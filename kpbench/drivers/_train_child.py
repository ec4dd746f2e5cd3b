"""The training cells' child process: ``python -m kpvid_tpu_torch.train``
with the benchmark's inputs handed in and its first steps recorded.

    python kpbench/drivers/_train_child.py job.json

``job.json`` holds the run's ``seed``, the configuration's ``model``
section, the trainer tree (``stage1`` or ``stage2``), the ``capture``
directory, the number of ``capture_steps`` and ``runs``: the CLI's argument
lists. Before the CLI starts, three of its seams take the benchmark's
inputs, and nothing of its loop changes:

- the trainer's ``init_parameters`` returns weights made on the card from
  the seed (kpbench/harness.py::make_params), and stage 1's ``vgg_params``
  the VGG19 weights made the same way;
- ``parallel.select_step`` (what the CLI's loop calls) returns the step the
  program selects, wrapped: for its first ``capture_steps`` calls it keeps
  the batch and noise it was fed and the metrics it returned, after the first
  the norm of each parameter's gradient as Adam holds it (its first moment
  over 1 - beta1), after the last the norm of each parameter's change since
  the start, and the generator's first prediction (what ``g_grads``
  returned); then it writes them to ``capture/<run>/``;
- each ``MetricLogger.log_metrics`` also writes the process's peak device
  memory to ``capture/peak.json``, and appends to ``capture/waits.jsonl``
  its step and the seconds the loop has spent so far inside its
  ``kpvid.train.data_wait`` span (``next(train_iter)``), timed around the
  CLI's own ``span`` with or without a profiler.

The top-level names of the modules this process has loaded go to
``capture/modules.json`` at the capture, at every ``log_metrics`` mark and
once more as the process exits (``"at": "exit"``); the parent holds that
last record to the same import check as itself.

The first run goes through ``runpy`` exactly as ``-m`` does; later runs of
the list (the readings' seeds) call the CLI's ``main`` again in the same
process.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import runpy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
DATA_WAIT = "kpvid.train.data_wait"
sys.path.insert(0, str(BENCH.parent))


def main() -> None:
    import numpy as np
    import torch

    from kpbench import harness
    from kpbench.reference import spec
    import kpvid_tpu_torch.parallel as parallel
    import kpvid_tpu_torch.train.cli as cli
    from kpvid_tpu_torch.train.state import ADAM_BETAS, GANTrainer
    from kpvid_tpu_torch.utils.logging import MetricLogger

    job = json.loads(Path(sys.argv[1]).read_text())
    m, tree, k = job["model"], job["tree"], job["capture_steps"]
    capture = Path(job["capture"])
    state = {"run": 0, "seed": job["seeds"][0]}
    shapes = spec.stage1_trainer(m) if tree == "stage1" else spec.stage2_trainer(m)

    def record_modules(at: str) -> None:
        (capture / "modules.json").write_text(json.dumps(
            {"at": at, "names": sorted({name.split(".")[0] for name in list(sys.modules)})}))

    def init_parameters(self, key=0):
        state["p0"] = harness.make_params(shapes, state["seed"], 2, self.device)
        return state["p0"]

    def vgg_params(config):
        w = harness.make_params(spec.vgg19(job.get("vgg_max_width")), state["seed"], 3,
                                job["device"])
        return {n: {"kernel": w[n + ".kernel"].cpu().numpy(), "bias": w[n + ".bias"].cpu().numpy()}
                for n, *_ in spec.VGG19_LAYOUT}

    real_select = parallel.select_step

    class Captured(Exception):
        """Raised after the capture when the job asks to stop there."""

    def select_step(trainer, mode, accum):
        fn = real_select(trainer, mode, accum)
        n, kept = [0], {"metrics": [], "inputs": []}
        out_dir = capture / str(state["run"])

        def named(prefix, names, params):
            return [(f"{prefix}.{a}", p) for a, p in zip(names, params)]

        def faulty(*args):
            """The step broken as ``job["fault"]`` says (the benchmark's own
            tests plant it here to see the check fail): 'unchanged' returns
            its metrics with the state put back, 'half' runs on the first
            half of the batch's rows, its losses the mean over those,
            'late_jax' imports JAX in the loop once the capture is done."""
            if job.get("fault") == "late_jax" and n[0] > k:
                __import__("jax")
            if job.get("fault") == "half":
                h = len(next(iter(args[0].values()))) // 2
                return fn({key: v[:h] for key, v in args[0].items()},
                          *(np.asarray(a)[:h] for a in args[1:]))
            if job.get("fault") == "unchanged":
                saved = {key: v.detach().clone() for key, v in trainer.model.state_dict().items()}
                out = fn(*args)
                trainer.model.load_state_dict(saved)
                return out
            return fn(*args)

        real_g = trainer.g_grads

        def g_grads(*a, **kw):  # the step's first generator forward, as produced
            grads, pred, metrics = real_g(*a, **kw)
            if "pred" not in kept:
                kept["pred"] = pred.float().cpu().numpy()
            return grads, pred, metrics

        trainer.g_grads = g_grads

        def step(*args):
            i = n[0]
            n[0] += 1
            if i >= k:
                return faulty(*args)
            kept["inputs"].append({**{key: v.detach().cpu().numpy() for key, v in args[0].items()},
                                   **({"noise": np.asarray(args[1])} if len(args) > 1 else {})})
            out = faulty(*args)
            kept["metrics"].append({key: float(v) for key, v in out.items()})
            if i == 0:
                kept["grad_norms"] = {
                    name: float(opt.state[p]["exp_avg"].norm()) / (1 - ADAM_BETAS[0])
                    for opt, items in ((trainer.g_opt, named(trainer.G_PREFIX, trainer._g_names,
                                                             trainer._g_params)),
                                       (trainer.d_opt, named(trainer.D_PREFIX, trainer._d_names,
                                                             trainer._d_params)))
                    for name, p in items}
            if i == k - 1:
                p0 = state["p0"]
                kept["change_norms"] = {name: float((p.detach() - p0[name]).norm())
                                        for name, p in trainer.model.named_parameters()}
                out_dir.mkdir(parents=True, exist_ok=True)
                np.save(out_dir / "pred.npy", kept["pred"])
                np.savez(out_dir / "inputs.npz", **{f"{j}.{key}": v for j, b in
                                                   enumerate(kept["inputs"]) for key, v in b.items()})
                (out_dir / "capture.json").write_text(json.dumps(
                    {key: kept[key] for key in ("metrics", "grad_norms", "change_norms")}))
                record_modules("capture")
                if job.get("stop_after_capture"):
                    raise Captured
            return out

        return step

    real_span, waited = cli.span, [0.0]

    @contextlib.contextmanager
    def timed(name):
        t = time.perf_counter()
        try:
            with real_span(name):
                yield
        finally:
            waited[0] += time.perf_counter() - t

    def span(name):
        return timed(name) if name == DATA_WAIT else real_span(name)

    real_log = MetricLogger.log_metrics

    def log_metrics(self, split, step, metrics):
        real_log(self, split, step, metrics)
        (capture / "peak.json").write_text(json.dumps(
            {"peak": torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0}))
        with open(capture / "waits.jsonl", "a") as f:
            f.write(json.dumps({"split": split, "step": step, "data_wait_s": waited[0]}) + "\n")
        record_modules(f"step {step}")

    plant_input_fault(job.get("fault"))
    GANTrainer.init_parameters = init_parameters
    cli.vgg_params = vgg_params
    parallel.select_step = select_step
    cli.span = span
    MetricLogger.log_metrics = log_metrics
    capture.mkdir(parents=True, exist_ok=True)
    atexit.register(record_modules, "exit")
    for run, (seed, argv) in enumerate(zip(job["seeds"], job["runs"])):
        state.update(run=run, seed=seed)
        waited[0] = 0.0
        sys.argv = ["kpvid_tpu_torch.train"] + argv
        try:
            if run == 0:
                runpy.run_module("kpvid_tpu_torch.train", run_name="__main__", alter_sys=True)
            else:
                cli.main(argv)
        except Captured:
            pass


def plant_input_fault(fault) -> None:
    """The CLI's inputs broken as ``fault`` says (the benchmark's own tests
    plant it to see ``batches`` or ``noise`` fail): 'no_rotation' leaves the
    keypoints' rotation out, 'seed_off_by_one' seeds the train stream with
    its seed plus one, 'noise_key' draws each step's noise from the second
    key of a split of its own."""
    if fault == "no_rotation":
        import kpvid_tpu_torch.data.augment as augment

        augment.rotate_keypoints = lambda points, degrees: points
    elif fault == "seed_off_by_one":
        from kpvid_tpu_torch.data.base import HostDataPipeline

        real_init = HostDataPipeline.__init__

        def init(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            self.seed += 1

        HostDataPipeline.__init__ = init
    elif fault == "noise_key":
        import kpvid_tpu_torch.train.cli as cli
        from kpvid_tpu_torch.utils import jax_random

        real_noise = cli.step_noise
        cli.step_noise = lambda key, *args: real_noise(jax_random.split(key)[1], *args)


if __name__ == "__main__":
    main()
