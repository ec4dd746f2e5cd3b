"""One rank of the port's data-parallel runs for tests/test_torch_parallel.py.

Started twice by the test, with the KPVID_* environment (2 processes, gloo on
the CPU); imports nothing of JAX. It reads a job (JSON) and runs, in the
same order on both ranks:

- the data-parallel trainers (parallel.make_dp_reduce_step) from the
  parameter files the test wrote, each rank on its contiguous rows of the
  test's global batches (rank r holds rows [r*b, (r+1)*b)): stage 1 and
  stage 2 'fused' for 3 steps with the f32 all-reduce, 1 step with the bf16
  one, stage 2 with grad_accum 2; the gradients of the first update after
  the reduction; then one more profiled step of each for the collective
  inventory;
- ``python -m kpvid_tpu_torch.train --mode motion_generator --synthetic``'s
  ``main`` for 3 steps, the labeler's and evaluate's ``main``;
- or, for ``die``, rank 1 exits and rank 0 waits at a barrier, which must
  fail.

Each rank writes ``rank{r}.npz`` (arrays and metrics) and ``rank{r}.json``.
"""

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kpvid_tpu_torch import configs as tcfgs  # noqa: E402
from kpvid_tpu_torch import parallel  # noqa: E402
from kpvid_tpu_torch.losses import synthesize_vgg19_params  # noqa: E402


def config(spec: dict, **training) -> tcfgs.Config:
    return tcfgs.Config(model=tcfgs.ModelConfig(**spec["model"]),
                        training=tcfgs.TrainingConfig(**{**spec["training"], **training})
                        ).validate()


def run_trainer(stage: int, spec: dict, tag: str, n_steps: int, res: dict, inv: dict,
                **training) -> None:
    rank, world = parallel.world()
    cfg = config(spec, **training)
    vgg = synthesize_vgg19_params(max_width=spec["vgg_width"]) if stage == 1 else None
    trainer, step = parallel.make_dp_reduce_step(cfg, stage, vgg_params=vgg, device="cpu")
    init = np.load(spec["init"])
    trainer.load_parameters({k: init[k] for k in init.files})
    data = np.load(spec["batches"])
    names = ([f"{trainer.G_PREFIX}.{n}" for n in trainer._g_names],
             [f"{trainer.D_PREFIX}.{n}" for n in trainer._d_names])
    reduce, reduced = trainer._reduce_grads, []

    def recording_reduce(grads):
        out = reduce(grads)
        reduced.append(out)
        return out

    trainer._reduce_grads = recording_reduce
    b = cfg.training.batch_size // world
    for i in range(n_steps + 1):
        batch = {k[len(f"{i}/"):]: data[k][rank * b:(rank + 1) * b] for k in data.files
                 if k.startswith(f"{i}/") and not k.endswith("noise")}
        args = (batch,) if stage == 1 else (batch, data[f"{i}/noise"])
        if i < n_steps:
            metrics = step(*args)
            res.update({f"{tag}_m{i}_{k}": float(v) for k, v in metrics.items()})
            if i == 0:  # 'fused': the generator's update first
                for group, grads in zip(names, reduced):
                    res.update({f"{tag}_grad/{n}": g.numpy() for n, g in zip(group, grads)})
            if i + 1 in (1, n_steps):
                res.update({f"{tag}_after{i + 1}/{k}": v.numpy().copy()
                            for k, v in trainer.model.state_dict().items()})
        else:  # one more step, profiled: the collectives of a step
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
                step(*args)
            tally = parallel.collective_inventory(prof)
            inv[tag] = {"counts": tally.counts, "bytes": tally.bytes, "dtypes": tally.dtypes,
                        "n_params": sum(p.numel() for p in trainer.model.parameters())}


def main() -> None:
    job = json.loads(Path(sys.argv[1]).read_text())
    out = Path(job["out"])
    torch.set_num_threads(2)
    multiproc = parallel.maybe_initialize("cpu")
    rank, world = parallel.world()
    info = {"multiproc": multiproc, "rank": rank, "world": world}
    if job.get("die"):
        if rank == 1:
            os._exit(0)  # leaves without a word: rank 0's barrier must fail, not hang
        parallel.barrier("kpvid_test_die")
        raise SystemExit("the barrier returned without rank 1")
    res, inv = {}, {}
    for stage, spec in ((1, job["stage1"]), (2, job["stage2"])):
        run_trainer(stage, spec, f"s{stage}_f32", 3, res, inv)
        run_trainer(stage, spec, f"s{stage}_bf16", 1, res, inv, dp_grad_dtype="bfloat16")
    run_trainer(2, job["stage2_accum"], "s2_accum", 1, res, inv, grad_accum=2)
    info["inventory"] = inv

    from kpvid_tpu_torch import evaluate, make_pseudo_labels
    from kpvid_tpu_torch.train import main as train_main

    run = train_main(job["train_args"])
    info["train"] = {"start_step": run["start_step"], "end_step": run["end_step"],
                     "metrics": run["metrics"]}
    info["label"] = {k: v for k, v in make_pseudo_labels.main(job["label_args"]).items()
                     if isinstance(v, (int, float))}
    info["evaluate"] = {k: v for k, v in evaluate.main(job["evaluate_args"]).items()
                        if isinstance(v, (int, float))}
    np.savez(out / f"rank{rank}.npz", **res)
    (out / f"rank{rank}.json").write_text(json.dumps(info))


if __name__ == "__main__":
    main()
