"""Training through the CLI: ``python -m kpvid_tpu_torch.train`` as a child
process (drivers/_train_child.py) on the benchmark's synthetic tree.

The workload file gives the CLI's ``mode``, the ``tree`` (kpbench/traffic/
tree.py), ``warmup_steps`` and ``capture_steps``, and ``checks`` (name ->
limit). The configuration file's ``training`` and ``data`` sections are the
CLI's. The window's marks are the CLI's own ``train_metrics.jsonl`` lines
(every ``summary_interval`` steps, written after the card has finished the
step): the window runs from the first mark at or after ``warmup_steps`` to
the last mark at most ``--seconds`` later, and ``train_examples_per_s`` is
every example of the steps between them over the time between them. Set-up
is this process's start to the first mark. The child is then interrupted
and waited for, and the record of its loaded modules that it wrote as it
exited is held to the import check. A traced run passes ``--profile-dir``: the CLI's own
``torch.profiler`` trace of loop steps 10-14; its window, which follows the trace, also gives
the loop's wait for its batches, timed by the child around the CLI's span.

The check: the child recorded what its first ``capture_steps`` steps were
fed and gave (drivers/_train_child.py); once it has ended, the plain
reference (kpbench/reference) runs the same steps in f32 from the same
weights, made again from the seed. Stage 1's steps take the batches the CLI
fed. Stage 2's take the batches and noise that the reference works out
itself from the tree and the seed (kpbench/reference/sequences.py,
streams.py), and the check holds what the CLI was fed to them (``batches``,
``noise``).
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from kpbench import harness

STEP_OUT = {"detector_translator": "stage1", "motion_generator": "stage2"}


def cli_argv(cell: harness.Cell, config: Path, max_steps: int, profile: Path | None) -> list:
    argv = ["--mode", cell.workload["mode"], "--config", str(config), "--max-steps",
            str(max_steps), "--no-images", "--device", cell.device]
    return argv + (["--profile-dir", str(profile)] if profile else [])


def prepare(cell: harness.Cell, seeds: list, max_steps: int, profile: Path | None = None,
            stop_after_capture: bool = False):
    """The run's scratch directory, the child's job file and its command."""
    work = harness.fresh_dir(cell.work)
    tree = data_tree(cell)
    runs = []
    for i, seed in enumerate(seeds):
        config = harness.port_config_file(
            cell, work / f"config{i}.yaml",
            paths={"data_dir": str(tree), "log_dir": str(work / f"log{i}"),
                   "vggnet": str(work / "no-vgg19.npy")},
            training={"seed": seed % 2**31, "resume": False})
        runs.append(cli_argv(cell, config, max_steps, profile))
    job = {"seeds": seeds, "model": cell.model, "tree": STEP_OUT[cell.workload["mode"]],
           "capture": str(work / "capture"), "capture_steps": cell.workload["capture_steps"],
           "runs": runs, "device": cell.device, "vgg_max_width": cell.config.get("vgg_max_width"),
           "stop_after_capture": stop_after_capture, "fault": cell.notes.get("fault")}
    (work / "job.json").write_text(json.dumps(job))
    cmd = [sys.executable, str(harness.BENCH / "drivers" / "_train_child.py"),
           str(work / "job.json")]
    return work, cmd


def marks(path: Path) -> list:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:  # a line being written
            break
    return out


def run(cell: harness.Cell) -> dict:
    wl = cell.workload
    t0_wall = time.time() - (time.perf_counter() - cell.t0)
    profile = cell.work / "profile" if cell.trace else None
    work, cmd = prepare(cell, [cell.seed], 10**9, profile)
    jsonl = work / "log0" / wl["mode"] / "train_metrics.jsonl"
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(work / "child.out", "w") as out:
        child = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                                 cwd=harness.CHECKOUT)
        try:
            trace = profile / f"{wl['mode']}_rank0.pt.trace.json" if profile else None
            first, last = watch(child, jsonl, wl["warmup_steps"], cell.seconds,
                                ready=trace.exists if trace else None)
        finally:
            stop(child)
    check_modules(work / "capture" / "modules.json")
    waits = data_wait(work / "capture" / "waits.jsonl", first["step"], last["step"])
    bs = cell.config["training"]["batch_size"]
    window_s = last["time"] - first["time"]
    e2e = {"train_examples_per_s": (last["step"] - first["step"]) * bs / window_s,
           "setup_s": first["time"] - t0_wall}
    peak = json.loads((work / "capture" / "peak.json").read_text())["peak"]
    records = {}
    if cell.trace:
        records = profile_records(profile, wl["mode"])
        records["wall_per_step_s"] = window_s / (last["step"] - first["step"])
        records["flops_per_step"] = step_flops(cell)
        records["data_wait"] = waits
    checks, _ = compare(cell, work / "capture" / "0", cell.seed)
    steps = last["step"] - first["step"]
    return {"e2e": e2e, "records": records, "checks": checks, "attempted": steps, "failed": 0,
            "device": harness.device_block(cell, peak, records), "breakdown": records.get("breakdown")}


def watch(child, jsonl: Path, warmup: int, seconds: float, poll: float = 0.2, ready=None):
    """(first mark, last mark) of the window: the first mark at or after
    ``warmup`` (and, given ``ready``, written after ``ready()`` held: a
    traced run's trace is on disk); raises if the child ends first."""
    first, gate = None, (-1 if ready is None else None)
    while True:
        if child.poll() is not None:
            raise RuntimeError(f"the train CLI ended with {child.returncode} before the window "
                               f"closed (see {jsonl.parents[2] / 'child.out'})")
        ms = marks(jsonl)
        if gate is None and ready():  # marks from here on come after it
            gate = ms[-1]["step"] if ms else -1
        ms = [m for m in ms if m["step"] >= warmup and gate is not None and m["step"] > gate]
        if ms and first is None:
            first = ms[0]
        if first is not None and ms[-1]["time"] > first["time"] + seconds:
            ms = [m for m in ms if m["step"] >= first["step"]]
            inside = [m for m in ms if m["time"] <= first["time"] + seconds]
            # at least one interval, even where marks are further apart
            return first, inside[-1] if len(inside) > 1 else ms[1]
        time.sleep(poll)


def data_wait(path: Path, first: int, last: int):
    """(seconds the CLI's loop spent waiting for its batches in the steps
    after mark ``first`` up to mark ``last``, their number), from the
    child's ``waits.jsonl``; None where either mark is missing."""
    at = {w["step"]: w["data_wait_s"] for w in marks(path) if w["split"] == "train"}
    if first not in at or last not in at:
        return None
    return at[last] - at[first], last - first


def check_modules(path: Path) -> None:
    """Raise unless the CLI's process recorded its modules as it exited and
    none of them is JAX's or the JAX package's."""
    loaded = json.loads(path.read_text()) if path.exists() else {}
    if loaded.get("at") != "exit":
        raise RuntimeError(f"the train CLI's process left no record of its modules at exit "
                           f"(last: {loaded.get('at')})")
    bad = sorted(set(loaded["names"]) & set(harness.FORBIDDEN))
    if bad:
        raise RuntimeError(f"the train CLI's process imported {bad}")


def stop(child) -> None:
    """Interrupt the CLI (its loop closes its pipelines on the way out) and
    wait for it; killed after 60 s."""
    if child.poll() is None:
        child.send_signal(signal.SIGINT)
        try:
            child.wait(60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()


def step_flops(cell) -> float:
    from kpbench.counts import model as counts

    bs = cell.config["training"]["batch_size"]
    if cell.workload["mode"] == "detector_translator":
        return counts.stage1_step_flops(cell.model, bs)
    return counts.stage2_step_flops(cell.model, bs)


def profile_records(profile: Path, mode: str) -> dict:
    """The CLI's trace of steps 10-14 (``{mode}_rank0.pt.trace.json``) as
    the readers' records: the window from its first to its last event."""
    rec = harness.chrome_records(profile / f"{mode}_rank0.pt.trace.json")
    spans = [x[:2] for x in rec["device"] + rec["host"]]
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    busy, _ = harness.busy_and_gaps(rec["device"], lo, hi)
    rec.update(kind="train", stage=STEP_OUT[mode], window=(lo, hi), steps=5, busy_s=busy,
               window_s=(hi - lo) / 1e9, breakdown=harness.breakdown(rec, lo, hi))
    return rec


# ------------------------------------------------------------------ the check
def data_tree(cell: harness.Cell) -> Path:
    """The cell's synthetic tree, written on first use."""
    from kpbench.traffic.tree import ensure_tree

    return ensure_tree(harness.BENCH / ".data", cell.workload["tree"], cell.model["n_pts"])


def fed_batches(cell, capture: Path) -> list:
    """What the CLI's first ``capture_steps`` steps were fed, as recorded:
    one dict of arrays a step."""
    inputs = np.load(capture / "inputs.npz")
    return [{key.split(".", 1)[1]: inputs[key] for key in inputs.files
             if key.startswith(f"{i}.")} for i in range(cell.workload["capture_steps"])]


def own_batches(cell, seed: int) -> list:
    """Stage 2's first batches and noise as the reference works them out
    from the tree and the CLI's seed (kpbench/reference/sequences.py and
    streams.py)."""
    from kpbench.reference.sequences import first_batches
    from kpbench.reference.streams import stage2_noise

    k, bs = cell.workload["capture_steps"], cell.config["training"]["batch_size"]
    batches = first_batches(data_tree(cell), seed % 2**31, bs, k, cell.model["n_action"])
    noise = stage2_noise(seed % 2**31, k, bs, cell.model["vae_dim"])
    return [dict(b, noise=z) for b, z in zip(batches, noise)]


def fed_numbers(fed: list, own: list) -> dict:
    """Stage 2's inputs, what the CLI was fed against what the reference
    works out: ``batches``, the widest gap of the batches' arrays; ``noise``,
    of the noise. An array missing, or of another shape, reads infinite."""
    def widest(keys):
        return max(harness.gap(f[k], o[k]) if k in f and f[k].shape == o[k].shape else math.inf
                   for f, o in zip(fed, own) for k in keys)

    return {"batches": widest([k for k in own[0] if k != "noise"]), "noise": widest(["noise"])}


def reference_side(cell, batches: list, seed: int, variant: str = "program"):
    """The reference's steps on ``batches`` (one dict of arrays a step), and
    the same steps as ``variant`` computes them ('control': float8 operands;
    'half': each step on the first half of its batch, the mean over those
    rows)."""
    import torch

    from kpbench.reference import model as ref
    from kpbench.reference import spec
    from kpbench.reference.nets import PLAIN, fp8, plain_backends

    plain_backends()
    m, dev = cell.model, cell.device
    stage = STEP_OUT[cell.workload["mode"]]
    batches = [{key: torch.from_numpy(v).to(dev) for key, v in b.items()} for b in batches]
    shapes = spec.stage1_trainer(m) if stage == "stage1" else spec.stage2_trainer(m)
    p0 = harness.make_params(shapes, seed, 2, dev)
    G = {n: v for n, v in p0.items() if n.startswith(("stage1.", "stage2."))}
    D = {n: v for n, v in p0.items() if n not in G}
    lr = cell.config["training"]["lr"]

    def losses(q, rows):
        if stage == "stage1":
            vgg = harness.make_params(spec.vgg19(cell.config.get("vgg_max_width")), seed, 3, dev)
            return (lambda G, D, b: ref.stage1_losses(G, D, vgg, b["image"][:rows],
                                                      b["future_image"][:rows], m, q))
        return (lambda G, D, b: ref.stage2_losses(
            G, D, {key: v[:rows] for key, v in b.items()}, b["noise"][:rows], m, q))

    bs = batches[0][next(iter(batches[0]))].shape[0]
    want = ref.train_steps(G, D, losses(PLAIN, bs), [(b,) for b in batches], lr)
    if variant == "program":
        return want, None
    q, rows = (fp8, bs) if variant == "control" else (PLAIN, bs // 2)
    return want, ref.train_steps(G, D, losses(q, rows), [(b,) for b in batches], lr)


def numbers(want: dict, got: dict, p0: dict) -> dict:
    """The compared numbers (PERF.md gives the readings behind each choice).
    Leaves whose reference first gradient is under a thousandth of the
    median leaf's (a conv bias under train-mode BN: nought but rounding)
    are left out of all but the losses. A leaf's gap is measured against
    the larger of its reference norm and the median leaf's.

    - ``loss1``: the first step's larger relative gap of loss_G and loss_D;
    - ``loss``: the same over every recorded step;
    - ``grad``: the worst leaf's gap of first-gradient norms;
    - ``grad_median``: the median leaf's;
    - ``update``: the median leaf's gap of the parameters' change after
      the last recorded step (a state left unchanged reads 1);
    - ``update_worst``: the worst leaf's;
    - ``pred``: the widest gap of the first step's prediction (stage 1's
      blended frame, stage 2's keypoint sequence), over the rows both have."""
    import torch

    rel = [{n: abs(g[n] - w[n]) / abs(w[n]) for n in ("loss_G", "loss_D")}
           for g, w in zip(got["metrics"], want["losses"])]
    gw = {n: float(v.norm()) for n, v in want["first_grads"].items()}
    gmed = float(np.median(list(gw.values())))
    moving = [n for n in gw if gw[n] >= 1e-3 * gmed]
    grad_gap = {n: abs(got["grad_norms"][n] - gw[n]) / max(gw[n], gmed) for n in moving}
    cw = {n: float((want["params"][n] - p0[n]).norm()) for n in moving}
    cmed = float(np.median(list(cw.values())))
    update_gap = {n: abs(got["change_norms"][n] - cw[n]) / max(cw[n], cmed) for n in moving}
    g_worst, u_worst = (max(d, key=d.get) for d in (grad_gap, update_gap))
    rows = len(got["pred"])
    pred = float((torch.as_tensor(got["pred"]).to(want["pred"].device)
                  - want["pred"][:rows]).abs().max())
    return {"pred": pred, "pred_scale": float(want["pred"].abs().max()),
            "loss1": max(rel[0].values()), "loss": max(max(r.values()) for r in rel),
            "grad": grad_gap[g_worst], "grad_median": float(np.median(list(grad_gap.values()))),
            "update": float(np.median(list(update_gap.values()))),
            "update_worst": update_gap[u_worst], "grad_leaf": g_worst, "update_leaf": u_worst,
            "left_out": len(gw) - len(moving)}


def as_got(side: dict, p0: dict) -> dict:
    """A reference variant's steps in the form the child records them."""
    return {"metrics": side["losses"], "pred": side["pred"],
            "grad_norms": {n: float(v.norm()) for n, v in side["first_grads"].items()},
            "change_norms": {n: float((side["params"][n] - p0[n]).norm())
                             for n in side["first_grads"]}}


def compare(cell, capture: Path, seed: int, variant: str = "program"):
    """(checks, readings) of a run: the program's recorded steps (or, for a
    control or fault variant, the reference's variant) against the
    reference. Stage 2's reference runs on its own batches and noise, and
    its readings add :func:`fed_numbers`."""
    from kpbench.reference import spec

    stage = STEP_OUT[cell.workload["mode"]]
    shapes = spec.stage1_trainer(cell.model) if stage == "stage1" else spec.stage2_trainer(
        cell.model)
    p0 = harness.make_params(shapes, seed, 2, cell.device)
    batches = fed_batches(cell, capture)
    fed = {}
    if stage == "stage2":
        own = own_batches(cell, seed)
        fed = fed_numbers(batches, own)
        batches = own
    want, side = reference_side(cell, batches, seed, variant)
    got = (dict(json.loads((capture / "capture.json").read_text()),
                pred=np.load(capture / "pred.npy")) if side is None else as_got(side, p0))
    vals = {**numbers(want, got, p0), **fed}
    if variant == "program":
        cell.notes["readings"] = vals
    limits = cell.workload["checks"]
    return {k: (vals[k], limits[k]) for k in limits}, vals


def readings(cell: harness.Cell, seeds: list, variants: list) -> list:
    """The check's numbers for each seed and variant ('program', 'control',
    'half'): one child runs the CLI's first steps for every seed in turn
    (and stops there), then the reference reads each capture."""
    work, cmd = prepare(cell, seeds, 10**9, stop_after_capture=True)
    with open(work / "child.out", "w") as out:
        subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=harness.CHECKOUT, check=True)
    lines = []
    for i, seed in enumerate(seeds):
        for variant in variants:
            _, vals = compare(cell, work / "capture" / str(i), seed, variant)
            lines.append({"seed": seed, "variant": variant, "checks": vals})
    return lines
