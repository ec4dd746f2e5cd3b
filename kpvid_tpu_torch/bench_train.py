"""Training throughput: one JSON line.

    python -m kpvid_tpu_torch.bench_train [--out F] [--iters 20] [--k 8] [--device cuda]

Counterpart of the JAX package's ``tools/bench_train.py`` (the training
counterpart of ``bench``): ``Config()`` widths in bf16, random inputs drawn
with numpy from a seed and put on the device first, at three points:

- ``stage1_parity``: stage 1 at batch 16;
- ``stage1_throughput``: stage 1 at batch 128. JAX's point also switches
  ``model.upsample_mode`` to 'fused'; the port reads no upsample mode
  (configs/config.py), so this is the batch-16 path at batch 128;
- ``stage2``: stage 2 at batch 64.

At each point, in turn, each form in a trainer of its own (the first freed
before the second is made, so both fit where each does):

- the eager ``train_step``: two warm-up steps, then the best of three
  windows of ``--iters`` steps, each window ending in a synchronise;
- the graphed ``train_step_multi`` (one step captured as a CUDA graph and
  replayed K = ``--k`` times a call): the first call (capture included),
  then the best of three windows of ``--iters // K`` calls;

with ms a step and examples/s, one step's device ms and device operations
from ``torch.profiler`` (a single eager step; a graphed call over its K
steps), and each form's peak memory. ``capture_s`` is the first graphed
call's seconds less its K steps at the measured rate. The line is
``{"metric": "stage1_train_examples_per_sec_per_chip", "value", "unit",
"detail"}``, the value ``stage1_throughput``'s eager examples/s (the
training CLI's step). There is no ``vs_baseline``: no TPU number is a
target for the card. It runs on the card and raises without one
(``--device cpu`` runs the plain versions on the CPU, where no device
time or memory is measured).
"""

from __future__ import annotations

import json
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

POINTS = (("stage1_parity", 1, 16), ("stage1_throughput", 1, 128), ("stage2", 2, 64))
WINDOWS, WARMUP = 3, 2
THROUGHPUT_NOTE = ("the port reads no model.upsample_mode (JAX's 'fused' at this point): "
                   "the batch-16 path at batch 128")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch training benchmark")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--iters", type=int, default=20, help="steps a timed window")
    parser.add_argument("--k", type=int, default=8, help="steps a graphed call")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    return parser


def _inputs(m, stage: int, bs: int, device):
    """Two batches (and, in stage 2, their noise) on ``device``, from seed 0."""
    import torch

    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        if stage == 1:
            b = {k: rng.uniform(-1, 1, (bs, m.image_size, m.image_size, 3)).astype(np.float32)
                 for k in ("image", "future_image")}
        else:
            b = {"keypoints": rng.uniform(-1, 1, (bs, m.n_pts, 2)).astype(np.float32),
                 "real_seq": rng.uniform(-1, 1, (bs, m.n_future_frames, m.n_pts, 2)
                                         ).astype(np.float32),
                 "action_code": np.eye(m.n_action, dtype=np.float32)[np.zeros(bs, int)],
                 "noise": rng.standard_normal((bs, m.vae_dim)).astype(np.float32)}
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


# the profiler's own records, which key_averages() leaves out
_UNCOUNTED = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def profile_totals(prof) -> tuple[dict, dict]:
    """(device, host): per event name, [count, µs] of a finished
    ``torch.profiler.profile``. The events and times ``key_averages()``
    gives, read from the raw records: it builds a Python object for each,
    seconds of host time for a training step's ~30,000."""
    from torch.profiler import DeviceType

    device, host = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in _UNCOUNTED or getattr(e, "is_hidden_event", lambda: False)():
            continue
        rec = (device if e.device_type() == DeviceType.CUDA else host).setdefault(
            e.name(), [0, 0.0])
        rec[0] += 1
        rec[1] += (e.end_ns() - e.start_ns()) / 1e3
    return device, host


def device_profile(fn, device) -> tuple[float | None, int | None]:
    """(device ms, device operations) of ``fn()`` from torch.profiler; None
    on the CPU."""
    if device.type != "cuda":
        return None, None
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    ops, _ = profile_totals(prof)
    return sum(us for _, us in ops.values()) / 1e3, sum(n for n, _ in ops.values())


def _point(make, stage: int, bs: int, batches, iters: int, k: int, device) -> dict:
    import torch

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def best(fn, calls: int) -> float:
        """Seconds a call: the best of WINDOWS windows of ``calls`` calls."""
        out = float("inf")
        for r in range(WINDOWS):
            t0 = time.perf_counter()
            for i in range(calls):
                fn(r + i)
            sync()
            out = min(out, (time.perf_counter() - t0) / calls)
        return out

    def peak_gib():
        return torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None

    def step(t, i):
        b = batches[i % 2]
        return t.train_step(b) if stage == 1 else t.train_step(b, b["noise"])

    rec = {"batch": bs}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = make()
    for i in range(WARMUP):
        step(trainer, i)
    sync()
    s = best(lambda i: step(trainer, i), iters)
    dev_ms, n_ops = device_profile(lambda: step(trainer, 0), device)
    rec["eager"] = {"ms_per_step": 1e3 * s, "examples_per_s": bs / s, "device_ms": dev_ms,
                    "device_ops": n_ops, "peak_gib": peak_gib()}
    del trainer
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    names = ("image", "future_image") if stage == 1 else ("keypoints", "real_seq",
                                                          "action_code", "noise")
    stacked = {n: torch.stack([batches[i % 2][n] for i in range(k)]) for n in names}

    def multi(t):
        if stage == 1:
            return t.train_step_multi(stacked)
        return t.train_step_multi(stacked, stacked["noise"])

    trainer = make()
    t0 = time.perf_counter()
    multi(trainer)
    sync()
    first_s = time.perf_counter() - t0
    s = best(lambda i: multi(trainer), max(1, iters // k)) / k
    dev_ms, n_ops = device_profile(lambda: multi(trainer), device)
    rec["graphed"] = {"k": k, "ms_per_step": 1e3 * s, "examples_per_s": bs / s,
                      "capture_s": first_s - k * s,
                      "device_ms": dev_ms / k if dev_ms is not None else None,
                      "device_ops": n_ops // k if n_ops is not None else None,
                      "peak_gib": peak_gib()}
    rec["forms"] = "eager, then graphed in a fresh trainer"
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> dict:
    """Run the benchmark; print and return its JSON line."""
    args = build_parser().parse_args(argv)
    import dataclasses

    import torch

    from .configs import Config
    from .device import resolve_device
    from .losses import synthesize_vgg19_params
    from .train import Stage1Trainer, Stage2Trainer

    device = resolve_device(args.device)
    base = Config()  # production widths, bf16
    vgg = synthesize_vgg19_params()
    results = {}
    for tag, stage, bs in POINTS:
        cfg = dataclasses.replace(
            base, training=dataclasses.replace(base.training, batch_size=bs)).validate()

        def make(cfg=cfg, stage=stage):
            t = (Stage1Trainer(cfg, vgg, device=device) if stage == 1
                 else Stage2Trainer(cfg, device=device))
            t.load_parameters(t.init_parameters(1))
            return t

        results[tag] = _point(make, stage, bs, _inputs(cfg.model, stage, bs, device),
                              args.iters, args.k, device)
        if tag == "stage1_throughput":
            results[tag]["note"] = THROUGHPUT_NOTE
    line = {"metric": "stage1_train_examples_per_sec_per_chip",
            "value": round(results["stage1_throughput"]["eager"]["examples_per_s"], 1),
            "unit": "examples/s",
            "detail": dict(results, device=torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=2) + "\n")
    return line


if __name__ == "__main__":
    main()
