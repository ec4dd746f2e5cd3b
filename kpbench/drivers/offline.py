"""Offline generation: back-to-back ``generate`` calls through
``GeneratorMesh`` over one device, as ``python -m kpvid_tpu_torch.bench``
and evaluate drive it.

The workload file gives ``batch`` (images a call), ``image_pool`` (host
image batches made from the seed, used in turn), ``warmup_calls``,
``sample_calls`` (the calls kept for the check, drawn from the seed by
reservoir sampling over every call of the window), ``trace_calls`` and
``checks`` (name -> limit). Each call's classes and latents are drawn from
the seed. Set-up ends after the warm-up calls have run; the window is
``--seconds`` of calls, and ``frames_per_s`` is every frame of every call
over the time from the first launch to the card's finishing the last.
A traced run then traces ``trace_calls`` more calls.
"""

from __future__ import annotations

import gc
import random

import numpy as np

from kpbench import harness


def inputs(cell: harness.Cell, rng: np.random.Generator):
    """The host image pool (uniform in [-1, 1], as bench makes its images)
    and a function of the call index to that call's (images, one-hot
    actions, latents)."""
    m, wl = cell.model, cell.workload
    b, s = wl["batch"], m["image_size"]
    pool = [rng.uniform(-1.0, 1.0, (b, s, s, 3)).astype(np.float32)
            for _ in range(wl["image_pool"])]

    def call(i: int):
        act = np.zeros((b, m["n_action"]), np.float32)
        act[np.arange(b), rng.integers(0, m["n_action"], b)] = 1.0
        z = rng.standard_normal((b, m["vae_dim"])).astype(np.float32)
        return pool[i % len(pool)], act, z

    return call


def program(cell: harness.Cell, params: dict):
    """The system under test: (generate(im, act, z) -> device outputs,
    synchronize, the replica whose stream the outputs are on, close)."""
    import torch

    from kpvid_tpu_torch.configs import load_config
    from kpvid_tpu_torch.eval.final import GeneratorMesh

    config = load_config(harness.port_config_file(cell, cell.work / "config.yaml"))
    mesh = GeneratorMesh(config, params, [torch.device(cell.device)])
    if cell.device == "cuda":
        from kpvid_tpu_torch.ops import _build

        _build.build_all()
    rep = mesh.replicas[0]

    def generate(im, act, z):
        return mesh.map(lambda r, *rows: r.final.generate(*rows), im, act, z)[0]

    return generate, mesh.synchronize, rep.launching


def run(cell: harness.Cell) -> dict:
    import torch

    from kpbench.counts import model as counts
    from kpbench.reference import spec

    harness.fresh_dir(cell.work)
    wl, m = cell.workload, cell.model
    dev = torch.device(cell.device)
    params = harness.make_params(spec.generation(m), cell.seed, 1, dev)
    rng = np.random.default_rng(cell.seed)
    draw = inputs(cell, rng)
    make = cell.notes.get("program", program)
    generate, synchronize, launching = make(cell, params)
    keys = ("pred_im_seq", "mask", "current_points", "future_points")

    for i in range(wl["warmup_calls"]):
        generate(*draw(i))
    synchronize()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = harness.now() - cell.t0

    pick, kept = random.Random(cell.seed), []
    n, t_start = 0, harness.now()
    deadline = t_start + cell.seconds
    while harness.now() < deadline:
        args = draw(wl["warmup_calls"] + n)
        out = generate(*args)
        slot = n if n < wl["sample_calls"] else pick.randrange(n + 1)
        if slot < wl["sample_calls"]:
            with launching():
                rec = (args, {k: out[k].clone() for k in keys})
            if slot < len(kept):
                kept[slot] = rec
            else:
                kept.append(rec)
        n += 1
        del out
    synchronize()
    window_s = harness.now() - t_start
    frames = n * wl["batch"] * m["n_future_frames"]
    e2e = {"frames_per_s": frames / window_s, "setup_s": setup_s}

    records = {}
    if cell.trace:
        records = trace_calls(cell, generate, synchronize, draw, wl["warmup_calls"] + n)
        records["wall_per_call_s"] = window_s / n
        records["flops_per_call"] = counts.generate_flops(m, wl["batch"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del generate, synchronize, launching
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, params, kept)
    return {"e2e": e2e, "records": records, "checks": checks, "attempted": n,
            "failed": 0, "device": harness.device_block(cell, peak, records),
            "breakdown": records.get("breakdown")}


def trace_calls(cell, generate, synchronize, draw, first: int) -> dict:
    """A ``torch.profiler`` trace (host ops with their shapes, and the card's
    kernels and copies) of ``trace_calls`` more calls, inside one
    ``kpbench.window`` range that ends after the card has finished them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device == "cuda" else [])
    k = cell.workload["trace_calls"]
    with profile(activities=acts, record_shapes=True) as prof:
        with record_function("kpbench.window"):
            for i in range(k):
                generate(*draw(first + i))
            synchronize()
    rec = harness.trace_records(prof)
    lo, hi = next((o[0], o[1]) for o in rec["host"] if o[2] == "kpbench.window")
    busy, _ = harness.busy_and_gaps(rec["device"], lo, hi)
    rec.update(kind="offline", window=(lo, hi), calls=k, busy_s=busy, window_s=(hi - lo) / 1e9,
               breakdown=harness.breakdown(rec, lo, hi))
    return rec


def compare(cell, params: dict, kept: list) -> dict:
    """The kept calls against the plain reference, in f32 with TF32 off, in
    blocks of ``check_rows`` images: the widest gap of the keypoints (current
    and future), of the frames and of the masks, and the largest mean gap of
    a block's frames."""
    import torch

    from kpbench.reference import model as ref
    from kpbench.reference.nets import plain_backends

    plain_backends()
    m, rows = cell.model, cell.workload["check_rows"]
    dev = next(iter(params.values())).device
    gaps = {"points": 0.0, "frames": 0.0, "masks": 0.0, "frames_mean": 0.0}
    with torch.no_grad():
        for (im, act, z), out in kept:
            for i in range(0, im.shape[0], rows):
                sl = slice(i, i + rows)
                want = ref.generate(params, *(torch.from_numpy(a[sl]).to(dev) for a in (im, act, z)),
                                    m)

                def g(key):
                    return float((out[key][sl].float() - want[key]).abs().max())

                gaps["points"] = max(gaps["points"], g("current_points"), g("future_points"))
                gaps["frames"] = max(gaps["frames"], g("pred_im_seq"))
                gaps["masks"] = max(gaps["masks"], g("mask"))
                gaps["frames_mean"] = max(gaps["frames_mean"], float(
                    (out["pred_im_seq"][sl].float() - want["pred_im_seq"]).abs().mean()))
    limits = cell.workload["checks"]
    cell.notes["readings"] = gaps
    return {k: (gaps[k], limits[k]) for k in limits}


def control(cell: harness.Cell, params: dict):
    """The check's control: the plain reference in the program's place, its
    convolutions' and products' operands rounded to float8 e4m3 (per-tensor
    scale), the precision below the configuration's bf16."""
    import contextlib

    import torch

    from kpbench.reference import model as ref
    from kpbench.reference.nets import fp8, plain_backends

    plain_backends()
    dev = torch.device(cell.device)

    @torch.no_grad()
    def generate(im, act, z):
        args = (torch.from_numpy(a).to(dev) for a in (im, act, z))
        return ref.generate(params, *args, cell.model, q=fp8)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    return generate, sync, contextlib.nullcontext
