#!/usr/bin/env python3
"""Drive kpvid_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. It
imports nothing of JAX or of the JAX package, and:

1. builds the CUDA kernels from ``kpvid_tpu_torch/csrc`` (one nvcc per
   source, started together), prints the build time, and reads the built
   library's SASS (``cuobjdump -sass``): every bf16 conv kernel must hold
   tensor-core instructions (``HGMMA`` or ``HMMA``);
2. holds every kernel of the generation path against its plain PyTorch
   version, on the card, at the shapes the path gives it at ``Config()``
   with 4 requests (N = 4 * 32 frames): float32 with TF32 off (rtol 1e-4,
   atol 1e-4) and bfloat16 (max |kernel - plain| <= 2% of max |plain|: the
   kernel rounds once, the plain version rounds the conv output and then
   the affine); the soft-argmax from f32 and bf16 maps and the Gaussian
   render into f32 and bf16 maps on both grids (bf16 maps within one bf16
   step), at the slice's shapes and at batch 32's. Every kernel is timed two
   ways: its device time (``device_ms``: launches captured in one CUDA
   graph, the replays timed with CUDA events) and a host loop of launches
   between two CUDA events (``time_ms``), which includes the host's launch
   cost. The plain version is timed by the host loop; for the conv, one
   ``F.conv2d`` call in channels_last bfloat16 with the BN scale folded
   into the weights (a yardstick the port never calls) by its device time.
   It prints for every conv shape its TFLOP/s, its share of the bound and
   its ratio to ``F.conv2d``. Then the same checks, f32 and bf16, at the
   shapes of each of the daemon's buckets (N = 32 to 1,024 frames);
3. serves 4 requests through ``InferenceEngine`` at ``Config()`` with random
   weights from a seed (BN statistics and biases randomized), checks the
   shapes, the uint8 outputs, the mask range, that a seed gives the same
   video twice, and that every generate launched 8 / 2 / 1 / 2 kernels;
   then runs the whole path in float32 through the kernels and through the
   plain versions on the card and compares them;
4. times ``generate`` at batch 32 (1,024 frames, bfloat16), each of its
   stages both ways, and the same call through the plain versions; and
   says whether the pose decoder's raw maps reach the soft-argmax
   contiguous (else what the copy costs);
5. serve: starts the HTTP daemon (``make_server`` on 127.0.0.1, port 0,
   buckets 1..32, warm-up on) over an ``InferenceEngine`` at ``Config()``
   and sends it 96 ``POST /v1/generate`` requests from 16 client threads
   in a spawned process of their own (PNGs drawn from seed 0, alternating
   160x120 and 120x160; npz and a few GIFs), once with the depth-1 pipeline
   and once without. It checks every response, that the launch counters
   show 8 / 2 / 1 / 2 per dispatched batch, that a request sent twice comes
   back with the same bits, and that 4 responses, and a batch of 32 run at
   once, agree with the same requests run alone at bucket 1: images within
   0.02 (3 uint8 steps), points within 0.016 (two bf16 steps); and that
   each bucket's batch through the kernels agrees with the same batch
   through the plain versions (images 0.02, current points 1e-4, future
   points 0.016). It prints requests/s, frames/s, latency p50/p95, mean
   batch rows and pad fraction both ways, where the dispatcher's and the
   handlers' host time goes (npz and GIF encoding apart from the socket
   write), one response's encoding alone, and the batch-32 readback time;
6. label: writes a synthetic Penn-Action tree (32 videos, about 1,400
   frames), saves the stage-1 parameters with ``save_parameters`` and runs
   ``python -m kpvid_tpu_torch.make_pseudo_labels``'s ``main`` on the card
   at 128-frame chunks in bf16. It checks one finite [n, 40, 2] label file
   in [-1, 1] per video, one ``pose_head`` launch per chunk and nothing
   else, and on the first 128-frame chunk that the kernel agrees with the
   plain soft-argmax on the same raw maps within 1e-5 and that the labels
   are the kernel's points; it prints frames/s and the host decode's share;
7. train: stage 2 at ``Config()`` in bf16, batch 16, on phase 6's tree and
   the labels the port's own labeler wrote: ``python -m
   kpvid_tpu_torch.train``'s ``main`` for 40 steps (a checkpoint at step 20,
   one test sweep, one summary-image write), then 3 steps each of
   'fused_dg' and 'two_batch'. It checks that every loss is finite, every
   parameter moved and no kernel was launched (stage 2 has none); resumes a
   second run from the step-20 checkpoint to step 40 and checks that it ends
   with the same bits (parameters and Adam state); runs one fused step in
   f32 at ``Config()`` width on the card and on the CPU from the same
   parameters, batch and noise and holds the losses (rtol 1e-4) and every
   gradient (max |card - CPU| <= 1e-3 of the tensor's max |CPU|) against
   each other; and prints the step time (host clock, synchronised, median
   of 10 after warm-up), examples/s, and one step's device time and kernel
   count from ``torch.profiler``;
8. evaluate: ``python -m kpvid_tpu_torch.evaluate``'s ``main`` on the tree's
   8 test videos at eval batch 8, with phase 6's stage-1 parameter file and
   phase 7's ``ckpt-40`` directory. It checks the PNG tree (2 PNGs and 5
   directories of 32 PNGs per sample), 8 / 2 / 1 / 4 launches per batch (the
   render twice more, for the point images at 128^2), the render at those
   shapes against its plain version (f32 grid into f32 maps, bf16 grid into
   bf16 and f32 maps) and its times, and that a second run with the same
   seed writes the same bytes; it prints samples/s with generate and PNG
   writing timed apart.

It exits non-zero on any failed check, and without a CUDA device. The line
before the last holds the kernels' JSON record (launches per generate, per
served batch, per labeled chunk and per evaluate batch), the last line the
device.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_TOL = 0.02
BATCH = 4
BATCH_B32 = 32
SLICE_TOL = 1e-3


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)
    print(f"ok: {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_s: float = 0.3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(max(budget_s / max(time.perf_counter() - t0, 1e-6), 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 10, budget_s: float = 0.3) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, the graph replayed back to back between two CUDA events, so the
    host's launch cost is paid once a replay and hidden behind the device's
    work. What is left of the host is the graph's gap between its kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: builds, caches, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    n = int(min(max(budget_s / max(time.perf_counter() - t0, 1e-6), 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    return ms


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        ok = bool(torch.allclose(got, want, **F32_TOL))
    else:
        ok = err <= BF16_REL_TOL * float(want.abs().max())
    if not ok:
        raise CheckFailed(f"kernel disagrees with its plain version: max abs err {err}")
    return err


def compare_one_bf16_step(got, want) -> float:
    """bf16 outputs that round the same f32 value once: each within one bf16
    step of the larger magnitude (2^-7 of it)."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool((err <= 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 2.0**-126).all()):
        raise CheckFailed(f"bf16 maps more than one bf16 step from plain: max abs err "
                          f"{float(err.max())}")
    return float(err.max())


def conv_shapes(m, n: int) -> tuple[list, list]:
    """The cases of #1 and of #2 that ``generate`` launches at N frames:
    (label, input shape, Cout, relu, launches per generate)."""
    hs, s = m.heatmap_size, m.image_size
    f0 = m.translator_filters
    f1, f2 = f0 // 2, f0 // 4
    conv = [
        ("oct0 b/c/d", (n, hs, hs, f0), f0, True, 3),
        ("oct1 b/c/d", (n, 2 * hs, 2 * hs, f1), f1, True, 3),
        ("oct2b", (n, s, s, f2), f2, True, 1),
        ("heads", (n, s, s, f2), 4, False, 1),
    ]
    up2 = [
        ("oct1a", (n, hs, hs, f0), f1, True, 1),
        ("oct2a", (n, 2 * hs, 2 * hs, f1), f2, True, 1),
    ]
    return conv, up2


def conv_inputs(gen, shape, cout, dtype):
    import torch

    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / (3 * c**0.5)).to(dtype)
    sc = torch.rand(cout, generator=gen, device="cuda") + 0.5
    sh = torch.randn(cout, generator=gen, device="cuda") * 0.1
    return x, k, sc, sh


def check_pose_head(gen, m, b: int) -> tuple[dict, object]:
    """#3 on [b, S, S, K] maps, f32 and bf16, against the plain soft-argmax;
    returns the errors by dtype and the bf16 maps (the main path's input)."""
    import torch

    from kpvid_tpu_torch import ops

    s, k_pts = m.image_size, m.n_pts
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        raw = (3 * torch.randn((b, s, s, k_pts), generator=gen, device="cuda")).to(dtype)
        got = ops.pose_head(raw)
        torch.cuda.synchronize()
        errs[dtype] = compare(got, ops.heatmaps_to_keypoints(raw), torch.float32)
        print(f"pose_head {tuple(raw.shape)} {dtype}: max abs err {errs[dtype]:.3e}", flush=True)
    return errs, raw


def check_render(gen, m, rows: int, gd, hs: int | None = None) -> tuple[dict, object]:
    """#4 from [rows, K, 2] points on the ``gd`` grid, into f32 and bf16
    [rows, hs, hs, K] maps (hs: the heatmap size unless given), against the
    plain render; returns the errors by output dtype and the points."""
    import torch

    from kpvid_tpu_torch import ops

    hs = hs or m.heatmap_size
    mu = (torch.rand((rows, m.n_pts, 2), generator=gen, device="cuda") * 2 - 1).to(gd).float()
    errs = {}
    for od in (torch.float32, torch.bfloat16):
        got = ops.gaussian_render(mu, hs, hs, m.heatmap_inv_std, gd, od)
        torch.cuda.synchronize()
        want = ops.render_gaussian_maps(mu, hs, hs, m.heatmap_inv_std, gd, od)
        if od == torch.float32:
            errs[od] = compare(got, want, torch.float32)
        else:
            errs[od] = compare_one_bf16_step(got, want)
        print(f"gaussian_render {tuple(mu.shape)} {gd} grid -> {od}: max abs err "
              f"{errs[od]:.3e}", flush=True)
    return errs, mu


def kernel_phase(cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from kpvid_tpu_torch import ops

    m = cfg.model
    n = BATCH * m.n_future_frames
    hs, s, k_pts = m.heatmap_size, m.image_size, m.n_pts
    conv_cases, up2_cases = conv_shapes(m, n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    for name, kernel, plain, cases, up2 in (
        ("conv3x3_affine", ops.conv3x3_affine, ops.conv3x3_affine_plain, conv_cases, False),
        ("up2_conv3_affine", ops.up2_conv3_affine, ops.up2_conv3_affine_plain, up2_cases, True),
    ):
        rec = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0,
                   library_ms=0.0 if not up2 else None, max_abs_err=0.0, max_abs_err_f32=0.0)
        for label, shape, cout, relu, mult in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, k, sc, sh = conv_inputs(gen, shape, cout, dtype)
                got = kernel(x, k, sc, sh, relu=relu)
                torch.cuda.synchronize()
                err = compare(got, plain(x, k, sc, sh, relu=relu), dtype)
                key = "max_abs_err_f32" if dtype == torch.float32 else "max_abs_err"
                rec[key] = max(rec[key], err)
                print(f"{name} {label} {tuple(shape)}->{cout} {dtype}: max abs err {err:.3e}",
                      flush=True)
            # x, k, sc, sh are the bfloat16 inputs of the main path
            t_k = device_ms(lambda: kernel(x, k, sc, sh, relu=relu))
            t_h = time_ms(lambda: kernel(x, k, sc, sh, relu=relu))
            t_p = time_ms(lambda: plain(x, k, sc, sh, relu=relu))
            nb, h, w, c = shape
            oh, ow = (2 * h, 2 * w) if up2 else (h, w)
            n_ops = 2.0 * nb * oh * ow * cout * 9 * c
            n_bytes = 2.0 * (nb * h * w * c + 9 * c * cout + nb * oh * ow * cout) + 8 * cout
            b_ms, _ = bound_ms(n_bytes, n_ops, "bfloat16")
            line = (f"{name} {label} bf16: device {t_k:.4f} ms ({n_ops / t_k / 1e9:.1f} TFLOP/s, "
                    f"{100 * b_ms / t_k:.1f}% of the bound {b_ms:.4f} ms), host loop "
                    f"{t_h:.4f} ms, plain {t_p:.4f} ms")
            if not up2:
                xc = x.permute(0, 3, 1, 2)  # channels_last view
                wc = (k.float() * sc).to(x.dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bias = sh.to(x.dtype)
                t_l = device_ms(lambda: F.conv2d(xc, wc, bias, padding=1))
                rec["library_ms"] += mult * t_l
                line += f", F.conv2d {t_l:.4f} ms, kernel / F.conv2d {t_k / t_l:.2f}"
            else:
                line += ", F.conv2d n/a"
            print(line + f", x{mult} per generate", flush=True)
            rec["ms"] += mult * t_k
            rec["host_loop_ms"] += mult * t_h
            rec["plain_ms"] += mult * t_p
            rec["ops"] += mult * n_ops
            rec["bytes"] += mult * n_bytes
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"], "bfloat16")
        ratio = "n/a" if up2 else f"{rec['ms'] / rec['library_ms']:.2f}"
        print(f"{name} per generate at batch {BATCH} bf16: {rec['ops'] / rec['ms'] / 1e9:.1f} "
              f"TFLOP/s, {100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound, "
              f"kernel / F.conv2d {ratio}", flush=True)
        records[name] = rec

    # pose head: the raw heatmaps of the request images, which the path
    # hands over in the compute dtype (bf16); f32 is checked too
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    for b in (BATCH, BATCH_B32):
        errs, raw = check_pose_head(gen, m, b)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        check(torch.equal(ops.pose_head(raw), ops.pose_head(raw)),
              f"pose_head at batch {b} gives the same points twice")
        # raw is the bf16 input of the main path
        n_bytes = raw.numel() * raw.element_size() + 4.0 * b * k_pts * 2
        n_ops = 2.0 * raw.numel() + 6.0 * b * k_pts * 2 * s
        times = dict(ms=device_ms(lambda: ops.pose_head(raw), reps=100),
                     host_loop_ms=time_ms(lambda: ops.pose_head(raw)),
                     plain_ms=time_ms(lambda: ops.heatmaps_to_keypoints(raw)))
        times["bound_ms"], times["bound_by"] = bound_ms(n_bytes, n_ops, "float32")
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"pose_head bf16 batch {b}: device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms), host loop {times['host_loop_ms']:.4f} ms, plain "
              f"{times['plain_ms']:.4f} ms", flush=True)
    records["pose_head"] = rec

    # gaussian render: the current maps ([B, K, 2], f32 grid) and the future
    # maps ([B*T, K, 2]), whose grid takes the keypoints' dtype; the path
    # writes both in the compute dtype (bf16); f32 maps are checked too
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    t = m.n_future_frames
    for b in (BATCH, BATCH_B32):
        times = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0)
        tot_bytes = tot_ops = 0.0
        for rows, gd in ((b, torch.float32), (b * t, torch.bfloat16)):
            errs, mu = check_render(gen, m, rows, gd)
            rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
            rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
            # the main path's call: bf16 maps
            args = (mu, hs, hs, m.heatmap_inv_std, gd, torch.bfloat16)
            times["ms"] += device_ms(lambda: ops.gaussian_render(*args), reps=100)
            times["host_loop_ms"] += time_ms(lambda: ops.gaussian_render(*args))
            times["plain_ms"] += time_ms(lambda: ops.render_gaussian_maps(*args))
            tot_bytes += 4.0 * rows * k_pts * 2 + 2.0 * rows * hs * hs * k_pts
            tot_ops += rows * (hs * hs * k_pts + 8.0 * k_pts * 2 * hs)
        times["bound_ms"], times["bound_by"] = bound_ms(tot_bytes, tot_ops, "float32")
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"gaussian_render bf16 per generate at batch {b}: device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms), host loop {times['host_loop_ms']:.4f} ms, plain "
              f"{times['plain_ms']:.4f} ms", flush=True)
    records["gaussian_render"] = rec
    for name, r in records.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name} per generate at batch {BATCH}: device {r['ms']:.4f} ms, host loop "
              f"{r['host_loop_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return records


def bucket_kernel_phase(cfg) -> dict:
    """Every kernel against its plain version, f32 and bf16, at the shapes
    each of the daemon's buckets gives it (N = bucket * 32 frames), with the
    tolerances of ``kernel_phase``; returns the worst error per kernel and
    bucket."""
    import torch

    from kpvid_tpu_torch import ops

    m = cfg.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for b in SERVE_BUCKETS:
        conv_cases, up2_cases = conv_shapes(m, b * m.n_future_frames)
        errs = {}
        for name, kernel, plain, cases in (
            ("conv3x3_affine", ops.conv3x3_affine, ops.conv3x3_affine_plain, conv_cases),
            ("up2_conv3_affine", ops.up2_conv3_affine, ops.up2_conv3_affine_plain, up2_cases),
        ):
            for _, shape, cout, relu, _ in cases:
                for dtype in (torch.float32, torch.bfloat16):
                    x, k, sc, sh = conv_inputs(gen, shape, cout, dtype)
                    got = kernel(x, k, sc, sh, relu=relu)
                    err = compare(got, plain(x, k, sc, sh, relu=relu), dtype)
                    errs[name] = max(errs.get(name, 0.0), err)
                    del x, got
        errs["pose_head"] = max(check_pose_head(gen, m, b)[0].values())
        errs["gaussian_render"] = max(
            max(check_render(gen, m, rows, gd)[0].values())
            for rows, gd in ((b, torch.float32), (b * m.n_future_frames, torch.bfloat16)))
        torch.cuda.empty_cache()
        worst[b] = errs
        check(True, f"bucket {b} (N = {b * m.n_future_frames}): every kernel agrees with its "
                    f"plain version, f32 and bf16; worst max abs err "
                    + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    return worst


def sass_phase() -> None:
    """Every bf16 conv kernel of the built library runs on the tensor cores:
    its SASS holds HGMMA (wgmma) or HMMA (mma.sync) instructions."""
    from kpvid_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump found")
    lib = _build._target("conv3x3.cu")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(maxsplit=1)[0]
        if "conv3x3_bf16_mma_kernel" in name:
            found[name] = next((op for op in ("HGMMA", "HMMA") if op in section), None)
    print(f"bf16 conv kernels in {lib.name}: " + ", ".join(
        f"{name[:60]}...: {op}" for name, op in found.items()), flush=True)
    check(bool(found) and all(found.values()),
          f"all {len(found)} bf16 conv kernels hold {sorted(set(found.values()) - {None})}")


def randomized_params(cfg, seed: int) -> dict:
    """init_parameters(seed) with the BN statistics, BN affine and biases drawn
    at random too, so that a mistake in any of them shows."""
    import torch

    from kpvid_tpu_torch.eval import FinalGenerator

    params = FinalGenerator(cfg, device="cpu").init_parameters(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=gen)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=gen)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=gen)
    return params


EXPECTED_LAUNCHES = {"conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1,
                     "gaussian_render": 2}


def slice_phase(cfg, params) -> dict:
    """4 requests through InferenceEngine; returns the launch counts of one run."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import InferenceEngine, request_z

    m = cfg.model
    engine = InferenceEngine(cfg, params, device="cuda")
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32)
    actions = np.array([0, 3, 5, 8]) % m.n_action
    z = np.stack([request_z(seed, m.vae_dim) for seed in (11, 12, 13, 14)])

    ops.reset_launch_counts()
    out = engine.run(images, actions, z)
    counts = ops.launch_counts()
    print(f"launches in one generate: {counts}", flush=True)
    check(counts == EXPECTED_LAUNCHES, "launches per generate are 8 / 2 / 1 / 2")
    t, s, k = m.n_future_frames, m.image_size, m.n_pts
    check(out["pred_im_seq"].shape == (BATCH, t, s, s, 3) and out["pred_im_seq"].dtype == np.uint8,
          f"pred_im_seq is uint8 {out['pred_im_seq'].shape}")
    check(out["mask"].shape == (BATCH, t, s, s, 1) and out["mask"].dtype == np.uint8,
          f"mask is uint8 {out['mask'].shape}")
    check(out["current_points"].shape == (BATCH, k, 2)
          and np.isfinite(out["current_points"]).all(), "current_points finite [B, K, 2]")
    check(out["future_points"].shape == (BATCH, t, k, 2)
          and np.isfinite(out["future_points"]).all()
          and np.abs(out["future_points"]).max() <= 1.0, "future_points finite in [-1, 1]")
    check(int(out["pred_im_seq"].max()) > int(out["pred_im_seq"].min()), "the video is not constant")

    act = np.eye(m.n_action, dtype=np.float32)[actions]
    raw = engine.final.generate(images, act, z)
    mask = raw["mask"]
    check(bool(torch.isfinite(raw["pred_im_seq"]).all()) and float(mask.min()) >= 0.0
          and float(mask.max()) <= 1.0, "mask in [0, 1] before quantization, video finite")
    again = engine.run(images, actions, z)
    check(all(np.array_equal(out[key], again[key]) for key in engine.OUTPUT_KEYS),
          "the same seeds give the same videos twice")
    check(ops.launch_counts() == {name: 3 * c for name, c in EXPECTED_LAUNCHES.items()},
          "every generate call launched 8 / 2 / 1 / 2 kernels")
    return counts


def f32_path_phase(cfg, params) -> None:
    """The whole path in float32, once through the kernels and once through
    the plain versions on the card."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import FinalGenerator, request_z

    m = cfg.model
    cfg32 = dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, compute_dtype="float32"))
    gen = FinalGenerator(cfg32, device="cuda")
    gen.load_parameters(params)
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32)
    act = np.eye(m.n_action, dtype=np.float32)[[1, 2, 6, 7]]
    z = np.stack([request_z(seed, m.vae_dim) for seed in (21, 22, 23, 24)])
    kern = gen.generate(images, act, z)
    ops.reset_launch_counts()
    with plain_path(ops):
        plain = gen.generate(images, act, z)
    check(sum(ops.launch_counts().values()) == 0, "the plain run launched no kernel")
    for key in ("current_points", "future_points", "pred_im_seq", "pred_im_crude", "mask"):
        err = float((kern[key] - plain[key]).abs().max())
        print(f"f32 path {key}: max abs err kernels vs plain {err:.3e}", flush=True)
        check(err <= SLICE_TOL, f"f32 path {key} within {SLICE_TOL}")


def throughput_phase(cfg, params, card: str) -> float:
    import torch

    from kpvid_tpu_torch.eval import FinalGenerator, request_z

    m = cfg.model
    b = 32
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(params)
    rng = np.random.default_rng(2)
    images = torch.as_tensor(
        rng.uniform(-1, 1, (b, m.image_size, m.image_size, 3)).astype(np.float32), device="cuda")
    act = torch.as_tensor(np.eye(m.n_action, dtype=np.float32)[rng.integers(0, m.n_action, b)],
                          device="cuda")
    z = torch.as_tensor(np.stack([request_z(int(sd), m.vae_dim) for sd in range(b)]), device="cuda")
    gen.generate(images, act, z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gen.generate(images, act, z)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(out["pred_im_seq"]).all()), "batch-32 video finite")
    fps = iters * b * m.n_future_frames / dt
    print(f"generate batch {b} bf16: {dt / iters * 1e3:.1f} ms per call, {fps:.1f} frames/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)

    # where the time of one call goes: its stages, timed one by one
    s1 = gen.stage1
    with torch.no_grad():
        mu = s1.detect(images)
        fut = gen.stage2.decode(z, mu.reshape(b, -1), act)
        fut = fut.reshape(b, m.n_future_frames, m.n_pts, 2)
        first = gen._split_first_conv(images, mu, fut)
        heads = s1.translator.fused_heads()
        stages = {
            "detect (pose encoder + pose_head)": lambda: s1.detect(images),
            "motion decode (LSTM)": lambda: gen.stage2.decode(z, mu.reshape(b, -1), act),
            "split first conv (+ gaussian_render)": lambda: gen._split_first_conv(images, mu, fut),
            "translator decode (conv kernels)": lambda: s1.translator(first, *heads),
        }
        stages["the whole generate"] = lambda: gen.generate(images, act, z)
        for name, fn in stages.items():
            print(f"stage at batch {b} bf16: {name}: device {device_ms(fn, 1, 1.0):.3f} ms, "
                  f"host loop {time_ms(fn, 1.0):.3f} ms", flush=True)

        # the raw maps reach pose_head in bf16; does .contiguous() copy them?
        raw = s1.pose_encoder.raw_maps(images)
        line = (f"raw maps at batch {b}: {raw.dtype} {tuple(raw.shape)}, contiguous "
                f"{raw.is_contiguous()}")
        if not raw.is_contiguous():
            line += f", .contiguous() {device_ms(raw.contiguous, 10):.4f} ms"
        print(line, flush=True)

    # the same call through the plain versions, for comparison only
    from kpvid_tpu_torch import ops

    with plain_path(ops):
        t_plain = time_ms(lambda: gen.generate(images, act, z), 1.0)
    print(f"generate batch {b} bf16 through the plain versions: {t_plain:.1f} ms per call, "
          f"{b * m.n_future_frames / t_plain * 1e3:.1f} frames/s", flush=True)
    return fps


def plain_path(ops):
    """Every kernel call site of the path bound to its plain version."""
    import contextlib

    stack = contextlib.ExitStack()
    for target, fn in (
        ("kpvid_tpu_torch.ops.chain.conv3x3_affine", ops.conv3x3_affine_plain),
        ("kpvid_tpu_torch.ops.chain.up2_conv3_affine", ops.up2_conv3_affine_plain),
        ("kpvid_tpu_torch.models.networks.pose_head", ops.heatmaps_to_keypoints),
        ("kpvid_tpu_torch.eval.final.gaussian_render", ops.render_gaussian_maps),
    ):
        stack.enter_context(mock.patch(target, fn))
    return stack


SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_REQUESTS = 96
SERVE_CLIENTS = 16
GIF_EVERY = 24  # every 24th request asks for a GIF: 4 of 96
# bucket 1 against any other bucket, bf16 (PERF.md section 2): images within
# 0.02, i.e. 3 uint8 steps (pred_im_seq's [-1, 1] and the mask's [0, 1] held
# alike); points within two bf16 steps at 1.0
BUCKET_TOL = {"pred_im_seq": 3, "mask": 3, "current_points": 0.016, "future_points": 0.016}
# a bucket's batch through the kernels against the same batch through the
# plain versions, bf16 (PERF.md section 2): images within 0.02, the current
# points within 1e-4 (#3 takes the same maps), future points within two bf16
# steps at 1.0
PATH_TOL = {"pred_im_seq": 0.02, "pred_im_crude": 0.02, "mask": 0.02,
            "current_points": 1e-4, "future_points": 0.016}


def serve_traffic(m) -> list[dict]:
    """The serve phase's requests: PNGs drawn from seed 0, alternating
    landscape and portrait so both crop branches run, cycling actions,
    fixed seeds."""
    from PIL import Image

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(SERVE_REQUESTS):
        w, h = (160, 120) if i % 2 == 0 else (120, 160)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
        reqs.append({"image": base64.b64encode(buf.getvalue()).decode(),
                     "action": i % m.n_action, "seed": 1000 + i,
                     "format": "gif" if i % GIF_EVERY == GIF_EVERY - 1 else "npz"})
    return reqs


def post(base: str, body: dict) -> tuple[int, str, bytes]:
    req = urllib.request.Request(f"{base}/v1/generate", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def client_process(base: str, reqs: list[dict], out_dir: str) -> None:
    """The load: SERVE_CLIENTS closed-loop threads in a process of their own,
    so that they share no GIL with the daemon. Writes each response body to
    ``<i>.bin`` and the statuses, content types, latencies (s) and the wall
    time to ``meta.json``; stops sending after a failed request."""
    out = Path(out_dir)
    status, ctypes, latency = [None] * len(reqs), [""] * len(reqs), [0.0] * len(reqs)
    lock = threading.Lock()
    todo = iter(range(len(reqs)))
    failed = threading.Event()

    def client():
        while not failed.is_set():
            with lock:
                i = next(todo, None)
            if i is None:
                return
            t0 = time.perf_counter()
            status[i], ctypes[i], body = post(base, reqs[i])
            latency[i] = time.perf_counter() - t0
            (out / f"{i}.bin").write_bytes(body)
            if status[i] != 200:
                failed.set()

    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (out / "meta.json").write_text(json.dumps({
        "status": status, "ctype": ctypes, "latency": latency,
        "wall": time.perf_counter() - t0}))


def drive(base: str, reqs: list[dict]) -> tuple[list, list, float]:
    """Send every request from ``client_process`` in a spawned process;
    returns the responses (status, content type, body; None if not sent),
    each request's latency in s, and the wall time."""
    import multiprocessing

    with tempfile.TemporaryDirectory(prefix="kpvid_clients_") as tmp:
        proc = multiprocessing.get_context("spawn").Process(
            target=client_process, args=(base, reqs, tmp))
        proc.start()
        proc.join(timeout=600)
        if proc.is_alive():
            proc.kill()
            proc.join()
        check(proc.exitcode == 0, "the client process finished")
        meta = json.loads((Path(tmp) / "meta.json").read_text())
        results = [None if st is None else (st, ct, (Path(tmp) / f"{i}.bin").read_bytes())
                   for i, (st, ct) in enumerate(zip(meta["status"], meta["ctype"]))]
    return results, meta["latency"], meta["wall"]


class HostTimer:
    """Seconds spent in wrapped calls, summed over threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self.lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                    self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def check_bucket_agreement(got: dict, want: dict, what: str) -> dict:
    errs = {}
    for key, tol in BUCKET_TOL.items():
        if got[key].dtype == np.uint8:
            err = int(np.abs(got[key].astype(np.int16) - want[key].astype(np.int16)).max())
        else:
            err = float(np.abs(got[key] - want[key]).max())
        errs[key] = err
        if err > tol:
            raise CheckFailed(f"{what}: {key} differs by {err} (bound {tol})")
    return errs


def serve_phase(cfg, params, card: str) -> dict:
    """The HTTP daemon at Config(), with the pipeline on and off."""
    import torch
    from PIL import Image

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.data.augment import resolve_frame_ops
    from kpvid_tpu_torch.device import start_readback
    from kpvid_tpu_torch.eval import InferenceEngine, device_quantize, make_server, request_z
    from kpvid_tpu_torch.eval import server as server_mod

    m = cfg.model
    t, s, k = m.n_future_frames, m.image_size, m.n_pts
    engine = InferenceEngine(cfg, params, device="cuda")
    reqs = serve_traffic(m)
    report = {}
    first_npz = None
    for pipeline in (True, False):
        timer = HostTimer()
        with mock.patch.object(engine, "dispatch", timer.wrap("dispatch", engine.dispatch)), \
                mock.patch.object(engine, "fetch", timer.wrap("fetch", engine.fetch)), \
                mock.patch.object(server_mod, "preprocess_image",
                                  timer.wrap("preprocess", server_mod.preprocess_image)), \
                mock.patch.object(server_mod, "encode_npz",
                                  timer.wrap("encode_npz", server_mod.encode_npz)), \
                mock.patch.object(server_mod, "encode_gif",
                                  timer.wrap("encode_gif", server_mod.encode_gif)), \
                mock.patch.object(server_mod._Handler, "_send_bytes",
                                  timer.wrap("send", server_mod._Handler._send_bytes)):
            t0 = time.perf_counter()
            server, batcher = make_server(engine, port=0, buckets=SERVE_BUCKETS, warmup=True,
                                          pipeline=pipeline)
            warm_s = time.perf_counter() - t0
            base = f"http://127.0.0.1:{server.server_address[1]}"
            serving = threading.Thread(target=server.serve_forever, daemon=True)
            serving.start()
            try:
                timer.seconds.clear()
                timer.calls.clear()
                ops.reset_launch_counts()
                results, latency, wall = drive(base, reqs)
                counts = ops.launch_counts()
                with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
                    stats = json.loads(r.read())
                host = dict(timer.seconds)
                calls = dict(timer.calls)
                # one request, twice, alone: the same bucket both times
                again = [post(base, dict(reqs[0], seed=77)) for _ in range(2)]
            finally:
                server.shutdown()
                server.server_close()
                batcher.stop()
                serving.join(timeout=30)
        mode = "pipeline on" if pipeline else "pipeline off"
        check(all(r is not None and r[0] == 200 for r in results),
              f"{mode}: all {len(reqs)} requests answered 200")
        batches = stats["batches_total"]
        check(stats["requests_total"] == len(reqs) and batches > 0,
              f"{mode}: {len(reqs)} requests in {batches} batches")
        check(counts == {name: c * batches for name, c in EXPECTED_LAUNCHES.items()},
              f"{mode}: launches {counts} are 8 / 2 / 1 / 2 per dispatched batch")
        outs, gifs = {}, []
        for i, (req, (_, ctype, body)) in enumerate(zip(reqs, results)):
            if req["format"] == "gif":
                gifs.append(ctype == "image/gif" and body[:6] in (b"GIF87a", b"GIF89a"))
                continue
            out = dict(np.load(io.BytesIO(body)))
            ok = (out["pred_im_seq"].dtype == np.uint8 and out["pred_im_seq"].shape == (t, s, s, 3)
                  and out["mask"].dtype == np.uint8 and out["mask"].shape == (t, s, s, 1)
                  and out["current_points"].shape == (k, 2)
                  and out["future_points"].shape == (t, k, 2)
                  and np.isfinite(out["current_points"]).all()
                  and np.isfinite(out["future_points"]).all() and int(out["seed"]) == req["seed"])
            if not ok:
                raise CheckFailed(f"{mode}: request {i} has wrong outputs")
            outs[i] = out
        check(len(outs) + len(gifs) == len(reqs) and all(gifs),
              f"{mode}: every npz holds uint8 [32,128,128,3] and [32,128,128,1] and finite "
              f"points, and the {len(gifs)} GIF answers are GIFs")
        a, b = (dict(np.load(io.BytesIO(r[2]))) for r in again)
        check(all(r[0] == 200 for r in again) and all(np.array_equal(a[x], b[x]) for x in a),
              f"{mode}: one request sent twice, alone, comes back with the same bits")
        if first_npz is None:
            first_npz = (outs, a)
        else:
            check(all(np.array_equal(first_npz[1][x], a[x]) for x in a),
                  "the lone request gives the same bits with the pipeline on and off")
        lat = np.sort(np.asarray(latency))
        frames = len(reqs) * t
        rep = {"requests_per_s": len(reqs) / wall, "frames_per_s": frames / wall,
               "wall_s": wall, "warmup_s": warm_s,
               "latency_ms_p50": stats["latency_ms_p50"], "latency_ms_p95": stats["latency_ms_p95"],
               "client_latency_ms_p50": 1e3 * float(lat[len(lat) // 2]),
               "client_latency_ms_p95": 1e3 * float(lat[min(len(lat) - 1, int(len(lat) * 0.95))]),
               "batches": batches, "mean_batch_rows": stats["mean_batch_rows"],
               "pad_fraction": stats["pad_fraction"],
               "host_s": host, "host_calls": calls,
               "launches_per_batch": {n: c / batches for n, c in counts.items()}}
        report["pipeline" if pipeline else "no_pipeline"] = rep
        print(f"serve ({mode}) on {card}: {rep['requests_per_s']:.2f} requests/s, "
              f"{rep['frames_per_s']:.1f} frames/s, {len(reqs)} requests in {wall:.3f} s from "
              f"{SERVE_CLIENTS} clients; batcher latency p50 {rep['latency_ms_p50']:.1f} ms, p95 "
              f"{rep['latency_ms_p95']:.1f} ms; client latency p50 "
              f"{rep['client_latency_ms_p50']:.1f} ms, p95 {rep['client_latency_ms_p95']:.1f} ms; "
              f"{batches} batches, mean batch rows {rep['mean_batch_rows']:.2f}, pad fraction "
              f"{rep['pad_fraction']:.3f}; warm-up {warm_s:.2f} s", flush=True)
        print(f"serve ({mode}) host seconds, summed over threads: " + ", ".join(
            f"{n} {v:.3f} s in {calls[n]} calls" for n, v in sorted(host.items())) +
            f" (wall {wall:.3f} s)", flush=True)

    # the same requests alone at bucket 1, and 32 of them at once, not counted
    outs, _ = first_npz
    ops_ = resolve_frame_ops("auto")
    prep = {i: server_mod.preprocess_image(Image.open(io.BytesIO(base64.b64decode(r["image"]))),
                                           s, ops_)
            for i, r in enumerate(reqs)}

    def alone(i):
        return {x: v[0] for x, v in engine.run(prep[i][None], np.asarray([reqs[i]["action"]]),
                                                request_z(reqs[i]["seed"], m.vae_dim)[None]).items()}

    npz_ids = sorted(outs)
    worst = {}
    for i in npz_ids[:4]:
        errs = check_bucket_agreement(outs[i], alone(i), f"response {i} vs bucket 1")
        worst = {x: max(worst.get(x, 0), e) for x, e in errs.items()}
    check(True, f"4 daemon responses agree with bucket 1: {worst}")
    ids32 = npz_ids[:32]
    batch = engine.run(np.stack([prep[i] for i in ids32]),
                       np.asarray([reqs[i]["action"] for i in ids32]),
                       np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids32]))
    worst = {}
    for j in range(0, 32, 8):
        errs = check_bucket_agreement({x: v[j] for x, v in batch.items()}, alone(ids32[j]),
                                      f"row {j} of bucket 32 vs bucket 1")
        worst = {x: max(worst.get(x, 0), e) for x, e in errs.items()}
    check(True, f"bucket 32 agrees with bucket 1 on rows 0, 8, 16, 24: {worst}")
    report["bucket32_vs_bucket1"] = worst

    # every bucket's batch through the kernels and through the plain versions
    report["kernels_vs_plain_per_bucket"] = {}
    for b in SERVE_BUCKETS:
        ids = npz_ids[:b]
        args = (np.stack([prep[i] for i in ids]),
                np.eye(m.n_action, dtype=np.float32)[[reqs[i]["action"] for i in ids]],
                np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids]))
        with torch.no_grad():
            kern = engine.final.generate(*args)
            with plain_path(ops):
                plain = engine.final.generate(*args)
        errs = {x: float((kern[x].float() - plain[x].float()).abs().max()) for x in PATH_TOL}
        bad = {x: e for x, e in errs.items() if not e <= PATH_TOL[x]}
        if bad:
            raise CheckFailed(f"bucket {b}: kernels vs plain {bad} (bounds {PATH_TOL})")
        report["kernels_vs_plain_per_bucket"][b] = errs
        check(True, f"bucket {b}: the path through the kernels agrees with the plain versions, "
                    "bf16: " + ", ".join(f"{x} {e:.3e}" for x, e in errs.items()))
        del kern, plain

    # the engine alone, no HTTP traffic: host clock of one run per bucket
    report["engine_run_ms"] = {}
    for b in SERVE_BUCKETS:
        ids = npz_ids[:b]
        args = (np.stack([prep[i] for i in ids]), np.asarray([reqs[i]["action"] for i in ids]),
                np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids]))
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.run(*args)
            runs.append(1e3 * (time.perf_counter() - t0))
        report["engine_run_ms"][b] = float(np.median(runs))
    print("engine.run alone (dispatch + readback, host clock, median of 5): " + ", ".join(
        f"bucket {b} {ms:.2f} ms" for b, ms in report["engine_run_ms"].items()), flush=True)

    # the batch-32 readback alone: copy-stream time of the uint8 outputs
    z = np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids32])
    act = np.eye(m.n_action, dtype=np.float32)[[reqs[i]["action"] for i in ids32]]
    with torch.no_grad():
        out = engine.final.generate(np.stack([prep[i] for i in ids32]), act, z)
        quant = {"pred_im_seq": device_quantize(out["pred_im_seq"]),
                 "mask": device_quantize(out["mask"], rescale=False),
                 "current_points": out["current_points"].float(),
                 "future_points": out["future_points"].float()}
    torch.cuda.synchronize()
    n_bytes = sum(v.numel() * v.element_size() for v in quant.values())
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(engine.copy_stream)
        rb = start_readback(quant, engine.copy_stream)
        end.record(engine.copy_stream)
        rb.wait()
        end.synchronize()
        times.append(start.elapsed_time(end))
    report["readback_b32_ms"] = times

    # one response's encoding alone: one thread, no load
    one = outs[npz_ids[0]]
    n_raw = sum(v.nbytes for v in one.values())
    enc = {}
    for name, fn in (("npz", lambda: server_mod.encode_npz(one, int(one["seed"]))),
                     ("gif", lambda: server_mod.encode_gif(one["pred_im_seq"]))):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            body = fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        enc[name] = {"ms": float(np.median(runs)), "bytes": len(body)}
    report["encode_alone"] = enc
    print(f"one response encoded alone (one thread, no load, median of 5): npz "
          f"{enc['npz']['ms']:.2f} ms ({n_raw / 1e6:.2f} MB -> {enc['npz']['bytes'] / 1e6:.2f} MB), "
          f"GIF {enc['gif']['ms']:.2f} ms ({enc['gif']['bytes'] / 1e6:.2f} MB); the outputs "
          "come from random weights", flush=True)
    print(f"batch-32 readback of {n_bytes / 1e6:.1f} MB (uint8 video and mask, f32 points) on "
          f"the copy stream: {', '.join(f'{x:.3f}' for x in times)} ms "
          f"({n_bytes / min(times) / 1e6:.1f} GB/s)", flush=True)
    return report


def label_phase(cfg, params, card: str, root: Path) -> dict:
    """The labeler on a synthetic tree at 128-frame chunks, bf16. Leaves the
    tree (``root/penn``, its labels) and the stage-1 parameter file
    (``root/stage1.npz``) for phases 7 and 8."""
    import torch

    from kpvid_tpu_torch import make_pseudo_labels, ops
    from kpvid_tpu_torch.checkpoint import save_parameters
    from kpvid_tpu_torch.data import (
        VideoFramesDataset,
        make_synthetic_penn_tree,
        pack_chunks,
    )
    from kpvid_tpu_torch.data.image_pair import read_split
    from kpvid_tpu_torch.device import to_device

    m = cfg.model
    chunk = 128
    t0 = time.perf_counter()
    make_synthetic_penn_tree(root / "penn", n_train=24, n_test=8)
    tree_s = time.perf_counter() - t0
    ckpt = save_parameters(root / "stage1.npz",
                           {k: v for k, v in params.items() if k.startswith("stage1.")})
    (root / "cfg.yaml").write_text(json.dumps({  # JSON is YAML
        "paths": {"data_dir": str(root / "penn")},
        "training": {"compute_dtype": cfg.training.compute_dtype},
        "model": dataclasses.asdict(m),
        "data": {"labeler_chunk": chunk},
    }))
    ops.reset_launch_counts()
    stats = make_pseudo_labels.main(["--config", str(root / "cfg.yaml"),
                                     "--checkpoint", str(ckpt), "--device", "cuda"])
    counts = ops.launch_counts()
    n_frames = stats["frames"]
    check(stats["videos"] == 32 and stats["chunks"] == -(-n_frames // chunk),
          f"labeled 32 videos, {n_frames} frames, in {stats['chunks']} chunks of {chunk}")
    check(counts == {"conv3x3_affine": 0, "up2_conv3_affine": 0,
                     "pose_head": stats["chunks"], "gaussian_render": 0},
          f"launches {counts}: one pose_head per chunk, nothing else")
    labels = {}
    for subset in ("train", "test"):
        for rel, _ in read_split(str(root / "penn"), subset):
            vid = int(rel.split("/")[-1])
            n = len(list((root / "penn" / rel).iterdir()))
            arr = np.load(root / "penn" / "pseudo_labels" / f"{vid:04d}.npy")
            if not (arr.shape == (n, m.n_pts, 2) and arr.dtype == np.float32
                    and np.isfinite(arr).all() and np.abs(arr).max() <= 1.0):
                raise CheckFailed(f"labels of video {vid}: {arr.shape} {arr.dtype}")
            labels[vid] = arr
    check(len(labels) == 32, "one finite [n, 40, 2] label file in [-1, 1] per video")

    # the first chunk again: raw maps, the kernel and the plain soft-argmax
    enc, _ = make_pseudo_labels.load_pose_encoder(cfg, str(ckpt), torch.device("cuda"))
    ds = VideoFramesDataset(str(root / "penn"), "train", m.image_size, as_uint8=True)
    slab, segs = next(pack_chunks(ds.iter_videos(), chunk))
    with torch.no_grad():
        x = to_device(slab, torch.device("cuda")).float() / 255.0 * 2.0 - 1.0
        raw = enc.raw_maps(x).contiguous()
        got = ops.pose_head(raw)
        want = ops.heatmaps_to_keypoints(raw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"pose_head on a {tuple(raw.shape)} {raw.dtype} chunk within 1e-5 "
                       f"of the plain soft-argmax: max abs err {err:.3e}")
    pts = got.cpu().numpy()
    label_err = max(float(np.abs(labels[vid][v_off:v_off + c] - pts[s_off:s_off + c]).max())
                    for vid, _, v_off, s_off, c in segs)
    check(label_err <= 1e-5, f"the labels of the first chunk are the kernel's points: max "
                             f"abs diff {label_err:.3e}")
    n_bytes = raw.numel() * raw.element_size() + 4.0 * chunk * m.n_pts * 2
    n_ops = 2.0 * raw.numel() + 6.0 * chunk * m.n_pts * 2 * m.image_size
    kern = dict(ms=device_ms(lambda: ops.pose_head(raw), reps=20),
                host_loop_ms=time_ms(lambda: ops.pose_head(raw)),
                plain_ms=time_ms(lambda: ops.heatmaps_to_keypoints(raw)), max_abs_err=err)
    kern["bound_ms"], kern["bound_by"] = bound_ms(n_bytes, n_ops, "float32")
    fps = n_frames / stats["seconds"]
    print(f"label on {card}: {n_frames} frames of 32 videos in {stats['seconds']:.3f} s, "
          f"{fps:.1f} frames/s; decode thread busy {stats['decode_seconds']:.3f} s "
          f"({100 * stats['decode_seconds'] / stats['seconds']:.1f}% of the wall time), labeling "
          f"loop waiting for slabs {stats['wait_seconds']:.3f} s "
          f"({100 * stats['wait_seconds'] / stats['seconds']:.1f}%); tree written in "
          f"{tree_s:.2f} s", flush=True)
    print(f"pose_head on a labeling chunk {tuple(raw.shape)} {raw.dtype} ({n_bytes / 1e6:.1f} MB): "
          f"device {kern['ms']:.4f} ms ({100 * kern['bound_ms'] / kern['ms']:.1f}% of the bound "
          f"{kern['bound_ms']:.4f} ms), host loop {kern['host_loop_ms']:.4f} ms, plain "
          f"{kern['plain_ms']:.4f} ms", flush=True)
    return dict(frames=n_frames, videos=stats["videos"], chunks=stats["chunks"],
                seconds=stats["seconds"], frames_per_s=fps,
                decode_seconds=stats["decode_seconds"], wait_seconds=stats["wait_seconds"],
                launches=counts, pose_head_chunk=kern)


TRAIN_BATCH = 16
TRAIN_STEPS = 40
TRAIN_CKPT = 20
# the card's f32 step against the CPU's (TF32 off on both): losses within
# rtol 1e-4; each gradient tensor within 1e-3 of its own max |CPU| (sums in
# another order on each side; the encoder's gradients are ill-conditioned
# where the KL term's 1/sigma is large, see tests/test_torch_gpu.py)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3
EVAL_LAUNCHES = {"conv3x3_affine": 8, "up2_conv3_affine": 2, "pose_head": 1,
                 "gaussian_render": 4}


def train_config(cfg, root: Path, name: str, log: str, **training) -> Path:
    """A YAML (JSON is YAML) of ``cfg``'s model for the trainer on phase 6's
    tree, batch 16, a checkpoint every 20 steps, one summary and one test
    sweep (at step 0)."""
    path = root / f"{name}.yaml"
    path.write_text(json.dumps({
        "paths": {"data_dir": str(root / "penn"), "log_dir": str(root / log)},
        "training": {"compute_dtype": cfg.training.compute_dtype, "batch_size": TRAIN_BATCH,
                     "checkpoint_interval": TRAIN_CKPT, "summary_interval": 1000,
                     "test_interval": 1000, "log_interval": 10, **training},
        "model": dataclasses.asdict(cfg.model),
    }))
    return path


def moved_and_finite(run: dict, what: str) -> None:
    """Every loss of a trainer run's last step is finite and every parameter
    tensor differs from its initial value."""
    import torch

    trainer = run["trainer"]
    init = trainer.init_parameters(trainer.config.training.seed)
    still = [k for k, v in trainer.model.state_dict().items()
             if torch.equal(v.detach().cpu(), init[k])]
    check(all(np.isfinite(v) for v in run["metrics"].values()) and not still,
          f"{what}: every loss finite ("
          + ", ".join(f"{k} {v:.4g}" for k, v in run["metrics"].items())
          + f"), all {len(init)} parameter tensors moved")


def train_phase(cfg, card: str, root: Path) -> dict:
    """Stage 2 at Config() in bf16 on phase 6's tree and labels."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.checkpoint import list_checkpoint_steps, load_checkpoint
    from kpvid_tpu_torch.data import HostDataPipeline, SequenceDataset
    from kpvid_tpu_torch.device import to_device
    from kpvid_tpu_torch.train import Stage2Trainer
    from kpvid_tpu_torch.train import main as train_main
    from kpvid_tpu_torch.train.cli import step_noise

    m = cfg.model
    args = ["--mode", "motion_generator", "--max-steps", str(TRAIN_STEPS)]
    ops.reset_launch_counts()
    run = train_main(args + ["--config", str(train_config(cfg, root, "train_a", "log_a"))])
    counts = ops.launch_counts()
    ck = root / "log_a" / "motion_generator"
    check(sum(counts.values()) == 0, f"the trainer launched none of the four kernels: {counts}")
    check(list_checkpoint_steps(ck) == [TRAIN_CKPT, TRAIN_STEPS],
          f"checkpoints at steps {TRAIN_CKPT} and {TRAIN_STEPS}")
    moved_and_finite(run, f"{TRAIN_STEPS} fused steps at Config(), bf16, batch {TRAIN_BATCH}")
    tests = [json.loads(ln) for ln in (ck / "test_metrics.jsonl").read_text().splitlines()]
    images = sorted(p.name for p in (ck / "train_images").iterdir())
    check(len(tests) == 1 and all(np.isfinite(v) for v in tests[0].values()) and len(images) == 8,
          f"one test sweep (finite: loss_G {tests[0]['loss_G']:.4g}) and one summary write "
          f"({len(images)} PNGs)")

    # resume from the step-20 checkpoint in a log dir of its own, to step 40
    shutil.copytree(ck / f"ckpt-{TRAIN_CKPT}", root / "log_b" / "motion_generator"
                    / f"ckpt-{TRAIN_CKPT}")
    resumed = train_main(args + ["--config", str(train_config(cfg, root, "train_b", "log_b"))])
    want = load_checkpoint(ck / f"ckpt-{TRAIN_STEPS}")
    got = load_checkpoint(root / "log_b" / "motion_generator" / f"ckpt-{TRAIN_STEPS}")
    differ = [k for k in want if not np.array_equal(want[k], got.get(k))]
    check(resumed["start_step"] == TRAIN_CKPT + 1 and sorted(got) == sorted(want) and not differ,
          f"resumed at step {resumed['start_step']}, the run ends with the uninterrupted run's "
          f"bits in all {len(want)} arrays (parameters and Adam state); differing: {differ[:5]}")

    for mode in ("fused_dg", "two_batch"):
        other = train_main(["--mode", "motion_generator", "--max-steps", "3", "--no-images",
                            "--config", str(train_config(cfg, root, f"train_{mode}",
                                                         f"log_{mode}", gan_step_mode=mode))])
        moved_and_finite(other, f"3 {mode} steps")

    # one fused step in f32 on the card and on the CPU
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=TRAIN_BATCH))
    ds = SequenceDataset(str(root / "penn"), "train", m.n_pts, m.n_action, image_size=m.image_size)
    batch = next(HostDataPipeline(ds, TRAIN_BATCH, shuffle=True, repeat=True, seed=0).batches())
    noise = step_noise(0, 0, 1, TRAIN_BATCH, m.vae_dim)[0]
    steps = {}
    for dev in ("cuda", "cpu"):
        t = Stage2Trainer(cfg32, device=dev)
        t.load_parameters(t.init_parameters(1))
        first_pt, real_seq, act = t._flatten_batch(batch)
        g_grads, pred, g_m = t.g_grads(first_pt, real_seq, act, noise)
        d_grads, d_m = t.d_grads(real_seq, pred)
        names = t._g_names + t._d_names
        steps[dev] = ({k: float(v) for k, v in {**g_m, **d_m}.items()},
                      {n: g.detach().cpu() for n, g in zip(names, list(g_grads) + list(d_grads))})
    (lc, gc), (lp, gp) = steps["cuda"], steps["cpu"]
    loss_gap = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    grad_gap = {n: float((gc[n] - gp[n]).abs().max()) / max(float(gp[n].abs().max()), 1e-30)
                for n in gp}
    worst = max(grad_gap, key=grad_gap.get)
    print(f"f32 fused step at Config(), batch {TRAIN_BATCH}, card vs CPU: losses "
          + ", ".join(f"{k} {lc[k]:.6g} / {lp[k]:.6g}" for k in lp)
          + f"; worst relative gap: losses {loss_gap:.3e}, gradients {grad_gap[worst]:.3e} "
          f"({worst})", flush=True)
    check(loss_gap <= STEP_LOSS_RTOL and grad_gap[worst] <= STEP_GRAD_REL,
          f"the card's f32 step agrees with the CPU's: losses within {STEP_LOSS_RTOL}, every "
          f"gradient within {STEP_GRAD_REL} of its max")

    # the bf16 step's time: host clock, synchronised, median of 10 after warm-up
    trainer = run["trainer"]
    dev_batch = {k: to_device(v, trainer.device) for k, v in batch.items()}
    dev_noise = to_device(noise, trainer.device)
    for _ in range(3):
        trainer.train_step(dev_batch, dev_noise)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(dev_batch, dev_noise)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(times))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(dev_batch, dev_noise)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_step_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    rep = {"step_ms": step_ms, "step_ms_all": times, "examples_per_s": TRAIN_BATCH / step_ms * 1e3,
           "device_step_ms": device_step_ms if n_kernels else None, "kernels_per_step": n_kernels,
           "seconds_40_steps": run["seconds"], "f32_loss_gap": loss_gap,
           "f32_grad_gap": grad_gap[worst], "f32_grad_gap_tensor": worst,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()}}
    print(f"train on {card}: bf16 step at batch {TRAIN_BATCH}: {step_ms:.2f} ms (median of 10, "
          f"host clock, synchronised; all {', '.join(f'{x:.1f}' for x in times)}), "
          f"{rep['examples_per_s']:.1f} examples/s; the 40-step run took {run['seconds']:.2f} s",
          flush=True)
    if n_kernels:
        print(f"train step device time (torch.profiler, sum of its {n_kernels} kernels): "
              f"{device_step_ms:.3f} ms, {100 * device_step_ms / step_ms:.1f}% of the step; top: "
              + "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                          for e in top),
              flush=True)
    else:
        print("train step device time: not measured, torch.profiler (CUPTI) recorded no "
              "kernel on the card", flush=True)
    return rep


def evaluate_phase(cfg, card: str, root: Path) -> dict:
    """evaluate on phase 6's 8 test videos with phase 7's checkpoint."""
    import torch

    from kpvid_tpu_torch import evaluate, ops

    m = cfg.model
    conf = train_config(cfg, root, "eval", "log_eval")
    ckpt = root / "log_a" / "motion_generator" / f"ckpt-{TRAIN_STEPS}"
    runs, trees, per_batch = [], [], {}
    for name in ("eval_a", "eval_b"):
        ops.reset_launch_counts()
        stats = evaluate.main(["--config", str(conf), "--checkpoint_stage1",
                               str(root / "stage1.npz"), "--checkpoint_stage2", str(ckpt),
                               "--save_dir", str(root / name)])
        counts = ops.launch_counts()
        check(stats["samples"] == 8 and stats["batches"] == 1
              and counts == {k: v * stats["batches"] for k, v in EVAL_LAUNCHES.items()},
              f"evaluate wrote 8 samples in {stats['batches']} batch; launches {counts} are "
              "8 / 2 / 1 / 4 per batch")
        per_batch = {k: v / stats["batches"] for k, v in counts.items()}
        files = {p.relative_to(root / name).as_posix(): p.read_bytes()
                 for p in sorted((root / name).rglob("*.png"))}
        for i in range(8):
            d = root / name / f"{i:04d}"
            ok = ((d / "input_im.png").is_file() and (d / "current_points.png").is_file()
                  and all(len(list((d / sub).glob("*.png"))) == m.n_future_frames
                          for sub in ("real_seq", "pred_seq", "mask", "crude", "pred_points")))
            if not ok:
                raise CheckFailed(f"sample {i}: incomplete PNG tree")
        check(len(files) == 8 * (2 + 5 * m.n_future_frames),
              f"{name}: each sample has 2 PNGs and 5 directories of {m.n_future_frames} PNGs")
        runs.append(stats)
        trees.append(files)
        print(f"evaluate ({name}) on {card}: 8 samples in {stats['seconds']:.3f} s "
              f"({8 / stats['seconds']:.2f} samples/s); waiting for the batch (JPEG decode) "
              f"{stats['data_seconds']:.3f} s, generate and point images "
              f"{stats['generate_seconds']:.3f} s, PNG writers {stats['write_seconds']:.3f} s "
              f"summed over {stats['png_workers']} threads", flush=True)
    check(trees[0] == trees[1], "a second run with the same seed writes the same bytes")

    # #4 at the point images' shapes: current [8, K, 2] on the f32 grid, future
    # [8 * 32, K, 2] on the bf16 grid; JAX writes each map in its points' dtype
    gen = torch.Generator(device="cuda").manual_seed(2)
    s, k = m.image_size, m.n_pts
    rec = {"ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
           "max_abs_err_f32": 0.0}
    tot_bytes = tot_ops = 0.0
    for rows, gd in ((8, torch.float32), (8 * m.n_future_frames, torch.bfloat16)):
        errs, mu = check_render(gen, m, rows, gd, s)
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        args = (mu, s, s, m.heatmap_inv_std, gd, gd)
        t_dev = device_ms(lambda: ops.gaussian_render(*args), reps=10)
        t_host = time_ms(lambda: ops.gaussian_render(*args))
        t_plain = time_ms(lambda: ops.render_gaussian_maps(*args))
        n_bytes = 4.0 * rows * k * 2 + (4.0 if gd == torch.float32 else 2.0) * rows * s * s * k
        n_ops = rows * (s * s * k + 8.0 * k * 2 * s)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        print(f"gaussian_render {tuple(mu.shape)} -> [{rows}, {s}, {s}, {k}] {gd}: device "
              f"{t_dev:.4f} ms ({100 * b_ms / t_dev:.1f}% of the bound {b_ms:.4f} ms, {b_by}), "
              f"host loop {t_host:.4f} ms, plain {t_plain:.4f} ms", flush=True)
        rec["ms"] += t_dev
        rec["host_loop_ms"] += t_host
        rec["plain_ms"] += t_plain
        tot_bytes += n_bytes
        tot_ops += n_ops
    rec["bound_ms"], rec["bound_by"] = bound_ms(tot_bytes, tot_ops, "float32")
    print(f"gaussian_render per evaluate batch (point images, 128^2): device {rec['ms']:.4f} ms "
          f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound {rec['bound_ms']:.4f} ms), "
          f"host loop {rec['host_loop_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms", flush=True)
    return {"runs": runs, "launches_per_batch": per_batch, "render_128": rec,
            "samples_per_s": [8 / r["seconds"] for r in runs]}


KERNEL_META = {
    # the bf16 body the path runs; conv3x3.cu includes it and holds the f32 route
    "conv3x3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3_mma.cuh",
                       "kpvid_tpu/ops/pallas_conv.py:158"),
    "up2_conv3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3_mma.cuh",
                         "kpvid_tpu/ops/pallas_conv.py:434"),
    "pose_head": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                  "kpvid_tpu/ops/pallas_kernels.py:92"),
    "gaussian_render": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                        "kpvid_tpu/ops/pallas_kernels.py:146"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kpvid_tpu_torch.configs import Config
    from kpvid_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)
    build_s = _build.build_all()
    for src, log in _build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{src}: " + " | ".join(regs), flush=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    sass_phase()

    cfg = Config().validate()
    records = kernel_phase(cfg)
    per_bucket = bucket_kernel_phase(cfg)
    params = randomized_params(cfg, seed=0)
    counts = slice_phase(cfg, params)
    f32_path_phase(cfg, params)
    fps = throughput_phase(cfg, params, card)
    serve = serve_phase(cfg, params, card)
    with tempfile.TemporaryDirectory(prefix="kpvid_smoke_") as tmp:
        root = Path(tmp)
        label = label_phase(cfg, params, card, root)
        train = train_phase(cfg, card, root)
        evaluation = evaluate_phase(cfg, card, root)

    kernels = []
    for name, (route, source, replaces) in KERNEL_META.items():
        r = records[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "max_abs_err_f32": r["max_abs_err_f32"], "ms": r["ms"],
            "host_loop_ms": r["host_loop_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launches_per_path": {
                "generate": counts[name],
                "serve_per_batch": serve["pipeline"]["launches_per_batch"][name],
                "label_per_chunk": label["launches"][name] / label["chunks"],
                "evaluate_per_batch": evaluation["launches_per_batch"][name],
                "train_per_step": train["launches_per_step"][name],
            },
        })
        kernels[-1]["max_abs_err_per_bucket"] = {b: e[name] for b, e in per_bucket.items()}
        if "b32" in r:
            kernels[-1]["batch32"] = r["b32"]
        if name == "pose_head":
            kernels[-1]["label_chunk"] = label["pose_head_chunk"]
        if name == "gaussian_render":
            kernels[-1]["evaluate_point_images_128"] = evaluation["render_128"]
    print(json.dumps({"kernels": kernels, "batch": BATCH, "frames_per_s_b32_bf16": fps,
                      "serve": serve, "label": {k: v for k, v in label.items()
                                                if k != "pose_head_chunk"},
                      "train": train, "evaluate": {k: v for k, v in evaluation.items()
                                                   if k != "render_128"},
                      "card": card}))
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
