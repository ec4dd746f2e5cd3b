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
   its ratio to ``F.conv2d``;
3. serves 4 requests through ``InferenceEngine`` at ``Config()`` with random
   weights from a seed (BN statistics and biases randomized), checks the
   shapes, the uint8 outputs, the mask range, that a seed gives the same
   video twice, and that every generate launched 8 / 2 / 1 / 2 kernels;
   then runs the whole path in float32 through the kernels and through the
   plain versions on the card and compares them;
4. times ``generate`` at batch 32 (1,024 frames, bfloat16), each of its
   stages both ways, and the same call through the plain versions; and
   says whether the pose decoder's raw maps reach the soft-argmax
   contiguous (else what the copy costs).

It exits non-zero on any failed check, and without a CUDA device. The line
before the last holds the kernels' JSON record, the last line the device.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
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


def kernel_phase(cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from kpvid_tpu_torch import ops

    m = cfg.model
    n = BATCH * m.n_future_frames
    hs, s, k_pts = m.heatmap_size, m.image_size, m.n_pts
    f0 = m.translator_filters
    f1, f2 = f0 // 2, f0 // 4
    # (name, input shape, Cout, relu, launches per generate)
    conv_cases = [
        ("oct0 b/c/d", (n, hs, hs, f0), f0, True, 3),
        ("oct1 b/c/d", (n, 2 * hs, 2 * hs, f1), f1, True, 3),
        ("oct2b", (n, s, s, f2), f2, True, 1),
        ("heads", (n, s, s, f2), 4, False, 1),
    ]
    up2_cases = [
        ("oct1a", (n, hs, hs, f0), f1, True, 1),
        ("oct2a", (n, 2 * hs, 2 * hs, f1), f2, True, 1),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    def conv_inputs(shape, cout, dtype):
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / (3 * c**0.5)).to(dtype)
        sc = torch.rand(cout, generator=gen, device="cuda") + 0.5
        sh = torch.randn(cout, generator=gen, device="cuda") * 0.1
        return x, k, sc, sh

    for name, kernel, plain, cases, up2 in (
        ("conv3x3_affine", ops.conv3x3_affine, ops.conv3x3_affine_plain, conv_cases, False),
        ("up2_conv3_affine", ops.up2_conv3_affine, ops.up2_conv3_affine_plain, up2_cases, True),
    ):
        rec = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0,
                   library_ms=0.0 if not up2 else None, max_abs_err=0.0, max_abs_err_f32=0.0)
        for label, shape, cout, relu, mult in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, k, sc, sh = conv_inputs(shape, cout, dtype)
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
        for dtype in (torch.float32, torch.bfloat16):
            raw = (3 * torch.randn((b, s, s, k_pts), generator=gen, device="cuda")).to(dtype)
            got = ops.pose_head(raw)
            torch.cuda.synchronize()
            err = compare(got, ops.heatmaps_to_keypoints(raw), torch.float32)
            key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
            rec[key] = max(rec[key], err)
            print(f"pose_head {tuple(raw.shape)} {dtype}: max abs err {err:.3e}", flush=True)
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
            mu = (torch.rand((rows, k_pts, 2), generator=gen, device="cuda") * 2 - 1)
            mu = mu.to(gd).float()
            for od in (torch.float32, torch.bfloat16):
                got = ops.gaussian_render(mu, hs, hs, m.heatmap_inv_std, gd, od)
                torch.cuda.synchronize()
                want = ops.render_gaussian_maps(mu, hs, hs, m.heatmap_inv_std, gd, od)
                if od == torch.float32:
                    err = compare(got, want, torch.float32)
                    rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], err)
                else:
                    err = compare_one_bf16_step(got, want)
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                print(f"gaussian_render {tuple(mu.shape)} {gd} grid -> {od}: max abs err "
                      f"{err:.3e}", flush=True)
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
    import dataclasses

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
    params = randomized_params(cfg, seed=0)
    counts = slice_phase(cfg, params)
    f32_path_phase(cfg, params)
    fps = throughput_phase(cfg, params, card)

    kernels = []
    for name, (route, source, replaces) in KERNEL_META.items():
        r = records[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "max_abs_err_f32": r["max_abs_err_f32"], "ms": r["ms"],
            "host_loop_ms": r["host_loop_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        if "b32" in r:
            kernels[-1]["batch32"] = r["b32"]
    print(json.dumps({"kernels": kernels, "batch": BATCH, "frames_per_s_b32_bf16": fps,
                      "card": card}))
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
