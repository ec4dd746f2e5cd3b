#!/usr/bin/env python3
"""Drive kpvid_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. It
imports nothing of JAX or of the JAX package, and:

1. builds the CUDA kernels from ``kpvid_tpu_torch/csrc`` (one nvcc per
   source, started together) and prints the build time;
2. holds every kernel of the generation path against its plain PyTorch
   version, on the card, at the shapes the path gives it at ``Config()``
   with 4 requests (N = 4 * 32 frames): float32 with TF32 off (rtol 1e-4,
   atol 1e-4) and bfloat16 (max |kernel - plain| <= 2% of max |plain|: the
   kernel rounds once, the plain version rounds the conv output and then
   the affine). It times the kernel, the plain version and, for the conv,
   one ``F.conv2d`` call in channels_last bfloat16 with the BN scale folded
   into the weights (a yardstick the port never calls), with CUDA events;
3. serves 4 requests through ``InferenceEngine`` at ``Config()`` with random
   weights from a seed (BN statistics and biases randomized), checks the
   shapes, the uint8 outputs, the mask range, that a seed gives the same
   video twice, and that every generate launched 8 / 2 / 1 / 2 kernels;
   then runs the whole path in float32 through the kernels and through the
   plain versions on the card and compares them;
4. times ``generate`` at batch 32 (1,024 frames, bfloat16), each of its
   stages, and the same call through the plain versions.

It exits non-zero on any failed check, and without a CUDA device. The line
before the last holds the kernels' JSON record, the last line the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_TOL = 0.02
BATCH = 4
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
        rec = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0,
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
            t_k = time_ms(lambda: kernel(x, k, sc, sh, relu=relu))
            t_p = time_ms(lambda: plain(x, k, sc, sh, relu=relu))
            nb, h, w, c = shape
            oh, ow = (2 * h, 2 * w) if up2 else (h, w)
            n_ops = 2.0 * nb * oh * ow * cout * 9 * c
            n_bytes = 2.0 * (nb * h * w * c + 9 * c * cout + nb * oh * ow * cout) + 8 * cout
            b_ms, _ = bound_ms(n_bytes, n_ops, "bfloat16")
            line = (f"{name} {label} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({n_ops / t_k / 1e9:.1f} TFLOP/s)")
            if not up2:
                xc = x.permute(0, 3, 1, 2)  # channels_last view
                wc = (k.float() * sc).to(x.dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bias = sh.to(x.dtype)
                t_l = time_ms(lambda: F.conv2d(xc, wc, bias, padding=1))
                rec["library_ms"] += mult * t_l
                line += f", F.conv2d {t_l:.4f} ms"
            print(line + f", x{mult} per generate", flush=True)
            rec["ms"] += mult * t_k
            rec["plain_ms"] += mult * t_p
            rec["ops"] += mult * n_ops
            rec["bytes"] += mult * n_bytes
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"], "bfloat16")
        records[name] = rec

    # pose head: raw heatmaps of the 4 request images; the path computes them in
    # the compute dtype and converts to f32, so the bf16 setting rounds first
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    for dtype in (torch.float32, torch.bfloat16):
        raw = torch.randn((BATCH, s, s, k_pts), generator=gen, device="cuda").to(dtype).float()
        got = ops.pose_head(raw)
        torch.cuda.synchronize()
        err = compare(got, ops.heatmaps_to_keypoints(raw), torch.float32)
        rec["max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"] = err
        print(f"pose_head {tuple(raw.shape)} from {dtype}: max abs err {err:.3e}", flush=True)
    rec["ms"] = time_ms(lambda: ops.pose_head(raw))
    rec["plain_ms"] = time_ms(lambda: ops.heatmaps_to_keypoints(raw))
    n_bytes = 4.0 * (raw.numel() + BATCH * k_pts * 2)
    n_ops = 2.0 * raw.numel() + 6.0 * BATCH * k_pts * 2 * s
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops, "float32")
    records["pose_head"] = rec

    # gaussian render: the current maps ([B, K, 2]) and the future maps ([B*T, K, 2])
    rec = dict(ms=0.0, plain_ms=0.0, library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    tot_bytes = tot_ops = 0.0
    for rows in (BATCH, n):
        for dtype in (torch.float32, torch.bfloat16):
            mu = (torch.rand((rows, k_pts, 2), generator=gen, device="cuda") * 2 - 1)
            mu = mu.to(dtype).float()
            got = ops.gaussian_render(mu, hs, hs, m.heatmap_inv_std)
            torch.cuda.synchronize()
            want = ops.render_gaussian_maps(mu, hs, hs, m.heatmap_inv_std)
            err = compare(got, want, torch.float32)
            key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
            rec[key] = max(rec[key], err)
            print(f"gaussian_render {tuple(mu.shape)} from {dtype}: max abs err {err:.3e}",
                  flush=True)
        rec["ms"] += time_ms(lambda: ops.gaussian_render(mu, hs, hs, m.heatmap_inv_std))
        rec["plain_ms"] += time_ms(lambda: ops.render_gaussian_maps(mu, hs, hs, m.heatmap_inv_std))
        tot_bytes += 4.0 * (rows * k_pts * 2 + rows * hs * hs * k_pts)
        tot_ops += rows * (hs * hs * k_pts + 8.0 * k_pts * 2 * hs)
    rec["bound_ms"], rec["bound_by"] = bound_ms(tot_bytes, tot_ops, "float32")
    records["gaussian_render"] = rec
    for name, r in records.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name} per generate at batch {BATCH}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return records


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
        for name, fn in stages.items():
            print(f"stage at batch {b} bf16: {name} {time_ms(fn, 1.0):.3f} ms", flush=True)

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
    "conv3x3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3.cu",
                       "kpvid_tpu/ops/pallas_conv.py:158"),
    "up2_conv3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3.cu",
                         "kpvid_tpu/ops/pallas_conv.py:434"),
    "pose_head": ("triton", "kpvid_tpu_torch/ops/keypoint_kernels.py",
                  "kpvid_tpu/ops/pallas_kernels.py:92"),
    "gaussian_render": ("triton", "kpvid_tpu_torch/ops/keypoint_kernels.py",
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
            "max_abs_err_f32": r["max_abs_err_f32"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "batch": BATCH, "frames_per_s_b32_bf16": fps,
                      "card": card}))
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
