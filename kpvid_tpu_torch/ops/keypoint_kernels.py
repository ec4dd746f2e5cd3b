"""Triton kernels for the keypoint path: fused soft-argmax and Gaussian render.

- :func:`pose_head` replaces kpvid_tpu/ops/pallas_kernels.py::pose_head_pallas
  (the ``pl.pallas_call`` at pallas_kernels.py:92): raw heatmaps
  [B, H, W, K] -> keypoints [B, K, 2] (x, y), in one pass over the heatmap.
  The TPU kernel carries the sum over H from one grid step to the next in
  scratch memory; blocks on the card run in no order, so here one program
  owns a (batch, K-block) pair and loops over H itself: it sums rows into
  the W-marginal and keeps an online softmax (running max, sum and weighted
  sum) of the H-marginal. Bound: the bytes of the heatmap, read once.
- :func:`gaussian_render` replaces pallas_kernels.py::gaussian_render_pallas
  (pallas_kernels.py:146): keypoints [B, K, 2] -> maps [B, H, W, K] in f32,
  written straight in NHWC. One program per (batch, row). Bound: the bytes
  of the maps, written once.

K = 40 needs no padding: Triton masks the ragged channel block. The plain
PyTorch versions are ops/coords.py::heatmaps_to_keypoints and
::render_gaussian_maps; each wrapper takes them for a tensor on the CPU and
launches its kernel for a CUDA tensor or raises. ``launches`` on each
wrapper counts its kernel launches. ``triton`` is imported at the first
launch, never when this module is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import heatmaps_to_keypoints, render_gaussian_maps

tl = None  # triton.language, bound at the first launch
_jitted: dict = {}


def _pose_head_kernel(raw_ptr, out_ptr, H, W, K, inv_h, inv_w, step_h, step_w,
                      BH: "tl.constexpr", BW: "tl.constexpr", BK: "tl.constexpr"):
    b = tl.program_id(0)
    ks = tl.program_id(1) * BK + tl.arange(0, BK)
    kmask = ks < K
    ws = tl.arange(0, BW)
    wmask = ws < W
    base = raw_ptr + b.to(tl.int64) * H * W * K
    sum_w = tl.zeros([BW, BK], dtype=tl.float32)
    m_run = tl.full([BK], float("-inf"), tl.float32)
    s_run = tl.zeros([BK], dtype=tl.float32)
    t_run = tl.zeros([BK], dtype=tl.float32)
    for h0 in range(0, H, BH):
        hs = h0 + tl.arange(0, BH)
        hmask = hs < H
        ptrs = base + (hs[:, None, None] * W + ws[None, :, None]) * K + ks[None, None, :]
        mask = hmask[:, None, None] & wmask[None, :, None] & kmask[None, None, :]
        x = tl.load(ptrs, mask=mask, other=0.0)
        sum_w += tl.sum(x, axis=0)
        mh = tl.sum(x, axis=1) * inv_w  # [BH, BK] means over W
        mh = tl.where(hmask[:, None], mh, float("-inf"))
        m_new = tl.maximum(m_run, tl.max(mh, axis=0))
        alpha = tl.exp(m_run - m_new)
        e = tl.exp(mh - m_new[None, :])
        gy = hs.to(tl.float32) * step_h - 1.0
        s_run = s_run * alpha + tl.sum(e, axis=0)
        t_run = t_run * alpha + tl.sum(e * gy[:, None], axis=0)
        m_run = m_new
    y = t_run / s_run
    mw = tl.where(wmask[:, None], sum_w * inv_h, float("-inf"))  # [BW, BK] means over H
    ew = tl.exp(mw - tl.max(mw, axis=0)[None, :])
    gx = ws.to(tl.float32) * step_w - 1.0
    x_out = tl.sum(ew * gx[:, None], axis=0) / tl.sum(ew, axis=0)
    optr = out_ptr + (b.to(tl.int64) * K + ks) * 2
    tl.store(optr, x_out, mask=kmask)
    tl.store(optr + 1, y, mask=kmask)


def _render_kernel(mu_ptr, out_ptr, H, W, K, step_h, step_w, c2,
                   BW: "tl.constexpr", BK: "tl.constexpr"):
    n = tl.program_id(0).to(tl.int64)
    h = tl.program_id(1)
    ks = tl.arange(0, BK)
    kmask = ks < K
    mx = tl.load(mu_ptr + (n * K + ks) * 2, mask=kmask, other=0.0)
    my = tl.load(mu_ptr + (n * K + ks) * 2 + 1, mask=kmask, other=0.0)
    gy = h.to(tl.float32) * step_h - 1.0
    dy = gy - my
    ey = tl.exp(-(dy * dy) * c2)  # [BK]
    ws = tl.arange(0, BW)
    wmask = ws < W
    gx = ws.to(tl.float32) * step_w - 1.0
    dx = gx[:, None] - mx[None, :]
    ex = tl.exp(-(dx * dx) * c2)  # [BW, BK]
    val = ey[None, :] * ex
    optr = out_ptr + ((n * H + h) * W + ws[:, None]) * K + ks[None, :]
    tl.store(optr, val, mask=wmask[:, None] & kmask[None, :])


def _jit(fn):
    global tl
    if fn.__name__ not in _jitted:
        import triton
        import triton.language

        tl = triton.language
        _jitted[fn.__name__] = triton.jit(fn)
    return _jitted[fn.__name__]


def _step(size: int) -> float:
    return 2.0 / (size - 1) if size > 1 else 0.0


def _check_cuda(t: torch.Tensor, name: str, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} kernel takes a contiguous float32 {ndim}-d tensor, "
            f"got {t.dtype} {tuple(t.shape)}"
        )


def pose_head(raw_maps: torch.Tensor) -> torch.Tensor:
    """Spatial soft-argmax, fused: [B, H, W, K] f32 -> [B, K, 2] (x, y)."""
    if raw_maps.device.type == "cpu":
        return heatmaps_to_keypoints(raw_maps)
    _check_cuda(raw_maps, "pose_head", 4)
    b, h, w, k = raw_maps.shape
    out = torch.empty((b, k, 2), dtype=torch.float32, device=raw_maps.device)
    bw = max(16, 1 << (w - 1).bit_length())
    bk = 8
    bh = max(1, 8192 // (bw * bk))
    kern = _jit(_pose_head_kernel)
    kern[(b, -(-k // bk))](
        raw_maps, out, h, w, k, 1.0 / h, 1.0 / w, _step(h), _step(w),
        BH=bh, BW=bw, BK=bk, num_warps=8,
    )
    pose_head.launches += 1
    return out


def gaussian_render(mu: torch.Tensor, height: int, width: int, inv_std: float = 14.3) -> torch.Tensor:
    """Gaussian maps straight into NHWC: [B, K, 2] f32 -> [B, H, W, K] f32."""
    if mu.device.type == "cpu":
        return render_gaussian_maps(mu, height, width, inv_std)
    _check_cuda(mu, "gaussian_render", 3)
    b, k, _ = mu.shape
    out = torch.empty((b, height, width, k), dtype=torch.float32, device=mu.device)
    c2 = float(np.float32(inv_std) * np.float32(inv_std))
    bw = max(16, 1 << (width - 1).bit_length())
    bk = max(16, 1 << (k - 1).bit_length())
    kern = _jit(_render_kernel)
    kern[(b, height)](
        mu, out, height, width, k, _step(height), _step(width), c2,
        BW=bw, BK=bk, num_warps=4,
    )
    gaussian_render.launches += 1
    return out


pose_head.launches = 0
gaussian_render.launches = 0
