"""The keypoint path's kernels: fused soft-argmax and Gaussian render.

Both are in ``csrc/keypoint.cu`` (CUDA C++ for sm_90a, built by ``_build``):

- :func:`pose_head` replaces kpvid_tpu/ops/pallas_kernels.py::pose_head_pallas
  (the ``pl.pallas_call`` at pallas_kernels.py:92): raw heatmaps [B, H, W, K]
  in f32 or bf16 -> keypoints [B, K, 2] (x, y) in f32, converting in
  registers as the TPU kernel does. Bound: the heatmap's bytes, read once.
  The TPU kernel carries the W-marginal across grid steps; here a cluster of
  8 blocks takes one image, each block a band of rows, and the blocks
  combine their partial sums through distributed shared memory: one launch,
  no atomics, a fixed order of every sum.
- :func:`gaussian_render` replaces pallas_kernels.py::gaussian_render_pallas
  (pallas_kernels.py:146): keypoints [N, K, 2] f32 -> maps [N, H, W, K]
  written once in ``out_dtype`` (the TPU kernel's ``dtype``), straight in
  NHWC with 16-byte stores. Bound: the maps' bytes, written once. A block
  takes a band of rows of one frame and computes the separable exponentials
  once into shared memory. The grid and c2 are those of the plain version
  (coords.grid and inv_std_squared), so a bf16 ``grid_dtype`` takes JAX's
  values.

The plain PyTorch versions are ops/coords.py::heatmaps_to_keypoints and
::render_gaussian_maps; each wrapper takes them for a tensor on the CPU and
launches its kernel for a CUDA tensor or raises. ``launches`` on each
wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .coords import grid, heatmaps_to_keypoints, inv_std_squared, render_gaussian_maps

_SOURCE = "keypoint.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_kpvid_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kpvid_pose_head.argtypes = [i, p, p, p, p, i, i, i, i, p]
        lib.kpvid_pose_head.restype = i
        lib.kpvid_gaussian_render.argtypes = [i, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.kpvid_gaussian_render.restype = i
        lib.kpvid_cuda_error_string.argtypes = [i]
        lib.kpvid_cuda_error_string.restype = ctypes.c_char_p
        lib._kpvid_bound = True
    return lib


def _check_cuda(t: torch.Tensor, name: str, ndim: int, dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} kernel takes a contiguous {ndim}-d tensor of "
            f"{', '.join(str(d) for d in dtypes)}, got {t.dtype} {tuple(t.shape)}"
        )


def _raise_on(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.kpvid_cuda_error_string(err).decode()}"
        )


def pose_head(raw_maps: torch.Tensor) -> torch.Tensor:
    """Spatial soft-argmax, fused: [B, H, W, K] f32 or bf16 -> [B, K, 2] f32 (x, y)."""
    if raw_maps.device.type == "cpu":
        return heatmaps_to_keypoints(raw_maps)
    _check_cuda(raw_maps, "pose_head", 4, _DTYPES)
    b, h, w, k = raw_maps.shape
    out = torch.empty((b, k, 2), dtype=torch.float32, device=raw_maps.device)
    gx = grid(w, raw_maps.device)
    gy = grid(h, raw_maps.device)
    lib = _lib()
    err = lib.kpvid_pose_head(
        _DTYPES[raw_maps.dtype], raw_maps.data_ptr(), gx.data_ptr(), gy.data_ptr(),
        out.data_ptr(), b, h, w, k, torch.cuda.current_stream(raw_maps.device).cuda_stream,
    )
    _raise_on(err, lib, "pose_head")
    pose_head.launches += 1
    return out


def gaussian_render(mu: torch.Tensor, height: int, width: int, inv_std: float = 14.3,
                    grid_dtype: torch.dtype = torch.float32,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian maps straight into NHWC: [B, K, 2] f32 -> [B, H, W, K] in
    ``out_dtype`` (f32 or bf16), on the grid and inv_std^2 of ``grid_dtype``
    (see render_gaussian_maps)."""
    if mu.device.type == "cpu":
        return render_gaussian_maps(mu, height, width, inv_std, grid_dtype, out_dtype)
    _check_cuda(mu, "gaussian_render", 3, (torch.float32,))
    if out_dtype not in _DTYPES:
        raise ValueError(f"gaussian_render kernel writes float32 or bfloat16, got {out_dtype}")
    b, k, _ = mu.shape
    out = torch.empty((b, height, width, k), dtype=out_dtype, device=mu.device)
    gy = grid(height, mu.device, grid_dtype)
    gx = grid(width, mu.device, grid_dtype)
    lib = _lib()
    err = lib.kpvid_gaussian_render(
        _DTYPES[out_dtype], mu.data_ptr(), gy.data_ptr(), gx.data_ptr(), out.data_ptr(),
        b, height, width, k, inv_std_squared(inv_std, grid_dtype),
        torch.cuda.current_stream(mu.device).cuda_stream,
    )
    _raise_on(err, lib, "gaussian_render")
    gaussian_render.launches += 1
    return out


pose_head.launches = 0
gaussian_render.launches = 0
