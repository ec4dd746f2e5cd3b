"""The keypoint path's kernels: fused soft-argmax and Gaussian render, and
their backwards.

All four are in ``csrc/keypoint.cu`` (CUDA C++ for sm_90a, built by ``_build``):

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
- :func:`pose_head_backward` and :func:`gaussian_render_backward` are the
  gradients stage-1 training takes through the two (the TPU kernels have no
  VJP: JAX trains through the jnp forms by autodiff). When the maps require
  a gradient, ``pose_head`` launches the forward's training form, which also
  writes both softmaxes (p [B, K, W], q [B, K, H], f32), and its backward
  writes the maps' gradient from them in the maps' dtype without reading the
  maps; ``gaussian_render``'s backward reduces the maps' cotangent to the
  points' gradient [N, K, 2] f32, one block a frame, in a fixed order. Both
  are ``torch.autograd.Function`` s.

The plain PyTorch versions are ops/coords.py::heatmaps_to_keypoints and
::render_gaussian_maps, and here the backwards' closed forms. Each wrapper
calls its ``torch.ops.kpvid`` op (ops/library.py), whose CPU implementation
is the plain version and whose CUDA implementation launches the kernel or
raises; a CPU tensor that requires a gradient takes the plain forward under
torch autograd. ``launches`` on each wrapper counts its kernel launches; the
backwards count theirs apart from the forwards.
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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kpvid_pose_head.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
        lib.kpvid_pose_head.restype = i
        lib.kpvid_gaussian_render.argtypes = [i, p, p, p, p, i, i, i, i, f, p]
        lib.kpvid_gaussian_render.restype = i
        lib.kpvid_pose_head_backward.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.kpvid_pose_head_backward.restype = i
        lib.kpvid_gaussian_render_backward.argtypes = [i, p, p, p, p, p, i, i, i, i, f, p]
        lib.kpvid_gaussian_render_backward.restype = i
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pose_head_launch(raw_maps: torch.Tensor, marginals: bool):
    """Launch #3 on a CUDA tensor; with ``marginals`` its training form, which
    also returns the two softmaxes p [B, K, W] and q [B, K, H]. The CUDA
    implementation of ``kpvid::pose_head`` and ``kpvid::pose_head_train``."""
    _check_cuda(raw_maps, "pose_head", 4, _DTYPES)
    b, h, w, k = raw_maps.shape
    dev = raw_maps.device
    out = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    p = torch.empty((b, k, w), dtype=torch.float32, device=dev) if marginals else None
    q = torch.empty((b, k, h), dtype=torch.float32, device=dev) if marginals else None
    gx, gy = grid(w, dev), grid(h, dev)
    lib = _lib()
    err = lib.kpvid_pose_head(
        _DTYPES[raw_maps.dtype], raw_maps.data_ptr(), gx.data_ptr(), gy.data_ptr(),
        out.data_ptr(), p.data_ptr() if marginals else None,
        q.data_ptr() if marginals else None, b, h, w, k, _stream(raw_maps),
    )
    _raise_on(err, lib, "pose_head")
    pose_head.launches += 1
    return out, p, q


def pose_head_train_plain(raw_maps: torch.Tensor):
    """Plain version of the training form: (points [B, K, 2], p [B, K, W],
    q [B, K, H]), all f32; the points are heatmaps_to_keypoints's."""
    raw = raw_maps.float()
    p = torch.softmax(raw.mean(dim=1), dim=1)  # [B, W, K]
    q = torch.softmax(raw.mean(dim=2), dim=1)  # [B, H, K]
    x = torch.sum(p * grid(p.shape[1], p.device)[:, None], dim=1)
    y = torch.sum(q * grid(q.shape[1], q.device)[:, None], dim=1)
    return (torch.stack([x, y], dim=-1), p.transpose(1, 2).contiguous(),
            q.transpose(1, 2).contiguous())


def pose_head_backward_plain(g: torch.Tensor, points: torch.Tensor, p: torch.Tensor,
                             q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of #3's backward, the kernel's closed form:
    d raw[b, h, w, k] = g_x p_w (gx_w - x) / H + g_y q_h (gy_h - y) / W, in
    f32, rounded once to ``dtype``."""
    w, h = p.shape[2], q.shape[2]
    cx = g[..., 0:1] * p * (grid(w, p.device) - points[..., 0:1]) / h  # [B, K, W]
    cy = g[..., 1:2] * q * (grid(h, q.device) - points[..., 1:2]) / w  # [B, K, H]
    d = cy[:, :, :, None] + cx[:, :, None, :]  # [B, K, H, W]
    return d.permute(0, 2, 3, 1).to(dtype).contiguous()


def pose_head_backward_launch(g, points, p, q, dtype: torch.dtype) -> torch.Tensor:
    """Launch #3's backward on CUDA tensors; the CUDA implementation of
    ``kpvid::pose_head_backward``."""
    for t, name in ((g, "g"), (points, "points"), (p, "p"), (q, "q")):
        _check_cuda(t, f"pose_head_backward ({name})", 3, (torch.float32,))
    if dtype not in _DTYPES:
        raise ValueError(f"pose_head_backward writes float32 or bfloat16, got {dtype}")
    b, k, w = p.shape
    h = q.shape[2]
    dev = g.device
    out = torch.empty((b, h, w, k), dtype=dtype, device=dev)
    gy, gx = grid(h, dev), grid(w, dev)
    lib = _lib()
    err = lib.kpvid_pose_head_backward(
        _DTYPES[dtype], g.data_ptr(), points.data_ptr(), p.data_ptr(), q.data_ptr(),
        gy.data_ptr(), gx.data_ptr(), out.data_ptr(), b, h, w, k, _stream(g),
    )
    _raise_on(err, lib, "pose_head_backward")
    pose_head_backward.launches += 1
    return out


def pose_head_backward(g: torch.Tensor, points: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The maps' gradient [B, H, W, K] in ``dtype`` from the points'
    cotangent ``g`` [B, K, 2], the forward's points and its softmaxes p
    [B, K, W] and q [B, K, H] (all f32)."""
    return torch.ops.kpvid.pose_head_backward(g, points, p, q, dtype)


class _PoseHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw_maps):
        out, p, q = torch.ops.kpvid.pose_head_train(raw_maps)
        ctx.save_for_backward(out, p, q)
        ctx.maps_dtype = raw_maps.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        out, p, q = ctx.saved_tensors
        return pose_head_backward(g.float().contiguous(), out, p, q, ctx.maps_dtype)


def pose_head(raw_maps: torch.Tensor) -> torch.Tensor:
    """Spatial soft-argmax, fused: [B, H, W, K] f32 or bf16 -> [B, K, 2] f32
    (x, y), differentiable in the maps. A CPU tensor that requires a gradient
    takes the plain version under torch autograd."""
    if torch.is_grad_enabled() and raw_maps.requires_grad:
        if raw_maps.device.type == "cpu":
            return heatmaps_to_keypoints(raw_maps)
        return _PoseHead.apply(raw_maps)
    return torch.ops.kpvid.pose_head(raw_maps)


def render_launch(mu: torch.Tensor, height: int, width: int, inv_std: float,
                  grid_dtype: torch.dtype, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch #4 on a CUDA tensor; the CUDA implementation of
    ``kpvid::gaussian_render``."""
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
        b, height, width, k, inv_std_squared(inv_std, grid_dtype), _stream(mu),
    )
    _raise_on(err, lib, "gaussian_render")
    gaussian_render.launches += 1
    return out


def gaussian_render_backward_plain(dmaps: torch.Tensor, mu: torch.Tensor, inv_std: float,
                                   grid_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of #4's backward, the kernel's closed form:
    d mu_x[n, k] = 2 c2 sum_{h,w} G ey_h ex_w (gx_w - mu_x), d mu_y likewise
    with (gy_h - mu_y), in f32."""
    _, h, w, _ = dmaps.shape
    c2 = inv_std_squared(inv_std, grid_dtype)
    m = mu.float()
    dy = grid(h, mu.device, grid_dtype)[None, :, None] - m[:, None, :, 1]  # [N, H, K]
    dx = grid(w, mu.device, grid_dtype)[None, :, None] - m[:, None, :, 0]  # [N, W, K]
    t = (dmaps.float() * torch.exp(-(dy * dy) * c2)[:, :, None]
         * torch.exp(-(dx * dx) * c2)[:, None])  # [N, H, W, K]
    ax = torch.sum(t * dx[:, None], dim=(1, 2))
    ay = torch.sum(t * dy[:, :, None], dim=(1, 2))
    return 2.0 * c2 * torch.stack([ax, ay], dim=-1)


def render_backward_launch(dmaps: torch.Tensor, mu: torch.Tensor, inv_std: float,
                           grid_dtype: torch.dtype) -> torch.Tensor:
    """Launch #4's backward on CUDA tensors; the CUDA implementation of
    ``kpvid::gaussian_render_backward``."""
    _check_cuda(dmaps, "gaussian_render_backward (dmaps)", 4, _DTYPES)
    _check_cuda(mu, "gaussian_render_backward (mu)", 3, (torch.float32,))
    n, h, w, k = dmaps.shape
    dmu = torch.empty((n, k, 2), dtype=torch.float32, device=mu.device)
    gy, gx = grid(h, mu.device, grid_dtype), grid(w, mu.device, grid_dtype)
    lib = _lib()
    err = lib.kpvid_gaussian_render_backward(
        _DTYPES[dmaps.dtype], dmaps.data_ptr(), mu.data_ptr(), gy.data_ptr(), gx.data_ptr(),
        dmu.data_ptr(), n, h, w, k, inv_std_squared(inv_std, grid_dtype), _stream(mu),
    )
    _raise_on(err, lib, "gaussian_render_backward")
    gaussian_render_backward.launches += 1
    return dmu


def gaussian_render_backward(dmaps: torch.Tensor, mu: torch.Tensor, inv_std: float = 14.3,
                             grid_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The points' gradient [N, K, 2] f32 from the maps' cotangent ``dmaps``
    [N, H, W, K] (f32 or bf16, widened to f32) at the points ``mu``, on the
    grid and c2 of the forward's ``grid_dtype``."""
    return torch.ops.kpvid.gaussian_render_backward(dmaps, mu, inv_std, grid_dtype)


class _GaussianRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, height, width, inv_std, grid_dtype, out_dtype):
        ctx.save_for_backward(mu)
        ctx.inv_std, ctx.grid_dtype = inv_std, grid_dtype
        return torch.ops.kpvid.gaussian_render(mu, height, width, inv_std, grid_dtype, out_dtype)

    @staticmethod
    def backward(ctx, dmaps):
        (mu,) = ctx.saved_tensors
        dmu = gaussian_render_backward(dmaps.contiguous(), mu, ctx.inv_std, ctx.grid_dtype)
        return dmu, None, None, None, None, None


def gaussian_render(mu: torch.Tensor, height: int, width: int, inv_std: float = 14.3,
                    grid_dtype: torch.dtype = torch.float32,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian maps straight into NHWC: [B, K, 2] f32 -> [B, H, W, K] in
    ``out_dtype`` (f32 or bf16), on the grid and inv_std^2 of ``grid_dtype``
    (see render_gaussian_maps); differentiable in ``mu``. A CPU tensor that
    requires a gradient takes the plain version under torch autograd."""
    if torch.is_grad_enabled() and mu.requires_grad:
        if mu.device.type == "cpu":
            return render_gaussian_maps(mu, height, width, inv_std, grid_dtype, out_dtype)
        return _GaussianRender.apply(mu, height, width, inv_std, grid_dtype, out_dtype)
    return torch.ops.kpvid.gaussian_render(mu, height, width, float(inv_std), grid_dtype,
                                           out_dtype)


pose_head.launches = 0
gaussian_render.launches = 0
pose_head_backward.launches = 0
gaussian_render_backward.launches = 0
