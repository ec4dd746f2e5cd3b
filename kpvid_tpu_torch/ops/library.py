"""The port's kernels as ``torch.library`` custom ops, namespace ``kpvid``.

Registering the kernels makes them ordinary operators to the rest of
PyTorch: ``torch.export`` records a call as one ``torch.ops.kpvid.*`` node
instead of failing on ``data_ptr()`` of a fake tensor or baking in the
branch a wrapper took, and a program exported on one device runs on
another through the registration of that device. Each op has

- a CPU implementation: the plain PyTorch version (ops/conv3x3.py,
  ops/coords.py, ops/keypoint_kernels.py);
- a CUDA implementation: the ctypes launch of the hand-written kernel, which
  launches or raises, and counts its launches (``ops.launch_counts``);
- a fake implementation: shapes and dtypes only; it launches and counts
  nothing, so tracing moves no counter.

No device has another implementation, and none falls back to another. The
ops, by TPU kernel they replace:

  #1  kpvid::conv3x3_affine        [N,H,W,C] -> [N,H,W,Cout], x.dtype
  #2  kpvid::up2_conv3_affine      [N,H,W,C] -> [N,2H,2W,Cout], x.dtype
  #3  kpvid::pose_head             [B,H,W,K] -> [B,K,2] f32
      kpvid::pose_head_train       -> ([B,K,2], p [B,K,W], q [B,K,H]) f32
  #4  kpvid::gaussian_render       [B,K,2] f32 -> [B,H,W,K] out_dtype
  #3' kpvid::pose_head_backward    -> the maps' gradient [B,H,W,K] in dtype
  #4' kpvid::gaussian_render_backward  -> [N,K,2] f32

Importing ``kpvid_tpu_torch.ops`` registers them; nothing is built until a
CUDA implementation first runs.
"""

import torch
from torch import Tensor

from . import conv3x3 as _conv
from . import keypoint_kernels as _kp
from .coords import heatmaps_to_keypoints, render_gaussian_maps

def _custom_op(name: str):
    return torch.library.custom_op(f"kpvid::{name}", mutates_args=(), device_types="cpu")


# --- #1 / #2: the fused conv + affine --------------------------------------


@_custom_op("conv3x3_affine")
def conv3x3_affine(x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                   relu: bool) -> Tensor:
    return _conv.conv3x3_affine_plain(x, kernel, scale, shift, relu)


@conv3x3_affine.register_kernel("cuda")
def _(x, kernel, scale, shift, relu):
    return _conv.launch(x, kernel, scale, shift, relu, up2=False)


@conv3x3_affine.register_fake
def _(x, kernel, scale, shift, relu):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, kernel.shape[3]))


@_custom_op("up2_conv3_affine")
def up2_conv3_affine(x: Tensor, kernel: Tensor, scale: Tensor, shift: Tensor,
                     relu: bool) -> Tensor:
    return _conv.up2_conv3_affine_plain(x, kernel, scale, shift, relu)


@up2_conv3_affine.register_kernel("cuda")
def _(x, kernel, scale, shift, relu):
    return _conv.launch(x, kernel, scale, shift, relu, up2=True)


@up2_conv3_affine.register_fake
def _(x, kernel, scale, shift, relu):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, kernel.shape[3]))


# --- #3: the soft-argmax, its training form and its backward ----------------


@_custom_op("pose_head")
def pose_head(raw_maps: Tensor) -> Tensor:
    return heatmaps_to_keypoints(raw_maps)


@pose_head.register_kernel("cuda")
def _(raw_maps):
    return _kp.pose_head_launch(raw_maps, marginals=False)[0]


@pose_head.register_fake
def _(raw_maps):
    b, _, _, k = raw_maps.shape
    return raw_maps.new_empty((b, k, 2), dtype=torch.float32)


@_custom_op("pose_head_train")
def pose_head_train(raw_maps: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return _kp.pose_head_train_plain(raw_maps)


@pose_head_train.register_kernel("cuda")
def _(raw_maps):
    return _kp.pose_head_launch(raw_maps, marginals=True)


@pose_head_train.register_fake
def _(raw_maps):
    b, h, w, k = raw_maps.shape
    f32 = torch.float32
    return (raw_maps.new_empty((b, k, 2), dtype=f32), raw_maps.new_empty((b, k, w), dtype=f32),
            raw_maps.new_empty((b, k, h), dtype=f32))


@_custom_op("pose_head_backward")
def pose_head_backward(g: Tensor, points: Tensor, p: Tensor, q: Tensor,
                       dtype: torch.dtype) -> Tensor:
    return _kp.pose_head_backward_plain(g, points, p, q, dtype)


@pose_head_backward.register_kernel("cuda")
def _(g, points, p, q, dtype):
    return _kp.pose_head_backward_launch(g, points, p, q, dtype)


@pose_head_backward.register_fake
def _(g, points, p, q, dtype):
    b, k, w = p.shape
    return g.new_empty((b, q.shape[2], w, k), dtype=dtype)


# --- #4: the Gaussian render and its backward --------------------------------


@_custom_op("gaussian_render")
def gaussian_render(mu: Tensor, height: int, width: int, inv_std: float,
                    grid_dtype: torch.dtype, out_dtype: torch.dtype) -> Tensor:
    return render_gaussian_maps(mu, height, width, inv_std, grid_dtype, out_dtype)


@gaussian_render.register_kernel("cuda")
def _(mu, height, width, inv_std, grid_dtype, out_dtype):
    return _kp.render_launch(mu, height, width, inv_std, grid_dtype, out_dtype)


@gaussian_render.register_fake
def _(mu, height, width, inv_std, grid_dtype, out_dtype):
    b, k, _ = mu.shape
    return mu.new_empty((b, height, width, k), dtype=out_dtype)


@_custom_op("gaussian_render_backward")
def gaussian_render_backward(dmaps: Tensor, mu: Tensor, inv_std: float,
                             grid_dtype: torch.dtype) -> Tensor:
    return _kp.gaussian_render_backward_plain(dmaps, mu, inv_std, grid_dtype)


@gaussian_render_backward.register_kernel("cuda")
def _(dmaps, mu, inv_std, grid_dtype):
    return _kp.render_backward_launch(dmaps, mu, inv_std, grid_dtype)


@gaussian_render_backward.register_fake
def _(dmaps, mu, inv_std, grid_dtype):
    n, _, _, k = dmaps.shape
    return mu.new_empty((n, k, 2), dtype=torch.float32)

