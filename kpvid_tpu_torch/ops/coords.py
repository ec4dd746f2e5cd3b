"""Keypoint coordinate ops: spatial soft-argmax and Gaussian rendering.

Counterpart of kpvid_tpu/ops/coords.py, in plain PyTorch. Keypoints live
in [-1, 1]^2 on ``linspace(-1, 1, size)`` grids that include both ends,
stored as (x, y). The fused kernels of the same functions are in
``keypoint_kernels.py``; ``colorize_point_maps`` (a max-reduce in JAX, no
kernel there) stays plain.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def grid(size: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``linspace(-1, 1, size)`` as f32 values. For bfloat16, computed as
    jnp.linspace computes it in bf16: ``step = i / (size - 1)``, then
    ``-(1 - step) + step``, each operation rounded to bf16, which is not
    ``linspace(...).to(bfloat16)``: at size 8 the two differ by 0.0039.
    Cached per (size, device, dtype); callers must not write to it."""
    if dtype == torch.float32 or size < 2:
        return torch.linspace(-1.0, 1.0, size, dtype=torch.float32, device=device)
    div = size - 1
    step = torch.arange(div, dtype=dtype, device=device) / torch.tensor(div, dtype=dtype)
    ends = torch.ones(1, dtype=dtype, device=device)
    return torch.cat([-(1 - step) + step, ends]).float()


@functools.lru_cache(maxsize=None)
def inv_std_squared(inv_std: float, dtype: torch.dtype = torch.float32) -> float:
    """``inv_std ** 2`` as JAX computes it in ``dtype``: ``inv_std`` rounded
    to dtype, squared, and the square rounded to dtype."""
    c = torch.tensor(inv_std, dtype=dtype)
    return float(c * c)


def soft_argmax_1d(logits: torch.Tensor, dim: int) -> torch.Tensor:
    """Expectation of softmax(logits) along ``dim`` against the [-1, 1] grid."""
    probs = torch.softmax(logits, dim=dim)
    shape = [1] * logits.dim()
    shape[dim] = logits.shape[dim]
    g = grid(logits.shape[dim], logits.device).reshape(shape)
    return torch.sum(probs * g, dim=dim)


def heatmaps_to_keypoints(raw_maps: torch.Tensor) -> torch.Tensor:
    """Raw heatmaps [B, H, W, K] -> keypoints [B, K, 2] (x, y), in f32.
    x is the soft-argmax of the mean over H, y that of the mean over W."""
    raw = raw_maps.float()
    x = soft_argmax_1d(raw.mean(dim=1), dim=1)  # [B, W, K] -> [B, K]
    y = soft_argmax_1d(raw.mean(dim=2), dim=1)  # [B, H, K] -> [B, K]
    return torch.stack([x, y], dim=-1)


def render_gaussian_maps(
    mu: torch.Tensor, height: int, width: int, inv_std: float = 14.3,
    grid_dtype: torch.dtype = torch.float32, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Keypoints [..., K, 2] (x, y) -> maps [..., H, W, K] in ``out_dtype``:
    exp(-((gy - mu_y)^2 + (gx - mu_x)^2) * inv_std^2), computed separably as
    exp(-(gy - mu_y)^2 c2) * exp(-(gx - mu_x)^2 c2).

    The grid and c2 = inv_std^2 take the values JAX gives them in
    ``grid_dtype`` (the keypoints' dtype there); the arithmetic is f32, and
    the product is rounded once to ``out_dtype``, into contiguous NHWC as the
    kernel writes it."""
    batch_shape = mu.shape[:-2]
    k = mu.shape[-2]
    mu2 = mu.float().reshape(-1, k, 2)
    c2 = inv_std_squared(inv_std, grid_dtype)
    gy = grid(height, mu.device, grid_dtype)[None, None, :]
    gx = grid(width, mu.device, grid_dtype)[None, None, :]
    ey = torch.exp(-torch.square(gy - mu2[..., 1:2]) * c2)  # [B, K, H]
    ex = torch.exp(-torch.square(gx - mu2[..., 0:1]) * c2)  # [B, K, W]
    maps = ey[:, :, :, None] * ex[:, :, None, :]  # [B, K, H, W]
    maps = maps.permute(0, 2, 3, 1)
    return maps.reshape(*batch_shape, height, width, k).to(out_dtype).contiguous()


def blend(background: torch.Tensor, crude: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask keeps the background, (1 - mask) takes the crude prediction."""
    return background * mask + crude * (1.0 - mask)


def colorize_point_maps(maps: torch.Tensor, colors) -> torch.Tensor:
    """Tint each keypoint map with its color and take the max over the
    keypoints: maps [..., H, W, K], colors [K, 3] -> [..., H, W, 3], in the
    maps' dtype (the colors rounded to it, as JAX does). One channel at a
    time, so no [..., H, W, K, 3] product is held. ``colors`` is a host
    array, copied to the maps' device with a wait on the host, or a tensor
    already there in any float dtype, which takes no host copy and no wait
    (the colors are the same bytes either way)."""
    colors = torch.as_tensor(colors).to(device=maps.device, dtype=maps.dtype)
    return torch.stack([(maps * colors[:, c]).amax(dim=-1) for c in range(3)], dim=-1)
