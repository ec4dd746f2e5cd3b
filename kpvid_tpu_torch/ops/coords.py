"""Keypoint coordinate ops: spatial soft-argmax and Gaussian rendering.

Counterpart of kpvid_tpu/ops/coords.py, in plain PyTorch. Keypoints live
in [-1, 1]^2 on ``linspace(-1, 1, size)`` grids that include both ends,
stored as (x, y). The fused kernels of the same functions are in
``keypoint_kernels.py``.
"""

from __future__ import annotations

import torch


def _grid(size: int, device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, size, dtype=torch.float32, device=device)


def soft_argmax_1d(logits: torch.Tensor, dim: int) -> torch.Tensor:
    """Expectation of softmax(logits) along ``dim`` against the [-1, 1] grid."""
    probs = torch.softmax(logits, dim=dim)
    shape = [1] * logits.dim()
    shape[dim] = logits.shape[dim]
    grid = _grid(logits.shape[dim], logits.device).reshape(shape)
    return torch.sum(probs * grid, dim=dim)


def heatmaps_to_keypoints(raw_maps: torch.Tensor) -> torch.Tensor:
    """Raw heatmaps [B, H, W, K] -> keypoints [B, K, 2] (x, y), in f32.
    x is the soft-argmax of the mean over H, y that of the mean over W."""
    raw = raw_maps.float()
    x = soft_argmax_1d(raw.mean(dim=1), dim=1)  # [B, W, K] -> [B, K]
    y = soft_argmax_1d(raw.mean(dim=2), dim=1)  # [B, H, K] -> [B, K]
    return torch.stack([x, y], dim=-1)


def render_gaussian_maps(
    mu: torch.Tensor, height: int, width: int, inv_std: float = 14.3
) -> torch.Tensor:
    """Keypoints [..., K, 2] (x, y) -> maps [..., H, W, K] in f32:
    exp(-((gy - mu_y)^2 + (gx - mu_x)^2) * inv_std^2), computed separably as
    exp(-(gy - mu_y)^2 c2) * exp(-(gx - mu_x)^2 c2)."""
    batch_shape = mu.shape[:-2]
    k = mu.shape[-2]
    mu2 = mu.float().reshape(-1, k, 2)
    c2 = torch.tensor(inv_std, dtype=torch.float32) ** 2
    gy = _grid(height, mu.device)[None, None, :]
    gx = _grid(width, mu.device)[None, None, :]
    ey = torch.exp(-torch.square(gy - mu2[..., 1:2]) * c2.to(mu.device))  # [B, K, H]
    ex = torch.exp(-torch.square(gx - mu2[..., 0:1]) * c2.to(mu.device))  # [B, K, W]
    maps = ey[:, :, :, None] * ex[:, :, None, :]  # [B, K, H, W]
    maps = maps.permute(0, 2, 3, 1)
    return maps.reshape(*batch_shape, height, width, k)


def blend(background: torch.Tensor, crude: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask keeps the background, (1 - mask) takes the crude prediction."""
    return background * mask + crude * (1.0 - mask)
