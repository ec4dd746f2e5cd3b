"""2x bilinear upsampling with TF1-legacy sampling, NHWC.

Counterpart of kpvid_tpu/ops/resize.py. For an exact 2x upsample the TF1
default (bilinear, align_corners=False, legacy centers) is

    out[2i]   = in[i]
    out[2i+1] = (in[i] + in[i+1]) / 2     (edge-clamped)

applied along H, then along W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _up2_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    mid = (x + nxt) * 0.5
    out = torch.stack([x, mid], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return out.reshape(shape)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], TF1-legacy stencil with the edge clamp."""
    return _up2_axis(_up2_axis(x, 1), 2)


def conv3x3_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv, NHWC input, HWIO kernel, in x.dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def up2_conv3(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3x3_SAME(upsample2x(x)) with the upsample materialized.
    x: [B, H, W, C]; k3: [3, 3, C, F] -> [B, 2H, 2W, F]."""
    y = conv3x3_same(upsample2x(x), k3)
    return y if bias is None else y + bias.to(y.dtype)
