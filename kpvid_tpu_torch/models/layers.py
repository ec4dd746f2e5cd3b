"""Primitive layers, NHWC at every boundary.

Counterpart of kpvid_tpu/models/layers.py. Parameters are f32 and keep the
JAX package's values; the compute runs in ``dtype``. Where the layout
differs, the bridge converts them:
conv weights are OIHW here (HWIO in Flax); the LSTM kernels
``lstm_{i}_kernel`` [D+H, 4H] and the Dense kernels [in, out] are kept as
they are. Parity points:

- TF ``SAME`` padding is asymmetric for even inputs at stride 2
  (0 before, 1 after), which torch's ``padding=1`` is not; ``Conv(pad=p)``
  zero-pads first and then applies ``SAME`` to the padded size (the
  PatchGAN's idiom: (1, 1) for 128 -> 65, then (1, 2) from 65 on);
- BatchNorm (eval) uses the moving statistics with eps 1e-5. In train mode
  it normalizes with the batch's f32 statistics over N, H and W, Flax's
  fast variance ``max(0, E[x^2] - E[x]^2)``, and, inside
  :func:`updating_batch_stats` only, moves the running statistics to
  ``0.999 old + 0.001 batch`` with that same biased variance (torch's
  ``F.batch_norm`` would update with the unbiased one);
- the LSTM gate order is i, j, f, o with ``sigmoid(f + 1.0)`` and an f32
  cell state: not ``nn.LSTM``'s layout. Its gates are computed as JAX's
  ``jnp.dot(..., preferred_element_type=float32)`` computes them: the
  step's input and the kernel are rounded to ``dtype``, the products and
  their sums are f32, and nothing is rounded before the f32 bias is added.
  The route is the same on the CPU and the card: the rounded operands are
  widened to f32 and multiplied in f32 (with TF32 off, PyTorch's default),
  which is exact, since a product of two bf16 values fits in f32.
  ``torch.mm(..., out_dtype=float32)`` is not taken: it has no CPU kernel,
  and in torch 2.11 on the card it has no derivative, so the trainer could
  not use it;
- ``Dense(relu=True)`` keeps the reference's default-ReLU quirk, and
  ``Dense(tanh=True)`` is the ``to_coord`` head.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2D conv with TF SAME padding after an optional zero pre-pad of ``pad``
    on each side; NHWC in and out, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, pad: int = 0):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.pad = pad
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4)
        k = self.weight.shape[-1]
        (t, b), (l, r) = (_same_pads(s, k, self.stride) for s in x.shape[2:])
        if t == b and l == r:
            y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(x, (l, r, t, b)), self.weight.to(self.dtype), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """BN over the last (channel) axis, eps 1e-5, in f32, Flax's
    ``nn.BatchNorm(momentum=0.999)``: the moving statistics (``train``
    False) or the batch's (``train`` True; see the module docstring)."""

    MOMENTUM = 0.999

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = False  # set by updating_batch_stats
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp(torch.square(xf).mean(dim=(0, 1, 2)) - torch.square(mean), min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            xf, mean, var = x.float(), self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean) * mul + self.bias
        return y.to(x.dtype)


@contextlib.contextmanager
def updating_batch_stats(model: nn.Module):
    """Within the block, every train-mode BatchNorm of ``model`` moves its
    running statistics toward its batch's (JAX's ``mutable=['batch_stats']``
    pass, whose result the trainer keeps); outside it they stay as they are."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = False


class ConvBNReLU(nn.Module):
    """conv + BN + ReLU. ``up2`` upsamples the input 2x first (TF1-legacy);
    ``skip`` is concatenated after it along the channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, dtype=dtype)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, up2: bool = False,
                skip: torch.Tensor | None = None, train: bool = False) -> torch.Tensor:
        if up2:
            x = upsample2x(x)
        if skip is not None:
            x = torch.cat([x.to(self.conv.dtype), skip.to(self.conv.dtype)], dim=-1)
        return torch.relu(self.bn(self.conv(x), train))


class StackedLSTM(nn.Module):
    """Multi-layer LSTM over a whole sequence: [B, T, D] -> [B, T, H] f32.

    Per step and layer one [B, D+H] @ [D+H, 4H] product of operands rounded
    to ``dtype``, computed and summed in f32; the gates and the cell state
    are f32."""

    def __init__(self, in_dim: int, features, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.dtype = dtype
        dims = [in_dim] + list(self.features[:-1])
        for i, (d, h) in enumerate(zip(dims, self.features)):
            self.register_parameter(f"lstm_{i}_kernel", nn.Parameter(torch.zeros(d + h, 4 * h)))
            self.register_parameter(f"lstm_{i}_bias", nn.Parameter(torch.zeros(4 * h)))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        b, t = xs.shape[:2]
        # rounded to the compute dtype once, then widened: the f32 products
        # of the rounded values (see the module docstring)
        kernels = [getattr(self, f"lstm_{i}_kernel").to(self.dtype).float()
                   for i in range(len(self.features))]
        biases = [getattr(self, f"lstm_{i}_bias") for i in range(len(self.features))]
        state = [
            (xs.new_zeros((b, h), dtype=torch.float32), xs.new_zeros((b, h), dtype=torch.float32))
            for h in self.features
        ]
        outs = []
        for step in range(t):
            inp = xs[:, step]
            for li, (c, h) in enumerate(state):
                z = torch.cat([inp.to(self.dtype), h.to(self.dtype)], dim=-1)
                gates = torch.matmul(z.float(), kernels[li]) + biases[li]
                i, j, f, o = torch.chunk(gates, 4, dim=-1)
                c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
                h = torch.sigmoid(o) * torch.tanh(c)
                state[li] = (c, h)
                inp = h
            outs.append(inp)
        return torch.stack(outs, dim=1)


class Dense(nn.Module):
    """Fully connected layer, kernel [in, out], computed in ``dtype``.
    ``relu``: the reference's default-ReLU quirk; ``tanh``: the to_coord head."""

    def __init__(self, in_dim: int, out_dim: int, relu: bool = False, tanh: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu = relu
        self.tanh = tanh
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)
        if self.tanh:
            return torch.tanh(y)
        if self.relu:
            return torch.relu(y)
        return y


def init_like_jax(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Parameters of ``model`` with the JAX package's init laws, drawn on the
    CPU from ``seed`` in the order of ``named_modules``: Xavier-uniform conv,
    LSTM and Dense kernels, normal(0.02) for a tanh ``to_coord`` head, zero
    biases, BN scale 1 / bias 0 / mean 0 / var 1. Keyed like the model's
    ``state_dict``."""
    import math

    gen = torch.Generator().manual_seed(seed)
    params = {k: torch.zeros_like(v, device="cpu") for k, v in model.state_dict().items()}

    def xavier(key, fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        params[key].uniform_(-a, a, generator=gen)

    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, Conv):
            o, i, kh, kw = mod.weight.shape
            xavier(p + "weight", i * kh * kw, o * kh * kw)
        elif isinstance(mod, BatchNorm):
            params[p + "weight"].fill_(1.0)
            params[p + "running_var"].fill_(1.0)
        elif isinstance(mod, StackedLSTM):
            for li in range(len(mod.features)):
                key = f"{p}lstm_{li}_kernel"
                xavier(key, *params[key].shape)
        elif isinstance(mod, Dense):
            if mod.tanh:
                params[p + "weight"].normal_(0.0, 0.02, generator=gen)
            else:
                xavier(p + "weight", *params[p + "weight"].shape)
    return params
