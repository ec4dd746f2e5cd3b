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
  ``F.batch_norm`` would update with the unbiased one); inside
  :func:`syncing_batch_stats` the batch statistics ``[E[x], E[x^2]]`` are
  averaged over the 'data' group first, differentiably (Flax's
  ``axis_name``: sync-BN for the data-parallel step);
- the LSTM gate order is i, j, f, o with ``sigmoid(f + 1.0)`` and an f32
  cell state: not ``nn.LSTM``'s layout. Its gates are computed as JAX's
  ``jnp.dot(..., preferred_element_type=float32)`` computes them: the
  step's input and the kernel are rounded to ``dtype``, the products and
  their sums are f32, and nothing is rounded before the f32 bias is added.
  The torch route widens the rounded operands to f32 and multiplies in f32
  (with TF32 off, PyTorch's default), which is exact, since a product of
  two bf16 values fits in f32. An unrecorded bf16 forward takes the
  ``kpvid::lstm_cell`` op instead: on the card its tensor cores take the
  bf16 operands as they are and sum in f32, on the CPU it runs the torch
  route's ops (:class:`StackedLSTM`);
- ``Dense(relu=True)`` keeps the reference's default-ReLU quirk, and
  ``Dense(tanh=True)`` is the ``to_coord`` head.

Tensor parallelism (parallel/sharding.py::shard_modules): a layer may hold
only its 'model' rank's slice of an array, ``shard`` then being that
rank's place and ``sharded`` the names and dims of its slices. A ``Conv``,
``Dense`` or LSTM whose kernel is sliced runs column-parallel (its output
channels, outputs or gate columns on the local slice, then joined; the
input's gradient summed over the 'model' group: parallel/tensor.py); a
``BatchNorm`` joins its sliced affine and statistics at use and moves only
its slice of the running statistics. The joined values are the full
arrays' bits, so the forward is the unsharded layer's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.inference_bn import bias_bn_relu
from ..ops.lstm import cell_update, lstm_cell
from ..ops.resize import upsample2x
from ..parallel.distributed import all_reduce_mean
from ..parallel.tensor import copy_to_model, join


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
        self.shard, self.sharded = None, {}

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``bias=False`` leaves the bias add to the caller."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        col = "weight" in self.sharded  # column-parallel: this rank's output channels
        if col:
            x = copy_to_model(x, self.shard)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4)
        k = self.weight.shape[-1]
        (t, b), (l, r) = (_same_pads(s, k, self.stride) for s in x.shape[2:])
        if t == b and l == r:
            y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(x, (l, r, t, b)), self.weight.to(self.dtype), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        if bias and self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return join(y, -1, self.shard) if col else y


class BatchNorm(nn.Module):
    """BN over the last (channel) axis, eps 1e-5, in f32, Flax's
    ``nn.BatchNorm(momentum=0.999)``: the moving statistics (``train``
    False) or the batch's (``train`` True; see the module docstring)."""

    MOMENTUM = 0.999

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = False  # set by updating_batch_stats
        self.sync = False  # set by syncing_batch_stats, with the group to sync over
        self.sync_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.shard, self.sharded = None, {}

    def _full(self, name: str) -> torch.Tensor:
        t = getattr(self, name)
        return join(t, 0, self.shard) if name in self.sharded else t

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 2))
            mean_sq = torch.square(xf).mean(dim=(0, 1, 2))
            if self.sync:
                mean, mean_sq = all_reduce_mean(torch.stack([mean, mean_sq]),
                                                self.sync_group).unbind(0)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.MOMENTUM
                    for name, batch in (("running_mean", mean), ("running_var", var)):
                        if name in self.sharded:  # this rank's channels only
                            batch = self.shard.local(batch, 0)
                        run = getattr(self, name)
                        run.copy_(m * run + (1 - m) * batch)
            mul = self._full("weight") * torch.rsqrt(var + self.eps)
            beta = self._full("bias")
        else:
            mean, mul, beta = self.running_affine()
            xf = x.float()
        y = (xf - mean) * mul + beta
        return y.to(x.dtype)

    def running_affine(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, beta), f32 [C], of the inference form ``(x - mean) *
        mul + beta``: the running mean, ``weight * rsqrt(running_var + eps)``
        and the BN bias."""
        with torch.no_grad():
            mean, var = self._full("running_mean"), self._full("running_var")
        return mean, self._full("weight") * torch.rsqrt(var + self.eps), self._full("bias")


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


@contextlib.contextmanager
def syncing_batch_stats(model: nn.Module, enabled: bool = True, group=None):
    """Within the block (when ``enabled``), every train-mode BatchNorm of
    ``model`` normalizes with the batch statistics averaged over ``group``
    (the 'data' axis; None: every process): the data-parallel step's
    sync-BN. In the port every BatchNorm is one of JAX's ``bn_axis`` sites:
    the stage-1 generator's image encoder, pose encoder and translator."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)] if enabled else []
    for bn in bns:
        bn.sync, bn.sync_group = True, group
    try:
        yield
    finally:
        for bn in bns:
            bn.sync, bn.sync_group = False, None


class ConvBNReLU(nn.Module):
    """conv + BN + ReLU. ``up2`` upsamples the input 2x first (TF1-legacy);
    ``skip`` is concatenated after it along the channels.

    The inference forward of an unsharded layer (``train`` False, neither
    the conv nor the BN sharded) runs the conv without its bias, then the
    bias add, BN and ReLU as one ``kpvid::bias_bn_relu`` op (ops/inference_bn.py),
    which gives the bits of the torch passes it replaces. Training, the
    sharded layers and a forward that autograd would record (grad mode on
    and an input or parameter that requires a gradient; the op has no
    gradient formula) run the conv, :class:`BatchNorm` and the ReLU."""

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
        conv, bn = self.conv, self.bn
        recording = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if train or recording or conv.shard is not None or bn.shard is not None:
            return torch.relu(bn(conv(x), train))
        return bias_bn_relu(conv(x, bias=False), conv.bias.to(conv.dtype), *bn.running_affine(),
                            True)


class StackedLSTM(nn.Module):
    """Multi-layer LSTM over a whole sequence: [B, T, D] -> [B, T, H] f32.

    Per step and layer one [B, D+H] @ [D+H, 4H] product of operands rounded
    to ``dtype``, computed and summed in f32; the gates and the cell state
    are f32.

    A bf16 forward that autograd would not record (grad mode off, or no
    input or parameter requiring a gradient), with no layer sharded, runs
    each step and layer as one ``kpvid::lstm_cell`` op (ops/lstm.py), on
    any device: on the card the product on the tensor cores and the cell
    in its epilogue, only the order of the f32 sums changed; on the CPU the
    op's plain version, the torch route's bits. The kernels are rounded to
    bf16 once a call. Everything else (training, the f32 configurations,
    whose products bf16 tensor cores cannot give, the sharded layers) runs
    the torch ops."""

    def __init__(self, in_dim: int, features, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.dtype = dtype
        dims = [in_dim] + list(self.features[:-1])
        for i, (d, h) in enumerate(zip(dims, self.features)):
            self.register_parameter(f"lstm_{i}_kernel", nn.Parameter(torch.zeros(d + h, 4 * h)))
            self.register_parameter(f"lstm_{i}_bias", nn.Parameter(torch.zeros(4 * h)))
        self.shard, self.sharded = None, {}

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        recording = torch.is_grad_enabled() and (
            xs.requires_grad or any(p.requires_grad for p in self.parameters()))
        if self.dtype == torch.bfloat16 and not recording and not self.sharded:
            return self._forward_op(xs)
        return self._forward_torch(xs)

    def _forward_torch(self, xs: torch.Tensor) -> torch.Tensor:
        b, t = xs.shape[:2]
        # rounded to the compute dtype once, then widened: the f32 products
        # of the rounded values (see the module docstring)
        kernels = [getattr(self, f"lstm_{i}_kernel").to(self.dtype).float()
                   for i in range(len(self.features))]
        biases = [getattr(self, f"lstm_{i}_bias") for i in range(len(self.features))]
        # column-parallel layers: this rank's gate columns, then all four joined
        cols = [f"lstm_{i}_kernel" in self.sharded for i in range(len(self.features))]
        state = [
            (xs.new_zeros((b, h), dtype=torch.float32), xs.new_zeros((b, h), dtype=torch.float32))
            for h in self.features
        ]
        outs = []
        for step in range(t):
            inp = xs[:, step]
            for li, (c, h) in enumerate(state):
                z = torch.cat([inp.to(self.dtype), h.to(self.dtype)], dim=-1)
                if cols[li]:
                    z = copy_to_model(z, self.shard)
                gates = torch.matmul(z.float(), kernels[li]) + biases[li]
                if cols[li]:
                    gates = join(gates, -1, self.shard)
                h, c = cell_update(gates, c)
                state[li] = (c, h)
                inp = h
            outs.append(inp)
        return torch.stack(outs, dim=1)

    def _forward_op(self, xs: torch.Tensor) -> torch.Tensor:
        b, t = xs.shape[:2]
        n = len(self.features)
        kernels = [getattr(self, f"lstm_{i}_kernel").to(self.dtype) for i in range(n)]
        biases = [getattr(self, f"lstm_{i}_bias") for i in range(n)]
        # per layer: (c f32, h in the compute dtype)
        state = [(xs.new_zeros((b, h), dtype=torch.float32), xs.new_zeros((b, h), dtype=self.dtype))
                 for h in self.features]
        xs = xs.to(self.dtype)
        outs = []
        for step in range(t):
            inp = xs[:, step]
            for li, (c, h) in enumerate(state):
                h32, c, inp = lstm_cell(inp, h, c, kernels[li], biases[li])
                state[li] = (c, inp)
            outs.append(h32)
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
        self.shard, self.sharded = None, {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        col = "weight" in self.sharded  # column-parallel: this rank's outputs
        if col:
            x = copy_to_model(x, self.shard)
        y = torch.matmul(x, self.weight.to(self.dtype)) + self.bias.to(self.dtype)
        if col:
            y = join(y, -1, self.shard)
        if self.tanh:
            return torch.tanh(y)
        if self.relu:
            return torch.relu(y)
        return y


def init_like_jax(model: nn.Module, keys: dict,
                  shapes: dict | None = None) -> dict[str, torch.Tensor]:
    """Parameters of ``model`` as Flax's ``init`` draws the JAX package's.

    ``keys`` maps each top-level child of ``model`` to the key JAX's
    ``init`` of that network takes (``utils/jax_random.py``). Each random
    leaf is drawn with its Flax parameter key: the scope path of
    ``bridge.jax_path`` and the leaf's place among the ``self.param`` calls
    of that Flax module (a conv's or Dense's kernel 1, its bias 2; the
    LSTM's ``lstm_{i}_kernel`` 2i + 1, ``lstm_{i}_bias`` 2i + 2). Conv, LSTM
    and Dense kernels are Xavier-uniform (a conv's drawn in Flax's HWIO
    shape, then laid out OIHW), a tanh ``to_coord`` head normal(0.02);
    biases are 0, BN scale 1 / bias 0 / mean 0 / var 1. Keyed like the
    model's ``state_dict``; ``shapes`` (name -> full shape) gives the full
    arrays of a model that holds shards."""
    from ..bridge import jax_path
    from ..utils import jax_random

    shapes = shapes or {k: tuple(v.shape) for k, v in model.state_dict().items()}
    drawn, ones = {}, set()  # name -> (init law, Flax counter); names filled with 1
    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, Conv):
            drawn[p + "weight"] = (jax_random.xavier_uniform, 1)
        elif isinstance(mod, BatchNorm):
            ones.update((p + "weight", p + "running_var"))
        elif isinstance(mod, StackedLSTM):
            for li in range(len(mod.features)):
                drawn[f"{p}lstm_{li}_kernel"] = (jax_random.xavier_uniform, 2 * li + 1)
        elif isinstance(mod, Dense):
            drawn[p + "weight"] = (jax_random.normal_init if mod.tanh
                                   else jax_random.xavier_uniform, 1)
    params = {}
    for name, shape in shapes.items():
        if name not in drawn:
            params[name] = (torch.ones if name in ones else torch.zeros)(shape)
            continue
        law, counter = drawn[name]
        top, rest = name.split(".", 1)
        key = jax_random.flax_param_key(keys[top], jax_path(rest)[:-1], counter)
        if len(shape) == 4:  # OIHW here, HWIO in Flax
            o, i, kh, kw = shape
            arr = law(key, (kh, kw, i, o)).transpose(3, 2, 0, 1)
        else:
            arr = law(key, tuple(shape))
        params[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return params
