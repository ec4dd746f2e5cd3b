"""Tensor parallelism over the 'model' mesh axis: the collectives of a
column-parallel layer.

What XLA inserts for kpvid_tpu/parallel/sharding.py's ``P(..., 'model')``
parameters, written out (Megatron-LM's column-parallel layer). A layer
whose kernel is sharded over its output columns (models/layers.py: a
``Conv``'s output channels, a ``Dense``'s outputs, an LSTM's gate columns)
runs on the 'model' ranks of one data coordinate, which hold the same input
rows:

- :func:`copy_to_model` on its input: the identity forward; backward, the
  cotangent summed over the 'model' group, since each rank's input gradient
  comes from its own output columns only;
- :func:`join` on its output: the ranks' column slices concatenated along
  ``dim``; backward, this rank's slice of the cotangent. Every rank computes
  the same loss from the joined output, so the cotangent is the same on all
  of them and is not summed (``torch.distributed.nn.functional.all_gather``
  sums it, which would scale the gradients by the axis size).

A sharded vector (BN's affine and statistics) is joined at use the same way.

The join is exact on every backend: each rank writes its slice into a
zero-filled buffer of the full shape, and the buffers, read as bytes, are
summed by ``all_reduce``; one non-zero byte plus zeros is that byte, so the
result holds each rank's bits (-0.0 and NaN included). gloo has no
``all_gather`` for CUDA tensors (the ranks that share a card run on gloo),
and both backends sum uint8 on the CPU and the card. It moves the axis size
times the slice's bytes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the 'model' axis: ``index`` of ``size``, and the
    process group of the ranks that share its data coordinate."""

    index: int
    size: int
    group: object = None

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slice of a full tensor along ``dim`` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def join_(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices concatenated along ``dim``, without autograd."""
        dim = dim % local.dim()
        shape = list(local.shape)
        shape[dim] *= self.size
        full = torch.zeros(shape, dtype=local.dtype, device=local.device)
        self.local(full, dim).copy_(local)
        dist.all_reduce(full.view(-1).view(torch.uint8), group=self.group)
        return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
        ctx.dim, ctx.shard = dim, shard
        return shard.join_(local.contiguous(), dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.shard.local(g, ctx.dim).contiguous(), None, None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the 'model' group."""
    return _CopyToModel.apply(x, shard)


def join(local: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    """The 'model' ranks' slices of a tensor concatenated along ``dim``;
    differentiable (the backward keeps this rank's slice)."""
    return _Join.apply(local, dim, shard)
