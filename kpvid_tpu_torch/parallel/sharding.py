"""Sharding rules: which of the trainers' arrays shard over 'model', and how a
full array and its shards convert.

Counterpart of kpvid_tpu/parallel/sharding.py. JAX's rule (``_leaf_spec``):
an array shards over 'model' exactly when its last dim in the Flax layout is
at least ``min_shard_dim`` and divisible by the axis size, into contiguous
slices of that dim (``P(..., 'model')``); everything else, scalars included,
is replicated. The port keeps every array in the Flax layout but the conv
kernels (OIHW here, HWIO there; bridge.py), so the Flax layout's last dim is
dim 0 of a 4-D array and the last dim of any other. Adam's moments shard
with their parameter, its step counts never; BN statistics are arrays of the
state like any other (JAX's ``shard_state`` applies the rule to the whole
train state).

- :func:`shard_dim`: the rule on one shape;
- :func:`param_sharding_rules`: the rule over a ``state_dict``'s arrays;
- :func:`shard_modules`: each rank keeps only its shards in the modules
  (models/layers.py then runs them column-parallel);
- :func:`shard_state` / :func:`gather_state`: full arrays to this rank's
  shards and back; the gather is a collective every 'model' rank joins;
- :func:`batch_shard`: the pipeline's shard of a rank, its data coordinate.

There is no ``batch_sharding`` / ``shard_batch`` / ``replicate``: a process
feeds its own rows (parallel/distributed.py), and one process over several
cards replicates its modules itself (eval/final.py::GeneratorMesh).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from .tensor import ModelShard


def shard_dim(shape, model_size: int, min_shard_dim: int = 1024) -> int | None:
    """The dim an array of ``shape`` (the port's layout) shards along over a
    'model' axis of ``model_size``, or None when it is replicated."""
    shape = tuple(shape)
    if model_size <= 1 or not shape:
        return None
    dim = 0 if len(shape) == 4 else len(shape) - 1  # the Flax layout's last dim
    if shape[dim] >= min_shard_dim and shape[dim] % model_size == 0:
        return dim
    return None


def param_sharding_rules(arrays: Mapping, model_size: int,
                         min_shard_dim: int = 1024) -> dict[str, int]:
    """name -> shard dim for every array of ``arrays`` (name -> tensor or
    shape) that shards; the others are replicated."""
    rules = {}
    for name, val in arrays.items():
        dim = shard_dim(getattr(val, "shape", val), model_size, min_shard_dim)
        if dim is not None:
            rules[name] = dim
    return rules


def shard_modules(model: nn.Module, shard: ModelShard, min_shard_dim: int) -> dict[str, int]:
    """Replace every parameter and buffer of ``model`` that the rule shards by
    this rank's slice of it, and tell its module (``module.shard``,
    ``module.sharded``: name -> dim); returns the rules keyed like
    ``model.state_dict()``. Only the layers of models/layers.py run sharded
    arrays; another module holding one raises."""
    from ..models.layers import BatchNorm, Conv, Dense, StackedLSTM

    rules = {}
    for prefix, mod in model.named_modules():
        own = {**mod._parameters, **mod._buffers}
        local = {n: d for n, t in own.items() if t is not None
                 and (d := shard_dim(t.shape, shard.size, min_shard_dim)) is not None}
        if not local:
            continue
        if not isinstance(mod, (BatchNorm, Conv, Dense, StackedLSTM)):
            raise NotImplementedError(f"{type(mod).__name__} {prefix!r} cannot run sharded")
        for name, dim in local.items():
            sliced = shard.local(own[name].detach(), dim).clone()
            if name in mod._parameters:
                mod._parameters[name] = nn.Parameter(sliced)
            else:
                mod._buffers[name] = sliced
            rules[f"{prefix}.{name}" if prefix else name] = dim
        mod.shard, mod.sharded = shard, local
    return rules


def shard_state(arrays: Mapping, rules: Mapping[str, int],
                shard: ModelShard | None) -> dict:
    """``arrays`` (full: a checkpoint's or an init's) with each array that
    ``rules`` names cut to this rank's slice; the rest as they are."""
    if shard is None or not rules:
        return dict(arrays)
    return {k: shard.local(torch.as_tensor(v), rules[k]) if k in rules else v
            for k, v in arrays.items()}


def gather_state(arrays: Mapping, rules: Mapping[str, int],
                 shard: ModelShard | None) -> dict:
    """The full arrays of this rank's shards: a collective over the 'model'
    group, one per sharded array in ``arrays``' order, which every rank of
    the group must join (JAX: utils/checkpoint.py's ``process_allgather``)."""
    if shard is None or not rules:
        return dict(arrays)
    with torch.no_grad():
        return {k: shard.join_(v.contiguous(), rules[k]) if k in rules else v
                for k, v in arrays.items()}


def batch_shard(mesh) -> tuple[int, int]:
    """(shard_id, num_shards) of this rank's data pipeline: its data
    coordinate of the 'data' axis. The 'model' ranks of a coordinate read the
    same shard, so they see the same rows."""
    return mesh.d, mesh.data
