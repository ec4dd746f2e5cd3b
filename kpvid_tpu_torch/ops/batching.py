"""Two equal batches through one network in a single forward.

Copy of kpvid_tpu/ops/batching.py's ``pair_fns`` and ``resolve_pair_mode``:
'concat' stacks the rows [a_0..a_B, b_0..b_B] (the reference's
tf.concat), 'interleave' [a_0, b_0, a_1, b_1, ...]. Every consumer is
row-independent, so both give the same rows. The JAX package picks
'interleave' under a batch-sharded mesh, where one pair spans the devices.
In the port every pair is rank-local (a process of the data-parallel step
pairs its own rows, as inside JAX's shard_map step, which forces 'concat'),
so 'auto' is 'concat' on one card and on many.
"""

from __future__ import annotations

import torch


def interleave_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape:
        raise ValueError(f"pair of unequal shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], *a.shape[1:])


def deinterleave_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    y = x.reshape(x.shape[0] // 2, 2, *x.shape[1:])
    return y[:, 0], y[:, 1]


def concat_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape:
        raise ValueError(f"pair of unequal shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return torch.cat([a, b], dim=0)


def split_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[0] // 2
    return x[:h], x[h:]


def pair_fns(mode: str):
    """(pair, unpair) of a pair-batching mode."""
    if mode == "interleave":
        return interleave_pair, deinterleave_pair
    if mode == "concat":
        return concat_pair, split_pair
    raise ValueError(f"unknown pair_batching mode {mode!r}")


def resolve_pair_mode(mode: str) -> str:
    """training.pair_batching: 'auto' is 'concat' (every pair is
    rank-local); explicit modes pass through."""
    if mode == "auto":
        return "concat"
    pair_fns(mode)  # validate
    return mode
