"""Flax variable trees -> the port's parameters.

The JAX package's variables, given as nested dicts of arrays (numpy, or
anything ``np.asarray`` takes), become a flat dict keyed like
``FinalGenerator.load_parameters`` takes it:

- stage-1 ``params`` and ``batch_stats`` of ``image_encoder``,
  ``pose_encoder`` and ``translator``: ``{name}_conv/Conv_0/{kernel,bias}``
  -> ``{name}.conv.{weight,bias}``; ``{name}_bn/BatchNorm_0/{scale,bias}``
  and ``{mean,var}`` -> ``{name}.bn.{weight,bias,running_mean,running_var}``;
  bare convs (``heat``, ``crude``, ``mask``) -> ``{name}.{weight,bias}``;
- stage-2 ``params`` that ``decode`` reads: ``dec_in``, ``dec_lstm`` and
  ``to_coord``; ``Dense_0/{kernel,bias}`` -> ``{weight,bias}``, the LSTM's
  ``lstm_{i}_kernel`` [D+H, 4H] and ``lstm_{i}_bias`` kept as they are;
- for the stage-2 trainer (:func:`stage2_trainer_from_jax`), the whole
  MotionGenerator tree (``enc_lstm`` and ``enc_head`` too) keyed
  ``stage2.*``, and the SeqDiscriminator tree keyed ``discriminator.*``:
  ``StackedLSTM_0`` -> ``lstm``, ``Dense_0/Dense_0`` -> ``head``.

Conv kernels go from HWIO to OIHW; every other array keeps its layout.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

STAGE1_MODULES = ("image_encoder", "pose_encoder", "translator")
STAGE2_DECODE_MODULES = ("dec_in", "dec_lstm", "to_coord")
STAGE2_MODULES = ("enc_lstm", "enc_head") + STAGE2_DECODE_MODULES
_DISCRIMINATOR = {"StackedLSTM_0": "lstm", "Dense_0": "head"}
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def torch_name(path: tuple[str, ...]) -> str:
    """Flax path -> the port's parameter name (without the stage prefix)."""
    out = []
    segs = list(path)
    i = 0
    while i < len(segs):
        seg = segs[i]
        nxt = segs[i + 1] if i + 1 < len(segs) else None
        if seg.endswith("_conv") and nxt == "Conv_0":
            out += [seg[: -len("_conv")], "conv"]
            i += 2
            continue
        if seg.endswith("_bn") and nxt == "BatchNorm_0":
            out += [seg[: -len("_bn")], "bn"]
            i += 2
            continue
        if seg in ("Conv_0", "Dense_0"):
            i += 1
            continue
        out.append(_LEAF.get(seg, seg) if nxt is None else seg)
        i += 1
    return ".".join(out)


def _convert(arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 4:  # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def from_jax(stage1_vars: Mapping | None = None,
             stage2_params: Mapping | None = None) -> dict[str, torch.Tensor]:
    """stage1_vars: {'params': ..., 'batch_stats': ...} of Stage1Generator;
    stage2_params: the MotionGenerator's ``params`` collection. Either may be
    left out (a stage-1 checkpoint alone feeds the labeler)."""
    if stage1_vars is None and stage2_params is None:
        raise ValueError("from_jax needs stage1_vars, stage2_params or both")
    out = {}
    for col in ("params", "batch_stats"):
        for path, arr in _flatten((stage1_vars or {}).get(col, {})):
            if path[0] in STAGE1_MODULES:
                out["stage1." + torch_name(path)] = _convert(arr)
    for path, arr in _flatten(stage2_params or {}):
        if path[0] in STAGE2_DECODE_MODULES:
            out["stage2." + torch_name(path)] = _convert(arr)
    return out


def stage2_trainer_from_jax(g_params: Mapping, d_params: Mapping) -> dict[str, torch.Tensor]:
    """The ``g_params`` (MotionGenerator) and ``d_params`` (SeqDiscriminator)
    collections of a JAX stage-2 train state, keyed like
    ``Stage2Trainer.load_parameters`` takes them."""
    out = {}
    for path, arr in _flatten(g_params):
        if path[0] not in STAGE2_MODULES:
            raise ValueError(f"unknown stage-2 generator parameter {'/'.join(path)}")
        out["stage2." + torch_name(path)] = _convert(arr)
    for path, arr in _flatten(d_params):
        out[f"discriminator.{_DISCRIMINATOR[path[0]]}." + torch_name(path[1:])] = _convert(arr)
    return out
