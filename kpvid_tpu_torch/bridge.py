"""Flax variable trees <-> the port's parameters.

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
  ``StackedLSTM_0`` -> ``lstm``, ``Dense_0/Dense_0`` -> ``head``;
- for the stage-1 trainer (:func:`stage1_trainer_from_jax`), the generator's
  ``params`` and ``batch_stats`` keyed ``stage1.*`` as above, and the
  ImageDiscriminator tree keyed ``image_discriminator.*``:
  ``conv{i}/Conv_0/{kernel,bias}`` -> ``conv{i}.{weight,bias}``,
  ``logit/Conv_0/kernel`` -> ``logit.weight``.

Conv kernels go from HWIO to OIHW; every other array keeps its layout.

The other direction: :func:`jax_path` inverts :func:`torch_name`, module by
module (a bare ``weight`` is a conv's ``Conv_0/kernel`` unless the module
is one of the Dense layers); :func:`to_jax` gives the generation
variables, and :func:`stage1_trainer_to_jax` / :func:`stage2_trainer_to_jax`
a trainer checkpoint's arrays as the fields of JAX's ``GANTrainState``:
nested dicts of numpy arrays, conv kernels back to HWIO, each Adam state as
optax lays out ``optax.adam`` (``(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))``, here a tuple of dicts). Nothing here
imports JAX or optax.
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
# the inverse: a leaf's Flax name under a conv or Dense, and under a BatchNorm
_PARAM_LEAF = {"weight": "kernel", "bias": "bias"}
_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
# the modules whose bare weight and bias sit in a Dense_0, not a Conv_0
_DENSE = ("dec_in", "enc_head", "to_coord")
BATCH_STATS = ("mean", "var")


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


def jax_path(name: str) -> tuple[str, ...]:
    """The port's parameter name (without the stage prefix) -> its Flax path,
    the inverse of :func:`torch_name`; also the stage-2 discriminator's
    ``lstm.*`` and ``head.*`` -> ``StackedLSTM_0/*`` and ``Dense_0/Dense_0/*``."""
    *mods, leaf = name.split(".")
    if mods == ["lstm"]:
        return ("StackedLSTM_0", leaf)
    if mods == ["head"]:  # the head's Dense holds a Dense_0
        return ("Dense_0", "Dense_0", _PARAM_LEAF[leaf])
    if len(mods) >= 2 and mods[-1] == "conv":
        return (*mods[:-2], mods[-2] + "_conv", "Conv_0", _PARAM_LEAF[leaf])
    if len(mods) >= 2 and mods[-1] == "bn":
        return (*mods[:-2], mods[-2] + "_bn", "BatchNorm_0", _BN_LEAF[leaf])
    if leaf in _PARAM_LEAF and mods:
        return (*mods, "Dense_0" if mods[-1] in _DENSE else "Conv_0", _PARAM_LEAF[leaf])
    return (*mods, leaf)  # the LSTMs' lstm_{i}_kernel / lstm_{i}_bias


def _insert(tree: dict, path: tuple[str, ...], val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise ValueError(f"two parameters map to {'/'.join(path)}")
    tree[path[-1]] = val


def to_flax_layout(val) -> np.ndarray:
    """A port tensor as a host array in the Flax layout (OIHW -> HWIO)."""
    a = val.detach().cpu().numpy() if torch.is_tensor(val) else np.asarray(val)
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)


def _trees(arrays: Mapping, prefix: str) -> tuple[dict, dict]:
    """(params, batch_stats) of the names under ``prefix.``, in Flax's trees."""
    params, stats = {}, {}
    for name, val in arrays.items():
        if name.startswith(prefix + "."):
            path = jax_path(name[len(prefix) + 1:])
            _insert(stats if path[-1] in BATCH_STATS else params, path, to_flax_layout(val))
    return params, stats


def to_jax(params: Mapping) -> tuple[dict, dict]:
    """FinalGenerator's parameters -> (stage1_vars, stage2_params): the
    ``{'params', 'batch_stats'}`` of the stage-1 generator and the
    MotionGenerator's ``params`` that ``decode`` reads, as JAX's
    ``FinalGenerator.generate`` takes them."""
    s1_params, s1_stats = _trees(params, "stage1")
    s2_params, _ = _trees(params, "stage2")
    return {"params": s1_params, "batch_stats": s1_stats}, s2_params


def _count(arrays: Mapping, prefix: str) -> int:
    """The update count of the Adam state under ``prefix``: every
    parameter's ``step`` holds it."""
    steps = {float(np.asarray(v)) for k, v in arrays.items()
             if k.startswith(prefix + ".") and k.endswith(".step")}
    if len(steps) != 1:
        raise ValueError(f"the Adam state {prefix} has no single update count: {sorted(steps)}")
    return int(steps.pop())


def optax_adam_state(arrays: Mapping, prefix: str, module_prefix: str) -> tuple:
    """The Adam state under ``{prefix}.{module_prefix}.{name}.{exp_avg,
    exp_avg_sq, step}`` as ``optax.adam``'s: ``({'count', 'mu', 'nu'},
    {'count'})``, mu and nu in the Flax trees of the parameters, the counts
    int32."""
    base = f"{prefix}.{module_prefix}"
    count = np.asarray(_count(arrays, base), np.int32)
    mu, nu = {}, {}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        for name, val in arrays.items():
            if name.startswith(base + ".") and name.endswith("." + key):
                _insert(tree, jax_path(name[len(base) + 1:-len(key) - 1]), to_flax_layout(val))
    return {"count": count, "mu": mu, "nu": nu}, {"count": count.copy()}


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


def stage1_trainer_from_jax(g_params: Mapping, d_params: Mapping,
                            batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """The ``g_params`` and ``batch_stats`` (Stage1Generator) and ``d_params``
    (ImageDiscriminator) collections of a JAX stage-1 train state, keyed like
    ``Stage1Trainer.load_parameters`` takes them."""
    out = {}
    for col in (g_params, batch_stats):
        for path, arr in _flatten(col):
            if path[0] not in STAGE1_MODULES:
                raise ValueError(f"unknown stage-1 generator variable {'/'.join(path)}")
            out["stage1." + torch_name(path)] = _convert(arr)
    for path, arr in _flatten(d_params):
        out["image_discriminator." + torch_name(path)] = _convert(arr)
    return out


def _trainer_to_jax(arrays: Mapping, g_prefix: str, d_prefix: str) -> dict:
    g_params, batch_stats = _trees(arrays, g_prefix)
    d_params, _ = _trees(arrays, d_prefix)
    return {"step": np.asarray(int(np.asarray(arrays["step"])), np.int32),
            "g_params": g_params, "d_params": d_params, "batch_stats": batch_stats,
            "g_opt_state": optax_adam_state(arrays, "g_opt", g_prefix),
            "d_opt_state": optax_adam_state(arrays, "d_opt", d_prefix)}


def stage1_trainer_to_jax(arrays: Mapping) -> dict:
    """A stage-1 trainer checkpoint's arrays (``Stage1Trainer.state_arrays``)
    -> the fields of JAX's stage-1 ``GANTrainState``: ``step``, ``g_params``
    and ``batch_stats`` (Stage1Generator), ``d_params`` (ImageDiscriminator)
    and both optax Adam states."""
    return _trainer_to_jax(arrays, "stage1", "image_discriminator")


def stage2_trainer_to_jax(arrays: Mapping) -> dict:
    """A stage-2 trainer checkpoint's arrays -> the fields of JAX's stage-2
    ``GANTrainState`` (``batch_stats`` empty: the MotionGenerator has none)."""
    return _trainer_to_jax(arrays, "stage2", "discriminator")
