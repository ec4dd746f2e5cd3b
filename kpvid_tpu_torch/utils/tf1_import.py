"""The reference's TF1 checkpoints -> the port's trainer parameters.

Copy of kpvid_tpu/utils/tf1_import.py's name rules, keyed on the Flax path
that ``bridge.jax_path`` gives each of the port's names, so that
:func:`map_names` takes the port's parameter name to the reference's TF1
variable name:

- ``layers.conv(scope=s)`` -> ``<scope>/s/conv2d/kernel|bias``;
  ``layers.batch_norm(scope=s)`` -> ``<scope>/s/{gamma,beta,moving_mean,
  moving_variance}``;
- LSTM stacks -> ``<scope>[/rnn]/multi_rnn_cell/cell_{i}/basic_lstm_cell/
  kernel|bias`` (``rnn/`` under dynamic_rnn: the VAE encoder and the
  sequence discriminator);
- ``fully_connected`` -> ``<scope>/fully_connected/weights|biases``; the
  shared ``to_coord`` head -> ``vae_decoder/fully_connected/W|b``.

TF1 conv kernels are HWIO and fully-connected weights [in, out], Flax's
layouts, so the arrays go through the bridge's layouts (HWIO -> OIHW) and
nowhere else. :func:`transcode_tf1_checkpoint` reads the bundle with
``tf_bundle`` (numpy alone, no TensorFlow). The reference's Adam slots
(``.../Adam``, ``.../Adam_1``), ``beta1_power``, ``beta2_power`` and
``global_step`` are in no map and are not read.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np
import torch

from ..bridge import _convert, jax_path
from .tf_bundle import TFBundle

# flax trunk block name -> reference encoder conv index
_TRUNK = {
    "in0": 1, "in1": 2,
    "down0": 3, "keep0": 4,
    "down1": 5, "keep1": 6,
    "down2": 7, "keep2": 8,
}


def _conv_leaf(tf_scope: str, leaf: str) -> str:
    return f"{tf_scope}/conv2d/{'kernel' if leaf == 'kernel' else 'bias'}"


def _bn_leaf(tf_scope: str, leaf: str) -> str:
    return tf_scope + "/" + {
        "scale": "gamma",
        "bias": "beta",
        "mean": "moving_mean",
        "var": "moving_variance",
    }[leaf]


def _trunk_name(parts: list[str], leaf: str, prefix: str) -> str | None:
    """parts like ['in0_conv', 'Conv_0'] or ['down1_bn', 'BatchNorm_0']."""
    head = parts[0]
    if head.endswith("_conv"):
        idx = _TRUNK.get(head[:-5])
        if idx is None:
            return None
        return _conv_leaf(f"{prefix}/conv_{idx}", leaf)
    if head.endswith("_bn"):
        idx = _TRUNK.get(head[:-3])
        if idx is None:
            return None
        return _bn_leaf(f"{prefix}/b_norm_{idx}", leaf)
    return None


def _decoder_name(parts: list[str], leaf: str, prefix: str) -> str | None:
    """Pose-decoder / translator blocks: dec{o}{a-d} / oct{o}{a-d} map to
    conv_{2o+1}_0, conv_{2o+1}_1, conv_{2o+2}_0, conv_{2o+2}_1."""
    head = parts[0]
    for tag in ("dec", "oct"):
        if head.startswith(tag) and (head.endswith("_conv") or head.endswith("_bn")):
            body = head[len(tag):].split("_")[0]  # e.g. '0a'
            octave, sub = int(body[:-1]), body[-1]
            conv_id = 2 * octave + 1 + (0 if sub in "ab" else 1)
            col = 0 if sub in "ac" else 1
            if head.endswith("_conv"):
                return _conv_leaf(f"{prefix}/conv_{conv_id}_{col}", leaf)
            return _bn_leaf(f"{prefix}/b_norm_{conv_id}_{col}", leaf)
    return None


def _stage1_tf_name(path: tuple[str, ...]) -> str | None:
    """Flax path (module..., Conv_0 or BatchNorm_0, leaf) -> TF1 name."""
    *parts, _flax_mod, leaf = path
    if parts and parts[0] == "image_encoder":
        rest = parts[1:]
        if rest and rest[0] == "trunk":
            return _trunk_name(rest[1:], leaf, "image_encoder/encoder")
        return None
    if parts and parts[0] == "pose_encoder":
        rest = parts[1:]
        if rest and rest[0] == "trunk":
            return _trunk_name(rest[1:], leaf, "pose_encoder/encoder")
        if rest and rest[0] == "heat":
            # the final 1x1 conv uses layers.conv's default scope 'conv_0'
            return _conv_leaf("pose_encoder/conv_0", leaf)
        return _decoder_name(rest, leaf, "pose_encoder")
    if parts and parts[0] == "translator":
        rest = parts[1:]
        if rest and rest[0] == "crude":
            return _conv_leaf("translator/conv_6_0", leaf)
        if rest and rest[0] == "mask":
            return _conv_leaf("translator/conv_6_1", leaf)
        return _decoder_name(rest, leaf, "translator")
    return None


def _discr_tf_name(path: tuple[str, ...]) -> str | None:
    *parts, _mod, leaf = path
    if not parts:
        return None
    head = parts[0]
    if head == "logit":
        return _conv_leaf("img_discr/D_logit", leaf)
    if head.startswith("conv"):
        return _conv_leaf(f"img_discr/conv_{head[4:]}", leaf)
    return None


def _stage2_tf_name(path: tuple[str, ...]) -> str | None:
    head, leaf = path[0], path[-1]

    def lstm(scope: str, rnn: bool) -> str:
        _, idx, kind = leaf.split("_")  # leaf like 'lstm_0_kernel'
        mid = "rnn/multi_rnn_cell" if rnn else "multi_rnn_cell"
        return f"{scope}/{mid}/cell_{idx}/basic_lstm_cell/{kind}"

    def fc(scope: str) -> str:
        return f"{scope}/fully_connected/" + ("weights" if leaf == "kernel" else "biases")

    if head == "enc_lstm":
        return lstm("vae_encoder", rnn=True)
    if head == "enc_head":
        return fc("vae_encoder")
    if head == "dec_in":
        return fc("vae_decoder")
    if head == "dec_lstm":
        return lstm("vae_decoder", rnn=False)
    if head == "to_coord":
        return f"vae_decoder/fully_connected/{'W' if leaf == 'kernel' else 'b'}"
    # sequence discriminator (its own tree)
    if head.startswith("StackedLSTM"):
        return lstm("seq_discr", rnn=True)
    if head.startswith("Dense"):
        return fc("seq_discr")
    return None


def _flax_shape(shape) -> tuple[int, ...]:
    """A port tensor's shape in the TF1 / Flax layout (OIHW -> HWIO)."""
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else tuple(shape)


_MAPPERS = {"stage1": _stage1_tf_name, "stage1_discr": _discr_tf_name,
            "stage2": _stage2_tf_name, "stage2_discr": _stage2_tf_name}
STAGES = tuple(_MAPPERS)


def map_names(names: Iterable[str], stage: str) -> dict[str, str]:
    """The port's trainer names (``stage1.*``, ``image_discriminator.*``,
    ``stage2.*``, ``discriminator.*``) -> the TF1 variable name, for every
    name the mapping covers. stage: 'stage1' | 'stage1_discr' | 'stage2' |
    'stage2_discr'."""
    mapper = _MAPPERS[stage]
    out = {}
    for name in names:
        tf_name = mapper(jax_path(name.split(".", 1)[1]))
        if tf_name is not None:
            out[name] = tf_name
    return out


def transcode_tf1_checkpoint(ckpt_path: str, target: Mapping[str, torch.Tensor],
                             stage: str) -> tuple[dict[str, torch.Tensor], dict]:
    """Graft the TF1 checkpoint ``ckpt_path``'s tensors onto ``target``
    (port name -> tensor). Returns (merged, report): ``matched`` and
    ``missing`` list TF1 names, ``mismatched`` (TF1 name, checkpoint shape,
    model shape in the TF1 layout). A missing or mismatched tensor keeps the
    target's value."""
    bundle = TFBundle(ckpt_path)
    tf_shapes = bundle.shapes()
    mapping = map_names(target, stage)
    merged = dict(target)
    matched, missing, mismatched = [], [], []
    for name, tf_name in mapping.items():
        if tf_name not in tf_shapes:
            missing.append(tf_name)
            continue
        want = _flax_shape(tuple(target[name].shape))
        if tuple(tf_shapes[tf_name]) != want:
            mismatched.append((tf_name, tuple(tf_shapes[tf_name]), want))
            continue
        value = _convert(np.asarray(bundle.tensor(tf_name), np.float32))
        merged[name] = value.to(device=target[name].device, dtype=target[name].dtype)
        matched.append(tf_name)
    return merged, {"matched": matched, "missing": missing, "mismatched": mismatched}
