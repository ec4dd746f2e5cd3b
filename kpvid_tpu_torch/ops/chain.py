"""The translator decode as a chain of fused conv kernels.

Counterpart of kpvid_tpu/ops/pallas_chain.py::translator_chain, from the
activation of the translator's first layer on (the split first conv with
that layer's BN + ReLU is one conv3x3_add_affine launch,
eval/final.py::GenerateNet.split_first_conv), at ``Config()``:

  3 x conv3x3_affine    32^2 x 256
  up2_conv3_affine      -> 64^2 x 128
  3 x conv3x3_affine    64^2 x 128
  up2_conv3_affine      -> 128^2 x 64
  conv3x3_affine        128^2 x 64
  conv3x3_affine        the crude + mask heads, 64 -> 4, no ReLU
  f32 crude, sigmoid mask

This module runs layers that are already prepared: it knows no layer name
and reads no BN statistics. ``models/networks.py::Translator.serving_weights``
owns their layout (HWIO kernels in the compute dtype, BN folded to f32
scale and shift, the heads as one 4-channel conv).

The TPU chain packs the 128^2 layers along W to fill 128-lane registers;
on the card the C = 64 conv and the 4-channel head are plain launches of
the same kernel, so there is no packing. Each wrapper launches its kernel
for CUDA tensors and takes its plain version on the CPU.
"""

from __future__ import annotations

import torch

from .conv3x3 import conv3x3_affine, up2_conv3_affine


def translator_chain(x: torch.Tensor, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """(crude f32 [N, R, R, 3], mask f32 [N, R, R, 1]).

    x: [N, h, w, F] the first layer's activation (after its BN and ReLU),
    in the compute dtype. weights: a ``Translator.serving_weights()``
    record; this reads its ``chain``, each layer (up2, HWIO kernel, scale,
    shift) in order, and its ``head`` (kernel [3, 3, C, 4], scale, bias)."""
    x = x.contiguous()
    for layer in weights.chain:
        conv = up2_conv3_affine if layer.up2 else conv3x3_affine
        x = conv(x, layer.kernel, layer.scale, layer.shift)
    head = weights.head
    y = conv3x3_affine(x, head.kernel, head.scale, head.bias, relu=False)
    crude = y[..., :3].float()
    mask = torch.sigmoid(y[..., 3:4].float())
    return crude, mask
