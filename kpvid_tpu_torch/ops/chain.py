"""The translator decode as a chain of fused conv kernels.

Counterpart of kpvid_tpu/ops/pallas_chain.py::translator_chain:

  oct0a BN + ReLU      elementwise torch on the precomputed first conv
  oct0b..oct0d         conv3x3_affine      32^2 x 256
  oct1a                up2_conv3_affine    -> 64^2 x 128
  oct1b..oct1d         conv3x3_affine      64^2 x 128
  oct2a                up2_conv3_affine    -> 128^2 x 64
  oct2b                conv3x3_affine      128^2 x 64
  crude + mask heads   conv3x3_affine      64 -> 4, no ReLU
  f32 crude, sigmoid mask

The TPU chain packs the last octave along W to fill 128-lane registers;
on the card the C = 64 conv and the 4-channel head are plain launches of
the same kernel, so there is no packing. Each wrapper launches its kernel
for CUDA tensors and takes its plain version on the CPU.
"""

from __future__ import annotations

import torch

from .conv3x3 import conv3x3_affine, fold_bn, up2_conv3_affine


def translator_chain(
    layers: dict,
    first_preact: torch.Tensor,
    head_kernel: torch.Tensor,
    head_bias: torch.Tensor,
    n_octaves: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(crude f32 [N, R, R, 3], mask f32 [N, R, R, 1]).

    layers: name -> (kernel HWIO or None, conv bias or None, BN gamma, BN beta,
    BN mean, BN var) for oct0a and every oct{o}{a..d} layer the decode runs.
    first_preact: [N, h, w, F] pre-activation output of oct0a (bias
    included), in the compute dtype. head_kernel/head_bias: the crude and
    mask convs concatenated along the output channels ([3, 3, C, 4], [4])."""
    dt = first_preact.dtype

    def folded(name):
        k, bias, gamma, beta, mean, var = layers[name]
        scale, shift = fold_bn(bias, gamma, beta, mean, var)
        return k.to(dt), scale, shift

    _, _, gamma, beta, mean, var = layers["oct0a"]
    s0, t0 = fold_bn(None, gamma, beta, mean, var)
    x = torch.relu(first_preact.float() * s0 + t0).to(dt)

    for o in range(n_octaves + 1):
        if o > 0:
            x = up2_conv3_affine(x, *folded(f"oct{o}a"))
        x = conv3x3_affine(x, *folded(f"oct{o}b"))
        if o == n_octaves:
            break
        for layer in ("c", "d"):
            x = conv3x3_affine(x, *folded(f"oct{o}{layer}"))

    ones = torch.ones_like(head_bias, dtype=torch.float32)
    y = conv3x3_affine(x, head_kernel.to(dt), ones, head_bias.float(), relu=False)
    crude = y[..., :3].float()
    mask = torch.sigmoid(y[..., 3:4].float())
    return crude, mask
