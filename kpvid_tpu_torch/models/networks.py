"""Inference-mode networks of the generation path, NHWC at every boundary.

Counterpart of kpvid_tpu/models/networks.py: ConvEncoder, ImageEncoder,
PoseEncoder, Translator (the serving decode), Stage1Generator's
detect/embed/generate and MotionGenerator.decode. Module and parameter
names follow the Flax tree (``in0_conv/Conv_0/kernel`` is ``in0.conv.weight``
here), so the bridge maps one onto the other by name.

The encoders and the pose decoder run torch convolutions, as the JAX
package leaves them to XLA; the pose decoder upsamples and concatenates its
skip input before each octave's first conv, which is the same function as
the JAX fused form. The soft-argmax runs the fused ``pose_head`` kernel and
the translator the conv kernels of ops/chain.py (their plain versions on a
CPU tensor).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.chain import translator_chain
from ..ops.coords import blend
from ..ops.keypoint_kernels import pose_head
from .layers import Conv, ConvBNReLU, Dense, StackedLSTM


class ConvEncoder(nn.Module):
    """7x7s1 + 3x3s1 at base width, then 3 octaves of [3x3s2 + 3x3s1] with
    doubling filters; returns the four block features (full, 1/2, 1/4, 1/8)."""

    def __init__(self, in_ch: int = 3, filters: int = 32, dtype=torch.float32):
        super().__init__()
        f = filters
        self.in0 = ConvBNReLU(in_ch, f, 7, 1, dtype)
        self.in1 = ConvBNReLU(f, f, 3, 1, dtype)
        for i in range(3):
            setattr(self, f"down{i}", ConvBNReLU(f, 2 * f, 3, 2, dtype))
            setattr(self, f"keep{i}", ConvBNReLU(2 * f, 2 * f, 3, 1, dtype))
            f *= 2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.in1(self.in0(x))
        feats = [x]
        for i in range(3):
            x = getattr(self, f"keep{i}")(getattr(self, f"down{i}")(x))
            feats.append(x)
        return feats


class ImageEncoder(nn.Module):
    """Appearance encoder: returns [input] + the trunk's features."""

    def __init__(self, filters: int = 32, dtype=torch.float32):
        super().__init__()
        self.trunk = ConvEncoder(3, filters, dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x] + self.trunk(x)


class PoseEncoder(nn.Module):
    """Keypoint detector: trunk + skip-connected upsampling decoder to K raw
    heatmaps at full resolution, then the spatial soft-argmax in f32."""

    def __init__(self, n_pts: int, image_size: int, filters: int = 128,
                 trunk_filters: int = 32, dtype=torch.float32):
        super().__init__()
        self.trunk = ConvEncoder(3, trunk_filters, dtype)
        f, prev_f, res, octave = filters, trunk_filters * 8, image_size // 8, 0
        while True:
            skip_ch = 0 if octave == 0 else trunk_filters * 2 ** (3 - octave)
            setattr(self, f"dec{octave}a", ConvBNReLU(prev_f + skip_ch, f, 3, 1, dtype))
            setattr(self, f"dec{octave}b", ConvBNReLU(f, f, 3, 1, dtype))
            if res == image_size:
                self.heat = Conv(f, n_pts, 1, dtype=dtype)
                break
            setattr(self, f"dec{octave}c", ConvBNReLU(f, f, 3, 1, dtype))
            setattr(self, f"dec{octave}d", ConvBNReLU(f, f, 3, 1, dtype))
            prev_f, res, octave = f, res * 2, octave + 1
            if f >= 8:
                f //= 2
        self.n_octaves = octave

    def raw_maps(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.trunk(x)
        h = feats[-1]
        for o in range(self.n_octaves + 1):
            if o == 0:
                h = self.dec0a(h)
            else:
                h = getattr(self, f"dec{o}a")(h, up2=True, skip=feats[-1 - o])
            h = getattr(self, f"dec{o}b")(h)
            if o < self.n_octaves:
                h = getattr(self, f"dec{o}d")(getattr(self, f"dec{o}c")(h))
        return self.heat(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> keypoints [B, K, 2] (x, y) in f32; the raw maps
        go to the kernel in the compute dtype, which widens them in registers."""
        return pose_head(self.raw_maps(x).contiguous())


class Translator(nn.Module):
    """Image decoder from the 1/4-resolution joint embedding: conv blocks per
    octave, filters halving from ``filters``, two 2x upsample octaves, a
    3-channel crude image head and a 1-channel sigmoid mask head. Inference
    runs the serving decode of ops/chain.py on the precomputed first conv."""

    n_octaves = 2

    def __init__(self, in_ch: int, filters: int = 256, dtype=torch.float32):
        super().__init__()
        f, prev_f = filters, in_ch
        for o in range(self.n_octaves + 1):
            setattr(self, f"oct{o}a", ConvBNReLU(prev_f, f, 3, 1, dtype))
            setattr(self, f"oct{o}b", ConvBNReLU(f, f, 3, 1, dtype))
            if o < self.n_octaves:
                setattr(self, f"oct{o}c", ConvBNReLU(f, f, 3, 1, dtype))
                setattr(self, f"oct{o}d", ConvBNReLU(f, f, 3, 1, dtype))
                prev_f = f
                if f >= 8:
                    f //= 2
        self.crude = Conv(f, 3, 3, dtype=dtype)
        self.mask = Conv(f, 1, 3, dtype=dtype)

    def layer_params(self) -> dict:
        """name -> (HWIO kernel, conv bias, BN gamma, beta, mean, var) for
        every conv+BN block, as ops/chain.translator_chain takes them."""
        out = {}
        for name, mod in self.named_children():
            if isinstance(mod, ConvBNReLU):
                bn = mod.bn
                out[name] = (
                    mod.conv.weight.permute(2, 3, 1, 0).contiguous(), mod.conv.bias,
                    bn.weight, bn.bias, bn.running_mean, bn.running_var,
                )
        return out

    def fused_heads(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The crude and mask convs as one 4-channel conv: ([3, 3, C, 4] HWIO,
        [4]); channels 0..2 are crude, channel 3 the mask logit."""
        k = torch.cat([self.crude.weight, self.mask.weight], dim=0)
        b = torch.cat([self.crude.bias, self.mask.bias], dim=0)
        return k.permute(2, 3, 1, 0).contiguous(), b

    def forward(self, first_preact: torch.Tensor, head_kernel: torch.Tensor,
                head_bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """first_preact: [N, h, w, F] output of oct0a's conv (bias included)
        -> (crude f32 [N, 4h, 4w, 3], mask f32 [N, 4h, 4w, 1])."""
        return translator_chain(
            self.layer_params(), first_preact.contiguous(), head_kernel, head_bias,
            n_octaves=self.n_octaves,
        )


class Stage1Generator(nn.Module):
    """Stage-1 graph at inference: detect, embed, and generate T frames from
    one source frame."""

    def __init__(self, n_pts: int, image_size: int = 128, encoder_filters: int = 32,
                 translator_filters: int = 256, pose_decoder_filters: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.image_encoder = ImageEncoder(encoder_filters, dtype)
        self.pose_encoder = PoseEncoder(
            n_pts, image_size, pose_decoder_filters, encoder_filters, dtype
        )
        self.translator = Translator(encoder_filters * 4 + 2 * n_pts, translator_filters, dtype)

    def detect(self, im: torch.Tensor) -> torch.Tensor:
        """Frames [B, H, W, 3] -> keypoints [B, K, 2]."""
        return self.pose_encoder(im)

    def embed(self, im: torch.Tensor) -> torch.Tensor:
        """Appearance embedding [B, H/4, W/4, 4 * encoder_filters]."""
        return self.image_encoder(im)[-2]

    def generate(self, im: torch.Tensor, first_preact: torch.Tensor,
                 head_kernel: torch.Tensor, head_bias: torch.Tensor) -> dict:
        """im: [B, H, W, 3]; first_preact: [B*T, h, w, F] -> the T frames of
        each sample, blended with the source frame and clipped to [-1, 1]."""
        b = im.shape[0]
        t = first_preact.shape[0] // b
        crude, mask = self.translator(first_preact, head_kernel, head_bias)
        im_t = im.float().repeat_interleave(t, dim=0)
        final = torch.clamp(blend(im_t, crude, mask), -1.0, 1.0)
        crude = torch.clamp(crude, -1.0, 1.0)
        hw = tuple(im.shape[1:3])
        return {
            "pred_im_seq": final.reshape(b, t, *hw, 3),
            "mask": mask.reshape(b, t, *hw, 1),
            "pred_im_crude": crude.reshape(b, t, *hw, 3),
        }


class MotionGenerator(nn.Module):
    """Stage-2 decoder: relu FC([z, first_pt, action]) -> the step-0 input of
    a stacked LSTM (zero input afterwards), tanh ``to_coord`` head on every
    step -> [B, T, 2K]."""

    def __init__(self, n_pts: int, n_action: int, n_future: int = 32,
                 cell_info=(1024, 1024), vae_dim: int = 64, dtype=torch.float32):
        super().__init__()
        self.n_pts = n_pts
        self.n_future = n_future
        self.dec_in = Dense(vae_dim + 2 * n_pts + n_action, 32, relu=True, dtype=dtype)
        self.dec_lstm = StackedLSTM(32, cell_info, dtype=dtype)
        self.to_coord = Dense(int(cell_info[-1]), 2 * n_pts, tanh=True, dtype=dtype)

    def decode(self, z: torch.Tensor, first_pt: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        inp0 = self.dec_in(torch.cat([z, first_pt, act], dim=-1))  # [B, 32]
        xs = torch.cat([inp0[:, None], inp0.new_zeros((b, self.n_future - 1, inp0.shape[-1]))], 1)
        outs = self.dec_lstm(xs)  # [B, T, H]
        coords = self.to_coord(outs.reshape(b * self.n_future, -1))
        return coords.reshape(b, self.n_future, 2 * self.n_pts)
