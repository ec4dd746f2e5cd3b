"""Networks of generation and of both training stages, NHWC at every boundary.

Counterpart of kpvid_tpu/models/networks.py: ConvEncoder, ImageEncoder,
PoseEncoder, Translator, Stage1Generator (the training forward, and
detect/embed for inference), ImageDiscriminator (the PatchGAN of
stage 1), and the trainable stage-2 pair: MotionGenerator (decode; with
``encoder=True`` also encode and the training forward) and
SeqDiscriminator. Module and parameter names follow the Flax tree
(``in0_conv/Conv_0/kernel`` is ``in0.conv.weight`` here), so the bridge maps
one onto the other by name.

The encoders and the pose decoder run torch convolutions, as the JAX
package leaves them to XLA, each inference layer's bias, BN and ReLU one
``bias_bn_relu`` op after it (models/layers.py::ConvBNReLU); the pose
decoder upsamples and concatenates its skip input before each octave's
first conv, which is the same function as the JAX fused form. The soft-argmax runs the fused ``pose_head`` kernel and
the stage-1 forward's maps the ``gaussian_render`` kernel, both
differentiable through their backward kernels. The translator's training
form runs torch convolutions, as JAX training takes the XLA path;
``Translator.serving_weights`` is the one owner of its serving layout, which
eval/final.py (generation and its phases) and ops/chain.py (the prepared
layers) read. On a CPU tensor every kernel wrapper takes its plain version.
``train`` selects batch-statistics BN, as in Flax.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batching import pair_fns
from ..ops.conv3x3 import fold_bn
from ..ops.coords import blend
from ..ops.keypoint_kernels import gaussian_render, pose_head
from .layers import Conv, ConvBNReLU, Dense, StackedLSTM


class ConvEncoder(nn.Module):
    """7x7s1 + 3x3s1 at base width, then 3 octaves of [3x3s2 + 3x3s1] with
    doubling filters; returns the four block features (full, 1/2, 1/4, 1/8).
    ``octaves`` < 3 stops the trunk after that many octaves (an inference
    caller that reads no deeper feature): the first ``octaves + 1``."""

    OCTAVES = 3

    def __init__(self, in_ch: int = 3, filters: int = 32, dtype=torch.float32):
        super().__init__()
        f = filters
        self.in0 = ConvBNReLU(in_ch, f, 7, 1, dtype)
        self.in1 = ConvBNReLU(f, f, 3, 1, dtype)
        for i in range(self.OCTAVES):
            setattr(self, f"down{i}", ConvBNReLU(f, 2 * f, 3, 2, dtype))
            setattr(self, f"keep{i}", ConvBNReLU(2 * f, 2 * f, 3, 1, dtype))
            f *= 2

    def forward(self, x: torch.Tensor, train: bool = False,
                octaves: int = OCTAVES) -> list[torch.Tensor]:
        x = self.in1(self.in0(x, train=train), train=train)
        feats = [x]
        for i in range(octaves):
            x = getattr(self, f"down{i}")(x, train=train)
            x = getattr(self, f"keep{i}")(x, train=train)
            feats.append(x)
        return feats


class ImageEncoder(nn.Module):
    """Appearance encoder: returns [input] + the trunk's features."""

    def __init__(self, filters: int = 32, dtype=torch.float32):
        super().__init__()
        self.trunk = ConvEncoder(3, filters, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        return [x] + self.trunk(x, train)


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

    def raw_maps(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        feats = self.trunk(x, train)
        h = feats[-1]
        for o in range(self.n_octaves + 1):
            if o == 0:
                h = self.dec0a(h, train=train)
            else:
                h = getattr(self, f"dec{o}a")(h, up2=True, skip=feats[-1 - o], train=train)
            h = getattr(self, f"dec{o}b")(h, train=train)
            if o < self.n_octaves:
                h = getattr(self, f"dec{o}c")(h, train=train)
                h = getattr(self, f"dec{o}d")(h, train=train)
        return self.heat(h)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, H, W, 3] -> keypoints [B, K, 2] (x, y) in f32; the raw maps
        go to the kernel in the compute dtype, which widens them in registers."""
        return pose_head(self.raw_maps(x, train).contiguous())


class FirstLayer(NamedTuple):  # oct0a, split for eval/final.py's split first conv
    static_kernel: torch.Tensor  # OIHW [F, C + K, 3, 3] of the per-sample channels, for cuDNN
    bias: torch.Tensor  # [F] f32
    frame_kernel: torch.Tensor  # HWIO [3, 3, K, F] of the per-frame channels
    scale: torch.Tensor  # [F] f32: oct0a's BN folded without the bias
    shift: torch.Tensor


class ChainLayer(NamedTuple):  # a conv + BN + ReLU layer of ops/chain.py
    up2: bool  # a 2x upsample before the conv
    kernel: torch.Tensor  # HWIO [3, 3, Cin, Cout]
    scale: torch.Tensor  # [Cout] f32: BN with the conv bias folded in
    shift: torch.Tensor


class Head(NamedTuple):  # crude (channels 0..2) and mask (3) as one conv, no ReLU
    kernel: torch.Tensor  # HWIO [3, 3, C, 4]
    scale: torch.Tensor  # [4] f32 ones
    bias: torch.Tensor  # [4] f32


class ServingWeights(NamedTuple):
    """:meth:`Translator.serving_weights`: kernels in the compute dtype."""

    first: FirstLayer
    chain: tuple[ChainLayer, ...]  # oct0b .. oct2b
    head: Head


class Translator(nn.Module):
    """Image decoder from the 1/4-resolution joint embedding: conv blocks per
    octave, filters halving from ``filters``, two 2x upsample octaves, a
    3-channel crude image head and a 1-channel sigmoid mask head. Its input's
    ``in_ch`` channels are [embedding ++ current maps ++ future maps], the
    maps ``n_pts`` channels each. :meth:`decode` is the training form;
    serving reads :meth:`serving_weights`."""

    n_octaves = 2

    def __init__(self, in_ch: int, n_pts: int, filters: int = 256, dtype=torch.float32):
        super().__init__()
        self.n_pts = n_pts
        self.dtype = dtype
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

    def serving_weights(self) -> ServingWeights:
        """The one place that lays the parameters out for serving: every
        kernel in the compute dtype, every BN folded to f32 (scale, shift)
        by ``fold_bn``. Made from the current parameters at each call. oct0a
        is split at its last ``n_pts`` input channels, the future maps,
        which the split first conv convolves per frame."""
        dt = self.dtype
        conv, bn = self.oct0a.conv, self.oct0a.bn
        weight = conv.weight.to(dt)
        n_static = weight.shape[1] - self.n_pts
        first = FirstLayer(
            weight[:, :n_static], conv.bias.float(),
            # HWIO, copied here so that the op launches its kernel alone
            weight[:, n_static:].permute(2, 3, 1, 0).contiguous(),
            *fold_bn(None, bn.weight, bn.bias, bn.running_mean, bn.running_var),
        )
        chain = tuple(  # registered in decode order; each later octave's "a" upsamples
            ChainLayer(name.endswith("a"), mod.conv.weight.permute(2, 3, 1, 0).contiguous().to(dt),
                       *fold_bn(mod.conv.bias, mod.bn.weight, mod.bn.bias, mod.bn.running_mean,
                                mod.bn.running_var))
            for name, mod in self.named_children()
            if isinstance(mod, ConvBNReLU) and name != "oct0a"
        )
        k = torch.cat([self.crude.weight, self.mask.weight], dim=0)
        b = torch.cat([self.crude.bias, self.mask.bias], dim=0)
        head = Head(k.permute(2, 3, 1, 0).contiguous().to(dt),
                    torch.ones_like(b, dtype=torch.float32), b.float())
        return ServingWeights(first, chain, head)

    def decode(self, joint: torch.Tensor, train: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """The training form, torch convolutions: joint [N, h, w, C] -> (crude
        f32, mask f32), the 2x upsamples (TF1-legacy) between the octaves and
        the crude and mask heads apart."""
        h = joint
        for o in range(self.n_octaves + 1):
            h = getattr(self, f"oct{o}a")(h, up2=o > 0, train=train)
            h = getattr(self, f"oct{o}b")(h, train=train)
            if o < self.n_octaves:
                h = getattr(self, f"oct{o}c")(h, train=train)
                h = getattr(self, f"oct{o}d")(h, train=train)
        return self.crude(h).float(), torch.sigmoid(self.mask(h).float())


class ImageDiscriminator(nn.Module):
    """PatchGAN: six [pad 1 + 4x4 stride-2 SAME] convs, ``filters`` doubling
    to 32x, leaky ReLU 0.01, then pad 1 + 3x3 SAME to one logit map with no
    bias, returned in f32."""

    def __init__(self, filters: int = 64, dtype=torch.float32):
        super().__init__()
        ch, prev = filters, 3
        for i in range(6):
            setattr(self, f"conv{i}", Conv(prev, ch, 4, 2, dtype=dtype, pad=1))
            prev, ch = ch, 2 * ch
        self.logit = Conv(prev, 1, 3, 1, use_bias=False, dtype=dtype, pad=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(6):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        return self.logit(x).float()


class Stage1Generator(nn.Module):
    """Stage-1 graph: the training forward (image encoder on frame t, pose
    encoder on both frames as one 2B batch, Gaussian maps at
    ``heatmap_size``, translator, masked blend), and for inference detect
    and embed."""

    def __init__(self, n_pts: int, image_size: int = 128, encoder_filters: int = 32,
                 translator_filters: int = 256, pose_decoder_filters: int = 128,
                 dtype=torch.float32, heatmap_size: int = 32, heatmap_inv_std: float = 14.3,
                 pair_mode: str = "concat"):
        super().__init__()
        self.dtype = dtype
        self.heatmap_size = heatmap_size
        self.heatmap_inv_std = heatmap_inv_std
        self._pair, self._unpair = pair_fns(pair_mode)
        self.image_encoder = ImageEncoder(encoder_filters, dtype)
        self.pose_encoder = PoseEncoder(
            n_pts, image_size, pose_decoder_filters, encoder_filters, dtype
        )
        self.translator = Translator(encoder_filters * 4 + 2 * n_pts, n_pts, translator_filters,
                                     dtype)

    def forward(self, im: torch.Tensor, future_im: torch.Tensor, train: bool) -> dict:
        """im, future_im: [B, H, W, 3] f32 -> final, crude (f32 [B, H, W, 3]),
        mask (f32 [B, H, W, 1]), current_mu and future_mu ([B, K, 2] f32).
        Both frames share the pose encoder's BN batch statistics; the maps are
        rendered on the f32 grid and written once in the compute dtype."""
        emb = self.image_encoder(im, train)[-2]
        mu = self.pose_encoder(self._pair(im, future_im), train)
        current_mu, future_mu = self._unpair(mu)
        hs, inv_std = self.heatmap_size, self.heatmap_inv_std
        maps = [gaussian_render(m.contiguous(), hs, hs, inv_std, out_dtype=self.dtype)
                for m in (current_mu, future_mu)]
        crude, mask = self.translator.decode(torch.cat([emb.to(self.dtype)] + maps, dim=-1),
                                             train)
        return {"final": blend(im, crude, mask), "crude": crude, "mask": mask,
                "current_mu": current_mu, "future_mu": future_mu}

    def detect(self, im: torch.Tensor) -> torch.Tensor:
        """Frames [B, H, W, 3] -> keypoints [B, K, 2]."""
        return self.pose_encoder(im)

    def embed(self, im: torch.Tensor) -> torch.Tensor:
        """Appearance embedding [B, H/4, W/4, 4 * encoder_filters]: the
        forward's ``[-2]``, the trunk run through its second octave only (the
        third's layers keep their parameters for training)."""
        return self.image_encoder.trunk(im, octaves=2)[-1]


class MotionGenerator(nn.Module):
    """Stage-2 class-conditional VAE over keypoint sequences [B, T, 2K].

    decode: relu FC([z, first_pt, action]) -> the step-0 input of a stacked
    LSTM (zero input afterwards), tanh ``to_coord`` head on every step.
    With ``encoder=True`` (the trainer's model; generation builds the
    decoder alone) also encode: an LSTM over the real sequence, then relu
    FC([last output, first_pt, action]) -> (mu, stddev), both >= 0 by the
    reference's relu quirk; and the training forward, which
    reparameterizes z = mu + stddev * noise and decodes."""

    def __init__(self, n_pts: int, n_action: int, n_future: int = 32,
                 cell_info=(1024, 1024), vae_dim: int = 64, dtype=torch.float32,
                 encoder: bool = False):
        super().__init__()
        self.n_pts = n_pts
        self.n_future = n_future
        self.vae_dim = vae_dim
        cond = 2 * n_pts + n_action
        if encoder:
            self.enc_lstm = StackedLSTM(2 * n_pts, cell_info, dtype=dtype)
            self.enc_head = Dense(int(cell_info[-1]) + cond, 2 * vae_dim, relu=True, dtype=dtype)
        self.dec_in = Dense(vae_dim + cond, 32, relu=True, dtype=dtype)
        self.dec_lstm = StackedLSTM(32, cell_info, dtype=dtype)
        self.to_coord = Dense(int(cell_info[-1]), 2 * n_pts, tanh=True, dtype=dtype)

    def encode(self, real_seq: torch.Tensor, first_pt: torch.Tensor,
               act: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """real_seq [B, T, 2K], first_pt [B, 2K], act [B, A] -> (mu, stddev)."""
        outs = self.enc_lstm(real_seq)
        logit = self.enc_head(torch.cat([outs[:, -1], first_pt, act], dim=-1))
        return logit[:, : self.vae_dim], logit[:, self.vae_dim:]

    def decode(self, z: torch.Tensor, first_pt: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        inp0 = self.dec_in(torch.cat([z, first_pt, act], dim=-1))  # [B, 32]
        xs = torch.cat([inp0[:, None], inp0.new_zeros((b, self.n_future - 1, inp0.shape[-1]))], 1)
        outs = self.dec_lstm(xs)  # [B, T, H]
        coords = self.to_coord(outs.reshape(b * self.n_future, -1))
        return coords.reshape(b, self.n_future, 2 * self.n_pts)

    def forward(self, real_seq, first_pt, act, noise):
        """Training forward -> (pred_seq [B, T, 2K], mu, stddev); z is f32
        (the compute-dtype mu and stddev times the f32 noise, as in JAX)."""
        mu, stddev = self.encode(real_seq, first_pt, act)
        pred_seq = self.decode(mu + stddev * noise, first_pt, act)
        return pred_seq, mu, stddev


class SeqDiscriminator(nn.Module):
    """LSTM over a keypoint sequence [B, T, 2K], then relu FC -> 1 on the last
    step's output (the reference's relu'd logit quirk) -> [B, 1]."""

    def __init__(self, in_dim: int, cell_info=(1024, 1024), dtype=torch.float32):
        super().__init__()
        self.lstm = StackedLSTM(in_dim, cell_info, dtype=dtype)
        self.head = Dense(int(cell_info[-1]), 1, relu=True, dtype=dtype)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        return self.head(self.lstm(seq)[:, -1])
