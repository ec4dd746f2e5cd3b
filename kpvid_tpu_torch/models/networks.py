"""Networks of generation and of both training stages, NHWC at every boundary.

Counterpart of kpvid_tpu/models/networks.py: ConvEncoder, ImageEncoder,
PoseEncoder, Translator, Stage1Generator (the training forward, and
detect/embed/generate for inference), ImageDiscriminator (the PatchGAN of
stage 1), and the trainable stage-2 pair: MotionGenerator (decode; with
``encoder=True`` also encode and the training forward) and
SeqDiscriminator. Module and parameter names follow the Flax tree
(``in0_conv/Conv_0/kernel`` is ``in0.conv.weight`` here), so the bridge maps
one onto the other by name.

The encoders and the pose decoder run torch convolutions, as the JAX
package leaves them to XLA; the pose decoder upsamples and concatenates its
skip input before each octave's first conv, which is the same function as
the JAX fused form. The soft-argmax runs the fused ``pose_head`` kernel and
the stage-1 forward's maps the ``gaussian_render`` kernel, both
differentiable through their backward kernels. The translator's serving
decode runs the conv kernels of ops/chain.py; its training form runs torch
convolutions, as JAX training takes the XLA path. On a CPU tensor every
kernel wrapper takes its plain version. ``train`` selects batch-statistics
BN, as in Flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batching import pair_fns
from ..ops.chain import translator_chain
from ..ops.coords import blend
from ..ops.keypoint_kernels import gaussian_render, pose_head
from ..utils.spans import span
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

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        x = self.in1(self.in0(x, train=train), train=train)
        feats = [x]
        for i in range(3):
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
    ``heatmap_size``, translator, masked blend), and for inference detect,
    embed, and generate T frames from one source frame."""

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
        self.translator = Translator(encoder_filters * 4 + 2 * n_pts, translator_filters, dtype)

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
        """Appearance embedding [B, H/4, W/4, 4 * encoder_filters]."""
        return self.image_encoder(im)[-2]

    def generate(self, im: torch.Tensor, first_preact: torch.Tensor,
                 head_kernel: torch.Tensor, head_bias: torch.Tensor) -> dict:
        """im: [B, H, W, 3]; first_preact: [B*T, h, w, F] -> the T frames of
        each sample, blended with the source frame and clipped to [-1, 1]."""
        b = im.shape[0]
        t = first_preact.shape[0] // b
        with span("kpvid.generate.translator"):
            crude, mask = self.translator(first_preact, head_kernel, head_bias)
        with span("kpvid.generate.blend"):
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
