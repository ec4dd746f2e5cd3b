"""Fused end-to-end generation: one image + action class -> T-frame video.

Counterpart of kpvid_tpu/eval/final.py::FinalGenerator:

  pose-encode the input image -> first-frame keypoints (pose_head kernel)
  explicit z -> motion decoder (stacked LSTM) -> T future keypoint frames
  32^2 Gaussian maps (gaussian_render kernel); the translator's first conv
  split so its frame-invariant channels are convolved once per sample;
  the translator decode (conv kernels, ops/chain.py); blend and clip.

The entry point runs on the card by default and raises where there is none;
pass ``device="cpu"`` to run the plain versions on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Config
from ..device import resolve_device, to_device
from ..models import BatchNorm, Conv, Dense, MotionGenerator, StackedLSTM, Stage1Generator
from ..ops.keypoint_kernels import gaussian_render


class FinalGenerator:
    def __init__(self, config: Config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        m = config.model
        self.dtype = (
            torch.bfloat16 if config.training.compute_dtype == "bfloat16" else torch.float32
        )
        self.n_pts = m.n_pts
        self.n_future = m.n_future_frames
        self.stage1 = Stage1Generator(
            m.n_pts, m.image_size, m.encoder_filters, m.translator_filters,
            m.pose_decoder_filters, self.dtype,
        )
        self.stage2 = MotionGenerator(
            m.n_pts, m.n_action, m.n_future_frames, m.cell_info, m.vae_dim, self.dtype
        )
        self.model = nn.ModuleDict({"stage1": self.stage1, "stage2": self.stage2})
        self.model.to(self.device).eval()

    def init_parameters(self, seed: int) -> dict[str, torch.Tensor]:
        """Parameters with the shapes and init laws of the JAX package's
        FinalGenerator.init_variables, drawn on the CPU from ``seed``:
        Xavier-uniform kernels, zero biases, normal(0.02) for ``to_coord``,
        BN scale 1 / bias 0 / mean 0 / var 1. Keyed like
        :meth:`load_parameters` takes them."""
        gen = torch.Generator().manual_seed(seed)
        params = {k: torch.zeros_like(v, device="cpu") for k, v in self.model.state_dict().items()}

        def xavier(key, fan_in, fan_out):
            a = math.sqrt(6.0 / (fan_in + fan_out))
            params[key].uniform_(-a, a, generator=gen)

        for name, mod in self.model.named_modules():
            p = f"{name}."
            if isinstance(mod, Conv):
                o, i, kh, kw = mod.weight.shape
                xavier(p + "weight", i * kh * kw, o * kh * kw)
            elif isinstance(mod, BatchNorm):
                params[p + "weight"].fill_(1.0)
                params[p + "running_var"].fill_(1.0)
            elif isinstance(mod, StackedLSTM):
                for li in range(len(mod.features)):
                    key = f"{p}lstm_{li}_kernel"
                    xavier(key, *params[key].shape)
            elif isinstance(mod, Dense):
                if mod.tanh:
                    params[p + "weight"].normal_(0.0, 0.02, generator=gen)
                else:
                    xavier(p + "weight", *params[p + "weight"].shape)
        return params

    def load_parameters(self, params: dict) -> None:
        """Load a dict from :meth:`init_parameters` or ``bridge.from_jax``."""
        self.model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
             for k, v in params.items()},
            strict=True,
        )

    @torch.no_grad()
    def generate(self, im, action_code, z) -> dict:
        """im: [B, H, W, 3] in [-1, 1]; action_code: [B, A] one-hot; z: the
        motion latents [B, vae_dim]. Each sample's output depends only on its
        own (im, action, z) row.

        Returns im (the input on the device), pred_im_seq [B, T, H, W, 3],
        mask [B, T, H, W, 1], pred_im_crude, current_points [B, K, 2] and
        future_points [B, T, K, 2]."""
        im = to_device(im, self.device, torch.float32)
        act = to_device(action_code, self.device, torch.float32)
        z = to_device(z, self.device, torch.float32)
        b = im.shape[0]
        current_mu = self.stage1.detect(im)
        first_pt = current_mu.reshape(b, 2 * self.n_pts)
        pred_flat = self.stage2.decode(z, first_pt, act)  # [B, T, 2K]
        future_mu_seq = pred_flat.reshape(b, self.n_future, self.n_pts, 2)
        first = self._split_first_conv(im, current_mu, future_mu_seq)
        head_k, head_b = self.stage1.translator.fused_heads()
        out = self.stage1.generate(im, first, head_k, head_b)
        return {
            "im": im,
            "pred_im_seq": out["pred_im_seq"],
            "mask": out["mask"],
            "pred_im_crude": out["pred_im_crude"],
            "current_points": current_mu,
            "future_points": future_mu_seq,
        }

    def _split_first_conv(self, im, current_mu, future_mu_seq) -> torch.Tensor:
        """Pre-activation output of the translator's first conv for all B*T
        frames. Its input channels are [embedding ++ current map ++ future
        map]; the first two are the same for every frame of a sample, so
        they are convolved once per sample (exact by linearity), with the
        bias added once."""
        b, t = future_mu_seq.shape[:2]
        m = self.config.model
        hs, dt = m.heatmap_size, self.dtype
        emb = self.stage1.embed(im)
        # JAX renders each map on the grid of its keypoints' dtype: f32 for
        # the detected points, the compute dtype for the decoded ones; both
        # are written once in the compute dtype
        cur_map = gaussian_render(current_mu.float().contiguous(), hs, hs, m.heatmap_inv_std,
                                  out_dtype=dt)
        fut_map = gaussian_render(
            future_mu_seq.reshape(b * t, self.n_pts, 2).float().contiguous(),
            hs, hs, m.heatmap_inv_std, grid_dtype=future_mu_seq.dtype, out_dtype=dt,
        )
        static = torch.cat([emb.to(dt), cur_map], dim=-1)
        conv = self.stage1.translator.oct0a.conv
        weight = conv.weight.to(dt)  # [F, 128 + 2K, 3, 3]
        n_static = static.shape[-1]

        def conv3(x, w):
            y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
            return y.permute(0, 2, 3, 1)

        y_static = conv3(static, weight[:, :n_static]) + conv.bias.to(dt)  # [B, h, w, F]
        y_dyn = conv3(fut_map, weight[:, n_static:])  # [B*T, h, w, F]
        y = y_dyn.reshape(b, t, *y_dyn.shape[1:]) + y_static[:, None]
        return y.reshape(b * t, *y_dyn.shape[1:])
