"""Batch inference engine of the serving path.

Counterpart of kpvid_tpu/eval/server.py's ``InferenceEngine``,
``request_z``, ``to_uint8`` and ``device_quantize``. A request's motion
latent comes from its seed on the host (``np.random.default_rng(seed)``, the
same draw as the JAX package), so its video depends only on its own
(image, action, seed). The image-valued outputs are quantized to uint8 on
the device before the readback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import Config
from .final import FinalGenerator


def request_z(seed: int, vae_dim: int) -> np.ndarray:
    """The request's motion latent: z ~ N(0, 1)^vae_dim keyed by its seed."""
    return np.random.default_rng(seed).standard_normal(vae_dim).astype(np.float32)


def to_uint8(x: np.ndarray, rescale: bool = True) -> np.ndarray:
    """[-1, 1] (or [0, 1] with rescale=False) -> uint8, truncating after *255."""
    if rescale:
        x = 0.5 * (x + 1.0)
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def device_quantize(x: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    """:func:`to_uint8` on the device: the same f32 arithmetic and the same
    truncating float -> uint8 cast."""
    x = x.float()
    if rescale:
        x = 0.5 * (x + 1.0)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


class InferenceEngine:
    """Owns the parameters and maps a host-side (images, actions, z) batch to
    host-side numpy outputs: pred_im_seq and mask as uint8, points as f32."""

    OUTPUT_KEYS = ("pred_im_seq", "mask", "current_points", "future_points")

    def __init__(self, config: Config, params: dict, device: str | torch.device = "cuda"):
        """params: from ``FinalGenerator.init_parameters`` or ``bridge.from_jax``."""
        self.config = config
        self.final = FinalGenerator(config, device=device)
        self.final.load_parameters(params)
        self.device = self.final.device
        self.vae_dim = config.model.vae_dim
        self.image_size = config.model.image_size
        self.n_action = config.model.n_action
        self.n_future_frames = config.model.n_future_frames

    def dispatch(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> dict:
        """Enqueue the batch on the device and return device tensors without
        waiting for them. Pair with :meth:`fetch`."""
        actions = np.asarray(actions)
        act = np.zeros((actions.shape[0], self.n_action), np.float32)
        act[np.arange(actions.shape[0]), actions] = 1.0
        out = self.final.generate(images, act, z)
        return {
            "pred_im_seq": device_quantize(out["pred_im_seq"]),
            "mask": device_quantize(out["mask"], rescale=False),
            "current_points": out["current_points"].float(),
            "future_points": out["future_points"].float(),
        }

    @staticmethod
    def fetch(out: dict) -> dict:
        """Device tensors -> host numpy; waits for the device."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run(self, images: np.ndarray, actions: np.ndarray, z: np.ndarray) -> dict:
        """images [B, S, S, 3] f32 in [-1, 1]; actions [B] int; z [B, vae_dim]."""
        return self.fetch(self.dispatch(images, actions, z))
