"""The stage-2 trainer's image summaries.

Counterpart of kpvid_tpu/eval/visualize.py::stage2_summary_images: the
input image, the first frame's keypoints drawn at full resolution, and the
predicted and real keypoint sequences as strips of 64^2 colorized frames
side by side. Only the first ``max_outputs`` samples are drawn. As in JAX,
these are plain tensor code (no kernel); each map is rendered on the grid of
its points' dtype.
"""

from __future__ import annotations

import torch

from ..ops.coords import colorize_point_maps, render_gaussian_maps


def points_image(mu: torch.Tensor, colors, size: int, inv_std: float) -> torch.Tensor:
    """[N, K, 2] -> [N, size, size, 3]."""
    maps = render_gaussian_maps(mu, size, size, inv_std, grid_dtype=mu.dtype, out_dtype=mu.dtype)
    return colorize_point_maps(maps, colors)


def sequence_strip(mu_seq: torch.Tensor, colors, inv_std: float,
                   strip_res: int = 64) -> torch.Tensor:
    """[B, T, K, 2] -> [B, strip_res, T * strip_res, 3]."""
    b, t, k, _ = mu_seq.shape
    imgs = points_image(mu_seq.reshape(b * t, k, 2), colors, strip_res, inv_std)
    imgs = imgs.reshape(b, t, strip_res, strip_res, 3)
    return torch.cat([imgs[:, i] for i in range(t)], dim=2)


@torch.no_grad()
def stage2_summary_images(trainer, batch: dict, colors, noise, max_outputs: int = 2) -> dict:
    """name -> [n, H, W, 3] numpy images of the first ``max_outputs``
    samples of ``batch``; ``noise`` [n, vae_dim] is the forward's VAE noise."""
    small = {k: v[:max_outputs] for k, v in batch.items()}
    pred_seq, _, _ = trainer.forward(small, noise)
    first_pt, real_seq, _ = trainer._flatten_batch(small)
    b, t = pred_seq.shape[:2]
    k = trainer.n_pts
    inv_std = trainer.config.model.heatmap_inv_std
    size = small["image"].shape[1]
    out = {
        "im": small["image"],
        "first_pt": points_image(first_pt.reshape(b, k, 2), colors, size, inv_std),
        "predicted_pose_sequence": sequence_strip(pred_seq.reshape(b, t, k, 2), colors, inv_std),
        "real_pose_sequence": sequence_strip(real_seq.reshape(b, t, k, 2), colors, inv_std),
    }
    return {name: torch.as_tensor(v).float().cpu().numpy() for name, v in out.items()}
