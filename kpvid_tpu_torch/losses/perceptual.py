"""Frozen VGG19 perceptual loss of stage 1.

Copy of kpvid_tpu/losses/perceptual.py in PyTorch:

- inputs are images in [0, 255] (the trainer rescales from [-1, 1] first);
- RGB -> BGR with the per-channel mean [103.939, 116.779, 123.68] taken off
  in f32, then the compute dtype;
- 3x3 SAME convs + ReLU in the compute dtype (torch convolutions, as JAX
  leaves them to XLA), 2x2 stride-2 max-pools, features tapped after
  conv1_2, conv2_2, conv3_4, conv4_4 and conv5_4;
- loss = mean over the five taps of the f32 mean |feat_gt - feat_pred|, gt
  and pred through the tower as one 2B batch (ops/batching.py's layout).

The weights are a frozen dict (name -> HWIO kernel and bias, as the
reference's ``vgg19.npy`` holds them), never a trainer parameter:
:func:`prepare_vgg19` puts them on the device once as OIHW tensors.
:func:`synthesize_vgg19_params` draws JAX's deterministic stand-in weights
from the same ``default_rng`` stream for runs without ``vgg19.npy``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.batching import pair_fns

# (name, out_channels, followed_by_pool)
VGG19_LAYOUT = (
    ("conv1_1", 64, False),
    ("conv1_2", 64, True),
    ("conv2_1", 128, False),
    ("conv2_2", 128, True),
    ("conv3_1", 256, False),
    ("conv3_2", 256, False),
    ("conv3_3", 256, False),
    ("conv3_4", 256, True),
    ("conv4_1", 512, False),
    ("conv4_2", 512, False),
    ("conv4_3", 512, False),
    ("conv4_4", 512, True),
    ("conv5_1", 512, False),
    ("conv5_2", 512, False),
    ("conv5_3", 512, False),
    ("conv5_4", 512, False),  # pool5 comes after the last tap; never needed
)

VGG_FEATURE_LAYERS = ("conv1_2", "conv2_2", "conv3_4", "conv4_4", "conv5_4")

_VGG_MEAN_BGR = (103.939, 116.779, 123.68)


def load_vgg19_params(path: str) -> dict[str, dict[str, np.ndarray]]:
    """The reference's vgg19.npy dict (name -> [HWIO kernel, bias])."""
    data = np.load(path, encoding="latin1", allow_pickle=True).item()
    return {
        name: {"kernel": np.asarray(data[name][0]), "bias": np.asarray(data[name][1])}
        for name, _, _ in VGG19_LAYOUT
    }


def synthesize_vgg19_params(seed: int = 0,
                            max_width: int | None = None) -> dict[str, dict[str, np.ndarray]]:
    """Deterministic He-scaled stand-in weights with vgg19.npy's shapes, the
    same draws as JAX's; ``max_width`` clamps every layer's channels."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for name, out_ch, _ in VGG19_LAYOUT:
        if max_width is not None:
            out_ch = min(out_ch, max_width)
        fan_in = 3 * 3 * in_ch
        params[name] = {
            "kernel": rng.normal(0, np.sqrt(2.0 / fan_in), (3, 3, in_ch, out_ch)).astype(
                np.float32
            ),
            "bias": np.zeros((out_ch,), np.float32),
        }
        in_ch = out_ch
    return params


def prepare_vgg19(params: dict, device) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """name -> (OIHW f32 kernel, f32 bias) on ``device``, frozen."""
    out = {}
    for name, _, _ in VGG19_LAYOUT:
        k = torch.as_tensor(np.asarray(params[name]["kernel"], np.float32))
        b = torch.as_tensor(np.asarray(params[name]["bias"], np.float32))
        out[name] = (k.permute(3, 2, 0, 1).contiguous().to(device), b.to(device))
    return out


def vgg19_features(weights: dict, rgb_0_255: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """The five tap activations (NCHW, ``dtype``) of images [N, H, W, 3] in
    [0, 255]; ``weights`` from :func:`prepare_vgg19`."""
    x = rgb_0_255.float()
    mean = torch.tensor(_VGG_MEAN_BGR, dtype=torch.float32, device=x.device)
    x = (x.flip(-1) - mean).to(dtype).permute(0, 3, 1, 2)
    taps = []
    for name, _, pool in VGG19_LAYOUT:
        k, b = weights[name]
        x = torch.relu(F.conv2d(x, k.to(dtype), padding=1) + b.to(dtype)[:, None, None])
        if name in VGG_FEATURE_LAYERS:
            taps.append(x)
            if len(taps) == len(VGG_FEATURE_LAYERS):
                break
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return taps


def perceptual_loss(weights: dict, gt_0_255: torch.Tensor, pred_0_255: torch.Tensor,
                    dtype: torch.dtype = torch.float32, pair_mode: str = "concat") -> torch.Tensor:
    """Mean over the five taps of mean |feat_gt - feat_pred|, in f32."""
    pair, unpair = pair_fns(pair_mode)
    feats = vgg19_features(weights, pair(gt_0_255, pred_0_255), dtype)
    losses = []
    for f in feats:
        f_gt, f_pred = unpair(f.float())
        losses.append(torch.mean(torch.abs(f_gt - f_pred)))
    return torch.mean(torch.stack(losses))
