"""The daemon's request decoding as the reference works it out again: a
copy of the port's ``preprocess_image`` (the reference's evaluation crop:
short side to ``image_size`` by PIL's default resize, the reference
center-crop box, [-1, 1] float32) on PIL, and ``request_z`` (a request's
latent from its seed)."""

from __future__ import annotations

import io

import numpy as np


def center_crop_box(size_wh, target: int):
    w, h = size_wh
    half = target // 2
    if w > h:
        ratio = h / float(target)
        ox = int(w / ratio) / 2.0
        return (ox - half, 0, ox + half, target), ratio
    ratio = w / float(target)
    oy = int(h / ratio) / 2.0
    return (0, oy - half, target, oy + half), ratio


def preprocess_jpeg(data: bytes, image_size: int) -> np.ndarray:
    from PIL import Image

    im = Image.open(io.BytesIO(data)).convert("RGB")
    box, ratio = center_crop_box(im.size, image_size)
    w, h = im.size
    im = im.resize((int(w / ratio), int(h / ratio))).crop(box)
    return np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0


def request_z(seed: int, vae_dim: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(vae_dim).astype(np.float32)
