"""Stage 1's dataset of (frame t, frame t + d) pairs, and the Penn-Action
tree's split files and frame files.

Copy of kpvid_tpu/data/image_pair.py: a split file
``<data_dir>/<subset>_set.txt`` of "frames/<id> <action>" lines, 1-based
``%06d.jpg`` frames per video directory, and :class:`ImagePairDataset`:

- train: a random video (the sample index is not used), a uniform random
  frame t, d ~ U{8..11} with wraparound, then the same rotation U{-10..10}
  degrees, short-side resize, random crop along the long axis, 50% flip and
  one PIL filter/enhance branch for both frames;
- test: t = 0, d = 10 (or the last frame), the quirk-Q8 crop;
- float32 images in [-1, 1].

Every draw comes from the ``rng`` the pipeline passes, in JAX's order, so a
seed gives the JAX package's bytes. JAX's decoded-frame cache
(``data.decode_cache_mb``) is not ported: each sample decodes its two
frames.
"""

from __future__ import annotations

import os
import threading
from os import path as osp

import numpy as np
from PIL import Image

from . import augment


def read_split(data_dir: str, subset: str) -> list[tuple[str, int]]:
    with open(osp.join(data_dir, subset + "_set.txt"), "r") as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    return [(rel, int(act)) for rel, act in lines]


def video_frame_count(data_dir: str, rel_path: str) -> int:
    return len(os.listdir(osp.join(data_dir, rel_path)))


def load_frame(data_dir: str, rel_path: str, idx: int) -> Image.Image:
    """Frame ``idx`` (0-based) of a video: the file ``{idx + 1:06d}.jpg``."""
    return Image.open(osp.join(data_dir, rel_path, f"{idx + 1:06d}.jpg"))


class ImagePairDataset:
    def __init__(self, data_dir: str, subset: str, image_size: int = 128,
                 augment_samples: bool | None = None, random_pairs: bool | None = None,
                 native_ops: str = "auto"):
        self.data_dir = data_dir
        self.image_size = image_size
        self.videos = read_split(data_dir, subset)
        is_train = subset == "train"
        self.augment_samples = is_train if augment_samples is None else augment_samples
        self.random_pairs = is_train if random_pairs is None else random_pairs
        self.ops = augment.resolve_frame_ops(native_ops)
        self._frame_counts: dict[str, int] = {}
        self._fc_lock = threading.Lock()

    def _n_frames(self, rel: str) -> int:
        n = self._frame_counts.get(rel)
        if n is None:
            n = video_frame_count(self.data_dir, rel)
            with self._fc_lock:
                self._frame_counts[rel] = n
        return n

    def __len__(self) -> int:
        return len(self.videos)

    def sample(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        if self.random_pairs:
            idx = int(rng.integers(0, len(self.videos)))
        rel, _act = self.videos[idx]
        n_frames = self._n_frames(rel)
        if self.random_pairs:
            interval = int(rng.integers(8, 12))
            t = int(rng.integers(0, n_frames))
            t_future = (t + interval) % n_frames
        else:
            t, t_future = 0, min(10, n_frames - 1)

        ops = self.ops
        im = ops.prepare(load_frame(self.data_dir, rel, t).convert("RGB"))
        fim = ops.prepare(load_frame(self.data_dir, rel, t_future).convert("RGB"))
        size = self.image_size
        if self.augment_samples:
            angle = int(rng.integers(-10, 11))
            im, fim = ops.rotate(im, angle), ops.rotate(fim, angle)
            im, _ = ops.resize_short_side(im, size)
            fim, _ = ops.resize_short_side(fim, size)
            w, h = ops.size(im)
            if w > h:
                off = int(rng.integers(0, w - size + 1))
                box = (off, 0, off + size, size)
            else:
                off = int(rng.integers(0, h - size + 1))
                box = (0, off, size, off + size)
            im, fim = ops.crop(im, box), ops.crop(fim, box)
            if int(rng.integers(0, 2)):
                im, fim = ops.hflip(im), ops.hflip(fim)
            im, fim = ops.random_filter([im, fim], rng)
        else:
            box, _ = augment.pair_test_crop_box(ops.size(im), size)
            im, _ = ops.resize_short_side(im, size)
            fim, _ = ops.resize_short_side(fim, size)
            im, fim = ops.crop(im, box), ops.crop(fim, box)
        return {"image": ops.to_pm1(im), "future_image": ops.to_pm1(fim)}
