"""The Penn-Action tree's split files and frame files.

Copies read_split, video_frame_count and load_frame of
kpvid_tpu/data/image_pair.py: a split file ``<data_dir>/<subset>_set.txt``
of "frames/<id> <action>" lines, and 1-based ``%06d.jpg`` frames per video
directory. The stage-1 pair dataset comes with the training slices.
"""

from __future__ import annotations

import os
from os import path as osp

from PIL import Image


def read_split(data_dir: str, subset: str) -> list[tuple[str, int]]:
    with open(osp.join(data_dir, subset + "_set.txt"), "r") as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    return [(rel, int(act)) for rel, act in lines]


def video_frame_count(data_dir: str, rel_path: str) -> int:
    return len(os.listdir(osp.join(data_dir, rel_path)))


def load_frame(data_dir: str, rel_path: str, idx: int) -> Image.Image:
    """Frame ``idx`` (0-based) of a video: the file ``{idx + 1:06d}.jpg``."""
    return Image.open(osp.join(data_dir, rel_path, f"{idx + 1:06d}.jpg"))
