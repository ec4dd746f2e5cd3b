"""A synthetic Penn-Action-style tree, for runs without the dataset.

Copies make_synthetic_penn_tree of kpvid_tpu/data/synthetic.py, so both
packages write the same JPEG bytes from the same seed:

    <root>/train_set.txt, test_set.txt      ("frames/<id> <action>" lines)
    <root>/frames/<id>/000001.jpg ...       (1-based %06d JPEG frames)

Each video is a moving figure (a torso, a head and four limbs swinging with
an action-dependent frequency and amplitude); frame sizes alternate
landscape (200x150) and portrait (150x200) so both crop branches run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw


def _draw_figure(draw: ImageDraw.ImageDraw, w: int, h: int, t: float, action: int, vid: int):
    cx = w * (0.35 + 0.3 * ((vid * 37) % 100) / 100.0)
    cy = h * 0.5
    freq = 0.5 + 0.25 * action
    amp = 0.08 + 0.02 * (action % 3)
    sway = amp * np.sin(2 * np.pi * freq * t)
    # torso
    tw, th = w * 0.12, h * 0.3
    draw.rectangle([cx - tw / 2, cy - th / 2, cx + tw / 2, cy + th / 2], fill=(200, 120, 90))
    # head
    r = w * 0.05
    hy = cy - th / 2 - r
    draw.ellipse([cx - r, hy - r, cx + r, hy + r], fill=(230, 190, 160))
    # limbs: four swinging segments
    for k, (ox, oy, phase) in enumerate(
        [(-tw / 2, -th / 4, 0.0), (tw / 2, -th / 4, np.pi), (-tw / 4, th / 2, np.pi),
         (tw / 4, th / 2, 0.0)]
    ):
        ang = sway * (3 + k) + phase * 0.1
        length = h * 0.22
        x0, y0 = cx + ox, cy + oy
        x1 = x0 + length * np.sin(ang + 0.3 * k)
        y1 = y0 + length * np.cos(ang * 0.5)
        color = (90 + 30 * k, 160, 220 - 30 * k)
        draw.line([x0, y0, x1, y1], fill=color, width=max(2, w // 40))


def make_synthetic_penn_tree(root: str | Path, n_train: int = 4, n_test: int = 2,
                             n_actions: int = 9, frames_per_video: int = 40,
                             seed: int = 0) -> Path:
    """Create the tree and return its root. Does nothing if the tree's
    completion marker exists."""
    root = Path(root)
    marker = root / ".synthetic_complete"
    if marker.exists():
        return root
    rng = np.random.default_rng(seed)
    (root / "frames").mkdir(parents=True, exist_ok=True)
    splits = {"train": range(1, n_train + 1), "test": range(n_train + 1, n_train + n_test + 1)}
    for subset, ids in splits.items():
        lines = []
        for vid in ids:
            action = int(rng.integers(0, n_actions))
            w, h = (200, 150) if vid % 2 else (150, 200)
            vdir = root / "frames" / f"{vid:04d}"
            vdir.mkdir(parents=True, exist_ok=True)
            n_fr = frames_per_video + int(rng.integers(0, 8))
            for f in range(n_fr):
                im = Image.new("RGB", (w, h), (30 + vid * 5 % 60, 40, 55))
                _draw_figure(ImageDraw.Draw(im), w, h, f / 8.0, action, vid)
                im.save(vdir / f"{f + 1:06d}.jpg", quality=85)
            lines.append(f"frames/{vid:04d} {action}")
        (root / f"{subset}_set.txt").write_text("\n".join(lines) + "\n")
    marker.write_text("ok")
    return root
