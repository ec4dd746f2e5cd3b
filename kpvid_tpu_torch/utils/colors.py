"""Keypoint visualization palette (a copy of kpvid_tpu/utils/colors.py).

Random candidate colors, greedily keeping the one furthest (L1) from all
colors chosen so far; seeded, so a palette is the same in every run and in
both packages."""

from __future__ import annotations

import numpy as np


def get_n_colors(n: int, pastel_factor: float = 0.0, seed: int = 0) -> np.ndarray:
    """Return [n, 3] float32 colors in [0, 1]."""
    rng = np.random.default_rng(seed)
    colors = np.empty((n, 3), np.float64)
    for i in range(n):
        cand = (rng.uniform(0, 1, (100, 3)) + pastel_factor) / (1.0 + pastel_factor)
        if i == 0:
            colors[0] = cand[0]
            continue
        dists = np.abs(cand[:, None, :] - colors[None, :i, :]).sum(-1).min(axis=1)
        colors[i] = cand[np.argmax(dists)]
    return colors.astype(np.float32)
