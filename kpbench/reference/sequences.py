"""The first batches of a stage-2 training run, made from the data tree alone.

Plain numpy; it reads ``train_set.txt``, the number of frame files of each
video and ``pseudo_labels/<id>.npy``. The rule is the reference
repository's stage-2 sampler under a seeded, shuffled stream:

- epoch ``e``'s order is a permutation of the videos drawn from
  ``SeedSequence([seed, e])``; the sample at position ``idx`` of it draws
  from its own generator, ``SeedSequence([seed, e, idx])``, in this order:
- the video, again uniform over the split (the train split's random order);
- the start frame, uniform over those that leave 33 frames ``gap`` apart
  (``gap = n_frames // 33``);
- a rotation of U{-15..15} degrees, of the keypoints about the [-1, 1]
  origin as PIL turns the frame (counterclockwise on a y-down raster);
- a horizontal flip with probability 1/2 (x -> -x);
- a scale of U{70..120} / 100.

A sample is the first frame's keypoints [K, 2], the 32 that follow
[32, K, 2] (f64 until then, f32 out) and the action's one-hot code [A].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SEQ_LEN = 33


def _videos(root: Path) -> list:
    lines = (root / "train_set.txt").read_text().split("\n")
    return [(rel, int(act)) for rel, act in (line.split() for line in lines if line.strip())]


def sample(root: Path, videos: list, rng: np.random.Generator, n_action: int) -> dict:
    rel, action = videos[int(rng.integers(0, len(videos)))]
    n_frames = sum(1 for _ in (root / rel).iterdir())
    gap = n_frames // SEQ_LEN
    if gap < 1:
        raise ValueError(f"{rel}: {n_frames} frames, fewer than {SEQ_LEN}")
    start = int(rng.integers(0, n_frames - SEQ_LEN * gap + 1))
    points = np.load(root / "pseudo_labels" / f"{Path(rel).name}.npy")
    seq = points[start + gap * np.arange(SEQ_LEN)].astype(np.float64)
    rad = np.radians(-int(rng.integers(-15, 16)))
    c, s = np.cos(rad), np.sin(rad)
    x, y = seq[..., 0], seq[..., 1]
    seq = np.stack([c * x - s * y, s * x + c * y], axis=-1)
    if int(rng.integers(0, 2)):
        seq[..., 0] = -seq[..., 0]
    seq = seq * (int(rng.integers(70, 121)) / 100.0)
    code = np.zeros(n_action, np.float32)
    code[action] = 1.0
    return {"keypoints": seq[0].astype(np.float32), "real_seq": seq[1:].astype(np.float32),
            "action_code": code}


def first_batches(root: Path, seed: int, batch_size: int, n_batches: int,
                  n_action: int) -> list:
    """The first ``n_batches`` batches of ``batch_size`` of the train split
    under ``seed``: each a dict of stacked arrays."""
    root = Path(root)
    videos = _videos(root)
    samples, epoch = [], 0
    while len(samples) < batch_size * n_batches:
        order = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(
            len(videos))
        for idx in order[:batch_size * n_batches - len(samples)]:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, int(idx)]))
            samples.append(sample(root, videos, rng, n_action))
        epoch += 1
    return [{k: np.stack([s[k] for s in samples[i:i + batch_size]])
             for k in samples[0]} for i in range(0, len(samples), batch_size)]
