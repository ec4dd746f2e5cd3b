"""Stage-2 and evaluate dataset: first frame + keypoint trajectory + action.

A copy of kpvid_tpu/data/sequence.py::SequenceDataset, sample for sample
(the same bytes from the same rng):

- the labels are ``<data_dir>/pseudo_labels/{id}.npy`` (the labeler's);
- temporal subsampling: gap = n_frames // 33; gap >= 1 takes 33 frames
  ``gap`` apart; gap < 1 takes 17 consecutive frames and interpolates the
  midpoints of their keypoints up to 33;
- train augments: a rotation of U{-15..15} degrees of the image AND the
  keypoints (about the [-1, 1] origin), a 50% horizontal flip (x -> -x), and
  a keypoint scale of U{0.70..1.20} in 0.01 steps;
- the reference center crop;
- ``with_image_seq``: the 32 future frames at the ABSOLUTE indices i * gap
  (i = 1..32), the reference's quirk of ignoring the start index (only run
  with augmentation off);
- outputs: image [H, W, 3] in [-1, 1]; keypoints [K, 2]; real_seq
  [32, K, 2]; action_code one-hot [A]; optionally real_im_seq
  [32, H, W, 3] in [-1, 1].
"""

from __future__ import annotations

from os import path as osp

import numpy as np

from . import augment
from .image_pair import load_frame, read_split, video_frame_count


class SequenceDataset:
    def __init__(
        self,
        data_dir: str,
        subset: str,
        n_pts: int,
        n_action: int,
        sequence_len: int = 33,
        image_size: int = 128,
        with_image_seq: bool = False,
        augment_samples: bool | None = None,
        random_order: bool | None = None,
        native_ops: str = "auto",
    ):
        self.ops = augment.resolve_frame_ops(native_ops)
        self.data_dir = data_dir
        self.n_pts = n_pts
        self.n_action = n_action
        self.seq_len = sequence_len
        self.image_size = image_size
        self.with_image_seq = with_image_seq
        self.videos = read_split(data_dir, subset)
        is_train = subset == "train"
        self.augment_samples = is_train if augment_samples is None else augment_samples
        self.random_order = is_train if random_order is None else random_order

    def __len__(self) -> int:
        return len(self.videos)

    def _load_keypoints(self, rel: str) -> np.ndarray:
        return np.load(osp.join(self.data_dir, rel.replace("frames", "pseudo_labels") + ".npy"))

    def sample(self, idx: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        if self.random_order:
            idx = int(rng.integers(0, len(self.videos)))
        rel, act = self.videos[idx]
        n_frames = video_frame_count(self.data_dir, rel)
        keypoints = self._load_keypoints(rel)
        t_total = self.seq_len
        gap = n_frames // t_total
        n_half = (t_total - 1) // 2 + 1

        if self.augment_samples:
            if gap >= 1:
                start = int(rng.integers(0, n_frames - t_total * gap + 1))
            else:
                start = int(rng.integers(0, n_frames - n_half + 1))
        else:
            start = 0

        ops = self.ops
        image = ops.prepare(load_frame(self.data_dir, rel, start).convert("RGB"))

        if gap >= 1:
            fr_idx = [start + gap * i for i in range(t_total)]
            real_seq = keypoints[fr_idx, :, :].astype(np.float64)
        else:
            real_seq = np.zeros((t_total, self.n_pts, 2))
            half = keypoints[start : start + n_half, :, :]
            for i in range(n_half - 1):
                real_seq[2 * i] = half[i]
                real_seq[2 * i + 1] = (half[i] + half[i + 1]) / 2.0
            real_seq[-1] = half[-1]

        if self.augment_samples:
            angle = int(rng.integers(-15, 16))
            image = ops.rotate(image, angle)
            real_seq = augment.rotate_keypoints(real_seq, angle)

        box, ratio = augment.center_crop_box(ops.size(image), self.image_size)
        w, h = ops.size(image)
        image = ops.crop(ops.resize(image, (int(w / ratio), int(h / ratio))), box)

        image_seq = None
        if self.with_image_seq:
            n_future = t_total - 1
            seq_gap, twice = gap, False
            if seq_gap < 1:
                seq_gap, twice, n_future = 1, True, n_future // 2
            frames = []
            for i in range(1, n_future + 1):
                cur = ops.prepare(load_frame(self.data_dir, rel, i * seq_gap).convert("RGB"))
                cur = ops.crop(ops.resize(cur, (int(w / ratio), int(h / ratio))), box)
                arr = ops.to_unit(cur)
                frames.append(arr)
                if twice:
                    frames.append(arr)
            image_seq = np.stack(frames, axis=0) * 2.0 - 1.0

        if self.augment_samples:
            if int(rng.integers(0, 2)):
                image = ops.hflip(image)
                real_seq[:, :, 0] *= -1.0
            scale = int(rng.integers(70, 121)) / 100.0
            real_seq = real_seq * scale

        out = {
            "image": ops.to_pm1(image),
            "keypoints": real_seq[0].astype(np.float32),
            "real_seq": real_seq[1:].astype(np.float32),
            "action_code": augment.one_hot(self.n_action, act),
        }
        if image_seq is not None:
            out["real_im_seq"] = image_seq.astype(np.float32)
        return out
