"""The host-side frame geometry and augmentations of every data path.

Copy of kpvid_tpu/data/augment.py: the reference center-crop box, the image
pair loader's quirk-Q8 test box (x centered, y always 0..target), the
short-side resize, the ten PIL filter/enhance branches of the stage-1 train
augmentation, ``to_unit_float``, the keypoint rotation and one-hot of the
stage-2 augmentations, and ``FrameOps`` with its two byte-identical
backends, PIL ('pil') and the C++ kernels of kpvid_tpu_torch/native
('native', frames as uint8 HWC arrays).
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def resize_short_side(image: Image.Image, target: int) -> tuple[Image.Image, float]:
    """Resize so the short side is ``target`` px, keeping the aspect, with
    the reference's int() dims; returns (resized, ratio)."""
    w, h = image.size
    ratio = (h if w > h else w) / float(target)
    return image.resize((int(w / ratio), int(h / ratio))), ratio


def center_crop_box(size_wh: tuple[int, int], target: int) -> tuple[tuple, float]:
    """The reference center-crop box: short side scaled to target, long side
    center-cropped. Returns (box, ratio)."""
    w, h = size_wh
    half = target // 2
    if w > h:
        ratio = h / float(target)
        ox = int(w / ratio) / 2.0
        box = (ox - half, 0, ox + half, target)
    else:
        ratio = w / float(target)
        oy = int(h / ratio) / 2.0
        box = (0, oy - half, target, oy + half)
    return box, ratio


def pair_test_crop_box(size_wh: tuple[int, int], target: int) -> tuple[tuple, float]:
    """The image pair loader's test box (quirk Q8): x centered, y always
    0..target, so portrait frames are cropped from the top."""
    w, h = size_wh
    half = target // 2
    ratio = (h if w > h else w) / float(target)
    ox = int(w / ratio) / 2.0
    return (ox - half, 0, ox + half, target), ratio


def apply_random_filter(images: list[Image.Image], rng: np.random.Generator) -> list[Image.Image]:
    """One of the reference's ten PIL filter/enhance branches, the same for
    every image of the list, with JAX's draws from ``rng``."""
    r = int(rng.integers(0, 10))
    if r < 6:
        filt = [
            ImageFilter.DETAIL,
            ImageFilter.EDGE_ENHANCE,
            ImageFilter.SMOOTH,
            ImageFilter.SMOOTH_MORE,
            ImageFilter.EDGE_ENHANCE_MORE,
            ImageFilter.BLUR,
        ][r]
        return [im.filter(filt) for im in images]
    if r == 6:
        v = int(rng.integers(0, 51)) * 0.1
        return [ImageEnhance.Sharpness(im).enhance(v) for im in images]
    if r == 7:
        v = int(rng.integers(7, 21)) * 0.1
        return [ImageEnhance.Brightness(im).enhance(v) for im in images]
    if r == 8:
        v = int(rng.integers(0, 51)) * 0.1
        return [ImageEnhance.Color(im).enhance(v) for im in images]
    v = int(rng.integers(7, 31)) * 0.1
    return [ImageEnhance.Contrast(im).enhance(v) for im in images]


def rotate_keypoints(keypoints: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate [-1, 1] keypoints about the origin (the image center) to follow
    PIL's counterclockwise ``rotate(degrees)`` of the frame: a rotation by
    -degrees in math coordinates, which is PIL's in its y-down raster."""
    rad = np.radians(-degrees)
    c, s = np.cos(rad), np.sin(rad)
    x, y = keypoints[..., 0], keypoints[..., 1]
    return np.stack([c * x - s * y, s * x + c * y], axis=-1)


def one_hot(n_classes: int, idx: int) -> np.ndarray:
    label = np.zeros((n_classes,), np.float32)
    label[int(idx)] = 1.0
    return label


def to_unit_float(image: Image.Image) -> np.ndarray:
    return np.asarray(image, np.float32) / 255.0


def resolve_frame_ops(mode: str = "auto") -> "FrameOps":
    """Map a DataConfig.native_ops value to a FrameOps instance."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"native_ops must be auto|on|off, got {mode!r}")
    if mode == "off":
        return FrameOps(use_native=False)
    from .. import native

    ok = native.available()
    if mode == "on" and not ok:
        raise RuntimeError(
            "data.native_ops='on' but the native kernels are unavailable "
            "(no host compiler, build failure, or PIL mismatch)"
        )
    return FrameOps(use_native=ok)


class FrameOps:
    """Backend-dispatched frame ops. Frames are PIL Images ('pil') or uint8
    HWC arrays ('native'); callers treat them as opaque between prepare()
    and the to_*() exits."""

    def __init__(self, use_native: bool):
        self.native = bool(use_native)
        if self.native:
            from .. import native as _native

            self._n = _native

    def prepare(self, im: Image.Image):
        return np.asarray(im, np.uint8) if self.native else im

    def size(self, frame) -> tuple[int, int]:
        if self.native:
            return frame.shape[1], frame.shape[0]
        return frame.size

    def rotate(self, frame, angle: float):
        if self.native:
            return self._n.rotate_nearest(frame, angle)
        return frame.rotate(angle)

    def resize(self, frame, size_wh: tuple[int, int]):
        if self.native:
            return self._n.resize_bicubic(frame, size_wh)
        return frame.resize(size_wh)

    def resize_short_side(self, frame, target: int):
        """resize_short_side() over either backend (the same int() dims)."""
        w, h = self.size(frame)
        ratio = (h if w > h else w) / float(target)
        return self.resize(frame, (int(w / ratio), int(h / ratio))), ratio

    def crop(self, frame, box):
        if not self.native:
            return frame.crop(box)
        # PIL Image.crop semantics: round() the box (banker's, like
        # CPython), clamp degenerate boxes, zero-fill out-of-bounds
        x0, y0, x1, y1 = (int(round(v)) for v in box)
        x1, y1 = max(x1, x0), max(y1, y0)
        h, w = frame.shape[:2]
        sy0, sy1 = max(y0, 0), min(y1, h)
        sx0, sx1 = max(x0, 0), min(x1, w)
        if sy0 == y0 and sy1 == y1 and sx0 == x0 and sx1 == x1:
            return frame[y0:y1, x0:x1]
        out = np.zeros((y1 - y0, x1 - x0, frame.shape[2]), frame.dtype)
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = frame[sy0:sy1, sx0:sx1]
        return out

    def hflip(self, frame):
        if self.native:
            return np.ascontiguousarray(frame[:, ::-1])
        return frame.transpose(Image.FLIP_LEFT_RIGHT)

    def random_filter(self, frames: list, rng: np.random.Generator) -> list:
        """apply_random_filter() over either backend: native frames go
        through PIL at their cropped size and back."""
        if not self.native:
            return apply_random_filter(frames, rng)
        ims = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
        return [np.asarray(im, np.uint8) for im in apply_random_filter(ims, rng)]

    def to_pm1(self, frame) -> np.ndarray:
        """float32 in [-1, 1]: to_unit_float(frame) * 2 - 1."""
        if self.native:
            return self._n.to_f32(frame, pm1=True)
        return to_unit_float(frame) * 2.0 - 1.0

    def to_unit(self, frame) -> np.ndarray:
        """float32 in [0, 1]: to_unit_float(frame)."""
        if self.native:
            return self._n.to_f32(frame, pm1=False)
        return to_unit_float(frame)

    def to_u8(self, frame) -> np.ndarray:
        return frame if self.native else np.asarray(frame, np.uint8)
