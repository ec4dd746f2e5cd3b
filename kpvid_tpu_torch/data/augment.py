"""The host-side frame geometry of serving and labeling.

Copies the parts of kpvid_tpu/data/augment.py that those two paths use: the
reference center-crop box, ``to_unit_float`` and ``FrameOps`` with its two
byte-identical backends, PIL ('pil') and the C++ kernels of
kpvid_tpu_torch/native ('native', frames as uint8 HWC arrays). The training
augmentations come with the training slices.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


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

    def resize(self, frame, size_wh: tuple[int, int]):
        if self.native:
            return self._n.resize_bicubic(frame, size_wh)
        return frame.resize(size_wh)

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
