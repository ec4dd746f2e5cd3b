"""Host C++ image kernels of the input pipeline: bicubic resize, nearest
rotate and u8 -> f32.

A copy of kpvid_tpu/native (``fastimage.cpp`` is the same file, byte for
byte). These run on the host, not the card: they replace PIL's per-frame
resize and rotate and the to-float conversion of the serving, labeling and
sequence pipelines, BYTE-IDENTICAL to PIL. The source is compiled with ``g++`` at first use into
the port's build directory (``ops/_build.build_dir()``), bound with ctypes
(which releases the GIL for each call, so the daemon's handler threads and
the labeler's decode thread run them in parallel), and checked against PIL
once before use. ``DataConfig.native_ops`` selects them ('auto' | 'on' |
'off', see data/augment.py::resolve_frame_ops).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops._build import build_dir

logger = logging.getLogger("kpvid_tpu_torch")

_SRC = Path(__file__).parent / "fastimage.cpp"
_lib: ctypes.CDLL | None = None
_state: str | None = None  # None = unprobed; 'ok' | 'unavailable'
_lock = threading.Lock()


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = build_dir() / f"fastimage-{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # write to a temp name then rename: another process may build the same file
    with tempfile.NamedTemporaryFile(dir=out.parent, suffix=".so", delete=False) as tf:
        tmp = Path(tf.name)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", str(_SRC),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native fastimage build failed (%s); using PIL", e)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    ci = ctypes.c_int
    lib.ki_resize_bicubic_u8.argtypes = [u8p, ci, ci, u8p, ci, ci, ci]
    lib.ki_resize_bicubic_u8.restype = ci
    lib.ki_affine_nearest_u8.argtypes = [u8p, ci, ci, u8p, ctypes.POINTER(ctypes.c_double), ci]
    lib.ki_affine_nearest_u8.restype = ci
    lib.ki_u8_to_f32.argtypes = [u8p, f32p, ci, ci, ci, ci, ci]
    lib.ki_u8_to_f32.restype = ci
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bicubic(src: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """PIL im.resize((dw, dh)) (default BICUBIC) on a u8 HWC array."""
    dw, dh = int(size_wh[0]), int(size_wh[1])
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((dh, dw, ch), np.uint8)
    rc = _lib.ki_resize_bicubic_u8(_u8ptr(src), sw, sh, _u8ptr(dst), dw, dh, ch)
    if rc != 0:
        raise ValueError(f"ki_resize_bicubic_u8 failed ({rc})")
    return dst


def rotate_matrix(w: int, h: int, angle_degrees: float) -> np.ndarray:
    """The output -> input affine matrix PIL's Image.rotate builds (its
    round(.., 15) of the trigonometric terms included), so the C kernel and
    PIL truncate the same double coordinates."""
    angle = -math.radians(angle_degrees % 360.0)
    a = round(math.cos(angle), 15)
    b = round(math.sin(angle), 15)
    cx, cy = w / 2.0, h / 2.0
    c = a * -cx + b * -cy + cx
    f = -b * -cx + a * -cy + cy
    return np.array([a, b, c, -b, a, f], np.float64)


def rotate_nearest(src: np.ndarray, angle_degrees: float) -> np.ndarray:
    """PIL im.rotate(angle) (NEAREST, expand=False, zero fill) on a u8 HWC array."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w, ch = src.shape
    if angle_degrees % 360.0 == 0.0:
        return src.copy()
    m = rotate_matrix(w, h, angle_degrees)
    dst = np.empty_like(src)
    rc = _lib.ki_affine_nearest_u8(_u8ptr(src), w, h, _u8ptr(dst),
                                   m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ch)
    if rc != 0:
        raise ValueError(f"ki_affine_nearest_u8 failed ({rc})")
    return dst


def to_f32(src: np.ndarray, pm1: bool = True) -> np.ndarray:
    """np.asarray(im, f32) / 255 (pm1=False) or the same * 2 - 1 (pm1=True),
    with the same f32 arithmetic as the numpy expressions."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w, ch = src.shape
    dst = np.empty((h, w, ch), np.float32)
    rc = _lib.ki_u8_to_f32(_u8ptr(src), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           w, h, ch, 0, int(bool(pm1)))
    if rc != 0:
        raise ValueError(f"ki_u8_to_f32 failed ({rc})")
    return dst


def _self_check() -> bool:
    """One small randomized comparison against the running PIL per kernel:
    catches an unusual Pillow build or a miscompiled library."""
    from PIL import Image

    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (37, 53, 3), np.uint8)
    if not np.array_equal(np.asarray(Image.fromarray(src).resize((21, 29))),
                          resize_bicubic(src, (21, 29))):
        return False
    if not np.array_equal(np.asarray(Image.fromarray(src).rotate(7)), rotate_nearest(src, 7)):
        return False
    unit = np.asarray(src, np.float32) / 255.0
    return np.array_equal(unit, to_f32(src, pm1=False)) and np.array_equal(
        unit * 2.0 - 1.0, to_f32(src))


def available() -> bool:
    """Build (cached), bind and self-check the kernels once; False means the
    caller takes the PIL path. Never raises."""
    global _lib, _state
    with _lock:
        if _state is not None:
            return _state == "ok"
        try:
            path = _build()
            if path is not None:
                _lib = _bind(path)
                if _self_check():
                    _state = "ok"
                    return True
                logger.warning("native fastimage kernels disagree with this PIL build; "
                               "using PIL")
        except Exception as e:  # noqa: BLE001 - the probe reports, the caller decides
            logger.info("native fastimage unavailable (%s); using PIL", e)
        _lib = None
        _state = "unavailable"
        return False
