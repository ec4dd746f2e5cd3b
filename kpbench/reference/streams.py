"""The stage-2 trainer's VAE noise, worked out from the seed alone.

The training CLI draws it as the reference repository's ``train.py`` does,
with JAX's random streams at JAX's defaults (threefry2x32, partitionable
counters, 32-bit): ``rng = split(PRNGKey(seed))[0]``, then before each loop
step ``rng, step_rng = split(rng)``, and a 'fused' step's noise is
``normal(step_rng, (batch, vae_dim))`` in f32. Here, in plain numpy:

- a key is two 32-bit words, ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``;
- Random123's threefry2x32 with 20 rounds hashes the counter words
  ``(i >> 32, i mod 2**32)`` of element ``i`` under a key;
- ``split(key)`` row ``i`` is the hash of counter ``i``; a draw's 32 bits
  are the XOR of the hash's two words;
- uniform: the bits' top 23 as the mantissa of a float in [1, 2), less 1,
  times ``1 - lo`` plus ``lo``, with ``lo`` the f32 just above -1, and at
  least ``lo``;
- normal: ``sqrt(2) * erfinv(u)``, erfinv scipy's in f64 where JAX takes
  XLA's f32 polynomial, so a draw differs from JAX's in its last bits.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

_MASK = np.uint64(0xFFFFFFFF)
_ROUNDS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _MASK


def threefry(key, hi, lo):
    """Threefry2x32-20 of the counter words (``hi``, ``lo``) under ``key``."""
    k = [np.uint64(int(key[0])), np.uint64(int(key[1]))]
    k.append(k[0] ^ k[1] ^ np.uint64(0x1BD11BDA))
    x0 = (np.asarray(hi, np.uint64) + k[0]) & _MASK
    x1 = (np.asarray(lo, np.uint64) + k[1]) & _MASK
    for group in range(5):
        for r in _ROUNDS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + k[(group + 1) % 3]) & _MASK
        x1 = (x1 + k[(group + 2) % 3] + np.uint64(group + 1)) & _MASK
    return x0, x1


def split(key, n: int = 2) -> list:
    w0, w1 = threefry(key, np.zeros(n), np.arange(n))
    return [(int(a), int(b)) for a, b in zip(w0, w1)]


def normal(key, shape) -> np.ndarray:
    """An f64 draw of N(0, 1) of ``shape`` (JAX's up to its last bits)."""
    n = int(np.prod(shape))
    w0, w1 = threefry(key, np.zeros(n), np.arange(n))
    mantissa = ((w0 ^ w1) >> np.uint64(9)).astype(np.uint32) | np.uint32(0x3F800000)
    unit = mantissa.view(np.float32).astype(np.float64) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0 - lo))
    u = np.maximum(lo, (unit * span + lo).astype(np.float32)).astype(np.float64)
    return (np.sqrt(2.0) * erfinv(u)).reshape(shape)


def stage2_noise(seed: int, steps: int, rows: int, dim: int) -> list:
    """The noise of the CLI's first ``steps`` 'fused' stage-2 steps for
    ``training.seed`` = ``seed``, in f32: [rows, dim] a step."""
    rng = split((0, seed % 2**32))[0]
    out = []
    for _ in range(steps):
        rng, step = split(rng)
        out.append(normal(step, (rows, dim)).astype(np.float32))
    return out
