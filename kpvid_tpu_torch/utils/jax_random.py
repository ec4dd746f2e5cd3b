"""JAX's random streams, drawn on the host with numpy.

The JAX package draws every random number through ``jax.random`` (its
initial weights through Flax's initializers). This module draws the same
numbers without JAX, so that one seed means the same weights, latents and
training noise in both packages. It reproduces JAX 0.9's defaults
(``jax_default_prng_impl`` threefry2x32, ``jax_threefry_partitionable``
True, ``jax_enable_x64`` False) and Flax 0.12's parameter keys
(``flax_fix_rng_separator`` False):

- a key is two uint32 words; :func:`PRNGKey` of an integer seed is
  ``[0, seed mod 2**32]`` (with x64 off JAX converts the seed to int32
  first, so ``PRNGKey(2**32 + 5)`` is ``[0, 5]`` and both ``PRNGKey(-1)``
  and ``PRNGKey(2**63 - 1)`` are ``[0, 0xFFFFFFFF]``);
- :func:`threefry2x32` is Random123's threefry2x32 with 20 rounds;
  partitionable counters number an array's elements by their flat index
  ``i``, split into the words ``(i >> 32, i & 0xFFFFFFFF)``;
- :func:`split` ``(key, n)``: row ``i`` is ``threefry2x32(key, (0, i))``;
  :func:`fold_in` ``(key, d)`` is ``threefry2x32(key, (0, d mod 2**32))``;
- :func:`bits` (32-bit): element ``i`` is the XOR of the two output words
  of counter ``i``;
- :func:`uniform`: ``f32((bits >> 9) | 0x3F800000) - 1``, then
  ``u * (maxval - minval) + minval`` in f32, then ``max(minval, .)``;
- :func:`normal`: ``f32(sqrt 2) * erfinv(uniform(key, shape,
  nextafter(-1, 0), 1))``, with :func:`erfinv` XLA's single-precision
  polynomial (``w = -log1p(-x * x)``, two sets of 9 coefficients split at
  ``w < 5``). ``log1p`` is numpy's, not XLA's, so a draw may differ from
  JAX's in its last bits (a few ulp at most; most draws are equal);
- :func:`flax_param_key`: Flax gives the ``c``-th ``make_rng('params')``
  call of the module at scope path ``(n1, ..., nk)`` the key
  ``fold_in(root, u32)``, ``u32`` the first 4 bytes (big-endian) of the
  SHA-1 of ``n1 ... nk`` (UTF-8) followed by ``c`` (its minimal big-endian
  bytes); each ``self.param`` call makes one, counted from 1 in the order
  of the calls;
- the init laws of the JAX package: :func:`xavier_uniform` (Flax's
  ``variance_scaling(1, 'fan_avg', 'uniform')``: fans ``in * r`` and
  ``out * r`` with ``r`` the product of the other axes, so a conv kernel is
  drawn in its HWIO shape) and :func:`normal_init` (``normal(stddev)``);
  its zeros and ones need no draw.

Each array is drawn in one vectorised pass over its counters, in blocks of
``BLOCK`` counters (to bound the temporaries) spread over a pool of
threads. Nothing here imports JAX.
"""

from __future__ import annotations

import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
BLOCK = 1 << 20  # counters per pass

# XLA's ErfInv32: p(w) by Horner from the first coefficient
_ERFINV_W_LT_5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                           1.50140941], np.float32)
_ERFINV_W_GE_5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                           2.83297682], np.float32)


def PRNGKey(seed) -> np.ndarray:  # noqa: N802 - JAX's name
    """``jax.random.PRNGKey(seed)`` as a uint32 [2] array."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} is out of the int64 range JAX accepts")
    return np.array([0, seed & _MASK], np.uint32)


def as_key(seed_or_key) -> np.ndarray:
    """A key: an integer seed goes through :func:`PRNGKey`; a key (any
    uint32 pair) is returned as a uint32 [2] array."""
    if isinstance(seed_or_key, (int, np.integer)):
        return PRNGKey(seed_or_key)
    key = np.asarray(seed_or_key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"a key is a uint32 array of shape (2,), got {key.dtype} {key.shape}")
    return key


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Random123's threefry2x32_20 of the counter words ``(x0, x1)`` (uint32
    arrays of one shape) under ``key``; returns the two output words."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.add(x0, np.uint32(ks[0]), dtype=np.uint32)
    x1 = np.add(x1, np.uint32(ks[1]), dtype=np.uint32)
    tmp = np.empty_like(x1)
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 += x1
            np.right_shift(x1, np.uint32(32 - r), out=tmp)
            np.left_shift(x1, np.uint32(r), out=x1)
            x1 |= tmp
            x1 ^= x0
        x0 += np.uint32(ks[(group + 1) % 3])
        x1 += np.uint32((ks[(group + 2) % 3] + group + 1) & _MASK)
    return x0, x1


def _counter_words(start: int, stop: int) -> tuple[np.ndarray, np.ndarray]:
    """The words (hi, lo) of the flat counters ``start .. stop - 1``."""
    if stop <= 1 << 32:
        return np.zeros(stop - start, np.uint32), np.arange(start, stop, dtype=np.uint32)
    i = np.arange(start, stop, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(_MASK)).astype(np.uint32)


def _blocks(key, n: int, fn, out: np.ndarray) -> np.ndarray:
    """``out.flat[a:b] = fn(*threefry2x32(key, counters a .. b - 1))`` over
    blocks of :data:`BLOCK` counters, the blocks on a pool of threads
    (numpy's element-wise loops release the interpreter lock)."""
    flat = out.reshape(-1)

    def block(a: int) -> None:
        b = min(n, a + BLOCK)
        flat[a:b] = fn(*threefry2x32(key, *_counter_words(a, b)))

    starts = range(0, n, BLOCK)
    if len(starts) <= 1:
        for a in starts:
            block(a)
        return out
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        for _ in pool.map(block, starts):  # raises a block's error
            pass
    return out


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 [num, 2]."""
    out = np.empty((num, 2), np.uint32)
    y0, y1 = threefry2x32(as_key(key), *_counter_words(0, num))
    out[:, 0], out[:, 1] = y0, y1
    return out


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (``data`` taken mod 2**32, as JAX's
    uint32 conversion does)."""
    y0, y1 = threefry2x32(as_key(key), np.zeros(1, np.uint32),
                          np.array([int(data) & _MASK], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 of ``shape``."""
    shape = tuple(int(s) for s in shape)
    out = np.empty(shape, np.uint32)
    return _blocks(as_key(key), math.prod(shape), np.bitwise_xor, out)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """``a * b + c`` of f32 values rounded once to f32, as an FMA does (XLA
    contracts a product and a sum into one). The product is exact in f64;
    the f64 sum rounds to the f32 nearest the exact one, unless it lies on
    the midpoint of two f32 values, where the sum's rounding error picks the
    side."""
    s = a.astype(np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    t = s + c
    tie = (t.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if tie.any():
        back = t - s
        err = (s - (t - back)) + (c - back)  # t + err is the exact sum
        nudge = tie & (err != 0)
        t = np.where(nudge, np.nextafter(t, np.where(err > 0, np.inf, -np.inf)), t)
    return t.astype(np.float32)


def _unit(y0: np.ndarray, y1: np.ndarray) -> np.ndarray:
    """Uniform [0, 1) f32 of the 32-bit draws ``y0 ^ y1`` (JAX's mantissa trick)."""
    y0 ^= y1
    y0 >>= np.uint32(9)
    y0 |= np.uint32(0x3F800000)
    return y0.view(np.float32) - np.float32(1.0)


def _affine_unit(minval, maxval):
    """The block function of ``uniform(minval, maxval)`` (f32)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    return lambda y0, y1: np.maximum(lo, _fma32(_unit(y0, y1), span, lo))


def _draw(key, shape, fn) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    return _blocks(as_key(key), math.prod(shape), fn, np.empty(shape, np.float32))


def uniform(key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    if np.dtype(dtype) != np.float32:
        raise NotImplementedError(f"only float32 draws are reproduced, not {np.dtype(dtype)}")
    return _draw(key, shape, _affine_unit(minval, maxval))


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision inverse error function of f32 ``x``
    (``erfinv(+-1) = +-inf``)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-(x * x))
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
        for lo, hi in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
            p = _fma32(p, w, np.where(lt, lo, hi))
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), p * x)


_SQRT2 = np.float32(np.sqrt(2.0))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def normal(key, shape=(), dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    if np.dtype(dtype) != np.float32:
        raise NotImplementedError(f"only float32 draws are reproduced, not {np.dtype(dtype)}")
    unit = _affine_unit(_NORMAL_LO, 1.0)
    return _draw(key, shape, lambda y0, y1: _SQRT2 * erfinv(unit(y0, y1)))


def flax_param_key(root, path, counter: int) -> np.ndarray:
    """The key Flax's ``make_rng('params')`` gives the ``counter``-th call
    (from 1) of the module at scope ``path`` under the init key ``root``."""
    digest = hashlib.sha1()
    for part in (*path, int(counter)):
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(digest.digest()[:4], byteorder="big"))


def xavier_uniform(key, shape) -> np.ndarray:
    """Flax's ``xavier_uniform()`` (f32): ``uniform(key, shape, -1, 1) *
    sqrt(3 * variance)``, variance ``1 / mean(fans)`` rounded to f32, the fans
    those of a kernel with its inputs on axis -2 and outputs on -1."""
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, np.float32, -1.0) * np.sqrt(np.float32(3) * variance)


def normal_init(key, shape, stddev: float = 0.02) -> np.ndarray:
    """Flax's ``normal(stddev)`` (f32)."""
    return normal(key, shape) * np.float32(stddev)
