"""The few draws of JAX's default PRNG that the port needs, in numpy.

The FVD harness's ``tiny`` extractor uses fixed random weights that JAX
draws from ``jax.random.PRNGKey(42)`` (``utils/fvd.py:_tiny_forward``).
The port imports no JAX, so it replays those draws here:

- ``threefry_2x32``: the Threefry-2x32 hash (20 rounds), as
  ``jax._src.prng._threefry2x32_lowering``;
- ``prng_key``: ``PRNGKey(seed)`` of a 32-bit seed, the key words
  ``[0, seed]``;
- ``split``: ``jax.random.split`` with ``jax_threefry_partitionable`` on
  (JAX's default): the counters ``0 .. n-1`` as (hi, lo) words hashed
  under the key;
- ``random_bits``: 32-bit ``jax.random.bits``, ``bits1 ^ bits2`` of the
  hashed counters of the flat index;
- ``normal``: ``jax.random.normal`` in f32, ``sqrt(2) * erfinv(u)`` with u
  uniform in (-1, 1) made from the bits, erfinv as XLA's f32 polynomial
  (M. Giles, "Approximating the erfinv function").

The bits equal JAX's bitwise. The normals agree within 2 f32 ulps: the
polynomial's steps are fused multiply-adds, as XLA compiles them, but
numpy's log1p is not XLA's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` (two
    uint32 words); uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key words, for 0 <= seed < 2^32."""
    return np.array([0, seed], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry_2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32)."""
    b0, b1 = threefry_2x32(key, *_counters(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv: a degree-8 polynomial in w = -log1p(-x^2) (less
    than 5: w - 2.5; else sqrt(w) - 3), times x; +-1 gives +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        w64 = w.astype(np.float64)
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            # a fused multiply-add (XLA fuses Horner's steps): the product
            # is exact in float64, so one rounding to f32 remains
            c = np.where(lt, a, b).astype(np.float32).astype(np.float64)
            p = (c + p.astype(np.float64) * w64).astype(np.float32)
        out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
