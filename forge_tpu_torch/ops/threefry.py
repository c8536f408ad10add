"""JAX's default PRNG, threefry2x32, in host numpy (uint32): `prng_key`,
`fold_in`, `random_bits`, `uniform` and `normal`, the values
`jax.random.PRNGKey`, `fold_in`, `bits`, `uniform` and `normal` give on
float32.

The stream is the one JAX draws with `jax_threefry_partitionable` on (its
default since JAX 0.5; JAX 0.9 in this repository's tests): the 32 bits of
the element at flat index i of an array are y0 ^ y1, where (y0, y1) is
threefry2x32 of the key over the counter pair (i >> 32, i & 0xFFFFFFFF). The
other mode lays its counters out differently and gives other values. The
bits depend on the array's shape only through the flat index, so a draw
made in one layout (the reference's NHWC) and transposed to another is not
a draw made in that other layout.

`uniform` takes the top 23 bits as the mantissa of a float in [1, 2) and
subtracts 1; `normal` is √2·erfinv(u) for u uniform on
[nextafter(−1, 0), 1), with the single-precision erfinv that XLA lowers
`jax.lax.erf_inv` to (Giles' two polynomials in w = −log1p(−x²), split at
w = 5). Host arithmetic is float32, with the multiply-adds XLA fuses
(`uniform`'s scaling, erfinv's Horner steps) computed in float64 and
rounded once, as a fused multiply-add rounds. log1p is numpy's, so `normal`
agrees with JAX's to float32 rounding (relative 1e-6), the bits and
`uniform` exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds over the counter words (x0, x1) → (y0, y1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: (0, seed mod 2³²)."""
    return 0, int(seed) & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)` for 0 ≤ data < 2³²."""
    if not 0 <= int(data) < 1 << 32:
        raise OverflowError(f"fold_in: {data} is out of bounds for uint32")
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, int(data), np.uint32))
    return int(y0[0]), int(y1[0])


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(key, shape)`: uint32 of `shape`."""
    n = int(np.prod(shape, dtype=np.int64))
    index = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (index >> np.uint64(32)).astype(np.uint32),
                          (index & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key: Tuple[int, int], shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c) -> np.ndarray:
    """a·b + c for float32 operands, rounded once to float32."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


# Giles' single-precision erfinv coefficients, highest degree first (XLA's ErfInv32)
_W_SMALL = np.asarray([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                       0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                       1.50140941], np.float32)
_W_LARGE = np.asarray([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                       0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                       2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: ±inf at ±1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):  # log1p(−1) = −inf at x = ±1, taken below
        w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _W_SMALL[0], _W_LARGE[0]).astype(np.float32)
    for c_small, c_large in zip(_W_SMALL[1:], _W_LARGE[1:]):
        p = _fma(p, w, np.where(small, c_small, c_large))
    with np.errstate(invalid="ignore"):
        edge, mid = x * np.float32(np.inf), p * x
    return np.where(np.abs(x) == np.float32(1.0), edge, mid).astype(np.float32)


def normal(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
