"""The JAX package's random dimension subsets, drawn on the host with numpy.

The embed family clusters on random subsets of the feature dimensions
(``models/pointgroup3heads.py:_subset_masks`` of the JAX package). There the
subsets are drawn with ``jax.random`` under its default generator,
``threefry2x32`` with ``jax_threefry_partitionable = True``. This module
repeats those draws bit for bit: the Threefry-2x32 hash (20 rounds, key
schedule ``k0 ^ k1 ^ 0x1BD11BDA``), ``PRNGKey``, ``fold_in``, ``split`` and
``random_bits`` in their partitionable forms, ``uniform`` (the 23 mantissa
bits under exponent 0, minus 1) and ``randint`` (two 32-bit draws combined
modulo the span). The counters are host integers, so a draw costs the
device nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``
    ([2] uint32): two uint32 arrays of the counters' shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^32: [0, seed]."""
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return np.array([0, int(seed)], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter (0, data mod 2^32)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) % 2**32], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): key i is the hash of (0, i)."""
    b0, b1 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32-bit ``random_bits`` (partitionable): element i (row-major) is the
    XOR of the two words of the hash of (i >> 32, i mod 2^32)."""
    n = int(np.prod(shape)) if len(shape) else 1
    i = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32, on [0, 1)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key: np.ndarray, low: int, high: int) -> int:
    """``jax.random.randint(key, (), low, high)`` for int32 bounds with
    low < high."""
    k1, k2 = split(key)
    hi, lo = int(random_bits(k1, ())), int(random_bits(k2, ()))
    span = high - low
    m32 = 2**32 - 1  # the products and the sum wrap in uint32, as JAX's do
    mult = ((2**16 % span) ** 2 & m32) % span
    return low + ((((hi % span) * mult & m32) + lo % span) & m32) % span


def subset_mask_rows(key: np.ndarray, pool: np.ndarray, d: int, runs: int, low: int,
                     high: int, tag: int) -> np.ndarray:
    """One sample's masks of a strategy op ([runs, d] float32), as the JAX
    package's ``_subset_masks`` draws them from the sample's key: run i
    folds in ``tag * 131 + i``, splits, draws a uniform per dimension (-1
    outside ``pool``) and a size k in [low, high] (at most ``len(pool)``),
    and keeps the k pool dimensions of largest noise (ties to the lower
    dimension, a stable sort)."""
    in_pool = np.zeros(d, bool)
    in_pool[pool] = True
    out = np.zeros((runs, d), np.float32)
    for i in range(runs):
        ku, kk = split(fold_in(key, tag * 131 + i))
        noise = np.where(in_pool, uniform(ku, (d,)), np.float32(-1.0))
        k = min(randint(kk, low, high + 1), len(pool))
        order = np.argsort(-noise, kind="stable")
        rank = np.empty(d, np.int64)
        rank[order] = np.arange(d)
        out[i] = (rank < k) & in_pool
    return out
