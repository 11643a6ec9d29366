"""Bit-exact threefry2x32 ``PRNGKey`` / ``fold_in`` / ``randint`` in numpy.

The engine seeds every request's entry points from
``randint(fold_in(PRNGKey(seed), rid & 0x7FFFFFFF), (E,), lo, hi)``, so a
result id can only match the JAX package if these bits do. This module
reproduces ``jax.random`` under ``jax_threefry_partitionable=True`` (the
default of current JAX):

  · a key is two uint32 words; ``PRNGKey(s)`` = (s >> 32, s & 0xFFFFFFFF)
  · ``fold_in(k, x)`` = threefry2x32(k, (0, x))
  · ``split(k)[i]`` = threefry2x32(k, (0, i)) — the counter is the 64-bit
    index split into (hi, lo) words
  · 32-bit ``random_bits(k, (E,))[i]`` = xor of the two output words of
    threefry2x32(k, (0, i))
  · ``randint`` draws two such streams from ``split(k)`` and combines them
    modulo the span: ((hi % s)·(2^32 % s) + lo % s) % s in wrapping uint32
    arithmetic (jax/_src/random.py ``_randint``).

Everything is vectorised over a leading batch of keys (one per admitted
request). Arithmetic is numpy ``uint32``, which wraps mod 2^32 as the
threefry spec requires.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block function on broadcast uint32
    arrays: key words (k1, k2), counter words (x1, x2). Returns the two
    output words."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                           for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + ks[0]
    y0 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + y0
            y0 = _rotl(y0, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        y0 = y0 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, y0


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32): (2,) uint32."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in`` for one key (2,) and a batch of uint32
    ``data`` (B,). Returns (B, 2) uint32 keys."""
    data = np.asarray(data, np.uint32)
    a, b = threefry2x32(key[0], key[1], np.zeros_like(data), data)
    return np.stack([a, b], axis=-1)


def _split2(keys: np.ndarray):
    """``jax.random.split(k)`` for a batch of keys (B, 2): two (B, 2)."""
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    a, b = threefry2x32(k1, k2, np.zeros((1, 2), np.uint32),
                        np.arange(2, dtype=np.uint32)[None])
    return (np.stack([a[:, 0], b[:, 0]], axis=-1),
            np.stack([a[:, 1], b[:, 1]], axis=-1))


def _random_bits32(keys: np.ndarray, n: int) -> np.ndarray:
    a, b = threefry2x32(keys[:, 0:1], keys[:, 1:2], np.zeros((1, n), np.uint32),
                        np.arange(n, dtype=np.uint32)[None])
    return a ^ b


def randint(keys: np.ndarray, n: int, lo, hi) -> np.ndarray:
    """``jax.random.randint(key, (n,), lo, hi)`` (int32) for a batch of
    keys (B, 2) with per-key bounds ``lo``/``hi`` (B,). Returns (B, n)
    int32. As in JAX, ``hi <= lo`` returns ``lo``."""
    keys = np.asarray(keys, np.uint32)
    lo = np.asarray(lo, np.int64).reshape(-1, 1)
    hi = np.asarray(hi, np.int64).reshape(-1, 1)
    if lo.min(initial=0) < -(1 << 31) or hi.max(initial=0) >= 1 << 31:
        raise ValueError("randint bounds must fit in int32")
    k_hi, k_lo = _split2(keys)
    higher = _random_bits32(k_hi, n)
    lower = _random_bits32(k_lo, n)
    span = np.where(hi <= lo, 1, hi - lo).astype(np.uint32)
    mult = (np.uint32(1 << 16) % span).astype(np.uint32)
    mult = (mult * mult) % span
    offset = ((higher % span) * mult + lower % span) % span
    return (lo + offset.astype(np.int64)).astype(np.int32)
