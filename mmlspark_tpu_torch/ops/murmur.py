"""MurmurHash3 (x86, 32-bit): feature identity for the VW-style featurizer
and ``Featurize``'s hashed columns.

Counterpart of ``mmlspark_tpu/ops/murmur.py``. The reference exposes VW's
murmur hash to the JVM for featurization (reference:
vw/VowpalWabbitMurmurWithPrefix.scala, JNI class ``VowpalWabbitMurmur``).
Hashing defines feature identity, so the hashes here are bit-equal to the
JAX package's. They always come from the port's native host library
(``native/mmlspark_native.cpp``, built by :mod:`._build`); a failed build
raises. :func:`murmur3_32_plain` is the same algorithm in Python, kept for
the tests that hold the native hash to it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Union

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _native():
    from .. import native
    return native


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_32(data: Union[bytes, str], seed: int = 0) -> int:
    """MurmurHash3_x86_32 of ``data`` (a str is hashed as UTF-8) with
    ``seed``; returns uint32. Always the native library."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _native().murmur3_32(bytes(data), seed & _MASK)


def murmur3_batch(strings: Sequence[Union[str, bytes]],
                  seeds: Sequence[int]) -> np.ndarray:
    """Hash n strings with per-string seeds -> ``uint32[n]``."""
    return _native().murmur3_batch(strings, seeds)


def murmur3_32_plain(data: Union[bytes, str], seed: int = 0) -> int:
    """The same hash in Python, for tests only."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = len(data)
    h = seed & _MASK
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    k = 0
    tail = data[nblocks * 4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


@lru_cache(maxsize=1 << 20)
def hash_namespace(name: str, seed: int = 0) -> int:
    """VW namespace seed: murmur of the namespace string with ``seed``
    (VW's --hash_seed, default 0 — the reference's hashSeed param)."""
    return murmur3_32(name, seed)


@lru_cache(maxsize=1 << 20)
def hash_feature(name: str, namespace_hash: int) -> int:
    """VW feature hash: numeric names index directly (offset by the namespace
    seed), everything else is murmur-hashed with the namespace seed."""
    if name.isdigit():
        return (int(name) + namespace_hash) & _MASK
    return murmur3_32(name, namespace_hash)


def mask_bits(h: Union[int, np.ndarray], num_bits: int):
    return h & ((1 << num_bits) - 1)
