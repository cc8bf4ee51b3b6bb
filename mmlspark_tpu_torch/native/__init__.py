"""The port's host C++ engines, loaded with ctypes.

``mmlspark_native.cpp`` (this directory) is built at first use by
:func:`...ops._build.build_host` into ``build/mmlspark_tpu_torch/`` with the
host C++ compiler. A missing compiler or a failed build raises: nothing
falls back to Python (the JAX package's loader returns None and parses in
Python instead; the port does not).

- ``csv_read_floats(text, ncols) -> float32[rows, ncols]``: numeric CSV,
  empty or unparseable fields NaN, ragged rows raise.
- ``treeshap_tree(...) -> float64[n, F] | None``: exact TreeSHAP for one
  tree; None when the engine rejects the tree (too deep, malformed), which
  the caller routes to its numpy engine.
- ``murmur3_32(data, seed) -> int`` and ``murmur3_batch(strings, seeds)
  -> uint32[n]``: MurmurHash3_x86_32, the feature identity of
  :mod:`..ops.murmur` (bit-equal to the JAX package's native hash).

``MMLSPARK_TPU_NATIVE_THREADS`` caps the worker pool (default: the host's
cores).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..ops import _build

NAME = "mmlspark_native"
# mm_abi_version of the source this loader binds
ABI_VERSION = 2
# every symbol _bind wires up: a library without one of them is refused
EXPECTED_SYMBOLS = ("mm_abi_version", "mm_csv_read_floats", "mm_treeshap",
                    "mm_murmur3_32", "mm_murmur3_batch")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The built and bound library (built once; raises if it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            lib = _build.load_host(NAME)
            missing = [s for s in EXPECTED_SYMBOLS if not hasattr(lib, s)]
            if missing:
                raise RuntimeError(f"{NAME}: library lacks {missing}")
            _bind(lib)
            if int(lib.mm_abi_version()) != ABI_VERSION:
                raise RuntimeError(
                    f"{NAME}: library ABI {lib.mm_abi_version()} != "
                    f"{ABI_VERSION}")
            _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.mm_abi_version.restype = ctypes.c_int64
    lib.mm_abi_version.argtypes = []
    lib.mm_csv_read_floats.restype = ctypes.c_int64
    lib.mm_csv_read_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.mm_treeshap.restype = ctypes.c_int64
    lib.mm_treeshap.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.mm_murmur3_32.restype = ctypes.c_uint32
    lib.mm_murmur3_32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_uint32]
    lib.mm_murmur3_batch.restype = None
    lib.mm_murmur3_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32)]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def csv_read_floats(text, ncols: int,
                    max_rows: Optional[int] = None) -> np.ndarray:
    """Parse numeric CSV text (str or bytes) -> ``float32[rows, ncols]``.
    Blank lines are skipped, fields trimmed; an empty or unparseable field
    is NaN; a row with another column count raises ``ValueError``."""
    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    if max_rows is None:
        max_rows = data.count(b"\n") + 1
    out = np.empty((max_rows, ncols), dtype=np.float32)
    n = get_lib().mm_csv_read_floats(data, len(data), ncols,
                                     _ptr(out, ctypes.c_float), max_rows)
    if n < 0:
        raise ValueError(f"CSV shape mismatch: expected {ncols} columns")
    return out[:n]


def treeshap_tree(feat: np.ndarray, left: np.ndarray, right: np.ndarray,
                  is_leaf: np.ndarray, cover: np.ndarray,
                  values: np.ndarray, go_left: np.ndarray,
                  n_features: int,
                  n_threads: int = 0) -> Optional[np.ndarray]:
    """Exact TreeSHAP for one tree, all instances: ``float64[n, F]``.

    ``go_left`` is the ``[M, n]`` routing matrix the caller computes (the
    split semantics stay in ``models/gbdt/treeshap.py``). Returns None when
    the engine rejects the tree (a child or feature index out of range, a
    cycle, or a depth past its arena budget); the caller then runs its
    numpy engine, which computes the same values. ``n_threads=0`` uses the
    pool's size."""
    lib = get_lib()
    feat = np.ascontiguousarray(feat, dtype=np.int32)
    left = np.ascontiguousarray(left, dtype=np.int32)
    right = np.ascontiguousarray(right, dtype=np.int32)
    is_leaf = np.ascontiguousarray(is_leaf, dtype=np.uint8)
    cover = np.ascontiguousarray(cover, dtype=np.float64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    go_left = np.ascontiguousarray(go_left, dtype=np.uint8)
    M, n = go_left.shape
    phi = np.zeros((n, int(n_features)), dtype=np.float64)
    rc = lib.mm_treeshap(
        _ptr(feat, ctypes.c_int32), _ptr(left, ctypes.c_int32),
        _ptr(right, ctypes.c_int32), _ptr(is_leaf, ctypes.c_uint8),
        _ptr(cover, ctypes.c_double), _ptr(values, ctypes.c_double),
        _ptr(go_left, ctypes.c_uint8), M, n, int(n_features),
        int(n_threads), _ptr(phi, ctypes.c_double))
    return None if rc != 0 else phi


def murmur3_32(data: bytes, seed: int) -> int:
    """MurmurHash3_x86_32 of ``data`` (bytes) with a uint32 ``seed``."""
    return int(get_lib().mm_murmur3_32(data, len(data), seed & 0xFFFFFFFF))


def murmur3_batch(strings, seeds) -> np.ndarray:
    """Hash n utf-8 strings with per-string seeds -> ``uint32[n]`` (large
    batches fan out over the worker pool)."""
    lib = get_lib()
    encoded = [s.encode("utf-8") if isinstance(s, str) else bytes(s)
               for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    seeds_arr = np.ascontiguousarray(
        np.asarray(seeds, dtype=np.int64) & 0xFFFFFFFF, dtype=np.uint32)
    if seeds_arr.shape != (len(encoded),):
        raise ValueError(f"{len(encoded)} strings but seeds of shape "
                         f"{seeds_arr.shape}")
    out = np.empty(len(encoded), dtype=np.uint32)
    lib.mm_murmur3_batch(buf, _ptr(offsets, ctypes.c_int64),
                         _ptr(seeds_arr, ctypes.c_uint32), len(encoded),
                         _ptr(out, ctypes.c_uint32))
    return out
