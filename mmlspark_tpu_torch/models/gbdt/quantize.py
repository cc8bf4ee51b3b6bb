"""The predict lanes: every quantize/dequantize of scoring in one place.

Counterpart of ``mmlspark_tpu/models/gbdt/quantize.py``. A lane is the
dtype rows and thresholds are compared in while a forest is scored:

  * ``f32``: raw f32 rows against raw f32 thresholds (the default);
  * ``bf16``: rows and thresholds narrowed to bfloat16 (half the upload
    bytes; a row within a bf16 ulp of a threshold may route the other
    way), leaves in f32;
  * ``int8``: rows quantized to their uint8 bin ids under the model's own
    bin boundaries (``#{upper_bounds < x}``, NaN -> bin 0: the binning of
    training), thresholds to the bin ids under the same strict compare, so
    ``x > thr`` and ``q(x) > q(thr)`` route identically; leaves stored as
    int8 per tree (symmetric, ``amax / 127``) and dequantized in f32. The
    leaf quantization is the lane's only difference from f32.

Both narrow lanes keep the per-class sum, the base score and the objective
transform in f32. ``MMLSPARK_TPU_PREDICT_DTYPE`` (the JAX package's name,
so a setting carries over) picks the lane when a call names none. Every
degrade to ``f32`` leaves one ``predict_dtype`` flight event per distinct
(requested, effective, reason), as the JAX package's does.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ...observability import flight as _flight

__all__ = [
    "PREDICT_DTYPES", "PREDICT_DTYPE_ENV", "resolve_predict_dtype",
    "staging_dtype", "feature_bounds", "quantize_features",
    "quantize_thresholds", "quantize_leaves", "dequantize_leaves",
    "cast_features_bf16", "cast_thresholds_bf16", "row_quantizer",
]

PREDICT_DTYPES = ("f32", "bf16", "int8")
PREDICT_DTYPE_ENV = "MMLSPARK_TPU_PREDICT_DTYPE"

# the dtype each lane stages feature rows in before they go to the device
_STAGING = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.uint8}

# one degrade flight event per distinct (requested, effective, reason):
# resolve runs on every predict call, the ring must not fill with repeats
_SEEN_DEGRADES: set = set()
_SEEN_LOCK = threading.Lock()


def _degrade(requested: str, effective: str, reason: str) -> str:
    key = (requested, effective, reason)
    with _SEEN_LOCK:
        fresh = key not in _SEEN_DEGRADES
        if fresh:
            _SEEN_DEGRADES.add(key)
    if fresh:
        _flight.record("predict_dtype", requested=requested,
                       effective=effective, reason=reason)
    return effective


def resolve_predict_dtype(requested: Optional[str] = None, *,
                          has_mdec: bool = False,
                          max_bin: int = 0) -> str:
    """The lane a scoring call runs in, one of :data:`PREDICT_DTYPES`.

    ``requested=None`` reads ``MMLSPARK_TPU_PREDICT_DTYPE`` (default
    ``f32``); an unknown value there degrades to ``f32`` (a setting must
    not stop scoring), an unknown explicit argument raises. Both narrow
    lanes degrade to ``f32`` for models that carry LightGBM's missing-value
    routing (``has_mdec``: NaN and zero tests need the raw values), and
    ``int8`` also without the model's bin grid (``0 < max_bin <= 256``).
    Each degrade records a ``predict_dtype`` flight event (reasons
    ``unknown_env_value``, ``imported_missing_semantics``,
    ``no_binner_grid``), once per distinct degrade.
    """
    if requested is None:
        env = os.environ.get(PREDICT_DTYPE_ENV, "") or "f32"
        if env not in PREDICT_DTYPES:
            return _degrade(env, "f32", "unknown_env_value")
        requested = env
    elif requested not in PREDICT_DTYPES:
        raise ValueError(
            f"predict_dtype must be one of {PREDICT_DTYPES}, "
            f"got {requested!r}")
    if requested == "f32":
        return "f32"
    if has_mdec:
        return _degrade(requested, "f32", "imported_missing_semantics")
    if requested == "int8" and not (0 < int(max_bin) <= 256):
        return _degrade(requested, "f32", "no_binner_grid")
    return requested


def staging_dtype(predict_dtype: str) -> torch.dtype:
    """The torch dtype a lane stages feature rows in for the upload."""
    return _STAGING[predict_dtype]


def feature_bounds(binner_state: dict) -> np.ndarray:
    """The int8 lane's grid: ``[F, max_bin - 1]`` f32 per-feature bin upper
    bounds (inf-padded), as the binner state holds them."""
    return np.asarray(binner_state["upper_bounds"], np.float32)


def quantize_features(X: np.ndarray, upper_bounds: np.ndarray) -> np.ndarray:
    """Raw f32 rows ``[n, F]`` -> uint8 bin ids: ``#{j : ub[f, j] < x}``,
    NaN -> 0, capped at 255 (one ``searchsorted`` per feature)."""
    X = np.asarray(X, np.float32)
    ub = np.asarray(upper_bounds, np.float32)
    out = np.empty(X.shape, np.uint8)
    for f in range(X.shape[1]):
        col = X[:, f]
        q = np.searchsorted(ub[f], col, side="left")
        np.minimum(q, 255, out=q)
        out[:, f] = np.where(np.isnan(col), 0, q)
    return out


def quantize_thresholds(thr: np.ndarray, feat: np.ndarray,
                        upper_bounds: np.ndarray) -> np.ndarray:
    """Split thresholds -> uint8 bin ids under each node's feature grid,
    by the strict compare of :func:`quantize_features`. A learned threshold
    is a bin's upper bound, so ``x > thr`` iff ``q(x) > q(thr)``. Leaf and
    padding slots get ids that no routing reads; a feature outside the
    grid keeps id 0."""
    thr = np.asarray(thr, np.float32)
    feat = np.asarray(feat)
    ub = np.asarray(upper_bounds, np.float32)
    q = np.zeros(thr.shape, np.int64)
    for f in range(ub.shape[0]):
        sel = feat == f
        if sel.any():
            q[sel] = np.searchsorted(ub[f], thr[sel], side="left")
    return np.minimum(q, 255).astype(np.uint8)


def quantize_leaves(leaf_value: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tree symmetric int8 leaves: ``(q [T, M] int8, scale [T] f32)``
    with ``leaf ~= q * scale[t]``, ``scale = amax(|leaf|) / 127`` (floored
    at 1e-30 so an all-zero tree stays exact). Per tree: late trees' leaves
    are orders of magnitude smaller than the first's, and one scale would
    flush them to 0."""
    lv = np.asarray(leaf_value, np.float32)
    amax = np.abs(lv).max(axis=1)
    scale = np.maximum(amax / 127.0, 1e-30).astype(np.float32)
    q = np.clip(np.rint(lv / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_leaves(qleaf: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """``[T, M]`` int8 leaves -> f32 ``q * scale[t]`` on their device."""
    return qleaf.to(torch.float32) * scale[:, None]


def cast_features_bf16(X) -> torch.Tensor:
    """Raw rows -> a host bfloat16 tensor (round to nearest even)."""
    return torch.as_tensor(np.asarray(X, np.float32)).to(torch.bfloat16)


def cast_thresholds_bf16(thr: np.ndarray) -> torch.Tensor:
    """Thresholds -> a host bfloat16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(thr, np.float32)).to(
        torch.bfloat16)


def row_quantizer(predict_dtype: str, upper_bounds: Optional[np.ndarray]):
    """The admission transform of one bound model: a callable taking an f32
    row (or row batch) to the lane's staged dtype, or None for ``f32``."""
    if predict_dtype == "int8":
        ub = np.asarray(upper_bounds, np.float32)

        def quantize_row(row):
            r = np.asarray(row, np.float32)
            q = quantize_features(r.reshape(1, -1) if r.ndim == 1 else r, ub)
            return q[0] if r.ndim == 1 else q

        return quantize_row
    if predict_dtype == "bf16":
        return cast_features_bf16
    return None
