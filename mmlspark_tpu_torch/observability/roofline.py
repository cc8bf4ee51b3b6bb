"""Roofline ledger: achieved FLOP/s and bytes/s per hot executable.

Each executable registered here carries its FLOPs and bytes accessed
(the JAX package registers XLA ``cost_analysis()`` figures from its
predict and train caches; the port's producers come with its predict
plan). This module pairs that static cost with a *measured* per-call
wall time (bounded per-key EWMA + call count, fed by
a lightweight call-site timer) and renders each executable as a point on
the roofline: achieved FLOP/s and bytes/s against backend peaks.

Peaks come from a small per-device-kind table (the kind is
``torch.cuda.get_device_name()``), overridable via the
``MMLSPARK_TPU_PEAK_FLOPS`` / ``MMLSPARK_TPU_PEAK_BYTES_PER_SECOND``
registry knobs. An unknown backend degrades to ratios-only: achieved
rates are still reported, ``*_pct`` fields are ``None`` and the payload
carries an explicit ``peaks.source == "unknown"`` note, so a CPU CI leg
never fabricates a %-of-peak.

Stdlib-only by the ``obs-import-cycle`` contract; torch is touched
lazily (and only once it has initialised CUDA — the gateway-isolation
rule) to read the device kind. Every mutator is a no-op while telemetry is disabled,
keeping instrumented call sites byte-identical to their uninstrumented
behavior.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

from . import device as _device
from . import metrics as _metrics
from .env_registry import env_float

__all__ = ["note_device_kind", "resolve_peaks", "register_executable",
           "observe_call", "snapshot_payload", "reset"]

# the H100's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, f32 rate outside the tensor cores, int8 rate. chip_smoke.py
# computes its kernels' bounds from these same constants.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12

# (peak FLOP/s, peak device-memory bytes/s) per device kind, as
# ``torch.cuda.get_device_name()`` names the card; ratios, not
# guarantees. The forest traversal is f32 work, so the f32 rate is the
# FLOP peak. Unlisted kinds (the CPU, other cards) degrade to
# ratios-only.
_PEAK_TABLE: Dict[str, tuple] = {
    "NVIDIA H100 80GB HBM3": (PEAK_F32_OPS_PER_S, PEAK_BYTES_PER_S),
}

_PEAK_FLOPS_ENV = "MMLSPARK_TPU_PEAK_FLOPS"
_PEAK_BYTES_ENV = "MMLSPARK_TPU_PEAK_BYTES_PER_SECOND"

_EWMA_ALPHA = 0.2     # ~5-call memory: smooths jitter, tracks re-tuning
_MAX_ENTRIES = 128    # bounded ledger — LRU eviction past this

_lock = threading.Lock()
_entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_device_kind: Optional[str] = None


def _key_label(key_hash: str) -> str:
    """Short stable series label (full hash stays in the payload)."""
    return str(key_hash)[:12]


def note_device_kind(kind: Optional[str]) -> None:
    """Record the backend's device kind (callers that already hold a
    device pass its name in; last writer wins)."""
    global _device_kind
    if kind:
        _device_kind = str(kind)


def _maybe_device_kind() -> Optional[str]:
    """Best-effort device kind: recorded value, else the name of the
    current CUDA device — but only when this process has already
    initialised CUDA (a gateway or bare CLI must never create a device
    context just to render a debug page)."""
    if _device_kind is not None:
        return _device_kind
    if not _device.cuda_initialized():
        return None
    try:
        note_device_kind(sys.modules["torch"].cuda.get_device_name())
    except Exception:
        pass
    return _device_kind


def resolve_peaks() -> Dict[str, Any]:
    """Backend peaks: ``{"flops_per_second", "bytes_per_second",
    "source"}``. Env overrides win; then the per-device_kind table; an
    unrecognized backend yields ``None`` peaks with ``source:
    "unknown"`` (ratios-only degradation)."""
    env_flops = env_float(_PEAK_FLOPS_ENV, 0.0)
    env_bytes = env_float(_PEAK_BYTES_ENV, 0.0)
    if env_flops > 0 or env_bytes > 0:
        return {"flops_per_second": env_flops if env_flops > 0 else None,
                "bytes_per_second": env_bytes if env_bytes > 0 else None,
                "source": "env"}
    kind = _maybe_device_kind()
    if kind in _PEAK_TABLE:
        flops, byts = _PEAK_TABLE[kind]
        return {"flops_per_second": flops, "bytes_per_second": byts,
                "source": f"table:{kind}"}
    return {"flops_per_second": None, "bytes_per_second": None,
            "source": "unknown"}


def register_executable(key_hash: str, kind: str = "predict",
                        flops: Optional[float] = None,
                        bytes_accessed: Optional[float] = None,
                        compile_seconds: Optional[float] = None,
                        label: Optional[str] = None,
                        dtype: Optional[str] = None) -> None:
    """Add or refresh a ledger entry for a compiled executable.

    ``flops`` / ``bytes_accessed`` come from ``cost_analysis()`` (None
    when the backend exposes none — the entry still tracks wall time).
    ``dtype`` labels the executable's compute lane (the quantized
    predict lanes register as ``int8``/``bf16``, so the ledger shows the
    reduced ``bytes_accessed`` next to the lane that earned it).
    No-op while telemetry is disabled.
    """
    if not _metrics.enabled():
        return
    key_hash = str(key_hash)
    with _lock:
        entry = _entries.get(key_hash)
        if entry is None:
            entry = {"kind": kind, "label": label, "dtype": None,
                     "flops": None, "bytes_accessed": None,
                     "compile_seconds": None,
                     "calls": 0, "ewma_seconds": None}
            _entries[key_hash] = entry
            while len(_entries) > _MAX_ENTRIES:
                _entries.popitem(last=False)
        else:
            _entries.move_to_end(key_hash)
            entry["kind"] = kind
        if label is not None:
            entry["label"] = label
        if dtype is not None:
            entry["dtype"] = dtype
        if flops is not None:
            entry["flops"] = float(flops)
        if bytes_accessed is not None:
            entry["bytes_accessed"] = float(bytes_accessed)
        if compile_seconds is not None:
            entry["compile_seconds"] = float(compile_seconds)


def observe_call(key_hash: str, seconds: float) -> None:
    """Feed one measured call into the per-key EWMA and export the
    ``roofline_*`` families. Unregistered keys get a minimal entry (the
    cost arrives whenever the compile event fires). No-op while
    telemetry is disabled."""
    if not _metrics.enabled():
        return
    key_hash = str(key_hash)
    seconds = float(seconds)
    with _lock:
        entry = _entries.get(key_hash)
        if entry is None:
            entry = {"kind": "unknown", "label": None, "dtype": None,
                     "flops": None, "bytes_accessed": None,
                     "compile_seconds": None,
                     "calls": 0, "ewma_seconds": None}
            _entries[key_hash] = entry
            while len(_entries) > _MAX_ENTRIES:
                _entries.popitem(last=False)
        else:
            _entries.move_to_end(key_hash)
        entry["calls"] += 1
        prev = entry["ewma_seconds"]
        entry["ewma_seconds"] = (seconds if prev is None else
                                 _EWMA_ALPHA * seconds
                                 + (1.0 - _EWMA_ALPHA) * prev)
        ewma = entry["ewma_seconds"]
        flops = entry["flops"]
        byts = entry["bytes_accessed"]
    key = _key_label(key_hash)
    _metrics.safe_counter("roofline_calls_total", key=key).inc()
    _metrics.safe_gauge("roofline_call_seconds", key=key).set(ewma)
    peaks = resolve_peaks()
    if ewma and ewma > 0:
        if flops is not None and peaks["flops_per_second"]:
            _metrics.safe_gauge("roofline_flops_pct", key=key).set(
                100.0 * (flops / ewma) / peaks["flops_per_second"])
        if byts is not None and peaks["bytes_per_second"]:
            _metrics.safe_gauge("roofline_bytes_pct", key=key).set(
                100.0 * (byts / ewma) / peaks["bytes_per_second"])


def _render_entry(key_hash: str, entry: Dict[str, Any],
                  peaks: Dict[str, Any]) -> Dict[str, Any]:
    ewma = entry["ewma_seconds"]
    flops = entry["flops"]
    byts = entry["bytes_accessed"]
    achieved_f = (flops / ewma) if (flops is not None and ewma) else None
    achieved_b = (byts / ewma) if (byts is not None and ewma) else None
    pf, pb = peaks["flops_per_second"], peaks["bytes_per_second"]
    flops_pct = (100.0 * achieved_f / pf) if (achieved_f and pf) else None
    bytes_pct = (100.0 * achieved_b / pb) if (achieved_b and pb) else None
    bound = None
    if flops_pct is not None and bytes_pct is not None:
        bound = "compute" if flops_pct >= bytes_pct else "memory"
    return {"key": key_hash, "key_label": _key_label(key_hash),
            "kind": entry["kind"], "label": entry["label"],
            "dtype": entry.get("dtype"),
            "flops": flops, "bytes_accessed": byts,
            "compile_seconds": entry["compile_seconds"],
            "calls": entry["calls"], "ewma_seconds": ewma,
            "achieved_flops_per_second": achieved_f,
            "achieved_bytes_per_second": achieved_b,
            "flops_pct": flops_pct, "bytes_pct": bytes_pct,
            "bound": bound}


def snapshot_payload() -> Dict[str, Any]:
    """JSON-safe ledger view for ``/debug/roofline`` and the bench
    epilogue. Always renders (even disabled — the route stays truthful
    about an empty ledger)."""
    peaks = resolve_peaks()
    with _lock:
        items = [(k, dict(v)) for k, v in _entries.items()]
    return {"device_kind": _maybe_device_kind(),
            "peaks": peaks,
            "executables": [_render_entry(k, e, peaks)
                            for k, e in items]}


def reset() -> None:
    """Drop every entry and the recorded device kind (tests)."""
    global _device_kind
    with _lock:
        _entries.clear()
    _device_kind = None
