"""HBM ledger: named device-memory allocation accounting.

The framework pins a handful of long-lived buffers in device memory —
async-serving slot tables (``io/aserve/slots.py``), bundle-prewarmed
executables, the binned-dataset fit cache, packed-tree predict
arguments. Each claim/release lands here under a stable ``site`` name
and exports as ``hbm_ledger_bytes{site}``, so "where did my HBM go"
has a first-class answer instead of a diff of the allocator's totals.

``reconcile()`` closes the loop against the device's own count: it
reads the
last-sampled ``device_memory_bytes{stat="bytes_in_use"}`` rows out of
the metrics registry (it deliberately does NOT sample the device
itself — a
gateway rendering ``/debug/roofline`` must never drag the framework
in) and surfaces claimed-vs-observed drift as
``hbm_ledger_drift_bytes``. Drift is expected to be positive (model
arrays, scratch, the runtime's own pools are unclaimed); a large
*negative* drift means a site forgot to release.

Stdlib-only (``obs-import-cycle``); mutators no-op while telemetry is
disabled.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from . import metrics as _metrics

__all__ = ["claim", "release", "set_claim", "claims", "total",
           "reconcile", "snapshot_payload", "reset"]

_lock = threading.Lock()
_claims: Dict[str, float] = {}


def _export(site: str, nbytes: float) -> None:
    _metrics.safe_gauge("hbm_ledger_bytes", site=site).set(nbytes)


def claim(site: str, nbytes: float) -> None:
    """Add ``nbytes`` to ``site``'s claimed total. No-op when disabled."""
    if not _metrics.enabled():
        return
    site = str(site)
    with _lock:
        _claims[site] = _claims.get(site, 0.0) + float(nbytes)
        now = _claims[site]
    _export(site, now)


def release(site: str, nbytes: float) -> None:
    """Subtract ``nbytes`` from ``site`` (floored at 0 — a double
    release must not corrupt the ledger). No-op when disabled."""
    if not _metrics.enabled():
        return
    site = str(site)
    with _lock:
        _claims[site] = max(0.0, _claims.get(site, 0.0) - float(nbytes))
        now = _claims[site]
    _export(site, now)


def set_claim(site: str, nbytes: float) -> None:
    """Overwrite ``site``'s claimed total (idempotent sites that
    re-derive their footprint each time). No-op when disabled."""
    if not _metrics.enabled():
        return
    site = str(site)
    with _lock:
        _claims[site] = max(0.0, float(nbytes))
        now = _claims[site]
    _export(site, now)


def claims() -> Dict[str, float]:
    with _lock:
        return dict(_claims)


def total() -> float:
    with _lock:
        return sum(_claims.values())


def _observed_bytes_in_use() -> Optional[float]:
    """Sum of the registry's last-sampled
    ``device_memory_bytes{stat="bytes_in_use"}`` across devices, or None
    when nothing sampled yet (device.py only writes once CUDA is up)."""
    try:
        snap = _metrics.get_registry().snapshot()
    except Exception:
        return None
    fam = snap.get("device_memory_bytes")
    if not fam:
        return None
    vals = [row.get("value") for row in fam.get("series", ())
            if row.get("labels", {}).get("stat") == "bytes_in_use"]
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return float(sum(vals))


def reconcile() -> Dict[str, Any]:
    """Claimed vs device-observed bytes; sets ``hbm_ledger_drift_bytes``
    (observed - claimed) when an observation exists."""
    claimed = total()
    observed = _observed_bytes_in_use()
    drift = None
    if observed is not None:
        drift = observed - claimed
        _metrics.safe_gauge("hbm_ledger_drift_bytes").set(drift)
    return {"claimed_bytes": claimed, "observed_bytes_in_use": observed,
            "drift_bytes": drift}


def snapshot_payload() -> Dict[str, Any]:
    """JSON-safe ledger view for ``/debug/roofline``."""
    return {"sites": claims(), **reconcile()}


def reset() -> None:
    with _lock:
        _claims.clear()
