"""Per-request tail sampler: stage timelines for objective breaches.

The burn-rate plane (:mod:`.slo`) says *that* an objective is being
missed; this module answers *where the tail went*. Every request that
breaches its endpoint's objective deposits its complete stage timeline
(``admission -> forming_wait -> score -> write``, the shared
``stage_breakdown`` vocabulary both engines stamp) plus its trace id
into a bounded reservoir — the gateway hop deposits its own record
under the same trace id, so a federated read stitches the edge->worker
path via the existing traceparent propagation.

Served at ``/debug/tail`` through the shared ``debug_body`` funnel and
rendered offline by ``tools/tail_report.py`` as a p99-attribution
breakdown ("tail is 72% forming_wait -> raise slots / add worker" vs
"tail is score -> see /debug/roofline").

The reservoir keeps the most recent ``MMLSPARK_TPU_TAIL_SAMPLES``
breaches (default 128) and counts what it evicts — a sustained breach
storm reports its true volume, not just the survivors. Stdlib-only
(``obs-import-cycle``); mutators are no-ops while telemetry is
disabled.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

from . import metrics as _metrics
from .env_registry import env_int

__all__ = ["TAIL_SAMPLES_ENV", "sample", "attribution",
           "snapshot_payload", "reset"]

TAIL_SAMPLES_ENV = "MMLSPARK_TPU_TAIL_SAMPLES"
_DEFAULT_CAPACITY = 128

_lock = threading.Lock()
_samples: Deque[Dict[str, Any]] = deque()
_capacity: Optional[int] = None
_sampled_total = 0
_dropped_total = 0


def _cap_locked() -> int:
    global _capacity
    if _capacity is None:
        _capacity = max(1, env_int(TAIL_SAMPLES_ENV, _DEFAULT_CAPACITY))
    return _capacity


def sample(api: str, seconds: float, status: int,
           stages: Optional[Dict[str, float]] = None,
           trace_id: Optional[str] = None, hop: str = "worker",
           breach: str = "latency") -> None:
    """Deposit one breaching request's timeline. ``stages`` is the
    ``stage_breakdown`` dict (None for requests that never scored —
    shed/timeout paths still sample, attributed to their status)."""
    global _sampled_total, _dropped_total
    if not _metrics.enabled():
        return
    seconds = float(seconds)
    dominant = None
    stage_sum = None
    if stages:
        stage_sum = sum(stages.values())
        dominant = max(stages, key=lambda s: stages[s])
    record = {"ts": time.time(), "api": api, "hop": hop,
              "seconds": seconds, "status": int(status),
              "breach": breach, "trace_id": trace_id,
              "stages": dict(stages) if stages else None,
              "stage_sum_seconds": stage_sum,
              "dominant_stage": dominant}
    with _lock:
        cap = _cap_locked()
        while len(_samples) >= cap:
            _samples.popleft()
            _dropped_total += 1
        _samples.append(record)
        _sampled_total += 1
    _metrics.safe_counter("tail_samples_total", api=api,
                          breach=breach).inc()


def attribution() -> Dict[str, Any]:
    """Aggregate stage attribution across the reservoir: per-stage
    share of the sampled tail seconds plus the dominant stage — the
    summary ``tools/tail_report.py`` renders remediation hints from."""
    with _lock:
        records = list(_samples)
    totals: Dict[str, float] = {}
    timed = 0
    for r in records:
        if not r["stages"]:
            continue
        timed += 1
        for stage, s in r["stages"].items():
            totals[stage] = totals.get(stage, 0.0) + s
    grand = sum(totals.values())
    shares = {stage: (100.0 * s / grand if grand else 0.0)
              for stage, s in totals.items()}
    dominant = max(shares, key=lambda s: shares[s]) if shares else None
    return {"samples": len(records), "samples_with_stages": timed,
            "stage_seconds": totals, "stage_share_pct": shares,
            "dominant_stage": dominant}


def snapshot_payload() -> Dict[str, Any]:
    """``/debug/tail`` body: reservoir stats, the aggregate
    attribution, and the sampled timelines (most recent last). Always
    renders — a disabled or breach-free process reports an honest
    empty reservoir."""
    with _lock:
        records = list(_samples)
        cap = _cap_locked()
        sampled, dropped = _sampled_total, _dropped_total
    return {"capacity": cap, "sampled_total": sampled,
            "dropped_total": dropped,
            "attribution": attribution(),
            "samples": records}


def reset() -> None:
    """Drop the reservoir and the cached capacity read (tests)."""
    global _sampled_total, _dropped_total, _capacity
    with _lock:
        _samples.clear()
        _sampled_total = 0
        _dropped_total = 0
        _capacity = None
