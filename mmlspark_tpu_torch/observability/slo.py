"""SLO plane: declarative per-endpoint objectives + error-budget burn.

The serving stack can measure everything (stage histograms, roofline
ledger, federation sweep) but none of it answers the production
question: *are we meeting our latency/error objectives, and how fast
are we spending the error budget when we miss?* This module holds the
answer's first half — objectives and burn rate; the second half (which
stage ate the tail) lives in :mod:`.tailsampler`.

Objectives are declared in the ``MMLSPARK_TPU_SLO`` registry knob with
a tiny grammar, one clause list per endpoint::

    MMLSPARK_TPU_SLO="predict:p99<25ms,err<0.1%;embed:p95<5ms"

``p<P><<T>ms|s`` reads "P percent of requests complete under T"; the
latency error budget is the allowed slow fraction ``1 - P/100``.
``err<C%`` caps the 5xx fraction at ``C%``. Both engines (and the
gateway, for its own hop) feed :func:`observe_request` from the same
per-request finally path that feeds ``serving_stage_seconds``, so the
SLO verdict and the stage decomposition describe the same requests.

Burn rate is Google-SRE multi-window: a fast 5-minute and a slow
1-hour window, each reporting ``bad_fraction / budget`` — ``1.0``
means the budget is being spent exactly as fast as it accrues;
sustained ``> 1.0`` on both windows means the objective will be
missed. Exported as ``slo_burn_rate{api, window}`` /
``slo_budget_remaining{api, window}`` gauges, which the gateway's
federation sweep scrapes and folds into ``cluster_autoscale_hint``
(user-visible pain scales the fleet, not just backlog).

Stdlib-only by the ``obs-import-cycle`` contract. Every mutator is a
no-op while telemetry is disabled, and the whole plane is one dict
probe per request when no SLO is configured — unconfigured processes
stay byte-identical to pre-SLO behavior.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

from . import flight as _flight
from . import metrics as _metrics
from . import tailsampler as _tailsampler

__all__ = ["SLO_ENV", "Objective", "parse_spec", "configure",
           "configured", "objectives", "observe_request", "refresh",
           "snapshot_payload", "reset"]

SLO_ENV = "MMLSPARK_TPU_SLO"

#: (window label, span seconds) — Google-SRE fast/slow burn pair
WINDOWS = (("fast5m", 300.0), ("slow1h", 3600.0))

#: ring-bucket width: coarse enough that an hour is 720 buckets, fine
#: enough that the 5m window loses at most one bucket of resolution
_BUCKET_SECONDS = 5.0

#: gauge recompute throttle — the window sums are O(buckets) and must
#: not run per request on the 100k-RPS async path (snapshot_payload and
#: refresh() always recompute, so debug pages and tests stay exact)
_EXPORT_INTERVAL = 0.5

_CLAUSE_LAT_RE = re.compile(
    r"^p(?P<pct>\d+(?:\.\d+)?)<(?P<val>\d+(?:\.\d+)?)(?P<unit>ms|s)$")
_CLAUSE_ERR_RE = re.compile(r"^err<(?P<val>\d+(?:\.\d+)?)(?P<pct>%?)$")


@dataclass(frozen=True)
class Objective:
    """One endpoint's declared objective (parsed, normalized to
    seconds / fractions)."""

    api: str
    #: target percentile for the latency clause (e.g. 99.0), None when
    #: only an error clause is declared
    percentile: Optional[float] = None
    #: latency threshold in seconds the percentile is held against
    threshold_seconds: Optional[float] = None
    #: allowed 5xx fraction (0.001 == 0.1%), None when not declared
    error_ceiling: Optional[float] = None

    @property
    def latency_budget(self) -> Optional[float]:
        """Allowed slow fraction: ``1 - percentile/100``."""
        if self.percentile is None:
            return None
        return max(1.0 - self.percentile / 100.0, 1e-9)


def parse_spec(spec: str) -> Dict[str, Objective]:
    """Parse the ``MMLSPARK_TPU_SLO`` grammar into per-api objectives.

    Raises :class:`ValueError` on any malformed entry — the env path
    catches and degrades (an operator hint must not kill a worker at
    boot), explicit :func:`configure` callers fail loudly.
    """
    out: Dict[str, Objective] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        api, sep, clauses = entry.partition(":")
        api = api.strip()
        if not sep or not api:
            raise ValueError(f"SLO entry {entry!r}: expected "
                             "'<endpoint>:<clause>[,<clause>...]'")
        if api in out:
            raise ValueError(f"SLO endpoint {api!r} declared twice")
        pct = thr = ceil = None
        for clause in clauses.split(","):
            clause = clause.strip().lower().replace(" ", "")
            if not clause:
                continue
            m = _CLAUSE_LAT_RE.match(clause)
            if m:
                if thr is not None:
                    raise ValueError(f"SLO entry {entry!r}: two latency "
                                     "clauses")
                pct = float(m.group("pct"))
                if not 0.0 < pct <= 100.0:
                    raise ValueError(f"SLO entry {entry!r}: percentile "
                                     f"{pct} outside (0, 100]")
                thr = float(m.group("val"))
                if m.group("unit") == "ms":
                    thr /= 1e3
                continue
            m = _CLAUSE_ERR_RE.match(clause)
            if m:
                if ceil is not None:
                    raise ValueError(f"SLO entry {entry!r}: two error "
                                     "clauses")
                ceil = float(m.group("val"))
                if m.group("pct"):
                    ceil /= 100.0
                if not 0.0 < ceil <= 1.0:
                    raise ValueError(f"SLO entry {entry!r}: error ceiling "
                                     "outside (0%, 100%]")
                continue
            raise ValueError(f"SLO clause {clause!r} (in {entry!r}): "
                             "expected 'p<P><<T>ms' or 'err<C%'")
        if thr is None and ceil is None:
            raise ValueError(f"SLO entry {entry!r}: no clauses")
        out[api] = Objective(api=api, percentile=pct,
                             threshold_seconds=thr, error_ceiling=ceil)
    return out


# -- module state -----------------------------------------------------------

_lock = threading.Lock()
_spec: Optional[str] = None
_objectives: Dict[str, Objective] = {}
_env_loaded = False
#: per-api deque of [bucket_start_monotonic, total, slow, errors]
_rings: Dict[str, Deque[List[float]]] = {}
_last_export: Dict[str, float] = {}


def _ensure_env() -> None:
    """Lazily adopt the env spec (once per process / per reset)."""
    global _env_loaded, _spec, _objectives
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        raw = os.environ.get(SLO_ENV, "").strip()
        if raw:
            try:
                _objectives = parse_spec(raw)
                _spec = raw
            except ValueError as e:
                # degrade, don't die: a typo'd objective leaves the
                # process unconfigured with a flight breadcrumb
                _flight.record("slo_config", decision="rejected",
                               spec=raw, error=str(e))
        _env_loaded = True


def configure(spec: Optional[str]) -> Dict[str, Objective]:
    """Install objectives programmatically (tests, embedding apps).
    ``None``/empty clears. Malformed specs raise."""
    global _env_loaded, _spec, _objectives
    parsed = parse_spec(spec) if spec else {}
    with _lock:
        _objectives = parsed
        _spec = spec if parsed else None
        _env_loaded = True
        _rings.clear()
        _last_export.clear()
    return dict(parsed)


def configured() -> bool:
    _ensure_env()
    return bool(_objectives)


def objectives() -> Dict[str, Objective]:
    _ensure_env()
    return dict(_objectives)


def _ring(api: str) -> Deque[List[float]]:
    ring = _rings.get(api)
    if ring is None:
        ring = _rings[api] = deque()
    return ring


def _record_locked(api: str, now: float, slow: bool, error: bool) -> None:
    ring = _ring(api)
    bucket = now - (now % _BUCKET_SECONDS)
    if not ring or ring[-1][0] != bucket:
        ring.append([bucket, 0.0, 0.0, 0.0])
    ring[-1][1] += 1.0
    if slow:
        ring[-1][2] += 1.0
    if error:
        ring[-1][3] += 1.0
    horizon = now - WINDOWS[-1][1] - _BUCKET_SECONDS
    while ring and ring[0][0] < horizon:
        ring.popleft()


def _window_counts_locked(api: str, now: float,
                          span: float) -> Dict[str, float]:
    total = slow = errors = 0.0
    cutoff = now - span
    for bucket, t, s, e in _rings.get(api, ()):
        if bucket + _BUCKET_SECONDS <= cutoff:
            continue
        total += t
        slow += s
        errors += e
    return {"requests": total, "slow": slow, "errors": errors}


def _window_verdict(obj: Objective,
                    counts: Dict[str, float]) -> Dict[str, Any]:
    """Burn rates for one window: ``bad_fraction / budget`` per signal,
    the window's burn is the hotter of the two."""
    total = counts["requests"]
    lat_burn = err_burn = None
    if total > 0:
        if obj.latency_budget is not None:
            lat_burn = (counts["slow"] / total) / obj.latency_budget
        if obj.error_ceiling is not None:
            err_burn = (counts["errors"] / total) / obj.error_ceiling
    candidates = [b for b in (lat_burn, err_burn) if b is not None]
    burn = max(candidates) if candidates else 0.0
    return {**counts, "latency_burn": lat_burn, "error_burn": err_burn,
            "burn_rate": burn,
            "budget_remaining": max(0.0, 1.0 - burn)}


def _export_locked(api: str, now: float) -> Dict[str, Dict[str, Any]]:
    """Recompute every window for one api and set the gauges."""
    obj = _objectives[api]
    out: Dict[str, Dict[str, Any]] = {}
    for window, span in WINDOWS:
        verdict = _window_verdict(
            obj, _window_counts_locked(api, now, span))
        out[window] = verdict
        _metrics.safe_gauge("slo_burn_rate", api=api,
                            window=window).set(verdict["burn_rate"])
        _metrics.safe_gauge("slo_budget_remaining", api=api,
                            window=window).set(
                                verdict["budget_remaining"])
    _last_export[api] = now
    return out


def observe_request(api: str, seconds: float, status: int,
                    stages: Optional[Dict[str, float]] = None,
                    trace_id: Optional[str] = None,
                    hop: str = "worker") -> None:
    """Feed one completed request into the burn windows (and, when it
    breaches its objective, into the tail sampler's reservoir).

    The per-request finally path of both engines and the gateway calls
    this unconditionally; with no SLO configured it is one dict probe.
    """
    _ensure_env()
    if not _objectives:
        return
    if not _metrics.enabled():
        return
    obj = _objectives.get(api)
    if obj is None:
        return
    seconds = float(seconds)
    slow = (obj.threshold_seconds is not None
            and seconds > obj.threshold_seconds)
    error = int(status) >= 500
    breach = slow or (error and obj.error_ceiling is not None)
    now = time.monotonic()
    with _lock:
        _record_locked(api, now, slow, error)
        if now - _last_export.get(api, 0.0) >= _EXPORT_INTERVAL:
            _export_locked(api, now)
    if breach:
        signal = "latency" if slow else "error"
        _metrics.safe_counter("slo_breach_total", api=api,
                              signal=signal).inc()
        _tailsampler.sample(api, seconds, status, stages=stages,
                            trace_id=trace_id, hop=hop,
                            breach=signal)


def current_burn(api: str, window: str = "fast5m") -> float:
    """Live burn rate for one endpoint's window — 0.0 when no SLO is
    configured for it (an unconfigured endpoint cannot be "breaching").

    Computed from the ring directly, not read back from gauges: the
    dispatch-pacing override in ``io/aserve`` checks this per dispatch
    and must see a breach the moment it starts, not after the export
    throttle. Cost is one bounded ring scan under the lock.
    """
    _ensure_env()
    obj = _objectives.get(api)
    if obj is None:
        return 0.0
    span = dict(WINDOWS).get(window)
    if span is None:
        raise ValueError(f"unknown SLO window {window!r} "
                         f"(have {[w for w, _ in WINDOWS]})")
    now = time.monotonic()
    with _lock:
        verdict = _window_verdict(obj, _window_counts_locked(api, now, span))
    return float(verdict["burn_rate"])


def refresh() -> None:
    """Force a gauge recompute for every configured api (tests and the
    federation-facing callers that must not wait out the throttle)."""
    _ensure_env()
    if not _objectives or not _metrics.enabled():
        return
    now = time.monotonic()
    with _lock:
        for api in _objectives:
            _export_locked(api, now)


def _objective_view(obj: Objective) -> Dict[str, Any]:
    return {"percentile": obj.percentile,
            "threshold_ms": (None if obj.threshold_seconds is None
                             else obj.threshold_seconds * 1e3),
            "error_ceiling_pct": (None if obj.error_ceiling is None
                                  else obj.error_ceiling * 100.0),
            "latency_budget": obj.latency_budget}


def snapshot_payload() -> Dict[str, Any]:
    """``/debug/slo`` body: objectives, per-window burn, and a breach
    verdict per endpoint. Always recomputes (and re-exports the gauges)
    so the page and ``/metrics`` agree."""
    _ensure_env()
    now = time.monotonic()
    endpoints: Dict[str, Any] = {}
    with _lock:
        for api, obj in _objectives.items():
            windows = ({w: _window_verdict(
                            obj, _window_counts_locked(api, now, s))
                        for w, s in WINDOWS}
                       if not _metrics.enabled()
                       else _export_locked(api, now))
            endpoints[api] = {
                "objective": _objective_view(obj),
                "windows": windows,
                # breaching NOW means the fast window burns budget
                # faster than it accrues
                "breaching": windows[WINDOWS[0][0]]["burn_rate"] > 1.0,
            }
    return {"configured": bool(endpoints), "spec": _spec,
            "windows": {w: s for w, s in WINDOWS},
            "endpoints": endpoints,
            "note": ("burn_rate = bad_fraction / error_budget per "
                     "window; sustained > 1.0 on both windows means "
                     "the objective will be missed" if endpoints else
                     "no SLO configured — set MMLSPARK_TPU_SLO, e.g. "
                     "'predict:p99<25ms,err<0.1%'")}


def reset() -> None:
    """Drop objectives, windows, and the cached env read (tests)."""
    global _env_loaded, _spec, _objectives
    with _lock:
        _objectives = {}
        _spec = None
        _env_loaded = False
        _rings.clear()
        _last_export.clear()
