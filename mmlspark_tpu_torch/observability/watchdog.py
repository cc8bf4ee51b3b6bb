"""Active watchdog: stall detection for hot loops + training health.

Everything before this module is *passive* — metrics, spans, traces and
the flight ring record what happened, but nothing watches the process. A
hung batch thread, a stuck collective, or a diverging fit produces
silence until a client times out. MLPerf-scale TPU work fails via stalls
and skew, not crashes (Kumar et al., "Scale MLPerf-0.6 models on Google
TPU-v3 Pods"), so the watchdog is the piece that notices:

- **Heartbeats.** Hot loops (:mod:`..io.serving`'s batch thread, the
  streaming prefetcher, the GBDT round loop, distributed barriers)
  :func:`register` a named heartbeat and ``beat()`` once per iteration —
  one monotonic-clock store, nothing else. A daemon sampler thread
  checks ages every ``MMLSPARK_TPU_WATCHDOG_INTERVAL_SECONDS``; a
  heartbeat older than ``MMLSPARK_TPU_WATCHDOG_STALL_SECONDS`` (default
  30) is a stall: the watchdog dumps ALL thread stacks + the flight ring
  to ``MMLSPARK_TPU_FLIGHT_DIR``, records a ``watchdog_stall`` flight
  event carrying the stalled site and the stacks, logs through the
  funnel, and bumps ``watchdog_stalls_total{site=...}`` — exactly once
  per stall episode (it re-arms when the heartbeat resumes).
- **Training-health sentinels.** :func:`report_training_metric` feeds
  per-round losses/durations from the GBDT loop (and
  :func:`scan_eval_history` audits a finished fit, covering the fused
  single-dispatch paths that have no rounds): NaN/Inf loss, loss
  divergence over a window, and per-round throughput collapse each emit
  a flight event, bump ``training_health_events_total{model,kind}``, and
  drop the ``training_health{model}`` gauge to 0.

Kill-switch contract: :func:`register` returns a no-op handle and
:func:`report_training_metric` returns immediately while telemetry is
disabled — no sampler thread is ever started, hot paths keep
byte-identical behavior. The sampler starts lazily on the first real
registration and is shared process-wide.
"""

from __future__ import annotations

import math
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from . import device as _device
from . import flight as _flight
from . import metrics as _metrics
from .env_registry import env_float as _env_float

__all__ = [
    "Heartbeat", "register", "heartbeats", "stop", "running",
    "get_stall_seconds", "set_stall_seconds",
    "get_interval_seconds", "set_interval_seconds",
    "dump_all_stacks", "report_training_metric", "scan_eval_history",
    "training_healthy", "reset_training_health", "stall_counts",
    "add_event_callback",
]

_STALL_ENV = "MMLSPARK_TPU_WATCHDOG_STALL_SECONDS"
_INTERVAL_ENV = "MMLSPARK_TPU_WATCHDOG_INTERVAL_SECONDS"
_WINDOW_ENV = "MMLSPARK_TPU_WATCHDOG_LOSS_WINDOW"

#: loss must exceed window-min by this factor to count as divergence
DIVERGENCE_FACTOR = 2.0
#: a round slower than median-of-window by this factor is a collapse
COLLAPSE_FACTOR = 5.0


_stall_seconds = max(0.01, _env_float(_STALL_ENV, 30.0))
_interval_seconds = _env_float(_INTERVAL_ENV, 0.0)  # 0 -> derived

_lock = threading.Lock()
_hearts: Dict[int, "Heartbeat"] = {}
_next_id = 0
_thread: Optional[threading.Thread] = None
_stop_evt = threading.Event()
_stall_log: List[Dict[str, Any]] = []          # recent stalls (bounded)
#: subscribers to watchdog events: cb(category, name, fields) fired on
#: every stall episode (category "stall", name = heartbeat site) and
#: every training-health event (category = event kind, name = model) —
#: the hook training loops use to dump a last-good checkpoint when the
#: watchdog declares the fit sick (see models/gbdt/booster.py)
_event_callbacks: List[Any] = []


def add_event_callback(cb) -> Any:
    """Subscribe ``cb(category, name, fields)`` to stall/health events;
    returns a zero-arg unsubscribe. Callbacks run on the emitting thread
    (the sampler for stalls, the training loop for sentinels) and must
    never raise — exceptions are swallowed."""
    with _lock:
        _event_callbacks.append(cb)

    def _remove() -> None:
        with _lock:
            try:
                _event_callbacks.remove(cb)
            except ValueError:
                pass
    return _remove


def _emit_event(category: str, name: str, **fields: Any) -> None:
    with _lock:
        cbs = list(_event_callbacks)
    for cb in cbs:
        try:
            cb(category, name, fields)
        except Exception:  # noqa: BLE001 — a sick callback must not
            pass           # break the watchdog or the training loop


def get_stall_seconds() -> float:
    return _stall_seconds


def set_stall_seconds(seconds: float) -> float:
    """Set the stall threshold; returns the previous value (env default:
    ``MMLSPARK_TPU_WATCHDOG_STALL_SECONDS``)."""
    global _stall_seconds
    prev, _stall_seconds = _stall_seconds, max(0.01, float(seconds))
    return prev


def get_interval_seconds() -> float:
    """Effective sampling period: explicit setting/env, else a quarter of
    the stall threshold clamped to [0.05 s, 5 s]."""
    if _interval_seconds > 0:
        return _interval_seconds
    return min(5.0, max(0.05, _stall_seconds / 4.0))


def set_interval_seconds(seconds: float) -> float:
    global _interval_seconds
    prev = _interval_seconds
    _interval_seconds = max(0.0, float(seconds))
    return prev


class Heartbeat:
    """One registered hot loop. ``beat()`` is the entire per-iteration
    cost: a monotonic read and an attribute store."""

    __slots__ = ("site", "hb_id", "created", "last", "beats", "thread",
                 "stall_seconds", "_stalled", "_closed")

    def __init__(self, site: str, hb_id: int,
                 stall_seconds: Optional[float] = None):
        self.site = site
        self.hb_id = hb_id
        self.created = self.last = time.monotonic()
        self.beats = 0
        self.thread = threading.current_thread()
        #: per-site override of the global threshold (None = global) —
        #: coarse single-beat scopes (a whole inner fit) use a generous
        #: bound, per-iteration loops keep the tight default
        self.stall_seconds = stall_seconds
        self._stalled = False
        self._closed = False

    def beat(self) -> None:
        self.last = time.monotonic()
        self.beats += 1

    def close(self) -> None:
        """Deregister (a finished loop must not read as an eternal stall)."""
        self._closed = True
        with _lock:
            _hearts.pop(self.hb_id, None)

    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _NoopHeartbeat:
    """Disabled-path stand-in (also usable as a context manager)."""

    site = "noop"
    beats = 0

    def beat(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NoopHeartbeat":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP_HEARTBEAT = _NoopHeartbeat()


def register(site: str, stall_seconds: Optional[float] = None):
    """Register a heartbeat for a hot loop; returns the handle (a no-op
    handle while telemetry is disabled — the sampler never starts). Use
    as a context manager or call ``close()`` when the loop exits.
    ``stall_seconds`` raises the threshold for this site above the global
    one (a floor for slow-but-alive scopes like cold-compile first
    iterations; the effective threshold is the max of the two)."""
    if not _metrics.enabled():
        return NOOP_HEARTBEAT
    global _next_id
    hb = None
    with _lock:
        _next_id += 1
        hb = Heartbeat(str(site), _next_id, stall_seconds)
        _hearts[hb.hb_id] = hb
    _ensure_thread()
    return hb


def heartbeats() -> List[Dict[str, Any]]:
    """Point-in-time view (the ``/debug/cluster`` and test surface)."""
    now = time.monotonic()
    with _lock:
        return [{"site": h.site, "age_seconds": round(now - h.last, 6),
                 "beats": h.beats, "stalled": h._stalled}
                for h in _hearts.values()]


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def stop() -> None:
    """Stop the sampler thread and drop every registration (tests)."""
    global _thread
    _stop_evt.set()
    t = _thread
    if t is not None and t.is_alive() and t is not threading.current_thread():
        t.join(timeout=5)
    _thread = None
    _stop_evt.clear()
    with _lock:
        _hearts.clear()
        _stall_log.clear()


def _ensure_thread() -> None:
    global _thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _thread = threading.Thread(target=_run, name="mmlspark-watchdog",
                                   daemon=True)
        _thread.start()


def dump_all_stacks(limit_frames: int = 12) -> Dict[str, str]:
    """Formatted stack per live thread (id+name keyed) — the post-mortem
    payload for "what was every thread doing when the loop stalled"."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, str] = {}
    for tid, frame in sys._current_frames().items():
        stack = "".join(traceback.format_stack(frame, limit=limit_frames))
        out[f"{tid}:{names.get(tid, '?')}"] = stack
    return out


def stall_counts() -> Dict[str, int]:
    """Stalls flagged since process start, per site (bench snapshots)."""
    counts: Dict[str, int] = {}
    with _lock:
        for s in _stall_log:
            counts[s["site"]] = counts.get(s["site"], 0) + 1
    return counts


def _flag_stall(hb: Heartbeat, age: float) -> None:
    from . import logging as _logging
    stacks = dump_all_stacks()
    _metrics.safe_counter("watchdog_stalls_total", site=hb.site).inc()
    _flight.record("watchdog_stall", site=hb.site,
                   age_seconds=round(age, 3), beats=hb.beats,
                   stacks=stacks)
    dump_path = None
    try:
        dump_path = _flight.dump()
    except Exception:  # noqa: BLE001 — a full disk must not kill the sampler
        pass
    _logging.get_logger("mmlspark_tpu_torch.watchdog").error(
        "stall: heartbeat %r silent for %.3fs (threshold %.3fs); "
        "flight ring dumped", hb.site, age,
        max(hb.stall_seconds or 0.0, _stall_seconds),
        site=hb.site, dump=dump_path)
    with _lock:
        _stall_log.append({"site": hb.site, "age_seconds": round(age, 3),
                           "ts": time.time(), "dump": dump_path})
        del _stall_log[:-256]
    _emit_event("stall", hb.site, age_seconds=round(age, 3))


def _run() -> None:
    while not _stop_evt.wait(get_interval_seconds()):
        if not _metrics.enabled():
            continue
        # piggyback the periodic device-memory sample on the watchdog
        # tick (throttled + jax-guarded inside maybe_sample_device_memory)
        _device.maybe_sample_device_memory()
        now = time.monotonic()
        with _lock:
            hearts = list(_hearts.values())
        for hb in hearts:
            if hb._closed:
                continue
            if hb.thread is not None and not hb.thread.is_alive():
                # the loop's thread is gone (crashed out without close()):
                # deregister instead of reading as an eternal stall
                hb.close()
                continue
            age = now - hb.last
            if age > max(hb.stall_seconds or 0.0, _stall_seconds):
                if not hb._stalled:
                    hb._stalled = True      # once per episode
                    try:
                        _flag_stall(hb, age)
                    except Exception:  # noqa: BLE001
                        pass
            elif hb._stalled:
                hb._stalled = False
                _flight.record("watchdog_recovered", site=hb.site,
                               age_seconds=round(age, 3))


# ---------------------------------------------------------------------------
# Training-health sentinels
# ---------------------------------------------------------------------------

# metric names where larger is better: divergence there means *falling*,
# which early stopping already handles — the sentinels only chase blow-ups
_HIGHER_BETTER_TOKENS = ("auc", "ndcg", "map", "accuracy", "acc")


def _higher_is_better(metric_name: Optional[str]) -> bool:
    n = (metric_name or "").lower()
    return any(tok in n for tok in _HIGHER_BETTER_TOKENS)


class _TrainingState:
    __slots__ = ("losses", "durations", "healthy")

    def __init__(self, window: int):
        self.losses: deque = deque(maxlen=window)
        self.durations: deque = deque(maxlen=window)
        self.healthy = True


_training: Dict[str, _TrainingState] = {}


def _loss_window() -> int:
    return max(2, int(_env_float(_WINDOW_ENV, 8)))


def _state(model: str) -> _TrainingState:
    with _lock:
        st = _training.get(model)
        if st is None:
            st = _training[model] = _TrainingState(_loss_window())
        return st


def _unhealthy(model: str, kind: str, **fields: Any) -> None:
    from . import logging as _logging
    st = _state(model)
    st.healthy = False
    _metrics.safe_gauge("training_health", model=model).set(0.0)
    _metrics.safe_counter("training_health_events_total",
                          model=model, kind=kind).inc()
    _flight.record("training_health", model=model, event=kind, **fields)
    _logging.get_logger("mmlspark_tpu_torch.watchdog").error(
        "training health: %s on %s", kind, model, model=model, **fields)
    _emit_event(kind, model, **fields)


def report_training_metric(model: str, iteration: int,
                           loss: Optional[float] = None,
                           metric_name: Optional[str] = None,
                           seconds: Optional[float] = None) -> None:
    """Feed one training round's loss and/or wall time into the sentinels.

    No-op while telemetry is disabled. ``loss`` runs the NaN/Inf and
    windowed-divergence checks (divergence only for lower-is-better
    metrics); ``seconds`` runs the throughput-collapse check.
    """
    if not _metrics.enabled():
        return
    st = _state(model)
    if st.healthy:
        _metrics.safe_gauge("training_health", model=model).set(1.0)
    if loss is not None:
        loss = float(loss)
        if not math.isfinite(loss):
            _unhealthy(model, "nan_loss", iteration=iteration,
                       metric=metric_name, value=repr(loss))
        elif not _higher_is_better(metric_name):
            if (len(st.losses) == st.losses.maxlen
                    and loss > min(st.losses) * DIVERGENCE_FACTOR
                    and loss > st.losses[0]):
                _unhealthy(model, "loss_divergence", iteration=iteration,
                           metric=metric_name, value=loss,
                           window_min=min(st.losses))
            st.losses.append(loss)
    if seconds is not None and seconds > 0:
        if len(st.durations) == st.durations.maxlen:
            med = sorted(st.durations)[len(st.durations) // 2]
            if med > 0 and seconds > med * COLLAPSE_FACTOR:
                _unhealthy(model, "throughput_collapse",
                           iteration=iteration, seconds=round(seconds, 4),
                           window_median=round(med, 4))
        st.durations.append(float(seconds))


def scan_eval_history(model: str, history: Optional[Dict[str, Any]]) -> bool:
    """Post-fit audit of a booster's full metric history — catches NaN /
    divergence on the fused single-dispatch training paths, which never
    invoke a per-round callback. Returns final health."""
    if not _metrics.enabled():
        return True
    st = _state(model)
    for name, series in (history or {}).items():
        vals = [float(v) for v in (series or [])]
        if any(not math.isfinite(v) for v in vals):
            _unhealthy(model, "nan_loss", iteration=len(vals) - 1,
                       metric=str(name), value="non-finite in history")
            continue
        if vals and not _higher_is_better(name):
            lo = min(vals)
            if lo > 0 and vals[-1] > lo * DIVERGENCE_FACTOR:
                _unhealthy(model, "loss_divergence",
                           iteration=len(vals) - 1, metric=str(name),
                           value=vals[-1], window_min=lo)
    if st.healthy:
        _metrics.safe_gauge("training_health", model=model).set(1.0)
    return st.healthy


def training_healthy(model: str) -> bool:
    with _lock:
        st = _training.get(model)
    return st.healthy if st is not None else True


def reset_training_health(model: Optional[str] = None) -> None:
    """Forget sentinel state (all models by default) — a new fit starts
    healthy. Tests and sweep loops call this between fits."""
    with _lock:
        if model is None:
            _training.clear()
        else:
            _training.pop(model, None)
