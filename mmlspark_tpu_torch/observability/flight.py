"""Crash-safe flight recorder: the last N structured events, always on.

When a serving worker wedges or dies, metrics say *that* it died and
spans say how long things took — neither says what the process was doing
in its final seconds. The flight recorder does: a bounded, thread-safe
ring buffer of structured events (span ends, errors, retries/failovers,
compile events, queue transitions) that costs near-zero when idle and
dumps JSON

- on unhandled exception (chained ``sys.excepthook``),
- on ``SIGUSR2`` (poke a live, wedged process from the outside),
- on demand (:func:`dump`, the ``/debug/flight`` endpoint, bench.py's
  ``GRAFT_BENCH_FLIGHT_SNAPSHOT``).

Ring capacity comes from ``MMLSPARK_TPU_FLIGHT_EVENTS`` (default 4096);
dumps land in ``MMLSPARK_TPU_FLIGHT_DIR`` (default: the system temp
dir). Recording is inert behind the global telemetry kill switch and
stamps the active trace context onto every event, so a dump from a dying
worker stitches into the same story as the gateway's.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "record", "events", "clear", "dropped", "capacity", "set_capacity",
    "set_default_fields", "snapshot", "dump", "dump_json", "dump_path",
    "add_dump_callback", "remove_dump_callback",
    "install", "uninstall", "DEFAULT_CAPACITY",
]

_CAPACITY_ENV = "MMLSPARK_TPU_FLIGHT_EVENTS"
_DIR_ENV = "MMLSPARK_TPU_FLIGHT_DIR"


def _env_capacity() -> int:
    try:
        n = int(os.environ.get(_CAPACITY_ENV, "") or 4096)
    except ValueError:
        n = 4096
    return max(1, n)


DEFAULT_CAPACITY = _env_capacity()

# RLock, not Lock: the SIGUSR2 dump handler runs on the main thread
# BETWEEN bytecodes — possibly while that same thread is inside record()'s
# critical section. A non-reentrant lock would deadlock the exact process
# the signal was sent to inspect; re-entrancy lets the dump proceed (at
# worst observing one half-appended event, fine for a diagnostic ring).
_lock = threading.RLock()
_buf: "Deque[Dict[str, Any]]" = collections.deque(maxlen=DEFAULT_CAPACITY)
_dropped = 0
_seq = 0
_default_fields: Dict[str, Any] = {}


def record(kind: str, **fields: Any) -> None:
    """Append one event. Near-zero when disabled (one flag check); cheap
    when enabled (one dict build + locked deque append). The active
    trace context's ids are stamped on automatically."""
    if not _metrics.enabled():
        return
    global _dropped, _seq
    ev: Dict[str, Any] = {"kind": kind, "ts": time.time(),
                          "tid": threading.get_ident()}
    if _default_fields:
        ev.update(_default_fields)
    ev.update(fields)
    ctx = _tracing.current()
    if ctx is not None:
        ev.setdefault("trace_id", ctx.trace_id)
        ev.setdefault("span_id", ctx.span_id)
    with _lock:
        _seq += 1
        ev["seq"] = _seq
        if len(_buf) == _buf.maxlen:
            _dropped += 1                 # deque maxlen evicts the oldest
        _buf.append(ev)


def events() -> List[Dict[str, Any]]:
    """Point-in-time copy, oldest first."""
    with _lock:
        return [dict(e) for e in _buf]


def clear() -> None:
    global _dropped, _seq
    with _lock:
        _buf.clear()
        _dropped = 0
        _seq = 0


def dropped() -> int:
    """Events evicted since the last :func:`clear` (ring overwrites)."""
    return _dropped


def capacity() -> int:
    return _buf.maxlen or DEFAULT_CAPACITY


def set_capacity(n: int) -> int:
    """Resize the ring (keeps the newest events); returns the previous
    capacity. Env default: ``MMLSPARK_TPU_FLIGHT_EVENTS``."""
    global _buf, _dropped
    n = max(1, int(n))
    with _lock:
        prev = _buf.maxlen or DEFAULT_CAPACITY
        kept = list(_buf)[-n:]
        _dropped += len(_buf) - len(kept)
        _buf = collections.deque(kept, maxlen=n)
    return prev


def set_default_fields(**fields: Any) -> None:
    """Fields stamped onto every subsequent event (e.g. ``process_index``
    on multi-host runs, ``role`` on serving deployments); a None value
    removes the field. Replace-on-write for lock-free readers, mirroring
    spans.set_default_attrs."""
    global _default_fields
    merged = {**_default_fields, **fields}
    _default_fields = {k: v for k, v in merged.items() if v is not None}


def snapshot(since: Optional[int] = None) -> Dict[str, Any]:
    """JSON-safe view: events plus enough process identity to merge dumps
    from several workers (this is the ``/debug/flight`` payload).

    ``since`` is the incremental-scrape cursor: only events with
    ``seq > since`` are included, and the payload's ``last_seq`` is the
    highest ``seq`` ever assigned — the scraper passes it back as the
    next ``?since=`` so repeated scrapes are deltas, not full rings."""
    with _lock:
        if since is None:
            evs = [dict(e) for e in _buf]
        else:
            evs = [dict(e) for e in _buf if e.get("seq", 0) > since]
        drop = _dropped
        last = _seq
    out = {
        "pid": os.getpid(),
        "time": time.time(),
        "capacity": capacity(),
        "dropped": drop,
        "last_seq": last,
        "default_fields": dict(_default_fields),
        "events": evs,
    }
    if since is not None:
        out["since"] = since
    return out


def dump_json() -> bytes:
    """The snapshot as JSON bytes (non-serializable values are repr()d:
    a dump from a dying process must never fail on a weird field)."""
    return json.dumps(snapshot(), default=repr).encode("utf-8")


def _dump_dir() -> str:
    return os.environ.get(_DIR_ENV) or tempfile.gettempdir()


_dump_seq = 0


def dump_path(prefix: str = "flight") -> str:
    """A fresh, collision-free dump path:
    ``$MMLSPARK_TPU_FLIGHT_DIR/{prefix}-{pid}-{ts}-{n}.json``.

    Every dump producer (explicit :func:`dump`, the SIGUSR2/excepthook
    crash hooks, the watchdog's stall dump, the fleet timeline) names
    files through this one funnel. The pid plus a per-process monotonic
    counter make the name unique even when a gateway and several workers
    share one ``MMLSPARK_TPU_FLIGHT_DIR`` and dump within the same
    second (a wall-clock-only suffix silently overwrote the earlier
    dump — exactly the forensics a post-mortem needed)."""
    global _dump_seq
    with _lock:
        _dump_seq += 1
        n = _dump_seq
    return os.path.join(
        _dump_dir(),
        f"{prefix}-{os.getpid()}-{int(time.time())}-{n:04d}.json")


def dump(path: Optional[str] = None) -> str:
    """Write the snapshot to ``path`` (default: :func:`dump_path`);
    returns the path written."""
    if path is None:
        path = dump_path()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(dump_json())
    return path


# ---------------------------------------------------------------------------
# Crash hooks: SIGUSR2 + unhandled-exception dump
# ---------------------------------------------------------------------------

_prev_excepthook = None
_prev_signal = None
_installed_signum: Optional[int] = None

# companions dumped alongside the ring by both crash hooks — e.g. the
# gateway's fleet timeline registers here so a SIGUSR2 poke or an
# unhandled exception leaves the cluster-wide story next to the local one
_dump_callbacks: List[Callable[[], Any]] = []


def add_dump_callback(fn: Callable[[], Any]) -> None:
    """Register ``fn`` to run whenever a crash hook dumps the ring
    (SIGUSR2 / excepthook). Idempotent; exceptions are swallowed —
    a companion dump must never abort the primary one."""
    if fn not in _dump_callbacks:
        _dump_callbacks.append(fn)


def remove_dump_callback(fn: Callable[[], Any]) -> None:
    try:
        _dump_callbacks.remove(fn)
    except ValueError:
        pass


def _run_dump_callbacks() -> None:
    for fn in list(_dump_callbacks):
        try:
            fn()
        except Exception:  # noqa: BLE001 — never kill the crash hook
            pass


def _on_signal(signum, frame) -> None:  # noqa: ARG001 — signal signature
    try:
        from . import logging as _logging  # lazy: logging imports flight
        record("signal_dump", signum=int(signum))
        path = dump()
        _run_dump_callbacks()
        _logging.console(f"[flight] dumped {len(events())} events to {path}",
                         err=True)
    except Exception:  # noqa: BLE001 — a dump hook must never kill the host
        pass


def _on_unhandled(exc_type, exc, tb) -> None:
    try:
        from . import logging as _logging  # lazy: logging imports flight
        record("unhandled_exception",
               error=f"{exc_type.__name__}: {exc}")
        path = dump()
        _run_dump_callbacks()
        _logging.console(f"[flight] unhandled exception; dumped to {path}",
                         err=True)
    except Exception:  # noqa: BLE001
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def install(signum: Optional[int] = None, excepthook: bool = True) -> None:
    """Arm the crash hooks (idempotent).

    ``signum`` defaults to ``SIGUSR2`` where the platform has it; pass
    ``signum=0`` to skip signal installation (e.g. from non-main
    threads, where ``signal.signal`` raises — that failure is swallowed
    and only the excepthook is armed).
    """
    global _prev_excepthook, _prev_signal, _installed_signum
    import signal as _signal
    if signum is None:
        signum = getattr(_signal, "SIGUSR2", 0)
    if signum and _installed_signum is None:
        try:
            _prev_signal = _signal.signal(signum, _on_signal)
            _installed_signum = signum
        except (ValueError, OSError):     # non-main thread / exotic platform
            _prev_signal = None
    if excepthook and _prev_excepthook is None and \
            sys.excepthook is not _on_unhandled:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _on_unhandled


def uninstall() -> None:
    """Disarm the hooks and restore what was there before (tests)."""
    global _prev_excepthook, _prev_signal, _installed_signum
    import signal as _signal
    if _installed_signum is not None:
        try:
            _signal.signal(_installed_signum,
                           _prev_signal or _signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        _prev_signal = None
        _installed_signum = None
    if sys.excepthook is _on_unhandled:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    _prev_excepthook = None
