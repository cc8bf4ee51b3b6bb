"""Structured host-side spans that share names with device traces.

The reference's per-stage timing story is host StopWatch scopes with
human-readable names (stages/Timer.scala:57-92); our device-side story is
utils/profiling.annotate (torch.profiler.record_function). A :func:`span` is
the bridge: one context manager that

- records wall-time and nests via a contextvar parent (thread- and
  task-local, so concurrent serving threads don't corrupt each other's
  stacks);
- feeds the metrics registry's histograms (``span_duration_seconds``);
- enters ``utils/profiling.annotate`` with the same name, so device ops
  launched inside the span carry the host span's label in
  ``torch.profiler`` traces.

Spans accumulate into a bounded in-process buffer exportable as a Chrome
trace-event JSON file (``chrome://tracing`` / Perfetto) via
:func:`dump_trace`. Everything is a no-op while the metrics flag is off.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Optional

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "span", "span_fn", "instant", "dump_trace", "get_trace_events",
    "clear_trace", "set_default_attrs", "get_default_attrs", "current_span",
    "MAX_TRACE_EVENTS", "set_max_trace_events", "get_max_trace_events",
    "dropped_events",
]


def _env_cap() -> int:
    try:
        n = int(os.environ.get("MMLSPARK_TPU_MAX_TRACE_EVENTS", "")
                or 100_000)
    except ValueError:
        n = 100_000
    return max(1, n)


# Bounded buffer: long-running servers must not grow without limit; the
# oldest events are dropped once full (dump early, dump often). Tunable
# via MMLSPARK_TPU_MAX_TRACE_EVENTS (a week-long serving process sizes
# this to its memory budget) or set_max_trace_events at runtime.
MAX_TRACE_EVENTS = _env_cap()

_parent: "contextvars.ContextVar[Optional[_SpanRecord]]" = \
    contextvars.ContextVar("mmlspark_tpu_span_parent", default=None)
_buf_lock = threading.Lock()
# deque(maxlen=...) keeps the drop-oldest semantics at O(1) per record —
# a full list's pop(0) would memmove 100k entries inside the lock on every
# span completion of a long-running server
_events: "Deque[Dict[str, Any]]" = collections.deque(maxlen=MAX_TRACE_EVENTS)
_dropped = 0
_default_attrs: Dict[str, Any] = {}


class _SpanRecord:
    """Mutable in-flight span handle; ``set`` attaches attributes that end
    up in the trace event's ``args``."""

    __slots__ = ("name", "attrs", "parent")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 parent: "Optional[_SpanRecord]"):
        self.name = name
        self.attrs = attrs
        self.parent = parent

    def set(self, **attrs: Any) -> "_SpanRecord":
        self.attrs.update(attrs)
        return self


class _NoopSpan:
    """Disabled-path handle so call sites never branch on the flag."""

    name = ""
    parent = None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


def set_default_attrs(**attrs: Any) -> None:
    """Attributes stamped onto every subsequent event (e.g.
    ``process_index`` on multi-host runs — parallel/distributed.py sets it
    after ``initialize``)."""
    # replace-on-write: readers unpack {**_default_attrs, ...} without a
    # lock, and mutating the shared dict mid-unpack would raise
    # "dictionary changed size during iteration" out of span()'s finally
    # into the instrumented user code
    global _default_attrs
    _default_attrs = {**_default_attrs, **attrs}


def get_default_attrs() -> Dict[str, Any]:
    return dict(_default_attrs)


def current_span():
    """The innermost live span in this context (None outside any span)."""
    return _parent.get()


def _pid() -> int:
    idx = _default_attrs.get("process_index")
    return int(idx) if idx is not None else os.getpid()


def set_max_trace_events(n: int) -> int:
    """Resize the bounded event buffer (keeps the newest events); returns
    the previous cap. Env default: ``MMLSPARK_TPU_MAX_TRACE_EVENTS``."""
    global _events, _dropped, MAX_TRACE_EVENTS
    n = max(1, int(n))
    with _buf_lock:
        prev = MAX_TRACE_EVENTS
        kept = list(_events)[-n:]
        _dropped += len(_events) - len(kept)
        _events = collections.deque(kept, maxlen=n)
        MAX_TRACE_EVENTS = n
    return prev


def get_max_trace_events() -> int:
    return MAX_TRACE_EVENTS


def dropped_events() -> int:
    """Oldest-dropped count since the last :func:`clear_trace` (also
    exported as the ``trace_events_dropped_total`` counter)."""
    return _dropped


def _record(event: Dict[str, Any]) -> None:
    global _dropped
    ctx = _tracing.current()
    if ctx is not None:
        # stitch key: Chrome-trace dumps from different processes merge
        # into one logical request by this id
        args = event.get("args")
        if args is not None:
            args.setdefault("trace_id", ctx.trace_id)
            args.setdefault("span_id", ctx.span_id)
    with _buf_lock:
        full = len(_events) == _events.maxlen
        if full:
            _dropped += 1  # deque maxlen evicts the oldest on append
        _events.append(event)
    if full:
        # outside _buf_lock: the registry has its own lock, never nest them
        _metrics.safe_counter("trace_events_dropped_total").inc()


@contextlib.contextmanager
def span(name: str, metric_label: Optional[str] = None,
         **attrs: Any) -> Iterator[Any]:
    """Time a region: nests, traces, and feeds the registry.

    ``metric_label`` bounds registry label cardinality: the
    ``span_duration_seconds`` histogram is labeled with it instead of
    ``name`` when given (e.g. the pipeline layer passes the stage class
    name while the span itself carries the per-instance uid). The yielded
    handle's ``set(**attrs)`` adds attributes mid-span (row counts etc.).
    """
    if not _metrics.enabled():
        yield _NOOP_SPAN
        return
    from ..utils import profiling  # lazy: keeps observability import-cycle-free

    parent = _parent.get()
    rec = _SpanRecord(name, dict(attrs), parent)
    token = _parent.set(rec)
    t0 = time.perf_counter()
    try:
        # annotate degrades to a no-op itself (never breaks the spanned work)
        with profiling.annotate(name):
            yield rec
    finally:
        dur = time.perf_counter() - t0
        _parent.reset(token)
        args = {**_default_attrs, **rec.attrs}
        if parent is not None:
            args["parent"] = parent.name
        _record({
            "name": name, "ph": "X", "cat": "mmlspark",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": _pid(), "tid": threading.get_ident(),
            "args": args,
        })
        _metrics.safe_histogram("span_duration_seconds",
                                name=metric_label or name).observe(dur)
        # flight-recorder feed: span ends are the "what was it doing in
        # its final seconds" record a crash dump is made of
        from . import flight as _flight
        _flight.record("span_end", name=name, dur_us=int(dur * 1e6))


def span_fn(name: str, **attrs: Any):
    """Decorator form of :func:`span`."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name, **attrs):
                return fn(*a, **kw)
        return wrapped
    return deco


def instant(name: str, **attrs: Any) -> None:
    """Zero-duration marker (Chrome trace 'i' event) — e.g. one per boost
    round when detailed training telemetry is on."""
    if not _metrics.enabled():
        return
    _record({
        "name": name, "ph": "i", "cat": "mmlspark", "s": "t",
        "ts": time.perf_counter() * 1e6,
        "pid": _pid(), "tid": threading.get_ident(),
        "args": {**_default_attrs, **attrs},
    })


def get_trace_events() -> List[Dict[str, Any]]:
    with _buf_lock:
        return [dict(e) for e in _events]


def clear_trace() -> None:
    global _dropped
    with _buf_lock:
        _events.clear()
        _dropped = 0


def dump_trace(path: str) -> str:
    """Write the buffered events as Chrome trace-event JSON (load in
    chrome://tracing or ui.perfetto.dev). Returns ``path``."""
    with _buf_lock:
        doc = {
            "traceEvents": [dict(e) for e in _events],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": _dropped},
        }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
