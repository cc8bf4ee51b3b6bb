"""Structured host-side spans on the profiler's clock, with ids, device
time and counter deltas.

The reference's per-stage timing story is host StopWatch scopes with
human-readable names (stages/Timer.scala:57-92); our device-side story is
utils/profiling.annotate (torch.profiler.record_function). A :func:`span` is
the bridge: one context manager that

- records wall-time and nests via a contextvar parent (thread- and
  task-local, so concurrent serving threads don't corrupt each other's
  stacks);
- feeds the metrics registry's histograms (``span_duration_seconds``) and
  the flight recorder's ``span_end`` records, unless ``publish=False``;
- enters ``utils/profiling.annotate`` with the same name, so device ops
  launched inside the span carry the host span's label in
  ``torch.profiler`` traces.

Clock. ``ts`` is Unix-epoch microseconds: ``time.perf_counter()`` plus one
offset to ``time.time_ns()`` taken when this module is imported
(:data:`EPOCH_OFFSET_US`). Durations keep ``perf_counter``'s resolution,
and a span's ``ts`` lies on the clock ``torch.profiler`` stamps its host
events with (their ``start_ns()`` is Unix-epoch nanoseconds), so a span
and the ``record_function`` event it opens start within microseconds of
each other. The offset is fixed once: were the wall clock stepped or
slewed later in the process, the two clocks part by what it moved.

Ids. Each span's ``args`` hold its own ``span_id`` (an int, unique in the
process) and, inside another span, the parent's ``parent_id`` and name
(``parent``); an instant inside a span carries the span's ``parent_id``.
Two sibling spans of one name are told apart by their ids. Inside a
request's tracing context (:mod:`.tracing`) every event also carries the
request's ``trace_id`` and the hop's W3C span id as ``hop_span_id``.

Device time. ``span(name, device=d)`` takes device time only while
metrics are on, ``d`` is a CUDA device and the current stream is not
capturing a graph: it then records a pair of timing events on the current
stream at entry and exit. Nothing waits for them there. A pair the device
has passed is resolved into ``args["device_ms"]`` (the stream's elapsed
milliseconds between the two events: the enclosed work and any gap the
host left the stream idle) as later spans end; :func:`get_trace_events`
and :func:`dump_trace` wait for the rest.

Counters. ``span(name, counters={"rows": read})`` calls each ``read`` (a
function returning a plain int, e.g. a module counter) at entry and exit
and stores the change as that attribute.

Spans accumulate into a bounded in-process buffer exportable as a Chrome
trace-event JSON file (``chrome://tracing`` / Perfetto) via
:func:`dump_trace`, alone or laid over a ``torch.profiler`` trace of the
same stretch. Everything is a no-op while the metrics flag is off.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import (Any, Callable, Deque, Dict, Iterator, List, Mapping,
                    Optional)

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "span", "span_fn", "instant", "dump_trace", "get_trace_events",
    "clear_trace", "set_default_attrs", "get_default_attrs", "current_span",
    "MAX_TRACE_EVENTS", "set_max_trace_events", "get_max_trace_events",
    "dropped_events", "EPOCH_OFFSET_US",
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
_span_ids = itertools.count(1)
# (event, start, end) of device-timed spans whose device time is not read
# yet, oldest first; bounded like the event buffer
_pending: "Deque[tuple]" = collections.deque(maxlen=MAX_TRACE_EVENTS)
_pending_lock = threading.Lock()

#: Unix-epoch microseconds at ``time.perf_counter()`` 0: a span's ``ts`` is
#: ``perf_counter() * 1e6 + EPOCH_OFFSET_US``.
EPOCH_OFFSET_US = (time.time_ns() - time.perf_counter_ns()) / 1e3


def _epoch_us(perf_s: float) -> float:
    return perf_s * 1e6 + EPOCH_OFFSET_US


class _SpanRecord:
    """Mutable in-flight span handle; ``set`` attaches attributes that end
    up in the trace event's ``args``."""

    __slots__ = ("name", "attrs", "parent", "span_id")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 parent: "Optional[_SpanRecord]"):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.span_id = next(_span_ids)

    def set(self, **attrs: Any) -> "_SpanRecord":
        self.attrs.update(attrs)
        return self


class _NoopSpan:
    """Disabled-path handle so call sites never branch on the flag."""

    name = ""
    parent = None
    span_id = None

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
            args.setdefault("hop_span_id", ctx.span_id)
    with _buf_lock:
        full = len(_events) == _events.maxlen
        if full:
            _dropped += 1  # deque maxlen evicts the oldest on append
        _events.append(event)
    if full:
        # outside _buf_lock: the registry has its own lock, never nest them
        _metrics.safe_counter("trace_events_dropped_total").inc()


def _device_start(device):
    """``(stream, start event)``: a timing event recorded on ``device``'s
    current stream, or None where the span takes no device time (no
    device, not CUDA, or the stream is capturing a graph, where an event
    cannot be timed)."""
    if device is None:
        return None
    try:
        import torch

        dev = torch.device(device)
        if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return None
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return stream, start
    except Exception:  # noqa: BLE001 — never break the spanned work
        return None


def _device_end(started, event: Dict[str, Any]) -> None:
    """Record the span's end event on its stream and queue the pair;
    resolve every queued pair the device has passed."""
    stream, start = started
    try:
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
    except Exception:  # noqa: BLE001
        return
    with _pending_lock:
        _pending.append((event, start, end))
    _resolve_device_times(wait=False)


def _resolve_device_times(wait: bool) -> None:
    """Write ``device_ms`` into queued events, oldest first: those whose end
    event the device has passed, or (``wait``) all of them."""
    with _pending_lock:
        while _pending:
            event, start, end = _pending[0]
            try:
                if wait:
                    end.synchronize()
                elif not end.query():
                    return
                event["args"]["device_ms"] = start.elapsed_time(end)
            except Exception:  # noqa: BLE001 — an unreadable pair is dropped
                pass
            _pending.popleft()


@contextlib.contextmanager
def span(name: str, metric_label: Optional[str] = None, *,
         device: Any = None,
         counters: Optional[Mapping[str, Callable[[], int]]] = None,
         publish: bool = True, **attrs: Any) -> Iterator[Any]:
    """Time a region: nests, traces, and feeds the registry.

    ``metric_label`` bounds registry label cardinality: the
    ``span_duration_seconds`` histogram is labeled with it instead of
    ``name`` when given (e.g. the pipeline layer passes the stage class
    name while the span itself carries the per-instance uid). The yielded
    handle's ``set(**attrs)`` adds attributes mid-span (row counts etc.).
    ``device`` (a CUDA ``torch.device``) adds the region's device time,
    ``counters`` the change of each named counter over the region (module
    docstring). ``publish=False`` keeps the span out of
    ``span_duration_seconds`` and the flight ring: the trace buffer alone
    holds it.
    """
    if not _metrics.enabled():
        yield _NOOP_SPAN
        return
    from ..utils import profiling  # lazy: keeps observability import-cycle-free

    parent = _parent.get()
    rec = _SpanRecord(name, dict(attrs), parent)
    token = _parent.set(rec)
    before = {k: read() for k, read in counters.items()} if counters else None
    t0, started = time.perf_counter(), None
    try:
        # annotate degrades to a no-op itself (never breaks the spanned work)
        with profiling.annotate(name):
            # stamped once the annotation is open: its start on the
            # profiler's clock lies just before ours
            t0 = time.perf_counter()
            started = _device_start(device)
            yield rec
    finally:
        dur = time.perf_counter() - t0
        _parent.reset(token)
        if before:
            for k, read in counters.items():
                rec.attrs[k] = read() - before[k]
        args = {**_default_attrs, **rec.attrs, "span_id": rec.span_id}
        if parent is not None:
            args["parent"] = parent.name
            args["parent_id"] = parent.span_id
        event = {
            "name": name, "ph": "X", "cat": "mmlspark",
            "ts": _epoch_us(t0), "dur": dur * 1e6,
            "pid": _pid(), "tid": threading.get_ident(),
            "args": args,
        }
        _record(event)
        if started is not None:
            _device_end(started, event)
        if publish:
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
    args = {**_default_attrs, **attrs}
    parent = _parent.get()
    if parent is not None:
        args["parent_id"] = parent.span_id
    _record({
        "name": name, "ph": "i", "cat": "mmlspark", "s": "t",
        "ts": _epoch_us(time.perf_counter()),
        "pid": _pid(), "tid": threading.get_ident(),
        "args": args,
    })


def get_trace_events() -> List[Dict[str, Any]]:
    """The buffered events, oldest first, every device time resolved
    (this waits for the device to pass the spans' end events)."""
    _resolve_device_times(wait=True)
    with _buf_lock:
        return [dict(e) for e in _events]


def clear_trace() -> None:
    global _dropped
    with _pending_lock:
        _pending.clear()
    with _buf_lock:
        _events.clear()
        _dropped = 0


def dump_trace(path: str, overlay: Optional[str] = None) -> str:
    """Write the buffered events as Chrome trace-event JSON (load in
    chrome://tracing or ui.perfetto.dev), device times resolved. Returns
    ``path``.

    Alone, ``ts`` is Unix-epoch microseconds. ``overlay`` names a trace
    that ``torch.profiler``'s ``export_chrome_trace`` wrote of the same
    stretch: the document written is that trace with these events added,
    each ``ts`` moved onto its time base (its ``ts`` count microseconds
    from its ``baseTimeNanoseconds``, so ours become ``ts -
    baseTimeNanoseconds / 1000``). The spans then lie over the profiler's
    host ops and kernels, on rows of their own (``pid`` the process,
    ``tid`` the Python thread's ident)."""
    _resolve_device_times(wait=True)
    with _buf_lock:
        events = [dict(e) for e in _events]
        dropped = _dropped
    doc: Dict[str, Any] = {"displayTimeUnit": "ms"}
    if overlay is not None:
        with open(overlay) as f:
            doc = json.load(f)
        base_us = float(doc.get("baseTimeNanoseconds", 0)) / 1e3
        for e in events:
            e["ts"] = e["ts"] - base_us
        events = doc.get("traceEvents", []) + events
    doc["traceEvents"] = events
    doc["otherData"] = {**doc.get("otherData", {}),
                        "dropped_events": dropped}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
