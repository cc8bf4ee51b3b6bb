"""Per-request trace context propagated across serving processes.

Spans and the registry are local to a process; a request that
crosses the serving edge -> distributed gateway -> worker boundary still
lost its identity at each HTTP hop, so dumps from different processes
could not be stitched into one story. This module is the correlation
layer: a contextvar-held :class:`TraceContext` (``trace_id`` /
``span_id`` / ``parent_id``), W3C-traceparent-style header encoding for
the hops, and the slow-request exemplar buffer that attaches trace ids
to latency outliers.

Design rules (shared with the rest of ``observability``):

- **One module owns the header names.** ``TRACEPARENT_HEADER`` and
  ``REQUEST_ID_HEADER`` are the only place those strings exist in the
  framework — ``tests/test_lint.py`` rejects literals at call sites, so
  the wire contract cannot drift per hop.
- **Kill-switch inert.** While ``metrics.set_enabled(False)``,
  extraction returns ``None``, injection adds nothing, and exemplars
  don't record — instrumented paths keep byte-identical behavior.
- **Never breaks the request it labels.** Parsing is total (malformed
  headers yield a fresh context, never an exception).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import re
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Mapping, Optional

from . import metrics as _metrics

__all__ = [
    "TraceContext", "TRACEPARENT_HEADER", "REQUEST_ID_HEADER",
    "new_context", "child_context", "current", "activate", "deactivate",
    "use", "format_traceparent", "parse_traceparent",
    "context_from_headers", "inject_headers", "outbound_headers",
    "get_slow_threshold", "set_slow_threshold", "maybe_mark_slow",
    "get_exemplars", "clear_exemplars",
]

#: W3C trace-context propagation header (lowercase: HTTP header names are
#: case-insensitive and our parked-request dicts store lowercase keys).
TRACEPARENT_HEADER = "traceparent"
#: Response header echoing the request's trace id back to the caller.
REQUEST_ID_HEADER = "X-Request-Id"

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


@dataclass(frozen=True)
class TraceContext:
    """One hop's identity inside a distributed request.

    ``trace_id`` is shared by every hop of one request; ``span_id`` is
    this hop's own id; ``parent_id`` is the upstream hop's span id (None
    at the originating edge).
    """

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None


_current: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("mmlspark_tpu_trace_context", default=None)


def new_context() -> TraceContext:
    """Fresh root context (a request entering at this process)."""
    return TraceContext(trace_id=uuid.uuid4().hex,
                        span_id=uuid.uuid4().hex[:16])


def child_context(ctx: Optional[TraceContext] = None) -> TraceContext:
    """A downstream hop of ``ctx`` (default: the active context): same
    trace, fresh span id, parent pointing at the originating hop."""
    ctx = ctx if ctx is not None else _current.get()
    if ctx is None:
        return new_context()
    return TraceContext(trace_id=ctx.trace_id,
                        span_id=uuid.uuid4().hex[:16],
                        parent_id=ctx.span_id)


def current() -> Optional[TraceContext]:
    """The active trace context in this thread/task (None outside one)."""
    return _current.get()


def activate(ctx: TraceContext) -> "contextvars.Token":
    """Make ``ctx`` the active context; pass the token to
    :func:`deactivate` (contextvar discipline keeps concurrent serving
    threads from seeing each other's requests)."""
    return _current.set(ctx)


def deactivate(token: "contextvars.Token") -> None:
    _current.reset(token)


@contextlib.contextmanager
def use(ctx: TraceContext) -> Iterator[TraceContext]:
    """``with use(ctx):`` — scoped :func:`activate`/:func:`deactivate`."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


# ---------------------------------------------------------------------------
# Header encoding (W3C trace-context traceparent, version 00)
# ---------------------------------------------------------------------------


def format_traceparent(ctx: TraceContext) -> str:
    """``00-{trace_id}-{span_id}-01`` (sampled flag always set: sampling
    decisions belong to the collector, not the serving hot path)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Total parse: malformed/None input yields None, never an exception.
    The returned context carries the SENDER's span id; receivers should
    derive a child (see :func:`context_from_headers`)."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None or m.group(1) == "ff":        # ff is a forbidden version
        return None
    if m.group(2) == "0" * 32 or m.group(3) == "0" * 16:
        return None                            # all-zero ids are invalid
    return TraceContext(trace_id=m.group(2), span_id=m.group(3))


def _header_get(headers: Mapping[str, str], name: str) -> Optional[str]:
    """Tolerant lookup: email.Message headers are case-insensitive, the
    parked-request dicts are lowercase, user dicts may be anything."""
    v = headers.get(name)
    if v is None:
        v = headers.get(name.lower())
    if v is None and hasattr(headers, "items"):
        low = name.lower()
        for k, val in headers.items():
            if str(k).lower() == low:
                return val
    return v


def context_from_headers(
        headers: Mapping[str, str]) -> Optional[TraceContext]:
    """Inbound extraction at a serving hop.

    Returns None while telemetry is disabled (the kill-switch contract:
    no header echo, no context, byte-identical handling). Otherwise:
    a valid ``traceparent`` yields a child context of the sender's; a
    bare 32-hex ``X-Request-Id`` adopts that trace id; anything else
    starts a fresh trace.
    """
    if not _metrics.enabled():
        return None
    parsed = parse_traceparent(_header_get(headers, TRACEPARENT_HEADER))
    if parsed is not None:
        return child_context(parsed)
    rid = _header_get(headers, REQUEST_ID_HEADER)
    if rid and _TRACE_ID_RE.match(rid.strip().lower()):
        return TraceContext(trace_id=rid.strip().lower(),
                            span_id=uuid.uuid4().hex[:16])
    return new_context()


def inject_headers(headers: Dict[str, str],
                   ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """Stamp the active (or given) context onto an outbound hop's header
    dict; a no-op when disabled or outside any context."""
    if not _metrics.enabled():
        return headers
    ctx = ctx if ctx is not None else _current.get()
    if ctx is not None and TRACEPARENT_HEADER not in headers:
        headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
    return headers


def outbound_headers(ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """Headers to add to an outbound request ({} when inert) — for call
    sites that build header sets incrementally (urllib Request objects)."""
    return inject_headers({}, ctx)


# ---------------------------------------------------------------------------
# Slow-request exemplars
# ---------------------------------------------------------------------------
# Latency histograms aggregate away identity; an exemplar re-attaches it:
# any observation over the slow threshold records (metric, seconds,
# trace_id) into a bounded buffer surfaced by /varz, bumps
# slow_requests_total, and leaves a flight-recorder event — so "p99
# regressed" comes with concrete trace ids to chase through merged dumps.

_SLOW_ENV = "MMLSPARK_TPU_SLOW_REQUEST_SECONDS"
_slow_threshold = float(os.environ.get(_SLOW_ENV, "1.0") or 1.0)
_MAX_EXEMPLARS = 64
_exemplars: "Deque[Dict[str, Any]]" = collections.deque(
    maxlen=_MAX_EXEMPLARS)
_exemplar_lock = threading.Lock()


def get_slow_threshold() -> float:
    return _slow_threshold


def set_slow_threshold(seconds: float) -> float:
    """Set the slow-request exemplar threshold; returns the previous
    value (env default: ``MMLSPARK_TPU_SLOW_REQUEST_SECONDS``, 1.0s)."""
    global _slow_threshold
    prev, _slow_threshold = _slow_threshold, float(seconds)
    return prev


def maybe_mark_slow(metric: str, seconds: float,
                    stages: Optional[Dict[str, float]] = None,
                    **labels: Any) -> bool:
    """Record an exemplar if ``seconds`` crosses the slow threshold.

    ``stages`` (optional) is a per-stage wall-time breakdown of the
    same request (e.g. the serving plane's admission / forming_wait /
    score / write decomposition); it rides the exemplar and the flight
    event so a slow request tells you *which leg* was slow.

    Returns whether one was recorded. Near-zero cost on the fast path:
    one float compare when under threshold or disabled.
    """
    if seconds < _slow_threshold or not _metrics.enabled():
        return False
    ctx = _current.get()
    ex: Dict[str, Any] = {
        "metric": metric, "seconds": round(float(seconds), 6),
        "trace_id": ctx.trace_id if ctx else None,
        "span_id": ctx.span_id if ctx else None,
        "ts": time.time(), "labels": dict(labels),
    }
    if stages:
        ex["stages"] = {str(k): round(float(v), 6)
                        for k, v in stages.items()}
    with _exemplar_lock:
        _exemplars.append(ex)
    _metrics.safe_counter("slow_requests_total", metric=metric).inc()
    from . import flight as _flight  # lazy: flight imports tracing
    if stages:
        _flight.record("slow_request", metric=metric,
                       seconds=ex["seconds"], stages=ex["stages"], **labels)
    else:
        _flight.record("slow_request", metric=metric,
                       seconds=ex["seconds"], **labels)
    return True


def get_exemplars() -> List[Dict[str, Any]]:
    """Recent slow-request exemplars, oldest first (bounded at 64)."""
    with _exemplar_lock:
        return [dict(e) for e in _exemplars]


def clear_exemplars() -> None:
    with _exemplar_lock:
        _exemplars.clear()
