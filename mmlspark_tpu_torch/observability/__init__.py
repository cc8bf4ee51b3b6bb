"""Unified telemetry: metrics, spans, tracing, flight, logs, watchdog.

Seven pieces, one flag (the gateway's ``federation`` module is not
ported yet):

- :mod:`.metrics` — process-wide ``MetricsRegistry`` (Counter / Gauge /
  Histogram with labels), snapshot-to-dict, Prometheus text renderer.
- :mod:`.spans` — nesting wall-time spans that feed the registry AND enter
  ``utils/profiling.annotate`` (``torch.profiler.record_function``) so
  host scopes and device traces share names; exportable as Chrome trace-event JSON.
- :mod:`.tracing` — per-request ``TraceContext`` (trace_id / span_id /
  parent_id) propagated across serving hops via W3C-traceparent headers
  and stamped onto every span, plus slow-request exemplars.
- :mod:`.flight` — bounded crash-safe ring buffer of structured events,
  dumped on unhandled exception, SIGUSR2, or demand (``/debug/flight``).
- :mod:`.device` — ``device_memory_gauges()`` sampling live device
  memory stats (``torch.cuda``).
- :mod:`.logging` — structured JSON log funnel (``get_logger``): records
  carry trace ids + process identity, mirror into the flight ring, and
  rate-limit per logger; the ONLY sanctioned textual output path.
- :mod:`.watchdog` — heartbeat stall detection for hot loops (all-thread
  stack + flight dumps on stall) and training-health sentinels
  (NaN/divergence/throughput collapse -> ``training_health`` gauge).

``metrics.set_enabled(False)`` turns every instrumentation site in the
framework into a cheap no-op (profiling.py's never-break-the-pipeline
contract). ``ServingServer`` exposes the registry at ``GET /metrics``
and the debug trio at ``/healthz`` / ``/varz`` / ``/debug/flight``.
See docs/observability.md.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      counter, enabled, gauge, get_registry, histogram,
                      reset, safe_counter, safe_gauge, safe_histogram,
                      set_enabled, set_registry)
from .tracing import (REQUEST_ID_HEADER, TRACEPARENT_HEADER,  # noqa: F401
                      TraceContext)
from .spans import (clear_trace, current_span, dump_trace,  # noqa: F401
                    get_trace_events, instant, set_default_attrs, span,
                    span_fn)
from .device import device_memory_gauges  # noqa: F401
from .logging import console, get_logger  # noqa: F401
from . import flight, tracing, watchdog  # noqa: F401
from . import logging as logging  # noqa: F401,PLC0414 — the funnel module

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "get_registry", "set_registry",
    "safe_counter", "safe_gauge", "safe_histogram",
    "reset", "enabled", "set_enabled",
    "span", "span_fn", "instant", "dump_trace", "get_trace_events",
    "clear_trace", "set_default_attrs", "current_span",
    "TraceContext", "TRACEPARENT_HEADER", "REQUEST_ID_HEADER",
    "tracing", "flight", "logging", "watchdog",
    "get_logger", "console",
    "device_memory_gauges",
]
