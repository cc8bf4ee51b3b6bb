"""asyncserve: the event-loop serving plane with continuous batching.

Counterpart of ``mmlspark_tpu/io/aserve``. The threaded stack
(``io/serving.py``) pays one OS thread and one TCP handshake per request
and dequeues fixed ``get_batch`` windows; this package rebuilds the
request plane while keeping the scoring contract byte-compatible:

- :class:`~.server.AsyncServingServer` — a loop-native HTTP/1.1 front
  (``asyncio`` streams, keep-alive, no ``ThreadingHTTPServer``): one
  event loop multiplexes every connection, and each parked request is
  an ``asyncio.Future`` instead of a blocked handler thread.
- **Continuous batching** — requests are admitted into the *forming*
  device batch the moment a slot frees, not at fixed dequeue windows:
  while the scoring thread runs batch N on the device, the loop decodes
  arrivals straight into the next staging buffer, and the instant the
  device frees the scorer takes whatever has formed (the device batch
  never drains and refills).
- :class:`~.slots.SlotTable` — pinned ping-pong staging buffers: rows
  decode once into a pre-allocated pow2-bucket host tensor in the
  predict lane's dtype, so a scoring call does zero Python-side copies
  beyond the one h2d/d2h of ``Booster.predict``.
- **Full contract parity** with the threaded engine: tracing headers +
  ``X-Request-Id`` echo, the shared ``/metrics`` ``/healthz`` ``/varz``
  ``/debug/*`` funnels, deadline propagation, bounded-queue 429 shed,
  SIGTERM drain, and the ``serving.handle`` / ``serving.batch``
  failpoints — the gateway and the existing tests transfer unchanged.

Engine selection: ``MMLSPARK_TPU_SERVING_ENGINE=async|threaded`` — the
async engine is the default (the threaded stack is deprecated and
selecting it warns), overridable per query via
``serve().engine(...)`` and per worker via ``serving_main --engine``.
"""

from __future__ import annotations

import os
from typing import Optional

from ...observability import flight as _flight
from ...observability import metrics as _metrics
from ...observability.logging import get_logger

logger = get_logger("mmlspark_tpu_torch.io.aserve")

ENGINE_ENV = "MMLSPARK_TPU_SERVING_ENGINE"
ENGINES = ("threaded", "async")
#: the engine every unconfigured process gets (the threaded stack is
#: deprecated)
DEFAULT_ENGINE = "async"


def _note_threaded_deprecated(source: str) -> None:
    """Structured deprecation breadcrumbs for an explicit ``threaded``
    selection: a warning through the log funnel plus the
    ``serving_engine_deprecated_total`` counter, so a fleet rollout can
    count how many workers still pin the legacy engine."""
    _metrics.safe_counter("serving_engine_deprecated_total",
                          engine="threaded", source=source).inc()
    logger.warning("serving engine 'threaded' is deprecated; the async "
                   "engine (continuous batching) is the default and the "
                   "threaded stack will be retired — drop the explicit "
                   "selection or migrate", engine="threaded",
                   source=source, default=DEFAULT_ENGINE)


def resolve_engine(requested: Optional[str] = None) -> str:
    """Resolve the serving engine before any server is built.

    An explicit ``requested`` value must be valid (a typo'd flag fails
    loudly); the env-knob path degrades to the default with a flight
    event instead — an operator hint must not kill a worker at boot
    (the ``resolve_hist_blocks`` idiom). Either path selecting the
    deprecated ``threaded`` engine leaves a structured warning.
    """
    if requested is not None:
        if requested not in ENGINES:
            raise ValueError(f"unknown serving engine {requested!r} "
                             f"(known: {list(ENGINES)})")
        if requested == "threaded":
            _note_threaded_deprecated("explicit")
        return requested
    env = (os.environ.get(ENGINE_ENV, "") or DEFAULT_ENGINE)
    env = env.strip().lower()
    if env not in ENGINES:
        _flight.record("serving_engine", decision="fallback_async",
                       requested=env)
        return DEFAULT_ENGINE
    if env == "threaded":
        _note_threaded_deprecated("env")
    return env


from .server import AsyncServingQuery, AsyncServingServer  # noqa: E402
from .slots import SlotTable  # noqa: E402

__all__ = ["AsyncServingQuery", "AsyncServingServer", "SlotTable",
           "resolve_engine", "ENGINE_ENV", "ENGINES", "DEFAULT_ENGINE"]
