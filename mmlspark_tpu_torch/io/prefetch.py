"""Bounded double-buffered prefetch for streamed chunk pipelines.

Counterpart of ``mmlspark_tpu/io/prefetch.py``. A streamed path reads chunk
i from disk, then hands it to device work; run strictly in turn, the device
idles during every read and the disk during every dispatch.
:func:`iter_prefetched` loads chunk i+1 on one background thread while
chunk i is consumed: at most ``depth`` loads in flight (default 1, so with
the chunk being consumed no more than two are resident), order kept, and a
loader's exception raised to the consumer at its yield point. Only the
loading moves off the calling thread; the consumer's torch work stays on
it, in order, so streamed outputs are the same with prefetch on or off.

Kill switch: ``MMLSPARK_TPU_DISABLE_PREFETCH=1`` (or ``true``/``yes``) runs
the plain sequential loop.

Observability (the JAX package's families, per ``site``):
``streaming_prefetch_wait_seconds`` histograms how long the consumer
stalled waiting for a load (near zero: full overlap),
``streaming_prefetch_chunks_total`` counts chunks served; each wait is a
``prefetch_wait`` span, each chunk beats the ``prefetch:{site}`` watchdog
heartbeat, and the ``prefetch.chunk`` failpoint injects a failing or slow
load at the consumer's yield point.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

from ..observability import metrics as _metrics
from ..observability import spans as _spans
from ..observability import watchdog as _watchdog
from ..robustness.failpoints import fault_point as _failpoint

T = TypeVar("T")


def prefetch_enabled() -> bool:
    """False when the MMLSPARK_TPU_DISABLE_PREFETCH kill switch is set."""
    return os.environ.get("MMLSPARK_TPU_DISABLE_PREFETCH", "").lower() \
        not in ("1", "true", "yes")


def iter_prefetched(thunks: Iterable[Callable[[], T]], *, depth: int = 1,
                    site: str = "stream") -> Iterator[T]:
    """Yield ``thunk()`` for each thunk in order, loading ahead on one
    background thread with at most ``depth`` results in flight.

    ``thunks`` may be a lazy generator of zero-argument callables; it is
    advanced only from the calling thread. A thunk that raises re-raises at
    its yield point, in order. ``site`` labels the wait and chunk metrics
    per adopter."""
    if depth <= 0 or not prefetch_enabled():
        for thunk in thunks:
            yield thunk()
        return
    it = iter(thunks)
    pending: deque = deque()
    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="mmlspark-torch-prefetch")
    # one beat per chunk served: a reader wedged on a dead filesystem (or a
    # consumer wedged on device work) stops the beat and is flagged
    hb = _watchdog.register(f"prefetch:{site}", stall_seconds=120.0)
    try:
        while len(pending) < depth:
            thunk = next(it, None)
            if thunk is None:
                break
            pending.append(ex.submit(thunk))
        while pending:
            hb.beat()
            # chaos hook: a failing or slow chunk load, raised at the
            # consumer's yield point as a real reader error would be
            _failpoint("prefetch.chunk")
            fut = pending.popleft()
            t0 = time.perf_counter()
            with _spans.span("prefetch_wait", site=site):
                out = fut.result()
            _metrics.safe_histogram("streaming_prefetch_wait_seconds",
                                    site=site).observe(
                time.perf_counter() - t0)
            # refill before yielding: the next load overlaps the consumer's
            # work on this chunk
            thunk = next(it, None)
            if thunk is not None:
                pending.append(ex.submit(thunk))
            _metrics.safe_counter("streaming_prefetch_chunks_total",
                                  site=site).inc()
            yield out
    finally:
        hb.close()
        for fut in pending:
            fut.cancel()
        # an abandoned in-flight read must not outlive its source
        ex.shutdown(wait=True)
