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
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


def prefetch_enabled() -> bool:
    """False when the MMLSPARK_TPU_DISABLE_PREFETCH kill switch is set."""
    return os.environ.get("MMLSPARK_TPU_DISABLE_PREFETCH", "").lower() \
        not in ("1", "true", "yes")


def iter_prefetched(thunks: Iterable[Callable[[], T]], *,
                    depth: int = 1) -> Iterator[T]:
    """Yield ``thunk()`` for each thunk in order, loading ahead on one
    background thread with at most ``depth`` results in flight.

    ``thunks`` may be a lazy generator of zero-argument callables; it is
    advanced only from the calling thread. A thunk that raises re-raises at
    its yield point, in order."""
    if depth <= 0 or not prefetch_enabled():
        for thunk in thunks:
            yield thunk()
        return
    it = iter(thunks)
    pending: deque = deque()
    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="mmlspark-torch-prefetch")
    try:
        while len(pending) < depth:
            thunk = next(it, None)
            if thunk is None:
                break
            pending.append(ex.submit(thunk))
        while pending:
            out = pending.popleft().result()
            # refill before yielding: the next load overlaps the consumer's
            # work on this chunk
            thunk = next(it, None)
            if thunk is not None:
                pending.append(ex.submit(thunk))
            yield out
    finally:
        for fut in pending:
            fut.cancel()
        # an abandoned in-flight read must not outlive its source
        ex.shutdown(wait=True)
