"""Device-level hooks for the observability layer, on ``torch.profiler``
and ``torch.cuda``.

Counterpart of the part of ``mmlspark_tpu/utils/profiling.py`` that
observability calls:

- :func:`trace` captures a ``torch.profiler`` trace of everything run
  inside the ``with`` block (host ops, and the card's kernels where CUDA
  is up) into ``log_dir`` as Chrome-trace JSON, viewable in Perfetto.
- :func:`annotate` / :func:`annotate_fn` name host-side regions
  (``torch.profiler.record_function``), so device work launched inside
  them carries the label in a ``torch.profiler`` trace; ``spans.span``
  enters one per span.
- :func:`device_memory_stats` reads live per-device memory from the CUDA
  caching allocator and the CUDA driver, under the stat keys the JAX package
  exports (``observability/device.py``).

Every entry point degrades to a no-op (with the reason logged) rather
than failing the work it instruments.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator, Optional

from ..observability.device import cuda_initialized
from ..observability.logging import get_logger

logger = get_logger(__name__)

__all__ = ["trace", "annotate", "annotate_fn", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of everything run inside the
    ``with`` block into ``log_dir/trace-<pid>.json`` (Chrome-trace format,
    opens in Perfetto): host ops always, the card's kernels too once CUDA
    is initialised. ``create_perfetto_link`` is accepted for the JAX
    signature and does nothing (there is no link to make offline). No-op
    (but still a valid context) if the profiler cannot start, e.g. while
    another trace runs."""
    del create_perfetto_link
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda_initialized():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade to no-op, never break
        logger.warning("profiler trace unavailable (%r); continuing "
                       "untraced", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(log_dir, f"trace-{os.getpid()}.json"))
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler trace export failed: %r", e)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label device work launched in this region: ops dispatched inside show
    up under ``name`` in profiler traces (``torch.profiler.record_function``)."""
    entered = False
    try:
        import torch

        ctx = torch.profiler.record_function(name)
        ctx.__enter__()
        entered = True
    except Exception as e:  # noqa: BLE001 — never break the annotated job
        logger.warning("profiler annotation %r unavailable: %r", name, e)
    try:
        yield
    finally:
        if entered:
            try:
                ctx.__exit__(None, None, None)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler annotation %r exit failed: %r",
                               name, e)


def annotate_fn(name: str):
    """Decorator form of :func:`annotate`."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def _cuda_stats(index: int) -> Dict[str, Any]:
    """One card's stats under the JAX package's keys: the caching
    allocator's live and peak tensor bytes, the bytes it holds from the
    CUDA driver (``pool_bytes``), the card's total memory
    (``bytes_limit``) and the CUDA driver's free bytes
    (``largest_free_block_bytes``, the most one new block could take)."""
    import torch

    ms = torch.cuda.memory_stats(index)
    free, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "largest_free_block_bytes": int(free),
            "pool_bytes": int(ms.get("reserved_bytes.all.current", 0)),
            "num_allocs": int(ms.get("allocation.all.allocated", 0))}


def device_memory_stats() -> Dict[str, Optional[Dict[str, Any]]]:
    """Live per-device memory stats keyed by device string (``cuda:0``, ...;
    keys as :func:`_cuda_stats`). Empty in a process that has not
    initialised CUDA: one that holds no device has nothing to report, and
    asking the CUDA driver would create a context. A card whose stats cannot be
    read maps to ``None``."""
    if not cuda_initialized():
        return {}
    import torch

    out: Dict[str, Optional[Dict[str, Any]]] = {}
    for i in range(torch.cuda.device_count()):
        try:
            out[f"cuda:{i}"] = _cuda_stats(i)
        except Exception as e:  # noqa: BLE001
            logger.warning("memory stats unavailable on cuda:%d: %r", i, e)
            out[f"cuda:{i}"] = None
    return out
