"""Multi-process start-up and barriers on ``torch.distributed``.

Counterpart of ``mmlspark_tpu/parallel/distributed.py``: the reference
bootstraps distributed training with a driver socket that collects each
task's host:port (reference: lightgbm/LightGBMUtils.scala:116-185); the JAX
package calls ``jax.distributed.initialize``; here :func:`initialize` calls
``torch.distributed.init_process_group`` with the same (coordinator
address, process count, process id) triple. Nothing on a machine tells a
process of its cluster, so a caller passes the three (or the ``env://``
variables ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ..device import DeviceLike, resolve_device

_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               device: DeviceLike = None) -> None:
    """Join the process group (a no-op once joined, and on one process).

    ``coordinator_address`` is an init method URL (``tcp://host:port``,
    ``file:///path``) or a bare ``host:port`` (read as ``tcp://``). With no
    argument and no ``env://`` variables the call does nothing, as the JAX
    package's does on a single host; an explicit request that fails
    raises. ``backend`` defaults to ``nccl`` when ``device`` (default
    ``cuda``) is a GPU and ``gloo`` for ``device="cpu"``."""
    if dist.is_initialized():
        _tag_spans_with_process_index()
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and not all(v in os.environ for v in _ENV_VARS):
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=backend, init_method=init_method,
                            **kwargs)
    _tag_spans_with_process_index()


def _tag_spans_with_process_index() -> None:
    """Stamp this process's index onto every later span, flight event and
    log record, so merged multi-process dumps separate by process."""
    try:
        from ..observability import flight as _flight
        from ..observability import logging as _logging
        from ..observability import metrics as _metrics
        from ..observability import spans as _spans
        if not _metrics.enabled():
            return
        idx = process_index()
        _spans.set_default_attrs(process_index=idx)
        _flight.set_default_fields(process_index=idx)
        _logging.set_default_fields(process_index=idx)
        _flight.record("distributed_init", process_index=idx,
                       process_count=process_count())
        _logging.get_logger("mmlspark_tpu_torch.parallel").info(
            "distributed runtime initialized", process_index=idx,
            process_count=process_count())
    except Exception:  # noqa: BLE001 — telemetry must never break init
        pass


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Global barrier across the process group (a no-op on one process).
    Replaces Spark barrier execution mode (reference:
    TrainUtils.scala:476-483). The wait is registered with the watchdog
    (``barrier:{name}``: a peer that never arrives is a stalled barrier),
    runs in a ``barrier.{name}`` span and passes the ``barrier.wait``
    failpoint first."""
    if not dist.is_initialized():
        return
    from ..observability import watchdog as _watchdog
    from ..observability.spans import span as _span
    from ..robustness.failpoints import fault_point as _failpoint
    with _watchdog.register(f"barrier:{name}", stall_seconds=90.0), \
            _span(f"barrier.{name}", metric_label="barrier", barrier=name):
        _failpoint("barrier.wait")
        dist.barrier()
