"""Device telemetry: sample live device/host memory stats into gauges.

``utils/profiling.device_memory_stats`` gives a point-in-time view of
each card's memory (the CUDA caching allocator and the CUDA driver);
sampling it into the registry turns that into a series an operator can
watch — device memory growth across boost rounds (the binned-dataset
cache's documented retention, models/gbdt/api.py) shows up as a rising
``device_memory_bytes{stat="bytes_in_use"}`` between scrapes.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional

from . import metrics as _metrics
from .env_registry import env_float

__all__ = ["cuda_initialized", "device_memory_gauges",
           "maybe_sample_device_memory"]

# stat keys worth exporting, the JAX package's names (others stay in the
# returned dict for callers that want them).
_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
              "largest_free_block_bytes", "pool_bytes")


def device_memory_gauges() -> Dict[str, Optional[Dict[str, Any]]]:
    """Sample per-device memory stats into ``device_memory_bytes`` gauges
    (labels: ``device``, ``stat``) and return the raw stats dict.

    No-op (returns ``{}``) while telemetry is disabled; devices whose
    runtime exposes no stats are skipped (profiling already records the
    reason), so this never breaks the run it observes.
    """
    if not _metrics.enabled():
        return {}
    from ..utils import profiling  # lazy: torch only touched when sampling

    stats = profiling.device_memory_stats()
    for dev, ms in stats.items():
        if not ms:
            continue
        for key in _STAT_KEYS:
            v = ms.get(key)
            if v is not None:
                _metrics.safe_gauge("device_memory_bytes",
                                    device=dev, stat=key).set(float(v))
    return stats


def cuda_initialized() -> bool:
    """True when torch is loaded and has initialised CUDA in this process
    (never imports torch, never initialises CUDA): the one gate of every
    device probe, so a process that holds no card never makes a context."""
    torch = sys.modules.get("torch")
    try:
        return bool(torch is not None and torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 — a half-imported torch
        return False


# -- periodic sampling hook --------------------------------------------------
# Before this, device_memory_bytes only moved when a caller remembered to
# invoke device_memory_gauges() — it flatlined between manual calls. The
# watchdog tick and the federation sweep both call the throttled hook
# below, so any process running either loop gets a fresh sample every
# MMLSPARK_TPU_DEVICE_MEMORY_INTERVAL_SECONDS for free.

_INTERVAL_ENV = "MMLSPARK_TPU_DEVICE_MEMORY_INTERVAL_SECONDS"
_sample_lock = threading.Lock()
_last_sample = 0.0


def maybe_sample_device_memory(now: Optional[float] = None) -> bool:
    """Throttled ``device_memory_gauges()``: samples at most once per
    interval knob, only when telemetry is on AND this process has already
    initialised CUDA (a gateway/watchdog host must never create a device
    context just to poll memory it does not hold). Returns True when a
    sample ran."""
    if not _metrics.enabled() or not cuda_initialized():
        return False
    interval = env_float(_INTERVAL_ENV, 30.0)
    if interval <= 0:
        return False
    global _last_sample
    if now is None:
        now = time.monotonic()
    with _sample_lock:
        if now - _last_sample < interval:
            return False
        _last_sample = now
    try:
        device_memory_gauges()
    except Exception:
        return False
    return True
