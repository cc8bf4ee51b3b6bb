"""Timing utilities: the PyTorch package's copy of
``mmlspark_tpu/utils/stopwatch.py`` (reference: core/utils/StopWatch.scala
and the TrainingStats wall-time scopes at vw/VowpalWabbitBase.scala:27-46)."""

from __future__ import annotations

import time
from typing import Optional


class StopWatch:
    """Accumulating wall-clock timer usable as a context manager."""

    def __init__(self):
        self._total_ns = 0
        self._start: Optional[int] = None

    def start(self) -> "StopWatch":
        self._start = time.perf_counter_ns()
        return self

    def stop(self) -> int:
        if self._start is not None:
            self._total_ns += time.perf_counter_ns() - self._start
            self._start = None
        return self._total_ns

    def restart(self):
        self._total_ns = 0
        self.start()

    def elapsed_ns(self) -> int:
        extra = (time.perf_counter_ns() - self._start) if self._start is not None else 0
        return self._total_ns + extra

    def elapsed_s(self) -> float:
        return self.elapsed_ns() / 1e9

    def measure(self, fn, *args, **kwargs):
        with self:
            return fn(*args, **kwargs)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
