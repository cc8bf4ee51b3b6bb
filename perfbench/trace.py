"""A stretch of the run under ``torch.profiler``, read from its trace.

The device's busy time is the union of its kernels, copies and fills; an
idle gap is named by what the host was doing at its middle: the innermost
annotation open on the host (the port's spans and the benchmark's own enter
``torch.profiler.record_function`` under their names) and the innermost
operation or runtime call.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_OP_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
_TOP = 10


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Profile the ``with`` block; after :meth:`finish` (outside any
    measured window: it exports and reads the trace) ``busy_s``,
    ``window_s``, :meth:`kernel_s`, ``device_ops`` and ``idle_gaps``
    describe it. On a device with no trace (the CPU) ``busy_s`` is 0 and
    the lists are empty."""

    def __init__(self, device: torch.device):
        self.device = device
        self.busy_s = 0.0
        self.window_s = 0.0
        self.device_ops: List[list] = []
        self.idle_gaps: List[list] = []
        self._kernels: List[Tuple[str, float]] = []
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def finish(self) -> None:
        if self._prof is not None:
            self._read()
            self._prof = None

    def kernel_s(self, name_part: str) -> float:
        """Device seconds of the kernels whose name holds ``name_part``."""
        return sum(d for n, d in self._kernels if name_part in n)

    def _events(self):
        """``(category, start us, duration us, name, thread)`` of every
        event: from the profiler's own results, or, where this PyTorch does
        not expose an event's category, from its exported trace."""
        res = self._prof.profiler.kineto_results
        evs = res.events() if res is not None else []
        if evs and hasattr(evs[0], "activity_type"):
            return [(e.activity_type(), e.start_ns() / 1e3,
                     e.duration_ns() / 1e3, e.name(), e.start_thread_id())
                    for e in evs]
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return [(e.get("cat"), float(e["ts"]), float(e["dur"]),
                 e.get("name", "?"), e.get("tid")) for e in doc
                if e.get("ph") == "X" and "dur" in e]

    def _read(self) -> None:
        dev, host = [], []
        by_name: Dict[str, float] = defaultdict(float)
        tids: Dict[object, int] = defaultdict(int)
        for cat, ts, dur, name, tid in self._events():
            if cat in _DEVICE_CATS:
                dev.append((ts, ts + dur))
                by_name[name] += dur / 1e6
                if cat == "kernel":
                    self._kernels.append((name, dur / 1e6))
            elif cat == "user_annotation" or cat in _HOST_OP_CATS:
                host.append((ts, ts + dur, name, cat == "user_annotation",
                             tid))
                if cat == "user_annotation":
                    tids[tid] += 1
        busy = _merge(dev)
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.device_ops = [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:_TOP]]
        if not busy or not host:
            return
        main = max(tids, key=tids.get) if tids else None
        host = sorted((h for h in host if main is None or h[4] == main),
                      key=lambda h: (h[0], -h[1]))
        lo = min(h[0] for h in host)
        hi = max(max(h[1] for h in host), busy[-1][1])
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        idle: Dict[str, float] = defaultdict(float)
        for (a, b), label in zip(gaps, _labels(host, [(a + b) / 2
                                                     for a, b in gaps])):
            idle[label] += (b - a) / 1e6
        self.idle_gaps = [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:_TOP]]


def idle_pct(trace: Optional[DeviceTrace]) -> Optional[float]:
    """The traced stretch's share with nothing on the device, in %; None
    where the trace saw no device (the CPU)."""
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def _labels(host: list, points: List[float]) -> List[str]:
    """For each point (ascending), the innermost annotation and the
    innermost operation open on the host there."""
    starts = [h[0] for h in host]
    out: List[str] = []
    stack: List[tuple] = []
    i = 0
    for p in points:
        j = bisect.bisect_right(starts, p)
        while i < j:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        ann: Optional[str] = None
        op: Optional[str] = None
        for h in reversed(stack):
            if h[1] < p:
                continue
            if h[3] and ann is None:
                ann = h[2]
            if not h[3] and op is None:
                op = h[2]
        out.append(f"{ann or 'no span'} / {op or 'host Python'}")
    return out
