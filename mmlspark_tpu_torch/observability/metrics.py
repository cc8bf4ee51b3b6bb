"""Process-wide metrics registry: counters, gauges, histograms.

The reference surfaces operational numbers through per-stage StopWatch
scopes (core/utils/StopWatch.scala, stages/Timer.scala:57-92) and VW's
TrainingStats; there is no shared place a serving endpoint or a bench
harness can read them back from. This module is that place for the
rebuild: a thread-safe, label-aware :class:`MetricsRegistry` with a
Prometheus-text renderer, no external dependencies, and a single global
enable flag so every instrumentation site degrades to a cheap no-op
(mirroring utils/profiling.py's never-break-the-pipeline contract).

Conventions:

- metric names match ``[a-z_]+`` (enforced here and by tests/test_lint.py)
  so the Prometheus exposition stays valid without escaping;
- label values are free-form strings;
- histograms default to fixed log-scale latency buckets (100 us .. 60 s).

Usage::

    from mmlspark_tpu_torch.observability import metrics
    metrics.counter("rows_ingested_total", stage="Featurize").inc(n)
    metrics.histogram("serving_request_seconds", api="my_api").observe(dt)
    text = metrics.get_registry().render_prometheus()
"""

from __future__ import annotations

import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram",
    "safe_counter", "safe_gauge", "safe_histogram",
    "get_registry", "set_registry", "reset",
    "enabled", "set_enabled",
    "DEFAULT_BUCKETS", "NOOP",
]

_NAME_RE = re.compile(r"^[a-z_]+$")

# Log-scale (1 / 2.5 / 5 per decade) latency ladder: 100 us to 60 s. Wide
# enough for an in-process transform and a cross-host serving hop alike.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
)


class _Metric:
    """One labeled series. Subclasses hold their own state; all mutation
    goes through the owning registry's lock (cheap: a few ops per call)."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock


class Counter(_Metric):
    """Monotonically increasing count."""

    def __init__(self, lock: threading.Lock):
        super().__init__(lock)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """A value that can go up and down (queue depth, bytes in use)."""

    def __init__(self, lock: threading.Lock):
        super().__init__(lock)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (log-scale latency ladder by default)."""

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(lock)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # linear scan beats bisect for ~18 buckets and typical small values
        i = 0
        n = len(self.buckets)
        while i < n and v > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def bucket_counts(self) -> Dict[float, int]:
        """CUMULATIVE counts keyed by upper bound (+Inf as float('inf'))."""
        with self._lock:
            return self._bucket_counts_locked()

    def _bucket_counts_locked(self) -> Dict[float, int]:
        # caller must hold self._lock (non-reentrant, hence the split —
        # the registry's consistent-scrape read shares this with
        # bucket_counts so cumulative semantics live in one place)
        out: Dict[float, int] = {}
        acc = 0
        for b, c in zip(self.buckets, self._counts):
            acc += c
            out[b] = acc
        out[float("inf")] = acc + self._counts[-1]
        return out


class _NoopMetric:
    """Disabled-path stand-in: accepts every mutation, records nothing."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    sum = 0.0
    count = 0

    def bucket_counts(self) -> Dict[float, int]:
        return {}


NOOP = _NoopMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe family-of-labeled-series store.

    ``counter/gauge/histogram(name, **labels)`` returns the (created-once)
    series for that label set; the same call is both registration and
    lookup, so instrumentation sites stay one-liners.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_items_tuple: metric}, extra)
        self._families: Dict[str, Tuple[str, Dict[Tuple, _Metric], dict]] = {}

    # -- registration / lookup ---------------------------------------------
    def _series(self, kind: str, name: str, labels: Dict[str, str],
                **extra) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match [a-z_]+ (keeps the "
                "Prometheus exposition valid)")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {}, extra)
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested {kind}")
            elif kind == "histogram" and extra.get("buckets") is not None:
                cur = fam[2].get("buckets") or DEFAULT_BUCKETS
                req = tuple(sorted(float(b) for b in extra["buckets"]))
                if req != tuple(sorted(float(b) for b in cur)):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {tuple(cur)}, requested {req}")
            series = fam[1].get(key)
            if series is None:
                if kind == "histogram":
                    series = Histogram(self._lock,
                                       fam[2].get("buckets")
                                       or DEFAULT_BUCKETS)
                else:
                    series = _KINDS[kind](self._lock)
                fam[1][key] = series
            return series

    def counter(self, name: str, /, **labels: Any) -> Counter:
        return self._series("counter", name, labels)  # type: ignore

    def gauge(self, name: str, /, **labels: Any) -> Gauge:
        return self._series("gauge", name, labels)  # type: ignore

    def histogram(self, name: str, /,
                  buckets: Optional[Sequence[float]] = None,
                  **labels: Any) -> Histogram:
        return self._series("histogram", name, labels,  # type: ignore
                            buckets=tuple(buckets) if buckets else None)

    def reset(self) -> None:
        """Drop every family — tests get a clean slate."""
        with self._lock:
            self._families.clear()

    # -- export -------------------------------------------------------------
    def _read_families(self) -> Dict[str, Tuple[str, Dict[Tuple, tuple]]]:
        """Point-in-time copy of every series taken under ONE lock hold, so
        a histogram's count/sum/buckets are mutually consistent (a scrape
        racing observe() must never show _count != the +Inf bucket). Reads
        metric privates directly: bucket_counts() etc. re-acquire the same
        non-reentrant lock."""
        out: Dict[str, Tuple[str, Dict[Tuple, tuple]]] = {}
        with self._lock:
            for name, (kind, series, _) in self._families.items():
                rows: Dict[Tuple, tuple] = {}
                for key, m in series.items():
                    if kind == "histogram":
                        rows[key] = (m._count, m._sum,
                                     m._bucket_counts_locked())
                    else:
                        rows[key] = (m._value,)
                out[name] = (kind, rows)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view (JSON-safe): one entry per family, one series per
        label set. bench.py dumps this next to its BENCH_*.json lines."""
        out: Dict[str, Any] = {}
        for name, (kind, series) in sorted(self._read_families().items()):
            rows: List[Dict[str, Any]] = []
            for key, vals in sorted(series.items()):
                row: Dict[str, Any] = {"labels": dict(key)}
                if kind == "histogram":
                    count, total, buckets = vals
                    row["count"] = count
                    row["sum"] = total
                    row["buckets"] = {_fmt(b): c for b, c in buckets.items()}
                else:
                    row["value"] = vals[0]
                rows.append(row)
            out[name] = {"type": kind, "series": rows}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, (kind, series) in sorted(self._read_families().items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, vals in sorted(series.items()):
                base = dict(key)
                if kind == "histogram":
                    count, total, buckets = vals
                    for b, c in buckets.items():
                        lines.append(_sample(f"{name}_bucket",
                                             {**base, "le": _fmt(b)}, c))
                    lines.append(_sample(f"{name}_sum", base, total))
                    lines.append(_sample(f"{name}_count", base, count))
                else:
                    lines.append(_sample(name, base, vals[0]))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    """Short form for bucket-bound ``le`` labels only ('0.005', '+Inf')."""
    if v == float("inf"):
        return "+Inf"
    return format(v, "g")


def _fmt_value(v: Any) -> str:
    """Full-precision sample value: 'g' would round to 6 significant
    digits, corrupting any counter past ~1e6 (and multi-GB gauges)."""
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _sample(name: str, labels: Dict[str, str], value: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape(str(v))}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


# ---------------------------------------------------------------------------
# Global registry + enable flag
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()
_enabled = True


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (returns the previous one)."""
    global _registry
    prev, _registry = _registry, registry
    return prev


def reset() -> None:
    _registry.reset()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> bool:
    """Flip the global telemetry flag; returns the previous value.

    Disabled means every ``counter/gauge/histogram`` helper returns a
    shared no-op and span recording stops — instrumented code paths keep
    exactly their uninstrumented behavior.
    """
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def counter(name: str, /, **labels: Any) -> Counter:
    if not _enabled:
        return NOOP  # type: ignore[return-value]
    return _registry.counter(name, **labels)


def gauge(name: str, /, **labels: Any) -> Gauge:
    if not _enabled:
        return NOOP  # type: ignore[return-value]
    return _registry.gauge(name, **labels)


def histogram(name: str, /, buckets: Optional[Sequence[float]] = None,
              **labels: Any) -> Histogram:
    if not _enabled:
        return NOOP  # type: ignore[return-value]
    return _registry.histogram(name, buckets=buckets, **labels)


# Never-raising variants for framework instrumentation sites (pipeline
# wrappers, serving workers, request handlers): a registry conflict there
# (kind/bucket mismatch with a name the user registered first) must
# degrade to a no-op, not kill the worker thread or drop a response —
# the never-break-the-pipeline contract. Direct/user call sites should
# keep using counter/gauge/histogram, which raise loudly on misuse.

def safe_counter(name: str, /, **labels: Any) -> Counter:
    try:
        return counter(name, **labels)
    except Exception:
        return NOOP  # type: ignore[return-value]


def safe_gauge(name: str, /, **labels: Any) -> Gauge:
    try:
        return gauge(name, **labels)
    except Exception:
        return NOOP  # type: ignore[return-value]


def safe_histogram(name: str, /, buckets: Optional[Sequence[float]] = None,
                   **labels: Any) -> Histogram:
    try:
        return histogram(name, buckets=buckets, **labels)
    except Exception:
        return NOOP  # type: ignore[return-value]
