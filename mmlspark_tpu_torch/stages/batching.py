"""Mini-batching transformers — rows <-> batches.

Counterpart of ``mmlspark_tpu/stages/batching.py``: the reference's batching
stages (reference:
stages/MiniBatchTransformer.scala:14-204 — FixedMiniBatchTransformer:139,
DynamicMiniBatchTransformer:43, TimeIntervalMiniBatchTransformer:66,
FlattenBatch:174; iterator machinery in stages/Batchers.scala:12-131).
Batched columns hold one ndarray/list per row; FlattenBatch inverts. They
bound the shapes fed to the device — FixedMiniBatch with padding keeps one
static shape (what a captured CUDA graph needs), which is why ``padToSize``
exists here but not in the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer


def _batch_column(col, bounds: List[int]):
    out = []
    for i in range(len(bounds) - 1):
        sl = slice(bounds[i], bounds[i + 1])
        if isinstance(col, np.ndarray):
            out.append(col[sl])
        else:
            out.append(list(col[sl]))
    return out


class FixedMiniBatchTransformer(Transformer):
    """Group every ``batchSize`` rows into one batch row
    (reference: MiniBatchTransformer.scala:139)."""

    batchSize = Param("batchSize", "rows per batch", 256, TypeConverters.to_int)
    maxBufferSize = Param("maxBufferSize", "compat no-op (host memory is the buffer)",
                          2147483647, TypeConverters.to_int)
    buffered = Param("buffered", "compat no-op", False, TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        bs = self.get_or_default("batchSize")
        n = len(dataset)
        bounds = list(range(0, n, bs)) + [n]
        return Dataset({k: _batch_column(dataset[k], bounds)
                        for k in dataset.columns})


class DynamicMiniBatchTransformer(Transformer):
    """Batch whatever is available up to ``maxBatchSize`` (streaming semantics;
    reference: MiniBatchTransformer.scala:43). On a materialized dataset this
    yields one batch capped at maxBatchSize per group."""

    maxBatchSize = Param("maxBatchSize", "max rows per batch", 2147483647,
                         TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        bs = min(self.get_or_default("maxBatchSize"), max(len(dataset), 1))
        return FixedMiniBatchTransformer(batchSize=bs).transform(dataset)


class TimeIntervalMiniBatchTransformer(Transformer):
    """reference: MiniBatchTransformer.scala:66 — batches rows arriving within
    ``millisToWait``. Materialized datasets have no arrival times; behaves as a
    single batch (the streaming runtime in io.serving drives real batching)."""

    millisToWait = Param("millisToWait", "batching window", 1000, TypeConverters.to_int)
    maxBatchSize = Param("maxBatchSize", "max rows per batch", 2147483647,
                         TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        return DynamicMiniBatchTransformer(
            maxBatchSize=self.get_or_default("maxBatchSize")).transform(dataset)


class FlattenBatch(Transformer):
    """Invert batching: one row per element (reference: MiniBatchTransformer.scala:174)."""

    def transform(self, dataset: Dataset) -> Dataset:
        cols: Dict[str, list] = {k: [] for k in dataset.columns}
        n = len(dataset)
        for i in range(n):
            row = {k: dataset[k][i] for k in dataset.columns}
            lengths = {len(v) for v in row.values()
                       if isinstance(v, (list, np.ndarray))}
            m = max(lengths) if lengths else 1
            for k, v in row.items():
                if isinstance(v, (list, np.ndarray)) and len(v) == m:
                    cols[k].extend(list(v))
                else:  # scalar or mismatched: replicate
                    cols[k].extend([v] * m)
        out: Dict[str, object] = {}
        for k, vals in cols.items():
            try:
                arr = np.asarray(vals)
                out[k] = arr if arr.dtype != object else vals
            except Exception:
                out[k] = vals
        return Dataset(out)


class PadBatch(Transformer):
    """Pad every batched column to a fixed batch size with a fill value — keeps
    downstream device programs at one static shape (no reference equivalent:
    the JVM never recompiled per shape)."""

    padToSize = Param("padToSize", "target batch size", 256, TypeConverters.to_int)
    fillValue = Param("fillValue", "pad fill", 0.0, TypeConverters.to_float)
    maskCol = Param("maskCol", "output validity-mask column", "__mask",
                    TypeConverters.to_string)

    def transform(self, dataset: Dataset) -> Dataset:
        size = self.get_or_default("padToSize")
        fill = self.get_or_default("fillValue")
        new_cols: Dict[str, list] = {k: [] for k in dataset.columns}
        masks = []
        for i in range(len(dataset)):
            m = None
            for k in dataset.columns:
                v = dataset[k][i]
                if isinstance(v, np.ndarray):
                    m = v.shape[0]
                    pad = [(0, size - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
                    new_cols[k].append(np.pad(v, pad, constant_values=fill))
                elif isinstance(v, list):
                    m = len(v)
                    new_cols[k].append(v + [None] * (size - len(v)))
                else:
                    new_cols[k].append(v)
            mask = np.zeros(size, dtype=np.float32)
            mask[:m if m is not None else size] = 1.0
            masks.append(mask)
        new_cols[self.get_or_default("maskCol")] = masks
        return Dataset(new_cols)


# ---------------------------------------------------------------------------
# Iterator-level batchers (reference: stages/Batchers.scala:12-131) — the
# machinery under the transformers above, exposed for streaming/serving
# consumers that pull from live iterators rather than materialized Datasets.
# ---------------------------------------------------------------------------


def fixed_batches(it, batch_size: int):
    """Plain chunking (FixedBatcher): yield lists of up to ``batch_size``."""
    batch = []
    for x in it:
        batch.append(x)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


class _QueueFeeder:
    """Background producer draining an iterator into a bounded queue.

    One scaffold shared by every buffered batcher, carrying the three
    lifecycle guarantees the naive thread-plus-sentinel pattern lacks:
    a source-iterator exception is re-raised in the CONSUMER (not lost with
    the producer thread, which would hang the consumer forever); a consumer
    that abandons the generator unblocks the producer (no thread pinned on
    a full queue for the life of the process); and the queue is always
    bounded, so a slow consumer exerts backpressure instead of buffering
    the whole source.
    """

    END = object()

    def __init__(self, it, maxsize: int):
        import queue
        import threading
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._abandoned = threading.Event()
        self._error = None
        threading.Thread(target=self._run, args=(it,), daemon=True).start()

    def _put(self, x) -> bool:
        import queue
        while not self._abandoned.is_set():
            try:
                self.q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it) -> None:
        try:
            for x in it:
                if not self._put(x):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._error = e
        self._put(self.END)

    def close(self) -> None:
        self._abandoned.set()

    def finish(self) -> None:
        """Call on END: re-raise the producer's exception, if any."""
        if self._error is not None:
            raise self._error


def fixed_buffered_batches(it, batch_size: int, max_buffer: int = 8):
    """FixedBufferedBatcher: a background thread keeps building fixed-size
    batches into a bounded queue while the consumer processes the previous
    one — producer-side latency overlaps consumer-side compute."""
    feeder = _QueueFeeder(fixed_batches(it, batch_size), max_buffer)
    try:
        while True:
            batch = feeder.q.get()
            if batch is feeder.END:
                feeder.finish()
                return
            yield batch
    finally:
        feeder.close()


def dynamic_buffered_batches(it, max_buffer: int = 1024):
    """DynamicBufferedBatcher: a background thread drains the iterator into
    a buffer; each yielded batch is everything buffered since the consumer
    last asked (>= 1 element). Fast consumers get small batches (low
    latency), slow consumers get big ones (high throughput) — the dynamic
    micro-batching policy the serving path uses."""
    import queue

    feeder = _QueueFeeder(it, max_buffer)
    try:
        while True:
            first = feeder.q.get()
            if first is feeder.END:
                feeder.finish()
                return
            batch = [first]
            while True:
                try:
                    x = feeder.q.get_nowait()
                except queue.Empty:
                    break
                if x is feeder.END:
                    yield batch
                    feeder.finish()
                    return
                batch.append(x)
            yield batch
    finally:
        feeder.close()


def time_interval_batches(it, interval_ms: float, max_batch_size: int = 0,
                          max_buffer: int = 1024):
    """TimeIntervalBatcher: group everything arriving within each
    ``interval_ms`` window (optionally capped at ``max_batch_size``)."""
    import queue
    import time as _time

    feeder = _QueueFeeder(it, max_buffer)
    batch: list = []
    deadline = None
    try:
        while True:
            # yield at the window boundary even when the producer saturates
            # the queue: get(timeout=0) below still returns items whenever
            # the queue is non-empty, so without this check an uncapped
            # batch would grow past the interval instead of closing on time
            if deadline is not None and _time.monotonic() >= deadline:
                if batch:
                    yield batch
                batch, deadline = [], None
            timeout = (None if deadline is None
                       else max(deadline - _time.monotonic(), 0))
            try:
                x = feeder.q.get(timeout=timeout)
            except queue.Empty:
                if batch:
                    yield batch
                batch, deadline = [], None
                continue
            if x is feeder.END:
                if batch:
                    yield batch
                feeder.finish()
                return
            batch.append(x)
            if deadline is None:
                deadline = _time.monotonic() + interval_ms / 1000.0
            if max_batch_size and len(batch) >= max_batch_size:
                yield batch
                batch, deadline = [], None
    finally:
        feeder.close()
