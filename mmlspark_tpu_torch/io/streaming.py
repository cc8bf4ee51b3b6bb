"""Streamed scoring over ``.npy`` shards: larger-than-RAM inference.

Counterpart of ``stream_apply`` in ``mmlspark_tpu/io/streaming.py``
(reference: io/binary/BinaryFileReader.scala:20, streamed reads feeding
``mapPartitions`` scorers). Bounded host chunks go through the same scoring
function the in-memory path uses, so streamed outputs equal in-memory ones
by construction. ``Booster.predict_streamed`` and
``predict_contrib_streamed`` run on it.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Union

import numpy as np

from ..models.gbdt.ingest import PathLike, ShardedMatrixSource
from .prefetch import iter_prefetched


class _ChunkAccumulator:
    """Collects per-chunk outputs into one preallocated ``[total, ...]``
    buffer while they are row-aligned with their inputs (``fn``'s
    contract), so peak host memory is the output plus one chunk; a chunk
    whose rows, shape or dtype do not line up demotes it to collecting a
    list and concatenating at the end."""

    def __init__(self, total_rows: int):
        self.total = total_rows
        self.buf: Optional[np.ndarray] = None
        self.filled = 0
        self.outs: List[np.ndarray] = []

    def add(self, out: np.ndarray, rows_in: int) -> None:
        aligned = (not self.outs and out.shape[0] == rows_in
                   and (self.buf is None
                        or (out.shape[1:] == self.buf.shape[1:]
                            and out.dtype == self.buf.dtype)))
        if aligned:
            if self.buf is None:
                self.buf = np.empty((self.total,) + out.shape[1:],
                                    out.dtype)
            self.buf[self.filled:self.filled + out.shape[0]] = out
            self.filled += out.shape[0]
        else:
            if self.buf is not None:
                # a copy: a view would pin the whole preallocation
                self.outs.append(self.buf[:self.filled].copy())
                self.buf = None
            self.outs.append(out)

    def result(self) -> np.ndarray:
        if self.buf is not None:
            return (self.buf if self.filled == self.total
                    else self.buf[:self.filled])
        return (np.concatenate(self.outs, axis=0) if self.outs
                else np.zeros((0,), np.float32))


def stream_apply(source: Union[PathLike, ShardedMatrixSource],
                 fn: Callable[[np.ndarray], np.ndarray], *,
                 chunk_rows: int = 65_536,
                 out_dir: Optional[PathLike] = None,
                 prefix: str = "part") -> Union[np.ndarray, List[str]]:
    """Apply ``fn(chunk [m, ...]) -> [m, ...]`` over a sharded source in
    bounded row chunks.

    Chunk i+1 is read on a background thread while ``fn`` runs on chunk i
    (:mod:`.prefetch`; ``MMLSPARK_TPU_DISABLE_PREFETCH=1`` turns it off).
    ``fn`` always runs on the calling thread, in chunk order, so outputs
    are the same with prefetch on or off. With ``out_dir`` each chunk's
    output is written as one ``.npy`` shard (``<prefix>-00000.npy``, ...;
    earlier shards of that prefix are removed first) and the paths are
    returned; without it, the outputs land in one array.
    """
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    src = ShardedMatrixSource.coerce(source)
    paths: List[str] = []
    acc = _ChunkAccumulator(src.n)
    if out_dir is not None:
        out_dir = os.fspath(out_dir)
        src_dirs = {os.path.realpath(os.path.dirname(p))
                    for p in src.paths}
        if os.path.realpath(out_dir) in src_dirs:
            raise ValueError(
                f"out_dir {out_dir!r} contains the input shards — the "
                "stale-shard cleanup would delete the source before it is "
                "read; write outputs to a separate directory")
        os.makedirs(out_dir, exist_ok=True)
        for stale in os.listdir(out_dir):
            if stale.startswith(f"{prefix}-") and stale.endswith(".npy"):
                os.unlink(os.path.join(out_dir, stale))
    bounds = [(lo, min(lo + chunk_rows, src.n))
              for lo in range(0, src.n, chunk_rows)]
    reads = ((lambda lo=lo, hi=hi: src.read(lo, hi)) for lo, hi in bounds)
    for i, chunk in enumerate(iter_prefetched(reads, site="stream_apply")):
        out = np.asarray(fn(chunk))
        if out_dir is not None:
            p = os.path.join(out_dir, f"{prefix}-{i:05d}.npy")
            np.save(p, out)
            paths.append(p)
        else:
            acc.add(out, bounds[i][1] - bounds[i][0])
    if out_dir is not None:
        return paths
    return acc.result()
