"""Streamed scoring over ``.npy`` shards: larger-than-RAM inference.

Counterpart of ``stream_apply`` in ``mmlspark_tpu/io/streaming.py``
(reference: io/binary/BinaryFileReader.scala:20, streamed reads feeding
``mapPartitions`` scorers). Bounded host chunks go through the same scoring
function the in-memory path uses, so streamed outputs equal in-memory ones
by construction. ``Booster.predict_streamed`` and
``predict_contrib_streamed`` run on it, and so do :func:`stream_transform`
(any single-input column Transformer — DNNModel, ImageFeaturizer on decoded
arrays — over array shards) and :func:`stream_featurize_images`
(ImageFeaturizer over a directory of encoded images, decoded on the host
in bounded batches).
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


def stream_transform(stage, source: Union[PathLike, ShardedMatrixSource], *,
                     chunk_rows: int = 8_192,
                     out_dir: Optional[PathLike] = None,
                     input_col: Optional[str] = None,
                     output_col: Optional[str] = None):
    """Run a single-input-column Transformer (DNNModel, ImageFeaturizer on
    decoded arrays, ...) over array shards in bounded chunks.

    Each chunk is wrapped as a one-column Dataset and scored by the stage's
    own ``transform`` — streamed outputs equal in-memory outputs by
    construction. Returns concatenated outputs, or shard paths with
    ``out_dir``.
    """
    from ..core.dataset import Dataset

    in_col = input_col or stage.get_or_default("inputCol")
    out_col = (output_col or stage.get_or_default("outputCol")
               or "output")

    def score(chunk: np.ndarray) -> np.ndarray:
        scored = stage.transform(Dataset({in_col: chunk}))[out_col]
        return scored if isinstance(scored, np.ndarray) else np.stack(
            [np.asarray(v) for v in scored])

    return stream_apply(source, score, chunk_rows=chunk_rows,
                        out_dir=out_dir)


def stream_featurize_images(featurizer, image_dir: str, *,
                            batch_files: int = 256,
                            out_dir: Optional[PathLike] = None,
                            recursive: bool = True,
                            sample_ratio: float = 1.0, seed: int = 0):
    """ImageFeaturizer over a DIRECTORY of encoded images, never holding
    more than ``batch_files`` decoded images: files stream through the host
    decoder (reference: BinaryFileReader.scala:20 / ImageReader) in bounded
    batches, each batch rides the featurizer's device path. Batch i+1 is
    read AND decoded on the prefetch thread while the featurizer scores
    batch i (double-buffered; ``MMLSPARK_TPU_DISABLE_PREFETCH=1`` restores
    the sequential loop) — host decode is the dominant cost at this stage,
    so the overlap hides it behind device compute.

    Returns ``(paths, features)`` — or ``(paths, shard_paths)`` with
    ``out_dir``. Undecodable files are skipped (dropNa semantics) and do
    not appear in ``paths``.
    """
    from ..core.dataset import Dataset
    from ..image.ops import decode_image
    from .binary import _iter_files, read_binary_file

    if batch_files <= 0:
        raise ValueError(f"batch_files must be positive, got {batch_files}")
    featurizer = featurizer.copy({}).set(dropNa=True, inputCol="_img")
    out_col = featurizer.get_or_default("outputCol") or "features"
    shard_paths: List[str] = []
    feats: List[np.ndarray] = []
    kept_paths: List[str] = []
    if out_dir is not None:
        out_dir = os.fspath(out_dir)
        os.makedirs(out_dir, exist_ok=True)

    def load(files):
        # runs on the prefetch thread: disk read + host decode, the two
        # phases worth overlapping with the featurizer's device batch
        batch = [read_binary_file(f) for f in files]
        return ([p for p, _ in batch],
                [decode_image(b) for _, b in batch])

    def flush(loaded, idx):
        paths_b, imgs = loaded
        ds = Dataset({"_img": imgs, "_path": np.asarray(paths_b)})
        scored = featurizer.transform(ds)
        if len(scored) == 0:
            return                 # whole batch undecodable: nothing to emit
        block = np.stack([np.asarray(v) for v in scored[out_col]])
        kept_paths.extend(scored["_path"])
        if out_dir is not None:
            p = os.path.join(out_dir, f"part-{idx:05d}.npy")
            np.save(p, block)
            shard_paths.append(p)
        else:
            feats.append(block)

    def file_batches():
        # lazy file walk (read_binary_files materializes every blob up
        # front — exactly what streaming must avoid); zip members are not
        # expanded here. The rng draw stays on the calling thread so the
        # sampled file set is independent of prefetch.
        rng = np.random.default_rng(seed)
        files: List[str] = []
        for f in _iter_files(image_dir, recursive):
            if sample_ratio < 1.0 and rng.random() >= sample_ratio:
                continue
            files.append(f)
            if len(files) >= batch_files:
                yield (lambda fs=files: load(fs))
                files = []
        if files:
            yield (lambda fs=files: load(fs))

    for idx, loaded in enumerate(
            iter_prefetched(file_batches(), site="featurize_images")):
        flush(loaded, idx)
    if out_dir is not None:
        return kept_paths, shard_paths
    return kept_paths, (np.concatenate(feats, axis=0) if feats
                        else np.zeros((0,), np.float32))
