"""Out-of-core dataset ingest: ``.npy`` shards -> the binned device matrix.

Counterpart of ``mmlspark_tpu/models/gbdt/ingest.py`` (reference:
partition files feeding LightGBM's chunked dataset,
lightgbm/LightGBMUtils.scala:201-265). Row shards on disk are read in
bounded host chunks by offset (``ShardedMatrixSource``: no memmaps), each
chunk binned on the device and copied into its column slice of a
preallocated ``[F, n_local]`` bin matrix. Host peak memory is one chunk
(two while the next is prefetched) plus the binner sample; the raw float
matrix never exists whole on the host or the device.

Over a data group of ``k`` ranks each rank reads only its padded row
range ``[r n_pad / k, (r + 1) n_pad / k)`` cut at ``n`` (the slice
:func:`...parallel.placement.shard_rows` keeps in memory); its padding
columns bin zero rows, as the in-memory construct pads, and its labels,
weights and validity mask come from the same range. Rank 0 alone draws
and reads the binner sample and hands the fitted binner to the group.

Binner parity: the quantile binner is fit on exactly the rows the
in-memory path samples (same seed, same ``rng.choice`` draw, gathered from
the files in sorted order; the quantiles do not depend on the order), so
``construct(path=...)`` and ``construct(X)`` give bit-identical bin bounds,
bin matrices and models.

``MMLSPARK_TPU_INGEST_HOST_QUANT=1`` bins each chunk on the host instead
(:func:`.quantize.quantize_features`, the same compare count) and uploads
uint8 bin ids: a quarter of the upload bytes for host time.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...ops.binning import QuantileBinner, bin_cols
from . import quantize as _quantize

PathLike = Union[str, os.PathLike]

INGEST_HOST_QUANT_ENV = "MMLSPARK_TPU_INGEST_HOST_QUANT"


def host_quant_enabled(max_bin: int) -> bool:
    """Whether ingest chunks are binned on the host and uploaded as uint8
    bin ids (``MMLSPARK_TPU_INGEST_HOST_QUANT=1``; needs ``max_bin <=
    256``). Off by default: the host's searchsorted costs more than the
    upload it saves unless the link, not the host, is the bottleneck."""
    raw = os.environ.get(INGEST_HOST_QUANT_ENV, "").strip()
    try:
        on = int(raw or 0) == 1
    except ValueError:
        on = False
    return on and 0 < max_bin <= 256


class _NpyShard:
    """Header metadata for one .npy shard, read without mapping the file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version in ((2, 0), (3, 0)):
                # 2.0 and 3.0 share the header layout (3.0 = utf8 names)
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(
                    f"{path}: unsupported .npy format version {version}")
            self.data_offset = f.tell()
        if fortran:
            raise ValueError(f"{path}: Fortran-order .npy not supported")
        if dtype.hasobject:
            raise ValueError(f"{path}: object arrays not supported")
        self.shape = shape
        self.dtype = dtype
        self.row_items = int(np.prod(shape[1:], dtype=np.int64)) or 1
        self.row_bytes = self.row_items * dtype.itemsize


class ShardedMatrixSource:
    """A logical ``[n, F]`` (or ``[n]``) float array backed by .npy shards.

    Accepts a single ``.npy`` file, a directory of ``.npy`` shards (sorted
    by name — the writer's shard index order), or an explicit list of
    paths. Reads go through offset-based ``np.fromfile`` into fresh
    buffers — deliberately NOT memmaps: touched pages of a long-lived
    mapping stay resident and count toward peak RSS, past the raw data
    size at tens of millions of rows. With plain reads the OS page cache
    stays reclaimable and the process's resident set is the live chunk.
    """

    @classmethod
    def coerce(cls, source) -> "ShardedMatrixSource":
        """Pass through an existing source; wrap a path/list otherwise."""
        return source if isinstance(source, cls) else cls(source)

    def __init__(self, paths: Union[PathLike, Sequence[PathLike]]):
        if isinstance(paths, (str, os.PathLike)):
            p = os.fspath(paths)
            if os.path.isdir(p):
                names = sorted(f for f in os.listdir(p)
                               if f.endswith(".npy"))
                if not names:
                    raise FileNotFoundError(f"no .npy shards in {p}")
                paths = [os.path.join(p, f) for f in names]
            else:
                paths = [p]
        self.paths: List[str] = [os.fspath(p) for p in paths]
        self._shards = [_NpyShard(p) for p in self.paths]
        zero_d = [s.path for s in self._shards if len(s.shape) == 0]
        if zero_d:
            raise ValueError(
                f"0-D .npy shards have no row axis: {zero_d[:3]}")
        trailing = {s.shape[1:] for s in self._shards}
        if len(trailing) != 1:
            raise ValueError(
                f"inconsistent per-row shapes across shards: "
                f"{sorted(trailing)}")
        # GBDT ingest consumes 1-D/2-D; N-D shards (e.g. image batches)
        # serve the streamed-scoring path (io/streaming.py)
        self._lengths = np.array([s.shape[0] for s in self._shards],
                                 dtype=np.int64)
        self._offsets = np.concatenate(
            [[0], np.cumsum(self._lengths)])          # [S+1]

    @property
    def n(self) -> int:
        return int(self._offsets[-1])

    @property
    def ndim(self) -> int:
        return len(self._shards[0].shape)

    @property
    def num_features(self) -> int:
        return int(self._shards[0].shape[1]) if self.ndim == 2 else 1

    @property
    def row_shape(self) -> tuple:
        return tuple(self._shards[0].shape[1:])

    def _read_shard_rows(self, s: int, lo: int, hi: int,
                         dtype=np.float32) -> np.ndarray:
        sh = self._shards[s]
        raw = np.fromfile(sh.path, dtype=sh.dtype,
                          count=(hi - lo) * sh.row_items,
                          offset=sh.data_offset + lo * sh.row_bytes)
        raw = raw.reshape((hi - lo,) + sh.shape[1:])
        return np.asarray(raw, dtype=dtype or sh.dtype)

    def read(self, start: int, stop: int, dtype=np.float32) -> np.ndarray:
        """Rows [start, stop) crossing shard boundaries, coerced to
        ``dtype`` (default float32; ``None`` keeps the stored dtype, as
        integer shards above 2^24 need: a float32 round trip rounds
        them)."""
        start, stop = int(start), int(min(stop, self.n))
        if dtype is None:
            dts = {np.dtype(s.dtype) for s in self._shards}
            if len(dts) > 1:
                raise ValueError(
                    "dtype=None needs a single stored dtype across shards "
                    f"but found {sorted(map(str, dts))}; coercing mixed "
                    "shards silently would reintroduce the float32 "
                    "round-trip this mode exists to avoid")
            dtype = self._shards[0].dtype
        if stop <= start:
            return np.empty((0,) + self.row_shape, dtype)
        out = np.empty((stop - start,) + self.row_shape, dtype)
        self.read_into(out, start, stop)
        return out

    def read_into(self, out: np.ndarray, start: int, stop: int) -> int:
        """Fill ``out[:stop-start]`` with rows [start, stop); returns the
        row count. For float32 C-order shards the bytes land directly in
        ``out`` via ``readinto`` — no intermediate read buffer or dtype
        copy between the file and the caller's chunk."""
        start, stop = int(start), int(min(stop, self.n))
        rows = stop - start
        if rows <= 0:
            return 0
        s0 = int(np.searchsorted(self._offsets, start, side="right")) - 1
        pos = start
        while pos < stop:
            local = pos - int(self._offsets[s0])
            take = min(stop - pos, int(self._lengths[s0]) - local)
            sh = self._shards[s0]
            dst = out[pos - start:pos - start + take]
            if (sh.dtype == dst.dtype and dst.flags.c_contiguous):
                with open(sh.path, "rb") as f:
                    f.seek(sh.data_offset + local * sh.row_bytes)
                    got = f.readinto(memoryview(dst).cast("B"))
                if got != take * sh.row_bytes:
                    raise IOError(f"{sh.path}: short read ({got} bytes)")
            else:
                dst[...] = self._read_shard_rows(s0, local, local + take,
                                                 dtype=dst.dtype)
            pos += take
            s0 += 1
        return rows

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Rows at (sorted or unsorted) global indices.

        Row-at-a-time seek+read per selected row: the binner sample is
        a few hundred thousand rows at most, and scattered single-row
        reads keep resident memory at the output sample size (a memmap
        fancy-index would fault in a page per row and hold it mapped).
        """
        idx = np.asarray(idx, dtype=np.int64)
        shard = np.searchsorted(self._offsets, idx, side="right") - 1
        out = np.empty((idx.size,) + self.row_shape, np.float32)
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            sh = self._shards[s]
            base = int(self._offsets[s])
            with open(sh.path, "rb") as f:
                for j in sel:
                    f.seek(sh.data_offset
                           + (int(idx[j]) - base) * sh.row_bytes)
                    row = np.frombuffer(f.read(sh.row_bytes),
                                        dtype=sh.dtype)
                    out[j] = row.astype(np.float32).reshape(self.row_shape)
        return out


def write_shards(arr_iter, out_dir: PathLike, prefix: str = "part") -> List[str]:
    """Write an iterable of row blocks as numbered .npy shards.

    The datagen-side half of the out-of-core path: callers generate (or
    convert) data one bounded block at a time and never hold the full
    matrix. Returns the shard paths in order.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, block in enumerate(arr_iter):
        p = os.path.join(os.fspath(out_dir), f"{prefix}-{i:05d}.npy")
        np.save(p, np.asarray(block, dtype=np.float32))
        paths.append(p)
    return paths


def csv_to_shards(csv_path: PathLike, out_dir: PathLike, *,
                  label_col: int, num_cols: int = None,
                  weight_col: int = None, shard_rows: int = 1_000_000,
                  skip_header: bool = None,
                  read_bytes: int = 64 << 20):
    """Stream a numeric CSV into .npy feature/label(/weight) shards.

    The bridge from interchange data to the out-of-core path: the file is
    read in bounded byte chunks (cut at line boundaries), parsed by the
    port's C++ CSV reader (``native.csv_read_floats``; bad fields -> NaN;
    it raises if it cannot be built), split into feature vs label/weight
    columns, and
    written as numbered shards of exactly ``shard_rows`` rows (the last
    one smaller) — peak host memory is roughly one read chunk plus one
    shard. Stale ``part-*.npy`` files in the target directories are
    removed first, so re-runs never mix old shards into the dataset.
    Returns ``(x_dir, y_dir, w_dir_or_None)`` ready for
    ``LightGBMDataset.construct(path=..., label_path=...)``.

    ``skip_header=None`` auto-detects: a first line that does not parse as
    numbers is dropped. Reference equivalent: Spark's CSV reader feeding
    partitioned ingestion (the reference gets this from the platform).
    """
    from ...native import csv_read_floats

    if weight_col is not None and weight_col == label_col:
        raise ValueError(
            f"weight_col ({weight_col}) must differ from label_col: the "
            "shared column would be dropped from features once and written "
            "to both y/ and w/, silently training with weights == labels")
    out_dir = os.fspath(out_dir)
    xdir = os.path.join(out_dir, "x")
    ydir = os.path.join(out_dir, "y")
    wdir = os.path.join(out_dir, "w") if weight_col is not None else None

    with open(csv_path, "rb") as f:
        first = f.readline()
        if first.startswith(b"\xef\xbb\xbf"):
            # Excel-style 'CSV UTF-8' BOM would make the first data field
            # non-numeric (and the header auto-detect drop a data row)
            first = first[3:]
            bom = 3
        else:
            bom = 0
        if num_cols is None:
            num_cols = first.count(b",") + 1
        if skip_header is None:
            # the CSV parser maps non-numeric fields to NaN rather than
            # raising, so headers are detected by inspection: any field
            # that is non-empty and non-numeric marks a header line
            def _numeric(p: str) -> bool:
                p = p.strip()
                if not p:
                    return True        # empty field = missing value
                try:
                    float(p)
                    return True
                except ValueError:
                    return False

            parts = first.decode("utf-8", "replace").strip().split(",")
            skip_header = (len(parts) != num_cols
                           or not all(_numeric(p) for p in parts))
        if not skip_header:
            f.seek(bom)

        drop = [label_col] + ([weight_col] if weight_col is not None
                              else [])
        bad = [c for c in drop if not (0 <= c < num_cols)]
        if bad:
            raise ValueError(f"column index {bad} out of range for "
                             f"{num_cols} CSV columns")
        feat_cols = [c for c in range(num_cols) if c not in drop]

        # always clear the w/ layout slot too: a previous weighted run's
        # shards must not survive next to this run's features
        for d in (xdir, ydir, os.path.join(out_dir, "w")):
            if os.path.isdir(d):
                for stale in os.listdir(d):
                    if stale.startswith("part-") and stale.endswith(".npy"):
                        os.unlink(os.path.join(d, stale))
        for d in (xdir, ydir, wdir):
            if d:
                os.makedirs(d, exist_ok=True)

        shard = 0
        pend: list = []              # parsed blocks awaiting shard cuts
        pend_rows = 0
        carry = b""

        def write_shard(block):
            nonlocal shard
            np.save(os.path.join(xdir, f"part-{shard:05d}.npy"),
                    np.ascontiguousarray(block[:, feat_cols]))
            np.save(os.path.join(ydir, f"part-{shard:05d}.npy"),
                    np.ascontiguousarray(block[:, label_col]))
            if wdir:
                np.save(os.path.join(wdir, f"part-{shard:05d}.npy"),
                        np.ascontiguousarray(block[:, weight_col]))
            shard += 1

        def drain(final=False):
            # emit exact shard_rows slices; keep the remainder pending
            nonlocal pend, pend_rows
            if not pend or (pend_rows < shard_rows and not final):
                return
            block = pend[0] if len(pend) == 1 else np.concatenate(pend)
            off = 0
            while block.shape[0] - off >= shard_rows:
                write_shard(block[off:off + shard_rows])
                off += shard_rows
            if final and off < block.shape[0]:
                write_shard(block[off:])
                off = block.shape[0]
            pend = [block[off:]] if off < block.shape[0] else []
            pend_rows = block.shape[0] - off

        while True:
            chunk = f.read(read_bytes)
            if not chunk:
                break
            chunk = carry + chunk
            cut = chunk.rfind(b"\n")
            if cut < 0:
                carry = chunk
                continue
            carry, text = chunk[cut + 1:], chunk[:cut + 1]
            parsed = csv_read_floats(text, num_cols)
            pend.append(parsed)
            pend_rows += parsed.shape[0]
            drain()
        if carry.strip():
            parsed = csv_read_floats(carry, num_cols)
            pend.append(parsed)
            pend_rows += parsed.shape[0]
        drain(final=True)
    if shard == 0:
        raise ValueError(f"{os.fspath(csv_path)}: no data rows parsed")
    return xdir, ydir, wdir


def fit_binner_from_source(src: ShardedMatrixSource, *, max_bin: int,
                           bin_sample_count: int, seed: int,
                           categorical_features=(),
                           max_bin_by_feature=None) -> QuantileBinner:
    """Fit the quantile binner on the same sample the in-memory path draws.

    ``QuantileBinner.fit(X)`` samples ``rng.choice(n, sample_count,
    replace=False)`` when ``n > sample_count``; drawing the identical
    indices here and gathering those rows from the shard files makes the
    out-of-core binner bit-identical to the in-memory one. Host cost is
    the sample (<= bin_sample_count rows), never the dataset.
    """
    binner = QuantileBinner(max_bin, bin_sample_count, seed,
                            categorical_features, max_bin_by_feature)
    n = src.n
    if n > bin_sample_count:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, bin_sample_count, replace=False)
        sample = src.gather(np.sort(idx))
    else:
        sample = src.read(0, n)
    binner.fit(sample)
    binner.num_features = src.num_features
    return binner


def binned_matrix_from_source(src: ShardedMatrixSource,
                              binner: QuantileBinner, bin_dtype: torch.dtype,
                              chunk_rows: int, dev: torch.device,
                              lo0: int, hi0: int, width: int
                              ) -> torch.Tensor:
    """Stream file rows into the binned column-major ``[F, width]`` matrix
    on ``dev``: the matrix is allocated once, then each chunk of
    ``chunk_rows`` rows is read (on the prefetch thread), uploaded and
    binned by :func:`bin_cols` (or quantized on the host, see
    :func:`host_quant_enabled`) into its column slice, in row order on
    the calling thread. Only the file rows ``[lo0, hi0)`` (a rank's
    range) are read; the columns past ``hi0 - lo0`` bin zero rows, the
    padding of the in-memory construct."""
    F = src.num_features
    c = max(1, int(chunk_rows))
    ub = binner.upper_bounds
    ub_t = torch.from_numpy(ub)
    host_quant = host_quant_enabled(binner.max_bin)
    buf = torch.empty((F, width), dtype=bin_dtype, device=dev)
    from ...io.prefetch import iter_prefetched

    def load_chunk(lo: int):
        # a fresh host buffer per chunk: the prefetch thread fills the next
        # one while this one is uploaded
        hi = min(lo + c, width)
        host = np.empty((hi - lo, F), np.float32)
        got = max(0, min(hi, hi0 - lo0) - lo)
        if got:
            src.read_into(host[:got], lo0 + lo, lo0 + lo + got)
        host[got:] = 0.0
        return lo, host

    reads = ((lambda lo=lo: load_chunk(lo)) for lo in range(0, width, c))
    for lo, host in iter_prefetched(reads, site="ingest"):
        hi = lo + host.shape[0]
        if host_quant:
            q = torch.from_numpy(_quantize.quantize_features(host, ub))
            buf[:, lo:hi] = q.to(dev).t().to(bin_dtype)
        else:
            buf[:, lo:hi] = bin_cols(torch.from_numpy(host).to(dev), ub_t,
                                     bin_dtype)
    return buf


def vector_from_source(src: Optional[ShardedMatrixSource], n: int,
                       dev: torch.device, lo: int, hi: int, width: int
                       ) -> Optional[torch.Tensor]:
    """A 1-D label or weight vector read from shards onto ``dev``: the rows
    ``[lo, hi)``, zero-padded to ``width``."""
    if src is None:
        return None
    if src.ndim != 1:
        raise ValueError(f"expected 1-D shards, got ndim={src.ndim}")
    if src.n != n:
        raise ValueError(f"label/weight length {src.n} != feature rows {n}")
    out = np.zeros(width, np.float32)
    src.read_into(out[:hi - lo], lo, hi)
    return torch.from_numpy(out).to(dev)


def construct_from_files(path, label_path, weight_path=None, *,
                         max_bin: int = 255,
                         bin_sample_count: int = 200_000, seed: int = 0,
                         categorical_features=(),
                         bin_dtype="uint8",
                         chunk_rows: int = 262_144,
                         max_bin_by_feature=None,
                         device: DeviceLike = None, mesh=None):
    """Build a :class:`~.booster.LightGBMDataset` on ``device`` (default
    ``cuda``) from on-disk shards. ``bin_dtype`` defaults to ``uint8``
    here (the in-memory path's default is int32): out of core is the
    large-n regime where narrow bin storage is the point. ``mesh`` (a
    data group, default :func:`...parallel.mesh.get_default_mesh`): each
    rank reads and bins only its own padded row range; the result equals
    the in-memory ``construct(X, y, mesh=mesh)``'s slice bit for bit."""
    from ...parallel import mesh as meshlib
    from .booster import LightGBMDataset, _bin_dtype

    dev = resolve_device(device)
    mesh = mesh or meshlib.get_default_mesh()
    bd = _bin_dtype(bin_dtype, max_bin)
    xsrc = ShardedMatrixSource(path)
    if xsrc.ndim != 2:
        raise ValueError("feature shards must be 2-D [rows, features]")
    bad_cats = [int(i) for i in categorical_features
                if not (0 <= int(i) < xsrc.num_features)]
    if bad_cats:
        raise ValueError(
            f"categorical_features indexes {bad_cats} out of range for "
            f"{xsrc.num_features} features")
    ysrc = ShardedMatrixSource(label_path)
    wsrc = (ShardedMatrixSource(weight_path) if weight_path is not None
            else None)
    # the sample is drawn and read on rank 0 alone; every rank gets its
    # binner (the same upper bounds the in-memory construct fits)
    binner = mesh.from_first(lambda: fit_binner_from_source(
        xsrc, max_bin=max_bin, bin_sample_count=bin_sample_count,
        seed=seed, categorical_features=categorical_features,
        max_bin_by_feature=max_bin_by_feature))
    n = xsrc.n
    per = -(-n // mesh.size)
    n_pad = per * mesh.size
    rows = (min(mesh.rank * per, n), min((mesh.rank + 1) * per, n), per)
    Xbt = binned_matrix_from_source(xsrc, binner, bd, chunk_rows, dev,
                                    *rows)
    y = vector_from_source(ysrc, n, dev, *rows)
    vmask = torch.from_numpy(np.ascontiguousarray(meshlib.validity_mask(
        n, n_pad)[mesh.rank * per:(mesh.rank + 1) * per])).to(dev)
    w = vector_from_source(wsrc, n, dev, *rows)
    return LightGBMDataset(binner, Xbt, y, vmask if w is None else w, vmask,
                           n, n_pad, max_bin, categorical_features, mesh)
