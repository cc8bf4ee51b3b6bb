"""GBDT training driver, dataset construction and the Booster container.

Counterpart of ``mmlspark_tpu/models/gbdt/booster.py`` for one device:

  * :class:`LightGBMDataset` — quantile-bins once into the device-resident
    column-major ``[F, n]`` matrix tree growth consumes (reference:
    lightgbm/LightGBMDataset.scala:70-159);
  * :func:`train_booster` — the per-iteration host loop (reference:
    TrainUtils.scala:220-315): K trees per iteration for K score columns
    (multiclass), leafwise or depthwise growth, full-precision or
    quantized-gradient histograms, a validation set scored tree by tree
    with early stopping, metric overrides and the training metric; row
    sampling (bagging, stratified bagging, GOSS), random forests and DART
    (:func:`_train_dart`); warm starts from a booster and step-level
    checkpoint resume (:mod:`...utils.checkpoint`);
  * :class:`Booster` — the stacked fixed-shape forest, scoring raw rows on
    the device (``predict_raw`` / ``predict``, categorical splits and the
    missing-value routing of imported models included; ``predict_leaf``;
    ``feature_importances``), saved as ``.npz`` in the JAX package's layout
    and read and written as LightGBM's text model format;
  * the predict plan and the process-wide predictor cache
    (:meth:`Booster.predict_plan`, ``_PREDICT_CACHE``): ``predict`` and
    ``predict_raw`` run one cached program per plan key, which on ``cuda``
    is a CUDA graph captured per shape bucket (:class:`_PredictProgram`).

Sparse scipy feature matrices are densified in row blocks
(:func:`_densify`) before binning and scoring.

The JAX package packs the forest into one int32 buffer before its upload
(``_pack_trees_host``) because each of its transfers crosses a slow link
and its executable takes one flat argument. The port leaves that pack out:
its forest arguments go up once per ``(device, T_pad, lane)`` and stay
resident, so their transfer count is paid once per model, not per call,
and a graph reads them as the separate tensors the traversal gathers from.

On one device the padded row count equals the row count (the JAX package
pads rows only to a multiple of the mesh's shard count), so histogram
subtraction and its ``n // 2`` buffer engage exactly as they do there.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import json
import os
import pickle
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...observability import flight as _flight
from ...observability import hbm as _hbm
from ...observability import metrics as _metrics
from ...observability import roofline as _roofline
from ...observability import spans as _spans
from ...observability import watchdog as _watchdog
from ...observability.logging import console as _console
from ...ops.binning import QuantileBinner, bin_cols
from ...ops.lambdarank import lambdarank_cuda
from ...ops.histogram import (histogram_cols, node_histogram, quant_key,
                              quantize_stats, stats_amax_cuda)
from ...utils import prng
from ...core.dataset import _is_sparse
from ...parallel import mesh as meshlib
from ...parallel import placement
from ...parallel.mesh import Mesh
from ...robustness.failpoints import fault_point as _failpoint
from ... import tuning as _tuning
from ...tuning.decisions import ladder_pad
from . import growth as _growth
from . import quantize as _quantize
from .growth import (GrowConfig, LeafwiseRounds, Tree, _blocked,
                     forest_leaf_nodes, grow_tree, grow_tree_depthwise,
                     host_read, predict_forest_raw, predict_tree_binned,
                     resolve_growth_backend)
from .objectives import (HIGHER_IS_BETTER, SUPPORTED_EVAL_METRICS,
                         QueryGroups, auc_weighted, eval_metric,
                         get_objective, metric_family, score_transform)

_BIN_DTYPES = {"int32": (torch.int32, 1 << 31), "int16": (torch.int16, 1 << 15),
               "uint8": (torch.uint8, 256)}

# elements of the [trees, rows] routing transients predict keeps at once
_PREDICT_BUDGET = 1 << 24

# each tree field's host dtype (the JAX package's layout)
TREE_DTYPES = {"feat": np.int32, "thr_bin": np.int32, "left": np.int32,
               "right": np.int32, "is_leaf": np.bool_,
               "leaf_value": np.float32, "node_count": np.int32,
               "node_grad": np.float32, "node_hess": np.float32,
               "node_cnt": np.float32, "split_gain": np.float32,
               "node_value": np.float32, "cat_bitset": np.uint32}


class _PhaseTimer:
    """Opt-in wall-time phase breakdown of a ``train_booster`` call
    (``MMLSPARK_TPU_TIMING=1``): the reference's per-phase TrainingStats
    diagnostics (vw/VowpalWabbitBase.scala:27-46). A mark on a device
    waits for its queued work first, so each phase's time is its own."""

    def __init__(self):
        self.on = bool(os.environ.get("MMLSPARK_TPU_TIMING"))
        self._t = time.perf_counter() if self.on else 0.0

    def mark(self, name: str, device: Optional[torch.device] = None) -> None:
        if self.on:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            # console, not the JSON funnel: MMLSPARK_TPU_TIMING=1 is an
            # explicit operator request that prints regardless of the
            # telemetry kill switch
            _console(f"[gbdt-timing] {name}: {now - self._t:.3f}s")
            self._t = now


def _ingest_span(construct):
    """``construct`` in a ``gbdt.ingest`` span that records the dataset's
    rows and features (every route: in memory and out of core)."""
    @functools.wraps(construct)
    def spanned(cls, *args, **kwargs):
        with _spans.span("gbdt.ingest", publish=False) as sp:
            ds = construct(cls, *args, **kwargs)
            sp.set(rows=ds.n, features=ds.num_features)
        return ds
    return spanned


def _bin_dtype(bin_dtype, max_bin: int) -> torch.dtype:
    """Bin-id storage dtype: int32 (default), int16 or uint8. Bin ids are
    < max_bin, so narrow storage is lossless within range."""
    name = "int32" if bin_dtype is None else str(bin_dtype)
    if name not in _BIN_DTYPES:
        raise ValueError(
            f"bin_dtype must be one of {sorted(_BIN_DTYPES)}, got {name}")
    dtype, limit = _BIN_DTYPES[name]
    if max_bin > limit:
        raise ValueError(f"bin_dtype={name} holds bin ids < {limit}, but "
                         f"max_bin={max_bin}")
    return dtype


class LightGBMDataset:
    """Pre-binned, device-resident GBDT training dataset: bin once, train
    many. ``n`` rows padded to ``n_pad`` (a multiple of the data group's
    size) are sharded over ``mesh``: this rank holds ``Xbt``, its
    ``[F, n_local]`` slice of the bin matrix, and ``y``, ``w`` and
    ``vmask``, ``[n_local]`` f32 (padding rows have mask and weight 0). On
    one process ``n_local = n_pad = n``. A ranking dataset carries its
    rows' query groups (``queries``, :class:`.objectives.QueryGroups`:
    rows sorted by query, each query any length), else None."""

    def __init__(self, binner: QuantileBinner, Xbt: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor, vmask: torch.Tensor,
                 n: int, n_pad: int, max_bin: int,
                 categorical_features=(), mesh: Optional[Mesh] = None,
                 queries: Optional[QueryGroups] = None):
        self.binner = binner
        self.Xbt = Xbt
        self.y = y
        self.w = w
        self.vmask = vmask
        self.n = n
        self.n_pad = n_pad
        self.max_bin = max_bin
        self.categorical_features = tuple(
            int(i) for i in categorical_features)
        self.mesh = mesh or Mesh()
        self.queries = queries

    @property
    def num_features(self) -> int:
        return int(self.Xbt.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.Xbt.shape[1])

    @property
    def device(self) -> torch.device:
        return self.Xbt.device

    @classmethod
    @_ingest_span
    def construct(cls, X=None, y=None, weight=None, *, max_bin: int = 255,
                  bin_sample_count: int = 200_000, seed: int = 0,
                  bin_dtype=None, max_bin_by_feature=None,
                  row_valid: Optional[np.ndarray] = None,
                  query_offsets: Optional[np.ndarray] = None,
                  categorical_features=(), path=None, label_path=None,
                  weight_path=None, chunk_rows: Optional[int] = None,
                  device: DeviceLike = None, mesh: Optional[Mesh] = None,
                  _timer: Optional["_PhaseTimer"] = None
                  ) -> "LightGBMDataset":
        """Fit the quantile binner on the host (numpy), move the raw rows
        to ``device`` and bin them there into ``[F, n]``. Over a data group
        (``mesh``, default :func:`...parallel.mesh.get_default_mesh`: one
        process unless ``torch.distributed`` is initialised) every rank
        passes the same global rows and fits the binner on the same sample;
        rows are padded to a multiple of the group's size and each rank
        bins and keeps its own slice (:func:`...parallel.placement.
        shard_rows`), padding masked out. ``row_valid``
        ([n], 0 or 1) marks rows that must not count in histograms or
        totals (the ranker's in-group padding); the binner still sees every
        row, as the JAX package's does. ``query_offsets`` ([G + 1], rising
        from 0 to n) marks a ranking dataset's query groups over rows
        sorted by query (one process, in memory: every query whole on the
        one rank). ``categorical_features`` (feature
        indexes) bin as category ids (bin ``c`` holds id ``c``; ids past
        ``max_bin - 1`` share the last bin). A scipy sparse ``X`` is
        densified first (:func:`_densify`).

        Out of core: ``path`` (a ``.npy`` file, a directory of shards or a
        list of paths) with ``label_path`` (and optionally
        ``weight_path``) instead of arrays streams the rows in chunks of
        ``chunk_rows`` (default 262,144) through
        :func:`.ingest.construct_from_files`; bins default to uint8 there
        when ``max_bin <= 256`` (an explicit ``bin_dtype`` is honoured).
        The binner, the bins and so the trees equal the in-memory
        construct's; over a data group each rank reads only its own padded
        row range from the files, and rank 0 alone fits the binner."""
        if path is None and (label_path is not None
                             or weight_path is not None
                             or chunk_rows is not None):
            raise ValueError(
                "label_path/weight_path/chunk_rows only apply with path= "
                "(out-of-core); for in-memory arrays pass y/weight directly")
        mesh = mesh or meshlib.get_default_mesh()
        if not mesh.member:
            raise ValueError(f"this process is not in the data group {mesh}")
        if query_offsets is not None and (path is not None or mesh.size > 1):
            raise ValueError("query_offsets need in-memory rows on one rank "
                             "(a data group pads whole query groups to each "
                             "rank: pass row_valid)")
        if path is not None:
            if X is not None or y is not None or weight is not None:
                raise ValueError(
                    "pass either in-memory arrays or path=..., not both")
            if label_path is None:
                raise ValueError("path= requires label_path=")
            if row_valid is not None:
                raise ValueError("row_valid is not supported with path= "
                                 "(ranker group padding is in-memory only)")
            from .ingest import construct_from_files
            if bin_dtype is None:
                bin_dtype = "uint8" if max_bin <= 256 else "int32"
            _bin_dtype(bin_dtype, max_bin)
            return construct_from_files(
                path, label_path, weight_path, max_bin=max_bin,
                bin_sample_count=bin_sample_count, seed=seed,
                categorical_features=categorical_features,
                bin_dtype=bin_dtype,
                chunk_rows=262_144 if chunk_rows is None else chunk_rows,
                max_bin_by_feature=max_bin_by_feature, device=device,
                mesh=mesh)
        if X is None or y is None:
            raise ValueError(
                "construct needs in-memory arrays (X, y) or file shards "
                "(path=..., label_path=...)")
        dev = resolve_device(device)
        X = np.asarray(_densify(X), dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n, F = X.shape
        if y.shape != (n,):
            raise ValueError(f"y must have shape ({n},), got {y.shape}")
        bad_cats = [int(i) for i in categorical_features
                    if not (0 <= int(i) < F)]
        if bad_cats:
            raise ValueError(
                f"categorical_features indexes {bad_cats} out of range for "
                f"{F} features")
        bd = _bin_dtype(bin_dtype, max_bin)
        tw = _timer or _PhaseTimer()
        # the phases' spans end where the timer's marks fall; the copies
        # wait for the device, the bin apply does not (its device time)
        with _spans.span("gbdt.ingest.binner_fit", publish=False):
            binner = QuantileBinner(max_bin, bin_sample_count, seed,
                                    categorical_features,
                                    max_bin_by_feature).fit(X)
        tw.mark("binner_fit")
        with _spans.span("gbdt.ingest.upload", publish=False):
            placement.plan_for("gbdt.ingest", mesh=mesh, rows=n, device=dev,
                               dtype=str(bd).replace("torch.", ""))
            X_d, _ = placement.shard_rows(X, mesh, device=dev)
        tw.mark("xfer_X", dev)
        with _spans.span("gbdt.ingest.bin_apply", device=dev,
                         publish=False):
            Xbt = bin_cols(X_d, torch.from_numpy(binner.upper_bounds), bd)
            del X_d             # only the bin matrix stays resident
        tw.mark("bin_device", dev)
        with _spans.span("gbdt.ingest.aux", publish=False):
            n_pad = Xbt.shape[1] * mesh.size
            vmask = meshlib.validity_mask(n, n_pad)
            if row_valid is not None:
                vmask[:n] *= np.asarray(row_valid, np.float32)
            vmask_d, _ = placement.shard_rows(vmask, mesh, device=dev)
            y_d, _ = placement.shard_rows(y, mesh, device=dev)
            w_d = (vmask_d if weight is None else placement.shard_rows(
                np.asarray(weight, np.float32), mesh, device=dev)[0])
            queries = (None if query_offsets is None
                       else QueryGroups(query_offsets, y, weight))
        tw.mark("aux_shards", dev)
        return cls(binner, Xbt, y_d, w_d, vmask_d, n, n_pad, max_bin,
                   categorical_features, mesh, queries)


def _densify(X):
    """A scipy sparse matrix (CSR or CSC) as a dense f32 array, filled in
    row blocks of about 8 MB so the host holds the output and one block
    (LGBM_DatasetCreateFromCSR parity, reference:
    lightgbm/LightGBMUtils.scala:227); anything else is returned as is."""
    if not _is_sparse(X):
        return X
    X = X.tocsr()
    n, F = X.shape
    out = np.zeros((n, F), dtype=np.float32)
    step = max(1, (8 << 20) // max(F * 4, 1))
    for start in range(0, n, step):
        out[start:start + step] = X[start:start + step].toarray()
    return out


def _with_tree_defaults(trees: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fill tree fields that older files lack (``node_value`` from
    ``leaf_value``; an all-zero one-word ``cat_bitset``: no categorical
    split) and cast every field to its :data:`TREE_DTYPES` dtype."""
    trees = dict(trees)
    if "node_value" not in trees and "leaf_value" in trees:
        trees["node_value"] = trees["leaf_value"]
    if "cat_bitset" not in trees and "feat" in trees:
        trees["cat_bitset"] = np.zeros(
            (*np.asarray(trees["feat"]).shape, 1), np.uint32)
    return {k: np.asarray(v).astype(TREE_DTYPES[k]) if k in TREE_DTYPES
            else v for k, v in trees.items()}


# --- the fused predictor ----------------------------------------------------
# ``predict`` and ``predict_raw`` run one cached program per plan key: the
# forest traversal over T_pad trees, the mask of trees past t_end, the
# per-class sum, the base score and the optional transform. The forest
# rides as device tensors beside the program, so any Booster of the same
# key reuses it. On cuda the program of a bucketed batch size is a CUDA
# graph captured on its first call (one graph launch per call instead of
# hundreds of eager launches); elsewhere it runs the same body eagerly.

def _pow2_ceil(v: int) -> int:
    """Smallest power of two >= max(1, v)."""
    return 1 << (max(1, int(v)) - 1).bit_length()


# batch sizes up to this are bucketed (padded to a ladder rung) and, on
# cuda, scored through a captured graph; larger batches keep their shape
_GRAPH_MAX_ROWS = 8192


def _to_device(x: torch.Tensor, dev: torch.device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The predict path's ONLY host->device transfer funnel (tests shim it
    to count one upload per scoring call): ``x`` onto ``dev``, or into
    ``out`` there (a graph's static input). Pinned host rows go up without
    blocking the host; the read-back that follows waits for them."""
    nb = dev.type == "cuda" and x.device.type == "cpu" and x.is_pinned()
    if out is not None:
        return out.copy_(x, non_blocking=nb)
    return x.to(dev, non_blocking=nb)


def _from_device(x: torch.Tensor) -> np.ndarray:
    """The predict path's ONLY device->host transfer funnel."""
    return x.cpu().numpy()


def _forest_routing(forest: dict, cat_max_bin: int,
                    missing: bool = True) -> dict:
    """The keyword options of :func:`forest_leaf_nodes` for a forest's
    tensors: the categorical mask and bitsets where the model has
    categorical features, the LightGBM missing-value bytes of imported
    models (``missing=False``: without them, NaN left). ``cat_max_bin`` 0
    routes categories strictly (``FindInBitset``: models without a
    binner)."""
    kw = {}
    if forest["is_cat"] is not None:
        kw.update(is_cat=forest["is_cat"], cat_bitset=forest["bits"],
                  cat_max_bin=cat_max_bin)
    if missing and forest["mdec"] is not None:
        kw["missing_dec"] = forest["mdec"]
    return kw


def _forest_margins(forest: dict, X: torch.Tensor, K: int, depth_cap: int,
                    routing: dict, lane: str,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw margins ``[n, K]`` f32 of every tree of ``forest`` on staged rows
    ``X`` (tree ``t`` scores class ``t % K``), plus the base score. Trees
    are added one at a time, in order, so every device rounds the same
    sums the same way. ``active`` ([T] f32, 1 below ``t_end`` and 0 past
    it) masks the trees a bucket holds beyond the ones asked for: a leaf
    times 1 is the leaf, and an added masked 0 leaves an f32 sum as it was,
    so the margins equal those of the first ``t_end`` trees alone for
    finite leaves. A non-finite leaf past ``t_end`` gives NaN under the
    mask (inf * 0), as it does in the JAX program."""
    T = forest["feat"].shape[0]
    leaf = (forest["leaf"] if lane != "int8" else
            _quantize.dequantize_leaves(forest["qleaf"], forest["scale"]))
    n = X.shape[0]
    per_class = torch.zeros((K, n), dtype=torch.float32, device=X.device)
    rows = max(1, _PREDICT_BUDGET // max(T, 1))
    for s in range(0, n, rows):
        vals = predict_forest_raw(
            forest["feat"], forest["thr"], forest["left"], forest["right"],
            forest["is_leaf"], leaf, X[s:s + rows], depth_cap,
            **routing)                                          # [T, r]
        if active is not None:
            vals = vals * active[:, None]
        for t in range(T):
            per_class[t % K, s:s + rows] += vals[t]
    return per_class.t() + forest["base"][None, :]


def _forest_nbytes(forest: dict) -> float:
    """Device bytes a forest-argument dict pins (the ``packed_trees``
    HBM-ledger claim)."""
    return float(sum(v.numel() * v.element_size() for v in forest.values()
                     if isinstance(v, torch.Tensor)))


# the process-wide predictor cache: keyed on (device, plan key), NEVER on a
# Booster, so a serving worker's reloaded model, or a num_iteration sweep,
# reuses programs (and their captured graphs) instead of building anew
_PREDICT_CACHE: "OrderedDict" = OrderedDict()
_PREDICT_CACHE_MAX = 64
_PREDICT_CACHE_LOCK = threading.Lock()
# one capture at a time in the process, the growth rounds' included: the
# allocator's capture pools and the warm-up side stream are simplest to
# reason about serialized
_CAPTURE_LOCK = _growth._CAPTURE_LOCK
# forest-argument identities: a graph copies a forest in when the serial
# of the forest it last copied differs. A serial is this process's random
# 64-bit prefix and a counter, so a forest made in another process (a
# pickled Booster's, were its device state kept) never takes another's
# serial here
_SERIAL_PREFIX = int.from_bytes(os.urandom(8), "little")
_FOREST_COUNTER = itertools.count(1)


def _next_forest_serial() -> Tuple[int, int]:
    return (_SERIAL_PREFIX, next(_FOREST_COUNTER))

# guards each Booster's LRUs of device arguments (check, then insert or
# evict)
_DEVICE_ARGS_LOCK = threading.Lock()


class _PredictProgram:
    """The fused scoring program of one plan key on one device.

    Graph route (``cuda`` and ``n_pad <= 8192``, the bucketed sizes): the
    first call (:meth:`prepare`) allocates static buffers — the forest
    for ``T_pad`` trees, the ``active`` mask, the ``[n_pad, F]`` input in
    the lane's staged dtype — warms the body up on a side stream and
    captures it into a ``torch.cuda.CUDAGraph``. A call then copies its
    rows into the static input, zero-pads the rest, replays and reads
    back ``[:n]``. Larger batches come in exact shapes that rarely repeat,
    and the memory a graph's pool pins grows with its batch, so they run
    the same body eagerly on the rows as they come (one program object per
    key all the same), as every call on the CPU does. A failed capture
    raises: nothing scores eagerly in a graph's place.

    Captured pointers: a graph bakes in the addresses of the buffers it
    read at capture, while the cache is shared by every Booster of one
    key. So the program owns static forest buffers, and before a replay
    for a forest other than the one last copied in (a forest's serial), it
    copies that forest in, device to device — else a second model of the
    same key would score with the first model's trees.

    Concurrent replays: a graph and its static buffers are not reentrant,
    and several threads reach one entry at once (the threaded engine,
    in-process gateway workers on one Booster). A per-entry lock spans
    copy-in, replay and read-back. The capture runs in
    ``capture_error_mode="thread_local"``, so a probe thread reading
    ``torch.cuda`` meanwhile does not break it.

    Host work inside the captured region: the body makes no ``.item()``,
    ``.cpu()``, ``nonzero`` or boolean-mask index, and rows are staged
    (the int8 lane's bin apply, whose bounds stay resident per device)
    before they reach the static input, outside the graph."""

    def __init__(self, key: tuple, device: torch.device, T_pad: int,
                 n_pad: int, num_features: int, K: int, depth_cap: int,
                 cat_max_bin: int, lane: str, transform):
        self.key, self.device = key, device
        self.T_pad, self.n_pad, self.F, self.K = T_pad, n_pad, num_features, K
        self.depth_cap, self.cat_max_bin = depth_cap, cat_max_bin
        self.lane, self.transform = lane, transform
        self.graph_route = device.type == "cuda" and n_pad <= _GRAPH_MAX_ROWS
        self._lock = threading.Lock()
        self._graph = None
        self._static: Optional[dict] = None
        self.pinned_bytes = 0

    def _body(self, forest: dict, active: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
        raw = _forest_margins(forest, X, self.K, self.depth_cap,
                              _forest_routing(forest, self.cat_max_bin),
                              self.lane, active)
        return raw if self.transform is None else self.transform(raw)

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def prepare(self, forest: dict, active: torch.Tensor,
                t_end: int) -> None:
        """Capture the graph against static copies of ``forest`` and
        ``active`` (graph route; nothing to do on the eager route)."""
        if not self.graph_route or self._graph is not None:
            return
        dev = self.device
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            before = torch.cuda.memory_reserved(dev)
            st = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in forest.items()}
            st_active = active.clone()
            x = torch.zeros((self.n_pad, self.F),
                            dtype=_quantize.staging_dtype(self.lane),
                            device=dev)
            # warm-up on a side stream (allocator pools, lazy kernel
            # loads), as torch.cuda.graphs asks, then the capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._body(st, st_active, x)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._body(st, st_active, x)
            torch.cuda.synchronize(dev)
            # the static buffers and the graph's private pool
            self.pinned_bytes = torch.cuda.memory_reserved(dev) - before
        self._static = {"forest": st, "serial": forest["serial"],
                        "active": st_active, "t_end": t_end, "x": x,
                        "out": out}
        self._graph = graph

    def __call__(self, forest: dict, active: torch.Tensor, t_end: int,
                 stage_rows: Callable) -> np.ndarray:
        """Score one batch: ``stage_rows(out)`` performs the call's one
        upload (into ``out`` when given) and returns the staged device
        rows ``[n, F]``. Returns the host result ``[:n]``."""
        if not self.graph_route:
            # no padding: rows score independently, and the CPU's
            # vectorized elementwise loops round a row by where it falls
            # in the batch, so only the rows as they came match the eager
            # body bit for bit
            with _spans.span("gbdt.predict.upload", publish=False):
                X = stage_rows(None)
            with _spans.span("gbdt.predict.traverse", device=self.device,
                             publish=False):
                out = self._body(forest, active, X)
            with _spans.span("gbdt.predict.readback", publish=False):
                return _from_device(out)
        with self._lock:
            st = self._static
            if st["serial"] != forest["serial"]:
                for k, v in st["forest"].items():
                    if isinstance(v, torch.Tensor):
                        v.copy_(forest[k])
                st["serial"] = forest["serial"]
            if st["t_end"] != t_end:
                st["active"].copy_(active)
                st["t_end"] = t_end
            # ping-pong slot rows: a pinned slot buffer is copied into the
            # static input without blocking, on the stream the replay runs
            # on; the read-back below waits for both, so the caller
            # rewrites that buffer only after this call returns
            n = stage_rows(st["x"]).shape[0]
            if n > self.n_pad:
                raise ValueError(f"{n} rows do not fit the program's "
                                 f"{self.n_pad}")
            if n < self.n_pad:
                st["x"][n:].zero_()        # as the JAX package's np.pad
            self._graph.replay()
            return _from_device(st["out"][:n])


def _build_predict_program(key: tuple, device: torch.device, T_pad: int,
                           n_pad: int, num_features: int, K: int,
                           depth_cap: int, cat_max_bin: int, transform,
                           predict_dtype: str) -> "_PredictProgram":
    """The fused scoring program of one plan on ``device`` (JAX
    ``booster.py:539-586``): all ``T_pad`` trees, the ``active`` mask, the
    per-class sum, the base score and ``transform`` (None: raw margins)."""
    return _PredictProgram(key, device, T_pad, n_pad, num_features, K,
                           depth_cap, cat_max_bin, predict_dtype, transform)


class _ObservedProgram:
    """Cache entry that makes the capture observable: its first call
    prepares the program (the capture, on the graph route) and records a
    flight ``compile`` event with the key and wall seconds
    (``persistent_cache=""``: the port keeps no compile cache), feeds
    ``gbdt_compiles_total`` / ``gbdt_compile_seconds``, notes the card's
    name for the roofline's peaks and registers the program in the
    roofline ledger. Its bytes accessed are reckoned from the plan (forest
    arguments, the batch, the ``[n_pad, K]`` result); its FLOPs are None,
    since torch has no ``cost_analysis``. While metrics are on, each call
    is timed (copy-in to read-back) into ``observe_call``."""

    __slots__ = ("_prog", "_key", "_key_hash", "_lock", "_dtype", "_ready")

    def __init__(self, prog: _PredictProgram, key, dtype=None):
        self._prog = prog
        self._key = key
        self._key_hash = predict_key_hash(key)
        self._lock = threading.Lock()
        self._dtype = dtype
        self._ready = False

    @property
    def program(self) -> _PredictProgram:
        return self._prog

    def _bytes_accessed(self, forest: dict) -> float:
        p = self._prog
        item = torch.empty((), dtype=_quantize.staging_dtype(p.lane)
                           ).element_size()
        return (_forest_nbytes(forest) + 4.0 * p.T_pad
                + float(p.n_pad * p.F * item) + 4.0 * p.n_pad * p.K)

    def prepare(self, forest: dict, active: torch.Tensor, t_end: int,
                observed: bool = True) -> float:
        """Prepare once (serialized: two threads on a cold entry must not
        both capture). ``observed=False`` is the bundle prewarm: no
        ``compile`` event or compile counter, as the JAX prewarm's
        deserialize-and-compile records none. Returns the seconds taken
        (0.0 when it was ready)."""
        with self._lock:
            if self._ready:
                return 0.0
            t0 = time.perf_counter()
            self._prog.prepare(forest, active, t_end)
            dt = time.perf_counter() - t0
            self._ready = True
        p = self._prog
        if p.device.type == "cuda":
            _roofline.note_device_kind(torch.cuda.get_device_name(p.device))
        if observed:
            _metrics.safe_counter("gbdt_compiles_total",
                                  cache="predict").inc()
            _metrics.safe_histogram("gbdt_compile_seconds",
                                    cache="predict").observe(dt)
            _flight.record("compile", cache="predict", key=repr(self._key),
                           seconds=round(dt, 6), persistent_cache="",
                           device=str(p.device), graph=p.captured,
                           pinned_bytes=p.pinned_bytes)
        _roofline.register_executable(
            self._key_hash, kind="predict", flops=None,
            bytes_accessed=self._bytes_accessed(forest), compile_seconds=dt,
            label="gbdt_predict" if observed else "gbdt_predict(prewarm)",
            dtype=self._dtype)
        return dt

    def __call__(self, forest: dict, active: torch.Tensor, t_end: int,
                 stage_rows: Callable) -> np.ndarray:
        if not self._ready:
            self.prepare(forest, active, t_end)
        if not _metrics.enabled():
            return self._prog(forest, active, t_end, stage_rows)
        t0 = time.perf_counter()
        out = self._prog(forest, active, t_end, stage_rows)
        # the call ends in a blocking read-back, so this is device time
        # plus the call's host work
        _roofline.observe_call(self._key_hash, time.perf_counter() - t0)
        return out


def _predict_program(cache_key, build: Callable, dtype=None
                     ) -> _ObservedProgram:
    """Get-or-build in the bounded process-wide predictor cache, counting
    ``gbdt_predict_cache_{hits,misses}_total``."""
    with _PREDICT_CACHE_LOCK:
        fn = _PREDICT_CACHE.get(cache_key)
        if fn is not None:
            _PREDICT_CACHE.move_to_end(cache_key)
    if fn is None:
        _metrics.safe_counter("gbdt_predict_cache_misses_total").inc()
        with _spans.span("gbdt_predict_build"):
            fn = _ObservedProgram(build(), cache_key[1], dtype=dtype)
        with _PREDICT_CACHE_LOCK:
            fn = _PREDICT_CACHE.setdefault(cache_key, fn)
            _PREDICT_CACHE.move_to_end(cache_key)
            while len(_PREDICT_CACHE) > _PREDICT_CACHE_MAX:
                _PREDICT_CACHE.popitem(last=False)
    else:
        _metrics.safe_counter("gbdt_predict_cache_hits_total").inc()
    return fn


def preload_predict_program(key, fn, dtype=None,
                            device: DeviceLike = None) -> bool:
    """Install a prepared program under plan key ``key`` on ``device``
    (default ``cuda``) — the serving-bundle prewarm path: a worker fills
    the cache, graphs captured, before its first request. Never clobbers a
    live entry; returns whether the preload took. Counted apart from hits
    and misses (``gbdt_predict_cache_preloads_total``)."""
    cache_key = (str(resolve_device(device)), key)
    with _PREDICT_CACHE_LOCK:
        if cache_key in _PREDICT_CACHE:
            return False
    if not isinstance(fn, _ObservedProgram):
        raise TypeError(f"preload_predict_program takes a prepared "
                        f"program, got {type(fn).__name__}")
    with _PREDICT_CACHE_LOCK:
        if cache_key in _PREDICT_CACHE:      # lost a race
            return False
        _PREDICT_CACHE[cache_key] = fn
        while len(_PREDICT_CACHE) > _PREDICT_CACHE_MAX:
            _PREDICT_CACHE.popitem(last=False)
    _metrics.safe_counter("gbdt_predict_cache_preloads_total").inc()
    return True


def predict_key_hash(key) -> str:
    """Stable content hash of a predictor cache key (sha256 of its
    ``repr``): the name a bundle stores a program's plan under. Equal to
    the JAX package's for an equal key."""
    return hashlib.sha256(repr(key).encode("utf-8")).hexdigest()


class PredictPlan(NamedTuple):
    """One fused predict program's identity and its factory, shared by the
    online path (:meth:`Booster._predict_device`) and the bundle build, so
    the two never disagree on a key. ``make_program(device)`` returns the
    (not yet captured) program for that device."""

    key: tuple
    t_end: int
    n_pad: int
    T_pad: int
    num_features: int
    make_program: Callable
    predict_dtype: str = "f32"


def iter_predict_plans(booster: "Booster", batch_sizes,
                       num_iterations=(-1,), transforms=(True,),
                       dtypes=("f32",)):
    """Yield ``(meta, plan)`` for every DISTINCT predict program a serving
    deployment of ``booster`` dispatches to over the given batch sizes,
    iteration counts, transforms and lanes — the one enumeration the key
    manifest and the bundle build share. Batch sizes in one bucket, and a
    lane the model degrades into f32, dedupe; the meta records the
    effective lane."""
    seen = set()
    for dt in dtypes:
        for transformed in transforms:
            for it in num_iterations:
                for b in batch_sizes:
                    plan = booster.predict_plan(int(b), int(it),
                                                transformed=transformed,
                                                predict_dtype=dt)
                    if plan.key in seen:
                        continue
                    seen.add(plan.key)
                    yield ({"batch_size": int(b), "num_iteration": int(it),
                            "transformed": bool(transformed),
                            "predict_dtype": plan.predict_dtype}, plan)


def predict_key_manifest(booster: "Booster", batch_sizes,
                         num_iterations=(-1,),
                         transformed: bool = True) -> List[Dict]:
    """The (batch bucket x iteration) predictor keys a serving deployment
    of ``booster`` dispatches to, with their hashes: what a bundle's
    manifest pins."""
    return [{**meta, "n_pad": plan.n_pad, "t_pad": plan.T_pad,
             "key_hash": predict_key_hash(plan.key)}
            for meta, plan in iter_predict_plans(
                booster, batch_sizes, num_iterations,
                transforms=(transformed,))]


def _freeze_kwargs(kwargs: dict):
    """Hashable rendering of objective kwargs for the cache key (a JSON
    round trip turns tuples into lists); never passed back to the
    objective."""
    def freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze(x)) for k, x in v.items()))
        if isinstance(v, np.ndarray):
            return ("ndarray", v.dtype.str, v.shape, v.tobytes())
        return v
    return tuple(sorted((k, freeze(v)) for k, v in kwargs.items()))


class Booster:
    """A trained GBDT ensemble: fixed-shape trees stacked on a leading
    ``[T]`` axis, held as numpy on the host and uploaded to a device on
    first use there.

    ``missing_dec`` ([T, M] uint8 LightGBM decision_type bytes: bit 1
    default-left, bits 2-3 the missing type) is set only for models read
    from LightGBM text whose splits store other missing-value handling than
    this package's own (NaN left); None routes NaN left."""

    def __init__(self, trees: Dict[str, np.ndarray], thr_raw: np.ndarray,
                 num_class: int, base_score, objective: str, depth_cap: int,
                 binner_state: Optional[dict] = None, best_iteration: int = -1,
                 eval_history: Optional[Dict[str, List[float]]] = None,
                 objective_kwargs: Optional[dict] = None,
                 missing_dec: Optional[np.ndarray] = None):
        trees = _with_tree_defaults(trees)
        missing = [f for f in Tree._fields if f not in trees]
        if missing:
            raise ValueError(f"tree arrays lack fields {missing}")
        self.trees = {f: trees[f] for f in Tree._fields}
        self.thr_raw = np.asarray(thr_raw, dtype=np.float32)
        self.num_class = int(num_class)
        self.base_score = np.asarray(base_score, dtype=np.float32).reshape(-1)
        self.objective = objective
        # a list (the ranker's label_gain after a JSON round trip) is held
        # as the tuple the estimator fitted with
        self.objective_kwargs = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in (objective_kwargs or {}).items()}
        self.depth_cap = int(depth_cap)
        self.binner_state = binner_state
        self.best_iteration = int(best_iteration)
        self.eval_history = eval_history or {}
        self.missing_dec = (None if missing_dec is None
                            else np.asarray(missing_dec, np.uint8))
        self._dev_forest: Dict[Tuple[str, str], dict] = {}
        get_objective(objective, self.num_class, **self.objective_kwargs)

    # the device state a Booster builds on demand: uploaded forests (each
    # plan forest with its serial), active masks, the int8 lane's bounds
    _DEVICE_STATE = ("_dev_forest", "_plan_forest", "_dev_active",
                     "_dev_bounds")

    def __getstate__(self):
        """The host state only, as the JAX package's ``__getstate__``:
        device tensors would not unpickle on a host without the device, and
        a forest's serial belongs to the process that uploaded it. The
        predictor cache is process-wide, so an unpickled Booster reuses its
        programs."""
        return {k: v for k, v in self.__dict__.items()
                if k not in self._DEVICE_STATE}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._dev_forest = {}

    @property
    def num_trees(self) -> int:
        return int(self.trees["feat"].shape[0])

    @property
    def num_iterations(self) -> int:
        return self.num_trees // self.num_class

    @property
    def num_features(self) -> int:
        return int(self.binner_state["upper_bounds"].shape[0])

    def _cat_max_idx(self) -> int:
        """Largest category bin id: the binner's last bin (the catch-all of
        a model trained here), else the bitsets' last bit."""
        mb = (self.binner_state or {}).get("max_bin") or 0
        if mb > 0:
            return mb - 1
        return int(self.trees["cat_bitset"].shape[-1]) * 32 - 1

    def _cat_strict(self) -> bool:
        """Models without a binner (read from LightGBM text) route
        categories by ``FindInBitset``: ids outside the bitset and NaN go
        right."""
        return ((self.binner_state or {}).get("max_bin") or 0) <= 0

    def _is_cat(self) -> Optional[np.ndarray]:
        """[F] bool mask of categorical features, or None if there is
        none."""
        cats = (self.binner_state or {}).get("categorical_features") or ()
        if self.binner_state is None or not cats:
            return None
        F = self.num_features
        cats = [int(i) for i in cats if 0 <= int(i) < F]
        if not cats:
            return None
        m = np.zeros(F, dtype=bool)
        m[np.asarray(cats, dtype=int)] = True
        return m

    def _forest_on(self, dev: torch.device, lane: str = "f32") -> dict:
        """The routing arrays, base score, categorical bitsets and mask,
        missing-value bytes and node values on ``dev``, with the
        thresholds and leaves of predict lane ``lane``
        (:mod:`.quantize`): f32; bf16 thresholds; uint8 bin-id thresholds
        and int8 leaves with their per-tree scales (``qleaf``, ``scale``).
        Uploaded once per device and lane. Bitsets go up as int64
        words."""
        key = (str(dev), lane)
        ent = self._dev_forest.get(key)
        if ent is not None:
            return ent
        base = self._dev_forest.get((str(dev), "f32"))
        if base is None:
            base = self._upload_forest(dev, "f32", self.num_trees,
                                       node_value=True)
            self._dev_forest[(str(dev), "f32")] = base
        if lane == "f32":
            return base
        ent = dict(base)
        ent.update(self._lane_arrays(dev, lane, self.num_trees))
        self._dev_forest[key] = ent
        return ent

    def _lane_arrays(self, dev: torch.device, lane: str, T: int) -> dict:
        """The thresholds and leaves of the first ``T`` trees in a narrow
        lane: uint8 bin-id thresholds with int8 leaves and per-tree scales
        (int8), or bf16 thresholds (bf16)."""
        if lane == "int8":
            q, scale = _quantize.quantize_leaves(
                self.trees["leaf_value"][:T])
            return {"thr": torch.from_numpy(_quantize.quantize_thresholds(
                        self.thr_raw[:T], self.trees["feat"][:T],
                        _quantize.feature_bounds(self.binner_state))).to(dev),
                    "qleaf": torch.from_numpy(q).to(dev),
                    "scale": torch.from_numpy(scale).to(dev), "leaf": None}
        return {"thr": _quantize.cast_thresholds_bf16(
            self.thr_raw[:T]).to(dev)}

    def _upload_forest(self, dev: torch.device, lane: str, T: int,
                       node_value: bool = False) -> dict:
        """The first ``T`` trees' routing arrays, leaves (or the lane's),
        base score, categorical mask and bitsets (int64 words) and
        missing-value bytes, uploaded to ``dev``."""
        t = self.trees
        fields = [("feat", t["feat"]), ("thr", self.thr_raw),
                  ("left", t["left"]), ("right", t["right"]),
                  ("is_leaf", t["is_leaf"]), ("leaf", t["leaf_value"])]
        if node_value:
            fields.append(("node_value", t["node_value"]))
        ent = {k: torch.tensor(a[:T], device=dev) for k, a in fields}
        ent["base"] = torch.tensor(self.base_score, device=dev)
        is_cat = self._is_cat()
        ent["is_cat"] = (None if is_cat is None
                         else torch.tensor(is_cat, device=dev))
        ent["bits"] = (None if is_cat is None else torch.tensor(
            t["cat_bitset"][:T].astype(np.int64), device=dev))
        ent["mdec"] = (None if self.missing_dec is None
                       else torch.tensor(
                           self.missing_dec[:T].astype(np.int64),
                           device=dev))
        if lane != "f32":
            ent.update(self._lane_arrays(dev, lane, T))
        return ent

    def _device_forest_args(self, T_pad: int, predict_dtype: str,
                            dev: torch.device) -> dict:
        """The plan's forest arguments for the first ``T_pad`` trees in
        lane ``predict_dtype`` on ``dev``: uploaded once per ``(device,
        T_pad, lane)``, held in a bounded LRU of 4 (a learning-curve
        sweep over every t_end must not pin O(T^2) of device memory) and
        claimed on the HBM ledger as ``packed_trees``. Each carries a
        ``serial``: a captured graph copies a forest in when its serial
        differs from the last one it read."""
        ck = (str(dev), T_pad, predict_dtype)
        with _DEVICE_ARGS_LOCK:     # serving threads share one Booster
            cache = self.__dict__.setdefault("_plan_forest", OrderedDict())
            ent = cache.get(ck)
            if ent is None:
                ent = self._upload_forest(dev, predict_dtype, T_pad)
                ent["serial"] = _next_forest_serial()
                _hbm.claim("packed_trees", _forest_nbytes(ent))
                cache[ck] = ent
                while len(cache) > 4:
                    _k, old = cache.popitem(last=False)
                    _hbm.release("packed_trees", _forest_nbytes(old))
            else:
                cache.move_to_end(ck)
            return ent

    def _device_active(self, T_pad: int, t_end: int,
                       dev: torch.device) -> torch.Tensor:
        """``[T_pad]`` f32 mask on ``dev`` selecting the trees below
        ``t_end``."""
        key = (str(dev), T_pad, t_end)
        with _DEVICE_ARGS_LOCK:
            cache = self.__dict__.setdefault("_dev_active", OrderedDict())
            a = cache.get(key)
            if a is None:
                a = torch.from_numpy((np.arange(T_pad) < t_end)
                                     .astype(np.float32)).to(dev)
                cache[key] = a
                while len(cache) > 8:
                    cache.popitem(last=False)
            else:
                cache.move_to_end(key)
            return a

    def _tree_bucket(self, t_end: int) -> int:
        """Tree-count bucket of the predictor cache: the full model keeps
        its exact count; a partial ``t_end`` (num_iteration sweeps,
        best_iteration scoring) rounds its iterations up to a power of two,
        so a sweep meets log2 programs; the trees past ``t_end`` are masked
        by ``active``."""
        T_full = self.num_trees
        if t_end >= T_full:
            return T_full
        bucket = self.num_class * _pow2_ceil(t_end // self.num_class)
        return T_full if bucket >= T_full else bucket

    def predict_plan(self, n: int, num_iteration: int = -1,
                     transformed: bool = True,
                     num_features: Optional[int] = None,
                     predict_dtype: Optional[str] = None) -> PredictPlan:
        """The predict program a batch of ``n`` rows dispatches to: its
        cache key (element for element the JAX package's, so
        :func:`predict_key_hash` agrees across the packages) and what
        builds it. Host only: no device work and no capture happen here.

        Batches up to 8192 rows pad to a bucket — the tuner's measured
        ladder when one is decided, else the next power of two — so a
        server's varying batch sizes meet a bounded set of programs;
        larger batches keep their exact size. Both the ladder and the lane
        are resolved before the key exists."""
        if num_iteration is None or num_iteration < 0:
            num_iteration = self.num_iterations
        t_end = min(num_iteration * self.num_class, self.num_trees)
        ladder = _tuning.resolve_bucket_ladder()
        if 0 < n <= _GRAPH_MAX_ROWS:
            n_pad = (ladder_pad(n, ladder) if ladder
                     else 1 << (n - 1).bit_length())
        else:
            n_pad = max(n, 1)
        T_pad = self._tree_bucket(t_end)
        M = int(self.trees["feat"].shape[1])
        BW = int(self.trees["cat_bitset"].shape[-1])
        bs = self.binner_state or {}
        cat_max_bin = int(bs.get("max_bin") or 0)
        F_bin = (int(bs["upper_bounds"].shape[0]) if "upper_bounds" in bs
                 else int(num_features or 0))
        if num_features is None:
            num_features = F_bin
        predict_dtype = _quantize.resolve_predict_dtype(
            predict_dtype, has_mdec=self.missing_dec is not None,
            max_bin=cat_max_bin)
        spec_key = transform = None
        if transformed:
            spec_key = (self.objective, self.num_class,
                        _freeze_kwargs(self.objective_kwargs))
            transform = score_transform(self.objective, self.num_class,
                                        **self.objective_kwargs)
        # the key records only whether the optional arguments exist
        has_cat = any(0 <= int(i) < F_bin for i in
                      (bs.get("categorical_features") or ()))
        has_mdec = self.missing_dec is not None
        key = (T_pad, M, BW, n_pad, int(num_features), self.num_class,
               self.depth_cap, cat_max_bin, has_cat, has_mdec,
               predict_dtype, spec_key)
        depth_cap, K, F = self.depth_cap, self.num_class, int(num_features)
        return PredictPlan(
            key=key, t_end=t_end, n_pad=n_pad, T_pad=T_pad, num_features=F,
            make_program=lambda dev: _build_predict_program(
                key, dev, T_pad, n_pad, F, K, depth_cap, cat_max_bin,
                transform, predict_dtype),
            predict_dtype=predict_dtype)

    def predict_plan_args(self, plan: PredictPlan,
                          device: DeviceLike = None) -> tuple:
        """``(forest, active)``: the device arguments ``plan``'s program is
        called with on ``device`` (what the bundle prewarm captures
        against)."""
        dev = resolve_device(device)
        return (self._device_forest_args(plan.T_pad, plan.predict_dtype,
                                         dev),
                self._device_active(plan.T_pad, plan.t_end, dev))

    def _rows_host(self, X, lane: str) -> torch.Tensor:
        """Rows as a tensor ready for the call's one upload: a tensor as it
        is (slot-table rows already in the lane's staged dtype, or rows
        already on a device); uint8 arrays as the int8 lane's bin ids;
        bf16 for the bf16 lane; else f32 (the int8 lane bins f32 rows on
        the device)."""
        if isinstance(X, torch.Tensor):
            return X
        X = _densify(X)
        if (lane == "int8" and isinstance(X, np.ndarray)
                and X.dtype == np.uint8):
            return torch.from_numpy(np.ascontiguousarray(X))
        if lane == "bf16":
            return _quantize.cast_features_bf16(X)
        return torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))

    def _predict_device(self, X, num_iteration: int, transformed: bool,
                        predict_dtype: Optional[str] = None,
                        device: DeviceLike = None) -> np.ndarray:
        """The one scoring path of :meth:`predict` and :meth:`predict_raw`: the
        plan, the forest arguments (resident after the first call), the
        cached program, ONE upload (:func:`_to_device`; into the graph's
        static input on the graph route) and ONE read-back
        (:func:`_from_device`) of ``[n, K]`` (``[n]`` transformed, K=1)."""
        dev = resolve_device(device)
        with _spans.span("gbdt.predict", publish=False) as sp:
            with _spans.span("gbdt.predict.plan", publish=False):
                lane = self.resolved_predict_dtype(predict_dtype)
                rows = self._rows_host(X, lane)
                width = (self.num_features if self.binner_state is not None
                         else rows.shape[-1])
                if rows.dim() != 2 or rows.shape[1] != width:
                    raise ValueError(f"rows must be [n, {width}], got "
                                     f"{list(rows.shape)}")
                n = int(rows.shape[0])
                plan = self.predict_plan(n, num_iteration, transformed,
                                         num_features=int(rows.shape[1]),
                                         predict_dtype=lane)
                forest = self._device_forest_args(
                    plan.T_pad, plan.predict_dtype, dev)
                active = self._device_active(plan.T_pad, plan.t_end, dev)
                fn = _predict_program((str(dev), plan.key),
                                      lambda: plan.make_program(dev),
                                      dtype=plan.predict_dtype)
            want = _quantize.staging_dtype(plan.predict_dtype)

            def stage_rows(out: Optional[torch.Tensor]) -> torch.Tensor:
                dst = None if out is None else out[:n]
                if rows.dtype == want:
                    return _to_device(rows, dev, dst)
                staged = self._staged(_to_device(rows, dev),
                                      plan.predict_dtype)
                return staged if dst is None else dst.copy_(staged)

            sp.set(rows=n, graph=int(fn.program.graph_route))
            return fn(forest, active, plan.t_end, stage_rows)

    def _cat_max_bin(self) -> int:
        """The routing's categorical bin bound: the binner's ``max_bin``
        (ids clip into the last bin), or 0 for models without a binner,
        which route categories strictly."""
        return 0 if self._cat_strict() else self._cat_max_idx() + 1

    def resolved_predict_dtype(self, requested: Optional[str] = None) -> str:
        """The predict lane this model scores in for ``requested`` (None:
        ``MMLSPARK_TPU_PREDICT_DTYPE``): :func:`.quantize.
        resolve_predict_dtype` with this model's missing-value routing and
        bin grid."""
        return _quantize.resolve_predict_dtype(
            requested, has_mdec=self.missing_dec is not None,
            max_bin=int((self.binner_state or {}).get("max_bin") or 0))

    def _staged(self, X: torch.Tensor, lane: str) -> torch.Tensor:
        """Rows ``X`` in ``lane``'s staged dtype on their device: rows
        already in it pass through; f32 rows are quantized to bin ids by
        the bin apply of training (:func:`bin_cols`, the compare count of
        :func:`.quantize.quantize_features`) or cast to bf16."""
        want = _quantize.staging_dtype(lane)
        if X.dtype == want:
            return X
        if lane == "int8":
            # the bounds stay resident per device: an upload per call would
            # block the host
            bounds = self.__dict__.setdefault("_dev_bounds", {})
            ub = bounds.get(str(X.device))
            if ub is None:
                ub = bounds[str(X.device)] = torch.from_numpy(
                    _quantize.feature_bounds(self.binner_state)).to(X.device)
            return bin_cols(X.to(torch.float32), ub, torch.uint8).t()
        return X.to(want)

    def predict_raw_tensor(self, X: torch.Tensor, num_iteration: int = -1,
                           predict_dtype: Optional[str] = None
                           ) -> torch.Tensor:
        """Raw margins ``[n, num_class]`` f32 for rows ``X`` ([n, F]) on
        ``X``'s device: every tree's leaf value, summed per class (tree
        ``t`` scores class ``t % num_class``), plus the base score.
        ``predict_dtype`` picks the lane (:meth:`resolved_predict_dtype`);
        ``X`` may come in the lane's staged dtype (uint8 bin ids, bf16) or
        as f32 rows.

        This is the eager body: the predict program runs the same
        :func:`_forest_margins` over its bucket. Trees are added one at a
        time, in order, so every device rounds the same sums the same way:
        the margins are bit-identical on the CPU and the GPU, and with the
        program's."""
        if num_iteration is None or num_iteration < 0:
            num_iteration = self.num_iterations
        t_end = min(num_iteration * self.num_class, self.num_trees)
        lane = self.resolved_predict_dtype(predict_dtype)
        X = self._staged(X, lane)
        ent = self._forest_on(X.device, lane)
        forest = {k: (v[:t_end] if isinstance(v, torch.Tensor)
                      and k not in ("base", "is_cat") else v)
                  for k, v in ent.items()}
        return _forest_margins(forest, X, self.num_class, self.depth_cap,
                               _forest_routing(forest, self._cat_max_bin()),
                               lane)

    def _rows_on(self, X, device: DeviceLike,
                 lane: str = "f32") -> torch.Tensor:
        """Host rows uploaded to ``device`` for ``lane`` (:meth:`_rows_host`;
        from pinned memory without blocking the host, since the caller's
        read of the results waits for the upload)."""
        dev = resolve_device(device)
        X = self._rows_host(X, lane)
        return X.to(dev, non_blocking=dev.type == "cuda"
                    and X.device.type == "cpu" and X.is_pinned())

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    device: DeviceLike = None,
                    predict_dtype: Optional[str] = None) -> np.ndarray:
        """Raw margin scores: ``[n, num_class]`` (num_class=1 for binary and
        regression), computed on ``device`` (default ``cuda``) in predict
        lane ``predict_dtype`` (``f32``/``bf16``/``int8``; None reads
        ``MMLSPARK_TPU_PREDICT_DTYPE``; see :mod:`.quantize`), through the
        plan's cached program (:meth:`_predict_device`)."""
        return self._predict_device(X, num_iteration, transformed=False,
                                    predict_dtype=predict_dtype,
                                    device=device)

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                device: DeviceLike = None,
                predict_dtype: Optional[str] = None) -> np.ndarray:
        """Transformed prediction: ``[n]`` (probability for binary), or
        ``[n, num_class]`` softmax probabilities for multiclass; the lane
        as :meth:`predict_raw`, the transform in f32 inside the same
        program."""
        return self._predict_device(X, num_iteration, transformed=True,
                                    predict_dtype=predict_dtype,
                                    device=device)

    def predict_streamed(self, source, *, chunk_rows: int = 262_144,
                         out_dir=None, num_iteration: int = -1,
                         raw: bool = False, device: DeviceLike = None,
                         predict_dtype: Optional[str] = None):
        """Score ``.npy`` feature shards in bounded row chunks (out-of-core
        inference, :func:`...io.streaming.stream_apply`): each chunk runs
        :meth:`predict` (``raw``: :meth:`predict_raw`), so the streamed
        scores equal the in-memory ones bit for bit. Returns the scores,
        or the output shard paths with ``out_dir``."""
        from ...io.streaming import stream_apply

        method = self.predict_raw if raw else self.predict
        return stream_apply(
            source, lambda c: method(c, num_iteration, device=device,
                                     predict_dtype=predict_dtype),
            chunk_rows=chunk_rows, out_dir=out_dir)

    def predict_contrib_streamed(self, source, *, chunk_rows: int = 16_384,
                                 out_dir=None, method: str = "treeshap",
                                 device: DeviceLike = None):
        """:meth:`predict_contrib` over ``.npy`` feature shards in bounded
        row chunks; contributions are row-independent, so the result equals
        the in-memory one bit for bit. The output is ``(F + 1) * K`` wide,
        hence the smaller default chunk."""
        from ...io.streaming import stream_apply

        if method not in ("treeshap", "saabas"):
            # checked before stream_apply clears an existing out_dir
            raise ValueError(
                f"unknown contribution method {method!r}; expected "
                "'treeshap' or 'saabas'")
        return stream_apply(
            source, lambda c: self.predict_contrib(c, method=method,
                                                   device=device),
            chunk_rows=chunk_rows, out_dir=out_dir)

    # -- introspection -------------------------------------------------------
    def _check_missing_routing(self, X: np.ndarray) -> None:
        """``predict_contrib`` and ``predict_leaf`` route NaN left and zeros
        by the threshold. For imported models that store other
        missing-value handling (``missing_dec``), inputs that would take
        those rules raise rather than route differently from
        ``predict``/``predict_raw``."""
        if self.missing_dec is None:
            return
        # the float32 view the routing traverses: f64 values that underflow
        # to 0.0 in f32 must not slip the check
        X = np.asarray(X, dtype=np.float32)
        mt = (self.missing_dec >> 2) & 3
        internal = ~np.asarray(self.trees["is_leaf"])
        if (bool(((mt == 1) & internal).any())
                and (np.abs(X) <= 1e-35).any()):
            raise NotImplementedError(
                "predict_contrib/predict_leaf do not implement "
                "zero-as-missing routing for imported models; use "
                "predict()/predict_raw()")
        if np.isnan(X).any():
            raise NotImplementedError(
                "predict_contrib/predict_leaf route NaN left "
                "unconditionally, but this imported model stores different "
                "missing handling; impute NaNs or use "
                "predict()/predict_raw()")

    def predict_contrib(self, X: np.ndarray, method: str = "treeshap",
                        device: DeviceLike = None) -> np.ndarray:
        """Per-feature contributions ``[n, (F + 1) * num_class]``: per class
        block F values, then the bias (the expected value), summing to the
        raw margin (reference: ``featuresShapCol``,
        lightgbm/LightGBMBooster.scala:250-269).

        ``method="treeshap"``: exact Shapley values of the cover-conditional
        value function, f64. On ``cuda`` (the default) the fixed-shape
        device engine (:mod:`.treeshap_device`), on ``cpu`` the host engine
        (:mod:`.treeshap`: the native C++ recursion, numpy where it rejects
        a tree); ``MMLSPARK_TPU_SHAP_HOST=1`` / ``MMLSPARK_TPU_SHAP_DEVICE=1``
        force either. ``method="saabas"``: path attribution on ``device``
        (each split's change in expected node value goes to its feature),
        f32; it sums to the margin too but is not Shapley on correlated
        features."""
        X = np.asarray(_densify(X), dtype=np.float32)
        self._check_missing_routing(X)
        dev = resolve_device(device)
        if method == "treeshap":
            force_host = os.environ.get("MMLSPARK_TPU_SHAP_HOST") == "1"
            force_dev = os.environ.get("MMLSPARK_TPU_SHAP_DEVICE") == "1"
            if force_dev or (dev.type == "cuda" and not force_host):
                from .treeshap_device import shap_values_device
                return shap_values_device(self, X, device=dev)
            from .treeshap import shap_values
            return shap_values(self, X)
        if method != "saabas":
            raise ValueError(
                f"unknown contribution method {method!r}: use 'treeshap' "
                "(exact) or 'saabas' (approximate)")
        return self._saabas(torch.from_numpy(X).to(dev)).cpu().numpy()

    def _saabas(self, X: torch.Tensor) -> torch.Tensor:
        """Saabas contributions ``[n, (F + 1) * K]`` f32 on ``X``'s device:
        each tree's rows walk ``depth_cap`` steps; a step from an internal
        node adds the child's node value minus the node's to the split
        feature. Per tree the steps sum into ``[rows, F]`` first, then the
        trees into their class in tree order (the JAX package's scan)."""
        ent = self._forest_on(X.device)
        T, K = self.num_trees, self.num_class
        n, F = X.shape
        routing = _forest_routing(ent, self._cat_max_bin(), missing=False)
        csum = torch.zeros((K, n, F), dtype=torch.float32, device=X.device)
        feat, left, right = (ent[k].long() for k in ("feat", "left", "right"))
        nv, is_leaf, thr = ent["node_value"], ent["is_leaf"], ent["thr"]
        rows = max(1, _PREDICT_BUDGET // max(T * F, 1))
        for s in range(0, n, rows):
            Xs = X[s:s + rows]
            r = Xs.shape[0]
            node = torch.zeros((T, r), dtype=torch.long, device=X.device)
            contrib = torch.zeros((T, r, F), dtype=torch.float32,
                                  device=X.device)
            for _ in range(self.depth_cap):
                internal = ~is_leaf.gather(1, node)            # [T, r]
                f = torch.where(internal, feat.gather(1, node), 0)
                # one routing step; a row at a leaf stays there
                nxt = forest_leaf_nodes(
                    feat, thr, left, right, is_leaf, Xs, 1, start=node,
                    **routing)
                delta = torch.where(internal, nv.gather(1, nxt)
                                    - nv.gather(1, node), 0.0)
                contrib.scatter_add_(2, f[:, :, None], delta[:, :, None])
                node = nxt
            for t in range(T):
                csum[t % K, s:s + r] += contrib[t]
        rsum = torch.zeros(K, dtype=torch.float32, device=X.device)
        for t in range(T):
            rsum[t % K] += nv[t, 0]
        out = torch.zeros((n, (F + 1) * K), dtype=torch.float32,
                          device=X.device)
        for k in range(K):
            out[:, k * (F + 1):k * (F + 1) + F] = csum[k]
            out[:, k * (F + 1) + F] = ent["base"][k] + rsum[k]
        return out

    def predict_leaf(self, X: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
        """The node slot each row reaches in each tree: ``[n, T]`` int32
        (predLeaf parity, reference: lightgbm/LightGBMBooster.scala:250-269),
        routed on ``device`` (default ``cuda``)."""
        X32 = np.asarray(_densify(X), dtype=np.float32)
        self._check_missing_routing(X32)
        Xt = self._rows_on(X32, device)
        ent = self._forest_on(Xt.device)
        T = self.num_trees
        routing = _forest_routing(ent, self._cat_max_bin(), missing=False)
        out = torch.empty((Xt.shape[0], T), dtype=torch.int32,
                          device=Xt.device)
        rows = max(1, _PREDICT_BUDGET // max(T, 1))
        for s in range(0, Xt.shape[0], rows):
            out[s:s + rows] = forest_leaf_nodes(
                ent["feat"], ent["thr"], ent["left"], ent["right"],
                ent["is_leaf"], Xt[s:s + rows], self.depth_cap,
                **routing).t().to(torch.int32)
        return out.cpu().numpy()

    def feature_importances(self, importance_type: str = "split"
                            ) -> np.ndarray:
        """Per-feature importances over the internal nodes: ``split``
        counts, ``gain`` sums split gains (reference:
        LightGBMBooster.scala:306)."""
        out = np.zeros(self.num_features, dtype=np.float64)
        internal = ~self.trees["is_leaf"]
        feats = self.trees["feat"][internal]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, self.trees["split_gain"][internal])
        else:
            raise ValueError(f"importance_type must be split|gain, got "
                             f"{importance_type}")
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """``.npz`` in the JAX package's layout (``tree_<field>``, bitsets
        as uint32 ``[T, M, BW]``, ``thr_raw``, ``base_score``,
        ``binner_upper_bounds``, ``missing_dec`` where set,
        ``meta_json``)."""
        if self.binner_state is None:
            raise ValueError("a booster without a binner state cannot be "
                             "saved")
        arrays = {f"tree_{k}": v for k, v in self.trees.items()}
        arrays["thr_raw"] = self.thr_raw
        arrays["base_score"] = self.base_score
        arrays["binner_upper_bounds"] = self.binner_state["upper_bounds"]
        if self.missing_dec is not None:
            arrays["missing_dec"] = self.missing_dec
        bs = self.binner_state
        meta = dict(
            num_class=self.num_class, objective=self.objective,
            objective_kwargs=self.objective_kwargs, depth_cap=self.depth_cap,
            best_iteration=self.best_iteration, eval_history=self.eval_history,
            binner=dict(max_bin=bs["max_bin"],
                        sample_count=bs["sample_count"], seed=bs["seed"],
                        num_features=bs["num_features"],
                        categorical_features=list(
                            bs.get("categorical_features") or []),
                        max_bin_by_feature=bs.get("max_bin_by_feature"),
                        feature_names=bs.get("feature_names")))
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "Booster":
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            trees = {k: z[f"tree_{k}"] for k in Tree._fields
                     if f"tree_{k}" in z}
            binner_state = dict(meta["binner"])
            binner_state["upper_bounds"] = z["binner_upper_bounds"]
            thr_raw, base = z["thr_raw"], z["base_score"]
            mdec = z["missing_dec"] if "missing_dec" in z else None
        return Booster(trees, thr_raw, meta["num_class"], base,
                       meta["objective"], meta["depth_cap"], binner_state,
                       meta["best_iteration"], meta["eval_history"],
                       meta.get("objective_kwargs") or {}, missing_dec=mdec)

    def to_lightgbm_string(self) -> str:
        """The model as LightGBM's ``tree`` v3 text format, which any
        LightGBM tooling loads (saveNativeModel parity, reference:
        LightGBMClassifier.scala:172-194, LightGBMBooster.scala:289)."""
        from .lgbm_format import to_lightgbm_string
        return to_lightgbm_string(self)

    @staticmethod
    def from_lightgbm_string(s: str) -> "Booster":
        """Read a LightGBM text model (written by LightGBM or by
        :meth:`to_lightgbm_string`). The base score is 0: LightGBM folds
        any init score into the first iteration's leaves. The binner is a
        stub with ``max_bin=0``, so categorical splits route strictly."""
        from .lgbm_format import parse_lightgbm_string
        (trees, thr_raw, K, objective, kwargs, F,
         cat_features, missing_dec) = parse_lightgbm_string(s)
        M = trees.feat.shape[1]
        depth_cap = max(1, (M + 1) // 2 - 1)
        binner_state = dict(upper_bounds=np.zeros((F, 1), np.float32),
                            max_bin=0, sample_count=0, seed=0,
                            num_features=F,
                            categorical_features=list(cat_features))
        return Booster(trees._asdict(), thr_raw, K, np.zeros(K, np.float32),
                       objective, depth_cap, binner_state,
                       objective_kwargs=kwargs, missing_dec=missing_dec)

    def model_string(self) -> str:
        """The model as this package's JSON string (binner state, base
        score and history kept exactly; the JAX package reads it). For
        LightGBM tools use :meth:`to_lightgbm_string`; :meth:`from_string`
        reads both."""
        d = {
            "version": 1,
            "num_class": self.num_class,
            "objective": self.objective,
            "objective_kwargs": self.objective_kwargs,
            "depth_cap": self.depth_cap,
            "best_iteration": self.best_iteration,
            "base_score": self.base_score.tolist(),
            "thr_raw": self.thr_raw.tolist(),
            "trees": {k: np.asarray(v).tolist()
                      for k, v in self.trees.items()},
            "binner": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in (self.binner_state or {}).items()},
        }
        if self.missing_dec is not None:
            d["missing_dec"] = self.missing_dec.tolist()
        return json.dumps(d)

    @staticmethod
    def from_string(s: str) -> "Booster":
        """Read :meth:`model_string` JSON or LightGBM text (a string that
        starts with ``tree``)."""
        if s.lstrip().startswith("tree"):
            return Booster.from_lightgbm_string(s)
        d = json.loads(s)
        binner_state = dict(d["binner"])
        binner_state["upper_bounds"] = np.asarray(
            binner_state["upper_bounds"], dtype=np.float32)
        return Booster({k: np.asarray(v) for k, v in d["trees"].items()},
                       np.asarray(d["thr_raw"], np.float32), d["num_class"],
                       np.asarray(d["base_score"], np.float32),
                       d["objective"], d["depth_cap"], binner_state,
                       d["best_iteration"],
                       objective_kwargs=d.get("objective_kwargs") or {},
                       missing_dec=d.get("missing_dec"))


def _finalize_trees(trees_list: List[Tree], binner: QuantileBinner,
                    max_bin: int, K: int, base: np.ndarray, objective: str,
                    depth_cap: int, objective_kwargs: dict, best_iter: int,
                    history: Dict[str, List[float]],
                    init_booster: Optional[Booster] = None) -> Booster:
    """Stack grown trees into a Booster (raw thresholds from bin bounds;
    the int64 bitset words become uint32); tree ``t`` scores class
    ``t % K``. A warm start's ``init_booster`` is merged in front."""
    stacked = {f: host_read(torch.Tensor.cpu, torch.stack(
                   [getattr(t, f) for t in trees_list]))
               .numpy().astype(TREE_DTYPES[f]) for f in Tree._fields}
    upper = binner.bin_upper_raw()                         # [F, B]
    thr_raw = upper[stacked["feat"],
                    np.minimum(stacked["thr_bin"], max_bin - 1)]
    thr_raw = np.where(stacked["is_leaf"], np.float32(np.inf), thr_raw)
    b = Booster(stacked, thr_raw.astype(np.float32), K, base, objective,
                depth_cap, binner.state(), best_iteration=best_iter,
                eval_history=history, objective_kwargs=objective_kwargs)
    if init_booster is not None:
        b = _merge_boosters(init_booster, b)
    return b


def _truncate_booster(b: Booster, num_iterations: int) -> Booster:
    """The first ``num_iterations`` iterations (K trees each) of ``b``."""
    t_end = num_iterations * b.num_class
    return Booster({f: a[:t_end] for f, a in b.trees.items()},
                   b.thr_raw[:t_end], b.num_class, b.base_score, b.objective,
                   b.depth_cap, b.binner_state, b.best_iteration,
                   b.eval_history, b.objective_kwargs,
                   missing_dec=(None if b.missing_dec is None
                                else b.missing_dec[:t_end]))


def _scale_booster_values(b: Booster, per_tree_scale: np.ndarray) -> Booster:
    """Each tree's leaf and node values times its scale (rf averaging, dart
    normalization)."""
    s = np.asarray(per_tree_scale, np.float32)[:, None]
    trees = dict(b.trees, leaf_value=b.trees["leaf_value"] * s,
                 node_value=b.trees["node_value"] * s)
    return Booster(trees, b.thr_raw, b.num_class, b.base_score, b.objective,
                   b.depth_cap, b.binner_state, b.best_iteration,
                   b.eval_history, b.objective_kwargs)


def _pad_tree_slots(trees: Dict[str, np.ndarray], thr: np.ndarray, M: int):
    """Widen fixed-shape tree arrays to ``M`` node slots (inert leaves)."""
    pad = M - trees["feat"].shape[1]
    if pad == 0:
        return trees, thr

    def pad_field(name, a):
        if a.ndim == 1:                          # per-tree scalars
            return a
        width = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, width, constant_values=(name == "is_leaf"))

    trees = {k: pad_field(k, v) for k, v in trees.items()}
    thr = np.pad(thr, ((0, 0), (0, pad)), constant_values=np.float32(np.inf))
    return trees, thr


def _merge_boosters(first: Booster, second: Booster) -> Booster:
    """``first``'s trees followed by ``second``'s (BoosterMerge parity,
    reference: TrainUtils.scala:165-168, warm start through
    LGBM_BoosterMerge). Node slots and bitset words widen to the wider of
    the two; the base score is ``first``'s, the rest ``second``'s."""
    if first.num_class != second.num_class:
        raise ValueError(f"cannot merge a {first.num_class}-class booster "
                         f"with a {second.num_class}-class one")
    M = max(first.trees["feat"].shape[1], second.trees["feat"].shape[1])
    BW = max(first.trees["cat_bitset"].shape[-1],
             second.trees["cat_bitset"].shape[-1])

    def widen(b: Booster):
        t = dict(b.trees)
        cur = t["cat_bitset"].shape[-1]
        if cur != BW:
            t["cat_bitset"] = np.pad(t["cat_bitset"],
                                     ((0, 0), (0, 0), (0, BW - cur)))
        return _pad_tree_slots(t, b.thr_raw, M)

    (t1, thr1), (t2, thr2) = widen(first), widen(second)
    trees = {k: np.concatenate([t1[k], t2[k]], axis=0) for k in t1}
    missing_dec = None
    if first.missing_dec is not None or second.missing_dec is not None:
        # the absent side routes by this package's own rule (NaN left:
        # decision_type 10)
        def md(b, t):
            if b.missing_dec is not None:
                return np.pad(b.missing_dec,
                              ((0, 0), (0, M - b.missing_dec.shape[1])),
                              constant_values=10)
            return np.full((t["feat"].shape[0], M), 10, np.uint8)
        missing_dec = np.concatenate([md(first, t1), md(second, t2)])
    return Booster(trees, np.concatenate([thr1, thr2]), first.num_class,
                   first.base_score, second.objective,
                   max(first.depth_cap, second.depth_cap),
                   second.binner_state, second.best_iteration,
                   second.eval_history, second.objective_kwargs,
                   missing_dec=missing_dec)


def _metric_override(objective: str, eval_metric_name: Optional[str]):
    """(early-stopping metric override or None, whether it is the host
    ``auc``), checked against SUPPORTED_EVAL_METRICS."""
    requested = (eval_metric_name or "").strip() or None
    if requested:
        allowed = SUPPORTED_EVAL_METRICS[metric_family(objective)]
        if requested not in allowed:
            raise ValueError(
                f"metric={requested!r} is not supported for the "
                f"{objective!r} objective (choose from {allowed})")
    return requested, requested == "auc"


def _check_options(*, objective, boosting_type, init_booster, checkpoint_dir,
                   bagging_fraction, bagging_freq, pos_bagging_fraction,
                   neg_bagging_fraction, early_stopping_tolerance,
                   provide_training_metric, eval_metric_name):
    """The JAX package's argument checks of the boosting options, with its
    messages, in its order. Returns :func:`_metric_override`'s result."""
    if boosting_type not in ("gbdt", "goss", "rf", "dart"):
        raise ValueError(
            f"boostingType {boosting_type!r} is not supported "
            "(supported: gbdt, rf, dart, goss)")
    if boosting_type in ("rf", "dart"):
        if init_booster is not None:
            raise ValueError(
                f"warm start (modelString/numBatches) is not supported with "
                f"boostingType={boosting_type!r}: its trees carry "
                "normalization state that a warm-start prefix lacks")
        if checkpoint_dir is not None:
            raise ValueError(
                f"checkpointDir is not supported with "
                f"boostingType={boosting_type!r} (gbdt/goss only)")
    stratified = pos_bagging_fraction != 1.0 or neg_bagging_fraction != 1.0
    if boosting_type == "rf" and not (
            (bagging_fraction < 1.0 or stratified) and bagging_freq > 0):
        raise ValueError(
            "boostingType='rf' requires bagging: set baggingFraction < 1.0 "
            "(or pos/negBaggingFraction) and baggingFreq > 0 (LightGBM "
            "semantics — without bagging every random-forest tree would be "
            "identical)")
    if stratified:
        if objective != "binary":
            raise ValueError(
                "posBaggingFraction/negBaggingFraction apply to the binary "
                f"objective only (got objective={objective!r})")
        if bagging_freq <= 0:
            raise ValueError(
                "posBaggingFraction/negBaggingFraction need baggingFreq > 0")
        if not (0.0 < pos_bagging_fraction <= 1.0
                and 0.0 < neg_bagging_fraction <= 1.0):
            raise ValueError(
                "pos/negBaggingFraction must be in (0, 1]; got "
                f"{pos_bagging_fraction}/{neg_bagging_fraction}")
        if boosting_type == "goss":
            raise ValueError("goss does its own gradient-based sampling; "
                             "pos/negBaggingFraction do not apply")
        if boosting_type == "dart":
            raise ValueError(
                "pos/negBaggingFraction are supported for gbdt/rf; dart's "
                "fused drop-schedule path keeps plain baggingFraction")
        if bagging_fraction < 1.0:
            raise ValueError(
                "set either baggingFraction or pos/negBaggingFraction, "
                "not both (the stratified fractions replace it)")
    if early_stopping_tolerance < 0:
        raise ValueError(f"improvementTolerance must be >= 0, got "
                         f"{early_stopping_tolerance}")
    if provide_training_metric and boosting_type in ("rf", "dart"):
        raise ValueError(
            "isProvideTrainingMetric is supported for gbdt/goss (rf keeps "
            "train scores at the base margin and dart rescales past trees "
            "each iteration, so neither has a running train margin to "
            "evaluate)")
    requested, auc_host = _metric_override(objective, eval_metric_name)
    if requested and boosting_type == "dart":
        raise ValueError("metric overrides are not supported with "
                         "dart (its fused drop-schedule eval keeps the "
                         "objective default)")
    return requested, auc_host


def _row_uniforms(seed: int, bag_step: int, n: int, start: int = 0,
                  device: DeviceLike = None) -> torch.Tensor:
    """``[n]`` f32 uniforms in [0, 1): the per-row draws of bagging, GOSS
    and rf, rows ``[start, start + n)`` of the JAX package's one-device
    draw ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), 1_000_003 +
    bag_step), 0), (n_rows,))``, bit for bit (``utils/prng.py``). Drawn on
    ``device``; integer draws are exact, so the GPU and the CPU keep the
    same rows."""
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed),
                                    1_000_003 + int(bag_step)), 0)
    return prng.uniform(key, n, start=start, device=device)


def _quantile_linear(a: torch.Tensor, q: np.float32) -> float:
    """``jnp.quantile(a, q)`` (linear interpolation) of a 1-D f32 tensor,
    with its f32 index arithmetic, from two ``kthvalue`` order statistics
    (``torch.quantile`` refuses more than 2^24 elements). The interpolation
    ``lo * lw + hi * hw`` rounds as XLA's fused multiply-add does (one
    rounding after ``hi * hw`` is added), so a threshold inside a run of
    tied values is that value, as in the JAX package. NaN anywhere gives
    NaN."""
    if host_read(bool, torch.isnan(a).any()):
        return float("nan")
    one = np.float32(1.0)
    nf = np.float32(a.numel())
    qq = np.float32(q) * (nf - one)
    low, high = np.floor(qq), np.ceil(qq)
    hw = np.float32(qq - low)
    lw = np.float32(one - hw)
    low = int(np.clip(low, 0, nf - one))
    high = int(np.clip(high, 0, nf - one))
    item = torch.Tensor.item
    lo = np.float32(host_read(item, a.kthvalue(low + 1).values))
    hi = lo if high == low else np.float32(
        host_read(item, a.kthvalue(high + 1).values))
    # f64 holds the exact product of two f32 values
    return float(np.float32(np.float64(hi) * np.float64(hw)
                            + np.float64(np.float32(lo * lw))))


class _RowSampling:
    """Each iteration's row mask (the JAX package's ``step_local`` masks):

      * GOSS: the top ``top_rate`` share of rows by ``|grad|`` summed over
        score columns (a quantile over the padded length, whose padding
        rows sit at 0; over a data group each rank's own, as the JAX
        package's shards do), the rest kept with probability
        ``other_rate / (1 - top_rate)`` and weighted ``(1 - top_rate) /
        other_rate`` in the mask — so counts and ``minDataInLeaf`` see the
        amplified weights, as in the JAX package;
      * bagging: rows kept with probability ``bagging_fraction``, or
        ``pos``/``neg_bagging_fraction`` by label; one bag per
        ``bagging_freq`` iterations (rf and GOSS draw anew every
        iteration);
      * otherwise the validity mask.
    """

    def __init__(self, *, boosting_type, vmask, y, seed, bagging_fraction,
                 bagging_freq, pos_bagging_fraction, neg_bagging_fraction,
                 top_rate, other_rate, start=0):
        self.vmask, self.seed = vmask, seed
        # this rank's first global row: a rank draws its slice of the
        # one-device stream
        self.start = start
        self.goss = boosting_type == "goss"
        self.every_iteration = boosting_type in ("goss", "rf")
        stratified = (pos_bagging_fraction != 1.0
                      or neg_bagging_fraction != 1.0)
        self.bagging = (not self.goss and bagging_freq > 0
                        and (bagging_fraction < 1.0 or stratified))
        self.freq = max(int(bagging_freq), 1)
        if self.bagging:
            f32 = np.float32
            self.frac = (torch.where(y > 0.5, float(f32(pos_bagging_fraction)),
                                     float(f32(neg_bagging_fraction)))
                         if stratified else float(f32(bagging_fraction)))
        if self.goss:
            n_pad = vmask.shape[0]
            n_valid = max(host_read(float, vmask.sum()), 1.0)
            self.q = np.clip(np.float32(1.0) - np.float32(top_rate)
                             * np.float32(n_valid) / np.float32(n_pad),
                             np.float32(0.0), np.float32(1.0))
            self.keep_p = float(np.float32(other_rate
                                           / max(1.0 - top_rate, 1e-6)))
            self.amp = float(np.float32((1.0 - top_rate)
                                        / max(other_rate, 1e-6)))
        self._bag = (None, None)

    def bag_step(self, it: int) -> int:
        """The JAX package's ``_iter_keys`` bag step."""
        if self.every_iteration:
            return it
        return it // self.freq if self.bagging else 0

    def _uniforms(self, it: int) -> torch.Tensor:
        return _row_uniforms(self.seed, self.bag_step(it),
                             self.vmask.shape[0], self.start,
                             self.vmask.device)

    def __call__(self, it: int, grad: torch.Tensor) -> torch.Tensor:
        """The row mask of iteration ``it`` (``grad`` [n, K])."""
        if self.goss:
            absg = grad.abs().sum(dim=1) * self.vmask
            top = absg >= _quantile_linear(absg, self.q)
            rest = self._uniforms(it) < self.keep_p
            w = torch.where(top, 1.0, torch.where(rest, self.amp, 0.0))
            return self.vmask * w.to(torch.float32)
        if not self.bagging:
            return self.vmask
        step = self.bag_step(it)
        if self._bag[0] != step:
            bag = (self._uniforms(it) < self.frac).to(torch.float32)
            self._bag = (step, self.vmask * bag)
        return self._bag[1]


def _feature_mask(seed: int, it: int, F: int, feature_fraction: float,
                  dev: torch.device) -> torch.Tensor:
    """Iteration ``it``'s [F] bool feature subset, the JAX package's: ``u =
    uniform(fold_in(fold_in(PRNGKey(seed), it), 7), (F,))``, the features
    with ``u < feature_fraction`` and the argmin of ``u`` (at least one
    feature is kept)."""
    if feature_fraction >= 1.0:
        return torch.ones(F, dtype=torch.bool, device=dev)
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), it), 7)
    u = prng.uniform(key, F, device=dev)
    fmask = u < float(np.float32(feature_fraction))
    fmask[torch.argmin(u)] = True
    return fmask


def _grow_iteration(grow, Xbt, grad, hess, row_mask, fmask, cfg, is_cat,
                    seed: int, it: int, group=None, n_rows=None,
                    rounds=None):
    """The K trees of iteration ``it``, one per grad/hess column: full
    precision below ``cfg.quant_warmup_iters`` (or without
    ``quantized_grad``), else on int8 histograms rounded under
    ``quant_key(seed, it, k)``; on the collective path of ``group``
    (:func:`_grow_group`), whose ranks round their rows of the draw over
    the data's ``n_rows`` real rows. ``rounds``: the fit's
    :class:`.growth.LeafwiseRounds`, for :func:`grow_tree`. Returns
    [(tree, row_node)]."""
    quantized = cfg.quantized_grad and it >= cfg.quant_warmup_iters
    fp_cfg = cfg._replace(quantized_grad=False)
    # one device: the grow functions' single-device call
    on_group = ({} if group is None
                else {"group": group, "n_rows": n_rows})
    if rounds is not None:
        on_group["rounds"] = rounds
    out = []
    for k in range(grad.shape[1]):
        g_k, h_k = grad[:, k].contiguous(), hess[:, k].contiguous()
        if quantized:
            out.append(grow(Xbt, g_k, h_k, row_mask, fmask, cfg, is_cat,
                            qkey=quant_key(seed, it, k), **on_group))
        else:
            out.append(grow(Xbt, g_k, h_k, row_mask, fmask, fp_cfg, is_cat,
                            **on_group))
    return out


def _grow_group(mesh: Mesh, cfg: GrowConfig) -> Optional[Mesh]:
    """The group tree growth runs its collectives over (the JAX package's
    ``_grow_axis_for``): None for one rank, so histogram subtraction can
    engage. Voting keeps the group even at one rank (its top-2k ballot
    restricts the split search, the same at every world size), and so does
    a resolved ``hist_blocks`` (the blocked reduction runs the same
    program at every world size)."""
    return mesh if (mesh.size > 1 or cfg.voting or _blocked(cfg)) else None


def _global_metric(mesh: Mesh, obj, scores, y, w, metric_name: str,
                   **kwargs) -> float:
    """The eval metric over every rank's rows: each rank's weighted mean
    is weighted by its rows' weight and the parts summed over the group
    (``rmse`` combines squares), as the JAX package's ``psum`` does —
    topology-dependent in the last ulp (the JAX scope note,
    ``growth.py:206-211``). One rank: the metric as it is."""
    _, num = eval_metric(obj, scores, y, w, **kwargs)
    if mesh.size == 1:
        return host_read(float, num)
    wsum = w.sum()
    num = torch.where(wsum > 0, num.to(torch.float32),
                      torch.zeros((), device=w.device))
    part = num * num * wsum if metric_name == "rmse" else num * wsum
    tot = mesh.all_reduce(torch.stack([part, wsum]))
    m = tot[0] / tot[1]
    return host_read(float, torch.sqrt(m) if metric_name == "rmse" else m)


# rows the CPU's vectorized loops take at a time, at most (two 16-lane
# vectors), rounded up
_CPU_VEC_ROWS = 64


def _grad_hess(obj, score, y, w, group):
    """``obj.grad_hess`` of this rank's rows. On the CPU's collective path
    the rows are padded to a multiple of ``_CPU_VEC_ROWS`` first: PyTorch's
    vectorized CPU loops compute a transcendental function (``exp``,
    ``sigmoid``) with other code in a loop's scalar tail, so a row's bits
    would depend on where it falls in its rank's slice, and a fit on the
    blocked reduction on the world size. LambdaRank's rows are whole
    groups and stay as they are. A CUDA kernel computes every element
    alike."""
    n = y.shape[0]
    if (group is None or y.device.type != "cpu" or obj.name == "lambdarank"
            or n % _CPU_VEC_ROWS == 0):
        return obj.grad_hess(score, y, w)
    pad = _CPU_VEC_ROWS - n % _CPU_VEC_ROWS

    def grow(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 2
                                       else (0, pad))
    g, h = obj.grad_hess(grow(score), grow(y), grow(w))
    return g[:n], h[:n]


class _EarlyStopping:
    """The validation bookkeeping: history, best metric and iteration, and
    rounds without an improvement of more than ``tol``."""

    def __init__(self, metric_name: str, rounds: int, tol: float):
        self.name, self.rounds, self.tol = metric_name, rounds, float(tol)
        self.history: Dict[str, List[float]] = {metric_name: []}
        self.higher = metric_name in HIGHER_IS_BETTER
        self.best_metric = -np.inf if self.higher else np.inf
        self.best_iter, self.rounds_no_improve = -1, 0

    def restore(self, state: dict) -> None:
        self.best_metric = state.get("best_metric", self.best_metric)
        self.best_iter = state.get("best_iter", self.best_iter)
        self.rounds_no_improve = state.get("rounds_no_improve", 0)
        self.history = state.get("history", self.history)

    def state(self) -> dict:
        return dict(best_metric=self.best_metric, best_iter=self.best_iter,
                    rounds_no_improve=self.rounds_no_improve,
                    history=self.history)

    def update(self, it: int, m: float) -> bool:
        """Record ``m`` for iteration ``it``; True when training stops."""
        self.history[self.name].append(m)
        improved = (m > self.best_metric + self.tol if self.higher
                    else m < self.best_metric - self.tol)
        if improved:
            self.best_metric, self.best_iter = m, it
            self.rounds_no_improve = 0
        else:
            self.rounds_no_improve += 1
        return 0 < self.rounds <= self.rounds_no_improve


class _Valid(NamedTuple):
    """A validation set on the fit's device, this rank's padded slice of
    it: binned rows ``[nv_local, F]``, labels and weights (padding rows at
    weight 0; every row's on the host, for the host ``auc``) and the
    running scores ``[nv_local, K]``."""
    Xb: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    y_host: np.ndarray
    w_host: np.ndarray
    scores: torch.Tensor


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


def _last_good_dump(ckpt_mgr, K: int, all_trees: list, finalize,
                    es: "_EarlyStopping", iterations_done: int, **payload):
    """The watchdog callback of ``MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY=1``:
    on the first training-health sentinel (named ``gbdt``) or stall of the
    round loop (``gbdt_round_loop``) it checkpoints the newest healthy
    state at once. A sentinel drops the flagged round's trees (they carry
    the bad update); for a stall every complete round is good. The payload
    is the normal checkpoint's (without the score matrices: a resume
    re-scores) plus ``emergency`` and ``reason``, so the usual resume picks
    it up. One-shot, latched only after a successful save: an event with
    nothing healthy to save yet, or a failed write, leaves it armed."""
    done = threading.Event()

    def dump(category, name, fields):
        if name not in ("gbdt", "gbdt_round_loop") or done.is_set():
            return
        snap = list(all_trees)          # append-only: a snapshot is safe
        complete = (len(snap) // K) * K
        if category in ("nan_loss", "loss_divergence") and complete >= K:
            complete -= K
        if complete <= 0:
            return
        step = iterations_done + complete // K - 1
        try:
            ckpt_mgr.save(step, dict(
                payload, model=finalize(snap[:complete]).model_string(),
                iteration=step, **es.state(), emergency=True,
                reason=category))
        except Exception:  # noqa: BLE001 — stay armed for a later event
            return
        done.set()
        _flight.record("checkpoint_emergency_dump", model="gbdt",
                       reason=category, iteration=step)

    return dump


def _rank_scores(saved, mesh: Mesh, base: np.ndarray) -> np.ndarray:
    """This rank's padded slice of a saved ``(n, K)`` score matrix, its
    padding rows at ``base``, the score a fresh run gives them."""
    full = np.asarray(saved, np.float32)
    part = placement.local_rows(full, mesh).copy()
    start = mesh.rank * part.shape[0]
    part[max(0, full.shape[0] - start):] = np.asarray(base, np.float32)
    return part


def _save_checkpoint(ckpts, it: int, mesh: Mesh, scores: torch.Tensor,
                     n: int, valid: Optional["_Valid"],
                     es: "_EarlyStopping", model_string: Callable[[], str],
                     **payload) -> None:
    """Checkpoint iteration ``it``: the whole training and validation
    score matrices gathered from the ranks in row order, padding dropped
    (the layout of one process, so the payload does not depend on the
    topology), and the early-stopping state, which must be the same on
    every rank (its metrics are reduced over the group); rank 0 writes."""
    cpu = torch.Tensor.cpu
    full = host_read(cpu, mesh.all_gather(scores)[:n]).numpy()
    vfull = (None if valid is None else host_read(cpu, mesh.all_gather(
        valid.scores)[:len(valid.y_host)]).numpy())
    state = es.state()
    mesh.check_same(pickle.dumps(state), "the early-stopping state")
    if ckpts.writer:
        ckpts.save(it, dict(payload, model=model_string(), iteration=it,
                            scores=full, vscores=vfull, **state))


# what a gbdt.round span reports the change of: the host's waits on the
# device, the histogram kernels' launches and the rows handed to them, the
# launches of the fused int8 statistics kernel and of its amax, and the
# LambdaRank kernel's launches and the pairs they evaluated
_ROUND_COUNTERS = {
    "host_syncs": lambda: _growth.host_syncs,
    "hist_launches": lambda: (node_histogram.launches
                              + node_histogram.int8_launches
                              + node_histogram.det_launches
                              + histogram_cols.launches),
    "hist_rows": lambda: node_histogram.rows + histogram_cols.rows,
    "stats_launches": lambda: quantize_stats.launches,
    "stats_amax_launches": lambda: stats_amax_cuda.launches,
    "rank_launches": lambda: lambdarank_cuda.launches,
    "rank_pairs": lambda: lambdarank_cuda.pairs,
}


def train_booster(
    X: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    *,
    dataset: Optional[LightGBMDataset] = None,
    objective: str = "regression",
    num_class: int = 1,
    num_iterations: int = 100,
    cfg: Optional[GrowConfig] = None,
    max_bin: int = 255,
    bin_sample_count: int = 200_000,
    feature_fraction: float = 1.0,
    bagging_fraction: float = 1.0,
    bagging_freq: int = 0,
    seed: int = 0,
    valid_set: Optional[tuple] = None,
    early_stopping_rounds: int = 0,
    init_booster: Optional[Booster] = None,
    boost_from_average: bool = True,
    objective_kwargs: Optional[dict] = None,
    metric_eval_period: int = 1,
    row_valid: Optional[np.ndarray] = None,
    boosting_type: str = "gbdt",
    top_rate: float = 0.2,
    other_rate: float = 0.1,
    drop_rate: float = 0.1,
    max_drop: int = 50,
    skip_drop: float = 0.5,
    drop_seed: int = 4,
    checkpoint_dir: Optional[str] = None,
    checkpoint_period: int = 10,
    categorical_features=(),
    bin_dtype=None,
    pos_bagging_fraction: float = 1.0,
    neg_bagging_fraction: float = 1.0,
    early_stopping_tolerance: float = 0.0,
    provide_training_metric: bool = False,
    max_bin_by_feature=None,
    eval_metric_name: Optional[str] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
    iteration_callback: Optional[Callable[[int, Dict[str, float]],
                                          None]] = None,
) -> Booster:
    """Train a boosted ensemble on one device (default ``cuda``), or
    row-sharded over a data group.

    Each iteration computes grad/hess from the objective on the current
    ``[n, K]`` margin (K = 1, or ``num_class`` for multiclass), grows one
    tree per score column (``cfg.growth_policy``: leafwise or depthwise) on
    its grad/hess column under the iteration's row mask, and adds its leaf
    values to that column. ``dataset`` (a pre-built
    :class:`LightGBMDataset`) skips the ingest; its device wins over
    ``device`` (``X`` may come with it for an ``init_booster`` warm start).
    Every draw is the JAX package's, from its ``jax.random`` keys
    (``utils/prng.py``): ``feature_fraction < 1`` takes iteration ``it``'s
    feature subset under ``fold_in(fold_in(PRNGKey(seed), it), 7)``
    (:func:`_feature_mask`), so a resume needs no replay. With
    ``cfg.quantized_grad``, iterations below ``cfg.quant_warmup_iters``
    grow at full precision and later ones on int8 histograms, each tree
    stochastically rounded under ``quant_key(seed, iteration, class)``,
    the words of ``fold_in(fold_in(PRNGKey(seed), it), 13 + class)``.

    ``boosting_type``:
      * ``gbdt`` with bagging (``bagging_fraction < 1`` or the binary-only
        ``pos/neg_bagging_fraction``, and ``bagging_freq > 0``): each tree
        sees a bag of rows, redrawn every ``bagging_freq`` iterations;
      * ``goss``: gradient-based one-side sampling (``top_rate``,
        ``other_rate``; :class:`_RowSampling`);
      * ``rf``: a random forest — bagging required, a new bag every
        iteration, learning rate 1, gradients always at the base score, and
        the finished forest scaled by ``1 / iterations``; its validation
        metric is taken on the average of the trees so far;
      * ``dart``: :func:`_train_dart`.
    Per-row draws come from :func:`_row_uniforms` on the fit's device: a
    rank draws its own rows of the one-device stream, so a fit over a data
    group draws what one device draws.

    ``init_booster`` warm-starts: its base score, its margins on the raw
    rows as the starting scores, its trees merged in front of the new ones
    (early stopping then records ``best_iteration`` without cutting).
    ``checkpoint_dir`` saves a checkpoint every ``checkpoint_period``
    iterations (model, exact score matrices, early-stopping state) and
    resumes from the newest one whose data and config fingerprint matches;
    a checkpoint that already covers the request is returned cut to it.

    ``valid_set`` ``(X, y, weight or None)`` is binned with the dataset's
    binner and scored tree by tree (a ranking fit on query groups,
    ``dataset.queries``, gives its validation rows' query offsets as a
    fourth element); every ``metric_eval_period``
    iterations (and the last) its metric — the objective's default, or
    ``eval_metric_name`` from ``SUPPORTED_EVAL_METRICS`` (``auc`` on the
    host) — goes into ``eval_history``. An iteration counts as improved
    when it beats the best by more than ``early_stopping_tolerance``; after
    ``early_stopping_rounds`` evaluations without one, training stops and
    the booster is cut to ``best_iteration + 1`` iterations.
    ``provide_training_metric`` records ``training_<metric>`` on the
    training rows. The JAX package runs plain fits as one fused device
    loop; this host loop grows the same trees.

    ``categorical_features`` (feature indexes; the binner's, when
    ``dataset`` is given) split by LightGBM's sorted-subset search. ``X``
    and the validation rows may be scipy sparse matrices.

    ``mesh`` (default: the dataset's, else
    :func:`...parallel.mesh.get_default_mesh`) is the data group: every
    rank calls with the same global rows and keeps its slice
    (:meth:`LightGBMDataset.construct`), histograms and totals are summed
    over the group (``cfg.voting``: voting_parallel; ``cfg.hist_blocks``:
    the deterministic blocked reduction, resolved first by
    :func:`...parallel.placement.resolve_hist_blocks`), per-row draws are
    each rank's slice of the global stream, validation rows are sharded
    too and their metrics summed over the group, and every rank returns
    the same booster. ``checkpoint_dir`` over a group: rank 0 alone reads
    and writes the directory (:class:`...utils.checkpoint.
    GroupCheckpoints`); a payload holds the whole score matrices, gathered
    from the ranks, so a checkpoint written on R ranks resumes on R' (under
    ``hist_blocks`` to the uninterrupted run's trees, byte for byte).
    ``iteration_callback(it, {metric: value})`` is called after every
    iteration (an empty dict where no metric was evaluated).
    """
    # each fit starts with clean training-health sentinel windows
    _watchdog.reset_training_health("gbdt")
    cfg = resolve_growth_backend(cfg or GrowConfig())
    if dataset is not None and checkpoint_dir is not None:
        raise ValueError(
            "checkpointDir requires raw X/y arrays (the resume fingerprint "
            "hashes them); pass arrays instead of a pre-built dataset")
    if dataset is None and (X is None or y is None):
        raise ValueError("either X and y arrays or dataset= must be given")
    if dataset is not None and (y is not None or weight is not None
                                or row_valid is not None):
        raise ValueError("y/weight/row_valid are baked into the dataset at "
                         "construct() time; do not pass them alongside "
                         "dataset=")
    mesh = mesh or (dataset.mesh if dataset is not None
                    else meshlib.get_default_mesh())
    # the canonical reduction geometry, before anything else reads cfg:
    # the padded row count is the dataset's, or the rows' padded to the
    # group
    n_pad = (dataset.n_pad if dataset is not None
             else -(-int(np.shape(y)[0]) // mesh.size) * mesh.size)
    cfg = cfg._replace(hist_blocks=placement.resolve_hist_blocks(
        cfg.hist_blocks, mesh, n_pad, voting=cfg.voting))
    requested, auc_host = _check_options(
        objective=objective, boosting_type=boosting_type,
        init_booster=init_booster, checkpoint_dir=checkpoint_dir,
        bagging_fraction=bagging_fraction, bagging_freq=bagging_freq,
        pos_bagging_fraction=pos_bagging_fraction,
        neg_bagging_fraction=neg_bagging_fraction,
        early_stopping_tolerance=early_stopping_tolerance,
        provide_training_metric=provide_training_metric,
        eval_metric_name=eval_metric_name)
    eval_override = None if auc_host else requested
    objective_kwargs = objective_kwargs or {}

    ckpts = ckpt_fp = None
    dump_on_unhealthy = False
    iterations_done = 0
    user_init_booster = init_booster
    resume: Optional[dict] = None
    if checkpoint_dir is not None:
        from ...utils.checkpoint import GroupCheckpoints, data_fingerprint
        ckpt_fp = data_fingerprint(
            np.asarray(_densify(X), np.float32), np.asarray(y, np.float32),
            None if weight is None else np.asarray(weight, np.float32),
            config=(objective, num_class, cfg._replace(num_bins=max_bin),
                    max_bin, bin_sample_count,
                    tuple(int(i) for i in categorical_features),
                    boost_from_average, feature_fraction, bagging_fraction,
                    bagging_freq, seed, boosting_type, top_rate, other_rate,
                    pos_bagging_fraction, neg_bagging_fraction,
                    early_stopping_tolerance, requested,
                    None if max_bin_by_feature is None
                    else tuple(int(b) for b in max_bin_by_feature),
                    sorted(objective_kwargs.items()),
                    None if user_init_booster is None
                    else user_init_booster.model_string()))
        # one namespace per run: sweeps sharing the directory never prune
        # each other's files; over a data group rank 0 alone reads and
        # writes it, and hands every rank what it read
        ckpts = GroupCheckpoints(checkpoint_dir, ckpt_fp, mesh)
        dump_on_unhealthy = _env_flag("MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY")
        # MMLSPARK_TPU_STRICT_RESUME=1: resume or raise. Probed only when
        # the namespaced lookup found nothing, and across namespaces (a
        # changed config changes the namespace, which is what strict mode
        # must catch): CheckpointMismatchError names what was found; a
        # match there is a legacy un-namespaced checkpoint, resumed
        latest = ckpts.latest(
            strict_probe=_env_flag("MMLSPARK_TPU_STRICT_RESUME"))
        if latest is not None:
            resume = latest[1]
            init_booster = Booster.from_string(resume["model"])
            iterations_done = resume["iteration"] + 1
            if iterations_done >= num_iterations:
                return _truncate_booster(
                    init_booster,
                    resume.get("prior_iterations", 0) + num_iterations)

    tw = _PhaseTimer()
    if boosting_type == "rf":
        # no shrinkage: the forest is averaged when it is finished
        cfg = cfg._replace(learning_rate=1.0)
    obj = get_objective(objective, num_class, **objective_kwargs)
    K = obj.num_scores
    if dataset is None:
        dataset = LightGBMDataset.construct(
            X, y, weight, max_bin=max_bin, bin_sample_count=bin_sample_count,
            seed=seed, bin_dtype=bin_dtype,
            max_bin_by_feature=max_bin_by_feature, row_valid=row_valid,
            categorical_features=categorical_features, device=device,
            mesh=mesh, _timer=tw)
    # a ranking dataset's query groups reach the objective and its metric
    metric_kw = dict(objective_kwargs)
    if dataset.queries is not None:
        obj = get_objective(objective, num_class, queries=dataset.queries,
                            **objective_kwargs)
        metric_kw["queries"] = dataset.queries
    # the boosting loop and growth, from the dataset to the booster
    with _spans.span("gbdt.boost", publish=False) as boost_span:
        if dataset.mesh.ranks != mesh.ranks:
            raise ValueError(f"the dataset is sharded over {dataset.mesh}, "
                             f"the fit asks for {mesh}")
        dev = dataset.device
        max_bin = dataset.max_bin
        cfg = cfg._replace(num_bins=max_bin)
        F, n = dataset.num_features, dataset.n
        Xbt, y_d, w_d, vmask = dataset.Xbt, dataset.y, dataset.w, dataset.vmask
        placement.plan_for("gbdt.fit", mesh=mesh, rows=dataset.n_pad,
                           device=dev, boosting=boosting_type)
        group = _grow_group(mesh, cfg)
        # categorical routing mask, None without categorical features
        is_cat_np = dataset.binner.is_cat_mask()
        is_cat = (torch.from_numpy(is_cat_np).to(dev) if is_cat_np.any()
                  else None)

        if init_booster is not None:
            if X is None:
                raise ValueError(
                    "init_booster warm start scores raw rows: pass X "
                    "alongside dataset=")
            base = init_booster.base_score
            base_d = torch.from_numpy(base).to(dev)
            # a resume restores the exact score matrix of the interrupted run
            # (this rank's slice of it): re-scoring through predict_raw sums in
            # another order, which can pick other splits; an old payload
            # without it re-scores this rank's rows
            saved = None if resume is None else resume.get("scores")
            if saved is not None and np.shape(saved) == (n, K):
                scores = torch.from_numpy(
                    _rank_scores(saved, mesh, base)).to(dev)
            else:
                scores = init_booster.predict_raw_tensor(torch.from_numpy(
                    placement.local_rows(np.asarray(_densify(X), np.float32),
                                         mesh)).to(dev))
        else:
            # over the whole (padded) rows, gathered in rank order: the same
            # reduction at every world size
            y_all, wv_all = (mesh.all_gather(t) for t in (y_d, w_d * vmask))
            base_d = (obj.init_score(y_all, wv_all).reshape(1).expand(K)
                      if boost_from_average else torch.zeros(K, device=dev))
            base_d = base_d.to(torch.float32).contiguous()
            base = host_read(torch.Tensor.cpu, base_d).numpy()
            scores = base_d.repeat(dataset.n_local, 1)         # [n_local, K]
        scores = scores.contiguous()
        tw.mark("base_scores", dev)

        depth_cap = (cfg.max_depth if cfg.max_depth > 0
                     else max(1, cfg.num_leaves - 1))
        depth_cap = min(depth_cap, 2 * cfg.num_leaves)
        device_metric = eval_metric(
            obj, torch.zeros((1, K)) if K > 1 else torch.zeros(1),
            torch.zeros(1), torch.ones(1), metric=eval_override,
            **metric_kw)[0]
        metric_name = "auc" if auc_host else device_metric

        valid = valid_fp = None
        valid_kw = dict(objective_kwargs)
        if valid_set is not None:
            Xv, yv, wv = valid_set[:3]
            Xv = np.asarray(_densify(Xv), np.float32)
            yv = np.asarray(yv, np.float32)
            wv = np.ones_like(yv) if wv is None else np.asarray(wv, np.float32)
            if len(valid_set) > 3:
                valid_kw["queries"] = QueryGroups(valid_set[3], yv, wv)
            if ckpts is not None:
                # the validation rows are not in the run's fingerprint; their
                # saved scores are restored only against the same rows
                from ...utils.checkpoint import data_fingerprint
                valid_fp = data_fingerprint(Xv, yv, wv)
            Xv_d = torch.from_numpy(placement.local_rows(Xv, mesh)).to(dev)
            Xvb = bin_cols(Xv_d, torch.from_numpy(dataset.binner.upper_bounds),
                           Xbt.dtype).t().contiguous()     # [nv_local, F]
            saved = None if resume is None else resume.get("vscores")
            if (saved is not None and valid_fp is not None
                    and resume.get("valid_fingerprint") == valid_fp
                    and np.shape(saved) == (len(yv), K)):
                vscores = torch.from_numpy(_rank_scores(saved, mesh, base)).to(
                    dev)
            elif init_booster is not None:
                vscores = init_booster.predict_raw_tensor(Xv_d)
            else:
                vscores = base_d.repeat(Xv_d.shape[0], 1)  # [nv_local, K]
            del Xv_d
            # padding rows weigh 0
            valid = _Valid(Xvb, placement.shard_rows(yv, mesh, device=dev)[0],
                           placement.shard_rows(wv, mesh, device=dev)[0],
                           yv, wv, vscores.contiguous())
            tw.mark("valid_prep", dev)

        sampling = _RowSampling(
            boosting_type=boosting_type, vmask=vmask, y=y_d, seed=seed,
            bagging_fraction=bagging_fraction, bagging_freq=bagging_freq,
            pos_bagging_fraction=pos_bagging_fraction,
            neg_bagging_fraction=neg_bagging_fraction, top_rate=top_rate,
            other_rate=other_rate,
            start=mesh.rank * dataset.n_local)
        grow = (grow_tree_depthwise if cfg.growth_policy == "depthwise"
                else grow_tree)
        # the leafwise rounds of this fit, replayed on one card
        rounds = LeafwiseRounds() if grow is grow_tree else None
        es = _EarlyStopping(metric_name, early_stopping_rounds,
                            early_stopping_tolerance)
        if boosting_type == "dart":
            booster = _train_dart(
                dataset=dataset, cfg=cfg, K=K, obj=obj, objective=objective,
                objective_kwargs=objective_kwargs, base_d=base_d,
                valid=valid, depth_cap=depth_cap, es=es,
                num_iterations=num_iterations, seed=seed,
                feature_fraction=feature_fraction, sampling=sampling,
                grow=grow, is_cat=is_cat,
                metric_eval_period=metric_eval_period, drop_rate=drop_rate,
                max_drop=max_drop, skip_drop=skip_drop, drop_seed=drop_seed,
                mesh=mesh, group=group, valid_kw=valid_kw,
                iteration_callback=iteration_callback)
            boost_span.set(trees=booster.num_trees)
            return booster
        if resume is not None:
            es.restore(resume)
        is_rf = boosting_type == "rf"

        def column(sc):
            return sc if K > 1 else sc[:, 0]

        def finalize(trees_list):
            return _finalize_trees(trees_list, dataset.binner, max_bin, K,
                                   base, objective, depth_cap,
                                   objective_kwargs, es.best_iter,
                                   es.history, init_booster)

        all_trees: List[Tree] = []
        # watchdog: one beat and one round-duration report per boosting round
        # (a wedged round stops beating; a round suddenly much slower than its
        # window trips the throughput sentinel)
        hb = _watchdog.register("gbdt_round_loop", stall_seconds=120.0)
        prior_iterations = (0 if user_init_booster is None
                            else user_init_booster.num_iterations)
        unregister_dump = None
        if ckpts is not None and ckpts.writer and dump_on_unhealthy:
            # rank 0's callback alone: it holds no score matrix, so it needs
            # no collective (and may not enter one from the watchdog's thread)
            unregister_dump = _watchdog.add_event_callback(_last_good_dump(
                ckpts.manager, K, all_trees, finalize, es, iterations_done,
                fingerprint=ckpt_fp, prior_iterations=prior_iterations,
                valid_fingerprint=valid_fp))
        t_round = time.perf_counter()
        try:
            for it in range(iterations_done, num_iterations):
                with _spans.span("gbdt.round", counters=_ROUND_COUNTERS,
                                 publish=False, iteration=it):
                    hb.beat()
                    # chaos hook, one evaluation a round: `exit` is the
                    # mid-fit preemption the resume path is tested against
                    _failpoint("gbdt.round")
                    with _spans.span("gbdt.grad_hess", device=dev,
                                     publish=False):
                        grad, hess = _grad_hess(obj, column(scores), y_d,
                                                w_d, group)
                        if K == 1:
                            grad, hess = grad[:, None], hess[:, None]
                    with _spans.span("gbdt.grow", device=dev, publish=False):
                        row_mask = sampling(it, grad)
                        fmask = _feature_mask(seed, it, F, feature_fraction,
                                              dev)
                        grown = _grow_iteration(
                            grow, Xbt, grad, hess, row_mask, fmask, cfg,
                            is_cat, seed, it, group, dataset.n, rounds)
                    trees = []
                    with _spans.span("gbdt.score_update", device=dev,
                                     publish=False):
                        for k, (tree, row_node) in enumerate(grown):
                            # rf's trees all fit the base score's gradients
                            if not is_rf:
                                scores[:, k] += tree.leaf_value[
                                    row_node.long()]
                            trees.append(tree)
                    all_trees.extend(trees)

                    evaluate = (it % metric_eval_period == 0
                                or it == num_iterations - 1)
                    if provide_training_metric and evaluate:
                        es.history.setdefault(
                            f"training_{device_metric}", []).append(
                                _global_metric(mesh, obj, column(scores),
                                               y_d, w_d * vmask,
                                               device_metric,
                                               metric=eval_override,
                                               **metric_kw))
                    stop = False
                    round_metrics: Dict[str, float] = {}
                    if valid is not None:
                        vscores = valid.scores
                        for k, tree in enumerate(trees):
                            vscores[:, k] += predict_tree_binned(
                                tree, valid.Xb, depth_cap, is_cat)
                        if evaluate:
                            if auc_host:
                                # rank-based: the rf average changes no order
                                margin = mesh.all_gather(vscores[:, 0])
                                m = auc_weighted(
                                    host_read(torch.Tensor.cpu, margin[
                                        :len(valid.y_host)]).numpy(),
                                    valid.y_host, valid.w_host)
                            else:
                                veval = (base_d[None, :]
                                         + (vscores - base_d[None, :])
                                         / float(it + 1)
                                         if is_rf else vscores)
                                m = _global_metric(mesh, obj, column(veval),
                                                   valid.y, valid.w,
                                                   device_metric,
                                                   metric=eval_override,
                                                   **valid_kw)
                            _watchdog.report_training_metric(
                                "gbdt", it, loss=m, metric_name=metric_name)
                            stop = es.update(it, m)
                            round_metrics[metric_name] = m
                    if iteration_callback is not None:
                        iteration_callback(it, round_metrics)
                    if stop:
                        break
                    now_round = time.perf_counter()
                    _watchdog.report_training_metric(
                        "gbdt", it, seconds=now_round - t_round)
                    t_round = now_round
                    if (ckpts is not None and checkpoint_period > 0
                            and (it + 1) % checkpoint_period == 0
                            and it + 1 < num_iterations):
                        _save_checkpoint(
                            ckpts, it, mesh, scores, n, valid, es,
                            lambda: finalize(all_trees).model_string(),
                            fingerprint=ckpt_fp,
                            prior_iterations=prior_iterations,
                            valid_fingerprint=valid_fp)
        finally:
            hb.close()
            if unregister_dump is not None:
                unregister_dump()

        tw.mark("boosting", dev)
        booster = finalize(all_trees)
        # a resume cuts as a fresh run does (its trees carry global iteration
        # indices); only a caller's warm start keeps every tree
        if (early_stopping_rounds > 0 and es.best_iter >= 0
                and user_init_booster is None):
            booster = _truncate_booster(booster, es.best_iter + 1)
        if is_rf:
            # the forest's prediction: the base plus the mean of its trees
            booster = _scale_booster_values(
                booster,
                np.full(booster.num_trees, 1.0 / booster.num_iterations))
        boost_span.set(trees=booster.num_trees)
        return booster


def _train_dart(*, dataset, cfg, K, obj, objective, objective_kwargs,
                base_d, valid, depth_cap, es, num_iterations, seed,
                feature_fraction, sampling, grow, is_cat,
                metric_eval_period, drop_rate, max_drop, skip_drop,
                drop_seed, mesh, group, valid_kw,
                iteration_callback) -> Booster:
    """DART boosting (Dropouts meet Multiple Additive Regression Trees;
    LightGBM's ``boosting=dart``, reference: TrainParams.scala:9-10).

    Each iteration drops every earlier tree with probability ``drop_rate``
    (no tree at all with probability ``skip_drop``; at most ``max_drop``),
    fits the new trees' gradients at the ensemble without the dropped
    trees, then scales the new trees by 1/(k+1) and the dropped ones by
    k/(k+1). The drop sets come from ``np.random.default_rng(drop_seed)``
    alone, so the whole schedule is computed first, exactly as in the JAX
    package: ``eff_rows[it]`` holds the per-tree scales entering iteration
    ``it`` with its drop set zeroed, ``post_rows[it]`` the scales after it.

    Each tree's contribution on the training rows is kept on the device,
    ``[num_iterations, n, K]`` f32: ``4 * num_iterations * n * K`` bytes
    (0.16 GB at 10 x 581,012 x 7; 2.8 GB at 100 x 1,000,000 x 7), and the
    same for the validation rows. Scores are summed tree by tree in order,
    so the GPU and the CPU round them alike. The validation metric uses
    the scales after each iteration; early stopping records
    ``best_iteration`` and keeps every tree (dropping later trees would
    leave the earlier ones' scales wrong)."""
    Xbt, y_d, w_d = dataset.Xbt, dataset.y, dataset.w
    F, n_pad = Xbt.shape
    dev = Xbt.device
    T = num_iterations
    scales = np.zeros(T, np.float32)
    rng_drop = np.random.default_rng(drop_seed)
    eff_rows = np.zeros((T, T), np.float32)
    post_rows = np.zeros((T, T), np.float32)
    for it in range(T):
        if it == 0 or rng_drop.uniform() < skip_drop:
            dropped = np.empty(0, np.int64)
        else:
            dropped = np.nonzero(rng_drop.uniform(size=it) < drop_rate)[0]
            if max_drop > 0 and len(dropped) > max_drop:
                dropped = rng_drop.choice(dropped, size=max_drop,
                                          replace=False)
        eff_rows[it] = scales
        eff_rows[it, dropped] = 0.0
        kdrop = len(dropped)
        scales[dropped] *= kdrop / (kdrop + 1.0)
        scales[it] = 1.0 / (kdrop + 1.0)
        post_rows[it] = scales

    def weighted(contribs, row, upto):
        """base + sum over trees t < upto of row[t] * contribs[t], in
        order."""
        acc = torch.zeros_like(contribs[0])
        for t in range(upto):
            acc = acc + contribs[t] * float(row[t])
        return base_d[None, :] + acc

    contribs = torch.zeros((T, n_pad, K), dtype=torch.float32, device=dev)
    if valid is not None:
        vcontribs = torch.zeros((T, valid.Xb.shape[0], K),
                                dtype=torch.float32, device=dev)
    all_trees: List[Tree] = []
    n_done = 0
    hb = _watchdog.register("gbdt_dart_round_loop", stall_seconds=120.0)
    t_round = time.perf_counter()
    try:
        for it in range(T):
            with _spans.span("gbdt.round", counters=_ROUND_COUNTERS,
                             publish=False, iteration=it):
                hb.beat()
                with _spans.span("gbdt.grad_hess", device=dev,
                                 publish=False):
                    sc = weighted(contribs, eff_rows[it], it)
                    grad, hess = _grad_hess(obj, sc if K > 1 else sc[:, 0],
                                            y_d, w_d, group)
                    if K == 1:
                        grad, hess = grad[:, None], hess[:, None]
                with _spans.span("gbdt.grow", device=dev, publish=False):
                    row_mask = sampling(it, grad)
                    fmask = _feature_mask(seed, it, F, feature_fraction, dev)
                    grown = _grow_iteration(grow, Xbt, grad, hess, row_mask,
                                            fmask, cfg, is_cat, seed, it,
                                            group, dataset.n)
                with _spans.span("gbdt.score_update", device=dev,
                                 publish=False):
                    for k, (tree, row_node) in enumerate(grown):
                        contribs[it, :, k] = tree.leaf_value[row_node.long()]
                        all_trees.append(tree)
                        if valid is not None:
                            vcontribs[it, :, k] = predict_tree_binned(
                                tree, valid.Xb, depth_cap, is_cat)
                n_done = it + 1
                round_metrics: Dict[str, float] = {}
                stop = False
                if valid is not None and (it % metric_eval_period == 0
                                          or it == T - 1):
                    vsc = weighted(vcontribs, post_rows[it], it + 1)
                    m = _global_metric(mesh, obj,
                                       vsc if K > 1 else vsc[:, 0],
                                       valid.y, valid.w, es.name,
                                       **valid_kw)
                    _watchdog.report_training_metric("gbdt", it, loss=m,
                                                     metric_name=es.name)
                    stop = es.update(it, m)
                    round_metrics[es.name] = m
                if iteration_callback is not None:
                    iteration_callback(it, round_metrics)
                if stop:
                    break
                now_round = time.perf_counter()
                _watchdog.report_training_metric("gbdt", it,
                                                 seconds=now_round - t_round)
                t_round = now_round
    finally:
        hb.close()
    booster = _finalize_trees(all_trees, dataset.binner, dataset.max_bin, K,
                              host_read(torch.Tensor.cpu, base_d).numpy(),
                              objective, depth_cap,
                              objective_kwargs, es.best_iter, es.history)
    return _scale_booster_values(booster,
                                 np.repeat(post_rows[n_done - 1][:n_done], K))
