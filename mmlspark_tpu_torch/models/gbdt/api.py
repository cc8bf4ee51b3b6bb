"""LightGBM-style estimators and models: the public GBDT API surface.

Counterpart of ``mmlspark_tpu/models/gbdt/api.py`` (reference:
lightgbm/LightGBMClassifier.scala:24-195, LightGBMRegressor.scala,
LightGBMRanker.scala, lightgbm/LightGBMParams.scala): the classifier
(binary and multiclass), the regressor (every regression objective) and
the LambdaRank ranker. Every Param keeps its name and default, so code
written against the JAX package's estimators ports by renaming the import.
The port adds one Param, ``device`` (default ``cuda``), which fit and
transform run on.

Validation sets (``validationIndicatorCol``) with early stopping,
``improvementTolerance``, ``metricEvalPeriod``, ``metric`` overrides and
``isProvideTrainingMetric`` are ported, as are ``growthPolicy`` (leafwise
or depthwise), ``useQuantizedGrad`` with ``quantRenewLeaf`` and
``quantWarmupIters``, ``categoricalSlotIndexes``, ``slotNames``,
``leafPredictionCol`` and ``featuresShapCol`` / ``shapMethod`` (TreeSHAP
or saabas contributions); the training options ``boostingType`` (gbdt,
goss, rf, dart), bagging (plain and pos/neg stratified), warm starts
(``modelString``, ``numBatches``), ``checkpointDir`` resume and
``compactSelector``. Fits without ``checkpointDir`` reuse a binned dataset
of identical data (:func:`_cached_binned_dataset`). Feature columns may be
scipy sparse matrices. The models export and import LightGBM's text format
(``get_native_model``/``save_native_model``/``load_native_model``) and
report feature importances. ``initScoreCol`` is accepted and not read, as
in the JAX package. ``parallelism`` (``data_parallel`` or
``voting_parallel`` with ``topK``) selects how histograms cross the data
group (:mod:`...parallel`): rows are sharded over the
``torch.distributed`` ranks of the default group, one process when none
is initialised; every rank fits on the same global rows and returns the
same model.

Telemetry, as in the JAX package: a ``{uid}.train_booster`` span per fit,
``gbdt_fits_total``, ``gbdt_trained_iterations``, ``gbdt_best_iteration``
and ``gbdt_train_metric`` after it, the training-health audit of its eval
history, and, with ``MMLSPARK_TPU_TELEMETRY_ROUNDS=1``, a ``boost_round``
instant with ``gbdt_boost_rounds_total`` and ``gbdt_round_metric`` per
round. ``MMLSPARK_TPU_BINNED_CACHE=0`` turns the binned-dataset cache off;
its datasets are claimed on the HBM ledger as ``binned_cache``. Beyond the
JAX package, a fit and a ``transform`` run their phases in spans that only
the trace buffer holds (``publish=False``: no metric family, no flight
record): ``gbdt.labels``, ``gbdt.extract``, ``gbdt.binned_cache`` and
``gbdt.transform.features`` / ``.columns`` here, ``gbdt.ingest``,
``gbdt.boost``, ``gbdt.round`` and ``gbdt.predict`` with their phases in
:mod:`.booster` and :mod:`.growth`.
"""

from __future__ import annotations

import hashlib
import os
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ...core.dataset import Dataset, _is_sparse
from ...core.params import (HasFeaturesCol, HasGroupCol, HasInitScoreCol,
                            HasLabelCol, HasPredictionCol, HasProbabilityCol,
                            HasRawPredictionCol, HasValidationIndicatorCol,
                            HasWeightCol, Param, TypeConverters)
from ...core.pipeline import Estimator, Model
from ...device import DEFAULT_DEVICE
from ...observability import hbm as _hbm
from ...observability import metrics as _metrics
from ...observability import spans as _spans
from ...observability import watchdog as _watchdog
from ...parallel import mesh as meshlib
from .booster import Booster, LightGBMDataset, _densify, train_booster
from .growth import GrowConfig, resolve_growth_backend

# Binned datasets of recent fits, keyed by a content fingerprint of the
# training arrays, every binning param, the data group and the device:
# fits that change only learner params on the same rows (a sweep) reuse
# one ingest. Two entries bound the device memory they hold.
_BINNED_CACHE: "OrderedDict" = OrderedDict()
_BINNED_CACHE_MAX = 2
# lookups of the cache since the process started (or the last reset)
_BINNED_CACHE_STATS = {"hits": 0, "misses": 0}


def binned_cache_stats(reset: bool = False) -> dict:
    """``{"hits": h, "misses": m}``: the binned-dataset cache's lookups
    since the process started or the last ``reset=True`` (which zeroes
    them after reading)."""
    out = dict(_BINNED_CACHE_STATS)
    if reset:
        _BINNED_CACHE_STATS.update(hits=0, misses=0)
    return out


def _dataset_nbytes(ds) -> float:
    """Device bytes one cached binned dataset pins (the ``binned_cache``
    HBM-ledger claim): the bin matrix, labels, weights and mask."""
    arrays = {id(a): a for a in (ds.Xbt, ds.y, ds.w, ds.vmask)}
    return float(sum(a.numel() * a.element_size() for a in arrays.values()))


def clear_binned_dataset_cache() -> None:
    """Release the cached binned datasets and the device memory they
    hold."""
    _BINNED_CACHE.clear()
    _hbm.set_claim("binned_cache", 0)


def _cache_enabled() -> bool:
    return os.environ.get("MMLSPARK_TPU_BINNED_CACHE", "1") != "0"


# bytes of a buffer the cache key's crc32 takes in one piece
_KEY_CHUNK = 64 << 20


def _content_key(*arrays) -> str:
    """A content hash of ``arrays`` (None allowed) for the binned-dataset
    cache: each one's shape and dtype and the crc32 of every
    :data:`_KEY_CHUNK` bytes of it, so a changed byte anywhere changes the
    key. The chunks are hashed on a few threads (zlib releases the
    interpreter's lock over a buffer), so a warm fit's lookup over a
    gigabyte of rows takes a fraction of one core's pass. The key lives in
    this process only; a checkpoint's stored fingerprint is
    ``utils/checkpoint.py:data_fingerprint``."""
    h = hashlib.sha256()
    chunks = []
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}".encode())
        raw = a.reshape(-1).view(np.uint8)
        chunks += [raw[i:i + _KEY_CHUNK]
                   for i in range(0, raw.size, _KEY_CHUNK)] or [raw]
        chunks.append(None)                      # the array's end
    parts = [c for c in chunks if c is not None]
    if len(parts) > 1:
        with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as ex:
            crcs = iter(list(ex.map(zlib.crc32, parts)))
    else:
        crcs = iter([zlib.crc32(c) for c in parts])
    for c in chunks:
        h.update(b"|" if c is None else next(crcs).to_bytes(4, "little"))
    return h.hexdigest()[:32]


def _binned_cache_key(X, y, w, *, max_bin, bin_sample_count, seed,
                      categorical_features, bin_dtype, max_bin_by_feature,
                      device, mesh=None, query_offsets=None) -> tuple:
    """The cache key: a scipy sparse ``X`` is fingerprinted by its CSR
    buffers (a hit never densifies); the data group's ranks (``mesh``, else
    the default) and the device (``None`` read as the default, ``cuda``)
    stand in the JAX package's mesh, so a cpu fit never receives a cuda
    dataset; a ranking fit's query offsets are fingerprinted too."""
    if _is_sparse(X):
        X = X.tocsr()
        fp = _content_key(X.data, X.indices, X.indptr, np.asarray(X.shape),
                          y, w)
    else:
        fp = _content_key(X, y, w)
    return (fp, max_bin, bin_sample_count, seed,
            tuple(int(i) for i in categorical_features), str(bin_dtype),
            None if max_bin_by_feature is None
            else tuple(int(b) for b in max_bin_by_feature),
            (mesh or meshlib.get_default_mesh()).ranks,
            None if query_offsets is None
            else _content_key(np.asarray(query_offsets, np.int64)),
            str(torch.device(DEFAULT_DEVICE if device is None else device)))


def _cached_binned_dataset(X, y, w, *, max_bin, bin_sample_count, seed,
                           categorical_features, bin_dtype="int32",
                           max_bin_by_feature=None,
                           device=None, mesh=None,
                           query_offsets=None) -> LightGBMDataset:
    """The binned dataset of these rows and params on ``device`` over the
    data group ``mesh`` (default: the default mesh), built on a miss (the
    least recently used of :data:`_BINNED_CACHE_MAX` entries goes); a
    ranking fit's rows carry their query offsets. With
    ``MMLSPARK_TPU_BINNED_CACHE=0`` every call builds one and nothing is
    kept (nor fingerprinted)."""
    build = dict(max_bin=max_bin, bin_sample_count=bin_sample_count,
                 seed=seed, categorical_features=categorical_features,
                 bin_dtype=bin_dtype, max_bin_by_feature=max_bin_by_feature,
                 device=device, query_offsets=query_offsets)
    if not _cache_enabled():
        return LightGBMDataset.construct(X, y, w, mesh=mesh, **build)
    with _spans.span("gbdt.binned_cache", publish=False) as sp:
        key = _binned_cache_key(X, y, w, mesh=mesh, **build)
        ds = _BINNED_CACHE.get(key)
        sp.set(hit=int(ds is not None))
    if ds is None:
        _BINNED_CACHE_STATS["misses"] += 1
        ds = LightGBMDataset.construct(X, y, w, mesh=mesh, **build)
        _BINNED_CACHE[key] = ds
        _hbm.claim("binned_cache", _dataset_nbytes(ds))
        while len(_BINNED_CACHE) > _BINNED_CACHE_MAX:
            _k, old = _BINNED_CACHE.popitem(last=False)
            _hbm.release("binned_cache", _dataset_nbytes(old))
    else:
        _BINNED_CACHE_STATS["hits"] += 1
        _BINNED_CACHE.move_to_end(key)
    return ds


def _to_tristate_bool(v):
    """Param converter for True | False | "auto"."""
    if isinstance(v, str) and v.strip().lower() == "auto":
        return "auto"
    return TypeConverters.to_bool(v)


def _to_device(v):
    return None if v is None else str(v)


class _LightGBMParams(HasLabelCol, HasFeaturesCol, HasWeightCol,
                      HasInitScoreCol, HasValidationIndicatorCol,
                      HasPredictionCol):
    """Shared LightGBM params (reference: lightgbm/LightGBMParams.scala)."""

    device = Param("device", "Device to fit and score on: 'cuda' (default) "
                   "or 'cpu'", None, _to_device)
    boostingType = Param("boostingType", "gbdt, rf, dart or goss", "gbdt",
                         TypeConverters.to_string)
    numIterations = Param("numIterations", "Number of boosting iterations",
                          100, TypeConverters.to_int)
    learningRate = Param("learningRate", "Shrinkage rate", 0.1,
                         TypeConverters.to_float)
    numLeaves = Param("numLeaves", "Max leaves per tree", 31,
                      TypeConverters.to_int)
    maxDepth = Param("maxDepth", "Max tree depth (<=0: unlimited)", -1,
                     TypeConverters.to_int)
    maxBin = Param("maxBin", "Max feature bins", 255, TypeConverters.to_int)
    binSampleCount = Param("binSampleCount",
                           "Rows sampled to pick bin boundaries", 200000,
                           TypeConverters.to_int)
    baggingFraction = Param("baggingFraction", "Row subsample fraction", 1.0,
                            TypeConverters.to_float)
    baggingFreq = Param("baggingFreq", "Resample every k iterations (0=off)",
                        0, TypeConverters.to_int)
    baggingSeed = Param("baggingSeed", "Bagging seed", 3,
                        TypeConverters.to_int)
    featureFraction = Param("featureFraction", "Feature subsample per tree",
                            1.0, TypeConverters.to_float)
    lambdaL1 = Param("lambdaL1", "L1 regularization", 0.0,
                     TypeConverters.to_float)
    lambdaL2 = Param("lambdaL2", "L2 regularization", 0.0,
                     TypeConverters.to_float)
    minDataInLeaf = Param("minDataInLeaf", "Minimum rows per leaf", 20,
                          TypeConverters.to_int)
    minSumHessianInLeaf = Param("minSumHessianInLeaf",
                                "Minimum hessian sum per leaf", 1e-3,
                                TypeConverters.to_float)
    minGainToSplit = Param("minGainToSplit", "Minimum gain to make a split",
                           0.0, TypeConverters.to_float)
    earlyStoppingRound = Param("earlyStoppingRound", "Stop if validation "
                               "metric stalls this many rounds (0=off)", 0,
                               TypeConverters.to_int)
    metricEvalPeriod = Param("metricEvalPeriod",
                             "Evaluate metrics every k iterations", 1,
                             TypeConverters.to_int)
    numBatches = Param("numBatches", "Split data into sequential batches, "
                       "warm-starting each", 0, TypeConverters.to_int)
    modelString = Param("modelString", "Warm-start model string", None,
                        TypeConverters.to_string)
    checkpointDir = Param("checkpointDir", "Step-level checkpoint directory",
                          None, TypeConverters.to_string)
    checkpointInterval = Param("checkpointInterval",
                               "Iterations between checkpoints", 10,
                               TypeConverters.to_int)
    verbosity = Param("verbosity", "Log verbosity", -1, TypeConverters.to_int)
    growthPolicy = Param("growthPolicy", "leafwise (best-first, batched: top "
                         "leafBatch pending leaves split per histogram pass) "
                         "or depthwise", "leafwise", TypeConverters.to_string)
    leafBatch = Param("leafBatch", "Leafwise growth: pending leaves split "
                      "per fused histogram pass; 1 = strict sequential "
                      "best-first (LightGBM's exact order)", 8,
                      TypeConverters.to_int)
    parallelism = Param("parallelism", "data_parallel or voting_parallel",
                        "data_parallel", TypeConverters.to_string)
    topK = Param("topK", "Features each shard votes for under "
                 "voting_parallel", 20, TypeConverters.to_int)
    topRate = Param("topRate", "GOSS: top-gradient retain fraction", 0.2,
                    TypeConverters.to_float)
    otherRate = Param("otherRate", "GOSS: random retain fraction of the "
                      "rest", 0.1, TypeConverters.to_float)
    dropRate = Param("dropRate", "DART: per-tree dropout probability", 0.1,
                     TypeConverters.to_float)
    maxDrop = Param("maxDrop", "DART: max trees dropped per iteration", 50,
                    TypeConverters.to_int)
    skipDrop = Param("skipDrop", "DART: probability of skipping dropout for "
                     "an iteration", 0.5, TypeConverters.to_float)
    dropSeed = Param("dropSeed", "DART: dropout random seed", 4,
                     TypeConverters.to_int)
    defaultListenPort = Param("defaultListenPort", "Ignored (no socket "
                              "ring)", 12400, TypeConverters.to_int)
    timeout = Param("timeout", "Ignored (no rendezvous)", 1200.0,
                    TypeConverters.to_float)
    useBarrierExecutionMode = Param("useBarrierExecutionMode", "Ignored",
                                    False, TypeConverters.to_bool)
    boostFromAverage = Param("boostFromAverage", "Init score from label mean",
                             True, TypeConverters.to_bool)
    leafPredictionCol = Param("leafPredictionCol", "If set, output per-tree "
                              "leaf indices here", None,
                              TypeConverters.to_string)
    featuresShapCol = Param("featuresShapCol", "If set, output per-feature "
                            "contributions here", None,
                            TypeConverters.to_string)
    shapMethod = Param("shapMethod", "featuresShapCol algorithm: 'treeshap' "
                       "or 'saabas'", "treeshap", TypeConverters.to_string)
    categoricalSlotIndexes = Param("categoricalSlotIndexes", "Feature-vector "
                                   "slots to treat as categorical", None)
    useQuantizedGrad = Param("useQuantizedGrad", "Quantized-gradient "
                             "histograms (LightGBM use_quantized_grad)",
                             False, TypeConverters.to_bool)
    quantRenewLeaf = Param("quantRenewLeaf", "With useQuantizedGrad: renew "
                           "leaf outputs from f32 grad/hess", True,
                           TypeConverters.to_bool)
    quantWarmupIters = Param("quantWarmupIters", "With useQuantizedGrad: "
                             "full-precision iterations first", 2,
                             TypeConverters.to_int)
    binDtype = Param("binDtype", "Storage dtype of the device-resident "
                     "binned matrix: int32 (default), int16 or uint8",
                     "int32", TypeConverters.to_string)
    histSubtraction = Param("histSubtraction", "Parent-minus-sibling "
                            "histogram subtraction by smaller-child row "
                            "compaction. True | False | 'auto' (on for the "
                            "GPU and the CPU)", "auto", _to_tristate_bool)
    compactSelector = Param("compactSelector", "Row-compaction selector for "
                            "histSubtraction: searchsorted, argsort or "
                            "'auto' (searchsorted)", "auto",
                            TypeConverters.to_string)
    categoricalSlotNames = Param("categoricalSlotNames", "Categorical slots "
                                 "by feature name", None)
    improvementTolerance = Param("improvementTolerance", "Early stopping "
                                 "improvement tolerance", 0.0,
                                 TypeConverters.to_float)
    isProvideTrainingMetric = Param("isProvideTrainingMetric", "Record the "
                                    "training-set metric every iteration",
                                    False, TypeConverters.to_bool)
    posBaggingFraction = Param("posBaggingFraction", "Stratified bagging: "
                               "keep probability for positive rows", 1.0,
                               TypeConverters.to_float)
    negBaggingFraction = Param("negBaggingFraction", "Stratified bagging: "
                               "keep probability for negative rows", 1.0,
                               TypeConverters.to_float)
    maxDeltaStep = Param("maxDeltaStep", "Clamp each leaf's raw output to "
                         "+-this before shrinkage (0 = off)", 0.0,
                         TypeConverters.to_float)
    maxBinByFeature = Param("maxBinByFeature", "Per-feature max bin counts",
                            None)
    metric = Param("metric", "Validation/early-stopping metric override",
                   None, TypeConverters.to_string)
    slotNames = Param("slotNames", "Feature names for the feature-vector "
                      "slots", None)
    driverListenPort = Param("driverListenPort", "Ignored", 0,
                             TypeConverters.to_int)
    numTasks = Param("numTasks", "Ignored", 0, TypeConverters.to_int)
    repartitionByGroupingColumn = Param("repartitionByGroupingColumn",
                                        "Ignored", True,
                                        TypeConverters.to_bool)

    def _grow_config(self) -> GrowConfig:
        return resolve_growth_backend(GrowConfig(
            num_leaves=self.get_or_default("numLeaves"),
            max_depth=self.get_or_default("maxDepth"),
            num_bins=self.get_or_default("maxBin"),
            learning_rate=self.get_or_default("learningRate"),
            lambda_l1=self.get_or_default("lambdaL1"),
            lambda_l2=self.get_or_default("lambdaL2"),
            min_data_in_leaf=self.get_or_default("minDataInLeaf"),
            min_sum_hessian_in_leaf=self.get_or_default(
                "minSumHessianInLeaf"),
            min_gain_to_split=self.get_or_default("minGainToSplit"),
            voting=self.get_or_default("parallelism") == "voting_parallel",
            top_k=self.get_or_default("topK"),
            leaf_batch=self.get_or_default("leafBatch"),
            hist_subtraction=self.get_or_default("histSubtraction"),
            max_delta_step=self.get_or_default("maxDeltaStep"),
            growth_policy=self.get_or_default("growthPolicy"),
            quantized_grad=self.get_or_default("useQuantizedGrad"),
            quant_renew_leaf=self.get_or_default("quantRenewLeaf"),
            quant_warmup_iters=self.get_or_default("quantWarmupIters"),
            compact_selector=self.get_or_default("compactSelector"),
        ))

    def _extract_arrays(self, dataset: Dataset):
        """(X, y, weight or None) as float32, X the features column itself
        where it is a float32 array already (no copy: a refit on cached bins
        then reads its rows once, for the cache key); a scipy sparse
        features column stays sparse (training densifies it in row
        blocks)."""
        fcol = self.get_or_default("featuresCol")
        raw = dataset[fcol]
        X = raw if _is_sparse(raw) else np.asarray(raw, np.float32)
        y = dataset.array(self.get_or_default("labelCol"), np.float32)
        wcol = self.get_or_default("weightCol")
        w = dataset.array(wcol, np.float32) if wcol else None
        return X, y, w

    def _categorical_indexes(self):
        if self.get_or_default("categoricalSlotNames"):
            raise ValueError(
                "categoricalSlotNames requires named feature slots; this "
                "columnar Dataset API carries plain arrays — use "
                "categoricalSlotIndexes")
        idx = self.get_or_default("categoricalSlotIndexes")
        return tuple(int(i) for i in idx) if idx else ()

    def _apply_slot_names(self, booster: Booster) -> Booster:
        """Record slotNames as the model's feature names (they become the
        native model's ``feature_names``; reference: LightGBMParams
        slotNames)."""
        names = self.get_or_default("slotNames")
        if names:
            F = booster.binner_state.get("num_features")
            if F is not None and len(names) != F:
                raise ValueError(
                    f"slotNames has {len(names)} entries for {F} features")
            names = [str(x) for x in names]
            bad = [x for x in names if not x or any(c.isspace() for c in x)]
            if bad:
                # the native text format is whitespace-delimited
                raise ValueError(
                    f"slotNames must be non-empty and whitespace-free for "
                    f"native-model interop; got {bad[:3]}")
            booster.binner_state["feature_names"] = names
        return booster

    def _split_validation(self, dataset: Dataset):
        """validationIndicatorCol semantics (reference:
        LightGBMBase.scala:214-219): (training rows, validation rows or
        None)."""
        vcol = self.get_or_default("validationIndicatorCol")
        if not vcol or vcol not in dataset:
            return dataset, None
        mask = dataset.array(vcol).astype(bool)
        return dataset.filter(~mask), dataset.filter(mask)

    def _round_callback(self):
        """The per-round telemetry callback, or None unless
        ``MMLSPARK_TPU_TELEMETRY_ROUNDS=1`` (and metrics are on): a
        ``boost_round`` instant, ``gbdt_boost_rounds_total``, the round's
        wall time and metrics to the training-health sentinels, and
        ``gbdt_round_metric`` per metric."""
        if not (_metrics.enabled()
                and os.environ.get("MMLSPARK_TPU_TELEMETRY_ROUNDS") == "1"):
            return None
        cls = type(self).__name__
        last = [time.perf_counter()]

        def cb(it: int, round_metrics: dict) -> None:
            vals = {k: float(v) for k, v in round_metrics.items()}
            _spans.instant("boost_round", model=cls, iteration=it, **vals)
            _metrics.safe_counter("gbdt_boost_rounds_total", model=cls).inc()
            now = time.perf_counter()
            _watchdog.report_training_metric(cls, it, seconds=now - last[0])
            last[0] = now
            for k, v in vals.items():
                _metrics.safe_gauge("gbdt_round_metric",
                                    model=cls, metric=k).set(v)
                _watchdog.report_training_metric(cls, it, loss=v,
                                                 metric_name=k)
        return cb

    def _publish_booster_telemetry(self, booster: Booster) -> None:
        """The registry's view of a finished fit: its count, iterations,
        best iteration and the last value of each metric series; the
        training-health audit of its eval history; a fresh device-memory
        sample (the binned-dataset cache keeps device memory across
        fits)."""
        if not _metrics.enabled():
            return
        cls = type(self).__name__
        _metrics.safe_counter("gbdt_fits_total", model=cls).inc()
        _metrics.safe_gauge("gbdt_trained_iterations",
                            model=cls).set(booster.num_iterations)
        if booster.best_iteration is not None and booster.best_iteration >= 0:
            _metrics.safe_gauge("gbdt_best_iteration",
                                model=cls).set(booster.best_iteration)
        for mname, series in (booster.eval_history or {}).items():
            if series:
                _metrics.safe_gauge("gbdt_train_metric", model=cls,
                                    metric=str(mname)).set(float(series[-1]))
        _watchdog.scan_eval_history(cls, booster.eval_history)
        from ...observability.device import device_memory_gauges
        device_memory_gauges()

    def _fit_booster(self, dataset: Dataset, objective: str, num_class: int,
                     objective_kwargs: Optional[dict] = None) -> Booster:
        """Fit in a ``{uid}.train_booster`` span with fresh training-health
        windows for this estimator, then publish the fit's telemetry."""
        cls = type(self).__name__
        _watchdog.reset_training_health(cls)
        with _spans.span(f"{self.uid}.train_booster",
                         metric_label=f"{cls}.train_booster",
                         objective=objective, num_class=num_class):
            booster = self._fit_booster_impl(dataset, objective, num_class,
                                             objective_kwargs)
        self._publish_booster_telemetry(booster)
        return booster

    def _train_kwargs(self, objective: str, num_class: int,
                      objective_kwargs: Optional[dict] = None) -> dict:
        """The keyword arguments of ``train_booster`` that this estimator's
        params set (all but the rows, ``num_iterations``, the validation
        set and the warm start): one place for ``fit`` and the automl
        sweep's trials."""
        return dict(
            checkpoint_dir=self.get_or_default("checkpointDir"),
            checkpoint_period=self.get_or_default("checkpointInterval"),
            objective=objective, num_class=num_class,
            cfg=self._grow_config(),
            max_bin=self.get_or_default("maxBin"),
            bin_sample_count=self.get_or_default("binSampleCount"),
            feature_fraction=self.get_or_default("featureFraction"),
            bagging_fraction=self.get_or_default("baggingFraction"),
            bagging_freq=self.get_or_default("baggingFreq"),
            seed=self.get_or_default("baggingSeed"),
            early_stopping_rounds=self.get_or_default("earlyStoppingRound"),
            metric_eval_period=self.get_or_default("metricEvalPeriod"),
            boost_from_average=self.get_or_default("boostFromAverage"),
            objective_kwargs=objective_kwargs or {},
            boosting_type=self.get_or_default("boostingType"),
            top_rate=self.get_or_default("topRate"),
            other_rate=self.get_or_default("otherRate"),
            drop_rate=self.get_or_default("dropRate"),
            max_drop=self.get_or_default("maxDrop"),
            skip_drop=self.get_or_default("skipDrop"),
            drop_seed=self.get_or_default("dropSeed"),
            categorical_features=self._categorical_indexes(),
            bin_dtype=self.get_or_default("binDtype"),
            pos_bagging_fraction=self.get_or_default("posBaggingFraction"),
            neg_bagging_fraction=self.get_or_default("negBaggingFraction"),
            early_stopping_tolerance=self.get_or_default(
                "improvementTolerance"),
            provide_training_metric=self.get_or_default(
                "isProvideTrainingMetric"),
            max_bin_by_feature=self.get_or_default("maxBinByFeature"),
            eval_metric_name=self.get_or_default("metric"),
            device=self.get_or_default("device"),
            iteration_callback=self._round_callback())

    def _fit_booster_impl(self, dataset: Dataset, objective: str,
                          num_class: int,
                          objective_kwargs: Optional[dict] = None
                          ) -> Booster:
        """Fit through ``train_booster`` as the JAX estimators do: a
        ``modelString`` warm start; ``numBatches`` sequential batches, each
        binned from its own rows and warm-started from the previous one
        (reference: LightGBMBase.scala:28-50); without ``checkpointDir``, a
        cached binned dataset."""
        with _spans.span("gbdt.extract", publish=False) as sp:
            train_ds, valid_ds = self._split_validation(dataset)
            X, y, w = self._extract_arrays(train_ds)
            sp.set(rows=int(np.shape(X)[0]), features=int(np.shape(X)[1]))
        valid_set = None
        if valid_ds is not None and len(valid_ds) > 0:
            valid_set = self._extract_arrays(valid_ds)
        init_booster = None
        ms = self.get_or_default("modelString")
        if ms:
            init_booster = Booster.from_string(ms)
        common = self._train_kwargs(objective, num_class,
                                    objective_kwargs)
        num_iterations = self.get_or_default("numIterations")
        num_batches = self.get_or_default("numBatches")
        if num_batches and num_batches > 1:
            if common["boosting_type"] in ("rf", "dart"):
                # fail before batch 0 trains: batch 1 would refuse the
                # warm start
                raise ValueError(
                    f"numBatches > 1 is not supported with boostingType="
                    f"{common['boosting_type']!r} (its trees carry "
                    "normalization state that a warm-start prefix lacks)")
            bounds = np.linspace(0, len(y), num_batches + 1).astype(int)
            booster = init_booster
            base_ckpt = common["checkpoint_dir"]
            for i in range(num_batches):
                sl = slice(bounds[i], bounds[i + 1])
                if base_ckpt:
                    # one directory per batch: batch i never resumes from
                    # batch i-1's checkpoints
                    common["checkpoint_dir"] = os.path.join(
                        base_ckpt, f"batch_{i:04d}")
                booster = train_booster(
                    X[sl], y[sl], None if w is None else w[sl],
                    num_iterations=num_iterations, valid_set=valid_set,
                    init_booster=booster, **common)
            return self._apply_slot_names(booster)
        if common["checkpoint_dir"] is None:
            dset = _cached_binned_dataset(
                X, y, w, max_bin=common["max_bin"],
                bin_sample_count=common["bin_sample_count"],
                seed=common["seed"],
                categorical_features=common["categorical_features"],
                bin_dtype=common["bin_dtype"],
                max_bin_by_feature=common["max_bin_by_feature"],
                device=common["device"])
            return self._apply_slot_names(train_booster(
                X=X if init_booster is not None else None, dataset=dset,
                num_iterations=num_iterations, valid_set=valid_set,
                init_booster=init_booster, **common))
        return self._apply_slot_names(train_booster(
            X, y, w, num_iterations=num_iterations, valid_set=valid_set,
            init_booster=init_booster, **common))


def _features_dense(dataset: Dataset, col: str) -> np.ndarray:
    """The features column as dense f32; a scipy sparse matrix is
    densified in row blocks (LGBM_DatasetCreateFromCSR parity)."""
    raw = dataset[col]
    if _is_sparse(raw):
        return _densify(raw)
    return dataset.array(col, np.float32)


class _LightGBMModelBase(Model, _LightGBMParams):
    """Shared trained-model behavior (introspection, native model export,
    persistence)."""

    def __init__(self, booster: Optional[Booster] = None, **kwargs):
        super().__init__(**kwargs)
        self.booster = booster

    def _add_introspection_cols(self, dataset: Dataset, X) -> Dataset:
        """``leafPredictionCol``: each row's leaf slot in every tree;
        ``featuresShapCol``: each row's per-feature contributions by
        ``shapMethod`` (``Booster.predict_contrib``)."""
        dev = self.get_or_default("device")
        leaf_col = self.get_or_default("leafPredictionCol")
        if leaf_col:
            dataset = dataset.with_column(
                leaf_col, self.booster.predict_leaf(
                    X, device=dev).astype(np.float64))
        shap_col = self.get_or_default("featuresShapCol")
        if shap_col:
            dataset = dataset.with_column(
                shap_col, self.booster.predict_contrib(
                    X, method=self.get_or_default("shapMethod"), device=dev
                ).astype(np.float64))
        return dataset

    def get_feature_importances(self, importance_type: str = "split"):
        return self.booster.feature_importances(importance_type).tolist()

    def get_native_model(self) -> str:
        """The model as LightGBM text (loads in any LightGBM tooling;
        reference: LightGBMModelMethods getNativeModel)."""
        return self.booster.to_lightgbm_string()

    def save_native_model(self, path: str) -> None:
        """Write LightGBM's ``tree`` v3 text format (reference:
        LightGBMClassifier.scala:172-194 saveNativeModel)."""
        with open(path, "w") as f:
            f.write(self.booster.to_lightgbm_string())

    @staticmethod
    def _read_native(path: str) -> Booster:
        with open(path) as f:
            return Booster.from_string(f.read())

    def _save_extra(self, path: str) -> None:
        self.booster.save(os.path.join(path, "booster"))

    def _load_extra(self, path: str) -> None:
        self.booster = Booster.load(os.path.join(path, "booster"))


class LightGBMClassifier(Estimator, _LightGBMParams, HasRawPredictionCol,
                         HasProbabilityCol):
    """GBDT classifier (reference: lightgbm/LightGBMClassifier.scala:24-66):
    ``binary`` for labels in {0, 1}, ``multiclass`` (one tree per class and
    iteration) for more classes."""

    objective = Param("objective", "binary or multiclass (auto from label "
                      "arity)", None, TypeConverters.to_string)
    isUnbalance = Param("isUnbalance", "Upweight the minority class (binary)",
                        False, TypeConverters.to_bool)
    thresholds = Param("thresholds", "Per-class prediction thresholds", None,
                       TypeConverters.to_list_float)

    def fit(self, dataset: Dataset) -> "LightGBMClassificationModel":
        with _spans.span("gbdt.labels", publish=False) as sp:
            y = dataset.array(self.get_or_default("labelCol"))
            classes = np.unique(y[~np.isnan(y.astype(np.float64))])
            sp.set(rows=len(y))
        if classes.size and (classes.min() < 0 or
                             not np.allclose(classes, classes.astype(int))):
            raise ValueError(
                "labels must be non-negative integers 0..k-1; got values "
                f"{classes[:5]}")
        num_class = max(int(classes.max()) + 1 if classes.size else 2, 2)
        obj = self.get_or_default("objective")
        if obj is None:
            obj = "binary" if num_class <= 2 else "multiclass"
        if obj == "binary" and num_class > 2:
            raise ValueError(f"binary objective needs labels in {{0,1}}, got "
                             f"{num_class} classes")
        kwargs = {}
        if obj == "binary" and self.get_or_default("isUnbalance"):
            pos = float((y > 0).sum())
            kwargs["pos_weight"] = float(len(y) - pos) / max(pos, 1.0)
        booster = self._fit_booster(
            dataset, obj, num_class if obj == "multiclass" else 1, kwargs)
        model = LightGBMClassificationModel(booster, numClasses=num_class)
        self._copy_params_to(model)
        return model


class LightGBMClassificationModel(_LightGBMModelBase, HasRawPredictionCol,
                                  HasProbabilityCol):
    numClasses = Param("numClasses", "Number of classes", 2,
                       TypeConverters.to_int)
    thresholds = Param("thresholds", "Per-class prediction thresholds", None,
                       TypeConverters.to_list_float)

    def get_actual_num_classes(self) -> int:
        return max(self.booster.num_class, 2)

    def transform(self, dataset: Dataset) -> Dataset:
        with _spans.span("gbdt.transform.features", publish=False,
                         rows=len(dataset)):
            X = _features_dense(dataset, self.get_or_default("featuresCol"))
        raw = self.booster.predict_raw(X, device=self.get_or_default("device"))
        with _spans.span("gbdt.transform.columns", publish=False,
                         rows=len(raw)):
            if self.booster.num_class == 1:      # binary: [neg, pos] margins
                margins = np.concatenate([-raw, raw], axis=1)
                p1 = torch.sigmoid(torch.from_numpy(raw[:, 0])).numpy()
                probs = np.stack([1 - p1, p1], axis=1)
            else:
                margins = raw
                probs = torch.softmax(torch.from_numpy(raw), dim=1).numpy()
            th = self.get_or_default("thresholds")
            scaled = probs / np.asarray(th)[None, :] if th else probs
            out = dataset.with_columns({
                self.get_or_default("rawPredictionCol"): margins,
                self.get_or_default("probabilityCol"): probs,
                self.get_or_default("predictionCol"):
                    scaled.argmax(axis=1).astype(np.float64),
            })
            return self._add_introspection_cols(out, X)

    @staticmethod
    def load_native_model(path: str) -> "LightGBMClassificationModel":
        booster = _LightGBMModelBase._read_native(path)
        k = 2 if booster.num_class == 1 else booster.num_class
        return LightGBMClassificationModel(booster, numClasses=k)


class LightGBMRegressor(Estimator, _LightGBMParams):
    """GBDT regressor (reference: lightgbm/LightGBMRegressor.scala;
    objectives per TrainParams.scala:86-104): l2, l1, huber, fair,
    quantile, poisson, tweedie, mape."""

    objective = Param("objective", "regression|regression_l1|huber|fair|"
                      "poisson|quantile|mape|tweedie", "regression",
                      TypeConverters.to_string)
    alpha = Param("alpha", "Huber/quantile alpha", 0.9,
                  TypeConverters.to_float)
    tweedieVariancePower = Param("tweedieVariancePower",
                                 "Tweedie variance power in [1, 2)", 1.5,
                                 TypeConverters.to_float)

    def fit(self, dataset: Dataset) -> "LightGBMRegressionModel":
        obj = self.get_or_default("objective")
        kwargs = {}
        if obj in ("huber", "quantile"):
            kwargs["alpha"] = self.get_or_default("alpha")
        if obj == "tweedie":
            kwargs["tweedie_variance_power"] = self.get_or_default(
                "tweedieVariancePower")
        booster = self._fit_booster(dataset, obj, 1, kwargs)
        model = LightGBMRegressionModel(booster)
        self._copy_params_to(model)
        return model


class LightGBMRegressionModel(_LightGBMModelBase):
    def transform(self, dataset: Dataset) -> Dataset:
        X = _features_dense(dataset, self.get_or_default("featuresCol"))
        pred = self.booster.predict(X, device=self.get_or_default("device"))
        out = dataset.with_column(self.get_or_default("predictionCol"),
                                  pred.astype(np.float64))
        return self._add_introspection_cols(out, X)

    @staticmethod
    def load_native_model(path: str) -> "LightGBMRegressionModel":
        return LightGBMRegressionModel(_LightGBMModelBase._read_native(path))


def _pad_groups(X: np.ndarray, y: np.ndarray, w: Optional[np.ndarray],
                group: np.ndarray, S: int, n_shard_multiple: int = 1):
    """Sort rows by group and pad every query group to a static width S
    (the ranker's layout over a data group of several ranks, and the JAX
    package's everywhere).

    Each group becomes a fixed [S] block (rows beyond S are truncated), and
    the group count is padded to a multiple of ``n_shard_multiple`` (the
    data group's size: each rank then holds whole groups). Returns (Xp,
    yp, wp, valid, n_groups) with Xp of shape [G_pad*S, F]."""
    group = np.asarray(group)
    order = np.argsort(group, kind="stable")
    X, y = X[order], y[order]
    w = None if w is None else w[order]
    _, starts, counts = np.unique(group[order], return_index=True,
                                  return_counts=True)
    G = len(starts)
    G_pad = -(-G // n_shard_multiple) * n_shard_multiple
    F = X.shape[1]
    Xp = np.zeros((G_pad * S, F), dtype=np.float32)
    yp = np.zeros(G_pad * S, dtype=np.float32)
    wp = np.zeros(G_pad * S, dtype=np.float32)
    valid = np.zeros(G_pad * S, dtype=np.float32)
    for g in range(G):
        c = min(int(counts[g]), S)
        sl = slice(starts[g], starts[g] + c)
        dst = slice(g * S, g * S + c)
        Xp[dst], yp[dst] = X[sl], y[sl]
        wp[dst] = 1.0 if w is None else w[sl]
        valid[dst] = 1.0
    return Xp, yp, wp, valid, G


def _sort_groups(X, y: np.ndarray, w: Optional[np.ndarray],
                 group: np.ndarray):
    """Rows sorted by query, stably, every row kept: ``(X, y, w, offsets)``
    with ``offsets`` ``[G + 1]`` int64, query ``q`` holding rows
    ``[offsets[q], offsets[q + 1])``. Rows already in order are not
    copied."""
    group = np.asarray(group)
    if group.size > 1 and np.any(group[1:] < group[:-1]):
        order = np.argsort(group, kind="stable")
        X, y, group = X[order], y[order], group[order]
        w = None if w is None else w[order]
    starts = np.flatnonzero(np.r_[True, group[1:] != group[:-1]]
                            if group.size else np.zeros(0, bool))
    return X, y, w, np.r_[starts, group.size].astype(np.int64)


class LightGBMRanker(Estimator, _LightGBMParams, HasGroupCol):
    """LambdaRank (reference: lightgbm/LightGBMRanker.scala).

    Rows are sorted by query, stably, and every row is kept: the lambdas
    are taken over query groups of any length (on the card one launch of
    ``csrc/lambdarank.cu`` a round), and the fit goes through the
    binned-dataset cache, keyed by the query offsets too. Over a data
    group of several ranks the groups are padded to a static width
    (``maxGroupSize``, or the next power of two above the largest group if
    smaller; rows past it are truncated), so each rank holds whole groups,
    as in the JAX package. A validation set is scored by NDCG at
    ``max(evalAt)``, averaged over its groups."""

    objective = Param("objective", "ranking objective", "lambdarank",
                      TypeConverters.to_string)
    labelGain = Param("labelGain", "NDCG gain per relevance grade: grade "
                      "g scores labelGain[g] (reference: LightGBMRanker "
                      "labelGain; default 2^g - 1)", None,
                      TypeConverters.to_list_float)
    maxPosition = Param("maxPosition", "NDCG truncation position "
                        "(reference: TrainParams maxPosition)", 20,
                        TypeConverters.to_int)
    evalAt = Param("evalAt", "Positions for NDCG evaluation", [1, 3, 5, 10],
                   TypeConverters.to_list_int)
    maxGroupSize = Param("maxGroupSize",
                         "Static padded width per query group over a data "
                         "group of several ranks (rows beyond it are "
                         "truncated there); one process keeps every row of "
                         "every group", 128, TypeConverters.to_int)
    sigma = Param("sigma", "LambdaRank sigmoid steepness", 1.0,
                  TypeConverters.to_float)

    def _rank_kwargs(self, y: np.ndarray) -> dict:
        eval_at = self.get_or_default("evalAt") or []
        kwargs = dict(max_position=self.get_or_default("maxPosition"),
                      sigma=self.get_or_default("sigma"),
                      eval_at=int(max(eval_at)) if eval_at else 0)
        lg = self.get_or_default("labelGain")
        if lg is not None:
            # LightGBM fails fast when a grade exceeds the gain table
            max_grade = int(np.nanmax(y)) if len(y) else 0
            if max_grade >= len(lg):
                raise ValueError(
                    f"labelGain has {len(lg)} entries but the data "
                    f"contains relevance grade {max_grade}")
            kwargs["label_gain"] = tuple(float(g) for g in lg)
        return kwargs

    def _ranker_kwargs(self) -> dict:
        """Exactly the JAX ranker's arguments: no categorical slots, bin
        dtype, warm start, checkpoints or GOSS/DART/stratified params
        (ROADMAP Queue 3); compactSelector reaches it through the
        config."""
        return dict(
            objective="lambdarank", num_class=1, cfg=self._grow_config(),
            max_bin=self.get_or_default("maxBin"),
            bin_sample_count=self.get_or_default("binSampleCount"),
            feature_fraction=self.get_or_default("featureFraction"),
            bagging_fraction=self.get_or_default("baggingFraction"),
            bagging_freq=self.get_or_default("baggingFreq"),
            seed=self.get_or_default("baggingSeed"),
            num_iterations=self.get_or_default("numIterations"),
            early_stopping_rounds=self.get_or_default("earlyStoppingRound"),
            early_stopping_tolerance=self.get_or_default(
                "improvementTolerance"),
            provide_training_metric=self.get_or_default(
                "isProvideTrainingMetric"),
            max_bin_by_feature=self.get_or_default("maxBinByFeature"),
            eval_metric_name=self.get_or_default("metric"),
            metric_eval_period=self.get_or_default("metricEvalPeriod"),
            boost_from_average=False,
            boosting_type=self.get_or_default("boostingType"),
            device=self.get_or_default("device"))

    def fit(self, dataset: Dataset) -> "LightGBMRankerModel":
        train_ds, valid_ds = self._split_validation(dataset)
        gcol = self.get_or_default("groupCol")
        if not gcol:
            raise ValueError("LightGBMRanker requires groupCol")
        nshards = meshlib.num_shards(meshlib.get_default_mesh())
        X, y, w = self._extract_arrays(train_ds)
        X = _densify(X)
        group = np.asarray(train_ds[gcol])
        has_valid = valid_ds is not None and len(valid_ds) > 0
        if nshards > 1:
            booster = self._fit_padded(X, y, w, group, valid_ds if has_valid
                                       else None, gcol, nshards)
        else:
            with _spans.span("gbdt.rank.groups", publish=False) as sp:
                X, y, w, offsets = _sort_groups(X, y, w, group)
                sp.set(queries=len(offsets) - 1, rows=len(y))
            valid_set = None
            if has_valid:
                Xv, yv, _ = self._extract_arrays(valid_ds)
                Xv, yv, _, voff = _sort_groups(_densify(Xv), yv, None,
                                               np.asarray(valid_ds[gcol]))
                valid_set = (Xv, yv, None, voff)
            common = self._ranker_kwargs()
            rank_kw = self._rank_kwargs(y)
            dset = _cached_binned_dataset(
                X, y, w, max_bin=common["max_bin"],
                bin_sample_count=common["bin_sample_count"],
                seed=common["seed"], categorical_features=(),
                max_bin_by_feature=common["max_bin_by_feature"],
                device=common["device"], query_offsets=offsets)
            booster = train_booster(dataset=dset, valid_set=valid_set,
                                    objective_kwargs=rank_kw, **common)
        model = LightGBMRankerModel(self._apply_slot_names(booster))
        self._copy_params_to(model)
        return model

    def _fit_padded(self, X, y, w, group, valid_ds, gcol: str,
                    nshards: int) -> Booster:
        """Over a data group of several ranks: every query group padded to
        one static width S (rows past it truncated), each rank holding
        whole groups, padding masked out through ``row_valid``."""
        sizes = np.unique(group, return_counts=True)[1]
        S = int(min(self.get_or_default("maxGroupSize"),
                    1 << int(np.ceil(np.log2(max(sizes.max(), 2))))))
        Xp, yp, wp, valid, _ = _pad_groups(X, y, w, group, S, nshards)
        valid_set = None
        if valid_ds is not None:
            Xv, yv, _ = self._extract_arrays(valid_ds)
            Xvp, yvp, _, validv, _ = _pad_groups(
                _densify(Xv), yv, None, np.asarray(valid_ds[gcol]), S,
                nshards)
            # per-row metric weight 1/group size: the weighted mean is the
            # mean NDCG over groups
            gsz = validv.reshape(-1, S).sum(axis=1)
            wv = (validv.reshape(-1, S)
                  / np.maximum(gsz, 1.0)[:, None]).reshape(-1)
            valid_set = (Xvp, yvp, wv.astype(np.float32))
        return train_booster(
            Xp, yp, wp, valid_set=valid_set, row_valid=valid,
            objective_kwargs=dict(group_size=S, **self._rank_kwargs(yp)),
            **self._ranker_kwargs())


class LightGBMRankerModel(_LightGBMModelBase):
    def transform(self, dataset: Dataset) -> Dataset:
        X = _features_dense(dataset, self.get_or_default("featuresCol"))
        score = self.booster.predict_raw(
            X, device=self.get_or_default("device"))[:, 0]
        out = dataset.with_column(self.get_or_default("predictionCol"),
                                  score.astype(np.float64))
        return self._add_introspection_cols(out, X)

    @staticmethod
    def load_native_model(path: str) -> "LightGBMRankerModel":
        return LightGBMRankerModel(_LightGBMModelBase._read_native(path))
