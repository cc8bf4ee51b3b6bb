"""Utility transformers — the pipeline glue library.

Counterpart of ``mmlspark_tpu/stages/basic.py``: host stages on the port's
``Dataset``, equivalents of the reference's ``stages`` package (reference:
stages/DropColumns.scala, SelectColumns.scala, RenameColumn.scala,
Explode.scala, Repartition.scala:19, StratifiedRepartition.scala:29,
Cacher.scala:13, ClassBalancer.scala:27, EnsembleByKey.scala:22,
SummarizeData.scala:18-191, MultiColumnAdapter.scala:18, UDFTransformer.scala:25,
Timer.scala:57-92, TextPreprocessor.scala:15-96, UnicodeNormalize.scala:20).
Semantics are columnar: "partitions" become the data group's row shards, so Repartition
maps to shard-count hints and StratifiedRepartition to label-balanced row
interleaving (each equal-size shard sees every label).
"""

from __future__ import annotations

import contextlib
import time
import unicodedata
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (HasInputCol, HasInputCols, HasLabelCol, HasOutputCol,
                           Param, TypeConverters)
from ..core.pipeline import Estimator, Model, PipelineStage, Transformer

from ..observability.logging import get_logger

logger = get_logger("mmlspark_tpu_torch")


class DropColumns(Transformer):
    cols = Param("cols", "Columns to drop", None, TypeConverters.to_list_string)

    def transform(self, dataset: Dataset) -> Dataset:
        return dataset.drop(*(self.get_or_default("cols") or []))


class SelectColumns(Transformer):
    cols = Param("cols", "Columns to keep", None, TypeConverters.to_list_string)

    def transform(self, dataset: Dataset) -> Dataset:
        return dataset.select(*(self.get_or_default("cols") or []))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def transform(self, dataset: Dataset) -> Dataset:
        return dataset.rename(self.get_or_default("inputCol"),
                              self.get_or_default("outputCol"))


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Expand a list column into one row per element."""

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.get_or_default("inputCol")]
        out_name = self.get_or_default("outputCol") or self.get_or_default("inputCol")
        idx, values = [], []
        for i in range(len(dataset)):
            items = col[i]
            for item in (items if items is not None else []):
                idx.append(i)
                values.append(item)
        base = dataset.take(np.asarray(idx, dtype=np.int64))
        try:
            arr = np.asarray(values)
            data = arr if arr.dtype != object else values
        except Exception:
            data = values
        return base.with_column(out_name, data)


class Cacher(Transformer):
    """Materialization hint; columnar data is already host-resident
    (reference: stages/Cacher.scala:13)."""

    def transform(self, dataset: Dataset) -> Dataset:
        return dataset


class Repartition(Transformer):
    """Shard-count hint. Rows are sharded over the data group's ranks; this
    stage re-orders rows round-robin so downstream equal-size sharding matches
    the requested partition count (reference: stages/Repartition.scala:19)."""

    n = Param("n", "Target number of shards", 1, TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        n = self.get_or_default("n")
        order = np.argsort(np.arange(len(dataset)) % n, kind="stable")
        return dataset.take(order)


class StratifiedRepartition(Transformer, HasLabelCol):
    """Reorder rows so every equal-size row-shard sees a balanced label mix
    (reference: stages/StratifiedRepartition.scala:29 — there it rebalances
    Spark partitions; here the row shards of the data group)."""

    mode = Param("mode", "equal | original | mixed", "equal", TypeConverters.to_string)
    seed = Param("seed", "Shuffle seed", 0, TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        y = dataset.array(self.get_or_default("labelCol"))
        rng = np.random.default_rng(self.get_or_default("seed"))
        by_label = {}
        for lbl in np.unique(y):
            idx = np.nonzero(y == lbl)[0]
            rng.shuffle(idx)
            by_label[lbl] = list(idx)
        # round-robin interleave across labels
        order = []
        queues = list(by_label.values())
        while any(queues):
            for q in queues:
                if q:
                    order.append(q.pop())
        return dataset.take(np.asarray(order))


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Adds a weight column inversely proportional to class frequency
    (reference: stages/ClassBalancer.scala:27)."""

    broadcastJoin = Param("broadcastJoin", "compat no-op", True, TypeConverters.to_bool)
    outputCol = Param("outputCol", "weight column", "weight", TypeConverters.to_string)

    def fit(self, dataset: Dataset) -> "ClassBalancerModel":
        y = dataset.array(self.get_or_default("inputCol"))
        vals, counts = np.unique(y, return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        model = ClassBalancerModel(table={float(v): float(w)
                                          for v, w in zip(vals, weights)})
        self._copy_params_to(model)
        return model


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    table = Param("table", "label -> weight", None, is_complex=True)
    outputCol = Param("outputCol", "weight column", "weight", TypeConverters.to_string)

    def __init__(self, table: Optional[dict] = None, **kwargs):
        super().__init__(**kwargs)
        if table is not None:
            self.set(table=table)

    def transform(self, dataset: Dataset) -> Dataset:
        y = dataset.array(self.get_or_default("inputCol"))
        tbl = self.get_or_default("table")
        w = np.asarray([tbl.get(float(v), 1.0) for v in y])
        return dataset.with_column(self.get_or_default("outputCol"), w)


class UDFTransformer(Transformer, HasInputCol, HasInputCols, HasOutputCol):
    """Arbitrary per-column function as a stage (reference:
    stages/UDFTransformer.scala:25; python UDFs via UDPyFParam). The function
    receives the full column array (vectorized), or a tuple of columns when
    ``inputCols`` is set."""

    udf = Param("udf", "callable column->column", None, is_complex=True)

    def __init__(self, udf: Optional[Callable] = None, **kwargs):
        super().__init__(**kwargs)
        if udf is not None:
            self.set(udf=udf)

    def transform(self, dataset: Dataset) -> Dataset:
        fn = self.get_or_default("udf")
        cols = self.get_or_default("inputCols")
        if cols:
            out = fn(*[dataset[c] for c in cols])
        else:
            out = fn(dataset[self.get_or_default("inputCol")])
        return dataset.with_column(self.get_or_default("outputCol"), out)


class MultiColumnAdapter(Transformer):
    """Map a unary stage over N (input, output) column pairs
    (reference: stages/MultiColumnAdapter.scala:18)."""

    baseStage = Param("baseStage", "Unary stage to replicate", None, is_complex=True)
    inputCols = Param("inputCols", "input columns", None, TypeConverters.to_list_string)
    outputCols = Param("outputCols", "output columns", None, TypeConverters.to_list_string)

    def __init__(self, baseStage: Optional[PipelineStage] = None, **kwargs):
        super().__init__(**kwargs)
        if baseStage is not None:
            self.set(baseStage=baseStage)

    def transform(self, dataset: Dataset) -> Dataset:
        stage = self.get_or_default("baseStage")
        for in_c, out_c in zip(self.get_or_default("inputCols"),
                               self.get_or_default("outputCols")):
            s = stage.copy({"inputCol": in_c, "outputCol": out_c})
            dataset = s.transform(dataset)
        return dataset


class Timer(Estimator):
    """Wrap a stage; log fit/transform wall time (reference: stages/Timer.scala:57-92).

    On top of the reference's host wall-clock logging, ``traceDir`` captures
    a ``torch.profiler`` trace of the wrapped fit/transform (host ops and,
    once CUDA is initialised, the card's kernels — see utils/profiling.py)."""

    stage = Param("stage", "Wrapped stage", None, is_complex=True)
    logToScala = Param("logToScala", "Log through the framework logger", True,
                       TypeConverters.to_bool)
    disableMaterialization = Param("disableMaterialization", "compat no-op", True,
                                   TypeConverters.to_bool)
    traceDir = Param("traceDir", "If set, capture a torch.profiler trace of "
                     "the wrapped fit/transform into this directory "
                     "(Chrome-trace format)", None,
                     TypeConverters.to_string)

    def __init__(self, stage: Optional[PipelineStage] = None, **kwargs):
        super().__init__(**kwargs)
        if stage is not None:
            self.set(stage=stage)

    def fit(self, dataset: Dataset) -> "TimerModel":
        from ..utils.profiling import annotate, trace
        inner = self.get_or_default("stage")
        tdir = self.get_or_default("traceDir")
        ctx = trace(tdir) if tdir else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx, annotate(f"Timer.fit:{type(inner).__name__}"):
            fitted = (inner.fit(dataset) if isinstance(inner, Estimator)
                      else inner)
        dt = time.perf_counter() - t0
        if self.get_or_default("logToScala"):
            logger.info("Timer: fitting %s took %.3fs", type(inner).__name__, dt)
        model = TimerModel(fitted=fitted)
        self._copy_params_to(model)
        return model


class TimerModel(Model):
    fitted = Param("fitted", "Fitted inner stage", None, is_complex=True)
    traceDir = Param("traceDir", "If set, capture a torch.profiler trace of "
                     "the wrapped transform into this directory", None,
                     TypeConverters.to_string)

    def __init__(self, fitted: Optional[Transformer] = None, **kwargs):
        super().__init__(**kwargs)
        if fitted is not None:
            self.set(fitted=fitted)

    def transform(self, dataset: Dataset) -> Dataset:
        from ..utils.profiling import annotate, trace
        inner = self.get_or_default("fitted")
        tdir = self.get_or_default("traceDir")
        ctx = trace(tdir) if tdir else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx, annotate(f"Timer.transform:{type(inner).__name__}"):
            out = inner.transform(dataset)
        logger.info("Timer: transforming %s took %.3fs", type(inner).__name__,
                    time.perf_counter() - t0)
        return out


class EnsembleByKey(Transformer):
    """Group rows by key column(s) and aggregate scalar/vector columns
    (reference: stages/EnsembleByKey.scala:22)."""

    keys = Param("keys", "key columns", None, TypeConverters.to_list_string)
    cols = Param("cols", "columns to aggregate", None, TypeConverters.to_list_string)
    strategy = Param("strategy", "mean (only supported, as in reference)", "mean",
                     TypeConverters.to_string)
    collapseGroup = Param("collapseGroup", "one row per group", True,
                          TypeConverters.to_bool)
    colNames = Param("colNames", "output names for the aggregated columns "
                     "(parallel to cols; default 'mean(<col>)' — "
                     "reference: EnsembleByKey colNames)", None,
                     TypeConverters.to_list_string)
    vectorDims = Param("vectorDims", "compat no-op", None)

    def transform(self, dataset: Dataset) -> Dataset:
        keys = self.get_or_default("keys")
        cols = self.get_or_default("cols")
        names = self.get_or_default("colNames")
        if names is not None and len(names) != len(cols):
            raise ValueError(
                f"colNames has {len(names)} entries for {len(cols)} cols")
        if names is not None and (len(set(names)) != len(names)
                                  or set(names) & set(keys)):
            raise ValueError(
                f"colNames must be distinct and must not collide with key "
                f"columns; got {names} with keys {keys}")
        out_name = dict(zip(cols, names)) if names else \
            {c: f"mean({c})" for c in cols}
        key_data = [dataset[k] for k in keys]
        n = len(dataset)
        groups: Dict[tuple, List[int]] = {}
        for i in range(n):
            k = tuple(kd[i] for kd in key_data)
            groups.setdefault(k, []).append(i)
        if self.get_or_default("strategy") != "mean":
            raise ValueError("only 'mean' strategy is supported (parity with reference)")
        out_cols: Dict[str, list] = {k: [] for k in keys}
        for c in cols:
            out_cols[out_name[c]] = []
        for k, idxs in groups.items():
            for name, val in zip(keys, k):
                out_cols[name].append(val)
            for c in cols:
                arr = np.asarray([dataset[c][i] for i in idxs], dtype=np.float64)
                out_cols[out_name[c]].append(arr.mean(axis=0))
        final = {}
        for name, vals in out_cols.items():
            try:
                final[name] = np.asarray(vals)
            except Exception:
                final[name] = vals
        if not self.get_or_default("collapseGroup"):
            # broadcast group aggregate back onto original rows
            gmap = {k: i for i, k in enumerate(groups.keys())}
            rows = [gmap[tuple(kd[i] for kd in key_data)] for i in range(n)]
            add = {out_name[c]: np.asarray(final[out_name[c]])[rows]
                   for c in cols}
            return dataset.with_columns(add)
        return Dataset(final)


class SummarizeData(Transformer):
    """Column statistics table (reference: stages/SummarizeData.scala:18-191:
    counts / basic / sample / percentiles blocks)."""

    counts = Param("counts", "include counts", True, TypeConverters.to_bool)
    basic = Param("basic", "include basic stats", True, TypeConverters.to_bool)
    sample = Param("sample", "include sample stats", True, TypeConverters.to_bool)
    percentiles = Param("percentiles", "include percentiles", True,
                        TypeConverters.to_bool)
    errorThreshold = Param("errorThreshold", "approx quantile tolerance (compat)",
                           0.0, TypeConverters.to_float)

    def transform(self, dataset: Dataset) -> Dataset:
        rows = []
        for name in dataset.columns:
            col = dataset[name]
            entry: Dict[str, object] = {"Feature": name}
            arr = None
            if isinstance(col, np.ndarray) and col.ndim == 1 and \
                    np.issubdtype(col.dtype, np.number):
                arr = col.astype(np.float64)
            if self.get_or_default("counts"):
                entry["Count"] = float(len(col))
                if arr is not None:
                    entry["Unique Value Count"] = float(len(np.unique(arr)))
                    entry["Missing Value Count"] = float(np.isnan(arr).sum())
                else:
                    vals = list(col)
                    entry["Unique Value Count"] = float(len(set(map(str, vals))))
                    entry["Missing Value Count"] = float(
                        sum(v is None for v in vals))
            if self.get_or_default("basic") and arr is not None:
                entry.update({
                    "Min": float(np.nanmin(arr)), "Max": float(np.nanmax(arr)),
                    "Mean": float(np.nanmean(arr)),
                    "Standard Deviation": float(np.nanstd(arr, ddof=1))
                    if len(arr) > 1 else 0.0,
                })
            if self.get_or_default("sample") and arr is not None:
                from scipy import stats as sps

                clean = arr[~np.isnan(arr)]
                entry["Sample Variance"] = float(np.var(clean, ddof=1)) if len(clean) > 1 else 0.0
                entry["Sample Standard Deviation"] = entry["Sample Variance"] ** 0.5
                if len(clean) > 2:
                    entry["Sample Skewness"] = float(sps.skew(clean))
                    entry["Sample Kurtosis"] = float(sps.kurtosis(clean))
            if self.get_or_default("percentiles") and arr is not None:
                clean = arr[~np.isnan(arr)]
                if len(clean):
                    for p in (0.5, 1, 5, 10, 25, 50, 75, 90, 95, 99, 99.5):
                        entry[f"P{p}"] = float(np.percentile(clean, p))
            rows.append(entry)
        return Dataset.from_rows(rows)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Trie-driven substring replacement (reference: stages/TextPreprocessor.scala:15-96)."""

    map = Param("map", "substring -> replacement", None, is_complex=True)
    normFunc = Param("normFunc", "identity|lowerCase|trim", "identity",
                     TypeConverters.to_string)

    def _normalize(self, s: str) -> str:
        fn = self.get_or_default("normFunc")
        if fn == "lowerCase":
            return s.lower()
        if fn == "trim":
            return s.strip()
        return s

    def transform(self, dataset: Dataset) -> Dataset:
        table = self.get_or_default("map") or {}
        # longest-match-first replacement, equivalent to the reference's trie walk
        keys = sorted(table.keys(), key=len, reverse=True)
        col = dataset[self.get_or_default("inputCol")]
        out = []
        for s in col:
            s = self._normalize(str(s))
            result, i = [], 0
            while i < len(s):
                for k in keys:
                    if s.startswith(k, i):
                        result.append(table[k])
                        i += len(k)
                        break
                else:
                    result.append(s[i])
                    i += 1
            out.append("".join(result))
        return dataset.with_column(self.get_or_default("outputCol"), out)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    """reference: stages/UnicodeNormalize.scala:20"""

    form = Param("form", "NFC|NFD|NFKC|NFKD", "NFKD", TypeConverters.to_string)
    lower = Param("lower", "lowercase after normalizing", True, TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.get_or_default("inputCol")]
        form = self.get_or_default("form")
        lower = self.get_or_default("lower")
        out = [unicodedata.normalize(form, str(s)) for s in col]
        if lower:
            out = [s.lower() for s in out]
        return dataset.with_column(self.get_or_default("outputCol"), out)
