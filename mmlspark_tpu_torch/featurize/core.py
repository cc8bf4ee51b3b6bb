"""Automatic feature engineering: Featurize / CleanMissingData / ValueIndexer.

Counterpart of ``mmlspark_tpu/featurize/core.py``: the reference's featurize
package (reference:
featurize/Featurize.scala:22-25 -> AssembleFeatures.scala:79-467 — casting,
one-hot of categoricals, hashing of strings, vector assembly;
CleanMissingData.scala:17-160; ValueIndexer.scala:23-187; IndexToValue.scala:20-27;
DataConversion.scala:21). Output is a dense [n, d] float32 features column —
the shape GBDT binning consumes directly. String hashes come from the
native murmur (``ops/murmur.py``), bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (HasInputCol, HasInputCols, HasOutputCol, Param,
                           TypeConverters)
from ..core.pipeline import Estimator, Model, Transformer
from ..ops.murmur import murmur3_32


def _is_numeric(col) -> bool:
    return isinstance(col, np.ndarray) and np.issubdtype(col.dtype, np.number)


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Index distinct values to contiguous ints, null last
    (reference: featurize/ValueIndexer.scala:23-187)."""

    def fit(self, dataset: Dataset) -> "ValueIndexerModel":
        col = dataset[self.get_or_default("inputCol")]
        if _is_numeric(col):
            levels = np.unique(col[~np.isnan(col.astype(np.float64))]).tolist()
        else:
            levels = sorted({str(v) for v in col if v is not None})
        model = ValueIndexerModel(levels=levels)
        self._copy_params_to(model)
        return model


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("levels", "ordered distinct values", None, is_complex=True)

    def __init__(self, levels: Optional[list] = None, **kwargs):
        super().__init__(**kwargs)
        if levels is not None:
            self.set(levels=levels)

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.get_or_default("inputCol")]
        levels = self.get_or_default("levels")
        lookup = {v: i for i, v in enumerate(levels)}
        null_idx = len(levels)
        if _is_numeric(col):
            out = np.asarray([lookup.get(float(v), null_idx) if not np.isnan(float(v))
                              else null_idx for v in col], dtype=np.int64)
        else:
            out = np.asarray([lookup.get(str(v), null_idx) if v is not None
                              else null_idx for v in col], dtype=np.int64)
        name = self.get_or_default("outputCol") or \
            f"{self.get_or_default('inputCol')}_indexed"
        return dataset.with_column(name, out)


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse of ValueIndexer (reference: featurize/IndexToValue.scala:20-27)."""

    levels = Param("levels", "ordered distinct values", None, is_complex=True)

    def transform(self, dataset: Dataset) -> Dataset:
        idx = dataset.array(self.get_or_default("inputCol")).astype(int)
        levels = self.get_or_default("levels")
        out = [levels[i] if 0 <= i < len(levels) else None for i in idx]
        try:
            arr = np.asarray(out)
            data = arr if arr.dtype != object else out
        except Exception:
            data = out
        return dataset.with_column(self.get_or_default("outputCol"), data)


class CleanMissingData(Estimator, HasInputCols):
    """Impute missing numeric values (reference: featurize/CleanMissingData.scala:17-160;
    modes Mean/Median/Custom as there)."""

    cleaningMode = Param("cleaningMode", "Mean | Median | Custom", "Mean",
                         TypeConverters.to_string)
    customValue = Param("customValue", "fill for Custom mode", None,
                        TypeConverters.to_float)
    outputCols = Param("outputCols", "output columns (default: in place)", None,
                       TypeConverters.to_list_string)

    def fit(self, dataset: Dataset) -> "CleanMissingDataModel":
        mode = self.get_or_default("cleaningMode")
        fills: Dict[str, float] = {}
        for c in self.get_or_default("inputCols"):
            arr = dataset.array(c, np.float64)
            clean = arr[~np.isnan(arr)]
            if mode == "Mean":
                fills[c] = float(clean.mean()) if len(clean) else 0.0
            elif mode == "Median":
                fills[c] = float(np.median(clean)) if len(clean) else 0.0
            elif mode == "Custom":
                fills[c] = float(self.get_or_default("customValue"))
            else:
                raise ValueError(f"unknown cleaningMode {mode}")
        model = CleanMissingDataModel(fills=fills)
        self._copy_params_to(model)
        return model


class CleanMissingDataModel(Model, HasInputCols):
    fills = Param("fills", "column -> fill value", None, is_complex=True)
    outputCols = Param("outputCols", "output columns", None,
                       TypeConverters.to_list_string)

    def __init__(self, fills: Optional[dict] = None, **kwargs):
        super().__init__(**kwargs)
        if fills is not None:
            self.set(fills=fills)

    def transform(self, dataset: Dataset) -> Dataset:
        fills = self.get_or_default("fills")
        in_cols = self.get_or_default("inputCols")
        out_cols = self.get_or_default("outputCols") or in_cols
        updates = {}
        for in_c, out_c in zip(in_cols, out_cols):
            arr = dataset.array(in_c, np.float64).copy()
            arr[np.isnan(arr)] = fills[in_c]
            updates[out_c] = arr
        return dataset.with_columns(updates)


class DataConversion(Transformer):
    """Cast columns to a target type (reference: featurize/DataConversion.scala:21)."""

    cols = Param("cols", "columns to convert", None, TypeConverters.to_list_string)
    convertTo = Param("convertTo", "boolean|byte|short|integer|long|float|double|string|date",
                      "double", TypeConverters.to_string)

    _DTYPES = {"boolean": np.bool_, "byte": np.int8, "short": np.int16,
               "integer": np.int32, "long": np.int64, "float": np.float32,
               "double": np.float64}

    def transform(self, dataset: Dataset) -> Dataset:
        target = self.get_or_default("convertTo")
        updates = {}
        for c in self.get_or_default("cols"):
            col = dataset[c]
            if target == "string":
                updates[c] = [str(v) for v in col]
            elif target == "date":
                import datetime
                updates[c] = [datetime.datetime.fromisoformat(str(v)) for v in col]
            else:
                updates[c] = np.asarray(col).astype(self._DTYPES[target])
        return dataset.with_columns(updates)


class Featurize(Estimator, HasOutputCol):
    """One-liner auto-featurization: numerics cast + impute, low-cardinality
    strings one-hot, high-cardinality strings hashed, all assembled into one
    dense float32 vector (reference: featurize/Featurize.scala:22-25 ->
    AssembleFeatures.scala:79-467; ``oneHotEncodeCategoricals`` and
    ``numberOfFeatures`` hash-space sizing as there)."""

    inputCols = Param("inputCols", "columns to featurize (default: all but label)",
                      None, TypeConverters.to_list_string)
    labelCol = Param("labelCol", "excluded from features", "label",
                     TypeConverters.to_string)
    outputCol = Param("outputCol", "assembled features column", "features",
                      TypeConverters.to_string)
    oneHotEncodeCategoricals = Param("oneHotEncodeCategoricals",
                                     "one-hot low-cardinality strings", True,
                                     TypeConverters.to_bool)
    # reference default is 262144 with sparse vectors (AssembleFeatures); the
    # dense device-ready block here defaults smaller
    numberOfFeatures = Param("numberOfFeatures",
                             "hash buckets for high-cardinality strings", 4096,
                             TypeConverters.to_int)
    featureColumns = Param("featureColumns", "Reference-compat mapping "
                           "{outputCol: [inputCols]} (Featurize "
                           "featureColumns). One entry only — it sets "
                           "outputCol and inputCols", None, is_complex=True)
    allowImages = Param("allowImages", "Accepted for reference parity: "
                        "image columns are featurized by the dedicated "
                        "ImageFeaturizer stage here, not by Featurize",
                        False, TypeConverters.to_bool)
    maxOneHotCardinality = Param("maxOneHotCardinality",
                                 "one-hot when distinct count <= this", 100,
                                 TypeConverters.to_int)

    def fit(self, dataset: Dataset) -> "FeaturizeModel":
        fc = self.get_or_default("featureColumns")
        out_override = None
        in_cols = self.get_or_default("inputCols")
        if fc:
            if len(fc) != 1:
                raise ValueError(
                    "featureColumns supports exactly one "
                    "{outputCol: [inputCols]} entry here (one assembled "
                    "vector per Featurize stage); chain stages for more")
            out, cols = next(iter(fc.items()))
            # resolve locally — fitting must not mutate the estimator
            out_override = str(out)
            in_cols = [str(c) for c in cols]
        if in_cols is None:
            in_cols = [c for c in dataset.columns
                       if c != self.get_or_default("labelCol")]
        plan: List[dict] = []
        for c in in_cols:
            col = dataset[c]
            if _is_numeric(col):
                if col.ndim > 1:
                    plan.append({"col": c, "kind": "vector", "dim": int(col.shape[1])})
                else:
                    arr = col.astype(np.float64)
                    clean = arr[~np.isnan(arr)]
                    fill = float(clean.mean()) if len(clean) else 0.0
                    plan.append({"col": c, "kind": "numeric", "fill": fill})
            else:
                distinct = sorted({str(v) for v in col if v is not None})
                if self.get_or_default("oneHotEncodeCategoricals") and \
                        len(distinct) <= self.get_or_default("maxOneHotCardinality"):
                    plan.append({"col": c, "kind": "onehot", "levels": distinct})
                else:
                    plan.append({"col": c, "kind": "hash",
                                 "width": int(self.get_or_default("numberOfFeatures"))})
        model = FeaturizeModel(plan=plan)
        self._copy_params_to(model)
        if out_override is not None:
            model.set(outputCol=out_override)
        return model


class FeaturizeModel(Model, HasOutputCol):
    plan = Param("plan", "per-column featurization plan", None, is_complex=True)
    outputCol = Param("outputCol", "assembled features column", "features",
                      TypeConverters.to_string)

    def __init__(self, plan: Optional[List[dict]] = None, **kwargs):
        super().__init__(**kwargs)
        if plan is not None:
            self.set(plan=plan)

    def transform(self, dataset: Dataset) -> Dataset:
        n = len(dataset)
        blocks: List[np.ndarray] = []
        for spec in self.get_or_default("plan"):
            col = dataset[spec["col"]]
            kind = spec["kind"]
            if kind == "numeric":
                arr = np.asarray(col, np.float64).copy()
                arr[np.isnan(arr)] = spec["fill"]
                blocks.append(arr[:, None].astype(np.float32))
            elif kind == "vector":
                blocks.append(np.asarray(col, np.float32).reshape(n, -1))
            elif kind == "onehot":
                levels = {v: i for i, v in enumerate(spec["levels"])}
                out = np.zeros((n, len(levels)), np.float32)
                for i in range(n):
                    j = levels.get(str(col[i]))
                    if j is not None:
                        out[i, j] = 1.0
                blocks.append(out)
            elif kind == "hash":
                D = spec["width"]
                if n * D > (1 << 31):
                    raise MemoryError(
                        f"dense hashed block ({n}, {D}) too large; lower "
                        "numberOfFeatures")
                out = np.zeros((n, D), np.float32)
                for i in range(n):
                    v = col[i]
                    if v is not None:
                        out[i, murmur3_32(str(v), 0) % D] += 1.0
                blocks.append(out)
        feats = np.concatenate(blocks, axis=1) if blocks else np.zeros((n, 0), np.float32)
        return dataset.with_column(self.get_or_default("outputCol"), feats)
