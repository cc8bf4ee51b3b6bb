"""Per-tenant feature plumbing for CyberML: id indexing and scalers.

The PyTorch port's own copy of ``mmlspark_tpu/cyber/feature.py``
(host numpy); the port imports nothing of the JAX package.

Equivalents of the reference's cyber feature helpers (reference:
src/main/python/mmlspark/cyber/feature/indexers.py — IdIndexer/MultiIndexer;
feature/scalers.py — PerPartitionScalarScaler, StandardScalarScaler,
LinearScalarScaler). Spark groupBy/join plumbing becomes vectorized numpy
group-bys keyed on the partition (tenant) column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.dataset import Dataset
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model


def _col_as_list(col) -> list:
    return col.tolist() if isinstance(col, np.ndarray) else list(col)


class _HasPartitionKey:
    partitionKey = Param("partitionKey",
                         "column to partition by; per-partition state is "
                         "completely isolated (the tenant axis)", None)

    def get_partition_key(self):
        return self.get_or_default("partitionKey")


# ---------------------------------------------------------------------------
# IdIndexer
# ---------------------------------------------------------------------------


class IdIndexerModel(Model, HasInputCol, HasOutputCol, _HasPartitionKey):
    """Vocabulary model mapping (partition, value) -> index in [1..n]; unseen
    values map to 0 (reference: cyber/feature/indexers.py IdIndexerModel)."""

    vocabulary = Param("vocabulary", "(partition, value) -> index mapping",
                       None, is_complex=True)

    def __init__(self, vocabulary: Optional[Dict[Tuple, int]] = None, **kwargs):
        super().__init__(**kwargs)
        if vocabulary is not None:
            self.set(vocabulary=vocabulary)

    def transform(self, dataset: Dataset) -> Dataset:
        vocab = self.get_or_default("vocabulary")
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol")
        part = self.get_partition_key()
        keys = _col_as_list(dataset[part])
        vals = _col_as_list(dataset[in_col])
        idx = np.asarray([vocab.get((k, v), 0) for k, v in zip(keys, vals)],
                         dtype=np.int64)
        return dataset.with_column(out_col, idx).drop(in_col)

    def undo_transform(self, dataset: Dataset) -> Dataset:
        """Map indices back to original values (the index->name join the
        reference uses to de-index ALS factors)."""
        vocab = self.get_or_default("vocabulary")
        inverse = {(k, i): v for (k, v), i in vocab.items()}
        out_col = self.get_or_default("outputCol")
        in_col = self.get_or_default("inputCol")
        part = self.get_partition_key()
        keys = _col_as_list(dataset[part])
        idx = _col_as_list(dataset[out_col])
        values = [inverse.get((k, int(i))) for k, i in zip(keys, idx)]
        return dataset.with_column(in_col, values)


class IdIndexer(Estimator, HasInputCol, HasOutputCol, _HasPartitionKey):
    """Index distinct (partition, value) pairs to ints starting at 1
    (reference: cyber/feature/indexers.py IdIndexer). With
    ``resetPerPartition`` the numbering restarts inside every partition."""

    resetPerPartition = Param("resetPerPartition",
                              "restart numbering at 1 inside each partition",
                              False)

    def __init__(self, input_col: Optional[str] = None,
                 partition_key: Optional[str] = None,
                 output_col: Optional[str] = None,
                 reset_per_partition: bool = False, **kwargs):
        super().__init__(**kwargs)
        if input_col is not None:
            self.set(inputCol=input_col)
        if partition_key is not None:
            self.set(partitionKey=partition_key)
        if output_col is not None:
            self.set(outputCol=output_col)
        self.set(resetPerPartition=reset_per_partition)

    def fit(self, dataset: Dataset) -> IdIndexerModel:
        part = self.get_partition_key()
        in_col = self.get_or_default("inputCol")
        pairs = sorted({(k, v) for k, v in zip(_col_as_list(dataset[part]),
                                               _col_as_list(dataset[in_col]))})
        vocab: Dict[Tuple, int] = {}
        if self.get_or_default("resetPerPartition"):
            counters: Dict = {}
            for k, v in pairs:
                counters[k] = counters.get(k, 0) + 1
                vocab[(k, v)] = counters[k]
        else:
            for i, (k, v) in enumerate(pairs, start=1):
                vocab[(k, v)] = i
        model = IdIndexerModel(vocabulary=vocab)
        self._copy_params_to(model)
        return model


class MultiIndexerModel(Model):
    """Apply several IdIndexerModels in sequence
    (reference: cyber/feature/indexers.py MultiIndexerModel)."""

    def __init__(self, models: Optional[List[IdIndexerModel]] = None, **kwargs):
        super().__init__(**kwargs)
        self.models = models or []

    def get_model_by_input_col(self, input_col: str) -> Optional[IdIndexerModel]:
        for m in self.models:
            if m.get_or_default("inputCol") == input_col:
                return m
        return None

    def get_model_by_output_col(self, output_col: str) -> Optional[IdIndexerModel]:
        for m in self.models:
            if m.get_or_default("outputCol") == output_col:
                return m
        return None

    def transform(self, dataset: Dataset) -> Dataset:
        for m in self.models:
            dataset = m.transform(dataset)
        return dataset

    def undo_transform(self, dataset: Dataset) -> Dataset:
        for m in self.models:
            dataset = m.undo_transform(dataset)
        return dataset

    def _save_extra(self, path: str) -> None:
        import os

        from ..core.pipeline import _save_stage_list
        _save_stage_list(self.models, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        import os

        from ..core.pipeline import _load_stage_list
        self.models = _load_stage_list(os.path.join(path, "stages"))


class MultiIndexer(Estimator):
    def __init__(self, indexers: Optional[List[IdIndexer]] = None, **kwargs):
        super().__init__(**kwargs)
        self.indexers = indexers or []

    def fit(self, dataset: Dataset) -> MultiIndexerModel:
        return MultiIndexerModel(models=[i.fit(dataset) for i in self.indexers])

    def _save_extra(self, path: str) -> None:
        import os

        from ..core.pipeline import _save_stage_list
        _save_stage_list(self.indexers, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        import os

        from ..core.pipeline import _load_stage_list
        self.indexers = _load_stage_list(os.path.join(path, "stages"))


# ---------------------------------------------------------------------------
# Per-partition scalers
# ---------------------------------------------------------------------------


def _group_indices(keys: list) -> Dict:
    groups: Dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


class _PerPartitionScalerModel(Model, HasInputCol, HasOutputCol, _HasPartitionKey):
    """Shared base: per-partition stats dict drives a vectorized transform
    (reference: cyber/feature/scalers.py PerPartitionScalarScalerModel)."""

    perGroupStats = Param("perGroupStats", "partition -> stats mapping", None,
                          is_complex=True)

    @property
    def per_group_stats(self) -> Dict:
        return self.get_or_default("perGroupStats")

    def _scale(self, x: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
        raise NotImplementedError

    def transform(self, dataset: Dataset) -> Dataset:
        part = self.get_partition_key()
        x = dataset.array(self.get_or_default("inputCol"), dtype=np.float64)
        out = np.empty_like(x)
        if part is None:
            out = self._scale(x, self.per_group_stats)
        else:
            keys = _col_as_list(dataset[part])
            for k, idx in _group_indices(keys).items():
                idx = np.asarray(idx)
                stats = self.per_group_stats.get(k)
                out[idx] = self._scale(x[idx], stats) if stats else np.nan
        return dataset.with_column(self.get_or_default("outputCol"), out)


class _PerPartitionScaler(Estimator, HasInputCol, HasOutputCol, _HasPartitionKey):
    def __init__(self, input_col: Optional[str] = None,
                 partition_key: Optional[str] = None,
                 output_col: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if input_col is not None:
            self.set(inputCol=input_col)
        if partition_key is not None:
            self.set(partitionKey=partition_key)
        if output_col is not None:
            self.set(outputCol=output_col)

    def _stats(self, x: np.ndarray) -> Dict[str, float]:
        raise NotImplementedError

    def _make_model(self) -> _PerPartitionScalerModel:
        raise NotImplementedError

    def fit(self, dataset: Dataset) -> _PerPartitionScalerModel:
        part = self.get_partition_key()
        x = dataset.array(self.get_or_default("inputCol"), dtype=np.float64)
        if part is None:
            stats = self._stats(x)
        else:
            keys = _col_as_list(dataset[part])
            stats = {k: self._stats(x[np.asarray(idx)])
                     for k, idx in _group_indices(keys).items()}
        model = self._make_model()
        self._copy_params_to(model)
        model.set(perGroupStats=stats)
        return model


class StandardScalarScalerModel(_PerPartitionScalerModel):
    coefficientFactor = Param("coefficientFactor",
                              "multiply scaled output by this", 1.0)

    def _scale(self, x: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
        coeff = self.get_or_default("coefficientFactor")
        std = stats["std"]
        if std == 0.0:
            return np.zeros_like(x)
        return coeff * (x - stats["mean"]) / std


class StandardScalarScaler(_PerPartitionScaler):
    """Per-partition z-score scaling
    (reference: cyber/feature/scalers.py StandardScalarScaler)."""

    coefficientFactor = Param("coefficientFactor",
                              "multiply scaled output by this", 1.0)

    def _stats(self, x: np.ndarray) -> Dict[str, float]:
        return {"mean": float(np.mean(x)), "std": float(np.std(x))}

    def _make_model(self) -> StandardScalarScalerModel:
        return StandardScalarScalerModel()


class LinearScalarScalerModel(_PerPartitionScalerModel):
    def _scale(self, x: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
        return x * stats["slope"] + stats["intercept"]


class LinearScalarScaler(_PerPartitionScaler):
    """Per-partition min-max scaling to [minRequiredValue, maxRequiredValue]
    (reference: cyber/feature/scalers.py LinearScalarScaler)."""

    minRequiredValue = Param("minRequiredValue", "target min", 0.0)
    maxRequiredValue = Param("maxRequiredValue", "target max", 1.0)

    def __init__(self, input_col: Optional[str] = None,
                 partition_key: Optional[str] = None,
                 output_col: Optional[str] = None,
                 min_required_value: Optional[float] = None,
                 max_required_value: Optional[float] = None, **kwargs):
        super().__init__(input_col, partition_key, output_col, **kwargs)
        if min_required_value is not None:
            self.set(minRequiredValue=min_required_value)
        if max_required_value is not None:
            self.set(maxRequiredValue=max_required_value)

    def _stats(self, x: np.ndarray) -> Dict[str, float]:
        lo, hi = float(np.min(x)), float(np.max(x))
        tlo = self.get_or_default("minRequiredValue")
        thi = self.get_or_default("maxRequiredValue")
        if hi == lo:
            # Degenerate span: pin everything to the top of the target range.
            return {"slope": 0.0, "intercept": thi}
        slope = (thi - tlo) / (hi - lo)
        return {"slope": slope, "intercept": tlo - lo * slope}

    def _make_model(self) -> LinearScalarScalerModel:
        return LinearScalarScalerModel()
