"""Complement-set sampling for explicit-feedback access anomaly training.

The PyTorch port's own copy of ``mmlspark_tpu/cyber/complement.py``
(host numpy, the same ``default_rng`` draws); the port imports
nothing of the JAX package.

Equivalent of the reference's ComplementAccessTransformer
(reference: src/main/python/mmlspark/cyber/anomaly/complement_access.py):
given observed (tenant, user, res) index tuples, sample tuples from the
complement set — index combinations inside the per-tenant [min, max] index
boxes that never occur in the data. Sampling is vectorized numpy (one draw
per observed row times ``complementsetFactor``), then de-duplicated and
anti-joined against the observed set.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import Param
from ..core.pipeline import Transformer


class ComplementAccessTransformer(Transformer):
    partitionKey = Param("partitionKey", "partition (tenant) column; None for "
                         "a single global partition", None)
    indexedColNamesArr = Param("indexedColNamesArr",
                               "indexed columns to complement-sample over", None)
    complementsetFactor = Param("complementsetFactor",
                                "samples drawn per observed row", 2)
    seed = Param("seed", "rng seed for reproducible sampling", 0)

    def __init__(self, partition_key: Optional[str] = None,
                 indexed_col_names_arr: Optional[List[str]] = None,
                 complementset_factor: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        if partition_key is not None:
            self.set(partitionKey=partition_key)
        if indexed_col_names_arr is not None:
            self.set(indexedColNamesArr=list(indexed_col_names_arr))
        if complementset_factor is not None:
            self.set(complementsetFactor=complementset_factor)

    def transform(self, dataset: Dataset) -> Dataset:
        factor = self.get_or_default("complementsetFactor")
        cols = self.get_or_default("indexedColNamesArr")
        part = self.get_or_default("partitionKey")
        rng = np.random.default_rng(self.get_or_default("seed"))

        if factor == 0:
            empty = {c: np.asarray([], dtype=np.int64) for c in cols}
            if part is not None:
                empty = {part: [], **empty}
            return Dataset(empty)

        if part is None:
            keys = np.zeros(len(dataset), dtype=np.int64)
        else:
            keys = np.asarray(dataset[part])
        mats = np.stack([dataset.array(c, dtype=np.int64) for c in cols], axis=1)

        out_keys, out_rows = [], []
        for k in sorted(set(keys.tolist())):
            rows = mats[keys == k]
            lo, hi = rows.min(axis=0), rows.max(axis=0)
            n = rows.shape[0] * factor
            draws = rng.integers(lo, hi + 1, size=(n, len(cols)))
            observed = {tuple(r) for r in rows.tolist()}
            keep = sorted({tuple(d) for d in draws.tolist()} - observed)
            out_rows.extend(keep)
            out_keys.extend([k] * len(keep))

        data = {c: np.asarray([r[i] for r in out_rows], dtype=np.int64)
                for i, c in enumerate(cols)}
        if part is not None:
            return Dataset({part: out_keys, **data})
        return Dataset(data)
