"""VowpalWabbitFeaturizer: hash columns into a fixed sparse feature space.

Counterpart of ``mmlspark_tpu/models/vw/featurizer.py``, on the host; its
indices and values are bit-equal to the JAX package's.

Parity with the reference's JVM-side featurization
(reference: vw/VowpalWabbitFeaturizer.scala:22-226 and the 11 per-type
featurizers under vw/featurizer/ — numeric / string / map / seq / boolean /
vector / string-split), re-designed for a columnar host pipeline: each input
column contributes hashed (index, value) pairs per row; the output column is a
padded fixed-width sparse block — ``indices [n, nnz_max] int32`` +
``values [n, nnz_max] f32`` — because batched training on the device wants
rectangles, not ragged JNI example objects.

Hashing matches ops/murmur.py (VW's murmur3), so feature identity is stable
across train/predict and across the ranks of a data group.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ...core.dataset import Dataset
from ...core.params import HasInputCols, HasOutputCol, Param, TypeConverters
from ...core.pipeline import Transformer
from ...ops.murmur import hash_feature, hash_namespace, mask_bits


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    numBits = Param("numBits", "Feature space is 2^numBits", 18, TypeConverters.to_int)
    sumCollisions = Param("sumCollisions", "Sum values on hash collision", True,
                          TypeConverters.to_bool)
    stringSplitInputCols = Param(
        "stringSplitInputCols",
        "Columns whose strings are whitespace-split into words first", None,
        TypeConverters.to_list_string)
    prefixStringsWithColumnName = Param(
        "prefixStringsWithColumnName", "Prefix hashed strings with column name",
        True, TypeConverters.to_bool)
    outputCol = Param("outputCol", "The name of the output column", "features",
                      TypeConverters.to_string)
    hashSeed = Param("hashSeed", "Seed of the murmur feature hashing (VW "
                     "--hash_seed; reference: VowpalWabbitBase hashSeed). "
                     "Train and score featurizers must agree", 0,
                     TypeConverters.to_int)
    preserveOrderNumBits = Param(
        "preserveOrderNumBits", "Reserve this many top bits to encode the "
        "input column's position, so features of different columns cannot "
        "collide and column order is recoverable from indices (reference: "
        "VowpalWabbitFeaturizer preserveOrderNumBits; 0 = off)", 0,
        TypeConverters.to_int)

    def _row_features(self, name: str, value, ns_hash: int, num_bits: int,
                      split: bool, prefix: bool) -> List[Tuple[int, float]]:
        out: List[Tuple[int, float]] = []
        if value is None:
            return out
        if isinstance(value, (bool, np.bool_)):
            if value:
                out.append((mask_bits(hash_feature(name, ns_hash), num_bits), 1.0))
        elif isinstance(value, (int, float, np.integer, np.floating)):
            v = float(value)
            if v != 0.0 and not np.isnan(v):
                out.append((mask_bits(hash_feature(name, ns_hash), num_bits), v))
        elif isinstance(value, str):
            if split:
                for w in value.split():
                    key = f"{name}_{w}" if prefix else w
                    out.append((mask_bits(hash_feature(key, ns_hash), num_bits), 1.0))
            else:
                key = f"{name}_{value}" if prefix else value
                out.append((mask_bits(hash_feature(key, ns_hash), num_bits), 1.0))
        elif isinstance(value, dict):
            for k, v in value.items():
                out.extend(self._row_features(f"{name}_{k}", v, ns_hash, num_bits,
                                              split, prefix))
        elif isinstance(value, np.ndarray) and value.ndim == 1:
            for i, v in enumerate(value):
                v = float(v)
                if v != 0.0:
                    out.append((mask_bits(hash_feature(str(i), ns_hash), num_bits), v))
        elif isinstance(value, (list, tuple)):
            for item in value:
                out.extend(self._row_features(name, item, ns_hash, num_bits,
                                              split, prefix))
        else:
            raise TypeError(f"unsupported feature type {type(value)} in column {name}")
        return out

    def transform(self, dataset: Dataset) -> Dataset:
        in_cols = self.get_or_default("inputCols") or []
        num_bits = self.get_or_default("numBits")
        split_cols = set(self.get_or_default("stringSplitInputCols") or [])
        prefix = self.get_or_default("prefixStringsWithColumnName")
        sum_coll = self.get_or_default("sumCollisions")
        # default namespace, seeded by hashSeed (VW --hash_seed)
        ns_hash = hash_namespace("", self.get_or_default("hashSeed"))
        pon = int(self.get_or_default("preserveOrderNumBits") or 0)
        if pon:
            if pon >= num_bits:
                raise ValueError(
                    f"preserveOrderNumBits={pon} must be < numBits="
                    f"{num_bits}")
            if len(in_cols) > (1 << pon):
                raise ValueError(
                    f"preserveOrderNumBits={pon} encodes at most "
                    f"{1 << pon} columns; got {len(in_cols)}")
        low_bits = num_bits - pon

        n = len(dataset)
        per_row: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        for ci, col in enumerate(in_cols):
            data = dataset[col]
            is_split = col in split_cols
            prefix_bits = ci << low_bits
            for i in range(n):
                v = data[i] if not isinstance(data, np.ndarray) else data[i]
                feats = self._row_features(col, v, ns_hash, num_bits,
                                           is_split, prefix)
                if pon:
                    # top bits carry the column position; hashes fold into
                    # the remaining low bits
                    feats = [(prefix_bits | (idx & ((1 << low_bits) - 1)),
                              val) for idx, val in feats]
                per_row[i].extend(feats)

        # collapse collisions, then pad to the max active-feature count
        nnz_max = 1
        collapsed: List[Dict[int, float]] = []
        for feats in per_row:
            d: Dict[int, float] = {}
            for idx, val in feats:
                if idx in d:
                    d[idx] = d[idx] + val if sum_coll else val
                else:
                    d[idx] = val
            collapsed.append(d)
            nnz_max = max(nnz_max, len(d))

        indices = np.zeros((n, nnz_max), dtype=np.int32)
        values = np.zeros((n, nnz_max), dtype=np.float32)
        for i, d in enumerate(collapsed):
            if d:
                idx = np.fromiter(d.keys(), dtype=np.int32, count=len(d))
                val = np.fromiter(d.values(), dtype=np.float32, count=len(d))
                indices[i, :len(d)] = idx
                values[i, :len(d)] = val
        out = self.get_or_default("outputCol")
        return dataset.with_columns({
            f"{out}_indices": indices,
            f"{out}_values": values,
        })
