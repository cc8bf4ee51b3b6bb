"""Constraint-driven synthetic Dataset generation for tests.

Counterpart of ``mmlspark_tpu/core/datagen.py``: the same specs and seed give
the same arrays in both packages.

Analog of the reference's datagen harness (reference:
core/test/datagen/GenerateDataset.scala, GenerateRow.scala,
DatasetConstraints.scala) rebuilt for the columnar Dataset: a column spec
list drives vectorized numpy generation, so property-style tests can sweep
schema shapes (numeric ranges, categorical arity, missing fractions, string
vocabularies) without hand-building fixtures.

Deterministic per (spec, seed): the same arguments always produce the same
Dataset, which keeps fuzz failures reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .dataset import Dataset

__all__ = ["ColumnSpec", "numeric", "categorical", "text", "boolean",
           "labels", "generate_dataset"]


@dataclass(frozen=True)
class ColumnSpec:
    """One generated column. ``kind``: numeric | categorical | text |
    boolean | label."""
    name: str
    kind: str = "numeric"
    low: float = 0.0
    high: float = 1.0
    missing_fraction: float = 0.0   # NaN rate (numeric only)
    values: Sequence = ()           # categorical choice set
    vocabulary: Sequence[str] = ()  # text word pool
    words_per_row: int = 5
    num_classes: int = 2            # label arity
    dtype: str = "float32"


def numeric(name: str, low: float = 0.0, high: float = 1.0,
            missing_fraction: float = 0.0, dtype: str = "float32"
            ) -> ColumnSpec:
    if not 0.0 <= missing_fraction <= 1.0:
        raise ValueError(f"column {name!r}: missing_fraction must be in "
                         f"[0, 1], got {missing_fraction}")
    return ColumnSpec(name, "numeric", low=low, high=high,
                      missing_fraction=missing_fraction, dtype=dtype)


def categorical(name: str, values: Sequence) -> ColumnSpec:
    if not len(values):
        raise ValueError(f"categorical column {name!r} needs a non-empty "
                         "value set")
    return ColumnSpec(name, "categorical", values=tuple(values))


def text(name: str, vocabulary: Sequence[str], words_per_row: int = 5
         ) -> ColumnSpec:
    if not len(vocabulary):
        raise ValueError(f"text column {name!r} needs a non-empty vocabulary")
    return ColumnSpec(name, "text", vocabulary=tuple(vocabulary),
                      words_per_row=int(words_per_row))


def boolean(name: str) -> ColumnSpec:
    return ColumnSpec(name, "boolean")


def labels(name: str = "label", num_classes: int = 2) -> ColumnSpec:
    if num_classes < 2:
        raise ValueError("labels need num_classes >= 2")
    return ColumnSpec(name, "label", num_classes=int(num_classes))


def _gen_column(spec: ColumnSpec, n: int, rng: np.random.Generator):
    if spec.kind == "numeric":
        is_float = np.issubdtype(np.dtype(spec.dtype), np.floating)
        if spec.missing_fraction > 0 and not is_float:
            raise ValueError(
                f"column {spec.name!r}: missing_fraction needs a float "
                f"dtype (NaN is not representable in {spec.dtype})")
        if np.issubdtype(np.dtype(spec.dtype), np.integer):
            # integer semantics: uniform integers over the integers WITHIN
            # [low, high] inclusive (truncating uniform floats would
            # floor-bias and make the default [0, 1) range constant)
            lo, hi = int(np.ceil(spec.low)), int(np.floor(spec.high))
            if hi < lo:
                raise ValueError(
                    f"column {spec.name!r}: no integers in "
                    f"[{spec.low}, {spec.high}]")
            return rng.integers(lo, hi + 1, size=n).astype(spec.dtype)
        if not is_float:
            raise ValueError(
                f"column {spec.name!r}: numeric dtype must be float or "
                f"integer, got {spec.dtype}")
        col = rng.uniform(spec.low, spec.high, size=n)
        if spec.missing_fraction > 0:
            col[rng.random(n) < spec.missing_fraction] = np.nan
        return col.astype(spec.dtype)
    if spec.kind == "categorical":
        return np.asarray(spec.values, dtype=object)[
            rng.integers(0, len(spec.values), size=n)]
    if spec.kind == "text":
        vocab = np.asarray(spec.vocabulary, dtype=object)
        words = vocab[rng.integers(0, len(vocab),
                                   size=(n, spec.words_per_row))]
        return np.asarray([" ".join(r) for r in words], dtype=object)
    if spec.kind == "boolean":
        return rng.integers(0, 2, size=n).astype(bool)
    if spec.kind == "label":
        return rng.integers(0, spec.num_classes, size=n).astype(np.float32)
    raise ValueError(f"unknown column kind {spec.kind!r} for "
                     f"column {spec.name!r}")


def generate_dataset(specs: List[ColumnSpec], n_rows: int,
                     seed: int = 0) -> Dataset:
    """Generate a Dataset with one column per spec, ``n_rows`` rows.
    Column streams are independent (each derives its own child seed from
    the column name), so adding a column never perturbs the others."""
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    names = [s.name for s in specs]
    dupes = {x for x in names if names.count(x) > 1}
    if dupes:
        raise ValueError(f"duplicate column names: {sorted(dupes)}")
    import zlib
    cols = {}
    for spec in specs:
        # zlib.crc32, not hash(): str hash is randomized per process and
        # would break cross-process reproducibility
        child = np.random.SeedSequence(
            [seed, zlib.crc32(spec.name.encode())])
        cols[spec.name] = _gen_column(spec, n_rows,
                                      np.random.default_rng(child))
    return Dataset(cols)
