"""Column helper functions; counterpart of ``mmlspark_tpu/stages/udfs.py``
(reference: stages/udfs.scala:16 —
``get_value_at`` and ``to_vector``).

The reference exposes these as Spark SQL UDFs producing Columns; the Dataset
idiom here is a function from dataset to dataset with an output column.
"""

from __future__ import annotations

import numpy as np

from ..core.dataset import Dataset


def get_value_at(dataset: Dataset, input_col: str, index: int,
                 output_col: str) -> Dataset:
    """Extract element ``index`` from each row's vector/sequence
    (udfs.scala get_value_at)."""
    col = dataset[input_col]
    # plain indexing: O(1) per row regardless of vector width, and works
    # for non-numeric sequences too
    vals = np.asarray([v[index] for v in col])
    return dataset.with_column(output_col, vals)


def to_vector(dataset: Dataset, input_col: str,
              output_col: str) -> Dataset:
    """Coerce a sequence-typed column into float32 vectors
    (udfs.scala to_vector)."""
    col = dataset[input_col]
    vecs = [np.asarray(v, dtype=np.float32) for v in col]
    return dataset.with_column(output_col, vecs)
