"""The work LambdaRank's lambdas need a round, from the queries and their
grades, whatever implements them."""

from __future__ import annotations

import numpy as np

# the formula's float operations for one pair y_i > y_j: the score
# difference, the sigmoid (a product, an exponential, an addition, a
# division), the two absolute differences (two each), their product and its
# division by maxDCG, lambda (two products), the hessian term (a
# subtraction and four products) and the four sums into the two rows
OPS_PER_PAIR = 21
# bytes a row: score, grade and weight read, gradient and hessian written
# (float32); and each query's int64 offset
ROW_BYTES = 5 * 4
OFFSET_BYTES = 8


def pairs(offsets: np.ndarray, y: np.ndarray) -> int:
    """The pairs ``(i, j)`` of one query with ``y_i > y_j``."""
    off = np.asarray(offsets, np.int64)
    lengths = np.diff(off)
    total = 0
    for q in range(lengths.size):
        _, counts = np.unique(y[off[q]:off[q + 1]], return_counts=True)
        total += (int(lengths[q]) ** 2 - int(np.sum(counts.astype(np.int64)
                                                    ** 2))) // 2
    return total


def round_work(offsets: np.ndarray, y: np.ndarray) -> tuple:
    """``(operations, bytes)`` of one round's lambdas."""
    n = int(np.asarray(offsets)[-1])
    return (OPS_PER_PAIR * pairs(offsets, y),
            ROW_BYTES * n + OFFSET_BYTES * len(offsets))
