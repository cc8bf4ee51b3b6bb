"""The bytes a fit needs, from the configuration's shapes and the fitted
model's own text, whatever implements it."""

from __future__ import annotations

from perfbench.reference.lgbm_text import TextModel, child_counts

# per row and tree: the gradient statistics as a histogram takes them
# (gradient, hessian and row weight, f32) and the score update (one f32
# read and one written)
STAT_BYTES = 12
SCORE_BYTES = 8


def fit_min_bytes(rows: int, features: int, trees: int) -> int:
    """Least bytes of a fit's trees: per tree one read of the ``[F, n]``
    bins at one byte a bin (``maxBin`` <= 256), the statistics and the score
    update of every row."""
    return trees * rows * (features + STAT_BYTES + SCORE_BYTES)


def hist_rows(model: TextModel) -> int:
    """Rows histogrammed with subtraction: each tree's root and, for each
    split, its smaller child."""
    return sum(int(t.internal_count[0])
               + int(child_counts(t).min(axis=1).sum())
               for t in model.trees if t.num_leaves > 1)


def hist_logical_bytes(model: TextModel, features: int, bins: int) -> int:
    """Histogram bytes of a fitted model's trees: each histogrammed row
    costs a byte for each of its ``features`` bins plus the statistics;
    each histogrammed node's (the root and one child a split) ``[F, 3, B]``
    float32 cells are written once."""
    nodes = sum(t.num_leaves for t in model.trees if t.num_leaves > 1)
    return (hist_rows(model) * (features + STAT_BYTES)
            + nodes * features * 3 * bins * 4)
