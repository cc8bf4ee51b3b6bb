"""Evaluation plotting helpers; counterpart of ``mmlspark_tpu/utils/plot.py``
(reference: src/main/python/mmlspark/plot/
plot.py — confusionMatrix and roc convenience wrappers).

These draw from this framework's own metric machinery
(train.core.ComputeModelStatistics / _roc_curve) rather than sklearn, and
accept a Dataset (or anything array-like per column). Import cost is lazy:
matplotlib loads only when a plot function is called, and backend choice is
left entirely to the caller/environment (headless CI auto-selects Agg).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _col(data, name: str) -> np.ndarray:
    # Dataset and any mapping of array-likes share the same protocol
    return np.asarray(data[name], dtype=np.float64)


def confusion_matrix(data, y_col: str = "label",
                     y_hat_col: str = "prediction",
                     labels: Optional[Sequence] = None, ax=None):
    """Render the normalized confusion matrix with per-cell counts; returns
    the matplotlib Axes (display is the caller's choice)."""
    import matplotlib.pyplot as plt

    y = _col(data, y_col).astype(int)
    y_hat = _col(data, y_hat_col).astype(int)
    k = int(max(y.max(), y_hat.max())) + 1
    cm = np.zeros((k, k), np.int64)
    for t, p in zip(y, y_hat):
        cm[t, p] += 1
    with np.errstate(invalid="ignore"):
        cmn = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    acc = float((y == y_hat).mean())

    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(cmn, interpolation="nearest", cmap="Blues",
                   vmin=0.0, vmax=1.0)
    ax.figure.colorbar(im, ax=ax)
    ticks = np.arange(k)
    names = list(labels) if labels is not None else [str(i) for i in ticks]
    ax.set_xticks(ticks, names)
    ax.set_yticks(ticks, names)
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    ax.set_title(f"accuracy = {acc * 100:.1f}%")
    for i in range(k):
        for j in range(k):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cmn[i, j] > 0.5 else "black")
    return ax


def roc(data, y_col: str = "label", score_col: str = "probability", ax=None):
    """Plot the ROC curve (AUC in the title); returns the Axes."""
    import matplotlib.pyplot as plt

    from ..train.core import _auc, _roc_curve

    y = _col(data, y_col)
    score = _col(data, score_col)
    if score.ndim == 2:
        score = score[:, 1]
    fpr, tpr = _roc_curve(y, score)

    if ax is None:
        _, ax = plt.subplots()
    ax.plot(fpr, tpr)
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(f"ROC (AUC = {_auc(fpr, tpr):.4f})")
    return ax
