"""Auto-train API: TrainClassifier / TrainRegressor + model statistics.

Counterpart of ``mmlspark_tpu/train/core.py``: the reference's train package
(and, like it, over any inner estimator of the port) (reference:
train/TrainClassifier.scala:53-374 — auto featurize + label indexing + fit any
classifier; TrainRegressor.scala:24-178; ComputeModelStatistics.scala:22-466 —
classification/regression metric tables incl. confusion matrix and ROC;
ComputePerInstanceStatistics.scala:16-42).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import HasLabelCol, Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..featurize.core import Featurize, ValueIndexer
from ..observability import metrics as _metrics
from ..observability import watchdog as _watchdog
from ..observability.logging import get_logger
from ..observability.spans import span as _span

logger = get_logger("mmlspark_tpu_torch.train")


class TrainClassifier(Estimator, HasLabelCol):
    """Auto-featurize + label-index + fit the wrapped classifier
    (reference: train/TrainClassifier.scala:53-374)."""

    model = Param("model", "inner classifier estimator", None, is_complex=True)
    featuresCol = Param("featuresCol", "assembled features column",
                        "TrainClassifier_features", TypeConverters.to_string)
    numFeatures = Param("numFeatures", "hash space for string features", 262144,
                        TypeConverters.to_int)
    reindexLabel = Param("reindexLabel", "index the label column", True,
                         TypeConverters.to_bool)
    labels = Param("labels", "explicit label-value ordering: index i is "
                   "assigned to labels[i] (reference: TrainClassifier "
                   "labels); unlisted values raise", None,
                   TypeConverters.to_list_string)

    def __init__(self, model=None, **kwargs):
        super().__init__(**kwargs)
        if model is not None:
            self.set(model=model)

    def fit(self, dataset: Dataset) -> "TrainedClassifierModel":
        label = self.get_or_default("labelCol")
        fcol = self.get_or_default("featuresCol")
        levels = None
        ds = dataset
        if self.get_or_default("reindexLabel"):
            with _span(f"{self.uid}.index_labels",
                       metric_label="TrainClassifier.index_labels"):
                ds, levels = self._index_labels(ds, label)
        with _span(f"{self.uid}.featurize",
                   metric_label="TrainClassifier.featurize"):
            feat_model = Featurize(
                labelCol=label, outputCol=fcol,
                numberOfFeatures=self.get_or_default("numFeatures")).fit(ds)
            ds = feat_model.transform(ds)
        inner = self.get_or_default("model").copy(
            {"labelCol": label, "featuresCol": fcol})
        # watchdog heartbeat over the blocking inner fit: a wedged
        # estimator (stuck collective, hung native call) gets flagged
        # with full stacks instead of hanging the training job mutely
        with _watchdog.register("train_classifier_fit",
                                stall_seconds=600.0), \
                _span(f"{self.uid}.fit_inner",
                      metric_label="TrainClassifier.fit_inner",
                      inner=type(inner).__name__):
            fitted = inner.fit(ds)
        logger.info("TrainClassifier fit complete",
                    inner=type(inner).__name__,
                    rows=len(ds), classes=len(levels) if levels else None)
        model = TrainedClassifierModel(featurizer=feat_model, inner=fitted,
                                       levels=levels)
        self._copy_params_to(model)
        return model

    def _index_labels(self, ds: Dataset, label: str):
        """Label indexing phase of fit (explicit `labels` ordering or a
        fitted ValueIndexer) — returns (indexed dataset, levels)."""
        explicit = self.get_or_default("labels")
        if explicit:
            # reference TrainClassifier `labels`: the given ordering IS
            # the index mapping; values outside it must fail loudly.
            # Levels must match the column's value domain — numeric
            # columns index by float, string columns by str (the
            # Param converter stores the list as strings either way).
            from ..featurize.core import ValueIndexerModel, _is_numeric
            col = ds[label]
            if _is_numeric(col):
                levels = [float(v) for v in explicit]
                seen = {float(v) for v in np.asarray(col).ravel()
                        if not (isinstance(v, float) and np.isnan(v))}
            else:
                levels = [str(v) for v in explicit]
                seen = {str(v) for v in col if v is not None}
            extra = sorted(seen - set(levels))
            if extra:
                raise ValueError(
                    f"label column contains values {extra} not in the "
                    f"explicit labels list {explicit}")
            indexer_model = ValueIndexerModel(
                levels=levels).set(inputCol=label, outputCol=label)
            return indexer_model.transform(ds), levels
        indexer = ValueIndexer(inputCol=label, outputCol=label).fit(ds)
        return indexer.transform(ds), indexer.get_or_default("levels")


class TrainedClassifierModel(Model, HasLabelCol):
    featurizer = Param("featurizer", "fitted featurize model", None, is_complex=True)
    inner = Param("inner", "fitted classifier", None, is_complex=True)
    levels = Param("levels", "label levels", None, is_complex=True)
    featuresCol = Param("featuresCol", "assembled features column",
                        "TrainClassifier_features", TypeConverters.to_string)

    def __init__(self, featurizer=None, inner=None, levels=None, **kwargs):
        super().__init__(**kwargs)
        if featurizer is not None:
            self.set(featurizer=featurizer)
        if inner is not None:
            self.set(inner=inner)
        if levels is not None:
            self.set(levels=levels)

    def transform(self, dataset: Dataset) -> Dataset:
        label = self.get_or_default("labelCol")
        ds = dataset
        levels = self.get_if_set("levels")
        if levels and label in ds:
            lookup = {v: i for i, v in enumerate(levels)}
            y = ds[label]
            idx = np.asarray([lookup.get(
                float(v) if isinstance(v, (int, float, np.number)) else str(v),
                len(levels)) for v in y], dtype=np.float64)
            ds = ds.with_column(label, idx)
        ds = self.get_or_default("featurizer").transform(ds)
        out = self.get_or_default("inner").transform(ds)
        return out.drop(self.get_or_default("featuresCol"))


class TrainRegressor(Estimator, HasLabelCol):
    """reference: train/TrainRegressor.scala:24-178"""

    model = Param("model", "inner regressor estimator", None, is_complex=True)
    featuresCol = Param("featuresCol", "assembled features column",
                        "TrainRegressor_features", TypeConverters.to_string)
    numFeatures = Param("numFeatures", "hash space for string features", 262144,
                        TypeConverters.to_int)

    def __init__(self, model=None, **kwargs):
        super().__init__(**kwargs)
        if model is not None:
            self.set(model=model)

    def fit(self, dataset: Dataset) -> "TrainedRegressorModel":
        label = self.get_or_default("labelCol")
        fcol = self.get_or_default("featuresCol")
        with _span(f"{self.uid}.featurize",
                   metric_label="TrainRegressor.featurize"):
            feat_model = Featurize(
                labelCol=label, outputCol=fcol,
                numberOfFeatures=self.get_or_default("numFeatures")).fit(
                    dataset)
            ds = feat_model.transform(dataset)
        inner = self.get_or_default("model").copy(
            {"labelCol": label, "featuresCol": fcol})
        with _watchdog.register("train_regressor_fit",
                                stall_seconds=600.0), \
                _span(f"{self.uid}.fit_inner",
                      metric_label="TrainRegressor.fit_inner",
                      inner=type(inner).__name__):
            fitted = inner.fit(ds)
        logger.info("TrainRegressor fit complete",
                    inner=type(inner).__name__, rows=len(ds))
        model = TrainedRegressorModel(featurizer=feat_model, inner=fitted)
        self._copy_params_to(model)
        return model


class TrainedRegressorModel(Model, HasLabelCol):
    featurizer = Param("featurizer", "fitted featurize model", None, is_complex=True)
    inner = Param("inner", "fitted regressor", None, is_complex=True)
    featuresCol = Param("featuresCol", "assembled features column",
                        "TrainRegressor_features", TypeConverters.to_string)

    def __init__(self, featurizer=None, inner=None, **kwargs):
        super().__init__(**kwargs)
        if featurizer is not None:
            self.set(featurizer=featurizer)
        if inner is not None:
            self.set(inner=inner)

    def transform(self, dataset: Dataset) -> Dataset:
        ds = self.get_or_default("featurizer").transform(dataset)
        out = self.get_or_default("inner").transform(ds)
        return out.drop(self.get_or_default("featuresCol"))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _ranked_counts(y: np.ndarray, score: np.ndarray):
    """Cumulative true-positive counts at each DISTINCT threshold — tied
    scores must move together, else curve areas become order-dependent and
    biased. Shared spine of the ROC and PR curves. Returns (idx, tps,
    thresholds) with idx the 0-based rank of each threshold's last row."""
    order = np.argsort(-score, kind="stable")
    ys, ss = y[order], score[order]
    boundary = np.nonzero(np.diff(ss))[0]
    idx = np.concatenate([boundary, [len(ys) - 1]])
    return idx, np.cumsum(ys)[idx], ss[idx]


def _roc_curve(y: np.ndarray, score: np.ndarray):
    idx, tps, _ = _ranked_counts(y, score)
    fps = (idx + 1) - tps
    P, N = max(tps[-1], 1e-12), max(fps[-1], 1e-12)
    tpr = np.concatenate([[0.0], tps / P])
    fpr = np.concatenate([[0.0], fps / N])
    return fpr, tpr


def _auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    return float(np.trapezoid(tpr, fpr))


def _pr_curve(y: np.ndarray, score: np.ndarray):
    """(precision, recall, thresholds) — one point per distinct threshold,
    prepended with the (recall=0, precision=1) anchor Spark's
    BinaryClassificationMetrics.pr() uses."""
    idx, tps, thresholds = _ranked_counts(y, score)
    P = max(tps[-1], 1e-12)
    return (np.concatenate([[1.0], tps / (idx + 1)]),
            np.concatenate([[0.0], tps / P]),
            thresholds)


class ComputeModelStatistics(Transformer):
    """Evaluation metrics as a Dataset (reference:
    train/ComputeModelStatistics.scala:22-466 — classification: accuracy,
    precision, recall, AUC, confusion matrix; regression: mse, rmse, r2, mae)."""

    evaluationMetric = Param("evaluationMetric", "classification | regression | auto",
                             "auto", TypeConverters.to_string)
    labelCol = Param("labelCol", "label column", "label", TypeConverters.to_string)
    scoresCol = Param("scoresCol", "probability/scores column", "probability",
                      TypeConverters.to_string)
    scoredLabelsCol = Param("scoredLabelsCol", "prediction column", "prediction",
                            TypeConverters.to_string)
    # curves/tables made available after transform (reference exposes its
    # confusion matrix and the Spark metric objects' curves the same way)
    confusion_matrix: Optional[np.ndarray] = None
    roc_curve: Optional[Dataset] = None
    pr_curve: Optional[Dataset] = None
    threshold_metrics: Optional[Dataset] = None

    def _is_classification(self, y: np.ndarray) -> bool:
        metric = self.get_or_default("evaluationMetric")
        if metric != "auto":
            return metric.startswith("class")
        vals = np.unique(y)
        return len(vals) <= max(20, int(np.sqrt(len(y)))) and \
            np.allclose(vals, vals.astype(int))

    def _publish(self, out: dict) -> Dataset:
        """Mirror the scalar metric table into registry gauges
        (``model_statistic{metric=...}``) so evaluation results are
        scrapeable alongside serving/training telemetry."""
        for k, v in out.items():
            _metrics.safe_gauge("model_statistic",
                                metric=k).set(float(np.asarray(v)[0]))
        return Dataset(out)

    def transform(self, dataset: Dataset) -> Dataset:
        y = dataset.array(self.get_or_default("labelCol"), np.float64)
        pred = dataset.array(self.get_or_default("scoredLabelsCol"), np.float64)
        if self._is_classification(y):
            k = int(max(y.max(), pred.max())) + 1
            cm = np.zeros((k, k), np.int64)
            for t, p in zip(y.astype(int), pred.astype(int)):
                cm[t, p] += 1
            self.confusion_matrix = cm
            acc = float((y == pred).mean())
            # macro + class-frequency-weighted precision/recall (parity with
            # the MulticlassMetrics the reference delegates to —
            # ComputeModelStatistics.scala:56-466 reports weightedPrecision/
            # weightedRecall alongside the unweighted variants)
            with np.errstate(invalid="ignore", divide="ignore"):
                prec_k = np.diag(cm) / np.maximum(cm.sum(axis=0), 1)
                rec_k = np.diag(cm) / np.maximum(cm.sum(axis=1), 1)
            freq = cm.sum(axis=1) / max(cm.sum(), 1)
            out = {
                "accuracy": np.asarray([acc]),
                "precision": np.asarray([float(np.nanmean(prec_k))]),
                "recall": np.asarray([float(np.nanmean(rec_k))]),
                "weighted_precision": np.asarray(
                    [float(np.nansum(prec_k * freq))]),
                "weighted_recall": np.asarray(
                    [float(np.nansum(rec_k * freq))]),
            }
            scol = self.get_or_default("scoresCol")
            if k == 2 and scol in dataset:
                scores = np.asarray(dataset[scol], np.float64)
                p1 = scores[:, 1] if scores.ndim == 2 else scores
                fpr, tpr = _roc_curve(y, p1)
                out["AUC"] = np.asarray([_auc(fpr, tpr)])
                self.roc_curve = Dataset({"false_positive_rate": fpr,
                                          "true_positive_rate": tpr})
                # precision-recall curve + per-threshold table
                # (BinaryClassificationMetrics parity: pr(), thresholds())
                prec_c, rec_c, thr_c = _pr_curve(y, p1)
                out["AUPR"] = np.asarray([float(np.trapezoid(prec_c, rec_c))])
                self.pr_curve = Dataset({"recall": rec_c,
                                         "precision": prec_c})
                self.threshold_metrics = Dataset({
                    "threshold": thr_c,
                    "precision": prec_c[1:],
                    "recall": rec_c[1:]})
            return self._publish(out)
        # regression
        err = pred - y
        mse = float(np.mean(err ** 2))
        var = float(np.var(y))
        return self._publish({
            "mean_squared_error": np.asarray([mse]),
            "root_mean_squared_error": np.asarray([mse ** 0.5]),
            "mean_absolute_error": np.asarray([float(np.mean(np.abs(err)))]),
            "R^2": np.asarray([1.0 - mse / var if var > 0 else 0.0]),
        })


class ComputePerInstanceStatistics(Transformer):
    """Per-row loss/error columns (reference:
    train/ComputePerInstanceStatistics.scala:16-42)."""

    labelCol = Param("labelCol", "label column", "label", TypeConverters.to_string)
    scoresCol = Param("scoresCol", "probability column", "probability",
                      TypeConverters.to_string)
    scoredLabelsCol = Param("scoredLabelsCol", "prediction column", "prediction",
                            TypeConverters.to_string)
    evaluationMetric = Param("evaluationMetric", "classification | regression | auto",
                             "auto", TypeConverters.to_string)

    def transform(self, dataset: Dataset) -> Dataset:
        y = dataset.array(self.get_or_default("labelCol"), np.float64)
        pred = dataset.array(self.get_or_default("scoredLabelsCol"), np.float64)
        scol = self.get_or_default("scoresCol")
        helper = ComputeModelStatistics(
            evaluationMetric=self.get_or_default("evaluationMetric"))
        if helper._is_classification(y):
            if scol in dataset:
                scores = np.asarray(dataset[scol], np.float64)
                if scores.ndim == 2:
                    picked = scores[np.arange(len(y)), y.astype(int).clip(
                        0, scores.shape[1] - 1)]
                else:
                    picked = np.where(y > 0, scores, 1 - scores)
                logloss = -np.log(np.clip(picked, 1e-15, 1.0))
                return dataset.with_column("log_loss", logloss)
            return dataset.with_column("correct", (y == pred).astype(np.float64))
        err = pred - y
        return dataset.with_columns({
            "L1_loss": np.abs(err), "L2_loss": err ** 2})
