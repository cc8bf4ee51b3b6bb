"""AutoML: hyperparameter spaces, tuning with k-fold CV, model selection.

The port's copy of ``mmlspark_tpu/automl/core.py`` (reference:
automl/TuneHyperparameters.scala:37-235 — random/grid search with thread-pool
parallel x-fold CV; HyperparamBuilder.scala:11-97; ParamSpace.scala:11-34;
FindBestModel.scala:21-199; EvaluationUtils.scala:15). The reference
parallelizes trials across a Spark cluster's thread pool; here the host runs
the trials and each trial's fit runs on the estimator's device (``cuda``
unless its ``device`` param says ``cpu``). ``parallelism > 1`` routes GBDT
sweeps through :func:`.sweep.swept_fit`: the trials of a fold share one
binned dataset and run in turn on the card.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..train.core import ComputeModelStatistics

# metrics where larger is better (reference: EvaluationUtils.scala metric infos)
_MAXIMIZE = {"AUC", "accuracy", "precision", "recall", "R^2", "r2"}
_METRIC_COL = {
    "AUC": "AUC", "accuracy": "accuracy", "precision": "precision",
    "recall": "recall", "mse": "mean_squared_error",
    "rmse": "root_mean_squared_error", "mae": "mean_absolute_error",
    "r2": "R^2", "R^2": "R^2",
}


# -- hyperparameter distributions (reference: HyperparamBuilder.scala:11-97) ----


class DiscreteHyperParam:
    """A finite set of values (uniform draw)."""

    def __init__(self, values: Sequence[Any], seed: int = 0):
        self.values = list(values)

    def draw(self, rng) -> Any:
        return self.values[int(rng.integers(len(self.values)))]

    def grid(self) -> List[Any]:
        return list(self.values)


class RangeHyperParam:
    """Uniform range [lo, hi); integer if both ends are ints."""

    def __init__(self, lo, hi, seed: int = 0):
        self.lo, self.hi = lo, hi
        self.is_int = isinstance(lo, int) and isinstance(hi, int)

    def draw(self, rng):
        if self.is_int:
            return int(rng.integers(self.lo, self.hi))
        return float(rng.uniform(self.lo, self.hi))

    def grid(self, n: int = 3) -> List[Any]:
        xs = np.linspace(self.lo, self.hi, n)
        return [int(x) for x in xs] if self.is_int else [float(x) for x in xs]


class HyperparamBuilder:
    """Collects (paramName -> dist) pairs (reference: HyperparamBuilder)."""

    def __init__(self):
        self._space: Dict[str, Any] = {}

    def add_hyperparam(self, name: str, dist) -> "HyperparamBuilder":
        self._space[name] = dist
        return self

    addHyperparam = add_hyperparam

    def build(self) -> Dict[str, Any]:
        return dict(self._space)


class RandomSpace:
    """Random draws from a param space (reference: ParamSpace.scala:11-34)."""

    def __init__(self, space: Dict[str, Any], seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)

    def param_maps(self, n: int):
        for _ in range(n):
            yield {k: d.draw(self.rng) for k, d in self.space.items()}


class GridSpace:
    """Cartesian product of per-param grids."""

    def __init__(self, space: Dict[str, Any], num_range_points: int = 3):
        self.space = space
        self.n = num_range_points

    def param_maps(self, n: Optional[int] = None):
        names = list(self.space)
        grids = [self.space[k].grid(self.n) if isinstance(self.space[k], RangeHyperParam)
                 else self.space[k].grid() for k in names]
        combos = itertools.product(*grids)
        for i, combo in enumerate(combos):
            if n is not None and i >= n:
                return
            yield dict(zip(names, combo))


# -- evaluation helper (reference: EvaluationUtils.scala:15) --------------------


def evaluate_metric(scored: Dataset, metric: str, labelCol: str = "label") -> float:
    """One scalar metric from a scored Dataset."""
    kind = ("classification" if metric in ("AUC", "accuracy", "precision", "recall")
            else "regression")
    stats = ComputeModelStatistics(
        evaluationMetric=kind, labelCol=labelCol).transform(scored)
    col = _METRIC_COL.get(metric, metric)
    if col not in stats:
        raise ValueError(f"metric {metric!r} not produced; have {stats.columns}")
    return float(stats[col][0])


# -- tuning (reference: automl/TuneHyperparameters.scala:37-235) ----------------


class TuneHyperparameters(Estimator):
    """Random/grid search over estimators with k-fold CV.

    reference: TuneHyperparameters.scala:80-160 (thread-pool parallel CV);
    trials here run in turn on the estimator's device.
    """

    models = Param("models", "estimators to tune", None, is_complex=True)
    evaluationMetric = Param("evaluationMetric", "metric name (AUC, accuracy, "
                             "rmse, ...)", "accuracy", TypeConverters.to_string)
    numFolds = Param("numFolds", "cross-validation folds", 3, TypeConverters.to_int)
    numRuns = Param("numRuns", "total param draws (random search)", 10,
                    TypeConverters.to_int)
    parallelism = Param("parallelism", "trial parallelism (reference: a "
                        "thread pool of concurrent CV fits). >1 runs GBDT "
                        "sweeps fold by fold over one binned dataset, the "
                        "trials dealt over the data group's ranks "
                        "(automl/sweep.py); estimators or param spaces "
                        "outside that envelope fall back to sequential "
                        "fits", 1, TypeConverters.to_int)
    paramSpace = Param("paramSpace", "RandomSpace/GridSpace or dict of dists",
                       None, is_complex=True)
    seed = Param("seed", "random seed", 0, TypeConverters.to_int)
    labelCol = Param("labelCol", "label column", "label", TypeConverters.to_string)

    def __init__(self, models=None, **kwargs):
        super().__init__(**kwargs)
        if models is not None:
            self.set(models=models)

    def _cv_metric(self, est: Estimator, params: Dict[str, Any],
                   folds: List[Dataset], metric: str, label: str) -> float:
        vals = []
        for i in range(len(folds)):
            train = None
            for j, f in enumerate(folds):
                if j != i:
                    train = f if train is None else train.union(f)
            trial = est.copy({k: v for k, v in params.items()
                              if est.has_param(k)})
            scored = trial.fit(train).transform(folds[i])
            vals.append(evaluate_metric(scored, metric, label))
        return float(np.mean(vals))

    def _swept_cv_metrics(self, est: Estimator,
                          param_maps: List[Dict[str, Any]],
                          folds: List[Dataset], metric: str,
                          label: str) -> "Optional[List[float]]":
        """All trials' CV metrics via the sweep (folds outer, trials
        inner), or None when the estimator/space is outside its envelope
        (the caller falls back to per-trial sequential fits)."""
        from .sweep import swept_fit

        per_trial = np.zeros((len(param_maps), len(folds)))
        for i in range(len(folds)):
            train = None
            for j, f in enumerate(folds):
                if j != i:
                    train = f if train is None else train.union(f)
            models = swept_fit(est, param_maps, train)
            if models is None:
                return None
            for t, model in enumerate(models):
                per_trial[t, i] = evaluate_metric(
                    model.transform(folds[i]), metric, label)
        return [float(m) for m in per_trial.mean(axis=1)]

    def fit(self, dataset: Dataset) -> "TuneHyperparametersModel":
        metric = self.get_or_default("evaluationMetric")
        label = self.get_or_default("labelCol")
        k = self.get_or_default("numFolds")
        folds = dataset.split([1.0 / k] * k, seed=self.get_or_default("seed"))
        space = self.get_if_set("paramSpace")
        if isinstance(space, dict):
            space = RandomSpace(space, self.get_or_default("seed"))
        models = self.get_or_default("models")
        if not isinstance(models, (list, tuple)):
            models = [models]

        maximize = metric in _MAXIMIZE
        best = (-np.inf if maximize else np.inf, None, None)
        history = []
        param_maps = (list(space.param_maps(self.get_or_default("numRuns")))
                      if space is not None else [{}])
        parallelism = self.get_or_default("parallelism")
        for est in models:
            swept = None
            if parallelism and parallelism > 1 and len(param_maps) > 1:
                swept = self._swept_cv_metrics(est, param_maps, folds,
                                               metric, label)
            trial_metrics = (swept if swept is not None else
                             [self._cv_metric(est, p, folds, metric, label)
                              for p in param_maps])
            for params, m in zip(param_maps, trial_metrics):
                history.append((type(est).__name__, dict(params), m))
                if (m > best[0]) if maximize else (m < best[0]):
                    best = (m, est, params)
        _, best_est, best_params = best
        fitted = best_est.copy({k: v for k, v in (best_params or {}).items()
                                if best_est.has_param(k)}).fit(dataset)
        return TuneHyperparametersModel(
            bestModel=fitted, bestMetric=best[0],
            bestParams=best_params, history=history)


class TuneHyperparametersModel(Model):
    bestModel = Param("bestModel", "winning fitted model", None, is_complex=True)
    bestMetric = Param("bestMetric", "winning CV metric", None,
                       TypeConverters.to_float)
    bestParams = Param("bestParams", "winning param map", None, is_complex=True)
    history = Param("history", "all (model, params, metric) trials", None,
                    is_complex=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def transform(self, dataset: Dataset) -> Dataset:
        return self.get_or_default("bestModel").transform(dataset)

    def get_best_model_info(self) -> str:
        return (f"metric={self.get_or_default('bestMetric')} "
                f"params={self.get_or_default('bestParams')}")


class FindBestModel(Estimator):
    """Evaluate already-specified models on the fit dataset and keep the best
    (reference: automl/FindBestModel.scala:21-199)."""

    models = Param("models", "fitted Transformers or Estimators to compare",
                   None, is_complex=True)
    evaluationMetric = Param("evaluationMetric", "metric name", "accuracy",
                             TypeConverters.to_string)
    labelCol = Param("labelCol", "label column", "label", TypeConverters.to_string)

    def __init__(self, models=None, **kwargs):
        super().__init__(**kwargs)
        if models is not None:
            self.set(models=models)

    def fit(self, dataset: Dataset) -> "BestModel":
        metric = self.get_or_default("evaluationMetric")
        label = self.get_or_default("labelCol")
        maximize = metric in _MAXIMIZE
        rows = []
        best = (-np.inf if maximize else np.inf, None)
        for m in self.get_or_default("models"):
            fitted = m.fit(dataset) if isinstance(m, Estimator) else m
            scored = fitted.transform(dataset)
            val = evaluate_metric(scored, metric, label)
            rows.append({"model": type(fitted).__name__, metric: val})
            if (val > best[0]) if maximize else (val < best[0]):
                best = (val, fitted)
        out = BestModel(bestModel=best[1], bestMetric=best[0],
                        allModelMetrics=Dataset.from_rows(rows))
        self._copy_params_to(out)
        return out


class BestModel(Model):
    bestModel = Param("bestModel", "winning model", None, is_complex=True)
    bestMetric = Param("bestMetric", "winning metric value", None,
                       TypeConverters.to_float)
    allModelMetrics = Param("allModelMetrics", "per-model metric table", None,
                            is_complex=True)

    def transform(self, dataset: Dataset) -> Dataset:
        return self.get_or_default("bestModel").transform(dataset)

    def get_evaluation_results(self) -> Dataset:
        return self.get_or_default("allModelMetrics")
