"""GBDT hyperparameter sweeps: the trials of one fold over one binned dataset.

The port's counterpart of ``mmlspark_tpu/automl/sweep.py``. The reference
parallelizes TuneHyperparameters trials across a Spark thread pool
(reference: automl/TuneHyperparameters.scala:100-160 — awaitable futures
over a fixed pool). The JAX package vmaps the trials through one compiled
boosting loop with the trial axis sharded over its mesh. The port's tree
growth is eager, with a host read-back per round, so it cannot vmap: it
keeps the JAX function's contract instead. Each trial's model equals a
sequential fit on one device (``est.copy(param_map).fit(train)``, byte for
byte), and the trials share the one ingest their fold needs: the rows are
binned once (:func:`...models.gbdt.api._cached_binned_dataset`) and every
trial trains on that dataset in turn on the estimator's device.

Over a data group of more than one rank the trials are dealt round-robin
over the ranks. Every rank holds all rows (the data group's contract), so
each fits its trials on a group of its own rank alone, and the fitted
boosters are gathered in trial order: every rank returns every model.

The envelope is the JAX package's, case for case (plain gbdt boosting, full
rows and features each iteration, K=1 objectives, no early stopping, warm
start, checkpoints, init scores or batches); :func:`swept_fit` returns None
outside it, and where histogram subtraction would engage, so the caller
falls back to sequential fits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataset import Dataset

# estimator param -> GrowConfig field: the params a sweep may vary (the JAX
# package traces exactly these through its vmapped loop)
SWEEPABLE: Dict[str, str] = {
    "learningRate": "learning_rate",
    "lambdaL1": "lambda_l1",
    "lambdaL2": "lambda_l2",
    "minGainToSplit": "min_gain_to_split",
    "minSumHessianInLeaf": "min_sum_hessian_in_leaf",
    "minDataInLeaf": "min_data_in_leaf",
}


def _eligible(est, param_maps: List[Dict[str, Any]]) -> bool:
    """True when ``est`` + the swept params fit the sweep's envelope."""
    from ..models.gbdt.api import LightGBMClassifier, LightGBMRegressor

    if not isinstance(est, (LightGBMClassifier, LightGBMRegressor)):
        return False
    if not param_maps or not all(set(m) <= set(SWEEPABLE)
                                 for m in param_maps):
        return False
    g = est.get_or_default
    if g("boostingType") != "gbdt":
        return False
    if (g("baggingFraction") < 1.0 or g("posBaggingFraction") < 1.0
            or g("negBaggingFraction") < 1.0 or g("featureFraction") < 1.0):
        return False
    if g("useQuantizedGrad"):
        return False
    # histSubtraction is NOT gated here: it is tri-state ("auto" default,
    # resolved per backend) and only ENGAGES above the growth layer's row
    # threshold — swept_fit applies that engagement rule once the row
    # count is known
    if g("earlyStoppingRound") > 0 or g("isProvideTrainingMetric"):
        return False
    if g("modelString") or g("checkpointDir") or g("initScoreCol"):
        return False
    if g("validationIndicatorCol") or (g("numBatches") or 0) > 1:
        return False
    return True


def _objective_of(est, y: np.ndarray):
    """(objective, num_class, kwargs, model_factory) mirroring est.fit."""
    from ..models.gbdt.api import (LightGBMClassificationModel,
                                   LightGBMClassifier,
                                   LightGBMRegressionModel)

    if isinstance(est, LightGBMClassifier):
        classes = np.unique(y[~np.isnan(y.astype(np.float64))])
        num_class = max(int(classes.max()) + 1 if classes.size else 2, 2)
        obj = est.get_or_default("objective") or (
            "binary" if num_class <= 2 else "multiclass")
        if obj != "binary" or num_class > 2:
            return None          # K>1: outside the envelope
        kwargs = {}
        if est.get_or_default("isUnbalance"):
            pos = float((y > 0).sum())
            kwargs["pos_weight"] = (len(y) - pos) / max(pos, 1.0)
        return obj, num_class, kwargs, (
            lambda b: LightGBMClassificationModel(b, numClasses=num_class))
    obj = est.get_or_default("objective")
    kwargs = {}
    if obj in ("huber", "quantile"):
        kwargs["alpha"] = est.get_or_default("alpha")
    if obj == "tweedie":
        kwargs["tweedie_variance_power"] = est.get_or_default(
            "tweedieVariancePower")
    return obj, 1, kwargs, LightGBMRegressionModel


def swept_fit(est, param_maps: List[Dict[str, Any]],
              train: Dataset) -> Optional[List[Any]]:
    """Fit one model per param map over one binned dataset.

    Returns fitted models (the same classes ``est.fit`` produces, params
    copied from ``est.copy(param_map)``), or None when the estimator or
    params fall outside the sweep's envelope. Each model's booster is
    byte-equal to ``est.copy(param_map).fit(train)``'s on a data group of
    one rank; over a larger group the trials run round-robin on the ranks,
    each on all rows (the JAX package's replicated-trial numerics)."""
    from ..models.gbdt.api import _cached_binned_dataset
    from ..models.gbdt.booster import train_booster
    from ..models.gbdt.growth import _use_subtraction
    from ..models.gbdt.objectives import get_objective
    from ..parallel import mesh as meshlib

    if not _eligible(est, param_maps):
        return None
    X, y, w = est._extract_arrays(train)
    base_cfg = est._grow_config()               # "auto" already resolved
    # subtraction would actually engage inside the trials (one-rank rule,
    # resolved config): fall back to sequential fits so the sweep takes
    # exactly the code path — and the memory profile — a plain est.fit()
    # would. The engagement row count is the padded dataset size, as in
    # the JAX package (its trials grow on replicated padded rows).
    group = meshlib.get_default_mesh()
    n_pad = -(-len(y) // group.size) * group.size
    if _use_subtraction(base_cfg, n_pad, group=None):
        return None
    objinfo = _objective_of(est, y)
    if objinfo is None:
        return None
    objective, _num_class, obj_kwargs, model_factory = objinfo
    if get_objective(objective, 1, **obj_kwargs).num_scores != 1:
        return None
    # this rank alone: the trials fit on all rows with no collective
    solo = (group if group.size == 1
            else meshlib.Mesh([group.ranks[group.rank]]))
    ds = _cached_binned_dataset(
        X, y, w, max_bin=est.get_or_default("maxBin"),
        bin_sample_count=est.get_or_default("binSampleCount"),
        seed=est.get_or_default("baggingSeed"),
        categorical_features=est._categorical_indexes(),
        bin_dtype=est.get_or_default("binDtype"),
        max_bin_by_feature=est.get_or_default("maxBinByFeature"),
        device=est.get_or_default("device"), mesh=solo)

    trials = [est.copy({k: v for k, v in pm.items() if est.has_param(k)})
              for pm in param_maps]
    boosters: Dict[int, Any] = {}
    for t in range(group.rank, len(trials), group.size):
        kw = trials[t]._train_kwargs(objective, 1, obj_kwargs)
        boosters[t] = train_booster(
            dataset=ds, num_iterations=trials[t].get_or_default(
                "numIterations"), **kw)
    if group.size > 1:
        boosters = _gather_boosters(boosters, group)

    models = []
    for t, trial in enumerate(trials):
        model = model_factory(trial._apply_slot_names(boosters[t]))
        trial._copy_params_to(model)
        models.append(model)
    return models


def _gather_boosters(mine: Dict[int, Any], group) -> Dict[int, Any]:
    """Every rank's ``{trial: booster}`` merged, on every rank (pickled
    through the group: a booster's arrays cross exactly)."""
    import torch.distributed as dist

    parts: List[Optional[Dict[int, Any]]] = [None] * group.size
    dist.all_gather_object(parts, mine, group=group.group)
    out: Dict[int, Any] = {}
    for p in parts:
        out.update(p)
    return out
