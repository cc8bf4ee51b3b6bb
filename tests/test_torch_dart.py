"""DART boosting: the PyTorch port against the JAX package.

DART draws its drop sets from ``np.random.default_rng(dropSeed)`` alone,
which both packages run the same way, so a fit without bagging and
``featureFraction`` draws nothing else at random and the port must grow
the JAX package's trees. Seeded rows (1,999 x 6, and a 600-row validation
set) go through both packages' ``train_booster`` on the CPU (the JAX side
on a one-device mesh, where it runs one fused program): trees identical,
margins within 1e-5 (each tree is scaled by its final DART weight), the
same ``best_iteration`` and histories within 1e-6 relative. Early
stopping records ``best_iteration`` and keeps every tree.

Cases: binary with a validation set and early stopping, with drops that
really happen (``dropRate=0.5``, ``skipDrop=0.2``); three classes;
regression (``rmse``) with ``metricEvalPeriod=2`` (the JAX package's host
loop); quantized (stochastically rounded); depthwise; bagging and
``featureFraction`` (the port draws the JAX package's streams,
``mmlspark_tpu_torch/utils/prng.py``; nothing is patched); the classifier
estimator. A DART fit that never drops (``skipDrop=1``) grows the gbdt
fit's trees.

The two packages sum the dropped ensemble in another order (the JAX
package with one ``einsum``, the port tree by tree), so gradients differ
by an ulp here and there; a row whose bf16-rounded stat flips with it
moves a small leaf's value past 1e-5. Leaves keep 40+ rows (100+ for three
classes, whose leaves are smaller).
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import booster as TB
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
CFG = dict(num_leaves=7, min_data_in_leaf=40)
DROPS = dict(drop_rate=0.5, skip_drop=0.2, drop_seed=9)


def _rows(n, seed, kind="binary"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    z = X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
    if kind == "binary":
        return X, (z > 0).astype(np.float32)
    if kind == "regression":
        return X, (z + 0.5 * X[:, 3]).astype(np.float32)
    logits = np.stack([X[:, 0] + X[:, 1], 0.8 * X[:, 2] * X[:, 3],
                       np.abs(X[:, 4]) - 0.7], axis=1)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    y = (rng.uniform(size=(n, 1)) > np.cumsum(p, axis=1)).sum(axis=1)
    return X, y.astype(np.float32)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _fit_pair(X, y, cfg=None, **kw):
    args = dict(objective="binary", num_iterations=6, max_bin=63,
                boosting_type="dart", **DROPS)
    args.update(kw)
    cfg = dict(CFG, **(cfg or {}))
    jb = jtrain(X, y, cfg=JG.GrowConfig(**cfg), mesh=_mesh(), **args)
    tb = TB.train_booster(X, y, cfg=TG.GrowConfig(**cfg), device="cpu",
                          **args)
    return jb, tb


def _assert_same_fit(jb, tb, X):
    assert tb.num_trees == jb.num_trees
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    assert tb.best_iteration == jb.best_iteration
    assert sorted(tb.eval_history) == sorted(jb.eval_history)
    for k, h in jb.eval_history.items():
        np.testing.assert_allclose(tb.eval_history[k], h, rtol=1e-6, atol=0)


def test_dart_validation_early_stopping_matches_jax():
    X, y = _rows(1999, 0)
    Xv, yv = _rows(600, 1)
    jb, tb = _fit_pair(X, y, num_iterations=12, valid_set=(Xv, yv, None),
                       early_stopping_rounds=2, cfg=dict(learning_rate=0.6))
    _assert_same_fit(jb, tb, X)
    hist = tb.eval_history["binary_logloss"]
    # it stopped early, kept every tree it grew and recorded the best
    assert len(hist) < 12 and tb.num_iterations == len(hist)
    assert tb.best_iteration == int(np.argmin(hist))
    assert tb.best_iteration < tb.num_iterations - 1


def test_dart_three_classes_matches_jax():
    X, y = _rows(2501, 2, "multiclass")
    jb, tb = _fit_pair(X, y, objective="multiclass", num_class=3,
                       num_iterations=5, cfg=dict(min_data_in_leaf=100))
    _assert_same_fit(jb, tb, X)


def test_dart_regression_eval_period_matches_jax():
    X, y = _rows(1999, 3, "regression")
    Xv, yv = _rows(500, 4, "regression")
    jb, tb = _fit_pair(X, y, objective="regression", num_iterations=7,
                       valid_set=(Xv, yv, None), metric_eval_period=2)
    _assert_same_fit(jb, tb, X)
    assert len(tb.eval_history["rmse"]) == 4        # iterations 0, 2, 4, 6


def test_dart_quantized_matches_jax():
    X, y = _rows(1997, 5)
    jb, tb = _fit_pair(X, y, cfg=dict(quantized_grad=True,
                                      quant_warmup_iters=1))
    _assert_same_fit(jb, tb, X)


def test_dart_depthwise_matches_jax():
    X, y = _rows(1999, 6)
    jb, tb = _fit_pair(X, y, cfg=dict(growth_policy="depthwise"))
    _assert_same_fit(jb, tb, X)


def test_dart_bagging_matches_jax():
    X, y = _rows(1999, 7)
    jb, tb = _fit_pair(X, y, bagging_fraction=0.7, bagging_freq=2, seed=5)
    _assert_same_fit(jb, tb, X)


def test_dart_feature_fraction_matches_jax():
    """Each iteration's feature subset under the JAX package's key
    ``fold_in(fold_in(PRNGKey(seed), it), 7)``."""
    X, y = _rows(1999, 10)
    jb, tb = _fit_pair(X, y, feature_fraction=0.5, seed=4)
    _assert_same_fit(jb, tb, X)


def test_dart_classifier_matches_jax():
    X, y = _rows(1999, 8)
    kw = dict(boostingType="dart", numIterations=5, numLeaves=7, maxBin=63,
              minDataInLeaf=40, dropRate=0.4, skipDrop=0.3, maxDrop=2,
              dropSeed=3)
    tm = LightGBMClassifier(device="cpu", **kw).fit(
        TDataset({"features": X, "label": y}))
    with default_mesh(_mesh()):
        jm = JClassifier(**kw).fit(JDataset({"features": X, "label": y}))
    _assert_same_fit(jm.booster, tm.booster, X)


def test_dart_without_drops_grows_the_gbdt_trees():
    """With ``skipDrop=1`` no tree is ever dropped and every scale stays 1:
    the fit is gbdt's."""
    X, y = _rows(1999, 9)
    kw = dict(objective="binary", num_iterations=4, max_bin=63,
              cfg=TG.GrowConfig(**CFG), device="cpu")
    dart = TB.train_booster(X, y, boosting_type="dart", skip_drop=1.0, **kw)
    gbdt = TB.train_booster(X, y, **kw)
    for f in STRUCTURE:
        np.testing.assert_array_equal(dart.trees[f], gbdt.trees[f])
    np.testing.assert_allclose(dart.predict_raw(X, device="cpu"),
                               gbdt.predict_raw(X, device="cpu"), rtol=0,
                               atol=1e-6)
