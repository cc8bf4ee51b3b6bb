"""The port's AutoML (``mmlspark_tpu_torch/automl``) against the JAX
package's, on the CPU, at small sizes.

* ``RandomSpace`` and ``GridSpace`` give the same param maps for one seed
  (the same numpy draws), and ``evaluate_metric`` the same values.
* ``TuneHyperparameters`` on the JAX test's 400 x 6 rows and 8-trial grid:
  the histories agree within 1e-6 with ``parallelism`` 1 (params outer,
  folds inner) and 8 (the sweep: folds outer, trials inner), and the port's
  two routes are equal trial by trial.
* The port's swept trees equal JAX ``swept_fit``'s (same structure, leaves
  within 1e-5), and every swept booster's ``model_string`` is byte-equal to
  a sequential ``est.copy(pm).fit``'s.
* ``_eligible`` equals the JAX function over a table of cases, and both
  packages fall back (None) at 8,192 rows or more with the default
  ``histSubtraction``; a structural space falls back to sequential fits.
* Over two gloo ranks the trials are dealt round-robin and every rank
  returns every model, byte-equal to one process's sweep.
* ``FindBestModel`` picks the same model with the same table; both models
  save and load, and JAX-saved directories load in the port.
* The binned-dataset cache's hits and misses over a tuning pin the two
  routes' loop orders (the sequential route misses on every fit from 3
  folds on, as the reference's order makes it).

The JAX estimators run on one device
(``default_mesh(make_mesh(devices=jax.devices()[:1]))``).
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.automl import core as jcore
from mmlspark_tpu.automl import sweep as jsweep
from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.core.pipeline import PipelineStage as JStage
from mmlspark_tpu.models.gbdt import api as japi
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.automl import core as tcore
from mmlspark_tpu_torch.automl import sweep as tsweep
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.gbdt import api as tapi

from _torch_ranks import run_ranks

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
EST = dict(numIterations=4, numLeaves=7, minDataInLeaf=2, maxBin=31)
GRID = {"learningRate": [0.05, 0.1, 0.2, 0.4], "lambdaL2": [0.0, 1.0]}


def _one_device():
    return default_mesh(make_mesh(devices=jax.devices()[:1]))


def sweep_rows():
    """The JAX test's rows (tests/test_classic_ml.py)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    return X, y


def blobs(seed=0, n=120, d=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (n // 2, d)) + 4.0
    b = rng.normal(0, 1, (n // 2, d)) - 4.0
    X = np.concatenate([a, b]).astype(np.float32)
    return X, np.concatenate([np.ones(n // 2), np.zeros(n // 2)])


def grid(mod):
    return mod.GridSpace({k: mod.DiscreteHyperParam(v)
                          for k, v in GRID.items()})


def _key(params):
    return tuple(sorted(params.items()))


def _same_trees(tb, jb, atol=1e-5):
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)), f)
    leaf = tb.trees["is_leaf"]
    np.testing.assert_allclose(
        np.where(leaf, tb.trees["leaf_value"], 0),
        np.where(leaf, np.asarray(jb.trees.leaf_value), 0), rtol=0,
        atol=atol)


def test_param_maps_equal_jax():
    for mod_space in ("random", "grid"):
        maps = []
        for mod in (tcore, jcore):
            space = {"a": mod.DiscreteHyperParam([1, 2, 5]),
                     "b": mod.RangeHyperParam(0.0, 1.0),
                     "c": mod.RangeHyperParam(2, 40)}
            sp = (mod.RandomSpace(space, seed=11) if mod_space == "random"
                  else mod.GridSpace(space, num_range_points=4))
            maps.append(list(sp.param_maps(20)))
        assert maps[0] == maps[1] and len(maps[0]) == 20
        for m in maps[0]:
            assert [type(m[k]) for k in "abc"] == [int, float, int]
    hb = (tcore.HyperparamBuilder()
          .addHyperparam("x", tcore.DiscreteHyperParam([3])).build())
    assert list(hb) == ["x"]


def test_evaluate_metric_equals_jax():
    rng = np.random.default_rng(3)
    y = (rng.random(300) > 0.4).astype(np.float64)
    p1 = np.clip(y * 0.5 + rng.random(300) * 0.6, 0, 1)
    cls = {"label": y, "prediction": (p1 > 0.5).astype(np.float64),
           "probability": np.stack([1 - p1, p1], 1),
           "rawPrediction": np.stack([-p1, p1], 1)}
    reg = {"label": y * 3 + rng.normal(size=300),
           "prediction": y * 3 + rng.normal(size=300) * 0.5}
    for metric in ("AUC", "accuracy", "precision", "recall"):
        assert tcore.evaluate_metric(Dataset(dict(cls)), metric) == \
            jcore.evaluate_metric(JDataset(dict(cls)), metric), metric
    for metric in ("mse", "rmse", "mae", "r2", "R^2"):
        assert tcore.evaluate_metric(Dataset(dict(reg)), metric) == \
            jcore.evaluate_metric(JDataset(dict(reg)), metric), metric
    with pytest.raises(ValueError, match="not produced"):
        tcore.evaluate_metric(Dataset(dict(reg)), "nonsense")
    assert tcore._MAXIMIZE == jcore._MAXIMIZE


@pytest.fixture(scope="module")
def tuned():
    """Both packages' TuneHyperparameters at parallelism 1 and 8."""
    X, y = sweep_rows()
    out = {}
    for par in (1, 8):
        out[("port", par)] = tcore.TuneHyperparameters(
            models=[tapi.LightGBMClassifier(device="cpu", **EST)],
            evaluationMetric="accuracy", numFolds=2, paramSpace=grid(tcore),
            parallelism=par).fit(Dataset({"features": X, "label": y}))
        with _one_device():
            out[("jax", par)] = jcore.TuneHyperparameters(
                models=[japi.LightGBMClassifier(**EST)],
                evaluationMetric="accuracy", numFolds=2,
                paramSpace=grid(jcore), parallelism=par).fit(
                    JDataset({"features": X, "label": y}))
    return out


@pytest.mark.parametrize("par", [1, 8])
def test_tune_history_matches_jax(tuned, par):
    t, j = tuned[("port", par)], tuned[("jax", par)]
    ht, hj = t.get_or_default("history"), j.get_or_default("history")
    assert len(ht) == len(hj) == 8
    for (nt, pt, mt), (nj, pj, mj) in zip(ht, hj):
        assert (nt, pt) == (nj, pj)
        assert abs(mt - mj) <= 1e-6, (pt, mt, mj)
    assert abs(t.get_or_default("bestMetric")
               - j.get_or_default("bestMetric")) <= 1e-6
    assert t.get_or_default("bestParams") == j.get_or_default("bestParams")
    assert t.get_or_default("bestMetric") > 0.8
    assert t.get_best_model_info() == (
        f"metric={t.get_or_default('bestMetric')} "
        f"params={t.get_or_default('bestParams')}")


def test_swept_and_sequential_routes_are_equal(tuned):
    seq = tuned[("port", 1)].get_or_default("history")
    par = tuned[("port", 8)].get_or_default("history")
    assert seq == par


@pytest.fixture(scope="module")
def fold_train():
    X, y = sweep_rows()
    return X[:200], y[:200]


def test_swept_trees_match_jax_swept_fit(fold_train):
    """Leaves of 20+ rows: a leaf of a few rows drifts past 1e-5 through
    the f32 root totals, as in every GBDT parity test of the port."""
    X, y = fold_train
    maps = list(grid(tcore).param_maps())
    est = dict(EST, minDataInLeaf=20)
    ours = tsweep.swept_fit(tapi.LightGBMClassifier(device="cpu", **est),
                            maps, Dataset({"features": X, "label": y}))
    with _one_device():
        theirs = jsweep.swept_fit(japi.LightGBMClassifier(**est), maps,
                                  JDataset({"features": X, "label": y}))
    assert len(ours) == len(theirs) == 8
    for pm, mt, mj in zip(maps, ours, theirs):
        assert type(mt).__name__ == type(mj).__name__
        assert mt.get_or_default("learningRate") == pm["learningRate"]
        _same_trees(mt.booster, mj.booster)
        np.testing.assert_allclose(
            mt.booster.predict_raw(X, device="cpu"),
            np.asarray(mj.booster.predict_raw(X)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_swept_models_byte_equal_sequential_fits(fold_train, estimator):
    X, y = fold_train
    maps = list(grid(tcore).param_maps())[::3]
    if estimator == "classifier":
        est = tapi.LightGBMClassifier(device="cpu",
                                      slotNames=[f"f{i}" for i in range(6)],
                                      **EST)
    else:
        est = tapi.LightGBMRegressor(device="cpu", objective="huber",
                                     alpha=0.7, **EST)
        y = y + X[:, 3]
    ds = Dataset({"features": X, "label": y})
    tapi.binned_cache_stats(reset=True)
    swept = tsweep.swept_fit(est, maps, ds)
    # one ingest: the trials share the fold's binned dataset
    assert tapi.binned_cache_stats()["misses"] <= 1
    for pm, model in zip(maps, swept):
        ref = est.copy(pm).fit(ds)
        assert type(model) is type(ref)
        assert model.booster.model_string() == ref.booster.model_string()
        assert model._paramMap == ref._paramMap
        np.testing.assert_array_equal(
            model.transform(ds).array("prediction"),
            ref.transform(ds).array("prediction"))


def _pair(**kw):
    return (tapi.LightGBMClassifier(**kw), japi.LightGBMClassifier(**kw))


ELIGIBLE_CASES = {
    "plain": (_pair(), [{"learningRate": 0.1}]),
    "every_sweepable": (_pair(), [{k: 1.0 for k in tsweep.SWEEPABLE}]),
    "non_sweepable_key": (_pair(), [{"numLeaves": 7}]),
    "empty_maps": (_pair(), []),
    "ranker": ((tapi.LightGBMRanker(), japi.LightGBMRanker()),
               [{"learningRate": 0.1}]),
    "regressor": ((tapi.LightGBMRegressor(), japi.LightGBMRegressor()),
                  [{"lambdaL1": 0.5}]),
    "quantized": (_pair(useQuantizedGrad=True), [{"learningRate": 0.1}]),
    "bagging": (_pair(baggingFraction=0.8), [{"learningRate": 0.1}]),
    "pos_bagging": (_pair(posBaggingFraction=0.5), [{"learningRate": 0.1}]),
    "feature_fraction": (_pair(featureFraction=0.5),
                         [{"learningRate": 0.1}]),
    "goss": (_pair(boostingType="goss"), [{"learningRate": 0.1}]),
    "dart": (_pair(boostingType="dart"), [{"learningRate": 0.1}]),
    "init_score": (_pair(initScoreCol="s"), [{"learningRate": 0.1}]),
    "num_batches": (_pair(numBatches=2), [{"learningRate": 0.1}]),
    "early_stopping": (_pair(earlyStoppingRound=3), [{"learningRate": 0.1}]),
    "training_metric": (_pair(isProvideTrainingMetric=True),
                        [{"learningRate": 0.1}]),
    "validation": (_pair(validationIndicatorCol="v"),
                   [{"learningRate": 0.1}]),
    "checkpoint": (_pair(checkpointDir="/nonexistent"),
                   [{"learningRate": 0.1}]),
    "warm_start": (_pair(modelString="tree"), [{"learningRate": 0.1}]),
    "no_subtraction": (_pair(histSubtraction=False), [{"lambdaL2": 1.0}]),
}


@pytest.mark.parametrize("case", sorted(ELIGIBLE_CASES))
def test_eligible_equals_jax(case):
    (t, j), maps = ELIGIBLE_CASES[case]
    assert tsweep._eligible(t, maps) == jsweep._eligible(j, maps)
    assert tsweep.SWEEPABLE == jsweep.SWEEPABLE


@pytest.mark.parametrize("n,hist_subtraction,falls_back", [
    (8192, "auto", True), (20000, "auto", True), (8192, True, True),
    (8192, False, False)])
def test_fallback_at_the_subtraction_threshold(n, hist_subtraction,
                                              falls_back):
    """With subtraction on (the default resolves to on for both packages
    off TPU), the sweep returns None at 8,192 rows or more: both
    packages."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    maps = [{"learningRate": 0.1}, {"learningRate": 0.3}]
    kw = dict(numIterations=1, numLeaves=4, maxBin=15,
              histSubtraction=hist_subtraction)
    got = tsweep.swept_fit(tapi.LightGBMClassifier(device="cpu", **kw),
                           maps, Dataset({"features": X, "label": y}))
    assert (got is None) == falls_back
    if falls_back:
        with _one_device():
            assert jsweep.swept_fit(japi.LightGBMClassifier(**kw), maps,
                                    JDataset({"features": X,
                                              "label": y})) is None


@pytest.mark.parametrize("folds,swept,sequential", [
    (2, (0, 3), (14, 3)), (3, (0, 4), (0, 25))])
def test_binned_cache_lookups_keep_the_reference_loop_orders(
        folds, swept, sequential):
    """(hits, misses) of the binned-dataset cache over a whole tuning: the
    sweep binds each fold's rows once (folds outer, trials inner); the
    sequential route (params outer, folds inner) cycles the folds'
    training sets through the two-entry cache, which misses on every fit
    from 3 folds on. The final refit on all rows is one more miss."""
    X, y = sweep_rows()
    ds = Dataset({"features": X, "label": y})
    got = []
    for par in (8, 1):
        tapi.clear_binned_dataset_cache()
        tapi.binned_cache_stats(reset=True)
        tcore.TuneHyperparameters(
            models=[tapi.LightGBMClassifier(numIterations=1, numLeaves=4,
                                            device="cpu")],
            evaluationMetric="AUC", numFolds=folds, paramSpace=grid(tcore),
            parallelism=par).fit(ds)
        st = tapi.binned_cache_stats()
        got.append((st["hits"], st["misses"]))
    assert got == [swept, sequential]


def test_structural_space_falls_back_to_sequential_fits():
    X, y = blobs()
    space = tcore.GridSpace({"numLeaves": tcore.DiscreteHyperParam([3, 7])})
    tuned = tcore.TuneHyperparameters(
        models=[tapi.LightGBMClassifier(numIterations=3, minDataInLeaf=2,
                                        device="cpu")],
        evaluationMetric="accuracy", numFolds=2, paramSpace=space,
        parallelism=4).fit(Dataset({"features": X, "label": y}))
    assert len(tuned.get_or_default("history")) == 2
    assert tuned.get_or_default("bestMetric") > 0.9
    assert tsweep.swept_fit(
        tapi.LightGBMClassifier(device="cpu"), list(space.param_maps()),
        Dataset({"features": X, "label": y})) is None


def test_random_space_tuning_matches_jax():
    X, y = blobs()
    out = []
    for mod, api, D in ((tcore, tapi, Dataset), (jcore, japi, JDataset)):
        space = (mod.HyperparamBuilder()
                 .add_hyperparam("numLeaves", mod.DiscreteHyperParam([3, 7]))
                 .add_hyperparam("learningRate", mod.RangeHyperParam(0.05,
                                                                     0.5))
                 .build())
        kw = dict(minDataInLeaf=2, numIterations=3)
        if mod is tcore:
            kw["device"] = "cpu"
        with _one_device():
            out.append(mod.TuneHyperparameters(
                models=[api.LightGBMClassifier(**kw),
                        api.LightGBMClassifier(maxBin=15, **kw)],
                evaluationMetric="AUC", numFolds=3, numRuns=2,
                paramSpace=space, seed=4).fit(D({"features": X, "label": y})))
    ht, hj = (o.get_or_default("history") for o in out)
    assert [h[:2] for h in ht] == [h[:2] for h in hj] and len(ht) == 4
    np.testing.assert_allclose([h[2] for h in ht], [h[2] for h in hj],
                               rtol=0, atol=1e-6)


def test_trials_dealt_over_two_ranks(tmp_path, fold_train):
    """Two gloo ranks: each fits every other trial on all rows, and both
    return all eight models, byte-equal to one process's sweep."""
    X, y = fold_train
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    body = f"""
import hashlib
from mmlspark_tpu_torch.automl.core import DiscreteHyperParam, GridSpace
from mmlspark_tpu_torch.automl.sweep import swept_fit
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt import api
X = np.load({str(tmp_path / 'X.npy')!r})
y = np.load({str(tmp_path / 'y.npy')!r})
space = GridSpace({{k: DiscreteHyperParam(v) for k, v in {GRID!r}.items()}})
fits = []
real = api.train_booster
def counted(*a, **k):
    fits.append(1)
    return real(*a, **k)
import mmlspark_tpu_torch.models.gbdt.booster as B
B.train_booster = counted
models = swept_fit(api.LightGBMClassifier(device="cpu", **{EST!r}),
                   list(space.param_maps()),
                   Dataset({{"features": X, "label": y}}))
result = {{"fits": len(fits), "sha": [hashlib.sha256(
    m.booster.model_string().encode()).hexdigest() for m in models]}}
"""
    res = run_ranks(tmp_path, 2, body)
    maps = list(grid(tcore).param_maps())
    one = tsweep.swept_fit(tapi.LightGBMClassifier(device="cpu", **EST),
                           maps, Dataset({"features": X, "label": y}))
    import hashlib
    want = [hashlib.sha256(m.booster.model_string().encode()).hexdigest()
            for m in one]
    assert [r["fits"] for r in res] == [4, 4]
    assert res[0]["sha"] == res[1]["sha"] == want


@pytest.fixture(scope="module")
def best_pair():
    X, y = blobs()
    out = []
    for api, D, mod in ((tapi, Dataset, tcore), (japi, JDataset, jcore)):
        extra = {"device": "cpu"} if api is tapi else {}
        with _one_device():
            out.append(mod.FindBestModel(models=[
                api.LightGBMClassifier(numIterations=1, numLeaves=2,
                                       minDataInLeaf=2, **extra),
                api.LightGBMClassifier(numIterations=10, numLeaves=7,
                                       minDataInLeaf=2, **extra)],
                evaluationMetric="AUC").fit(D({"features": X, "label": y})))
    return X, y, out


def test_find_best_model_matches_jax(best_pair):
    _, _, (t, j) = best_pair
    assert t.get_or_default("bestMetric") == j.get_or_default("bestMetric")
    tt, tj = t.get_evaluation_results(), j.get_evaluation_results()
    assert tt.columns == tj.columns == ["model", "AUC"]
    assert list(tt["model"]) == list(tj["model"])
    np.testing.assert_allclose(tt.array("AUC"), tj.array("AUC"), rtol=0,
                               atol=1e-6)
    # the winner is the model with the highest individual AUC
    best = int(np.argmax(tt.array("AUC")))
    assert t.get_or_default("bestMetric") == tt.array("AUC")[best]
    assert t.get_or_default("bestModel").get_or_default("numIterations") \
        == (1, 10)[best]


def test_models_save_and_load_in_both_packages(tuned, best_pair, tmp_path):
    X, y, (fb_t, fb_j) = best_pair
    Xs, ys = sweep_rows()
    cases = ((tuned[("port", 8)], tuned[("jax", 8)], Xs, ys),
             (fb_t, fb_j, X, y))
    for i, (t, j, Xc, yc) in enumerate(cases):
        ds = Dataset({"features": Xc, "label": yc})
        want = t.transform(ds).array("probability")
        t.save(str(tmp_path / f"t{i}"))
        again = PipelineStage.load(str(tmp_path / f"t{i}"))
        assert type(again) is type(t)
        np.testing.assert_array_equal(again.transform(ds).array(
            "probability"), want)
        assert again.get_or_default("bestMetric") == \
            t.get_or_default("bestMetric")
        # a directory the JAX package saved loads in the port
        with _one_device():
            jwant = j.transform(JDataset({"features": Xc, "label": yc}))
            j.save(str(tmp_path / f"j{i}"))
        ported = PipelineStage.load(str(tmp_path / f"j{i}"))
        assert type(ported).__module__.startswith("mmlspark_tpu_torch.")
        ported.get_or_default("bestModel").set(device="cpu")
        np.testing.assert_allclose(
            ported.transform(ds).array("probability"),
            jwant.array("probability"), rtol=0, atol=1e-5)
        assert JStage.load(str(tmp_path / f"j{i}")) is not None
