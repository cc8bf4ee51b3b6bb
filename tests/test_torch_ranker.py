"""LambdaRank training and the ranker estimator: the PyTorch port against
the JAX package.

Seeded query groups (sizes 6-40, relevance 0-4 drawn from a noisy function
of the features) go through both packages on the CPU. ``train_booster``
takes the JAX package's layout on both sides: groups padded to a fixed
width with ``_pad_groups``, the padding rows masked out of training through
``row_valid`` and carrying validation weight 0. The port's ranker fits the
groups ragged, every row kept, against the JAX ranker's padded fit: its
features lie on a grid of quarters, 0 among them, so the binner's bounds
(which in the JAX package also see the zero padding rows) are the same.
The JAX side runs on a one-device mesh (its estimator would otherwise pad
the group count to the 8 virtual CPU devices of the test run). Trees must
be identical and margins agree within 1e-5, with and without a validation
set and early stopping on NDCG. Also covered: ``.npz`` persistence of a
ranker (its ``label_gain`` tuple through the JSON meta, both directions)
and ``booster_from_jax_arrays``.
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import api as JA
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import api as TA
from mmlspark_tpu_torch.models.gbdt.booster import (Booster,
                                                    LightGBMDataset)
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig as TGrowConfig

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
S = 64
GAIN = (0.0, 1.0, 3.0, 7.0, 15.0)


def _queries(G, seed, min_size=6, max_size=40):
    """Rows of G query groups in shuffled order: (X, relevance, group)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(min_size, max_size + 1, size=G)
    group = np.repeat(np.arange(G) * 7 + 3, sizes)
    X = rng.normal(size=(len(group), 5)).astype(np.float32)
    rel = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.8 * rng.normal(size=len(group))
    y = np.digitize(rel, [-0.5, 0.3, 1.0, 1.8]).astype(np.float32)
    perm = rng.permutation(len(group))
    return X[perm], y[perm], group[perm]


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _assert_same_trees(jb, tb):
    assert tb.num_trees == jb.num_trees
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def queries():
    return _queries(180, 0), _queries(60, 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_pad_groups_matches_jax(weighted):
    X, y, g = _queries(30, 2, max_size=20)
    w = (np.random.default_rng(3).uniform(0.5, 1.5, size=len(y)).astype(
        np.float32) if weighted else None)
    got = TA._pad_groups(X, y, w, g, 16)             # sizes past 16 truncate
    want = JA._pad_groups(X, y, w, g, 16, 1)
    assert got[4] == want[4] == 30
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[3].sum() == np.minimum(np.unique(g, return_counts=True)[1],
                                      16).sum()


def test_dataset_row_valid_masks_rows_but_bins_them():
    X, y, g = _queries(10, 4)
    Xp, yp, wp, valid, _ = TA._pad_groups(X, y, None, g, S)
    ds = LightGBMDataset.construct(Xp, yp, wp, max_bin=31, row_valid=valid,
                                   device="cpu")
    np.testing.assert_array_equal(ds.vmask.numpy(), valid)
    np.testing.assert_array_equal(ds.w.numpy(), wp)
    assert ds.n == ds.n_pad == len(yp)
    # the binner was fit on every row, padding included
    plain = LightGBMDataset.construct(Xp, yp, max_bin=31, device="cpu")
    np.testing.assert_array_equal(ds.Xbt.numpy(), plain.Xbt.numpy())
    with pytest.raises(ValueError, match="row_valid"):
        ttrain(dataset=ds, row_valid=valid, objective="lambdarank",
               objective_kwargs=dict(group_size=S))


@pytest.mark.parametrize("validation", [False, True],
                         ids=["train-only", "early-stopping"])
def test_train_booster_lambdarank_matches_jax(queries, validation):
    (X, y, g), (Xv, yv, gv) = queries
    Xp, yp, wp, valid, _ = TA._pad_groups(X, y, None, g, S)
    kw = dict(objective="lambdarank", num_iterations=4, max_bin=63,
              boost_from_average=False, row_valid=valid,
              objective_kwargs=dict(group_size=S, max_position=10,
                                    eval_at=5, label_gain=GAIN))
    if validation:
        Xvp, yvp, _, vv, _ = TA._pad_groups(Xv, yv, None, gv, S)
        gsz = vv.reshape(-1, S).sum(axis=1)
        wv = (vv.reshape(-1, S) / gsz[:, None]).reshape(-1)
        kw.update(valid_set=(Xvp, yvp, wv), early_stopping_rounds=1,
                  provide_training_metric=True)
    cfg = dict(num_leaves=7, min_data_in_leaf=100, learning_rate=0.3)
    jb = jtrain(Xp, yp, wp, cfg=JGrowConfig(**cfg), mesh=_mesh(), **kw)
    tb = ttrain(Xp, yp, wp, cfg=TGrowConfig(**cfg), device="cpu", **kw)
    _assert_same_trees(jb, tb)
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_array_equal(tb.base_score, [0.0])
    np.testing.assert_allclose(tb.predict_raw(Xp, device="cpu"),
                               jb.predict_raw(Xp), rtol=0, atol=1e-5)
    assert sorted(tb.eval_history) == sorted(jb.eval_history)
    for key, want in jb.eval_history.items():
        np.testing.assert_allclose(tb.eval_history[key], want, rtol=1e-6,
                                   err_msg=key)
    if validation:
        assert len(tb.eval_history["ndcg"]) >= 2
        assert 0.3 < tb.eval_history["ndcg"][0] < 1.0


def _estimator_cols(queries):
    """The estimators' columns: features on a grid of quarters (at most 62
    distinct values, 0 among them, so padding adds no bin bound)."""
    (X, y, g), (Xv, yv, gv) = queries
    return {"features": np.round(np.concatenate([X, Xv]) * 4) / 4,
            "label": np.concatenate([y, yv]),
            "query": np.concatenate([g, gv + 1]),
            "isVal": np.r_[np.zeros(len(y), bool), np.ones(len(yv), bool)]}


@pytest.fixture(scope="module")
def ranker_pair(queries):
    cols = _estimator_cols(queries)
    params = dict(groupCol="query", validationIndicatorCol="isVal",
                  numIterations=5, numLeaves=7, minDataInLeaf=100,
                  learningRate=0.3, maxBin=63, maxGroupSize=S,
                  earlyStoppingRound=2, evalAt=[3, 5], labelGain=list(GAIN))
    model = TA.LightGBMRanker(device="cpu", **params).fit(TDataset(cols))
    with default_mesh(_mesh()):
        jmodel = JA.LightGBMRanker(**params).fit(JDataset(cols))
    return cols, model, jmodel


def test_ranker_fit_transform_matches_jax(ranker_pair):
    cols, model, jmodel = ranker_pair
    tb, jb = model.booster, jmodel.booster
    _assert_same_trees(jb, tb)
    assert tb.best_iteration == jb.best_iteration >= 0
    # the ragged fit has no padded width
    assert tb.objective_kwargs == {k: v for k, v in jb.objective_kwargs.items()
                                   if k != "group_size"}
    assert tb.objective_kwargs["label_gain"] == GAIN
    for key, want in jb.eval_history.items():
        np.testing.assert_allclose(tb.eval_history[key], want, rtol=1e-6,
                                   err_msg=key)
    ds = TDataset({"features": cols["features"]})
    pred = model.transform(ds).array("prediction")
    assert pred.shape == (len(cols["label"]),) and pred.dtype == np.float64
    np.testing.assert_allclose(
        pred, jmodel.transform(JDataset({"features": cols["features"]}))
        .array("prediction"), rtol=0, atol=1e-5)


def test_ranker_params_and_defaults_match_jax():
    mine = {p.name: p.default for p in TA.LightGBMRanker.params()}
    theirs = {p.name: p.default for p in JA.LightGBMRanker.params()}
    assert {k: v for k, v in mine.items() if k != "device"} == theirs


def test_ranker_refuses_missing_group_col_and_short_gain(queries):
    cols = _estimator_cols(queries)
    with pytest.raises(ValueError, match="groupCol"):
        TA.LightGBMRanker(device="cpu").fit(TDataset(cols))
    with pytest.raises(ValueError, match="labelGain"):
        TA.LightGBMRanker(device="cpu", groupCol="query",
                          labelGain=[0.0, 1.0]).fit(TDataset(cols))


def test_ranker_npz_round_trip_both_ways(ranker_pair, tmp_path):
    cols, model, jmodel = ranker_pair
    X = cols["features"]
    tb, jb = model.booster, jmodel.booster
    tb.save(str(tmp_path / "port"))
    back = Booster.load(str(tmp_path / "port"))
    assert back.objective_kwargs == tb.objective_kwargs
    np.testing.assert_array_equal(back.predict(X, device="cpu"),
                                  tb.predict(X, device="cpu"))
    jback = JBooster.load(str(tmp_path / "port.npz"))
    assert tuple(jback.objective_kwargs["label_gain"]) == GAIN
    np.testing.assert_allclose(jback.predict(X), tb.predict(X, device="cpu"),
                               rtol=0, atol=1e-5)
    jb.save(str(tmp_path / "jax"))
    tback = Booster.load(str(tmp_path / "jax.npz"))
    assert tback.objective_kwargs == jb.objective_kwargs
    np.testing.assert_allclose(tback.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=0, atol=1e-5)
    # the saved estimator model loads and scores the same
    model.save(str(tmp_path / "model"))
    loaded = TA.LightGBMRankerModel.load(str(tmp_path / "model"))
    np.testing.assert_array_equal(
        loaded.transform(TDataset({"features": X})).array("prediction"),
        model.transform(TDataset({"features": X})).array("prediction"))


@pytest.mark.parametrize("with_kwargs", [True, False],
                         ids=["training-kwargs", "scoring-only"])
def test_booster_from_jax_arrays_carries_a_ranker(ranker_pair, with_kwargs):
    cols, _, jmodel = ranker_pair
    jb = jmodel.booster
    port = booster_from_jax_arrays(
        {k: np.asarray(v) for k, v in jb.trees._asdict().items()},
        jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap,
        objective_kwargs=jb.objective_kwargs if with_kwargs else None)
    assert port.objective == "lambdarank"
    np.testing.assert_allclose(port.predict(cols["features"], device="cpu"),
                               np.asarray(jb.predict(cols["features"])),
                               rtol=0, atol=1e-5)
