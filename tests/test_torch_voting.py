"""voting_parallel (``GrowConfig.voting``, ``parallelism="voting_parallel"``)
in the PyTorch port against the JAX package.

On one shard the JAX package still runs the ballot (its ``_grow_axis_for``
keeps the collective axis under voting): only the top ``2 * top_k``
features' histograms reach the split search. At F=12 and ``top_k=3`` that
is 6 of 12 features, so the trees differ from data_parallel's; the port's
leafwise and depthwise fits equal the JAX fits on a one-device mesh
(identical trees, margins within 1e-5), and so do the estimators.
``_feature_best_gains`` and ``_voting_select`` are each held to the JAX
functions on the same histograms. A two-process voting fit (gloo on the
CPU) is held to quality only, as the JAX tests hold their sharded voting
fits (``tests/test_gbdt.py``): the ballot is shard-local by design.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import run_ranks
from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.gbdt.objectives import auc_weighted

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")


def _data(n=3000, F=12, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    z = (X[:, 0] + 0.8 * X[:, 5] * X[:, 6] - 0.6 * X[:, 9]
         + 0.3 * X[:, 11] + 0.5 * rng.normal(size=n))
    return X, (z > 0).astype(np.float32)


def _one_device():
    return make_mesh(devices=jax.devices()[:1])


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_voting_fits_match_jax(policy):
    X, y = _data()
    kw = dict(num_leaves=15, min_data_in_leaf=40, growth_policy=policy)
    common = dict(objective="binary", num_iterations=4, max_bin=63, seed=0)
    jb = jtrain(X, y, cfg=JG.GrowConfig(voting=True, top_k=3, **kw),
                mesh=_one_device(), **common)
    tb = ttrain(X, y, cfg=TG.GrowConfig(voting=True, top_k=3, **kw),
                device="cpu", **common)
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    plain = ttrain(X, y, cfg=TG.GrowConfig(**kw), device="cpu", **common)
    assert not np.array_equal(plain.trees["feat"], tb.trees["feat"])
    assert len(np.unique(tb.trees["feat"][~tb.trees["is_leaf"]])) <= 12


def test_voting_estimator_matches_jax():
    X, y = _data(seed=12)
    params = dict(numIterations=3, numLeaves=7, minDataInLeaf=40, maxBin=63,
                  parallelism="voting_parallel", topK=3)
    with default_mesh(_one_device()):
        jm = JClassifier(**params).fit(JDataset({"features": X, "label": y}))
    tm = LightGBMClassifier(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    for f in STRUCTURE:
        np.testing.assert_array_equal(tm.booster.trees[f],
                                      np.asarray(getattr(jm.booster.trees,
                                                         f)), err_msg=f)
    np.testing.assert_allclose(tm.booster.predict_raw(X, device="cpu"),
                               jm.booster.predict_raw(X), rtol=0, atol=1e-5)


def _hists(seed, W, F=12, B=31):
    """Dyadic grad/hess so cumsums are exact on both sides."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-64, 64, size=(W, F, B)) / 16.0
    h = rng.integers(0, 32, size=(W, F, B)) / 16.0
    c = rng.integers(0, 40, size=(W, F, B)).astype(np.float64)
    return np.stack([g, h, c], axis=2).astype(np.float32)      # [W,F,3,B]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_best_gains_match_jax(seed):
    hw = _hists(seed, 3)
    fm = np.ones(12, bool)
    fm[4] = False
    cfg_t = TG.GrowConfig(min_data_in_leaf=20, lambda_l2=0.5)
    cfg_j = JG.GrowConfig(min_data_in_leaf=20, lambda_l2=0.5)
    got = TG._feature_best_gains(torch.from_numpy(hw), torch.from_numpy(fm),
                                 cfg_t).numpy()
    for w in range(3):
        want = np.asarray(JG._feature_best_gains(jnp.asarray(hw[w]),
                                                 jnp.asarray(fm), cfg_j))
        np.testing.assert_array_equal(got[w], want)


@pytest.mark.parametrize("W,top_k", [(1, 3), (4, 3), (2, 8)])
def test_voting_select_matches_jax(W, top_k):
    hw = _hists(W + top_k, W)
    F, B = hw.shape[1], hw.shape[3]
    h = np.ascontiguousarray(hw.transpose(1, 0, 2, 3).reshape(F, 3 * W, B))
    fm = np.ones(F, bool)
    cfg_t = TG.GrowConfig(min_data_in_leaf=20, top_k=top_k, voting=True)
    cfg_j = JG.GrowConfig(min_data_in_leaf=20, top_k=top_k, voting=True)
    jh, jsel = jax.vmap(
        lambda hh: JG._voting_select(hh, jnp.asarray(fm), cfg_j, "data", W),
        axis_name="data")(jnp.asarray(h)[None])

    class One:
        size = 1

        def all_reduce(self, t, op="sum"):
            return t

    th, tsel = TG._voting_select(torch.from_numpy(h), torch.from_numpy(fm),
                                 cfg_t, One(), W)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel[0]))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh[0]))
    assert int(tsel.sum()) == min(2 * top_k, F)


def test_voting_ties_go_to_the_lower_feature(monkeypatch):
    """Features with equal votes are taken in index order: with one vote
    (``top_k=1``, feature 4), the other of the ``2 * top_k`` is feature 0."""
    gains = torch.tensor([[1.0, 2.0, 3.0, 2.5, 9.0, 3.0]])
    monkeypatch.setattr(TG, "_feature_best_gains", lambda *a: gains)
    h = torch.ones((6, 3, 4))
    _, sel = TG._voting_select(h, torch.ones(6, dtype=torch.bool),
                               TG.GrowConfig(top_k=1, voting=True), None, 1)
    assert sel.tolist() == [True, False, False, False, True, False]


def test_two_process_voting_fit_keeps_quality(tmp_path):
    body = """
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
rng = np.random.default_rng(11)
n, F = 3000, 12
X = rng.normal(size=(n, F)).astype(np.float32)
z = (X[:, 0] + 0.8 * X[:, 5] * X[:, 6] - 0.6 * X[:, 9] + 0.3 * X[:, 11]
     + 0.5 * rng.normal(size=n))
y = (z > 0).astype(np.float32)
b = train_booster(X, y, objective="binary", num_iterations=10,
                  cfg=GrowConfig(num_leaves=15, min_data_in_leaf=40,
                                 voting=True, top_k=3),
                  max_bin=63, seed=0, device="cpu")
result = {"model": b.model_string(),
          "pred": b.predict(X, device="cpu").tolist()}
"""
    ranks = run_ranks(tmp_path, 2, body)
    assert ranks[0]["model"] == ranks[1]["model"]
    X, y = _data()
    one = ttrain(X, y, objective="binary", num_iterations=10,
                 cfg=TG.GrowConfig(num_leaves=15, min_data_in_leaf=40,
                                   voting=True, top_k=3),
                 max_bin=63, seed=0, device="cpu")
    a2 = auc_weighted(np.asarray(ranks[0]["pred"]), y, None)
    a1 = auc_weighted(one.predict(X, device="cpu"), y, None)
    assert min(a1, a2) > 0.85 and abs(a1 - a2) < 0.02, (a1, a2)
