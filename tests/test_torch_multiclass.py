"""Multiclass training and scoring: the PyTorch port against the JAX package.

Seeded numpy rows with three classes go through both packages' trainers on
the CPU (the JAX side on a one-device mesh). Each iteration grows one tree
per class on that class's grad/hess column; the structure of all 3 x
iterations trees must be identical and the ``[n, 3]`` margins agree within
1e-5. Quantized fits round stochastically on both sides under the same
draws (the port's come from ``mmlspark_tpu_torch/utils/prng.py``, the JAX
package's ``jax.random`` stream; nothing is patched), so both get the same
int8 values. Also covered: the softmax ``predict``, the classifier estimator's
multiclass ``transform`` (margins, probabilities, ``thresholds``, argmax),
``.npz`` persistence in both directions and ``booster_from_jax_arrays``.
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import booster as TB
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.ops.histogram import quant_key

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
K = 3


def _data(n, seed):
    """Three classes drawn through a softmax of a fixed seeded function."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    logits = np.stack([X[:, 0] + X[:, 1], 0.8 * X[:, 2] * X[:, 3],
                       np.abs(X[:, 4]) - 0.7], axis=1)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    y = (rng.uniform(size=(n, 1)) > np.cumsum(p, axis=1)).sum(axis=1)
    return X, y.astype(np.float32)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _assert_same_trees(jb, tb):
    assert tb.num_class == jb.num_class == K
    assert tb.num_trees == jb.num_trees
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)


def _fit_pair(X, y, **cfg):
    kw = dict(objective="multiclass", num_class=K, num_iterations=3,
              max_bin=63)
    jb = jtrain(X, y, cfg=JG.GrowConfig(**cfg), mesh=_mesh(), **kw)
    tb = ttrain(X, y, cfg=TG.GrowConfig(**cfg), device="cpu", **kw)
    return jb, tb


@pytest.fixture(scope="module")
def data():
    return _data(9000, 0)


@pytest.fixture(scope="module")
def leafwise_pair(data):
    X, y = data
    return _fit_pair(X, y, num_leaves=7, min_data_in_leaf=100)


def test_train_booster_multiclass_leafwise_matches_jax(data, leafwise_pair):
    X, _ = data
    jb, tb = leafwise_pair
    _assert_same_trees(jb, tb)
    assert tb.num_trees == 9 and tb.num_iterations == 3
    np.testing.assert_array_equal(tb.base_score, np.zeros(K, np.float32))
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def test_train_booster_multiclass_depthwise_matches_jax(data):
    X, y = data
    jb, tb = _fit_pair(X, y, num_leaves=7, min_data_in_leaf=100,
                       growth_policy="depthwise")
    _assert_same_trees(jb, tb)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def test_train_booster_multiclass_quantized_matches_jax(data):
    X, y = data
    jb, tb = _fit_pair(X[:8997], y[:8997], num_leaves=7,
                       min_data_in_leaf=100, quantized_grad=True,
                       quant_warmup_iters=1)
    _assert_same_trees(jb, tb)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def test_quantized_trees_round_under_one_key_per_class(monkeypatch):
    X, y = _data(600, 1)
    seen = []
    real = TG.grow_tree

    def spy(*a, qkey=None, **kw):
        seen.append((a[5].quantized_grad, qkey, a[1].is_contiguous()))
        return real(*a, qkey=qkey, **kw)

    monkeypatch.setattr(TB, "grow_tree", spy)
    ttrain(X, y, objective="multiclass", num_class=K, num_iterations=2,
           max_bin=15, seed=4, cfg=TG.GrowConfig(num_leaves=3,
                                                 quantized_grad=True,
                                                 quant_warmup_iters=1),
           device="cpu")
    assert seen == ([(False, None, True)] * K
                    + [(True, quant_key(4, 1, k), True) for k in range(K)])


def test_predict_is_the_softmax_of_the_margins(data, leafwise_pair):
    X, _ = data
    jb, tb = leafwise_pair
    probs = tb.predict(X, device="cpu")
    assert probs.shape == (len(X), K)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs, np.asarray(jb.predict(X)), rtol=0,
                               atol=1e-6)
    raw = tb.predict_raw(X, device="cpu")
    np.testing.assert_array_equal(probs.argmax(axis=1), raw.argmax(axis=1))


@pytest.mark.parametrize("thresholds", [None, [0.5, 1.0, 0.2]],
                         ids=["argmax", "thresholds"])
def test_classifier_multiclass_fit_transform_matches_jax(thresholds):
    X, y = _data(6000, 2)
    params = dict(numIterations=3, numLeaves=7, minDataInLeaf=100,
                  maxBin=63)
    if thresholds:
        params["thresholds"] = thresholds
    model = LightGBMClassifier(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    assert model.get_or_default("numClasses") == K
    assert model.get_actual_num_classes() == K
    out = model.transform(TDataset({"features": X}))
    probs = out.array("probability")
    assert probs.shape == out.array("rawPrediction").shape == (6000, K)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    scaled = probs / np.asarray(thresholds or [1.0] * K)[None, :]
    np.testing.assert_array_equal(out.array("prediction"),
                                  scaled.argmax(axis=1).astype(np.float64))
    if thresholds is None:
        assert float((out.array("prediction") == y).mean()) > 0.5

    with default_mesh(_mesh()):
        jmodel = JClassifier(**params).fit(JDataset({"features": X,
                                                     "label": y}))
    jout = jmodel.transform(JDataset({"features": X}))
    _assert_same_trees(jmodel.booster, model.booster)
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(out.array(col), jout.array(col), rtol=0,
                                   atol=1e-5, err_msg=col)
    np.testing.assert_array_equal(out.array("prediction"),
                                  jout.array("prediction"))


def test_multiclass_npz_round_trip_both_ways(data, leafwise_pair, tmp_path):
    X, _ = data
    jb, tb = leafwise_pair
    tb.save(str(tmp_path / "port"))
    back = Booster.load(str(tmp_path / "port"))
    assert back.num_class == K
    np.testing.assert_array_equal(back.predict_raw(X, device="cpu"),
                                  tb.predict_raw(X, device="cpu"))
    jback = JBooster.load(str(tmp_path / "port.npz"))
    assert jback.num_class == K
    np.testing.assert_allclose(jback.predict(X), tb.predict(X, device="cpu"),
                               rtol=0, atol=1e-5)
    jb.save(str(tmp_path / "jax"))
    tback = Booster.load(str(tmp_path / "jax.npz"))
    np.testing.assert_allclose(tback.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=0, atol=1e-5)


def test_booster_from_jax_arrays_carries_multiclass(data, leafwise_pair):
    X, _ = data
    jb, _ = leafwise_pair
    port = booster_from_jax_arrays(
        {k: np.asarray(v) for k, v in jb.trees._asdict().items()},
        jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, objective_kwargs=jb.objective_kwargs)
    assert (port.num_class, port.num_iterations) == (K, 3)
    np.testing.assert_allclose(port.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=0, atol=1e-5)
