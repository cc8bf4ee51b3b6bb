"""The GBDT slice end to end: the PyTorch port against the JAX package.

Seeded numpy data go through the JAX package's ``train_booster`` on a
one-device mesh (so its ``_grow_axis_for`` returns None and growth takes
the same histogram-subtraction path as the port) and through the port's
``train_booster`` on the CPU. The split structure must be identical and
raw predictions agree within 1e-5. The configurations keep leaves at 100+
rows: the f32 parent-minus-left totals differ between the two packages by
about an ulp of the root total (see tests/test_torch_growth.py), which a
leaf of a few dozen rows would carry into its value at the 1e-5 level.
Also covered: the estimator's fit/transform on a ``Dataset``, ``.npz``
persistence in both directions, and carrying a JAX-trained booster over
with ``booster_from_jax_arrays``.
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassificationModel,
                                                LightGBMClassifier,
                                                LightGBMRegressor)
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig as TGrowConfig

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")


def _data(n, seed=0, F=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.02] = np.nan
    score = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) ** 2
             - 0.7 * np.nan_to_num(X[:, 2]) * np.nan_to_num(X[:, 3]))
    y_bin = (score + 0.3 * rng.normal(size=n) > 0.5).astype(np.float32)
    y_reg = (score + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y_bin, y_reg


def _one_device_mesh():
    return make_mesh(devices=jax.devices()[:1])


def _assert_same_structure(jb, tb):
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def binary_pair():
    """Binary, 5 rounds, 12000 rows: histogram subtraction on."""
    X, y, _ = _data(12000)
    kw = dict(num_leaves=7, min_data_in_leaf=200)
    jb = jtrain(X, y, objective="binary", num_iterations=5, max_bin=63,
                cfg=JGrowConfig(**kw), mesh=_one_device_mesh())
    tb = ttrain(X, y, objective="binary", num_iterations=5, max_bin=63,
                cfg=TGrowConfig(**kw), device="cpu")
    return X, jb, tb


def test_train_booster_binary_matches_jax(binary_pair):
    X, jb, tb = binary_pair
    assert tb.num_trees == jb.num_trees == 5
    _assert_same_structure(jb, tb)
    np.testing.assert_allclose(tb.base_score, jb.base_score, rtol=1e-6)
    np.testing.assert_allclose(tb.thr_raw, jb.thr_raw, rtol=0, atol=0)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, device="cpu"), jb.predict(X),
                               rtol=0, atol=1e-5)


def test_train_booster_regression_matches_jax():
    X, _, y = _data(3000, seed=1)
    kw = dict(num_leaves=7, min_data_in_leaf=100)
    jb = jtrain(X, y, objective="regression", num_iterations=3, max_bin=63,
                cfg=JGrowConfig(**kw), mesh=_one_device_mesh())
    tb = ttrain(X, y, objective="regression", num_iterations=3, max_bin=63,
                cfg=TGrowConfig(**kw), device="cpu", bin_dtype="uint8")
    _assert_same_structure(jb, tb)
    np.testing.assert_allclose(tb.predict(X, device="cpu"), jb.predict(X),
                               rtol=0, atol=1e-5)


def test_classifier_fit_transform_matches_jax():
    X, y, _ = _data(3000, seed=2)
    params = dict(numIterations=4, numLeaves=7, minDataInLeaf=100,
                  maxBin=63)
    model = LightGBMClassifier(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    assert isinstance(model, LightGBMClassificationModel)
    out = model.transform(TDataset({"features": X, "label": y}))
    probs = out.array("probability")
    assert probs.shape == (3000, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(out.array("prediction"),
                                  probs.argmax(axis=1).astype(np.float64))
    acc = float((out.array("prediction") == y).mean())
    assert acc > 0.8, acc

    with default_mesh(_one_device_mesh()):
        jmodel = JClassifier(**params).fit(
            JDataset({"features": X, "label": y}))
    jout = jmodel.transform(JDataset({"features": X, "label": y}))
    _assert_same_structure(jmodel.booster, model.booster)
    np.testing.assert_allclose(out.array("rawPrediction"),
                               jout.array("rawPrediction"), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(probs, jout.array("probability"), rtol=0,
                               atol=1e-5)


def test_regressor_fit_transform():
    X, _, y = _data(2000, seed=3)
    model = LightGBMRegressor(device="cpu", numIterations=3,
                              numLeaves=7).fit(
        TDataset({"features": X, "label": y}))
    pred = model.transform(TDataset({"features": X})).array("prediction")
    assert pred.shape == (2000,) and np.isfinite(pred).all()
    assert np.mean((pred - y) ** 2) < np.var(y)


def test_booster_npz_round_trip_and_jax_interop(binary_pair, tmp_path):
    X, jb, tb = binary_pair
    tb.save(str(tmp_path / "port"))
    back = Booster.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.predict_raw(X, device="cpu"),
                                  tb.predict_raw(X, device="cpu"))
    # the JAX package loads the port's file and predicts the same
    jback = JBooster.load(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(jback.predict_raw(X),
                               tb.predict_raw(X, device="cpu"), rtol=0,
                               atol=1e-5)
    # and the port loads the JAX package's file
    jb.save(str(tmp_path / "jax"))
    tback = Booster.load(str(tmp_path / "jax.npz"))
    np.testing.assert_allclose(tback.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def test_booster_from_jax_arrays_predicts_identically(binary_pair):
    X, jb, _ = binary_pair
    fields = {k: np.asarray(v) for k, v in jb.trees._asdict().items()}
    port = booster_from_jax_arrays(
        fields, jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state)
    assert port.num_trees == jb.num_trees
    np.testing.assert_allclose(port.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.predict(X, device="cpu"), jb.predict(X),
                               rtol=0, atol=1e-5)
    # the default depth cap (num_leaves - 1) routes every row the same
    port2 = booster_from_jax_arrays(fields, jb.thr_raw, jb.num_class,
                                    jb.base_score, jb.objective)
    np.testing.assert_array_equal(port2.predict_raw(X, device="cpu"),
                                  port.predict_raw(X, device="cpu"))


def test_booster_from_jax_arrays_refuses_categorical(binary_pair):
    """Categorical bitsets route only the features the binner state names
    categorical: bitsets with no such feature are refused, as are bitsets
    that do not match the trees' shape."""
    _, jb, _ = binary_pair
    fields = {k: np.asarray(v) for k, v in jb.trees._asdict().items()}
    fields["cat_bitset"] = np.ones_like(fields["cat_bitset"])
    with pytest.raises(ValueError, match="categorical_features"):
        booster_from_jax_arrays(fields, jb.thr_raw, 1, jb.base_score,
                                jb.objective)
    with pytest.raises(ValueError, match="categorical_features"):
        booster_from_jax_arrays(fields, jb.thr_raw, 1, jb.base_score,
                                jb.objective, binner_state=jb.binner_state)
    fields["cat_bitset"] = fields["cat_bitset"][:, :3]
    with pytest.raises(ValueError, match="does not match"):
        booster_from_jax_arrays(fields, jb.thr_raw, 1, jb.base_score,
                                jb.objective, binner_state=dict(
                                    jb.binner_state, categorical_features=[0]))
