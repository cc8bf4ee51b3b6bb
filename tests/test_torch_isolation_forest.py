"""The port's IsolationForest (``models/isolation_forest.py``) against the
JAX package's.

* Trees bit-equal: both build them on the host from the same
  ``default_rng`` draws (defaults; bootstrap with feature and sample
  fractions; a constant column).
* Scores within 1e-6 absolute (the f32 ``log`` of the extra path length
  is the one op whose rounding may differ; the mean over trees is the same
  numpy call on the same ``[T, n]`` array); with ``contamination`` the
  thresholds within 1e-6 and the labels equal.
* A model directory saved by the JAX package (``forest.npz``) loads in the
  port and scores equal, and ``isolation_forest_from_jax`` builds an equal
  model from the JAX model's arrays.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models import isolation_forest as jif
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models import isolation_forest as tif

torch.set_num_threads(1)

SCORE_ATOL = 1e-6
CASES = {
    "defaults": {},
    "bootstrap_fractions": dict(bootstrap=True, maxFeatures=0.6,
                                maxSamples=0.3, numEstimators=30,
                                contamination=0.05, randomSeed=7),
    "few_features_contamination": dict(maxFeatures=2.0, maxSamples=64.0,
                                       numEstimators=25, contamination=0.1),
}


def _rows(n=600, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:12] += 6.0                  # planted outliers
    X[:, 3] = 1.5                  # a constant column: leaves give up on it
    return X


def _fit_both(X, **kw):
    jm = jif.IsolationForest(**kw).fit(JDataset({"features": X}))
    tm = tif.IsolationForest(device="cpu", **kw).fit(
        Dataset({"features": X}))
    return jm, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_trees_bit_equal_and_scores_within_1e6(name):
    X = _rows()
    jm, tm = _fit_both(X, **CASES[name])
    for a in ("feat", "thr", "is_leaf", "leaf_size"):
        assert getattr(tm, a).dtype == getattr(jm, a).dtype, a
        np.testing.assert_array_equal(getattr(tm, a), getattr(jm, a))
    assert (tm.depth_cap, tm.sample_n) == (jm.depth_cap, jm.sample_n)
    Xq = _rows(n=300, seed=1)
    js = jm.transform(JDataset({"features": Xq}))
    ts = tm.transform(Dataset({"features": Xq}))
    np.testing.assert_allclose(ts.array("outlierScore"),
                               js.array("outlierScore"), rtol=0,
                               atol=SCORE_ATOL)
    th = jm.get_or_default("threshold")
    if th is None:
        assert tm.get_or_default("threshold") is None
        assert "prediction" not in ts
    else:
        assert abs(tm.get_or_default("threshold") - th) <= SCORE_ATOL
        np.testing.assert_array_equal(ts.array("prediction"),
                                      js.array("prediction"))
    # the planted outliers score highest
    s = ts.array("outlierScore")
    assert s[:12].mean() > s[12:].mean() + 0.1


def test_path_lengths_chunked_equal_whole(monkeypatch):
    X = _rows(n=500)
    _, tm = _fit_both(X, numEstimators=10)
    whole = tm.transform(Dataset({"features": X})).array("outlierScore")
    monkeypatch.setattr(tif, "SCORE_ROWS", 64)
    chunked = tm.transform(Dataset({"features": X})).array("outlierScore")
    np.testing.assert_array_equal(chunked, whole)


def test_jax_saved_model_loads_and_scores_equal(tmp_path):
    X = _rows()
    jm, _ = _fit_both(X, **CASES["bootstrap_fractions"])
    jm.save(str(tmp_path / "if"))
    tm = PipelineStage.load(str(tmp_path / "if"))
    assert type(tm) is tif.IsolationForestModel
    tm.set(device="cpu")
    want = jm.transform(JDataset({"features": X}))
    got = tm.transform(Dataset({"features": X}))
    np.testing.assert_allclose(got.array("outlierScore"),
                               want.array("outlierScore"), rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(got.array("prediction"),
                                  want.array("prediction"))
    # and the port's own save round-trips in the same format
    tm.save(str(tmp_path / "again"))
    back = PipelineStage.load(str(tmp_path / "again"))
    np.testing.assert_array_equal(back.thr, jm.thr)


def test_isolation_forest_from_jax_scores_equal():
    X = _rows()
    jm, _ = _fit_both(X, **CASES["few_features_contamination"])
    tm = tif.isolation_forest_from_jax(
        jm.feat, jm.thr, jm.is_leaf, jm.leaf_size, jm.depth_cap, jm.sample_n,
        jm.extract_param_map(), device="cpu")
    assert tm.get_or_default("threshold") == jm.get_or_default("threshold")
    np.testing.assert_allclose(
        tm.transform(Dataset({"features": X})).array("outlierScore"),
        jm.transform(JDataset({"features": X})).array("outlierScore"),
        rtol=0, atol=SCORE_ATOL)
