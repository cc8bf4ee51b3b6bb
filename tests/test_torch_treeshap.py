"""TreeSHAP and saabas contributions: the port against the JAX package.

Boosters trained by the JAX package on a one-device mesh are carried over
with ``booster_from_jax_arrays``. Held here:

  * the port's numpy TreeSHAP engine equals the JAX package's numpy engine
    within 1e-10 (``MMLSPARK_TPU_SHAP_NATIVE=0`` on both sides), and the
    port's C++ engine equals its numpy engine within 1e-10;
  * the device engine (torch, run on the CPU; f64 by default, f32 as the
    JAX package's) equals the JAX package's device engine within 1e-4 and,
    in f64, the host engine within 1e-10; its rows do not depend on the
    row block;
  * saabas equals the JAX package's;
  * a brute-force Shapley computation on small trees, the sum property,
    multiclass, NaN and categorical inputs, the zero-cover and split-feature
    checks, and ``featuresShapCol`` through the estimators of both packages;
  * the host build of the C++ engine raises without a compiler and on a
    failed build.
"""

import itertools
import math
import os

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.api import LightGBMRegressor as JRegressor
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.models.gbdt.treeshap import shap_values as jshap
from mmlspark_tpu.models.gbdt.treeshap_device import \
    shap_values_device as jshap_device
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassifier,
                                                LightGBMRegressor,
                                                _LightGBMParams)
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.models.gbdt.treeshap import shap_values
from mmlspark_tpu_torch.models.gbdt.treeshap_device import shap_values_device
from mmlspark_tpu_torch.ops import _build

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "resources", "lgbm_golden")


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _port(jb) -> Booster:
    fields = {f: np.asarray(getattr(jb.trees, f)) for f in jb.trees._fields}
    return booster_from_jax_arrays(
        fields, jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state,
        objective_kwargs=jb.objective_kwargs)


def _awkward(n=600, F=8, seed=5):
    """Rows with NaNs and a categorical column of 6 ids (column 2)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.03] = np.nan
    X[:, 2] = rng.integers(0, 6, size=n)
    y2 = ((X[:, 2] % 2 == 0) ^ (np.nan_to_num(X[:, 0]) > 0)).astype(
        np.float32)
    y3 = ((np.nan_to_num(X[:, 0]) > 0.5).astype(int)
          + (np.nan_to_num(X[:, 1]) > 0)).astype(np.float32)
    return X, y2, y3


@pytest.fixture(scope="module")
def models():
    X, y2, y3 = _awkward()
    cfg = JGrowConfig(num_leaves=15, min_data_in_leaf=5)
    out = {}
    for name, y, kw in (("binary", y2, {}), ("multiclass", y3,
                                             dict(num_class=3))):
        obj = "binary" if name == "binary" else "multiclass"
        for cat in (False, True):
            jb = jtrain(X, y, objective=obj, num_iterations=6, cfg=cfg,
                        max_bin=31, mesh=_mesh(),
                        categorical_features=(2,) if cat else (), **kw)
            out[(name, cat)] = (jb, _port(jb))
    return X, out


CASES = [("binary", False), ("binary", True), ("multiclass", False),
         ("multiclass", True)]


@pytest.mark.parametrize("case", CASES)
def test_numpy_engine_matches_jax(models, case, monkeypatch):
    X, out = models
    jb, tb = out[case]
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_NATIVE", "0")
    np.testing.assert_allclose(shap_values(tb, X[:120]),
                               jshap(jb, X[:120]), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_native_engine_matches_numpy_engine(models, case, monkeypatch):
    X, out = models
    _, tb = out[case]
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_NATIVE", "0")
    phi_np = shap_values(tb, X[:120])
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_NATIVE", "1")
    phi_nat = shap_values(tb, X[:120])
    np.testing.assert_allclose(phi_nat, phi_np, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_device_engine_matches_jax_device_engine(models, case):
    X, out = models
    jb, tb = out[case]
    want = jshap_device(jb, X[:300], row_block=128)
    got = shap_values_device(tb, X[:300], device="cpu", row_block=97)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and the exact host values, to f64 rounding
    host = shap_values(tb, X[:300])
    assert np.abs(got - host).max() < 1e-10


def test_device_rows_do_not_depend_on_the_block(models):
    X, out = models
    _, tb = out[("multiclass", True)]
    whole = shap_values_device(tb, X[:150], device="cpu")
    for block in (1, 37, 64):
        np.testing.assert_array_equal(
            shap_values_device(tb, X[:150], device="cpu", row_block=block),
            whole)
    np.testing.assert_array_equal(
        shap_values_device(tb, X[100:140], device="cpu"), whole[100:140])


@pytest.mark.parametrize("case", CASES)
def test_saabas_matches_jax(models, case):
    X, out = models
    jb, tb = out[case]
    got = tb.predict_contrib(X, method="saabas", device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jb.predict_contrib(X, method="saabas"),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["treeshap", "saabas"])
@pytest.mark.parametrize("case", CASES)
def test_contributions_sum_to_the_margin(models, case, method):
    X, out = models
    _, tb = out[case]
    F, K = X.shape[1], tb.num_class
    c = tb.predict_contrib(X[:200], method=method, device="cpu")
    assert c.shape == (200, (F + 1) * K)
    raw = tb.predict_raw(X[:200], device="cpu")
    for k in range(K):
        np.testing.assert_allclose(c[:, k * (F + 1):(k + 1) * (F + 1)].sum(1),
                                   raw[:, k], rtol=0, atol=1e-5)


def _cond_expectation(tb, t, x, S):
    """v(S): descend; split features in S follow x, the others average
    both children by training cover."""
    tr = tb.trees

    def rec(j):
        if tr["is_leaf"][t, j]:
            return float(tr["leaf_value"][t, j])
        f = int(tr["feat"][t, j])
        lo, hi = int(tr["left"][t, j]), int(tr["right"][t, j])
        if f in S:
            return rec(lo if not (x[f] > tb.thr_raw[t, j]) else hi)
        cl, cr = float(tr["node_cnt"][t, lo]), float(tr["node_cnt"][t, hi])
        return (cl * rec(lo) + cr * rec(hi)) / max(cl + cr, 1e-12)
    return rec(0)


def test_matches_bruteforce_shapley():
    rng = np.random.default_rng(0)
    n, F = 400, 5
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] - 0.5 * X[:, 3]
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    jb = jtrain(X, y, objective="regression", num_iterations=3, max_bin=31,
                cfg=JGrowConfig(num_leaves=8, max_depth=3), mesh=_mesh())
    tb = _port(jb)
    expected = np.zeros((10, F))
    for t in range(tb.num_trees):
        tr = tb.trees
        used = sorted({int(tr["feat"][t, j]) for j in range(tr["feat"].shape[1])
                       if not tr["is_leaf"][t, j] and tr["node_cnt"][t, j] > 0})
        u = len(used)
        for i in range(10):
            for fi in used:
                others = [g for g in used if g != fi]
                for r in range(len(others) + 1):
                    for S in itertools.combinations(others, r):
                        wgt = (math.factorial(r) * math.factorial(u - r - 1)
                               / math.factorial(u))
                        expected[i, fi] += wgt * (
                            _cond_expectation(tb, t, X[i], set(S) | {fi})
                            - _cond_expectation(tb, t, X[i], set(S)))
    host = tb.predict_contrib(X[:10], device="cpu")
    dev = shap_values_device(tb, X[:10], device="cpu")
    assert np.abs(host[:, :F] - expected).max() < 1e-9
    assert np.abs(dev[:, :F] - expected).max() < 1e-5


def test_deep_chain_goes_to_both_engines_alike(monkeypatch):
    # a chain ~num_leaves deep: the native engine takes it, and the numpy
    # engine's explicit stack needs no recursion
    n = 2000
    X = np.arange(n, dtype=np.float32)[:, None]
    y = (np.arange(n) % 5).astype(np.float32)
    jb = jtrain(X, y, objective="regression", num_iterations=1, max_bin=255,
                cfg=JGrowConfig(num_leaves=48, min_data_in_leaf=2,
                                leaf_batch=1), mesh=_mesh())
    tb = _port(jb)
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_NATIVE", "0")
    phi_np = shap_values(tb, X[:32])
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_NATIVE", "1")
    np.testing.assert_allclose(shap_values(tb, X[:32]), phi_np, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(phi_np.sum(1), tb.predict_raw(
        X[:32], device="cpu")[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        shap_values_device(tb, X[:32], device="cpu"), phi_np, rtol=0,
        atol=1e-4)


def test_engine_routing_by_device_and_env(models, monkeypatch):
    X, out = models
    _, tb = out[("binary", True)]
    monkeypatch.delenv("MMLSPARK_TPU_SHAP_HOST", raising=False)
    monkeypatch.delenv("MMLSPARK_TPU_SHAP_DEVICE", raising=False)
    host = shap_values(tb, X[:50])
    np.testing.assert_array_equal(tb.predict_contrib(X[:50], device="cpu"),
                                  host)
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_DEVICE", "1")
    np.testing.assert_array_equal(
        tb.predict_contrib(X[:50], device="cpu"),
        shap_values_device(tb, X[:50], device="cpu"))
    # cuda (the default) without a GPU raises rather than moving
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tb.predict_contrib(X[:5])


def test_zero_cover_raises_on_both_engines(models):
    X, out = models
    _, tb = out[("binary", False)]
    trees = dict(tb.trees, node_cnt=np.zeros_like(tb.trees["node_cnt"]))
    b = Booster(trees, tb.thr_raw, 1, tb.base_score, tb.objective,
                tb.depth_cap, tb.binner_state)
    with pytest.raises(ValueError, match="saabas"):
        b.predict_contrib(X[:5], device="cpu")
    with pytest.raises(ValueError, match="saabas"):
        shap_values_device(b, X[:5], device="cpu")
    # saabas needs no covers
    assert np.isfinite(b.predict_contrib(X[:5], method="saabas",
                                         device="cpu")).all()


def test_out_of_range_split_feature_raises():
    with open(os.path.join(GOLDEN, "binary", "model.txt")) as f:
        b = Booster.from_lightgbm_string(f.read())
    feat = b.trees["feat"]
    X = np.zeros((3, int(feat.max()) + 1), dtype=np.float32)
    j = int(np.argwhere(~b.trees["is_leaf"][0])[0][0])
    for bad_val in (-1, X.shape[1]):
        bad = feat.copy()
        bad[0, j] = bad_val
        b.trees["feat"] = bad
        with pytest.raises(ValueError, match="split feature"):
            b.predict_contrib(X, method="treeshap", device="cpu")
        with pytest.raises(ValueError, match="split feature"):
            shap_values_device(b, X, device="cpu")


def test_imported_missing_routing_raises():
    # a golden model with LightGBM's own missing handling: NaN inputs would
    # route otherwise than predict(), so contributions refuse them
    for name in sorted(os.listdir(GOLDEN)):
        with open(os.path.join(GOLDEN, name, "model.txt")) as f:
            b = Booster.from_lightgbm_string(f.read())
        if b.missing_dec is not None:
            break
    X = np.full((2, b.num_features), np.nan, np.float32)
    with pytest.raises(NotImplementedError, match="predict_contrib"):
        b.predict_contrib(X, method="saabas", device="cpu")
    with pytest.raises(ValueError, match="unknown contribution method"):
        b.predict_contrib(np.zeros((2, b.num_features), np.float32),
                          method="lime", device="cpu")


def test_features_shap_col_is_ported():
    # every Param is ported: the estimators keep no list of refused ones
    assert not hasattr(_LightGBMParams, "_NOT_PORTED")
    assert _LightGBMParams.featuresShapCol.default is None


@pytest.mark.parametrize("method", ["treeshap", "saabas"])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_features_shap_col_matches_jax_estimator(kind, method):
    X, y2, y3 = _awkward(n=900, seed=9)
    y = {"binary": y2, "multiclass": y3,
         "regression": np.nan_to_num(X[:, 0]) + X[:, 2]}[kind]
    params = dict(numIterations=4, numLeaves=7, minDataInLeaf=40,
                  maxBin=31, featuresShapCol="shap", shapMethod=method)
    est, jest = ((LightGBMRegressor, JRegressor) if kind == "regression"
                 else (LightGBMClassifier, JClassifier))
    model = est(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    got = model.transform(TDataset({"features": X}))["shap"]
    with default_mesh(_mesh()):
        jmodel = jest(**params).fit(JDataset({"features": X, "label": y}))
        want = np.asarray(jmodel.transform(JDataset({"features": X}))["shap"])
    K = 3 if kind == "multiclass" else 1
    assert got.shape == (900, (X.shape[1] + 1) * K)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_host_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        _build.build_host("mmlspark_native")


def test_failed_host_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="failed building broken"):
        _build.build_host("broken")
    assert not os.listdir(tmp_path / "out")


def test_host_library_lands_in_the_build_dir():
    path = _build.build_host("mmlspark_native")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libmmlspark_native-")
    assert path == _build.host_library_path("mmlspark_native")


def test_host_library_name_follows_the_compiler(tmp_path, monkeypatch):
    # a library built by another compiler is never loaded by its name
    fake = tmp_path / "fake-c++"
    fake.write_text("#!/bin/sh\necho 'fake-c++ (Other) 99.1'\n")
    fake.chmod(0o755)
    native = _build.host_library_path("mmlspark_native")
    monkeypatch.setenv("CXX", str(fake))
    other = _build.host_library_path("mmlspark_native")
    assert other != native
    assert os.path.dirname(other) == os.path.dirname(native)
