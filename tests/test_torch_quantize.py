"""The predict lanes (f32 / bf16 / int8): the port against the JAX package.

Boosters trained by the JAX package (on a one-device mesh) are carried over
with ``booster_from_jax_arrays``, binner state included, so both packages
score the same forest. The int8 lane routes exactly as f32 (rows and
thresholds on the model's own bin grid) and differs only by its per-tree
int8 leaves; both sides dequantize the same way, so the port's int8
margins equal the JAX package's within 1e-6. The bf16 lane rounds rows and
thresholds to bfloat16; torch and ``ml_dtypes`` round alike (checked bit
for bit), so its routing is equal and its margins agree within 1e-6 too.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.models.gbdt import quantize as jq
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models.gbdt import quantize as tq
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays

torch.set_num_threads(1)

LANES = ("f32", "bf16", "int8")


def _port(jb) -> Booster:
    fields = {f: np.asarray(getattr(jb.trees, f)) for f in jb.trees._fields}
    return booster_from_jax_arrays(
        fields, jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state,
        objective_kwargs=jb.objective_kwargs)


def _fit(kind, seed=7):
    rng = np.random.default_rng(seed)
    mesh = make_mesh(devices=jax.devices()[:1])
    if kind == "categorical":
        X = rng.normal(size=(1200, 5)).astype(np.float32)
        X[:, 1] = rng.integers(0, 9, size=1200)
        y = (np.isin(X[:, 1], [1, 4, 6]) ^ (X[:, 0] > 0)).astype(np.float32)
        jb = jtrain(X, y, objective="binary", num_iterations=6,
                    cfg=JGrowConfig(num_leaves=15, min_data_in_leaf=20),
                    max_bin=63, categorical_features=(1,), mesh=mesh)
        return jb, X
    X = rng.normal(size=(1200, 8)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.03] = np.nan
    x0, x1, x2 = (np.nan_to_num(X[:, i]) for i in range(3))
    if kind == "binary":
        y = (x0 + x1 * x2 > 0).astype(np.float32)
        kw = dict(objective="binary")
    elif kind == "multiclass":
        y = np.digitize(x0, [-0.5, 0.5]).astype(np.float32)
        kw = dict(objective="multiclass", num_class=3)
    else:
        y = (x0 * 2 + np.sin(x1)).astype(np.float32)
        kw = dict(objective="regression")
    jb = jtrain(X, y, num_iterations=8, max_bin=63, mesh=mesh,
                cfg=JGrowConfig(num_leaves=15, min_data_in_leaf=20), **kw)
    return jb, X


@pytest.fixture(scope="module")
def models():
    return {k: _fit(k) for k in ("binary", "multiclass", "regression",
                                 "categorical")}


# -- resolution ---------------------------------------------------------------

@pytest.mark.parametrize("env,requested,kw,want", [
    (None, None, dict(max_bin=63), "f32"),
    ("int8", None, dict(max_bin=63), "int8"),
    ("int8", "bf16", dict(max_bin=63), "bf16"),
    ("fp4", None, dict(max_bin=63), "f32"),
    (None, "int8", dict(has_mdec=True, max_bin=63), "f32"),
    (None, "bf16", dict(has_mdec=True, max_bin=63), "f32"),
    (None, "int8", dict(max_bin=0), "f32"),
    (None, "int8", dict(max_bin=1000), "f32"),
    (None, "bf16", dict(max_bin=0), "bf16"),
])
def test_resolve_predict_dtype_matches_jax(monkeypatch, env, requested, kw,
                                           want):
    if env is None:
        monkeypatch.delenv(tq.PREDICT_DTYPE_ENV, raising=False)
    else:
        monkeypatch.setenv(tq.PREDICT_DTYPE_ENV, env)
    assert tq.PREDICT_DTYPE_ENV == jq.PREDICT_DTYPE_ENV
    assert tq.resolve_predict_dtype(requested, **kw) == want
    assert jq.resolve_predict_dtype(requested, **kw) == want


def test_unknown_explicit_lane_raises():
    with pytest.raises(ValueError, match="predict_dtype"):
        tq.resolve_predict_dtype("fp4", max_bin=63)


def test_booster_lane_degrades_without_grid(models):
    jb, X = models["binary"]
    tb = _port(jb)
    assert tb.resolved_predict_dtype("int8") == "int8"
    # LightGBM text keeps no bin grid: int8 scores as f32
    back = Booster.from_lightgbm_string(tb.to_lightgbm_string())
    assert back.resolved_predict_dtype("int8") == "f32"
    np.testing.assert_array_equal(
        back.predict_raw(X, device="cpu", predict_dtype="int8"),
        back.predict_raw(X, device="cpu", predict_dtype="f32"))


# -- the quantization funnel --------------------------------------------------

def test_quantize_features_and_thresholds_equal_jax(models):
    jb, X = models["binary"]
    ub = tq.feature_bounds(jb.binner_state)
    Xn = X.copy()
    Xn[::7, 0] = np.nan
    Xn[::11, 1] = np.inf
    q = tq.quantize_features(Xn, ub)
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(q, jq.quantize_features(Xn, ub))
    feat = np.asarray(jb.trees.feat)
    np.testing.assert_array_equal(
        tq.quantize_thresholds(jb.thr_raw, feat, ub),
        jq.quantize_thresholds(jb.thr_raw, feat, ub))
    # x > thr  <=>  q(x) > q(thr) on every split of the model
    internal = ~np.asarray(jb.trees.is_leaf)
    qt = tq.quantize_thresholds(jb.thr_raw, feat, ub)
    for f, t, qq in zip(feat[internal][:64], jb.thr_raw[internal][:64],
                        qt[internal][:64]):
        np.testing.assert_array_equal(Xn[:, f] > t,
                                      q[:, f].astype(np.int32) > qq)


def test_quantize_leaves_equal_jax(models):
    jb, _ = models["multiclass"]
    lv = np.asarray(jb.trees.leaf_value)
    q, s = tq.quantize_leaves(lv)
    jqv, js = jq.quantize_leaves(lv)
    np.testing.assert_array_equal(q, jqv)
    np.testing.assert_array_equal(s, js)
    deq = tq.dequantize_leaves(torch.from_numpy(q), torch.from_numpy(s))
    assert np.abs(deq.numpy() - lv).max() <= s.max() / 2 + 1e-12
    # an all-zero tree stays exact
    q0, s0 = tq.quantize_leaves(np.zeros((2, 5), np.float32))
    assert not q0.any() and (s0 > 0).all()


def test_bf16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.normal(size=4000).astype(np.float32) * 10,
                        np.float32([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                    3.4e38, 1.00390625, 1.01171875])])
    ours = tq.cast_features_bf16(v).view(torch.int16).numpy()
    theirs = v.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        tq.cast_thresholds_bf16(v).view(torch.int16).numpy(), theirs)


def test_row_quantizer_and_staging():
    ub = np.sort(np.random.default_rng(0).normal(size=(3, 15)),
                 axis=1).astype(np.float32)
    rows = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    qz = tq.row_quantizer("int8", ub)
    np.testing.assert_array_equal(qz(rows), tq.quantize_features(rows, ub))
    np.testing.assert_array_equal(qz(rows[0]),
                                  tq.quantize_features(rows[:1], ub)[0])
    assert tq.row_quantizer("bf16", None)(rows).dtype == torch.bfloat16
    assert tq.row_quantizer("f32", None) is None
    assert [tq.staging_dtype(x) for x in LANES] == [
        torch.float32, torch.bfloat16, torch.uint8]


# -- the lanes end to end -----------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression",
                                  "categorical"])
@pytest.mark.parametrize("lane", LANES)
def test_lane_margins_match_jax(models, kind, lane):
    jb, X = models[kind]
    tb = _port(jb)
    got = tb.predict_raw(X, device="cpu", predict_dtype=lane)
    want = jb.predict_raw(X, predict_dtype=lane)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tb.predict(X, device="cpu", predict_dtype=lane),
        jb.predict(X, predict_dtype=lane), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_int8_within_leaf_quantization_bound(models, kind):
    jb, X = models[kind]
    tb = _port(jb)
    f32 = tb.predict_raw(X, device="cpu", predict_dtype="f32")
    i8 = tb.predict_raw(X, device="cpu", predict_dtype="int8")
    _, scale = tq.quantize_leaves(tb.trees["leaf_value"])
    K = tb.num_class
    bound = np.array([scale[k::K].sum() / 2 for k in range(K)])
    assert (np.abs(i8 - f32).max(axis=0) <= bound + 1e-6).all()


def test_staged_rows_and_tensor_entry(models):
    jb, X = models["binary"]
    tb = _port(jb)
    want = tb.predict_raw(X, device="cpu", predict_dtype="int8")
    # rows already quantized on the host pass through
    q = tq.quantize_features(X, tq.feature_bounds(tb.binner_state))
    np.testing.assert_array_equal(
        tb.predict_raw(q, device="cpu", predict_dtype="int8"), want)
    # f32 rows on the device are binned there by the bin apply
    got = tb.predict_raw_tensor(torch.from_numpy(X), predict_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression",
                                  "categorical"])
def test_host_and_device_quantizers_agree(models, kind):
    # the int8 lane's two quantizers of one grid: the host one of
    # ``row_quantizer`` (rows quantized before the upload) and the bin
    # apply that f32 rows get on their device, at every edge of the grid
    jb, X = models[kind]
    tb = _port(jb)
    ub = tq.feature_bounds(tb.binner_state)
    blocks = [X[:200]]
    for f in range(X.shape[1]):
        b = ub[f][np.isfinite(ub[f])]
        vals = np.concatenate([
            b, np.nextafter(b, np.float32(np.inf)),
            np.nextafter(b, np.float32(-np.inf)),
            np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)])
        block = np.repeat(np.nan_to_num(X[:1]), len(vals), axis=0)
        block[:, f] = vals
        blocks.append(block)
    R = np.concatenate(blocks).astype(np.float32)
    q_host = tq.row_quantizer("int8", ub)(R)
    q_dev = tb._staged(torch.from_numpy(R), "int8")
    np.testing.assert_array_equal(q_dev.numpy(), q_host)
    np.testing.assert_array_equal(
        tb.predict_raw(R, device="cpu", predict_dtype="int8"),
        tb.predict_raw(q_host, device="cpu", predict_dtype="int8"))


def test_env_picks_the_lane(models, monkeypatch):
    jb, X = models["regression"]
    tb = _port(jb)
    monkeypatch.setenv(tq.PREDICT_DTYPE_ENV, "int8")
    np.testing.assert_array_equal(
        tb.predict(X, device="cpu"),
        tb.predict(X, device="cpu", predict_dtype="int8"))
    monkeypatch.setenv(tq.PREDICT_DTYPE_ENV, "bf16")
    np.testing.assert_allclose(tb.predict(X, device="cpu"),
                               jb.predict(X), rtol=0, atol=1e-6)


def test_npz_round_trip_keeps_the_int8_lane(models, tmp_path):
    jb, X = models["multiclass"]
    tb = _port(jb)
    tb.save(str(tmp_path / "m"))
    back = Booster.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(
        back.predict_raw(X, device="cpu", predict_dtype="int8"),
        tb.predict_raw(X, device="cpu", predict_dtype="int8"))
    # and the JAX package reads the port's file into the same lane
    jback = JBooster.load(str(tmp_path / "m.npz"))
    np.testing.assert_allclose(
        jback.predict_raw(X, predict_dtype="int8"),
        back.predict_raw(X, device="cpu", predict_dtype="int8"),
        rtol=0, atol=1e-6)


def test_lane_forest_is_cached_per_device_and_lane(models):
    jb, X = models["binary"]
    tb = _port(jb)
    # the eager body's forest: once per device and lane
    for lane in LANES:
        tb.predict_raw_tensor(torch.from_numpy(X[:10]), predict_dtype=lane)
    assert sorted(tb._dev_forest) == [("cpu", "bf16"), ("cpu", "f32"),
                                      ("cpu", "int8")]
    ent = tb._dev_forest[("cpu", "int8")]
    assert ent["thr"].dtype == torch.uint8
    assert ent["qleaf"].dtype == torch.int8
    assert tb._dev_forest[("cpu", "bf16")]["thr"].dtype == torch.bfloat16
    # the predict plan's forest arguments: once per device, tree bucket
    # and lane
    T = tb.num_trees
    for lane in LANES:
        tb.predict_raw(X[:10], device="cpu", predict_dtype=lane)
    assert sorted(tb._plan_forest) == [("cpu", T, "bf16"), ("cpu", T, "f32"),
                                       ("cpu", T, "int8")]
    ent = tb._plan_forest[("cpu", T, "int8")]
    assert ent["thr"].dtype == torch.uint8
    assert ent["qleaf"].dtype == torch.int8
    assert tb._plan_forest[("cpu", T, "bf16")]["thr"].dtype == torch.bfloat16
