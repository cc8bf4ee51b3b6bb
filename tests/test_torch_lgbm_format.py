"""LightGBM text format and model introspection: the PyTorch port against
the JAX package.

  * The 12 golden models of ``tests/resources/lgbm_golden/`` (LightGBM v3
    text with the predictions of an independent evaluator): the port's
    ``from_lightgbm_string`` -> ``predict_raw`` / ``predict`` on the CPU
    reproduce ``expected.json`` at rtol 1e-5 / atol 1e-6, as the JAX
    package's own corpus test does, and equal the JAX package's;
    ``predict_leaf`` and ``feature_importances`` equal the JAX package's,
    and ``predict_leaf`` refuses (``_check_missing_routing``) exactly the
    inputs the JAX one refuses.
  * The emitter: the JAX package's trees carried across by
    ``booster_from_jax_arrays`` are written as the same text, character for
    character, for every golden model and for trained categorical,
    multiclass and named-slot models.
  * The missing-value routing of imported models (the JAX package's
    ``tests/test_lgbm_format.py`` cases, ported): zero-as-missing,
    default-right NaN, missing type none; and the refused variants.
  * Files in both directions: ``.npz`` with ``tree_cat_bitset`` and
    ``missing_dec``, and ``model_string`` JSON.
  * The estimators: ``slotNames`` become the text's ``feature_names``;
    ``get_native_model`` / ``save_native_model`` / ``load_native_model``
    for the classifier, regressor and ranker; ``leafPredictionCol`` and
    ``get_feature_importances`` equal the JAX estimator's.
"""

import json
import os

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
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from test_lgbm_format import GOLDEN

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "resources", "lgbm_golden")
NAMES = sorted(os.listdir(CORPUS))


def _golden(name):
    with open(os.path.join(CORPUS, name, "model.txt")) as f:
        text = f.read()
    with open(os.path.join(CORPUS, name, "expected.json")) as f:
        exp = json.load(f)
    return text, exp


def _ported(jb):
    """The JAX booster's arrays carried across to the port."""
    return booster_from_jax_arrays(
        {k: np.asarray(v) for k, v in jb.trees._asdict().items()},
        jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state,
        objective_kwargs=jb.objective_kwargs, missing_dec=jb.missing_dec)


def test_corpus_has_the_twelve_models():
    assert len(NAMES) == 12 and {"categorical", "categorical_multiword",
                                 "deep_chain", "missing_zero"} <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_golden_model_predicts_expected_and_as_jax(name):
    text, exp = _golden(name)
    b = Booster.from_lightgbm_string(text)
    jb = JBooster.from_lightgbm_string(text)
    X = np.asarray(exp["X"], np.float32)
    raw = b.predict_raw(X, device="cpu")
    np.testing.assert_allclose(raw, np.asarray(exp["raw"]), rtol=1e-5,
                               atol=1e-6, err_msg=name)
    pred = b.predict(X, device="cpu")
    np.testing.assert_allclose(pred, np.asarray(exp["pred"]), rtol=1e-5,
                               atol=1e-6, err_msg=name)
    np.testing.assert_allclose(raw, jb.predict_raw(X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pred, jb.predict(X), rtol=0, atol=1e-6)
    assert b.depth_cap == jb.depth_cap
    assert (b.missing_dec is None) == (jb.missing_dec is None)


def _leaf_or_error(fn, X):
    try:
        return fn(X), None
    except NotImplementedError as e:
        return None, str(e)


@pytest.mark.parametrize("name", NAMES)
def test_golden_model_leaves_and_importances_match_jax(name):
    text, exp = _golden(name)
    b = Booster.from_lightgbm_string(text)
    jb = JBooster.from_lightgbm_string(text)
    X = np.asarray(exp["X"], np.float32)
    # the expected rows as given (NaN and zeros refused alike where the
    # model stores other missing-value handling), then without them
    clean = np.where(np.isnan(X) | (np.abs(X) <= 1e-35), np.float32(0.3), X)
    for rows in (X, clean):
        got, gerr = _leaf_or_error(lambda r: b.predict_leaf(r, device="cpu"),
                                   rows)
        want, jerr = _leaf_or_error(jb.predict_leaf, rows)
        # the same refusal (the JAX message also names predict_contrib)
        assert (gerr is None) == (jerr is None)
        if gerr is not None:
            rule = "zero-as-missing" if "zero-as" in jerr else "NaN left"
            assert rule in gerr
        if want is not None:
            assert got.shape == (len(rows), jb.num_trees)
            np.testing.assert_array_equal(got, want)
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(b.feature_importances(kind),
                                      jb.feature_importances(kind))


@pytest.mark.parametrize("name", NAMES)
def test_emitted_text_equals_the_jax_emitter(name):
    text, exp = _golden(name)
    jb = JBooster.from_lightgbm_string(text)
    port = _ported(jb)
    s = port.to_lightgbm_string()
    assert s == jb.to_lightgbm_string()
    # and what the port writes it reads back to the same predictions
    X = np.asarray(exp["X"], np.float32)
    np.testing.assert_allclose(
        Booster.from_lightgbm_string(s).predict_raw(X, device="cpu"),
        np.asarray(exp["raw"]), rtol=1e-5, atol=1e-6)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _cat_rows(n, seed, n_cats=12):
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, n_cats, n).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    y = (np.isin(cats, [1, 4, 7, 10]) ^ (noise[:, 0] > 1.0)).astype(
        np.float32)
    return np.column_stack([cats, noise]), y


@pytest.mark.parametrize("objective,num_class", [("binary", 1),
                                                 ("multiclass", 3)])
def test_trained_model_text_equals_jax_and_round_trips(objective, num_class):
    X, y = _cat_rows(2000, 1)
    if num_class > 1:
        y = (X[:, 0] % 3).astype(np.float32)
    jb = jtrain(X, y, objective=objective, num_class=num_class,
                num_iterations=3, max_bin=63, categorical_features=(0,),
                cfg=JGrowConfig(num_leaves=7, min_data_in_leaf=50),
                mesh=_mesh())
    jb.binner_state["feature_names"] = ["cat", "a", "b", "c"]
    port = _ported(jb)
    s = port.to_lightgbm_string()
    assert s == jb.to_lightgbm_string()
    assert "feature_names=cat a b c" in s and "cat_threshold=" in s
    # LightGBM folds the base score into the first trees: 1e-5, not exact
    back = Booster.from_string(s)
    np.testing.assert_allclose(back.predict_raw(X, device="cpu"),
                               port.predict_raw(X, device="cpu"), rtol=0,
                               atol=1e-5)
    assert back._cat_strict() and back.num_class == num_class


# the JAX package's missing-value cases on its GOLDEN string
# (tests/test_lgbm_format.py, TestUnsupportedStockVariants)
def _variant(old, new):
    return Booster.from_string(GOLDEN.replace(old, new))


def test_zero_as_missing_routes_default_side():
    b = _variant("decision_type=2 2", "decision_type=6 2")
    assert b.missing_dec is not None
    np.testing.assert_allclose(
        b.predict_raw(np.array([[0.0, 0.0]], np.float32),
                      device="cpu")[0, 0], 0.25 - 0.0625, rtol=1e-6)
    b4 = _variant("decision_type=2 2", "decision_type=4 2")
    np.testing.assert_allclose(
        b4.predict_raw(np.array([[0.0, 0.0]], np.float32),
                       device="cpu")[0, 0], 0.0625 - 0.0625, rtol=1e-6)
    # |x| <= 1e-35 counts as zero; an f64 that underflows in f32 too
    tiny = np.array([[0.0, 1e-36], [0.0, 1e-300]], np.float64)
    np.testing.assert_allclose(b.predict_raw(tiny, device="cpu")[:, 0],
                               [0.25 - 0.0625] * 2, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="zero-as-missing"):
        b.predict_leaf(np.array([[0.0, 0.0]], np.float32), device="cpu")
    with pytest.raises(NotImplementedError, match="zero-as-missing"):
        b.predict_leaf(tiny, device="cpu")


def test_default_right_nan_routes_right():
    b = _variant("decision_type=2 2", "decision_type=8 2")
    np.testing.assert_allclose(
        b.predict_raw(np.array([[0.0, np.nan]], np.float32),
                      device="cpu")[0, 0], 0.0625 - 0.0625, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="NaN left"):
        b.predict_leaf(np.array([[0.0, np.nan]], np.float32), device="cpu")
    assert b.predict_leaf(np.array([[0.0, 0.0]], np.float32),
                          device="cpu").shape == (1, 2)


def test_missing_none_nan_maps_to_zero():
    b = _variant("threshold=0.5 -1.0", "threshold=-0.5 -1.0")
    np.testing.assert_allclose(
        b.predict_raw(np.array([[2.0, np.nan]], np.float32),
                      device="cpu")[0, 0], 0.0625 + 0.1875, rtol=1e-6)


@pytest.mark.parametrize("old,new,match", [
    ("objective=binary sigmoid:1",
     "objective=multiclassova num_class:3 sigmoid:1", "one-vs-all"),
    ("objective=binary sigmoid:1", "objective=binary sigmoid:2", "sigmoid"),
])
def test_unsupported_variants_are_refused(old, new, match):
    with pytest.raises(NotImplementedError, match=match):
        _variant(old, new)


@pytest.mark.parametrize("dt", ["4 2", "6 2", "8 2", "10 8"])
def test_missing_routing_matches_jax_on_odd_values(dt):
    s = GOLDEN.replace("decision_type=2 2", f"decision_type={dt}")
    b, jb = Booster.from_string(s), JBooster.from_string(s)
    vals = np.array([np.nan, 0.0, -0.0, 1e-36, -1e-36, 1e-30, 0.5, 0.51,
                     -1.0, -1.01, 1.25, 3.0, np.inf, -np.inf], np.float32)
    X = np.stack(np.meshgrid(vals, vals), -1).reshape(-1, 2)
    np.testing.assert_allclose(b.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-7)


def test_missing_dec_and_bitsets_persist_through_every_format(tmp_path):
    X = np.array([[0.0, np.nan], [1.0, 2.0], [3.0, 0.0]], np.float32)
    imported = _variant("decision_type=2 2", "decision_type=8 2")
    text, exp = _golden("categorical")
    cat = Booster.from_lightgbm_string(text)
    Xc = np.asarray(exp["X"], np.float32)
    for b, rows in ((imported, X), (cat, Xc)):
        expect = b.predict_raw(rows, device="cpu")
        b.save(str(tmp_path / "m"))
        back = Booster.load(str(tmp_path / "m"))
        assert (back.missing_dec is None) == (b.missing_dec is None)
        np.testing.assert_array_equal(back.trees["cat_bitset"],
                                      b.trees["cat_bitset"])
        np.testing.assert_array_equal(back.predict_raw(rows, device="cpu"),
                                      expect)
        # the JAX package reads the port's file and JSON string
        jback = JBooster.load(str(tmp_path / "m.npz"))
        np.testing.assert_allclose(jback.predict_raw(rows), expect, rtol=0,
                                   atol=1e-6)
        jstr = JBooster.from_string(b.model_string())
        np.testing.assert_allclose(jstr.predict_raw(rows), expect, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            Booster.from_string(b.model_string()).predict_raw(rows,
                                                              device="cpu"),
            expect)


def test_port_reads_jax_files_with_bitsets_and_missing_dec(tmp_path):
    X, y = _cat_rows(1500, 2)
    jb = jtrain(X, y, objective="binary", num_iterations=3, max_bin=63,
                categorical_features=(0,),
                cfg=JGrowConfig(num_leaves=7, min_data_in_leaf=50),
                mesh=_mesh())
    assert np.asarray(jb.trees.cat_bitset).any()
    jimp = JBooster.from_string(GOLDEN.replace("decision_type=2 2",
                                               "decision_type=6 2"))
    Xm = np.array([[0.0, 0.0], [1.0, np.nan], [-2.0, 0.7]], np.float32)
    for j, rows in ((jb, X[:300]), (jimp, Xm)):
        j.save(str(tmp_path / "j"))
        b = Booster.load(str(tmp_path / "j.npz"))
        assert b.trees["cat_bitset"].dtype == np.uint32
        np.testing.assert_allclose(b.predict_raw(rows, device="cpu"),
                                   j.predict_raw(rows), rtol=0, atol=1e-6)
        s = Booster.from_string(j.model_string())
        np.testing.assert_allclose(s.predict_raw(rows, device="cpu"),
                                   j.predict_raw(rows), rtol=0, atol=1e-6)
    assert Booster.load(str(tmp_path / "j.npz")).missing_dec is not None


def _ranker_rows(seed):
    rng = np.random.default_rng(seed)
    # queries of 16 rows, a power of two: the JAX ranker pads none
    group = np.repeat(np.arange(30), 16)
    X = rng.normal(size=(len(group), 4)).astype(np.float32)
    y = np.digitize(X[:, 0] + 0.5 * rng.normal(size=len(group)),
                    [-0.5, 0.5, 1.2]).astype(np.float32)
    return X, y, group


@pytest.mark.parametrize("kind", ["classifier", "regressor", "ranker"])
def test_estimator_native_model_leaves_and_importances(kind, tmp_path):
    X, y = _cat_rows(1500, 4)
    cols = {"features": X, "label": y}
    params = dict(numIterations=3, numLeaves=7, minDataInLeaf=50, maxBin=63,
                  slotNames=["cat", "a", "b", "c"], leafPredictionCol="leaf")
    if kind == "ranker":
        X, y, g = _ranker_rows(5)
        cols = {"features": X, "label": y, "query": g}
        params.update(groupCol="query", minDataInLeaf=20)
    else:
        params["categoricalSlotIndexes"] = [0]
    if kind == "regressor":
        cols["label"] = X[:, 1] + (X[:, 0] % 3)
    cls = {"classifier": "LightGBMClassifier", "regressor":
           "LightGBMRegressor", "ranker": "LightGBMRanker"}[kind]
    port = getattr(TA, cls)(device="cpu", **params).fit(TDataset(cols))
    with default_mesh(_mesh()):
        jm = getattr(JA, cls)(**params).fit(JDataset(cols))
        jout = jm.transform(JDataset({"features": X}))
    out = port.transform(TDataset({"features": X}))
    np.testing.assert_array_equal(out.array("leaf"), np.asarray(jout["leaf"]))
    assert out.array("leaf").shape == (len(X), port.booster.num_trees)
    np.testing.assert_array_equal(port.get_feature_importances("split"),
                                  jm.get_feature_importances("split"))
    s = port.get_native_model()
    assert "feature_names=cat a b c" in s
    path = str(tmp_path / "model.txt")
    port.save_native_model(path)
    model_cls = getattr(TA, {"classifier": "LightGBMClassificationModel",
                             "regressor": "LightGBMRegressionModel",
                             "ranker": "LightGBMRankerModel"}[kind])
    loaded = model_cls.load_native_model(path)
    loaded.set(device="cpu")
    col = "prediction"
    np.testing.assert_allclose(
        loaded.transform(TDataset({"features": X})).array(col),
        out.array(col), rtol=0, atol=1e-5)
