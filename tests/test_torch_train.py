"""``TrainClassifier`` / ``TrainRegressor`` and the model statistics of the
port (``train/core.py``) against the JAX package's.

The same Adult-Census-shaped table (numeric columns with NaN, string
columns, a string label; numpy from a seed) goes through both packages'
``TrainClassifier(model=LightGBMClassifier(...))`` — the port's on
``device="cpu"``, the JAX package's on one device. The label levels and
the assembled features are equal, the trees have the same structure and the
scores agree within 1e-5 (the GBDT parity tests' tolerance).
``ComputeModelStatistics`` and ``ComputePerInstanceStatistics`` of both
packages on one scored table are equal. The fit publishes the JAX
package's spans and ``model_statistic`` gauges; ``utils/plot`` draws from
the port's curves.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.api import LightGBMRegressor as JRegressor
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu.train import core as jtrain
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassifier,
                                                LightGBMRegressor)
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.train import core as ttrain

from _torch_parity import assert_same

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
GBDT = dict(numIterations=4, numLeaves=7, minDataInLeaf=60, maxBin=63)


def adult_like(n=2400, seed=0):
    """Adult Census Income's mix: numeric and string columns, string
    labels '<=50K' / '>50K' at about 24% positives."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 90, size=n).astype(np.float64)
    hours = rng.normal(40, 12, size=n)
    hours[rng.random(n) < 0.03] = np.nan
    edu = rng.choice(["HS-grad", "Bachelors", "Masters", "Some-college",
                      "Doctorate"], size=n, p=[.35, .3, .15, .15, .05])
    job = rng.choice([f"job{i}" for i in range(14)], size=n)
    sex = rng.choice(["Male", "Female"], size=n)
    edu_w = {"HS-grad": 0.0, "Some-college": 0.3, "Bachelors": 0.9,
             "Masters": 1.3, "Doctorate": 1.6}
    z = (0.04 * (age - 38) + 0.03 * np.nan_to_num(hours - 40)
         + np.asarray([edu_w[e] for e in edu]) + 0.4 * (sex == "Male")
         - 1.6 + 0.8 * rng.normal(size=n))
    label = np.where(z > 0, ">50K", "<=50K").astype(object)
    return {"age": age, "hours": hours, "edu": edu.astype(object),
            "job": job.astype(object), "sex": sex.astype(object),
            "income": label}


def _one_device():
    return default_mesh(make_mesh(devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def classifier_pair():
    cols = adult_like()
    t = ttrain.TrainClassifier(
        model=LightGBMClassifier(device="cpu", **GBDT), labelCol="income",
        numFeatures=32).fit(Dataset(dict(cols)))
    with _one_device():
        j = jtrain.TrainClassifier(
            model=JClassifier(**GBDT), labelCol="income",
            numFeatures=32).fit(JDataset(dict(cols)))
    return cols, t, j


def test_train_classifier_matches_jax(classifier_pair):
    cols, t, j = classifier_pair
    assert t.get_or_default("levels") == j.get_or_default("levels") == [
        "<=50K", ">50K"]
    ds_t = t.get_or_default("featurizer").transform(Dataset(dict(cols)))
    ds_j = j.get_or_default("featurizer").transform(JDataset(dict(cols)))
    np.testing.assert_array_equal(ds_t["TrainClassifier_features"],
                                  ds_j["TrainClassifier_features"])
    tb = t.get_or_default("inner").booster
    jb = j.get_or_default("inner").booster
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)), f)
    out_t = t.transform(Dataset(dict(cols)))
    out_j = j.transform(JDataset(dict(cols)))
    assert out_t.columns == out_j.columns
    np.testing.assert_allclose(out_t.array("probability"),
                               out_j.array("probability"), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(out_t.array("prediction"),
                                  out_j.array("prediction"))
    np.testing.assert_array_equal(out_t.array("income"),
                                  out_j.array("income"))


def test_explicit_labels_and_unlisted_values():
    cols = adult_like(600, seed=1)
    est = ttrain.TrainClassifier(
        model=LightGBMClassifier(device="cpu", numIterations=2),
        labelCol="income", labels=[">50K", "<=50K"], numFeatures=16)
    m = est.fit(Dataset(dict(cols)))
    assert m.get_or_default("levels") == [">50K", "<=50K"]
    with pytest.raises(ValueError, match="not in the explicit labels"):
        ttrain.TrainClassifier(
            model=LightGBMClassifier(device="cpu", numIterations=2),
            labelCol="income", labels=[">50K"]).fit(Dataset(dict(cols)))


def test_train_regressor_matches_jax():
    cols = adult_like(1500, seed=2)
    cols["hours_out"] = np.nan_to_num(cols.pop("hours"), nan=40.0)
    cols.pop("income")
    params = dict(numIterations=3, numLeaves=7, minDataInLeaf=50, maxBin=63)
    t = ttrain.TrainRegressor(model=LightGBMRegressor(device="cpu", **params),
                              labelCol="hours_out", numFeatures=16).fit(
        Dataset(dict(cols)))
    with _one_device():
        j = jtrain.TrainRegressor(model=JRegressor(**params),
                                  labelCol="hours_out", numFeatures=16).fit(
            JDataset(dict(cols)))
    tb = t.get_or_default("inner").booster
    jb = j.get_or_default("inner").booster
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)), f)
    np.testing.assert_allclose(
        t.transform(Dataset(dict(cols))).array("prediction"),
        j.transform(JDataset(dict(cols))).array("prediction"), rtol=0,
        atol=1e-4)


def _scored(classifier_pair):
    cols, t, _ = classifier_pair
    out = t.transform(Dataset(dict(cols)))
    return {c: out[c] for c in ("income", "probability", "prediction")}


@pytest.mark.parametrize("metric", ["auto", "classification", "regression"])
def test_compute_model_statistics_equal_jax(classifier_pair, metric):
    scored = _scored(classifier_pair)
    ts = ttrain.ComputeModelStatistics(labelCol="income",
                                       evaluationMetric=metric)
    js = jtrain.ComputeModelStatistics(labelCol="income",
                                       evaluationMetric=metric)
    assert_same(ts.transform(Dataset(dict(scored))),
                js.transform(JDataset(dict(scored))))
    if metric != "regression":
        np.testing.assert_array_equal(ts.confusion_matrix,
                                      js.confusion_matrix)
        for curve in ("roc_curve", "pr_curve", "threshold_metrics"):
            assert_same(getattr(ts, curve), getattr(js, curve))


@pytest.mark.parametrize("drop", [None, "probability"])
def test_compute_per_instance_statistics_equal_jax(classifier_pair, drop):
    scored = _scored(classifier_pair)
    if drop:
        scored.pop(drop)
    assert_same(
        ttrain.ComputePerInstanceStatistics(labelCol="income").transform(
            Dataset(dict(scored))),
        jtrain.ComputePerInstanceStatistics(labelCol="income").transform(
            JDataset(dict(scored))))
    reg = {"label": np.arange(6.0), "prediction": np.arange(6.0) ** 1.5}
    assert_same(ttrain.ComputePerInstanceStatistics(
        evaluationMetric="regression").transform(Dataset(dict(reg))),
        jtrain.ComputePerInstanceStatistics(
            evaluationMetric="regression").transform(JDataset(dict(reg))))


def _labels(snap, name):
    return sorted(json.dumps({k: re.sub(r"_\d{4}", "_N", str(v))
                              for k, v in s["labels"].items()},
                             sort_keys=True)
                  for s in snap.get(name, {}).get("series", []))


def test_fit_publishes_the_jax_spans_and_statistics():
    for m in (jmetrics, tmetrics):
        m.get_registry().reset()
    try:
        cols = adult_like(600, seed=3)
        tm = ttrain.TrainClassifier(
            model=LightGBMClassifier(device="cpu", numIterations=2),
            labelCol="income", numFeatures=16).fit(Dataset(dict(cols)))
        with _one_device():
            jm = jtrain.TrainClassifier(
                model=JClassifier(numIterations=2), labelCol="income",
                numFeatures=16).fit(JDataset(dict(cols)))
        ttrain.ComputeModelStatistics(labelCol="income").transform(
            tm.transform(Dataset(dict(cols))))
        jtrain.ComputeModelStatistics(labelCol="income").transform(
            jm.transform(JDataset(dict(cols))))
        ts = tmetrics.get_registry().snapshot()
        js = jmetrics.get_registry().snapshot()
        spans_t = set(_labels(ts, "span_duration_seconds"))
        for name in ("TrainClassifier.index_labels",
                     "TrainClassifier.featurize",
                     "TrainClassifier.fit_inner"):
            assert json.dumps({"name": name}) in spans_t, name
        assert spans_t <= set(_labels(js, "span_duration_seconds"))
        assert (_labels(ts, "model_statistic")
                == _labels(js, "model_statistic"))
        assert _labels(ts, "model_statistic")
    finally:
        for m in (jmetrics, tmetrics):
            m.get_registry().reset()


def test_trained_models_round_trip(classifier_pair, tmp_path):
    cols, t, _ = classifier_pair
    t.save(str(tmp_path / "tc"))
    back = PipelineStage.load(str(tmp_path / "tc"))
    assert_same(back.transform(Dataset(dict(cols))),
                t.transform(Dataset(dict(cols))))


def test_plot_helpers_draw_from_the_port_curves(classifier_pair):
    import matplotlib
    matplotlib.use("Agg")
    from mmlspark_tpu_torch.utils import plot

    scored = _scored(classifier_pair)
    y = (np.asarray(scored["income"]) > 0).astype(float)
    data = {"label": y, "prediction": scored["prediction"],
            "probability": scored["probability"]}
    ax = plot.confusion_matrix(data)
    assert ax.get_title().startswith("accuracy = ")
    ax = plot.roc(data)
    fpr, tpr = ttrain._roc_curve(y, np.asarray(scored["probability"])[:, 1])
    assert ax.get_title() == f"ROC (AUC = {ttrain._auc(fpr, tpr):.4f})"
    import matplotlib.pyplot as plt
    plt.close("all")
