"""The port's VW learners (``models/vw``) against the JAX package's.

* The featurizer's indices and values are bit-equal to the JAX
  featurizer's (every type of cell, string splitting, ``hashSeed``,
  ``preserveOrderNumBits``).
* ``train_sgd`` on one rank equals the JAX package's on one device within
  2e-5 (f32 rounding of the reductions; the scatter-adds run in the same
  order), for every loss and option over 2 passes; ``train_bfgs`` within
  the JAX package's own cross-mesh tolerance (rtol 1e-3, atol 1e-4).
* On the port alone: a streamed fit equals the in-memory fit and a
  resumed checkpointed fit the uninterrupted one, bit for bit (streamed
  lazy L1 within 1e-6, as the JAX package states).
* The estimators fit and score as the JAX package's (every Param the
  reference exposes), 2 gloo ranks equal a JAX 2-device mesh, ``convert``
  scores a JAX model equally, and directories saved by the JAX package
  load in a port process that cannot import JAX.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.vw import api as japi
from mmlspark_tpu.models.vw import sgd as jsgd
from mmlspark_tpu.models.vw.featurizer import \
    VowpalWabbitFeaturizer as JFeaturizer
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.vw import api as tapi
from mmlspark_tpu_torch.models.vw import sgd as tsgd
from mmlspark_tpu_torch.models.vw.convert import vw_model_from_jax
from mmlspark_tpu_torch.models.vw.featurizer import VowpalWabbitFeaturizer

from _torch_ranks import run_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD_ATOL = 2e-5


def _one_device():
    return jmesh.make_mesh({"data": 1}, devices=jax.devices()[:1])


# ---------------------------------------------------------------------------
# Featurizer
# ---------------------------------------------------------------------------

FEATURIZER_CASES = [
    ({"age": np.array([30.0, 0.0]), "city": ["paris", "rome"]},
     dict(inputCols=["age", "city"])),
    ({"text": ["hello world hello", "one"]},
     dict(inputCols=["text"], stringSplitInputCols=["text"])),
    ({"text": ["hello world hello", "one"]},
     dict(inputCols=["text"], stringSplitInputCols=["text"],
          sumCollisions=False, prefixStringsWithColumnName=False)),
    ({"s": ["x"]}, dict(inputCols=["s"])),
    ({"v": np.array([[1.0, 0.0, 3.0]])}, dict(inputCols=["v"])),
    ({"m": [{"a": 1.5, "b": 2.5}]}, dict(inputCols=["m"])),
    ({"b": [True, False], "n": [None, 3], "l": [["x", "y"], ["z"]],
      "f": [np.nan, 2.5]}, dict(inputCols=["b", "n", "l", "f"])),
    ({"a": ["u", "v"], "c": [1.0, 2.0], "d": ["p q", "r"]},
     dict(inputCols=["a", "c", "d"], stringSplitInputCols=["d"],
          preserveOrderNumBits=2, numBits=12)),
    ({"a": ["u", "v"], "c": [7.0, 2.0]},
     dict(inputCols=["a", "c"], hashSeed=12345, numBits=20)),
    ({"unicode": ["héllo wörld", "日本"]},
     dict(inputCols=["unicode"], stringSplitInputCols=["unicode"],
          outputCol="ns")),
]


@pytest.mark.parametrize("cols,kw", FEATURIZER_CASES,
                         ids=[str(i) for i in range(len(FEATURIZER_CASES))])
def test_featurizer_bit_equal_to_jax(cols, kw):
    out = kw.get("outputCol", "features")
    t = VowpalWabbitFeaturizer(**kw).transform(Dataset(dict(cols)))
    j = JFeaturizer(**kw).transform(JDataset(dict(cols)))
    for suffix in ("_indices", "_values"):
        a, b = t.array(out + suffix), j.array(out + suffix)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_featurizer_refusals_equal_jax():
    ds = {"a": ["u"], "b": ["v"], "c": ["w"]}
    for mod, D in ((VowpalWabbitFeaturizer, Dataset),
                   (JFeaturizer, JDataset)):
        with pytest.raises(ValueError, match="must be < numBits"):
            mod(inputCols=["a"], preserveOrderNumBits=18).transform(
                D(dict(ds)))
        with pytest.raises(ValueError, match="encodes at most"):
            mod(inputCols=["a", "b", "c"], preserveOrderNumBits=1).transform(
                D(dict(ds)))
        with pytest.raises(TypeError, match="unsupported"):
            mod(inputCols=["a"]).transform(D({"a": [object()]}))


# ---------------------------------------------------------------------------
# train_sgd / train_bfgs
# ---------------------------------------------------------------------------


def _data(n=500, nnz=6, bits=10, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, size=(n, nnz)).astype(np.int32)
    idx[:, -1] = 5                 # a constant feature in every row
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    val[:, -1] = 1.0
    y = (val[:, 0] + 0.4 * rng.normal(size=n) > 0).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return idx, val, y, sw


SGD_OPTIONS = [
    dict(),
    dict(adaptive=False, power_t=0.5),
    dict(adaptive=False, power_t=0.25, initial_t=3.0),
    dict(l1=0.01),
    dict(l2=0.01),
    dict(loss="hinge"),
    dict(loss="quantile", quantile_tau=0.3),
    dict(loss="squared", learning_rate=0.1),
    dict(batch_size=1, num_bits=8),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("over", SGD_OPTIONS, ids=lambda o: str(o) or "{}")
def test_train_sgd_matches_jax_one_device(over, weighted):
    idx, val, y, sw = _data()
    kw = dict(num_bits=10, loss="logistic", num_passes=2, batch_size=64)
    kw.update(over)
    idx = idx & ((1 << kw["num_bits"]) - 1)
    sw = sw if weighted else None
    wj = jsgd.train_sgd(idx, val, y, sw, jsgd.SGDConfig(**kw),
                        mesh=_one_device())
    wt = tsgd.train_sgd(idx, val, y, sw, tsgd.SGDConfig(**kw), device="cpu")
    assert wt.dtype == np.float32 and wt.shape == wj.shape
    np.testing.assert_allclose(wt, wj, rtol=0, atol=SGD_ATOL)


@pytest.mark.parametrize("loss,l1,l2", [("logistic", 0.0, 0.0),
                                        ("squared", 0.0, 0.01),
                                        ("logistic", 0.001, 0.0)])
def test_train_bfgs_matches_jax(loss, l1, l2):
    idx, val, y, _ = _data(seed=1)
    cfg = dict(num_bits=10, loss=loss, num_passes=8, l1=l1, l2=l2)
    wj = jsgd.train_bfgs(idx, val, y, None, jsgd.SGDConfig(**cfg),
                         mesh=_one_device())
    trace = {}
    wt = tsgd.train_bfgs(idx, val, y, None, tsgd.SGDConfig(**cfg),
                         device="cpu", trace=trace)
    np.testing.assert_allclose(wt, wj, rtol=1e-3, atol=1e-4)
    obj = trace["objective"]
    assert len(obj) == 9 and all(b <= a + 1e-7 for a, b in zip(obj, obj[1:]))
    assert len(trace["readbacks"]) == 8
    assert all(2 <= r <= 22 for r in trace["readbacks"])


def _shards(tmp_path, name, arr, parts=3):
    """``arr`` as ``parts`` ``.npy`` shards in its own dtype."""
    sub = tmp_path / name
    sub.mkdir()
    cuts = np.linspace(0, len(arr), parts + 1).astype(int)
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        np.save(sub / f"part{i:03d}.npy", arr[a:b])
    return str(sub)


@pytest.mark.parametrize("over,chunk", [(dict(), 128),
                                        (dict(adaptive=False), 200),
                                        (dict(l1=0.01), 200)])
def test_streamed_equals_in_memory(tmp_path, over, chunk):
    idx, val, y, _ = _data(n=500, bits=12)
    cfg = tsgd.SGDConfig(num_bits=12, loss="logistic", num_passes=2,
                         batch_size=64, **over)
    w_mem = tsgd.train_sgd(idx, val, y, None, cfg, device="cpu")
    paths = [_shards(tmp_path, k, a) for k, a in
             (("i", idx), ("v", val), ("y", y))]
    w_st = tsgd.train_sgd_streamed(*paths, cfg=cfg, chunk_rows=chunk,
                                   device="cpu")
    if over.get("l1"):
        np.testing.assert_allclose(w_st, w_mem, atol=1e-6)
    else:
        np.testing.assert_array_equal(w_st, w_mem)


@pytest.mark.parametrize("over", [dict(), dict(adaptive=False),
                                  dict(l1=0.01)])
def test_checkpoint_resume_is_bitwise(tmp_path, over):
    idx, val, y, _ = _data(n=256, nnz=4, bits=10, seed=3)
    cfg = tsgd.SGDConfig(num_bits=10, num_passes=4, batch_size=32, **over)
    w_direct = tsgd.train_sgd(idx, val, y, None, cfg, device="cpu")
    two = cfg._replace(num_passes=2)
    d = str(tmp_path / "ck")
    tsgd.train_sgd_checkpointed(idx, val, y, None, two, d, device="cpu")
    w_resumed = tsgd.train_sgd_checkpointed(idx, val, y, None, cfg, d,
                                            device="cpu")
    np.testing.assert_array_equal(w_resumed, w_direct)
    with pytest.raises(ValueError, match="already covers"):
        tsgd.train_sgd_checkpointed(idx, val, y, None,
                                    cfg._replace(num_passes=2), d,
                                    device="cpu")


def test_streamed_validation_errors(tmp_path):
    idx, val, y, _ = _data(n=96)
    paths = [_shards(tmp_path, k, a) for k, a in
             (("i", idx), ("v", val), ("y", y[:64]))]
    cfg = tsgd.SGDConfig(num_bits=12, loss="logistic")
    with pytest.raises(ValueError, match="row counts disagree"):
        tsgd.train_sgd_streamed(*paths, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="chunk_rows"):
        tsgd.train_sgd_streamed(paths[0], paths[1], paths[0], cfg=cfg,
                                chunk_rows=0, device="cpu")
    with pytest.raises(ValueError, match="bfgs"):
        tapi.VowpalWabbitClassifier(
            numBits=12, passThroughArgs="--bfgs", device="cpu").fit_streamed(
            paths[0], paths[1], paths[0])
    with pytest.raises(ValueError, match="weight_path"):
        tapi.VowpalWabbitClassifier(numBits=12, weightCol="w",
                                    device="cpu").fit_streamed(
            paths[0], paths[1], paths[0])
    with pytest.raises(ValueError, match="labelConversion"):
        tapi.VowpalWabbitClassifier(labelConversion=False,
                                    device="cpu").fit_streamed(
            paths[0], paths[1], paths[0])


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def _text(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pos, neg = ["good", "great", "happy"], ["bad", "awful", "sad"]
    texts, labels, nums = [], [], []
    for _ in range(n):
        yv = int(rng.integers(0, 2))
        words = list(rng.choice(pos if yv else neg, size=2))
        words += list(rng.choice(["the", "a", "is", "good", "bad"], size=2))
        texts.append(" ".join(words))
        labels.append(float(yv))
        nums.append(rng.normal())
    return {"text": texts, "extra": np.asarray(nums), "label":
            np.asarray(labels)}


def _hashed(cols):
    t = VowpalWabbitFeaturizer(inputCols=["text"],
                               stringSplitInputCols=["text"])
    j = JFeaturizer(inputCols=["text"], stringSplitInputCols=["text"])
    tx = VowpalWabbitFeaturizer(inputCols=["extra"], outputCol="xf")
    jx = JFeaturizer(inputCols=["extra"], outputCol="xf")
    return (tx.transform(t.transform(Dataset(dict(cols)))),
            jx.transform(j.transform(JDataset(dict(cols)))))


ESTIMATOR_CASES = [
    ("VowpalWabbitClassifier", dict(numPasses=2)),
    ("VowpalWabbitClassifier", dict(numBits=14, lossFunction="hinge",
                                    adaptive=False, powerT=0.3)),
    ("VowpalWabbitClassifier", dict(passThroughArgs="-b 12 --l2 0.001 "
                                    "--passes 3 --sgd --power_t 0.4 "
                                    "--initial_t 1")),
    ("VowpalWabbitClassifier", dict(additionalFeatures=["xf"], l1=1e-4)),
    ("VowpalWabbitClassifier", dict(additionalFeatures=["xf"],
                                    ignoreNamespaces="f", noConstant=True)),
    ("VowpalWabbitClassifier", dict(weightCol="w", batchSize=16)),
    ("VowpalWabbitClassifier", dict(passThroughArgs="--bfgs --passes 6")),
    ("VowpalWabbitRegressor", dict(numPasses=2, learningRate=0.2)),
    ("VowpalWabbitRegressor", dict(lossFunction="quantile",
                                   passThroughArgs="--quantile_tau 0.7 "
                                   "--noconstant")),
]


@pytest.mark.parametrize("name,kw", ESTIMATOR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ESTIMATOR_CASES)])
def test_estimator_fit_transform_matches_jax(name, kw):
    cols = _text()
    cols["w"] = np.linspace(0.5, 1.5, len(cols["label"]))
    tds, jds = _hashed(cols)
    tm = getattr(tapi, name)(device="cpu", **kw).fit(tds)
    with jmesh.default_mesh(_one_device()):
        jm = getattr(japi, name)(**kw).fit(jds)
    atol = 1e-4 if "bfgs" in kw.get("passThroughArgs", "") else SGD_ATOL
    np.testing.assert_allclose(tm.weights, jm.weights, rtol=0, atol=atol)
    to, jo = tm.transform(tds), jm.transform(jds)
    assert to.columns == jo.columns
    for c in ("prediction", "probability", "rawPrediction"):
        if c in to:
            np.testing.assert_allclose(to.array(c), jo.array(c), rtol=0,
                                       atol=10 * atol)
    assert tm.stats["numWeights"] == int((tm.weights != 0).sum())
    assert set(tm.stats) == set(jm.stats)


def test_classifier_learns_and_reports():
    tds, _ = _hashed(_text())
    m = tapi.VowpalWabbitClassifier(numPasses=3, device="cpu").fit(tds)
    out = m.transform(tds)
    assert (out.array("prediction") == tds.array("label")).mean() > 0.95
    np.testing.assert_allclose(out.array("probability").sum(1), 1.0,
                               atol=1e-6)
    stats = m.get_performance_statistics()
    assert stats["numExamples"][0] == 300
    rm = m.get_readable_model()
    np.testing.assert_array_equal(rm["weight"],
                                  m.weights[rm["index"]].astype(np.float64))


def test_label_conversion_and_initial_model():
    cols = _text(seed=2)
    tds, jds = _hashed(cols)
    pm = {"labelConversion": False}
    pm1 = tds.with_column("label", tds.array("label") * 2 - 1)
    jm1 = jds.with_column("label", jds.array("label") * 2 - 1)
    t = tapi.VowpalWabbitClassifier(device="cpu", **pm).fit(pm1)
    with jmesh.default_mesh(_one_device()):
        j = japi.VowpalWabbitClassifier(**pm).fit(jm1)
        j2 = japi.VowpalWabbitClassifier(initialModel=j).fit(jds)
    np.testing.assert_allclose(t.weights, j.weights, atol=SGD_ATOL)
    t2 = tapi.VowpalWabbitClassifier(initialModel=t, device="cpu").fit(tds)
    np.testing.assert_allclose(t2.weights, j2.weights, atol=5 * SGD_ATOL)
    with pytest.raises(ValueError, match="noConstant"):
        tapi.VowpalWabbitClassifier(initialModel=t, noConstant=True,
                                    device="cpu").fit(tds)
    with pytest.raises(ValueError, match="numBits"):
        tapi.VowpalWabbitClassifier(initialModel=t.weights, numBits=12,
                                    device="cpu").fit(tds)
    with pytest.raises(ValueError, match="-1/\\+1"):
        tapi.VowpalWabbitClassifier(labelConversion=False,
                                    device="cpu").fit(tds)


def test_checkpoint_dir_estimator_resume(tmp_path):
    tds, _ = _hashed(_text(seed=4))
    d = str(tmp_path / "ck")
    whole = tapi.VowpalWabbitClassifier(numPasses=3, device="cpu").fit(tds)
    tapi.VowpalWabbitClassifier(numPasses=2, checkpointDir=d,
                                device="cpu").fit(tds)
    resumed = tapi.VowpalWabbitClassifier(numPasses=3, checkpointDir=d,
                                          device="cpu").fit(tds)
    np.testing.assert_array_equal(resumed.weights, whole.weights)


def test_fit_streamed_and_predict_margin_streamed(tmp_path):
    tds, _ = _hashed(_text(seed=5))
    est = tapi.VowpalWabbitClassifier(numBits=16, numPasses=2,
                                      device="cpu")
    m_mem = est.fit(tds)
    idx, val = est._features(tds)
    paths = [_shards(tmp_path, k, a) for k, a in
             (("i", idx), ("v", val), ("y", tds.array("label")))]
    m_st = tapi.VowpalWabbitClassifier(
        numBits=16, numPasses=2, device="cpu").fit_streamed(
        *paths, chunk_rows=128)
    np.testing.assert_array_equal(m_st.weights, m_mem.weights)
    margins = m_mem.predict_margin_streamed(paths[0], paths[1],
                                            chunk_rows=70)
    np.testing.assert_array_equal(
        margins, m_mem.transform(tds).array("rawPrediction")[:, 1]
        .astype(np.float32))
    with pytest.raises(ValueError, match="swapped"):
        m_mem.predict_margin_streamed(paths[1], paths[1])


def test_model_save_load_and_pre_v2_format(tmp_path):
    tds, _ = _hashed(_text(seed=6))
    m = tapi.VowpalWabbitClassifier(device="cpu").fit(tds)
    m.save(str(tmp_path / "m"))
    back = PipelineStage.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.transform(tds).array("probability"),
                                  m.transform(tds).array("probability"))
    z = dict(np.load(str(tmp_path / "m" / "weights.npz")))
    z.pop("vw_format")
    np.savez_compressed(str(tmp_path / "m" / "weights"), **z)
    old = PipelineStage.load(str(tmp_path / "m"))
    assert old.get_or_default("noConstant") is True


def test_two_gloo_ranks_match_a_jax_two_device_mesh(tmp_path):
    idx, val, y, _ = _data(n=600, bits=10, seed=7)
    np.savez(tmp_path / "d.npz", idx=idx, val=val, y=y)
    body = f"""
    from mmlspark_tpu_torch.models.vw import sgd
    d = np.load({str(tmp_path / 'd.npz')!r})
    out = {{}}
    for name, over in (("ada", {{}}), ("l1", {{"l1": 0.01}})):
        cfg = sgd.SGDConfig(num_bits=10, loss="logistic", num_passes=2,
                            batch_size=32, **over)
        out[name] = sgd.train_sgd(d["idx"], d["val"], d["y"], None, cfg,
                                  device="cpu").tolist()
    cfg = sgd.SGDConfig(num_bits=10, loss="logistic", num_passes=5)
    out["bfgs"] = sgd.train_bfgs(d["idx"], d["val"], d["y"], None, cfg,
                                 device="cpu").tolist()
    result = out
    """
    ranks = run_ranks(tmp_path, 2, body)
    assert ranks[0] == ranks[1]
    mesh2 = jmesh.make_mesh({"data": 2}, devices=jax.devices()[:2])
    for name, over in (("ada", {}), ("l1", {"l1": 0.01})):
        cfg = jsgd.SGDConfig(num_bits=10, loss="logistic", num_passes=2,
                             batch_size=32, **over)
        wj = jsgd.train_sgd(idx, val, y, None, cfg, mesh=mesh2)
        np.testing.assert_allclose(np.asarray(ranks[0][name], np.float32),
                                   wj, rtol=0, atol=SGD_ATOL)
    wj = jsgd.train_bfgs(idx, val, y, None,
                         jsgd.SGDConfig(num_bits=10, loss="logistic",
                                        num_passes=5), mesh=mesh2)
    np.testing.assert_allclose(np.asarray(ranks[0]["bfgs"], np.float32), wj,
                               rtol=1e-3, atol=1e-4)


def test_convert_scores_a_jax_model_equally():
    tds, jds = _hashed(_text(seed=8))
    with jmesh.default_mesh(_one_device()):
        jm = japi.VowpalWabbitClassifier(numBits=15, numPasses=2,
                                         additionalFeatures=["xf"]).fit(jds)
    tm = vw_model_from_jax(jm.weights, jm.extract_param_map(), jm.stats,
                           device="cpu")
    assert isinstance(tm, tapi.VowpalWabbitClassificationModel)
    np.testing.assert_array_equal(tm.weights, jm.weights)
    to, jo = tm.transform(tds), jm.transform(jds)
    np.testing.assert_allclose(to.array("probability"),
                               jo.array("probability"), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to.array("prediction"),
                                  jo.array("prediction"))
    with pytest.raises(ValueError, match="kind"):
        vw_model_from_jax(jm.weights, kind="ranker")


BLOCK_JAX = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmlspark_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def test_jax_saved_stages_load_without_jax(tmp_path):
    """A VW model and a TrainedClassifierModel (LightGBM inside) saved by
    the JAX package load in a port process where importing jax or the JAX
    package raises, and score as the JAX package scores them."""
    from mmlspark_tpu.models.gbdt.api import LightGBMClassifier
    from mmlspark_tpu.train.core import TrainClassifier
    tds, jds = _hashed(_text(seed=9))
    with jmesh.default_mesh(_one_device()):
        jvw = japi.VowpalWabbitClassifier(numBits=14).fit(jds)
        rng = np.random.default_rng(0)
        tab = {"a": rng.normal(size=300), "c": rng.choice(["x", "y", "z"],
                                                          300).astype(object),
               "label": rng.choice(["no", "yes"], 300).astype(object)}
        jtc = TrainClassifier(model=LightGBMClassifier(numIterations=3),
                              numFeatures=8).fit(JDataset(dict(tab)))
    jvw.save(str(tmp_path / "vw"))
    jtc.save(str(tmp_path / "tc"))
    np.savez(tmp_path / "want.npz",
             vw=jvw.transform(jds).array("probability"),
             tc=jtc.transform(JDataset(dict(tab))).array("probability"),
             idx=jds.array("features_indices"),
             val=jds.array("features_values"),
             a=tab["a"], c=tab["c"].astype(str), label=tab["label"].astype(str))
    code = BLOCK_JAX + textwrap.dedent(f"""
    import numpy as np, torch
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    w = np.load({str(tmp_path / 'want.npz')!r})
    vw = PipelineStage.load({str(tmp_path / 'vw')!r})
    vw.set(device="cpu")
    got = vw.transform(Dataset({{"features_indices": w["idx"],
                                "features_values": w["val"]}}))
    assert type(vw).__module__.startswith("mmlspark_tpu_torch."), type(vw)
    assert np.abs(got.array("probability") - w["vw"]).max() <= 1e-6
    tc = PipelineStage.load({str(tmp_path / 'tc')!r})
    tc.get_or_default("inner").set(device="cpu")
    got = tc.transform(Dataset({{"a": w["a"],
                                "c": w["c"].astype(object),
                                "label": w["label"].astype(object)}}))
    assert np.abs(got.array("probability") - w["tc"]).max() <= 1e-5
    import sys
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "mmlspark_tpu")]
    assert not bad, bad
    print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
