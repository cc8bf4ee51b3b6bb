"""Streamed scoring and the prefetch loop of the port.

``stream_apply`` reads chunk i+1 on one background thread while chunk i is
scored on the calling thread: the outputs are the same with prefetch on
and off, at most two chunks are ever loaded and not yet consumed, and a
loader's exception reaches the consumer in order. ``predict_streamed`` and
``predict_contrib_streamed`` over ``.npy`` shards equal their in-memory
calls bit for bit, and the scores equal the JAX package's streamed scores
of the same forest (carried over with ``booster_from_jax_arrays``).
``stream_transform`` of a ``DNNModel`` over ``.npy`` shards and
``stream_featurize_images`` over a directory of PNG files (one of them
corrupt, skipped) equal the in-memory ``transform`` bit for bit, and the
JAX package's streamed features within the featurizer's tolerance (1e-4
of their largest magnitude: the resize's 1e-3 on 0..255, scaled by the
normalization, then the forward's f32 order).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.io.prefetch import iter_prefetched, prefetch_enabled
from mmlspark_tpu.io import streaming as jstreaming
from mmlspark_tpu.models.dnn import cnn as Jcnn
from mmlspark_tpu.models.dnn.scoring import DNNModel as JDNNModel
from mmlspark_tpu.models.dnn.scoring import ImageFeaturizer as JFeaturizer
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.image.ops import decode_image
from mmlspark_tpu_torch.io.streaming import (_ChunkAccumulator, stream_apply,
                                             stream_featurize_images,
                                             stream_transform)
from mmlspark_tpu_torch.models.dnn.convert import dnn_model_from_jax
from mmlspark_tpu_torch.models.dnn.scoring import ImageFeaturizer
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.models.gbdt.ingest import write_shards

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    X[rng.random(X.shape) < 0.02] = np.nan
    y = np.digitize(np.nan_to_num(X[:, 0]), [-0.4, 0.4]).astype(np.float32)
    jb = jtrain(X, y, objective="multiclass", num_class=3, num_iterations=4,
                cfg=JGrowConfig(num_leaves=7, min_data_in_leaf=30),
                max_bin=31, mesh=make_mesh(devices=jax.devices()[:1]))
    fields = {f: np.asarray(getattr(jb.trees, f)) for f in jb.trees._fields}
    tb = booster_from_jax_arrays(
        fields, jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state)
    write_shards([X[:1100], X[1100:1101], X[1101:]], d / "x")
    return d, X, jb, tb


@pytest.mark.parametrize("disable", ["0", "1"])
def test_stream_apply_same_with_prefetch_on_and_off(setup, monkeypatch,
                                                    disable):
    d, X, _, _ = setup
    monkeypatch.setenv("MMLSPARK_TPU_DISABLE_PREFETCH", disable)
    assert prefetch_enabled() == (disable == "0")
    out = stream_apply(str(d / "x"), lambda c: np.nan_to_num(c) * 2.0,
                       chunk_rows=317)
    np.testing.assert_array_equal(out, np.nan_to_num(X) * 2.0)


def test_prefetch_keeps_at_most_two_chunks_in_flight():
    lock = threading.Lock()
    state = {"loaded": 0, "consumed": 0, "most": 0}

    def thunk(i):
        def load():
            time.sleep(0.002)
            with lock:
                state["loaded"] += 1
                state["most"] = max(state["most"],
                                    state["loaded"] - state["consumed"])
            return i
        return load

    got = []
    for v in iter_prefetched(thunk(i) for i in range(30)):
        time.sleep(0.004)              # the consumer is the slower side
        with lock:
            state["consumed"] += 1
        got.append(v)
    assert got == list(range(30))
    assert state["most"] <= 2


def test_prefetch_raises_in_order():
    def thunk(i):
        def load():
            if i in (3, 5):
                raise KeyError(i)
            return i
        return load

    got = []
    with pytest.raises(KeyError) as ei:
        for v in iter_prefetched(thunk(i) for i in range(8)):
            got.append(v)
    assert got == [0, 1, 2] and ei.value.args == (3,)


def test_stream_apply_writes_shards(setup, tmp_path):
    d, X, _, _ = setup
    out = tmp_path / "out"
    out.mkdir()
    np.save(out / "part-00099.npy", np.zeros(3))       # a stale shard
    paths = stream_apply(str(d / "x"), lambda c: c[:, :2], chunk_rows=1000,
                         out_dir=str(out))
    assert [os.path.basename(p) for p in paths] == [
        "part-00000.npy", "part-00001.npy", "part-00002.npy"]
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p)
                                             for p in paths)
    np.testing.assert_array_equal(np.concatenate([np.load(p) for p in paths]),
                                  X[:, :2])
    with pytest.raises(ValueError, match="contains the input shards"):
        stream_apply(str(d / "x"), lambda c: c, out_dir=str(d / "x"))
    with pytest.raises(ValueError, match="chunk_rows"):
        stream_apply(str(d / "x"), lambda c: c, chunk_rows=0)


def test_accumulator_demotes_unaligned_outputs():
    acc = _ChunkAccumulator(5)
    acc.add(np.arange(2.0), 2)
    acc.add(np.arange(4.0), 3)                # not row-aligned
    np.testing.assert_array_equal(acc.result(), [0, 1, 0, 1, 2, 3])
    assert _ChunkAccumulator(0).result().shape == (0,)


@pytest.mark.parametrize("lane", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("raw", [False, True])
def test_predict_streamed_equals_predict(setup, raw, lane):
    d, X, jb, tb = setup
    got = tb.predict_streamed(str(d / "x"), chunk_rows=777, raw=raw,
                              device="cpu", predict_dtype=lane)
    method = tb.predict_raw if raw else tb.predict
    np.testing.assert_array_equal(got, method(X, device="cpu",
                                              predict_dtype=lane))
    if lane == "f32":
        want = jb.predict_streamed(str(d / "x"), chunk_rows=777, raw=raw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["treeshap", "saabas"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_predict_contrib_streamed_equals_predict_contrib(setup, monkeypatch,
                                                         method, engine):
    d, X, jb, tb = setup
    monkeypatch.setenv("MMLSPARK_TPU_SHAP_DEVICE",
                       "1" if engine == "device" else "0")
    got = tb.predict_contrib_streamed(str(d / "x"), chunk_rows=500,
                                      method=method, device="cpu")
    np.testing.assert_array_equal(
        got, tb.predict_contrib(X, method=method, device="cpu"))
    assert got.shape == (3000, 18)


def test_predict_contrib_streamed_checks_method_first(setup, tmp_path):
    d, _, _, tb = setup
    out = tmp_path / "keep"
    out.mkdir()
    np.save(out / "part-00000.npy", np.ones(2))
    with pytest.raises(ValueError, match="unknown contribution method"):
        tb.predict_contrib_streamed(str(d / "x"), method="lime",
                                    out_dir=str(out), device="cpu")
    assert os.listdir(out) == ["part-00000.npy"]


FEATURE_RTOL = 1e-4


@pytest.fixture(scope="module")
def dnn_pair():
    cfg = Jcnn.CNNConfig(num_classes=4, stage_sizes=(1, 1), width=4,
                         input_hw=(16, 16))
    params = jax.tree_util.tree_map(
        np.asarray, Jcnn.init_cnn_params(cfg, jax.random.PRNGKey(3)))
    spec = {"kind": "cnn", "config": {
        "num_classes": 4, "stage_sizes": (1, 1), "width": 4,
        "block": "basic", "input_hw": (16, 16)}}
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="x", outputCol="y", outputNode="pool", miniBatchSize=8)
    return jm, dnn_model_from_jax(jm, device="cpu")


def _close(got, want, rtol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("chunk_rows", [16, 13])
def test_stream_transform_dnn_equals_in_memory(dnn_pair, tmp_path,
                                               chunk_rows):
    jm, tm = dnn_pair
    x = np.random.default_rng(4).normal(size=(45, 16, 16, 3)).astype(
        np.float32)
    write_shards([x[:20], x[20:21], x[21:]], tmp_path / "x")
    got = stream_transform(tm, str(tmp_path / "x"), chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got, tm.transform(Dataset({"x": x}))["y"])
    paths = stream_transform(tm, str(tmp_path / "x"), chunk_rows=chunk_rows,
                             out_dir=str(tmp_path / "out"))
    np.testing.assert_array_equal(
        np.concatenate([np.load(p) for p in paths]), got)
    want = jstreaming.stream_transform(jm, str(tmp_path / "x"),
                                       chunk_rows=chunk_rows)
    _close(got, want, FEATURE_RTOL)


def _png(arr):
    from PIL import Image
    import io as _io
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("batch_files", [4, 64])
def test_stream_featurize_images_equals_in_memory(dnn_pair, tmp_path,
                                                  batch_files):
    jm, tm = dnn_pair
    rng = np.random.default_rng(5)
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    names = []
    for i in range(11):
        h, w = [(30, 24), (24, 30), (17, 19)][i % 3]
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        name = d / ("sub" if i % 4 == 0 else "") / f"im{i:02d}.png"
        name.write_bytes(_png(img))
        names.append(name)
    (d / "im99.png").write_bytes(b"not a png")           # skipped
    kw = dict(inputCol="img", outputCol="f", miniBatchSize=4)
    tf = ImageFeaturizer(tm, input_hw=(16, 16), device="cpu").set(**kw)
    paths, feats = stream_featurize_images(tf, str(d),
                                           batch_files=batch_files)
    assert len(paths) == 11 and not any(p.endswith("im99.png")
                                        for p in paths)
    imgs = [decode_image(open(p, "rb").read()) for p in paths]
    want = tf.transform(Dataset({"img": imgs}))["f"]
    np.testing.assert_array_equal(feats, want)
    kept, shards = stream_featurize_images(tf, str(d),
                                           batch_files=batch_files,
                                           out_dir=str(tmp_path / "o"))
    assert kept == paths
    np.testing.assert_array_equal(
        np.concatenate([np.load(p) for p in shards]), feats)
    jf = JFeaturizer(jm, input_hw=(16, 16)).set(**kw)
    jpaths, jfeats = jstreaming.stream_featurize_images(
        jf, str(d), batch_files=batch_files)
    assert list(jpaths) == list(paths)
    _close(feats, jfeats, FEATURE_RTOL)
    with pytest.raises(ValueError, match="batch_files"):
        stream_featurize_images(tf, str(d), batch_files=0)
