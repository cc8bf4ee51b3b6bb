"""The port's LIME (``mmlspark_tpu_torch/explain/lime.py``) against the JAX
package's, on the CPU, with the same seeds.

LIME is host numpy in both packages, so over an inner model that scores
the same in both (a numpy function on the columns), every output is equal:
the lasso's coefficients, the superpixel maps, TabularLIME's fitted
statistics and coefficients, ImageLIME's and TextLIME's coefficients and
their side columns. Over a ``DNNModel`` (the port's on the CPU against the
JAX package's on the same params), ImageLIME's coefficients agree within
1e-4 of their largest magnitude: the two forwards' f32 scores differ by
about 1e-6 relative, and the lasso carries that through its coordinate
sweeps (1.9e-7 measured).
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.explain import lime as J
from mmlspark_tpu.models.dnn import cnn as Jcnn
from mmlspark_tpu.models.dnn.scoring import DNNModel as JDNNModel
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.explain import lime as T
from mmlspark_tpu_torch.models.dnn.convert import dnn_model_from_jax

torch.set_num_threads(1)

DNN_COEF_RTOL = 1e-4


class _Scorer:
    """An inner model both packages can call: ``fn`` of the input column
    (stacked to an array, or the raw list of strings) into ``outCol``."""

    def __init__(self, fn, in_col, out_col="probability", text=False):
        self.fn, self.in_col, self.out_col, self.text = (fn, in_col,
                                                         out_col, text)

    def transform(self, ds):
        col = ds[self.in_col]
        x = list(col) if self.text else np.stack([np.asarray(v) for v in col])
        return ds.with_column(self.out_col, self.fn(x))


def _proba(x):
    z = x.reshape(len(x), -1) @ np.linspace(-1, 1, x[0].size) / x[0].size
    p = 1.0 / (1.0 + np.exp(-z))
    return np.stack([1 - p, p], axis=1)


@pytest.mark.parametrize("alpha,weighted", [(0.01, False), (0.001, True),
                                            (0.2, True)])
def test_lasso_equal(alpha, weighted):
    rng = np.random.default_rng(0)
    X = (rng.random((200, 12)) < 0.6).astype(np.float64)
    y = X @ rng.normal(size=12) + 0.1 * rng.normal(size=200)
    w = rng.random(200) if weighted else None
    np.testing.assert_array_equal(
        T.lasso_coordinate_descent(X, y, w, alpha),
        J.lasso_coordinate_descent(X, y, w, alpha))


@pytest.mark.parametrize("cell,modifier,hw", [(16.0, 130.0, (48, 40)),
                                              (8.0, 50.0, (23, 31))])
def test_superpixels_equal(cell, modifier, hw):
    img = np.random.default_rng(1).random((*hw, 3)).astype(np.float32) * 255
    img[: hw[0] // 2] *= 0.2           # a dark half: clusters follow it
    want = J.Superpixel(cell, modifier).cluster(img)
    got = T.Superpixel(cell, modifier).cluster(img)
    np.testing.assert_array_equal(got, want)
    jt = J.SuperpixelTransformer().set(inputCol="i", outputCol="s",
                                       cellSize=cell, modifier=modifier)
    tt = T.SuperpixelTransformer().set(inputCol="i", outputCol="s",
                                       cellSize=cell, modifier=modifier)
    for g, w in zip(tt.transform(Dataset({"i": [img, img[::-1]]}))["s"],
                    jt.transform(JDataset({"i": [img, img[::-1]]}))["s"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kernel_width", [0.0, 0.75])
def test_tabular_lime_equal(kernel_width):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(60, 5)).astype(np.float32)
    kw = dict(inputCol="x", outputCol="w", nSamples=300, seed=4,
              kernelWidth=kernel_width)
    jm = J.TabularLIME(model=_Scorer(_proba, "x")).set(**kw).fit(
        JDataset({"x": X}))
    tm = T.TabularLIME(model=_Scorer(_proba, "x")).set(**kw).fit(
        Dataset({"x": X}))
    np.testing.assert_array_equal(tm.get_or_default("columnMeans"),
                                  jm.get_or_default("columnMeans"))
    np.testing.assert_array_equal(tm.get_or_default("columnSTDs"),
                                  jm.get_or_default("columnSTDs"))
    np.testing.assert_array_equal(tm.transform(Dataset({"x": X[:4]}))["w"],
                                  jm.transform(JDataset({"x": X[:4]}))["w"])


def test_image_lime_equal_on_a_host_model():
    rng = np.random.default_rng(3)
    imgs = [rng.random((32, 24, 3)).astype(np.float32) * 255,
            rng.random((20, 20, 3)).astype(np.float32) * 255]
    kw = dict(inputCol="img", outputCol="w", superpixelCol="sp",
              nSamples=200, cellSize=8.0, seed=1)
    want = J.ImageLIME(model=_Scorer(_proba, "img")).set(**kw).transform(
        JDataset({"img": imgs}))
    got = T.ImageLIME(model=_Scorer(_proba, "img")).set(**kw).transform(
        Dataset({"img": imgs}))
    for c in ("w", "sp"):
        for g, w in zip(got[c], want[c]):
            np.testing.assert_array_equal(g, w)


def test_image_lime_over_dnn_models_agrees():
    cfg = Jcnn.CNNConfig(num_classes=3, stage_sizes=(1, 1), width=4,
                         input_hw=(24, 24))
    params = jax.tree_util.tree_map(
        np.asarray, Jcnn.init_cnn_params(cfg, jax.random.PRNGKey(6)))
    spec = {"kind": "cnn", "config": {
        "num_classes": 3, "stage_sizes": (1, 1), "width": 4,
        "block": "basic", "input_hw": (24, 24)}}
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="img", outputCol="probability", outputNode="logits",
        miniBatchSize=64)
    tm = dnn_model_from_jax(jm, device="cpu")
    rng = np.random.default_rng(5)
    imgs = [rng.normal(size=(24, 24, 3)).astype(np.float32)]
    kw = dict(inputCol="img", outputCol="w", nSamples=150, cellSize=6.0,
              seed=2)
    want = J.ImageLIME(model=jm).set(**kw).transform(
        JDataset({"img": imgs}))["w"][0]
    got = T.ImageLIME(model=tm).set(**kw).transform(
        Dataset({"img": imgs}))["w"][0]
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DNN_COEF_RTOL * np.abs(want).max())


def test_text_lime_equal():
    def score(texts):
        s = np.array([t.count("good") - t.count("bad") + 0.1 * len(t.split())
                      for t in texts], np.float64)
        return s

    texts = ["a good movie with a bad ending", "bad bad good",
             "nothing here"]
    kw = dict(inputCol="t", outputCol="w", tokensCol="tok", nSamples=120,
              seed=3, predictionCol="score")
    want = J.TextLIME(model=_Scorer(score, "t", "score", text=True)).set(
        **kw).transform(JDataset({"t": texts}))
    got = T.TextLIME(model=_Scorer(score, "t", "score", text=True)).set(
        **kw).transform(Dataset({"t": texts}))
    assert got["tok"] == want["tok"]
    for g, w in zip(got["w"], want["w"]):
        np.testing.assert_array_equal(g, w)
