"""Sparse CSR feature columns: the PyTorch port against its dense copy and
against the JAX package.

A scipy CSR matrix in the features column (rows about half zeros) is
densified in row blocks (``booster._densify``) before binning and scoring,
as the JAX package does. For the classifier, the regressor and the ranker
(whose groups are padded after densifying, validation rows included), a
fit on the CSR column must grow the same trees as a fit on its dense copy
and score the same, and the same holds in the JAX package; the port's CSR
fit also grows the JAX package's trees, margins within 1e-5.
``_densify`` itself fills its row blocks exactly (CSR and CSC) and leaves
dense input alone.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import api as JA
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import api as TA
from mmlspark_tpu_torch.models.gbdt import booster as TB

torch.set_num_threads(1)

TREE = ("feat", "thr_bin", "cat_bitset", "left", "right", "is_leaf")
OUTPUT = {"classifier": ("LightGBMClassifier", "probability"),
          "regressor": ("LightGBMRegressor", "prediction"),
          "ranker": ("LightGBMRanker", "prediction")}


def _sparse_rows(n, seed, F=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.uniform(size=(n, F)) < 0.5] = 0.0
    return X


def _columns(kind, seed):
    """Dense feature rows and the other columns of one estimator's data;
    the ranker's rows form 60 query groups of 16 (a power of two: the JAX
    ranker pads none), the last 8 marked validation."""
    X = _sparse_rows(1200 if kind != "ranker" else 960, seed)
    score = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    cols = {}
    if kind == "classifier":
        cols["label"] = (score > 0).astype(np.float32)
    elif kind == "regressor":
        cols["label"] = (score + 0.05 * X[:, 4]).astype(np.float32)
    else:
        rng = np.random.default_rng(seed + 1)
        cols["query"] = np.repeat(np.arange(60), 16)
        cols["label"] = np.digitize(score + 0.3 * rng.normal(size=len(X)),
                                    [-0.5, 0.3, 1.0]).astype(np.float32)
        cols["isVal"] = cols["query"] >= 52
    return X, cols


def _params(kind):
    p = dict(numIterations=3, numLeaves=7, minDataInLeaf=40, maxBin=63)
    if kind == "ranker":
        p.update(groupCol="query", validationIndicatorCol="isVal",
                 minDataInLeaf=20)
    return p


def _assert_same_trees(a, b):
    for f in TREE:
        np.testing.assert_array_equal(a.trees[f], np.asarray(
            b.trees[f] if isinstance(b.trees, dict) else getattr(b.trees, f)),
            err_msg=f)


@pytest.mark.parametrize("kind", sorted(OUTPUT))
def test_csr_fits_and_scores_as_its_dense_copy(kind):
    X, cols = _columns(kind, {"classifier": 0, "regressor": 1,
                              "ranker": 2}[kind])
    csr = sp.csr_matrix(X)
    cls, col = OUTPUT[kind]
    est = getattr(TA, cls)(device="cpu", **_params(kind))
    dense_model = est.fit(TDataset(dict(cols, features=X)))
    sparse_model = est.fit(TDataset(dict(cols, features=csr)))
    _assert_same_trees(sparse_model.booster, dense_model.booster)
    assert sparse_model.booster.eval_history == dense_model.booster.eval_history
    got = sparse_model.transform(TDataset({"features": csr})).array(col)
    np.testing.assert_array_equal(
        got, dense_model.transform(TDataset({"features": X})).array(col))
    # the JAX package: its CSR fit, its dense fit, and the port's agree
    with default_mesh(make_mesh(devices=jax.devices()[:1])):
        jest = getattr(JA, cls)(**_params(kind))
        jsparse = jest.fit(JDataset(dict(cols, features=csr)))
        jdense = jest.fit(JDataset(dict(cols, features=X)))
        jgot = np.asarray(jsparse.transform(
            JDataset({"features": csr}))[col])
    _assert_same_trees(sparse_model.booster, jsparse.booster)
    _assert_same_trees(sparse_model.booster, jdense.booster)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-5)


def test_csr_booster_predict_and_leaves_take_sparse_rows():
    X, cols = _columns("classifier", 3)
    b = TB.train_booster(sp.csr_matrix(X), cols["label"], objective="binary",
                         num_iterations=2, max_bin=63, device="cpu",
                         valid_set=(sp.csr_matrix(X[:100]),
                                    cols["label"][:100], None))
    for fn in (b.predict_raw, b.predict, b.predict_leaf):
        np.testing.assert_array_equal(fn(sp.csr_matrix(X), device="cpu"),
                                      fn(X, device="cpu"))


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_densify_fills_row_blocks_exactly(fmt):
    X = _sparse_rows(5000, 4, F=700)          # two row blocks of 2,995 rows
    got = TB._densify(getattr(sp, f"{fmt}_matrix")(X))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, X)
    assert TB._densify(X) is X
