"""The port's KNN stack (``nn/knn.py``, ``ops/topk.py``) against the JAX
package's.

* ``ops.topk.top_k`` equals ``jax.lax.top_k`` exactly, values and ids, on
  rows full of planted ties (small integers, ``-inf`` cells), largest and
  smallest, k from 1 to n, and with the crowded rows re-sorted in several
  chunks.
* ``KNN`` on rows with distinct distances: ids equal, distances within
  1e-5 relative (the f32 products round in another order); on integer
  rows whose distances tie (and are exact in f32), the whole output is
  equal, ties in ``lax.top_k``'s order. ``ConditionalKNN`` the same, with
  queries that allow fewer than k matches.
* ``BallTree`` (host float64, copied) returns exactly what the JAX one
  returns.
* Model directories saved by the JAX package (``index.npy`` with
  ``values.pkl`` or ``payload.pkl``) load in the port and transform equal;
  ``knn_from_jax`` builds equal models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.nn import knn as jknn
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.nn import knn as tknn
from mmlspark_tpu_torch.ops import topk as ttopk

torch.set_num_threads(1)

DIST_RTOL = 1e-5


def _tied(seed, q, n, levels, neg_inf=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels, size=(q, n)).astype(np.float32)
    if neg_inf:
        x[rng.random((q, n)) < 0.3] = -np.inf
    return x


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("largest", [True, False])
def test_top_k_equals_lax_top_k_on_ties(seed, largest):
    rng = np.random.default_rng(100 + seed)
    q, n = int(rng.integers(1, 24)), int(rng.integers(1, 400))
    x = _tied(seed, q, n, int(rng.integers(1, 6)), neg_inf=seed % 2 == 0)
    for k in sorted({1, int(rng.integers(1, n + 1)), n}):
        sign = 1.0 if largest else -1.0
        jv, ji = jax.lax.top_k(jnp.asarray(sign * x), k)
        tv, ti = ttopk.top_k(torch.as_tensor(x), k, largest=largest)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), sign * np.asarray(jv))


def test_top_k_crowded_rows_in_chunks(monkeypatch):
    x = _tied(3, 40, 300, 3)
    want = jax.lax.top_k(jnp.asarray(x), 17)
    monkeypatch.setattr(ttopk, "_RESORT_ELEMENTS", 700)   # two rows a chunk
    tv, ti = ttopk.top_k(torch.as_tensor(x), 17)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[0]))


def _fit_pair(index, k=7, bs=32, labels=None, **kw):
    cols = {"features": index}
    if labels is not None:
        cols["label"] = labels
        j = jknn.ConditionalKNN(k=k, blockSize=bs, **kw)
        t = tknn.ConditionalKNN(k=k, blockSize=bs, device="cpu", **kw)
    else:
        j = jknn.KNN(k=k, blockSize=bs, **kw)
        t = tknn.KNN(k=k, blockSize=bs, device="cpu", **kw)
    return j.fit(JDataset(dict(cols))), t.fit(Dataset(dict(cols)))


def _ids(matches):
    return [[m["value"] for m in row] for row in matches]


def test_knn_distinct_distances_ids_equal():
    rng = np.random.default_rng(0)
    index = rng.normal(size=(700, 12)).astype(np.float32)
    q = rng.normal(size=(90, 12)).astype(np.float32)
    jm, tm = _fit_pair(index, k=9, bs=40)
    jo = jm.transform(JDataset({"features": q}))["matches"]
    to = tm.transform(Dataset({"features": q}))["matches"]
    assert _ids(to) == _ids(jo)
    jd = np.array([[m["distance"] for m in r] for r in jo])
    td = np.array([[m["distance"] for m in r] for r in to])
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL)


@pytest.mark.parametrize("k", [1, 7, 500])
def test_knn_planted_ties_equal(k):
    """Integer rows: squared distances are exact small integers in f32 on
    both sides and tie often; ids come out in ``lax.top_k``'s order."""
    rng = np.random.default_rng(1)
    index = rng.integers(0, 3, size=(500, 6)).astype(np.float32)
    q = rng.integers(0, 3, size=(70, 6)).astype(np.float32)
    values = [f"v{i}" for i in range(500)]
    cols = {"features": index, "values": values}
    jm = jknn.KNN(k=k, blockSize=32).fit(JDataset(dict(cols)))
    tm = tknn.KNN(k=k, blockSize=32, device="cpu").fit(Dataset(dict(cols)))
    jo = jm.transform(JDataset({"features": q}))["matches"]
    to = tm.transform(Dataset({"features": q}))["matches"]
    assert to == jo


def test_conditional_knn_equal_with_short_rows():
    rng = np.random.default_rng(2)
    index = rng.integers(0, 4, size=(400, 8)).astype(np.float32)
    labels = list(rng.choice(["a", "b", "c", "d", "rare"], size=400,
                             p=[0.3, 0.3, 0.2, 0.19, 0.01]))
    q = rng.integers(0, 4, size=(60, 8)).astype(np.float32)
    conds = [list(rng.choice(["a", "b", "c", "d"], 2, replace=False))
             for _ in range(50)] + [["rare"]] * 5 + ["b"] * 4 + [["none"]]
    jm, tm = _fit_pair(index, k=9, bs=16, labels=labels)
    jo = jm.transform(JDataset({"features": q, "conditioner": conds}))
    to = tm.transform(Dataset({"features": q, "conditioner": conds}))
    assert to["matches"] == jo["matches"]
    assert min(len(r) for r in to["matches"]) < 9     # fewer allowed than k
    assert to["matches"][-1] == []


def test_ball_tree_equals_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(3000, 6)) + 50.0
    q = rng.normal(size=(400, 6)) + 50.0
    ji, jd = jknn.BallTree(pts, leaf_size=16).query_batch(q, k=5)
    ti, td = tknn.BallTree(pts, leaf_size=16).query_batch(q, k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    d = np.sqrt(((q[:, None, :] - pts[None]) ** 2).sum(-1))
    np.testing.assert_allclose(td, np.sort(d, axis=1)[:, :5], rtol=1e-12)
    assert tknn.BallTree(pts).query(q[0], k=3) == jknn.BallTree(pts).query(
        q[0], k=3)


def test_jax_saved_models_load_and_transform_equal(tmp_path):
    rng = np.random.default_rng(4)
    index = rng.integers(0, 3, size=(300, 5)).astype(np.float32)
    q = rng.integers(0, 3, size=(40, 5)).astype(np.float32)
    labels = list(rng.integers(0, 3, size=300))
    conds = [[0, 2]] * 40
    jm, _ = _fit_pair(index, k=6)
    jc, _ = _fit_pair(index, k=6, labels=labels)
    jm.save(str(tmp_path / "knn"))
    jc.save(str(tmp_path / "cknn"))
    tm = PipelineStage.load(str(tmp_path / "knn")).set(device="cpu")
    tc = PipelineStage.load(str(tmp_path / "cknn")).set(device="cpu")
    assert type(tm) is tknn.KNNModel
    assert type(tc) is tknn.ConditionalKNNModel
    assert (tm.transform(Dataset({"features": q}))["matches"]
            == jm.transform(JDataset({"features": q}))["matches"])
    cols = {"features": q, "conditioner": conds}
    assert (tc.transform(Dataset(dict(cols)))["matches"]
            == jc.transform(JDataset(dict(cols)))["matches"])
    fm = tknn.knn_from_jax(jm.index, jm.values, None,
                           jm.extract_param_map(), device="cpu")
    fc = tknn.knn_from_jax(jc.index, jc.values, jc.labels,
                           jc.extract_param_map(), device="cpu")
    assert type(fc) is tknn.ConditionalKNNModel
    assert (fm.transform(Dataset({"features": q}))["matches"]
            == jm.transform(JDataset({"features": q}))["matches"])
    assert (fc.transform(Dataset(dict(cols)))["matches"]
            == jc.transform(JDataset(dict(cols)))["matches"])
