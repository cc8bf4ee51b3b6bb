"""The port's SAR and ranking tools (``recommendation/``) against the JAX
package's.

* ``SAR`` (dense path; every similarity function; time decay): similarity
  and affinity bit-equal (the co-occurrence counts are exact on both
  sides, the rest is the same numpy); ``transform`` scores within 1e-6
  relative (f32 dot products summed in another order);
  ``recommend_for_all_users`` equal ids and ratings, including the
  zero-score and ``-inf`` (seen) ties, which come out in ``lax.top_k``'s
  order.
* The sparse path (``DENSE_CELLS_MAX = 0`` in both packages): similarity,
  scores and recommendations equal to the JAX package's.
* ``RecommendationIndexer``, ``RankingEvaluator`` (every metric),
  ``RankingAdapter`` and ``RankingTrainValidationSplit`` (the split and
  its ``validationMetrics``): equal.
* Model directories saved by the JAX package (``sar.npz``;
  ``sar_sim.npz``/``sar_aff.npz``/``sar_seen.npz``) load in the port and
  score equal; ``sar_from_jax`` builds an equal model.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.recommendation import ranking as jrank
from mmlspark_tpu.recommendation import sar as jsar
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.recommendation import ranking as trank
from mmlspark_tpu_torch.recommendation import sar as tsar

torch.set_num_threads(1)

SCORE_RTOL = 1e-6


def _clustered(seed=0, n_users=30, liked=6):
    """Two taste clusters of 10 items each: a user's unseen items of the
    other cluster all score 0, so a top-k past the own cluster's unseen
    items is decided by the zero ties."""
    rng = np.random.default_rng(seed)
    u, it = [], []
    for user in range(n_users):
        pool = np.arange(10) + (0 if user < n_users // 2 else 10)
        for i in rng.choice(pool, liked, replace=False):
            u.append(user)
            it.append(int(i))
    n = len(u)
    return {"user_idx": np.asarray(u, np.int32),
            "item_idx": np.asarray(it, np.int32),
            "rating": rng.integers(1, 6, n).astype(np.float32),
            "ts": rng.uniform(0, 90 * 86400.0, n)}


def _skewed(seed=1, n_users=60, n_items=40, n=900):
    rng = np.random.default_rng(seed)
    return {"user_idx": rng.integers(0, n_users, n).astype(np.int32),
            "item_idx": np.minimum(rng.zipf(1.5, n) - 1,
                                   n_items - 1).astype(np.int32),
            "rating": rng.integers(1, 6, n).astype(np.float32),
            "ts": rng.uniform(0, 3e7, n)}


def _fit_both(cols, **kw):
    jm = jsar.SAR(**kw).fit(JDataset(dict(cols)))
    tm = tsar.SAR(device="cpu", **kw).fit(Dataset(dict(cols)))
    return jm, tm


def _recs(model, k):
    r = model.recommend_for_all_users(k)
    return (np.stack(r["recommendations"]), np.stack(r["ratings"]),
            np.asarray(r["user_idx"]))


def _assert_same_model(jm, tm, cols, k):
    dense = isinstance(jm.userAffinity, np.ndarray)
    for a in ("itemSimilarity", "userAffinity", "seen"):
        j, t = getattr(jm, a), getattr(tm, a)
        if not dense:
            j, t = j.toarray(), t.toarray()
        assert t.dtype == j.dtype, a
        np.testing.assert_array_equal(t, j)
    js = jm.transform(JDataset(dict(cols))).array("prediction")
    ts = tm.transform(Dataset(dict(cols))).array("prediction")
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL, atol=1e-30)
    ji, jv, ju = _recs(jm, k)
    ti, tv, tu = _recs(tm, k)
    assert ti.dtype == ji.dtype
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=SCORE_RTOL, atol=0)
    return jv


@pytest.mark.parametrize("fn", ["cooccurrence", "jaccard", "lift"])
@pytest.mark.parametrize("data", ["clustered", "skewed"])
def test_dense_sar_equal(fn, data):
    cols = _clustered() if data == "clustered" else _skewed()
    jm, tm = _fit_both(cols, similarityFunction=fn, supportThreshold=2,
                       timeCol="ts")
    jv = _assert_same_model(jm, tm, cols, k=8)
    if data == "clustered":
        assert (jv == 0).sum() > 50        # the zero ties were exercised


def test_recommendations_equal_through_seen_ties():
    """k past every unseen item: the seen items (-inf) fill the tail, in
    id order; with removeSeenItems off their scores do."""
    cols = _clustered(seed=3)
    jm, tm = _fit_both(cols, supportThreshold=3)
    jv = _assert_same_model(jm, tm, cols, k=18)
    assert np.isneginf(jv).sum() > 0
    jm.set(removeSeenItems=False)
    tm.set(removeSeenItems=False)
    _assert_same_model(jm, tm, cols, k=18)


@pytest.mark.parametrize("fn", ["cooccurrence", "jaccard", "lift"])
def test_sparse_path_equal(fn, monkeypatch):
    monkeypatch.setattr(jsar, "DENSE_CELLS_MAX", 0)
    monkeypatch.setattr(tsar, "DENSE_CELLS_MAX", 0)
    cols = _clustered()
    jm, tm = _fit_both(cols, similarityFunction=fn, supportThreshold=2,
                       timeCol="ts")
    assert not isinstance(tm.userAffinity, np.ndarray)
    _assert_same_model(jm, tm, cols, k=8)


def test_indexer_equal():
    cols = {"user": ["alice", "bob", "alice", "carol"],
            "item": ["x", "y", "y", "z"]}
    jm = jsar.RecommendationIndexer().fit(JDataset(dict(cols)))
    tm = tsar.RecommendationIndexer().fit(Dataset(dict(cols)))
    probe = {"user": ["carol", "dave", "bob"], "item": ["y", "x", "z"]}
    jo = jm.transform(JDataset(dict(probe)))
    to = tm.transform(Dataset(dict(probe)))
    for c in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(to.array(c), jo.array(c))
    assert tm.recover_item(2) == jm.recover_item(2) == "z"


@pytest.mark.parametrize("metric", ["ndcgAt", "map", "precisionAtk",
                                    "recallAtK", "diversityAtK",
                                    "maxDiversity"])
def test_ranking_evaluator_equal(metric):
    rng = np.random.default_rng(5)
    recs = [list(rng.choice(30, 10, replace=False)) for _ in range(25)]
    labels = [list(rng.choice(30, int(rng.integers(0, 8)), replace=False))
              for _ in range(25)]
    cols = {"recommendations": recs, "labels": labels}
    for k in (3, 10):
        j = jrank.RankingEvaluator(metricName=metric, k=k, nItems=30)
        t = trank.RankingEvaluator(metricName=metric, k=k, nItems=30)
        assert (t.evaluate(Dataset(dict(cols)))
                == j.evaluate(JDataset(dict(cols))))
    assert (trank.RankingEvaluator(metricName=metric).transform(
        Dataset(dict(cols))).array(metric)[0]
        == jrank.RankingEvaluator(metricName=metric).transform(
            JDataset(dict(cols))).array(metric)[0])


def test_split_adapter_and_validation_metrics_equal():
    cols = _skewed(seed=7, n=1500)
    kw = dict(trainRatio=0.7, minRatingsPerUser=3, minRatingsPerItem=2,
              seed=11)
    jsplit = jrank.RankingTrainValidationSplit(
        estimator=jrank.RankingAdapter(jsar.SAR(supportThreshold=2), k=5),
        **kw)
    tsplit = trank.RankingTrainValidationSplit(
        estimator=trank.RankingAdapter(
            tsar.SAR(supportThreshold=2, device="cpu"), k=5), **kw)
    jtr, jva = jsplit.split(JDataset(dict(cols)))
    ttr, tva = tsplit.split(Dataset(dict(cols)))
    for c in cols:
        np.testing.assert_array_equal(ttr.array(c), jtr.array(c))
        np.testing.assert_array_equal(tva.array(c), jva.array(c))
    jfit = jsplit.fit(JDataset(dict(cols)))
    tfit = tsplit.fit(Dataset(dict(cols)))
    assert tsplit.get_or_default("validationMetrics") == jsplit.get_or_default(
        "validationMetrics")
    assert tsplit.get_or_default("validationMetrics")[0] > 0
    jo, to = jfit.transform(jva), tfit.transform(tva)
    assert list(map(list, to["recommendations"])) == list(
        map(list, jo["recommendations"]))
    assert list(to["labels"]) == list(jo["labels"])


@pytest.mark.parametrize("sparse", [False, True])
def test_jax_saved_model_loads_and_scores_equal(sparse, tmp_path,
                                                monkeypatch):
    if sparse:
        monkeypatch.setattr(jsar, "DENSE_CELLS_MAX", 0)
    cols = _clustered(seed=9)
    jm = jsar.SAR(supportThreshold=2, timeCol="ts").fit(JDataset(dict(cols)))
    jm.save(str(tmp_path / "sar"))
    tm = PipelineStage.load(str(tmp_path / "sar")).set(device="cpu")
    assert type(tm) is tsar.SARModel
    assert sparse == (not isinstance(tm.userAffinity, np.ndarray))
    _assert_same_model(jm, tm, cols, k=8)
    fm = tsar.sar_from_jax(jm.itemSimilarity, jm.userAffinity, jm.seen,
                           jm.extract_param_map(), device="cpu")
    _assert_same_model(jm, fm, cols, k=8)
