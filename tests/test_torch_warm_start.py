"""Warm starts, checkpoint resume and the binned-dataset cache.

Against the JAX package on the CPU (its side on a one-device mesh), with
seeded binary rows:

  * ``modelString`` warm starts through the classifier, from a model of
    another leaf count (the merge widens node slots) in this package's
    JSON and in LightGBM's text format: trees identical, margins within
    1e-5;
  * ``numBatches=2``: two sequential batches, each binned from its own
    rows and warm-started from the one before;
  * ``train_booster(init_booster=...)`` with a validation set and early
    stopping, which records ``best_iteration`` and keeps every tree.

In the port alone: a fit of 6 iterations checkpointed every 3, then the
same fit asked for 12, equals the uninterrupted 12-iteration fit bit for
bit (with bagging, ``featureFraction`` and quantized trees too, and with a
validation set whose early-stopping state resumes); a checkpoint that
already covers the request is returned cut to it; a checkpoint of other
data is ignored; ``CheckpointManager`` prunes, isolates namespaces and
refuses in strict mode; ``data_fingerprint`` equals the JAX package's.
The cache: a hit returns the same dataset, any binning param or the
device (cpu against cuda, by its key alone here) misses, two entries are
kept, the estimators use it without ``checkpointDir``. ``initScoreCol``
is accepted and not read, as in the JAX package.
"""

import os

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu.utils import checkpoint as JC
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import api as TA
from mmlspark_tpu_torch.models.gbdt import booster as TB
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")


def _binary(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float32)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _assert_same_fit(jb, tb, X):
    assert tb.num_trees == jb.num_trees
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def _assert_identical(a, b):
    """Two port boosters, bit for bit."""
    assert a.num_trees == b.num_trees
    for f in a.trees:
        np.testing.assert_array_equal(a.trees[f], b.trees[f], err_msg=f)
    np.testing.assert_array_equal(a.thr_raw, b.thr_raw)
    np.testing.assert_array_equal(a.base_score, b.base_score)


@pytest.fixture(scope="module")
def data():
    return _binary(1999, 0)


@pytest.fixture(scope="module")
def prior(data):
    """A 15-leaf port model of 3 iterations to warm-start from."""
    X, y = data
    return TB.train_booster(X, y, objective="binary", num_iterations=3,
                            max_bin=63, cfg=TG.GrowConfig(num_leaves=15,
                                                          min_data_in_leaf=60),
                            device="cpu")


@pytest.mark.parametrize("fmt", ["json", "lightgbm"])
def test_model_string_warm_start_matches_jax(fmt, data, prior):
    X, y = data
    ms = (prior.model_string() if fmt == "json"
          else prior.to_lightgbm_string())
    kw = dict(numIterations=3, numLeaves=7, maxBin=63, minDataInLeaf=100,
              modelString=ms)
    cols = {"features": X, "label": y}
    tb = LightGBMClassifier(device="cpu", **kw).fit(TDataset(cols)).booster
    with default_mesh(_mesh()):
        jb = JClassifier(**kw).fit(JDataset(cols)).booster
    _assert_same_fit(jb, tb, X)
    assert tb.num_iterations == 6 and tb.trees["feat"].shape[1] == 29
    # the new 13-slot trees are padded with inert leaves to the prior's 29
    assert tb.trees["is_leaf"][3:, 13:].all()
    if fmt == "json":
        np.testing.assert_array_equal(tb.trees["feat"][:3],
                                      prior.trees["feat"])


@pytest.mark.parametrize("warm", [False, True])
def test_num_batches_matches_jax(warm, data, prior):
    X, y = data
    kw = dict(numIterations=2, numLeaves=7, maxBin=63, minDataInLeaf=60,
              numBatches=2)
    if warm:
        kw["modelString"] = prior.model_string()
    cols = {"features": X, "label": y}
    tb = LightGBMClassifier(device="cpu", **kw).fit(TDataset(cols)).booster
    with default_mesh(_mesh()):
        jb = JClassifier(**kw).fit(JDataset(cols)).booster
    _assert_same_fit(jb, tb, X)
    assert tb.num_iterations == 4 + (3 if warm else 0)


def test_init_booster_with_early_stopping_matches_jax(data, prior):
    X, y = data
    Xv, yv = _binary(600, 1)
    cfg = dict(num_leaves=7, min_data_in_leaf=100, learning_rate=0.5)
    kw = dict(objective="binary", num_iterations=8, max_bin=63,
              valid_set=(Xv, yv, None), early_stopping_rounds=2)
    tb = TB.train_booster(X, y, cfg=TG.GrowConfig(**cfg), device="cpu",
                          init_booster=prior, **kw)
    jb = jtrain(X, y, cfg=JG.GrowConfig(**cfg), mesh=_mesh(),
                init_booster=JBooster.from_string(prior.model_string()), **kw)
    _assert_same_fit(jb, tb, X)
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.eval_history["binary_logloss"],
                               jb.eval_history["binary_logloss"], rtol=1e-6)
    # a caller's warm start keeps every tree it grew
    assert tb.num_iterations == 3 + len(tb.eval_history["binary_logloss"])


RESUME = {
    "plain": dict(),
    "sampled": dict(bagging_fraction=0.7, bagging_freq=2,
                    feature_fraction=0.8,
                    cfg=TG.GrowConfig(num_leaves=7, quantized_grad=True,
                                      quant_warmup_iters=1)),
}


def _ckpt_fit(X, y, directory, iterations, **kw):
    args = dict(objective="binary", max_bin=63, seed=4,
                cfg=TG.GrowConfig(num_leaves=7), checkpoint_dir=directory,
                checkpoint_period=3, device="cpu")
    args.update(kw)
    return TB.train_booster(X, y, num_iterations=iterations, **args)


@pytest.mark.parametrize("mode", sorted(RESUME))
def test_resume_equals_the_uninterrupted_fit(mode, data, tmp_path):
    X, y = data
    whole = _ckpt_fit(X, y, str(tmp_path / "a"), 12, **RESUME[mode])
    assert TC.CheckpointManager(str(tmp_path / "a")).steps() == [2, 5, 8]
    _ckpt_fit(X, y, str(tmp_path / "b"), 6, **RESUME[mode])
    mgr = TC.CheckpointManager(str(tmp_path / "b"))
    assert mgr.steps() == [2]             # it + 1 < 6 is never true at 5
    payload = mgr.load(2)
    assert payload["scores"].shape == (len(y), 1)
    assert payload["prior_iterations"] == 0
    resumed = _ckpt_fit(X, y, str(tmp_path / "b"), 12, **RESUME[mode])
    _assert_identical(resumed, whole)
    # a checkpoint past the request is returned cut to it
    cut = _ckpt_fit(X, y, str(tmp_path / "a"), 4, **RESUME[mode])
    _assert_identical(cut, TB._truncate_booster(whole, 4))


def test_sampled_resume_grows_the_jax_fit(data, tmp_path):
    """A sampled, quantized fit resumed from its iteration-2 checkpoint
    draws iteration ``it``'s bag, feature subset and rounding under the
    JAX package's keys for that ``it`` (no replay): the JAX package's
    uninterrupted fit, margins within 1e-5."""
    X, y = data
    kw = dict(RESUME["sampled"])
    cfg = kw.pop("cfg")
    _ckpt_fit(X, y, str(tmp_path / "b"), 6, cfg=cfg, **kw)
    resumed = _ckpt_fit(X, y, str(tmp_path / "b"), 12, cfg=cfg, **kw)
    jb = jtrain(X, y, objective="binary", num_iterations=12, max_bin=63,
                seed=4, cfg=JG.GrowConfig(num_leaves=7, quantized_grad=True,
                                          quant_warmup_iters=1),
                mesh=_mesh(), **kw)
    _assert_same_fit(jb, resumed, X)


def test_sampled_warm_start_matches_jax(data, prior):
    """A ``modelString`` warm start folds iterations 0, 1, ... of the new
    fit into its keys, as the JAX package does."""
    X, y = data
    kw = dict(numIterations=3, numLeaves=7, maxBin=63, minDataInLeaf=100,
              modelString=prior.model_string(), featureFraction=0.6,
              baggingFraction=0.8, baggingFreq=1, useQuantizedGrad=True,
              quantWarmupIters=1, baggingSeed=5)
    cols = {"features": X, "label": y}
    tb = LightGBMClassifier(device="cpu", **kw).fit(TDataset(cols)).booster
    with default_mesh(_mesh()):
        jb = JClassifier(**kw).fit(JDataset(cols)).booster
    _assert_same_fit(jb, tb, X)


def test_resume_restores_early_stopping_state(data, tmp_path):
    X, y = data
    Xv, yv = _binary(500, 2)
    kw = dict(valid_set=(Xv, yv, None), early_stopping_rounds=3,
              cfg=TG.GrowConfig(num_leaves=7, learning_rate=0.8))
    whole = _ckpt_fit(X, y, str(tmp_path / "a"), 12, **kw)
    _ckpt_fit(X, y, str(tmp_path / "b"), 6, **kw)
    resumed = _ckpt_fit(X, y, str(tmp_path / "b"), 12, **kw)
    _assert_identical(resumed, whole)
    assert resumed.best_iteration == whole.best_iteration
    assert resumed.eval_history == whole.eval_history


def test_stale_checkpoint_is_ignored(data, tmp_path):
    X, y = data
    X2, y2 = _binary(1999, 9)
    d = str(tmp_path / "ck")
    _ckpt_fit(X, y, d, 6)
    fresh = TB.train_booster(X2, y2, objective="binary", num_iterations=6,
                             max_bin=63, seed=4,
                             cfg=TG.GrowConfig(num_leaves=7), device="cpu")
    _assert_identical(_ckpt_fit(X2, y2, d, 6), fresh)
    # each run keeps its own namespace: the first run's file survives
    names = sorted(os.listdir(d))
    assert len(names) == 2 and names[0][:17] != names[1][:17]


def test_checkpoint_manager_prunes_isolates_and_refuses(tmp_path):
    d = str(tmp_path)
    a = TC.CheckpointManager(d, keep=2, namespace="aaaa")
    b = TC.CheckpointManager(d, namespace="bbbb")
    for step in range(4):
        a.save(step, {"fingerprint": "fa", "v": step})
    b.save(0, {"fingerprint": "fb"})
    assert a.steps() == [2, 3] and b.steps() == [0]
    assert a.latest()[1]["v"] == 3 and a.latest_matching("fa")[0] == 3
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    # the un-namespaced view sees every file; strict mode refuses a
    # directory whose files all mismatch and deletes nothing
    every = TC.CheckpointManager(d)
    assert every.steps() == [0, 2, 3]
    with pytest.raises(TC.CheckpointMismatchError, match="fz"):
        every.latest_matching("fz", strict=True)
    assert len(os.listdir(d)) == 3
    # a mismatching file in the manager's own view is purged
    assert a.latest_matching("other") is None and a.steps() == []
    assert b.steps() == [0]


def test_data_fingerprint_matches_jax():
    rng = np.random.default_rng(3)
    small = rng.normal(size=(50, 4)).astype(np.float32)
    large = rng.normal(size=(300_000,)).astype(np.float32)   # paged + crc
    cfg = ("binary", 1, 255, (1, 2), None, 0.5)
    for arrays in ((small,), (large, None, small)):
        assert (TC.data_fingerprint(*arrays, config=cfg)
                == JC.data_fingerprint(*arrays, config=cfg))
    changed = large.copy()
    changed[150_001] += 1.0                 # one byte off every sampled page
    assert TC.data_fingerprint(changed) != TC.data_fingerprint(large)


def test_num_batches_checkpoint_directories(data, tmp_path):
    X, y = data
    d = str(tmp_path / "ck")
    LightGBMClassifier(device="cpu", numIterations=4, numLeaves=7,
                       maxBin=63, numBatches=2, checkpointDir=d,
                       checkpointInterval=2).fit(
        TDataset({"features": X, "label": y}))
    assert sorted(os.listdir(d)) == ["batch_0000", "batch_0001"]
    for sub in os.listdir(d):
        assert TC.CheckpointManager(os.path.join(d, sub)).steps() == [1]


def _cache_kw(**kw):
    args = dict(max_bin=63, bin_sample_count=200_000, seed=3,
                categorical_features=(), bin_dtype="int32",
                max_bin_by_feature=None, device="cpu")
    args.update(kw)
    return args


def test_binned_cache_hits_and_misses(data, monkeypatch):
    X, y = data
    TA.clear_binned_dataset_cache()
    built = []
    real = TB.LightGBMDataset.construct
    monkeypatch.setattr(TB.LightGBMDataset, "construct",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    ds = TA._cached_binned_dataset(X, y, None, **_cache_kw())
    assert TA._cached_binned_dataset(X.copy(), y, None, **_cache_kw()) is ds
    assert len(built) == 1
    for change in (dict(max_bin=31), dict(seed=4), dict(bin_dtype="uint8"),
                   dict(categorical_features=(1,))):
        assert TA._cached_binned_dataset(X, y, None,
                                         **_cache_kw(**change)) is not ds
    assert len(built) == 5 and len(TA._BINNED_CACHE) == 2
    w = np.ones_like(y)
    key = TA._binned_cache_key(X, y, w, **_cache_kw())
    assert key != TA._binned_cache_key(X, y, None, **_cache_kw())
    # the device is part of the key: a cpu fit never gets a cuda dataset
    assert key != TA._binned_cache_key(X, y, w, **_cache_kw(device="cuda"))
    assert key[-1] == "cpu"
    TA.clear_binned_dataset_cache()
    assert not TA._BINNED_CACHE


@pytest.mark.parametrize("chunk", [1 << 26, 4096], ids=["one-piece",
                                                        "threaded-chunks"])
def test_binned_cache_content_key_sees_every_byte(data, monkeypatch, chunk):
    """The cache key's content hash (crc32 of each chunk, chunks hashed on
    threads) is equal for equal rows and moves with one changed byte
    anywhere, with the split between the arrays, and with None."""
    monkeypatch.setattr(TA, "_KEY_CHUNK", chunk)
    X, y = data
    key = TA._content_key(X, y, None)
    assert key == TA._content_key(X.copy(), y.copy(), None)
    for i in (0, X.size // 2, X.size - 1):
        Z = X.copy().reshape(-1)
        Z[i] = np.nextafter(Z[i], np.float32(np.inf))
        assert TA._content_key(Z.reshape(X.shape), y, None) != key
    assert TA._content_key(X, y, np.ones_like(y)) != key
    assert TA._content_key(X, None, y) != TA._content_key(X, y, None)
    assert TA._content_key(X[:, :2], X[:, 2:]) != TA._content_key(X)


def test_estimator_fits_share_one_binned_dataset(data, monkeypatch,
                                                 tmp_path):
    X, y = data
    TA.clear_binned_dataset_cache()
    built = []
    real = TB.LightGBMDataset.construct
    monkeypatch.setattr(TB.LightGBMDataset, "construct",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    cols = TDataset({"features": X, "label": y})
    kw = dict(device="cpu", numIterations=2, numLeaves=7, maxBin=63)
    a = LightGBMClassifier(learningRate=0.1, **kw).fit(cols).booster
    LightGBMClassifier(learningRate=0.3, **kw).fit(cols)
    assert len(built) == 1
    # the cached fit is the plain one; a checkpointed fit bins its own
    plain = TB.train_booster(X, y, objective="binary", num_iterations=2,
                             max_bin=63, seed=3,
                             cfg=TG.GrowConfig(num_leaves=7), device="cpu")
    _assert_identical(a, plain)
    assert len(built) == 2
    LightGBMClassifier(checkpointDir=str(tmp_path), **kw).fit(cols)
    assert len(built) == 3
    TA.clear_binned_dataset_cache()


def test_init_score_col_is_accepted_and_not_read(data):
    X, y = data
    cols = {"features": X, "label": y, "init": np.full(len(y), 5.0)}
    kw = dict(device="cpu", numIterations=2, numLeaves=7, maxBin=63)
    with_col = LightGBMClassifier(initScoreCol="init", **kw).fit(
        TDataset(cols)).booster
    without = LightGBMClassifier(**kw).fit(TDataset(cols)).booster
    _assert_identical(with_col, without)
