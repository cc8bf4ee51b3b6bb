"""Row sampling in training: the PyTorch port against the JAX package.

Seeded binary rows (1,999 x 6) go through both packages' ``train_booster``
on the CPU, the JAX side on a one-device mesh, under plain bagging,
stratified pos/neg bagging, GOSS and random forests, each with bf16 and
with stochastically rounded int8 histograms. Nothing is patched: the port
draws the JAX package's own streams (``mmlspark_tpu_torch/utils/prng.py``),
its per-row uniforms ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed),
1_000_003 + bag_step), 0), (n,))`` (0 is the one device's shard index) and
its rounding uniforms ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed),
it), 13 + k), (3, n))``. The masks and int8 stats are then the same and
the fits must grow the same trees, margins within 1e-5. A one-device mesh
pads no rows, so GOSS's quantile runs over the same length on both sides
at any row count.

Also covered: GOSS on three classes (``|grad|`` summed over the score
columns), a random forest with a validation set and early stopping (the
metric on the average of the trees so far), the estimators and the ranker
with these params, every argument check against the JAX package's
message, the linear quantile against ``jnp.quantile`` and (past 2^24
elements, where ``torch.quantile`` refuses) ``np.quantile``, the host
draws (bit-equal to ``jax.random``), the bag reuse over ``baggingFreq``
iterations and the GOSS mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.models.gbdt.api import LightGBMRanker as JRanker
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import booster as TB
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassifier,
                                                LightGBMRanker)

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")
N = 1999
CFG = dict(num_leaves=7, min_data_in_leaf=20)
MODES = {
    "bagging": dict(bagging_fraction=0.5, bagging_freq=2),
    "stratified": dict(pos_bagging_fraction=0.9, neg_bagging_fraction=0.3,
                       bagging_freq=1),
    "goss": dict(boosting_type="goss"),
    "rf": dict(boosting_type="rf", bagging_fraction=0.8, bagging_freq=1),
}


def jax_uniforms(seed, bag_step, n):
    """The JAX package's per-row uniforms of one bag step on a one-device
    mesh, as a CPU tensor."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                1_000_003 + bag_step), 0)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def _binary(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float32)


def _three_classes(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    logits = np.stack([X[:, 0] + X[:, 1], 0.8 * X[:, 2] * X[:, 3],
                       np.abs(X[:, 4]) - 0.7], axis=1)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    y = (rng.uniform(size=(n, 1)) > np.cumsum(p, axis=1)).sum(axis=1)
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


@pytest.fixture(scope="module")
def data():
    return _binary(N, 0)


@pytest.fixture(scope="module")
def jax_fits():
    """JAX boosters by key, fitted once per module."""
    return {}


def _pair(jax_fits, key, X, y, quantized=False, cfg=None, **kw):
    """(JAX booster, port booster) of one configuration."""
    args = dict(objective="binary", num_iterations=4, max_bin=63, seed=3)
    args.update(kw)
    cfg = dict(CFG, **(cfg or {}))
    if quantized:
        cfg.update(quantized_grad=True, quant_warmup_iters=1)
    if key not in jax_fits:
        jax_fits[key] = jtrain(X, y, cfg=JG.GrowConfig(**cfg), mesh=_mesh(),
                               **args)
    tb = TB.train_booster(X, y, cfg=TG.GrowConfig(**cfg), device="cpu",
                          **args)
    return jax_fits[key], tb


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampled_fit_matches_jax(mode, quantized, data, jax_fits):
    X, y = data
    jb, tb = _pair(jax_fits, (mode, quantized), X, y, quantized=quantized,
                   **MODES[mode])
    _assert_same_fit(jb, tb, X)
    if mode == "rf":
        # the averaged forest: each tree scaled by 1 / iterations
        assert tb.num_iterations == 4


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_feature_fraction_fit_matches_jax(policy, quantized, data,
                                          jax_fits):
    """Iteration ``it``'s features are those of ``uniform(fold_in(fold_in(
    PRNGKey(seed), it), 7), (F,)) < featureFraction``, plus its argmin."""
    X, y = data
    jb, tb = _pair(jax_fits, ("ff", policy, quantized), X, y,
                   quantized=quantized, feature_fraction=0.5,
                   cfg=dict(growth_policy=policy))
    _assert_same_fit(jb, tb, X)
    used = {int(f) for f in np.unique(tb.trees["feat"][~tb.trees["is_leaf"]])}
    assert len(used) > 3                 # the subsets change by iteration


def test_feature_mask_is_the_jax_draw():
    for seed, it in ((3, 0), (3, 5), (-2, 1), (2 ** 31 + 9, 7)):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), it), 7)
        u = np.asarray(jax.random.uniform(key, (9,)))
        want = u < 0.4
        want[np.argmin(u)] = True
        got = TB._feature_mask(seed, it, 9, 0.4, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want)
    assert TB._feature_mask(3, 0, 9, 1.0, torch.device("cpu")).all()


def test_goss_three_classes_matches_jax(jax_fits):
    X, y = _three_classes(3001, 1)
    jb, tb = _pair(jax_fits, "goss3", X, y, objective="multiclass",
                   num_class=3, num_iterations=3,
                   boosting_type="goss", top_rate=0.3, other_rate=0.2)
    _assert_same_fit(jb, tb, X)


@pytest.mark.parametrize("metric", [None, "auc"])
def test_rf_validation_matches_jax(metric, data, jax_fits):
    """rf's validation metric is taken on the average of the trees so far
    (auc: on the sum, whose order is the same); early stopping cuts the
    forest before it is averaged."""
    X, y = data
    Xv, yv = _binary(600, 5)
    jb, tb = _pair(jax_fits, ("rf_valid", metric), X, y, num_iterations=8,
                   valid_set=(Xv, yv, None),
                   early_stopping_rounds=2, eval_metric_name=metric,
                   cfg=dict(num_leaves=15, min_data_in_leaf=5),
                   **MODES["rf"])
    _assert_same_fit(jb, tb, X)
    assert tb.best_iteration == jb.best_iteration
    assert sorted(tb.eval_history) == sorted(jb.eval_history)
    for k, h in jb.eval_history.items():
        np.testing.assert_allclose(tb.eval_history[k], h, rtol=1e-6, atol=0)


@pytest.mark.parametrize("params", [
    dict(boostingType="goss", topRate=0.25, otherRate=0.15),
    dict(baggingFraction=0.6, baggingFreq=3, featureFraction=1.0),
    dict(boostingType="rf", posBaggingFraction=0.8, negBaggingFraction=0.5,
         baggingFreq=1),
], ids=["goss", "bagging", "rf-stratified"])
def test_classifier_sampling_matches_jax(params, data):
    X, y = data
    kw = dict(numIterations=3, numLeaves=7, maxBin=63, baggingSeed=11,
              **params)
    tm = LightGBMClassifier(device="cpu", **kw).fit(
        TDataset({"features": X, "label": y}))
    with default_mesh(_mesh()):
        jm = JClassifier(**kw).fit(JDataset({"features": X, "label": y}))
    _assert_same_fit(jm.booster, tm.booster, X)


def test_ranker_bagging_matches_jax():
    """The ranker passes ``boostingType`` and the bagging params, as the
    JAX ranker does. The bag is drawn over the fit's rows: the port's
    ragged rows, the JAX ranker's padded ones, the same rows where every
    query holds 16, a power of two, and no row is padded."""
    rng = np.random.default_rng(8)
    group = np.repeat(np.arange(60), 16)
    X = rng.normal(size=(len(group), 5)).astype(np.float32)
    y = np.digitize(X[:, 0] + 0.5 * rng.normal(size=len(group)),
                    [-0.5, 0.3, 1.0]).astype(np.float32)
    cols = {"features": X, "label": y, "query": group}
    kw = dict(groupCol="query", numIterations=3, numLeaves=7, maxBin=63,
              minDataInLeaf=20, baggingFraction=0.7, baggingFreq=1)
    tb = LightGBMRanker(device="cpu", **kw).fit(TDataset(cols)).booster
    with default_mesh(_mesh()):
        jb = JRanker(**kw).fit(JDataset(cols)).booster
    _assert_same_fit(jb, tb, X)


BAD = {
    "unknown-type": dict(boosting_type="bogus"),
    "rf-without-bagging": dict(boosting_type="rf"),
    "rf-warm-start": dict(boosting_type="rf", init_booster=object(),
                          bagging_fraction=0.5, bagging_freq=1),
    "dart-warm-start": dict(boosting_type="dart", init_booster=object()),
    "dart-checkpoint": dict(boosting_type="dart", checkpoint_dir="unused"),
    "stratified-regression": dict(objective="regression",
                                  pos_bagging_fraction=0.5, bagging_freq=1),
    "stratified-no-freq": dict(neg_bagging_fraction=0.5),
    "stratified-range": dict(pos_bagging_fraction=1.5, bagging_freq=1),
    "stratified-goss": dict(boosting_type="goss", pos_bagging_fraction=0.5,
                            bagging_freq=1),
    "stratified-dart": dict(boosting_type="dart", pos_bagging_fraction=0.5,
                            bagging_freq=1),
    "stratified-and-fraction": dict(pos_bagging_fraction=0.5,
                                    bagging_fraction=0.5, bagging_freq=1),
    "rf-training-metric": dict(boosting_type="rf", bagging_fraction=0.5,
                               bagging_freq=1, provide_training_metric=True),
    "dart-training-metric": dict(boosting_type="dart",
                                 provide_training_metric=True),
    "dart-metric": dict(boosting_type="dart", eval_metric_name="auc"),
    "negative-tolerance": dict(early_stopping_tolerance=-1.0),
    "dataset-checkpoint": dict(dataset=object(), checkpoint_dir="unused"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_option_checks_raise_jax_messages(name):
    X, y = _binary(50, 2)
    kw = dict(objective="binary", num_iterations=1)
    kw.update(BAD[name])
    xy = (None, None) if "dataset" in kw else (X, y)
    with pytest.raises(ValueError) as jerr:
        jtrain(*xy, mesh=_mesh(), **kw)
    with pytest.raises(ValueError) as terr:
        TB.train_booster(*xy, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_quantile_matches_jnp_quantile():
    rng = np.random.default_rng(4)
    a = np.abs(rng.normal(size=10_007)).astype(np.float32)
    a[rng.uniform(size=a.size) < 0.1] = 0.0        # padding-like zeros
    a[:50] = a[50]                                  # ties
    t = torch.from_numpy(a)
    for q in (0.0, 0.1, 0.5, 0.8, 0.8000213, 0.999, 1.0):
        q32 = np.float32(q)
        want = float(jnp.quantile(jnp.asarray(a), jnp.float32(q32)))
        assert TB._quantile_linear(t, q32) == want, q
    t[7] = float("nan")
    assert np.isnan(TB._quantile_linear(t, np.float32(0.5)))


def test_quantile_past_torch_limit_matches_numpy():
    """2^24 + 3 elements: ``torch.quantile`` refuses them; the order
    statistics agree with numpy's within the f32 index arithmetic's reach
    (a neighbouring element, 2^-24 apart on uniform data)."""
    n = (1 << 24) + 3
    a = torch.rand(n, generator=torch.Generator().manual_seed(5))
    for q in (0.25, 0.8):
        want = np.quantile(a.numpy(), q)
        assert abs(TB._quantile_linear(a, np.float32(q)) - want) < 1e-6


def test_row_uniforms_are_keyed_by_seed_and_step():
    """The JAX package's draws bit for bit, keyed by (seed, bag step); a
    rank's slice from ``start`` is that slice of the one-device draw."""
    a = TB._row_uniforms(3, 0, 1000, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (1000,)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    np.testing.assert_array_equal(a.numpy(), jax_uniforms(3, 0, 1000))
    assert torch.equal(a, TB._row_uniforms(3, 0, 1000, device="cpu"))
    assert not torch.equal(a, TB._row_uniforms(3, 1, 1000, device="cpu"))
    assert not torch.equal(a, TB._row_uniforms(4, 0, 1000, device="cpu"))
    assert torch.equal(a[600:], TB._row_uniforms(3, 0, 400, start=600,
                                                 device="cpu"))
    assert abs(float((a < 0.3).float().mean()) - 0.3) < 0.06


def _sampling(**kw):
    n = 4000
    y = (torch.arange(n) % 3 == 0).to(torch.float32)
    args = dict(boosting_type="gbdt", vmask=torch.ones(n), y=y, seed=7,
                bagging_fraction=1.0, bagging_freq=0,
                pos_bagging_fraction=1.0, neg_bagging_fraction=1.0,
                top_rate=0.2, other_rate=0.1)
    args.update(kw)
    return TB._RowSampling(**args)


def test_bag_is_reused_for_bagging_freq_iterations():
    s = _sampling(bagging_fraction=0.5, bagging_freq=3)
    g = torch.zeros(4000, 1)
    masks = [s(it, g) for it in range(7)]
    assert [s.bag_step(it) for it in range(7)] == [0, 0, 0, 1, 1, 1, 2]
    assert torch.equal(masks[0], masks[2])
    assert not torch.equal(masks[2], masks[3])
    assert set(masks[0].unique().tolist()) == {0.0, 1.0}
    # rf draws a new bag every iteration
    rf = _sampling(boosting_type="rf", bagging_fraction=0.5, bagging_freq=3)
    assert [rf.bag_step(it) for it in range(3)] == [0, 1, 2]
    # pos/neg: per-label keep rates
    st = _sampling(pos_bagging_fraction=0.9, neg_bagging_fraction=0.2,
                   bagging_freq=1)
    m, y = st(0, g), st.frac > 0.5
    assert abs(float(m[y].mean()) - 0.9) < 0.05
    assert abs(float(m[~y].mean()) - 0.2) < 0.05


def test_goss_mask_matches_the_jax_formula():
    """The top 20% of rows by |grad| (summed over the columns) keep weight
    1; the rest are kept with probability 0.1 / 0.8 at weight 8, under the
    JAX package's draws."""
    n = 4000
    vm = np.ones(n, np.float32)
    vm[-100:] = 0.0                                 # padding rows
    grad = np.random.default_rng(6).normal(size=(n, 2)).astype(np.float32)
    s = _sampling(boosting_type="goss", vmask=torch.from_numpy(vm))
    got = s(5, torch.from_numpy(grad)).numpy()
    absg = jnp.abs(jnp.asarray(grad)).sum(axis=1) * vm
    q = jnp.clip(1.0 - 0.2 * jnp.maximum(jnp.sum(vm), 1.0) / n, 0.0, 1.0)
    top = absg >= jnp.quantile(absg, q)
    rest = jnp.asarray(jax_uniforms(7, 5, n).numpy()) < 0.1 / 0.8
    want = vm * jnp.where(top, 1.0, jnp.where(rest, 8.0, 0.0))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(np.unique(got).tolist()) == {0.0, 1.0, 8.0}
