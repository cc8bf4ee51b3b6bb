"""Quantized-gradient training: the PyTorch port against the JAX package.

Seeded numpy inputs go through both packages on the CPU (the JAX package's
scatter engine, and its Pallas kernel in interpret mode).

  * ``node_histogram`` with ``scales=``: the same int8 stats and scales
    give ``[F, 3W, B]`` histograms **bit-equal** to both JAX engines (int32
    sums are exact, and the dequantization is the same f32 product).
  * ``positional_uniform`` reproduces the JAX package's
    ``_positional_uniform`` bit for bit (the blocked mode's draws), and
    ``quant_key`` the words of the JAX package's ``fold_in(fold_in(
    PRNGKey(seed), it), 13 + k)``; the plain path rounds with the JAX
    package's ``jax.random.uniform(qkey, [3, n])``.
  * ``grow_tree`` / ``grow_tree_depthwise`` with ``quantized_grad`` and no
    rounding key (round-to-nearest on both sides, so the same int8
    values): identical structure and row leaves; leaf values within rtol
    1e-4 / atol 1e-6, the bf16 growth tests' tolerance. With leaf renewal
    the leaves come from an f32 segment-sum, which XLA and PyTorch may add
    in another order; the difference measured on these cases was 0.
  * The estimator: a quantized fit whose warmup covers every iteration
    grows the JAX fit's trees, and so does a fit of stochastically rounded
    trees (the same draws on both sides); its training log-loss is also
    held to the JAX fit's within 2% relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.ops import histogram as TH
from mmlspark_tpu_torch.ops.histogram_scatter import node_hist_plain

torch.set_num_threads(1)

BIN_DTYPES = {"int32": (np.int32, torch.int32),
              "int16": (np.int16, torch.int16),
              "uint8": (np.uint8, torch.uint8)}
STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")


def _engine(monkeypatch, engine):
    monkeypatch.delenv("MMLSPARK_TPU_DISABLE_PALLAS_HIST", raising=False)
    if engine == "pallas":
        monkeypatch.setenv("MMLSPARK_TPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("MMLSPARK_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.setenv("MMLSPARK_TPU_HIST_ENGINE", engine)


def _quant_inputs(seed, n, F, W, B, bin_dtype):
    """int8 stats and scales from the JAX package's own quantize_stats."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(BIN_DTYPES[bin_dtype][0])
    pos = rng.integers(-1, W, size=n).astype(np.int32)      # some rows -1
    grad = rng.normal(size=n).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.9).astype(np.float32)
    base = np.stack([grad * mask, np.abs(grad) * mask, mask])
    q, scales = JH.quantize_stats(jnp.asarray(base))
    return binned, pos, np.array(q), np.array(scales)


def _both(binned, pos, q, scales, W, B):
    want = np.asarray(JH.node_histogram(
        jnp.asarray(binned), jnp.asarray(pos), jnp.asarray(q), W, B,
        scales=jnp.asarray(scales)))
    got = TH.node_histogram(torch.from_numpy(binned), torch.from_numpy(pos),
                            torch.from_numpy(q), W, B,
                            scales=torch.from_numpy(scales)).numpy()
    return got, want


@pytest.mark.parametrize("bin_dtype", sorted(BIN_DTYPES))
@pytest.mark.parametrize("W", [1, 3, 16])
def test_quantized_node_histogram_bit_equal_to_jax_scatter(W, bin_dtype,
                                                           monkeypatch):
    n, F, B = 1500, 4, 63
    binned, pos, q, scales = _quant_inputs(W, n, F, W, B, bin_dtype)
    _engine(monkeypatch, "scatter")
    got, want = _both(binned, pos, q, scales, W, B)
    assert got.shape == want.shape == (F, 3 * W, B)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bin_dtype", sorted(BIN_DTYPES))
@pytest.mark.parametrize("W,B", [(1, 255), (3, 63), (16, 63)])
def test_quantized_node_histogram_bit_equal_to_pallas_interpret(
        W, B, bin_dtype, monkeypatch):
    n, F = 512, 3
    binned, pos, q, scales = _quant_inputs(31 + W, n, F, W, B, bin_dtype)
    _engine(monkeypatch, "pallas")
    assert JH.resolve_engine() == "pallas"
    got, want = _both(binned, pos, q, scales, W, B)
    np.testing.assert_array_equal(got, want)


def test_quantized_cpu_tensor_takes_the_int32_plain_version():
    binned, pos, q, scales = _quant_inputs(3, 300, 2, 2, 15, "int32")
    before = (node_hist_plain.calls, TH.node_histogram.launches,
              TH.node_histogram.int8_launches)
    TH.node_histogram(torch.from_numpy(binned), torch.from_numpy(pos),
                      torch.from_numpy(q), 2, 15,
                      scales=torch.from_numpy(scales))
    assert (node_hist_plain.calls, TH.node_histogram.launches,
            TH.node_histogram.int8_launches) == (before[0] + 1, before[1],
                                                 before[2])
    raw = node_hist_plain(torch.from_numpy(binned), torch.from_numpy(pos),
                          torch.from_numpy(q), 2, 15, acc_dtype=torch.int32)
    assert raw.dtype == torch.int32
    with pytest.raises(ValueError, match="acc_dtype"):
        node_hist_plain(torch.from_numpy(binned), torch.from_numpy(pos),
                        torch.from_numpy(q), 2, 15, acc_dtype=torch.int64)


@pytest.mark.parametrize("key", [(0, 0), (7, 3), (0xFFFFFFFF, 0x12345678),
                                 TH.quant_key(3, 5, 0)])
@pytest.mark.parametrize("channels,n", [(3, 10007), (1, 5)])
def test_positional_uniform_bit_equal_to_jax(key, channels, n):
    want = np.asarray(JG._positional_uniform(
        jnp.asarray(np.array(key, np.uint32)), channels, n, None))
    got = TH.positional_uniform(key, channels, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_quant_key_words_depend_on_seed_iteration_and_class():
    keys = {TH.quant_key(s, it, k) for s in (0, 1) for it in (0, 1, 2)
            for k in (0, 1)}
    assert len(keys) == 12
    want = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(4), 9),
                              13)
    assert TH.quant_key(4, 9, 0) == tuple(int(w) for w in np.asarray(want))
    assert TH.quant_key(4, 9, 0) == TH.quant_key(4, 9, 0)
    assert all(0 <= w < 2 ** 32 for key in keys for w in key)


def test_quantize_for_rounds_with_the_positional_uniforms():
    """The port's _quantize_for equals the JAX package's on both paths:
    the blocked one with the positional uniforms, the plain one with
    ``jax.random.uniform`` under the same key words."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(3, 4000)).astype(np.float32)
    key = TH.quant_key(11, 4, 0)
    jkey = jnp.asarray(np.array(key, np.uint32))
    cfg = JG.GrowConfig(hist_blocks=8)
    jq, js = JG._quantize_for(cfg, jnp.asarray(base), jkey, None, 8, 500)
    tq, ts = TG._quantize_for(torch.from_numpy(base), key, None, 8, 500)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = JG._quantize_for(JG.GrowConfig(), jnp.asarray(base), jkey,
                              None, 0, 0)
    tq, ts = TG._quantize_for(torch.from_numpy(base), key)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rq, _ = TG._quantize_for(torch.from_numpy(base), None)
    jr, _ = JH.quantize_stats(jnp.asarray(base))
    np.testing.assert_array_equal(rq.numpy(), np.asarray(jr))


def test_leaf_renewal_sums_exactly_in_any_row_order():
    """The renewed leaf stats are each leaf's exact sum rounded once to
    f32, so no summation order (a launch on the card, a shuffle of the
    rows) moves a bit; they stay within f32 rounding of the JAX package's
    scatter-add."""
    rng = np.random.default_rng(12)
    n, M = 20_001, 9
    grad = rng.normal(size=n).astype(np.float32) * 3.0
    hess = rng.uniform(0.01, 0.3, size=n).astype(np.float32)
    vm = (rng.uniform(size=n) < 0.9).astype(np.float32)
    node = rng.integers(0, M - 1, size=n).astype(np.int32)
    zeros = torch.zeros(M)
    leaf = torch.ones(M, dtype=torch.bool)

    def renew(order):
        out = TG._renew_leaf_stats(
            zeros, zeros, zeros, leaf, torch.from_numpy(node[order]),
            torch.from_numpy(grad[order]), torch.from_numpy(hess[order]),
            torch.from_numpy(vm[order]))
        return torch.stack(out).numpy()

    got = renew(np.arange(n))
    np.testing.assert_array_equal(got, renew(rng.permutation(n)))
    stats = np.stack([grad * vm, hess * vm, vm]).astype(np.float64)
    exact = np.zeros((3, M))
    np.add.at(exact, (slice(None), node), stats)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    want = np.zeros((3, M), np.float32)
    want = np.asarray(jnp.asarray(want).at[:, jnp.asarray(node)].add(
        jnp.asarray(stats.astype(np.float32))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_stat_totals_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(3, 3001)).astype(np.float32)
    jq, js = JH.quantize_stats(jnp.asarray(base))
    want = np.asarray(JG._stat_totals(jq, js, None, 0, 0))
    got = TG._stat_totals(torch.from_numpy(np.asarray(jq)),
                          torch.from_numpy(np.asarray(js))).numpy()
    np.testing.assert_array_equal(got, want)


def _problem(seed, n, F=5, B=63):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(np.int32)
    signal = (binned[0] > B // 2).astype(np.float32) - 0.4 * (binned[1] < 9)
    grad = (rng.normal(size=n) + signal).astype(np.float32)
    hess = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    valid = (rng.uniform(size=n) < 0.95).astype(np.float32)
    return binned, grad, hess, valid


def grow_both(policy, binned, grad, hess, valid, **kw):
    """The same tree grown by both packages (no rounding key: nearest)."""
    jcfg = JG.resolve_growth_backend(JG.GrowConfig(growth_policy=policy,
                                                   **kw))
    tcfg = TG.resolve_growth_backend(TG.GrowConfig(growth_policy=policy,
                                                   **kw))
    jgrow = JG.grow_tree_depthwise if policy == "depthwise" else JG.grow_tree
    tgrow = TG.grow_tree_depthwise if policy == "depthwise" else TG.grow_tree
    fm = np.ones(binned.shape[0], bool)
    jt, jrow = jax.jit(lambda b, g, h, v, m: jgrow(
        b, g, h, v, m, jcfg, axis_name=None))(binned, grad, hess, valid, fm)
    tt, trow = tgrow(*(torch.from_numpy(a) for a in
                       (binned, grad, hess, valid, fm)), tcfg)
    return jt, np.asarray(jrow), tt, trow.numpy()


def assert_same_tree(jt, jrow, tt, trow):
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert int(tt.node_count) == int(jt.node_count)
    np.testing.assert_array_equal(trow, jrow)
    np.testing.assert_allclose(tt.leaf_value.numpy(),
                               np.asarray(jt.leaf_value),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [3000, 10000], ids=["full-width", "subtract"])
@pytest.mark.parametrize("renew", [True, False], ids=["renew", "no-renew"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_leaves=7, min_data_in_leaf=50, lambda_l2=1.0),
], ids=["default", "regularized"])
def test_grow_tree_quantized_matches_jax(n, renew, kw):
    B = 63
    binned, grad, hess, valid = _problem(n + 3 * renew + len(kw), n, B=B)
    jt, jrow, tt, trow = grow_both("leafwise", binned, grad, hess, valid,
                                   num_bins=B, quantized_grad=True,
                                   quant_renew_leaf=renew, **kw)
    assert int(tt.node_count) > 1
    assert_same_tree(jt, jrow, tt, trow)


def test_grow_tree_quantized_key_is_deterministic_and_rounds():
    """With a key, the port's stochastic rounding is a function of the key
    alone: the same key grows the same tree, another key other int8
    values."""
    binned, grad, hess, valid = _problem(5, 4000)
    args = [torch.from_numpy(a) for a in (binned, grad, hess, valid)]
    fm = torch.ones(binned.shape[0], dtype=torch.bool)
    cfg = TG.resolve_growth_backend(TG.GrowConfig(num_bins=63,
                                                  quantized_grad=True))
    a, _ = TG.grow_tree(*args, fm, cfg, qkey=TH.quant_key(1, 2, 0))
    b, _ = TG.grow_tree(*args, fm, cfg, qkey=TH.quant_key(1, 2, 0))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    base = torch.stack(args[1:3] + [args[3]])
    q1, _ = TG._quantize_for(base, TH.quant_key(1, 2, 0))
    q2, _ = TG._quantize_for(base, TH.quant_key(1, 3, 0))
    assert not torch.equal(q1, q2)


def test_train_booster_warmup_then_quantized_trees(monkeypatch):
    """Iterations below quant_warmup_iters grow at full precision (no
    int8 histogram), later ones quantized under quant_key(seed, it, 0)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1500, 4)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=1500) > 0).astype(np.float32)
    seen = []
    real = TG.grow_tree

    def spy(*a, qkey=None, **kw):
        seen.append((a[5].quantized_grad, qkey))
        return real(*a, qkey=qkey, **kw)

    from mmlspark_tpu_torch.models.gbdt import booster as TB
    monkeypatch.setattr(TB, "grow_tree", spy)
    ttrain(X, y, objective="binary", num_iterations=4, max_bin=31, seed=6,
           cfg=TG.GrowConfig(num_leaves=5, quantized_grad=True,
                             quant_warmup_iters=2), device="cpu")
    assert seen == [(False, None), (False, None),
                    (True, TH.quant_key(6, 2, 0)),
                    (True, TH.quant_key(6, 3, 0))]


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] ** 2 - 0.7 * X[:, 2] * X[:, 3]
    y = (score + 0.3 * rng.normal(size=n) > 0.5).astype(np.float32)
    return X, y


def _fit_both(X, y, **params):
    port = LightGBMClassifier(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    with default_mesh(make_mesh(devices=jax.devices()[:1])):
        jmodel = JClassifier(**params).fit(JDataset({"features": X,
                                                     "label": y}))
    return port, jmodel


def _logloss(y, p):
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_estimator_quantized_warmup_covering_the_fit_matches_jax(policy):
    X, y = _data(3000, 4)
    params = dict(numIterations=3, numLeaves=7, minDataInLeaf=100,
                  maxBin=63, useQuantizedGrad=True, quantWarmupIters=3,
                  growthPolicy=policy)
    port, jmodel = _fit_both(X, y, **params)
    for f in STRUCTURE:
        np.testing.assert_array_equal(port.booster.trees[f],
                                      np.asarray(getattr(jmodel.booster.trees,
                                                         f)), err_msg=f)
    np.testing.assert_allclose(port.booster.predict_raw(X, device="cpu"),
                               jmodel.booster.predict_raw(X), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_estimator_stochastically_rounded_fit_matches_jax(policy):
    """Quantized trees from the second iteration on, rounded with the JAX
    package's draws: the JAX fit's trees, margins within 1e-5."""
    X, y = _data(3000, 6)
    params = dict(numIterations=4, numLeaves=7, minDataInLeaf=100,
                  maxBin=63, useQuantizedGrad=True, quantWarmupIters=1,
                  growthPolicy=policy, baggingSeed=9)
    port, jmodel = _fit_both(X, y, **params)
    for f in STRUCTURE:
        np.testing.assert_array_equal(port.booster.trees[f],
                                      np.asarray(getattr(jmodel.booster.trees,
                                                         f)), err_msg=f)
    np.testing.assert_allclose(port.booster.predict_raw(X, device="cpu"),
                               jmodel.booster.predict_raw(X), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_estimator_quantized_fit_holds_the_jax_training_metric(policy):
    X, y = _data(12000, 5)
    params = dict(numIterations=6, numLeaves=15, minDataInLeaf=50,
                  maxBin=63, useQuantizedGrad=True, quantWarmupIters=1,
                  growthPolicy=policy)
    port, jmodel = _fit_both(X, y, **params)
    lp = _logloss(y, port.booster.predict(X, device="cpu"))
    lj = _logloss(y, np.asarray(jmodel.booster.predict(X)))
    base = _logloss(y, np.full_like(y, y.mean()))
    assert lp < 0.9 * base
    assert abs(lp - lj) <= 0.02 * lj, (lp, lj)
