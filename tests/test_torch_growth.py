"""Leafwise tree growth: the PyTorch port against the JAX package.

Identical binned columns, gradients and hessians (seeded numpy) go through
the JAX package's ``grow_tree`` (config resolved by its
``resolve_growth_backend``, ``axis_name=None``, the scatter histogram
engine of the CPU) and the port's ``grow_tree`` on the CPU. The split
structure (``feat``, ``thr_bin``, ``left``, ``right``, ``is_leaf``) and the
rows' final leaves must be identical. Leaf values agree within rtol 1e-4
(atol 1e-6 for values near zero), not 1e-5: the histogram cells come out
the same on both sides, but the f32 root totals and bin cumsums are summed
in another order, so they differ by about an ulp of the root total (1e-4 at
a hessian total near 2000), and every right child inherits that absolute
difference through its parent-minus-left total. A leaf of a few dozen rows
then carries it as a relative difference of up to 6e-5 (measured on
``test_grow_tree_narrow_bins_and_feature_mask``). Row counts below and
above 8192 cover growth without and with histogram subtraction; the
subtraction's row compaction runs under both selectors, searchsorted and
argsort.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu_torch.models.gbdt import growth as TG

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf")


def _problem(seed, n, F=5, B=63, bin_dtype=np.int32):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(bin_dtype)
    signal = (binned[0] > B // 2).astype(np.float32) - 0.4 * (binned[1] < 9)
    grad = (rng.normal(size=n) + signal).astype(np.float32)
    hess = rng.uniform(0.1, 0.3, size=n).astype(np.float32)
    valid = (rng.uniform(size=n) < 0.95).astype(np.float32)
    return binned, grad, hess, valid


def _grow_both(binned, grad, hess, valid, feat_mask, **kw):
    jcfg = JG.resolve_growth_backend(JG.GrowConfig(**kw))
    tcfg = TG.resolve_growth_backend(TG.GrowConfig(**kw))
    jt, jrow = jax.jit(lambda b, g, h, v, m: JG.grow_tree(
        b, g, h, v, m, jcfg, axis_name=None))(
        binned, grad, hess, valid, feat_mask)
    tt, trow = TG.grow_tree(*(torch.from_numpy(a) for a in
                              (binned, grad, hess, valid, feat_mask)), tcfg)
    return jt, np.asarray(jrow), tt, trow.numpy()


def _assert_same_tree(jt, jrow, tt, trow):
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert int(tt.node_count) == int(jt.node_count)
    np.testing.assert_array_equal(trow, jrow)
    np.testing.assert_allclose(tt.leaf_value.numpy(),
                               np.asarray(jt.leaf_value),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tt.node_cnt.numpy(), np.asarray(jt.node_cnt),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n", [3000, 10000], ids=["full-width", "subtract"])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(leaf_batch=1, num_leaves=15),
    dict(max_depth=3, lambda_l1=0.5, lambda_l2=1.0, min_gain_to_split=0.01),
    dict(num_leaves=7, min_data_in_leaf=50, max_delta_step=0.05,
         learning_rate=0.3),
], ids=["default", "sequential", "regularized", "clamped"])
def test_grow_tree_matches_jax(n, kw):
    B = 63
    binned, grad, hess, valid = _problem(n + len(kw), n, B=B)
    jt, jrow, tt, trow = _grow_both(binned, grad, hess, valid,
                                    np.ones(binned.shape[0], bool),
                                    num_bins=B, **kw)
    assert int(tt.node_count) > 1
    _assert_same_tree(jt, jrow, tt, trow)


def test_grow_tree_narrow_bins_and_feature_mask():
    """uint8 bin storage and a feature mask (feature_fraction) at 255
    bins, subtraction on."""
    B = 255
    binned, grad, hess, valid = _problem(9, 9000, F=6, B=B,
                                         bin_dtype=np.uint8)
    fm = np.array([False, True, True, False, True, True])
    jt, jrow, tt, trow = _grow_both(binned, grad, hess, valid, fm,
                                    num_bins=B)
    assert not np.isin(tt.feat.numpy()[~tt.is_leaf.numpy()], [0, 3]).any()
    _assert_same_tree(jt, jrow, tt, trow)


def test_resolve_growth_backend_takes_the_non_tpu_rule():
    cfg = TG.resolve_growth_backend(TG.GrowConfig())
    assert cfg.hist_subtraction is True
    j = JG.resolve_growth_backend(JG.GrowConfig())       # JAX on the CPU
    assert (j.hist_subtraction, j.compact_selector) == (True, "searchsorted")
    assert TG.resolve_growth_backend(cfg) == cfg
    with pytest.raises(ValueError):
        TG.resolve_growth_backend(TG.GrowConfig(hist_subtraction="yes"))
    with pytest.raises(ValueError):
        TG._use_subtraction(TG.GrowConfig(), 10000)


def test_use_subtraction_threshold():
    cfg = TG.resolve_growth_backend(TG.GrowConfig())
    assert not TG._use_subtraction(cfg, 8191)
    assert TG._use_subtraction(cfg, 8192)
    assert not TG._use_subtraction(cfg._replace(hist_subtraction=False),
                                   10 ** 6)


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.5])
def test_compact_select_matches_jax(frac):
    rng = np.random.default_rng(int(frac * 10))
    n = 1001
    sel = rng.uniform(size=n) < frac
    h_buf = n // 2
    jsrc, jn = JG._compact_select(jnp.asarray(sel), h_buf, "searchsorted")
    tsrc, tn = TG._compact_select(torch.from_numpy(sel), h_buf)
    assert int(tn) == int(jn)
    k = int(tn)
    np.testing.assert_array_equal(tsrc.numpy()[:k], np.asarray(jsrc)[:k])


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.5])
def test_compact_select_argsort_matches_jax(frac):
    """The argsort selector compacts the same rows, in the same order, as
    the JAX package's argsort and as the port's searchsorted."""
    rng = np.random.default_rng(int(frac * 10) + 1)
    n = 1001
    sel = rng.uniform(size=n) < frac
    h_buf = n // 2
    jsrc, jn = JG._compact_select(jnp.asarray(sel), h_buf, "argsort")
    tsrc, tn = TG._compact_select(torch.from_numpy(sel), h_buf, "argsort")
    ssrc, sn = TG._compact_select(torch.from_numpy(sel), h_buf)
    assert int(tn) == int(jn) == int(sn)
    k = int(tn)
    np.testing.assert_array_equal(tsrc.numpy()[:k], np.asarray(jsrc)[:k])
    np.testing.assert_array_equal(tsrc.numpy()[:k], ssrc.numpy()[:k])
    with pytest.raises(ValueError, match="compact_selector"):
        TG._compact_select(torch.from_numpy(sel), h_buf, "bogus")


@pytest.mark.parametrize("grow", ["grow_tree", "grow_tree_depthwise"])
def test_argsort_selector_grows_the_searchsorted_tree(grow):
    """At 12,000 rows histogram subtraction compacts every smaller child:
    both selectors grow the same tree, leaf values bit for bit."""
    binned, grad, hess, valid = _problem(21, 12_000)
    args = [torch.from_numpy(a) for a in (binned, grad, hess, valid)]
    fmask = torch.ones(binned.shape[0], dtype=torch.bool)
    trees = {}
    for mode in ("argsort", "searchsorted"):
        cfg = TG.resolve_growth_backend(TG.GrowConfig(
            num_bins=63, num_leaves=15, compact_selector=mode))
        assert TG._use_subtraction(cfg, 12_000)
        trees[mode] = getattr(TG, grow)(*args, fmask, cfg)
    (ta, ra), (ts, rs) = trees["argsort"], trees["searchsorted"]
    for f in TG.Tree._fields:
        assert torch.equal(getattr(ta, f), getattr(ts, f)), f
    assert torch.equal(ra, rs)


def test_compact_selector_resolves_as_jax_off_the_tpu():
    assert TG.resolve_growth_backend(
        TG.GrowConfig()).compact_selector == "searchsorted"
    assert JG.resolve_growth_backend(
        JG.GrowConfig()).compact_selector == "searchsorted"
    assert TG.resolve_growth_backend(TG.GrowConfig(
        compact_selector="argsort")).compact_selector == "argsort"
    with pytest.raises(ValueError) as jerr:
        JG.resolve_growth_backend(JG.GrowConfig(compact_selector="sort"))
    with pytest.raises(ValueError) as terr:
        TG.resolve_growth_backend(TG.GrowConfig(compact_selector="sort"))
    assert str(terr.value) == str(jerr.value)


def test_predict_tree_binned_matches_jax():
    B = 63
    binned, grad, hess, valid = _problem(5, 4000, B=B)
    jt, jrow, tt, trow = _grow_both(binned, grad, hess, valid,
                                    np.ones(binned.shape[0], bool),
                                    num_bins=B)
    rows = np.ascontiguousarray(binned.T)
    want = np.asarray(JG.predict_tree_binned(jt, jnp.asarray(rows), 30))
    got = TG.predict_tree_binned(tt, torch.from_numpy(rows), 30).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the rows' grown leaves are where prediction lands them
    np.testing.assert_array_equal(got, tt.leaf_value.numpy()[trow])


def test_leafwise_rounds_on_the_cpu_grow_the_plain_tree():
    """The fit's LeafwiseRounds is ignored off the card: the tree and the
    rows' leaves are those of a call without it."""
    binned, grad, hess, valid = _problem(11, 12000)
    args = (torch.from_numpy(binned), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(valid),
            torch.ones(binned.shape[0], dtype=torch.bool),
            TG.resolve_growth_backend(TG.GrowConfig(num_bins=63,
                                                    quantized_grad=True)))
    plain, rows = TG.grow_tree(*args, qkey=(3, 4))
    held, rows2 = TG.grow_tree(*args, qkey=(3, 4),
                               rounds=TG.LeafwiseRounds())
    for a, b in zip(plain, held):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(rows, rows2, rtol=0, atol=0)

