"""Categorical splits: the PyTorch port against the JAX package.

Seeded numpy inputs go through both packages on the CPU.

  * ``_best_split`` with ``is_cat``, the sorted-subset search: random
    ``[F, 3, B]`` histograms over mixed numeric and categorical features,
    B = 31, 63 and 255, with empty bins, tied ratios and
    ``max_cat_threshold`` binding. The port searches K nodes in one batch;
    each must equal the JAX function on that node: gain, feature, bin and
    left totals within 1e-6, and the bitset bit for bit. Grad and hess
    take dyadic values, so every cumsum is exact on both sides and ties
    are real ties, broken the same way.
  * Small fits (2,000 or 9,000 rows x 4, one categorical column of 12 ids
    whose label-carrying set {1, 4, 7, 10} is not contiguous; 4 rounds,
    15 leaves): leafwise and depthwise, without and with histogram
    subtraction (it engages from 8,192 rows), and quantized (stochastic
    rounding under the JAX package's draws, nothing patched). ``feat``,
    ``thr_bin`` and ``cat_bitset`` must be identical, margins within 1e-5.
    Leaves keep at least 100 rows: the f32 root totals are summed in
    another order on each side, and a leaf of a few rows carries that
    difference into its value past 1e-5.
  * Routing of raw category values: NaN, negative, unseen, past the
    catch-all bin (``maxBin - 1``), huge and non-integer ids, for a model
    trained here (ids bin as in training) and the same model read back
    from LightGBM text (strict ``FindInBitset``), against the JAX package;
    ``cat_member`` and ``raw_to_cat_bin`` against the JAX functions.
  * The estimators: ``categoricalSlotIndexes`` grows the JAX estimator's
    trees; ``categoricalSlotNames`` raises the JAX package's error; the
    ranker drops the slots, as the JAX ranker does.
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
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassifier,
                                                LightGBMRanker)
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays

torch.set_num_threads(1)

TREE = ("feat", "thr_bin", "cat_bitset", "left", "right", "is_leaf")


def _hists(seed, K, F, B, cats):
    """[K, F, 3, B] node histograms of dyadic stats: each node's rows fall
    in a random subset of each feature's bins (the rest empty), and many
    bins hold the same stats (tied ratios)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((K, F, 3, B), np.float32)
    for k in range(K):
        n = int(rng.integers(60, 400))
        g = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], size=n)
        h = rng.choice([0.25, 0.5], size=n)
        for f in range(F):
            used = rng.choice(B, size=max(2, B // (3 if f in cats else 1)),
                              replace=False)
            b = used[rng.integers(0, len(used), size=n)]
            for s, v in enumerate((g, h, np.ones(n))):
                np.add.at(out[k, f, s], b, v)
    return out


@pytest.mark.parametrize("B", [31, 63, 255])
@pytest.mark.parametrize("max_cat", [32, 4], ids=["cap32", "cap4"])
def test_best_split_categorical_matches_jax(B, max_cat):
    K, F = 6, 5
    cats = (1, 3, 4)
    hist = _hists(B + max_cat, K, F, B, cats)
    is_cat = np.zeros(F, bool)
    is_cat[list(cats)] = True
    fmask = np.array([True, True, True, False, True])
    allow = np.array([True] * (K - 1) + [False])
    tot = hist[:, 0].sum(axis=-1)                               # [K, 3]
    kw = dict(num_bins=B, min_data_in_leaf=3, min_sum_hessian_in_leaf=0.1,
              lambda_l2=0.5, max_cat_threshold=max_cat)
    jcfg, tcfg = JG.GrowConfig(**kw), TG.GrowConfig(**kw)
    got = TG._best_split(torch.from_numpy(hist),
                         *(torch.from_numpy(tot[:, i]) for i in range(3)),
                         tcfg, torch.from_numpy(fmask),
                         torch.from_numpy(allow), torch.from_numpy(is_cat))
    got = [a.numpy() for a in got]
    n_cat_wins = 0
    for k in range(K):
        want = [np.asarray(a) for a in JG._best_split(
            jnp.asarray(hist[k]), tot[k, 0], tot[k, 1], tot[k, 2], jcfg,
            jnp.asarray(fmask), jnp.bool_(allow[k]), jnp.asarray(is_cat))]
        np.testing.assert_allclose(got[0][k], want[0], rtol=1e-6, atol=0)
        assert (got[1][k], got[2][k]) == (want[1], want[2]), k
        for i in (3, 4, 5):
            np.testing.assert_allclose(got[i][k], want[i], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(got[6][k], want[6].astype(np.int64))
        assert got[6][k].shape == (TG.bitset_words(B),)
        n_cat_wins += bool(is_cat[want[1]] and np.isfinite(want[0]))
        if max_cat == 4 and is_cat[want[1]]:
            assert sum(bin(int(w)).count("1") for w in want[6]) <= 4
    assert n_cat_wins >= 2               # the categorical search was used
    assert got[0][K - 1] == -np.inf      # a node that may not split


@pytest.mark.parametrize("B", [31, 255])
def test_pack_bits_and_bit_test_match_jax(B):
    rng = np.random.default_rng(B)
    member = rng.uniform(size=(7, B)) < 0.4
    member[0, B - 1] = True              # the last bin (word 7 bit 31 at 255)
    want = np.stack([np.asarray(JG._pack_bits(jnp.asarray(m)))
                     for m in member])
    got = TG._pack_bits(torch.from_numpy(member)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    idx = rng.integers(0, B, size=7)
    idx[0] = B - 1
    np.testing.assert_array_equal(
        TG.bit_test(torch.from_numpy(got), torch.from_numpy(idx)).numpy(),
        member[np.arange(7), idx])


def _cat_data(n, seed=0, n_cats=12):
    """Column 0 holds a category id in [0, n_cats); the label follows
    membership of the non-contiguous set {1, 4, 7, 10}, 5% flipped."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, n_cats, n)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    y = (np.isin(cats, [1, 4, 7, 10]) ^ (rng.uniform(size=n) < 0.05)
         ^ (noise[:, 0] > 1.2)).astype(np.float32)
    return np.column_stack([cats.astype(np.float32), noise]), y


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _fit_pair(X, y, **kw):
    jb = jtrain(X, y, objective="binary", num_iterations=4, max_bin=63,
                categorical_features=(0,), cfg=JG.GrowConfig(**kw),
                mesh=_mesh())
    tb = ttrain(X, y, objective="binary", num_iterations=4, max_bin=63,
                categorical_features=(0,), cfg=TG.GrowConfig(**kw),
                device="cpu")
    return jb, tb


def _assert_same_fit(jb, tb, X):
    for f in TREE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    assert tb.trees["cat_bitset"].dtype == np.uint32
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
@pytest.mark.parametrize("n,sub", [(2000, False), (9000, True)],
                         ids=["plain", "subtract"])
def test_categorical_fit_matches_jax(policy, n, sub):
    X, y = _cat_data(n, seed=n % 7)
    jb, tb = _fit_pair(X, y, num_leaves=15, min_data_in_leaf=100,
                       growth_policy=policy, hist_subtraction=sub)
    # the root split is the category subset, and it is not a prefix
    assert tb.trees["feat"][0, 0] == 0
    assert tb.trees["cat_bitset"][0, 0, 0] == (1 << 1 | 1 << 4 | 1 << 7
                                               | 1 << 10)
    _assert_same_fit(jb, tb, X)


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_categorical_quantized_fit_matches_jax(policy):
    X, y = _cat_data(9000, seed=3)
    jb, tb = _fit_pair(X, y, num_leaves=15, min_data_in_leaf=100,
                       growth_policy=policy, quantized_grad=True,
                       quant_warmup_iters=1)
    assert np.any(tb.trees["cat_bitset"][1:])       # quantized trees split
    _assert_same_fit(jb, tb, X)


def test_validation_set_scores_categorical_trees_as_jax():
    """The validation rows are scored on their bins tree by tree
    (``predict_tree_binned`` with ``is_cat``): same history, same best
    iteration."""
    X, y = _cat_data(3000, seed=5)
    Xv, yv = _cat_data(800, seed=6)
    Xv[:5, 0] = [np.nan, -3.0, 40.0, 70.0, 2.6]
    kw = dict(objective="binary", num_iterations=6, max_bin=63,
              categorical_features=(0,), valid_set=(Xv, yv, None),
              early_stopping_rounds=2)
    cfg = dict(num_leaves=7, min_data_in_leaf=100)
    jb = jtrain(X, y, cfg=JG.GrowConfig(**cfg), mesh=_mesh(), **kw)
    tb = ttrain(X, y, cfg=TG.GrowConfig(**cfg), device="cpu", **kw)
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tb.eval_history["binary_logloss"],
                               jb.eval_history["binary_logloss"], rtol=1e-6)


# raw values of the categorical column: NaN, negatives, ids that round
# both ways, unseen ids, the catch-all bin (62 at maxBin 63) and past it
ODD_IDS = np.array([np.nan, -1.0, -0.6, -0.4, 0.4, 0.5, 1.49, 1.5, 3.999,
                    4.0, 6.5, 7.2, 10.0, 11.0, 12.0, 20.0, 61.6, 62.0, 63.0,
                    100.0, 255.0, 256.0, 1e9, np.inf, -np.inf], np.float32)


def _odd_rows(X):
    rows = X[:len(ODD_IDS)].copy()
    rows[:, 0] = ODD_IDS
    return rows


def test_raw_routing_trained_and_imported_matches_jax():
    X, y = _cat_data(3000, seed=8, n_cats=70)
    y = ((np.isin(X[:, 0], [1, 4, 7, 10]) | (X[:, 0] >= 62))
         ^ (X[:, 1] > 1.0)).astype(np.float32)
    jb, tb = _fit_pair(X, y, num_leaves=15, min_data_in_leaf=20)
    catch_all = tb.trees["cat_bitset"][..., 62 >> 5] >> (62 & 31) & 1
    assert catch_all.any()                    # ids >= 62 went left somewhere
    rows = _odd_rows(X)
    np.testing.assert_allclose(tb.predict_raw(rows, device="cpu"),
                               jb.predict_raw(rows), rtol=0, atol=1e-5)
    # the same trees read back from LightGBM text route strictly: an id
    # outside the bitset, NaN and the former catch-all's other ids go right
    with pytest.warns(UserWarning, match="catch-all"):
        text = tb.to_lightgbm_string()
    ti = Booster.from_lightgbm_string(text)
    ji = JBooster.from_lightgbm_string(text)
    assert ti._cat_strict() and not tb._cat_strict()
    got = ti.predict_raw(rows, device="cpu")
    np.testing.assert_allclose(got, ji.predict_raw(rows), rtol=0, atol=1e-6)
    # ids below the catch-all bin route as in training
    ok = np.isfinite(ODD_IDS) & (np.floor(ODD_IDS + 0.5) >= 0) & (
        np.floor(ODD_IDS + 0.5) < 62)
    np.testing.assert_allclose(got[ok], tb.predict_raw(rows[ok],
                                                       device="cpu"),
                               rtol=0, atol=1e-5)
    assert not np.allclose(got[~ok], tb.predict_raw(rows[~ok],
                                                    device="cpu"))


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("max_bin_idx", [62, 254])
def test_cat_member_and_raw_to_cat_bin_match_jax(strict, max_bin_idx):
    rng = np.random.default_rng(max_bin_idx + strict)
    BW = TG.bitset_words(max_bin_idx + 1)
    words = rng.integers(0, 2 ** 32, size=(len(ODD_IDS), BW),
                         dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JG.cat_member(jnp.asarray(words),
                                    jnp.asarray(ODD_IDS), max_bin_idx,
                                    strict))
    bits = torch.from_numpy(words.astype(np.int64)).reshape(1, -1)
    word0 = torch.arange(len(ODD_IDS))[None, :] * BW
    got = TG.cat_member(bits, word0, torch.from_numpy(ODD_IDS)[None, :],
                        max_bin_idx, strict)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TG.raw_to_cat_bin(torch.from_numpy(ODD_IDS), max_bin_idx).numpy(),
        np.asarray(JG.raw_to_cat_bin(jnp.asarray(ODD_IDS), max_bin_idx)))


def test_converted_categorical_booster_predicts_as_jax():
    X, y = _cat_data(2000, seed=9)
    jb, _ = _fit_pair(X, y, num_leaves=7, min_data_in_leaf=50)
    fields = {k: np.asarray(v) for k, v in jb.trees._asdict().items()}
    port = booster_from_jax_arrays(
        fields, jb.thr_raw, 1, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state)
    rows = np.concatenate([X[:200], _odd_rows(X)])
    np.testing.assert_array_equal(port.predict_raw(rows, device="cpu"),
                                  jb.predict_raw(rows))
    np.testing.assert_array_equal(port.predict_leaf(rows, device="cpu"),
                                  jb.predict_leaf(rows))


def test_estimator_categorical_slots_match_jax():
    X, y = _cat_data(3000, seed=11)
    params = dict(numIterations=4, numLeaves=7, minDataInLeaf=100,
                  maxBin=63, categoricalSlotIndexes=[0])
    port = LightGBMClassifier(device="cpu", **params).fit(
        TDataset({"features": X, "label": y}))
    with default_mesh(_mesh()):
        jm = JClassifier(**params).fit(JDataset({"features": X, "label": y}))
    for f in TREE:
        np.testing.assert_array_equal(port.booster.trees[f],
                                      np.asarray(getattr(jm.booster.trees,
                                                         f)), err_msg=f)
    out = port.transform(TDataset({"features": X}))
    np.testing.assert_allclose(
        out.array("probability"),
        np.asarray(jm.transform(JDataset({"features": X}))["probability"]),
        rtol=0, atol=1e-5)
    assert (out.array("prediction") == y).mean() > 0.9


def test_categorical_slot_names_raise_as_jax():
    X, y = _cat_data(200)
    msgs = []
    for cls, ds in ((LightGBMClassifier, TDataset), (JClassifier, JDataset)):
        kw = {"device": "cpu"} if cls is LightGBMClassifier else {}
        with pytest.raises(ValueError) as e:
            cls(numIterations=1, categoricalSlotNames=["c0"], **kw).fit(
                ds({"features": X, "label": y}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "categoricalSlotIndexes" in msgs[0]


def test_out_of_range_categorical_index_raises():
    X, y = _cat_data(200)
    with pytest.raises(ValueError, match="out of range"):
        ttrain(X, y, objective="binary", num_iterations=1,
               categorical_features=(4,), device="cpu")


def test_ranker_splits_categorical_slots():
    """The port's ranker forwards the JAX ranker's training arguments,
    which leave ``categoricalSlotIndexes`` out (a reference defect kept on
    purpose, ROADMAP Queue 3): both rankers split the category ids as
    numbers and grow the same trees. Every query holds 16 rows, a power of
    two, so the JAX ranker pads none and both fit the same rows."""
    X, _ = _cat_data(960, seed=12)
    rel = np.isin(X[:, 0], [1, 4, 7, 10]).astype(np.float32) * 2 + (
        X[:, 1] > 0.5)
    cols = {"features": X, "label": rel.astype(np.float32),
            "query": np.repeat(np.arange(60), 16)}
    kw = dict(groupCol="query", numIterations=2, numLeaves=7,
              minDataInLeaf=20, maxBin=63, categoricalSlotIndexes=[0])
    b = LightGBMRanker(device="cpu", **kw).fit(TDataset(cols)).booster
    with default_mesh(_mesh()):
        jb = JRanker(**kw).fit(JDataset(cols)).booster
    assert b._is_cat() is None and jb._is_cat() is None
    assert not b.trees["cat_bitset"].any()
    for f in TREE:
        np.testing.assert_array_equal(b.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(b.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
