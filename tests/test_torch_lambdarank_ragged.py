"""LambdaRank over query groups of any length, on the CPU.

  * The port's ragged lambdas (``objectives.lambdarank_plain``, the CPU's
    route and the card kernel's plain version) against the benchmark's
    float64 reference (``perfbench/reference/lambdarank.py``), for queries
    of 1 and 2 rows, tied scores, all-equal grades and queries longer than
    128 rows: within 2e-6 of the largest gradient and of the largest
    hessian (float32 sums of at most a few hundred terms, about 16 ulps),
    which the reference's own lambdas rounded to bfloat16 (about 2e-3)
    fail; and equal, within the JAX-parity tolerance 1e-6, to the padded
    layout's where every query fits its width.
  * A CUDA tensor reaches ``csrc/lambdarank.cu`` through its wrapper with
    the query offsets, the scratch for queries past the shared-memory rows,
    the gain table, ``max_position``, sigma and the launch's block and
    shared-memory rows: ``_launch`` is replaced by a NumPy model of the
    kernel (counted ranks and ideal places, each row's sums) run on the
    wrapper's buffers, which agrees with the plain version; the launch and
    pair counters move.
  * The ragged fit gives the padded fit's trees (quantization off) where
    every query fits the padded width; a query longer than the JAX
    package's width keeps every row; the binned-dataset cache keys on the
    query offsets; the ragged NDCG of ``eval_metric`` is the JAX package's
    padded one.
"""

import ctypes

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt import api as TA
from mmlspark_tpu_torch.models.gbdt import objectives as TO
from mmlspark_tpu_torch.models.gbdt.booster import (LightGBMDataset,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.ops import lambdarank as rank_ops
from perfbench.reference import lambdarank as ref

torch.set_num_threads(1)

# the ragged lambdas' tolerance against the float64 reference, as a share
# of the largest gradient and of the largest hessian
TOL = 2e-6
GAIN = (0.0, 1.0, 3.0, 7.0, 20.0)


def _queries(lengths, seed=0, tied=True, grades=5):
    """Rows of queries of ``lengths``: (scores, grades, weights, offsets);
    one query of all-equal grades and a run of tied scores when the
    lengths allow."""
    rng = np.random.default_rng(seed)
    off = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    n = int(off[-1])
    y = rng.integers(0, grades, n).astype(np.float32)
    s = rng.normal(size=n).astype(np.float32)
    if len(lengths) > 3:
        y[off[3]:off[4]] = 2.0
    if tied:
        big = int(np.argmax(lengths))
        s[off[big]:off[big] + min(10, lengths[big])] = 0.25
    return s, y, np.ones(n, np.float32), off


CASES = {
    "short-and-long": dict(lengths=[1, 2, 2, 5, 37, 300, 17, 64, 130],
                           max_position=20, sigma=1.0, label_gain=None),
    "truncated": dict(lengths=[2, 1, 9, 4, 140, 33], max_position=5,
                      sigma=2.0, label_gain=None),
    "gain-table": dict(lengths=[3, 1, 8, 8, 129, 50], max_position=10,
                       sigma=1.0, label_gain=GAIN),
    "first-round": dict(lengths=[1, 2, 6, 12, 200], max_position=20,
                        sigma=1.0, label_gain=None, zero_scores=True),
}


def _case(name):
    c = dict(CASES[name])
    s, y, w, off = _queries(c.pop("lengths"), seed=len(name))
    if c.pop("zero_scores", False):
        s[:] = 0.0              # every row of the first round ties
    return s, y, w, off, c


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_lambdas_agree_with_the_float64_reference(name):
    s, y, w, off, kw = _case(name)
    groups = TO.QueryGroups(off, y)
    g, h = TO.lambdarank_plain(torch.from_numpy(s), torch.from_numpy(y),
                               torch.from_numpy(w), groups,
                               kw["max_position"], kw["sigma"],
                               kw["label_gain"])
    want_g, want_h = ref.lambdas(torch.from_numpy(s), torch.from_numpy(y),
                                 off, kw["max_position"], kw["sigma"],
                                 kw["label_gain"])
    assert ref.lambda_gap(g, h, want_g, want_h) <= TOL
    bf16 = ref.lambda_gap(want_g.to(torch.bfloat16),
                          want_h.to(torch.bfloat16), want_g, want_h)
    assert bf16 > 100 * TOL
    # rows alone in their query, or of one grade, get nothing
    lengths = np.diff(off)
    for q in np.flatnonzero(lengths == 1):
        assert g[off[q]] == 0.0 and h[off[q]] == np.float32(1e-9)
    if len(lengths) > 3:
        assert not g[off[3]:off[4]].any()
    assert float(g.abs().max()) > 1e-3


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_lambdas_equal_the_padded_layout_where_queries_fit(name):
    s, y, w, off, kw = _case(name)
    lengths = np.diff(off)
    S = 1 << int(np.ceil(np.log2(lengths.max())))
    group = np.repeat(np.arange(len(lengths)), lengths)
    sp, yp, wp, valid, _ = TA._pad_groups(s[:, None], y, None, group, S)
    padded = TO.get_objective("lambdarank", group_size=S, **kw)
    pg, ph = padded.grad_hess(torch.from_numpy(sp[:, 0]),
                              torch.from_numpy(yp), torch.from_numpy(wp))
    ragged = TO.get_objective("lambdarank", queries=TO.QueryGroups(off, y),
                              **kw)
    g, h = ragged.grad_hess(*(torch.from_numpy(a) for a in (s, y, w)))
    keep = valid > 0
    np.testing.assert_allclose(g.numpy(), pg.numpy()[keep], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), ph.numpy()[keep], rtol=0,
                               atol=1e-6)


def test_query_groups_count_pairs_and_refuse_bad_offsets():
    s, y, w, off = _queries([1, 2, 5, 37, 300, 17])
    w[::7] = 0.0                       # weight-0 rows take no part
    groups = TO.QueryGroups(off, y, w)
    keep = w > 0
    want = sum(int((y[a:b][keep[a:b]][:, None]
                    > y[a:b][keep[a:b]][None, :]).sum())
               for a, b in zip(off[:-1], off[1:]))
    assert groups.pairs == want and groups.longest == 300
    assert (groups.n, groups.count) == (len(y), 6)
    for bad in (off[1:], np.r_[off[:-1], off[-1] + 1], off[::-1]):
        with pytest.raises(ValueError, match="offsets"):
            TO.QueryGroups(bad, y)


# --- the route a CUDA tensor takes ----------------------------------------

class _CudaTyped(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's tensor does, so the
    route a CUDA tensor takes runs here."""

    @property
    def is_cuda(self):
        return True


def _view(ptr, count, ctype):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def model_lambdarank(score, label, weight, offsets, table, max_position,
                     sigma):
    """``mm_lambdarank`` in NumPy float32: per query, ranks and ideal
    places counted, the discounts, maxDCG, each row's sums as the higher
    and as the lower item of its pairs."""
    f32 = np.float32
    n = score.size
    grad = np.zeros(n, f32)
    hess = np.zeros(n, f32)
    for b, e in zip(offsets[:-1], offsets[1:]):
        s, y, v = score[b:e], label[b:e], weight[b:e] > 0
        L = e - b
        if table is None:
            gain = np.exp2(y).astype(f32) - f32(1)
        else:
            gain = table[np.clip(y.astype(np.int32), 0, table.size - 1)]
        gain = np.where(v, gain, f32(0))
        sm = np.where(v, s, -np.inf).astype(f32)
        j = np.arange(L)
        earlier = j[None, :] < j[:, None]
        above = ((sm[None, :] > sm[:, None])
                 | ((sm[None, :] == sm[:, None]) & earlier)).sum(axis=1)
        ideal = ((gain[None, :] > gain[:, None])
                 | ((gain[None, :] == gain[:, None]) & earlier)).sum(axis=1)
        disc = np.where(v, f32(1) / np.log2(above.astype(f32) + f32(2)),
                        f32(0)).astype(f32)
        top = ideal < max_position
        maxdcg = max(f32(np.sum(np.where(top, gain * (f32(1) / np.log2(
            ideal.astype(f32) + f32(2))), f32(0)), dtype=f32)), f32(1e-12))
        pair = (y[:, None] > y[None, :]) & v[:, None] & v[None, :]
        delta = (np.abs(gain[:, None] - gain[None, :])
                 * np.abs(disc[:, None] - disc[None, :]) / maxdcg)
        sig = f32(1) / (f32(1) + np.exp(f32(sigma) * (s[:, None]
                                                      - s[None, :])))
        lam = np.where(pair, -f32(sigma) * sig * delta, f32(0))
        hp = np.where(pair, f32(sigma) ** 2 * sig * (1 - sig) * delta,
                      f32(0))
        grad[b:e] = lam.sum(axis=1) - lam.sum(axis=0)
        hess[b:e] = np.maximum(hp.sum(axis=1) + hp.sum(axis=0), f32(1e-9))
    return grad, hess


def _model_launch(calls):
    """``lambdarank._launch`` run by the model on the wrapper's buffers."""
    def launch(kernel, entry, args, dev):
        vals = [v for _, v in args]
        calls.append((kernel, entry, vals, [t for t, _ in args]))
        (score, label, weight, offsets, G, n, threads, smem_rows, scratch,
         table, n_table, max_position, sigma, grad, hess) = vals
        rows = [_view(p, n, ctypes.c_float) for p in (score, label, weight)]
        off = _view(offsets, G + 1, ctypes.c_longlong)
        tab = None if table is None else _view(table, n_table,
                                               ctypes.c_float)
        g, h = model_lambdarank(*rows, off, tab, max_position, sigma)
        _view(grad, n, ctypes.c_float)[:] = g
        _view(hess, n, ctypes.c_float)[:] = h
    return launch


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_cuda_tensor_reaches_the_kernel_with_the_queries(monkeypatch,
                                                           name):
    s, y, w, off, kw = _case(name)
    if name == "short-and-long":
        # one query past the kernel's shared-memory rows: the scratch
        s, y, w, off = _queries([3, rank_ops.SMEM_ROWS + 76, 9], seed=5)
    groups = TO.QueryGroups(off, y)
    calls = []
    monkeypatch.setattr(rank_ops, "_launch", _model_launch(calls))
    monkeypatch.setattr(TO, "lambdarank_plain", None)  # no CPU route
    launches, pairs = (rank_ops.lambdarank_cuda.launches,
                       rank_ops.lambdarank_cuda.pairs)
    obj = TO.get_objective("lambdarank", queries=groups, **kw)
    g, h = obj.grad_hess(*(torch.from_numpy(a).as_subclass(_CudaTyped)
                           for a in (s, y, w)))
    (kernel, entry, vals, types), = calls
    assert (kernel, entry) == ("lambdarank", "mm_lambdarank")
    G, n, threads, smem_rows, scratch, table, n_table = vals[4:11]
    max_position, sigma = vals[11:13]
    assert (G, n) == (len(off) - 1, len(y))
    assert (threads, smem_rows) == rank_ops.launch_shape(groups.longest)
    assert smem_rows == min(groups.longest, rank_ops.SMEM_ROWS)
    assert threads == (64 if groups.longest <= 256 else 256)
    assert (scratch is not None) == (groups.longest > rank_ops.SMEM_ROWS)
    assert n_table == (0 if kw["label_gain"] is None
                       else len(kw["label_gain"]))
    assert (max_position, sigma) == (kw["max_position"], kw["sigma"])
    assert types[4:8] == [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int]
    assert types[10:13] == [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    assert rank_ops.lambdarank_cuda.launches == launches + 1
    assert rank_ops.lambdarank_cuda.pairs == pairs + groups.pairs
    want_g, want_h = ref.lambdas(torch.from_numpy(s), torch.from_numpy(y),
                                 off, kw["max_position"], kw["sigma"],
                                 kw["label_gain"])
    assert ref.lambda_gap(g, h, want_g, want_h) <= TOL


@pytest.mark.parametrize("bad", ["dtype", "strided", "length", "offsets"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad):
    monkeypatch.setattr(rank_ops, "_launch", _model_launch([]))
    s, y, w, off = (torch.from_numpy(a) for a in _queries([4, 9, 3]))
    if bad == "dtype":
        s = s.double()
    elif bad == "strided":
        s = torch.stack([s, s], dim=1)[:, 0]
    elif bad == "length":
        w = w[:-1]
    else:
        off = off.to(torch.int32)
    with pytest.raises(ValueError):
        rank_ops.lambdarank_cuda(s, y, w, off, longest=9, pairs=1,
                                 max_position=20, sigma=1.0)


# --- fits -----------------------------------------------------------------

def _rank_rows(lengths, seed, F=4):
    """Features on a grid of quarters (0 among them, so padding rows add no
    bin bound), grades from a noisy function of them, query ids."""
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(len(lengths)), lengths)
    X = np.round(rng.normal(size=(len(group), F)) * 4).astype(np.float32) / 4
    rel = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.8 * rng.normal(size=len(group))
    y = np.digitize(rel, [-0.5, 0.3, 1.0, 1.8]).astype(np.float32)
    return X, y, group


@pytest.mark.parametrize("validation", [False, True],
                         ids=["train-only", "early-stopping"])
def test_ragged_fit_grows_the_padded_fits_trees(validation):
    lengths = np.random.default_rng(3).integers(1, 60, size=90)
    X, y, g = _rank_rows(lengths, 4)
    S = 64
    kw = dict(objective="lambdarank", num_iterations=4, max_bin=63,
              boost_from_average=False, device="cpu",
              cfg=GrowConfig(num_leaves=7, min_data_in_leaf=40,
                             learning_rate=0.3))
    rank = dict(max_position=10, eval_at=5, label_gain=GAIN)
    Xp, yp, wp, valid, _ = TA._pad_groups(X, y, None, g, S)
    pkw, rkw = {}, {}
    if validation:
        vlen = np.random.default_rng(5).integers(2, 40, size=30)
        Xv, yv, gv = _rank_rows(vlen, 6)
        Xvp, yvp, _, vv, _ = TA._pad_groups(Xv, yv, None, gv, S)
        gsz = vv.reshape(-1, S).sum(axis=1)
        wv = (vv.reshape(-1, S) / gsz[:, None]).reshape(-1)
        pkw = dict(valid_set=(Xvp, yvp, wv), early_stopping_rounds=1,
                   provide_training_metric=True)
        rkw = dict(valid_set=(Xv, yv, None, np.r_[0, np.cumsum(vlen)]),
                   early_stopping_rounds=1, provide_training_metric=True)
    padded = train_booster(Xp, yp, wp, row_valid=valid,
                           objective_kwargs=dict(group_size=S, **rank),
                           **pkw, **kw)
    ds = LightGBMDataset.construct(X, y, max_bin=63, device="cpu",
                                   query_offsets=np.r_[0, np.cumsum(
                                       lengths)])
    ragged = train_booster(dataset=ds, objective_kwargs=rank, **rkw, **kw)
    assert ragged.num_trees == padded.num_trees
    for f in ("feat", "thr_bin", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(ragged.trees[f], padded.trees[f],
                                      err_msg=f)
    np.testing.assert_allclose(ragged.predict_raw(X, device="cpu"),
                               padded.predict_raw(X, device="cpu"), rtol=0,
                               atol=1e-5)
    assert ragged.best_iteration == padded.best_iteration
    assert sorted(ragged.eval_history) == sorted(padded.eval_history)
    if validation:
        np.testing.assert_allclose(ragged.eval_history["ndcg"],
                                   padded.eval_history["ndcg"], rtol=1e-6)
        # the ragged training NDCG is the mean over the queries, as the
        # validation NDCG is; the padded layout's weighs each query by its
        # rows (its training rows weigh 1)
        train = ragged.eval_history["training_ndcg"]
        assert len(train) == len(padded.eval_history["training_ndcg"])
        assert all(0.0 < v <= 1.0 for v in train)


def test_a_query_longer_than_the_padded_width_keeps_every_row():
    lengths = np.r_[np.full(40, 12), 300]
    X, y, g = _rank_rows(lengths, 7)
    TA.clear_binned_dataset_cache()
    model = TA.LightGBMRanker(device="cpu", groupCol="query", numIterations=2,
                              numLeaves=7, maxBin=63, maxGroupSize=128).fit(
        Dataset({"features": X, "label": y, "query": g}))
    (ds,) = TA._BINNED_CACHE.values()
    assert ds.n == len(y) == 780 and ds.queries.longest == 300
    obj = TO.get_objective("lambdarank", queries=ds.queries,
                           **model.booster.objective_kwargs)
    grad, _ = obj.grad_hess(torch.zeros(len(y)), ds.y, ds.w)
    past = grad[480 + 128:]                  # the long query's rows past 128
    assert past.abs().max() > 1e-3
    assert "group_size" not in model.booster.objective_kwargs
    TA.clear_binned_dataset_cache()


def test_the_binned_cache_keys_on_the_query_offsets():
    X, y, g = _rank_rows(np.full(20, 16), 8)
    params = dict(device="cpu", groupCol="query", numIterations=1,
                  numLeaves=7, maxBin=63)
    other = np.repeat(np.arange(40), 8)           # the same rows, other queries
    TA.clear_binned_dataset_cache()
    TA.binned_cache_stats(reset=True)
    for q in (g, other, g):
        TA.LightGBMRanker(**params).fit(
            Dataset({"features": X, "label": y, "query": q}))
    assert TA.binned_cache_stats() == {"hits": 1, "misses": 2}
    keys = list(TA._BINNED_CACHE)           # the offsets' fingerprint
    assert [k[:-2] + k[-1:] for k in keys] == [keys[0][:-2] + keys[0][-1:]] * 2
    assert keys[0][-2] != keys[1][-2] and None not in (keys[0][-2],
                                                      keys[1][-2])
    TA.clear_binned_dataset_cache()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_ndcg_is_the_jax_packages_padded_ndcg(name):
    s, y, w, off, kw = _case(name)
    lengths = np.diff(off)
    S = 1 << int(np.ceil(np.log2(lengths.max())))
    group = np.repeat(np.arange(len(lengths)), lengths)
    sp, yp, _, valid, _ = TA._pad_groups(s[:, None], y, None, group, S)
    wv = (valid.reshape(-1, S) / valid.reshape(-1, S).sum(axis=1)[:, None]
          ).reshape(-1)
    jkw = dict(group_size=S, max_position=kw["max_position"], eval_at=5,
               label_gain=kw["label_gain"])
    jo = JO.get_objective("lambdarank", **jkw)
    _, want = JO.eval_metric(jo, sp[:, 0], yp, wv.astype(np.float32), **jkw)
    groups = TO.QueryGroups(off, y)
    to = TO.get_objective("lambdarank", queries=groups, **kw)
    name_, got = TO.eval_metric(
        to, *(torch.from_numpy(a) for a in (s, y, w)), queries=groups,
        eval_at=5, max_position=kw["max_position"],
        label_gain=kw["label_gain"])
    assert name_ == "ndcg"
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert 0.0 < float(got) <= 1.0
