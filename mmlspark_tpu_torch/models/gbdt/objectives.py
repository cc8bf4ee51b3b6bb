"""GBDT objectives: gradients/hessians, score transforms, eval metrics.

Counterpart of ``mmlspark_tpu/models/gbdt/objectives.py``, every objective:
``binary`` (with ``pos_weight``, isUnbalance), the regression family (l2,
l1, huber, fair, quantile, poisson, tweedie, mape), ``multiclass`` (softmax
over ``num_class`` score columns) and ``lambdarank`` (pairwise lambdas over
query groups of any length, :class:`QueryGroups`; or padded to a fixed
width, the JAX package's layout, which the ranker keeps over a data group
of several ranks). All are torch ops on the tensors' own device but the
ragged lambdas on the card, one launch of ``csrc/lambdarank.cu`` a round;
:func:`auc_weighted` is host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ...observability import spans as _spans
from ...ops.lambdarank import lambdarank_cuda


class Objective(NamedTuple):
    name: str
    # (scores [n] or [n, K], label [n], weight [n]) -> (grad, hess) same shape
    grad_hess: Callable
    # raw score -> prediction-space transform (sigmoid/softmax/exp/identity)
    transform: Callable
    num_scores: int = 1  # per-class score columns (1 unless multiclass)
    init_score: Callable = None  # (label, weight) -> scalar base score


def _mean_init(y, w):
    return torch.sum(y * w) / torch.sum(w)


def _log_mean_init(y, w):
    return torch.log(torch.clamp(_mean_init(y, w), min=1e-15))


def _zero_init(y, w):
    return torch.zeros((), dtype=torch.float32, device=y.device)


def _identity(s):
    return s


def _binary(label_pos_weight: float = 1.0):
    def grad_hess(score, y, w):
        p = torch.sigmoid(score)
        # isUnbalance / scale_pos_weight: positives get extra weight
        wy = w * torch.where(y > 0, torch.full_like(w, label_pos_weight),
                             torch.ones_like(w))
        return (p - y) * wy, p * (1 - p) * wy

    def init_score(y, w):
        p = torch.clamp(torch.sum(y * w) / torch.sum(w), 1e-15, 1 - 1e-15)
        return torch.log(p / (1 - p))

    return Objective("binary", grad_hess, torch.sigmoid, 1, init_score)


def _regression_l2():
    def grad_hess(score, y, w):
        return (score - y) * w, w

    return Objective("regression", grad_hess, _identity, 1, _mean_init)


def weighted_quantile(y, w, q):
    """Weighted q-quantile: smallest y with cumulative weight >= q * total.

    Zero weights (padding, row_valid) drop out, as LightGBM's weighted
    percentile for l1/quantile BoostFromAverage does."""
    order = torch.argsort(y, stable=True)
    ys, ws = y[order], w[order]
    cw = torch.cumsum(ws, dim=0)
    target = q * cw[-1]
    idx = torch.searchsorted(cw, target.reshape(1), right=False)
    return ys[idx.clamp(max=ys.shape[0] - 1)][0]


def _regression_l1():
    def grad_hess(score, y, w):
        return torch.sign(score - y) * w, w  # constant-hessian approximation

    return Objective("regression_l1", grad_hess, _identity, 1,
                     lambda y, w: weighted_quantile(y, w, 0.5))


def _huber(alpha: float = 0.9):
    def grad_hess(score, y, w):
        d = score - y
        g = torch.where(torch.abs(d) <= alpha, d, alpha * torch.sign(d))
        return g * w, w

    return Objective("huber", grad_hess, _identity, 1, _mean_init)


def _fair(c: float = 1.0):
    def grad_hess(score, y, w):
        d = score - y
        g = c * d / (torch.abs(d) + c)
        h = c * c / (torch.abs(d) + c) ** 2
        return g * w, h * w

    return Objective("fair", grad_hess, _identity, 1, _mean_init)


def _quantile(alpha: float = 0.5):
    def grad_hess(score, y, w):
        d = score - y
        g = torch.where(d >= 0, torch.full_like(d, 1.0 - alpha),
                        torch.full_like(d, -alpha))
        return g * w, w

    return Objective("quantile", grad_hess, _identity, 1,
                     lambda y, w: weighted_quantile(y, w, alpha))


def _poisson():
    def grad_hess(score, y, w):
        e = torch.exp(score)
        return (e - y) * w, e * w

    return Objective("poisson", grad_hess, torch.exp, 1, _log_mean_init)


def _tweedie(rho: float = 1.5):
    def grad_hess(score, y, w):
        e1 = torch.exp((1 - rho) * score)
        e2 = torch.exp((2 - rho) * score)
        g = -y * e1 + e2
        h = -y * (1 - rho) * e1 + (2 - rho) * e2
        return g * w, torch.clamp(h, min=1e-15) * w

    return Objective("tweedie", grad_hess, torch.exp, 1, _log_mean_init)


def _mape():
    def grad_hess(score, y, w):
        scale = 1.0 / torch.clamp(torch.abs(y), min=1.0)
        return torch.sign(score - y) * scale * w, scale * w

    return Objective("mape", grad_hess, _identity, 1, _mean_init)


def _softmax(s):
    return torch.softmax(s, dim=-1)


def _multiclass(num_class: int):
    def grad_hess(scores, y, w):  # scores [n, K], y [n] class ids
        p = torch.softmax(scores, dim=-1)
        onehot = torch.nn.functional.one_hot(y.long(), num_class).to(p.dtype)
        g = (p - onehot) * w[:, None]
        # LightGBM's multiclass hessian carries a factor of 2 (softmax upper
        # bound)
        h = 2.0 * p * (1 - p) * w[:, None]
        return g, h

    return Objective("multiclass", grad_hess, _softmax, num_class,
                     _zero_init)


def _label_gains(yy, label_gain):
    """Per-item NDCG gains: LightGBM's default 2^label - 1, or the explicit
    ``label_gain`` table (grade g gains label_gain[g])."""
    if label_gain is None:
        return torch.exp2(yy) - 1.0
    table = torch.tensor(label_gain, dtype=torch.float32, device=yy.device)
    idx = torch.clamp(yy.to(torch.int32), 0, table.shape[0] - 1)
    return table[idx.long()]


def _ranks(score, mask):
    """Each item's rank in its group by descending score, padding last.
    The sort is stable, as ``jnp.argsort`` is: on tied scores (every row
    of the first iteration scores the same) rank follows row order."""
    sm = torch.where(mask, score, torch.full_like(score, float("-inf")))
    order = torch.argsort(-sm, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def _position_discounts(S: int, max_position: int, device):
    """``1 / log2(pos + 2)`` for the first ``max_position`` positions of a
    group of width S, 0 beyond."""
    pos = torch.arange(S, device=device)
    return torch.where(pos < max_position, 1.0 / torch.log2(pos + 2.0),
                       torch.zeros((), device=device))


def _max_dcg(gains, mask, max_position: int):
    """Ideal DCG: gains sorted descending, truncated at max_position."""
    g_sorted = -torch.sort(-torch.where(mask, gains, torch.zeros_like(gains)),
                           dim=1).values
    d = _position_discounts(gains.shape[1], max_position, gains.device)
    return (g_sorted * d[None, :]).sum(dim=1)


def _dense_lambdas(s, yy, mask, max_position: int, sigma: float,
                   label_gain):
    """LambdaRank's pairwise gradients and (unclamped) hessians of groups
    laid out as rows of ``[G, S]`` (``mask``: the items that take part):
    every pair ``y_i > y_j`` of a group, ranks by descending score,
    ``|dgain| |ddiscount| / maxDCG@max_position`` times the sigmoid terms."""
    gains = _label_gains(yy, label_gain) * mask
    ranks = _ranks(s, mask)
    disc = 1.0 / torch.log2(ranks.to(torch.float32) + 2.0) * mask
    maxdcg = torch.clamp(_max_dcg(gains, mask, max_position), min=1e-12)

    sdiff = s[:, :, None] - s[:, None, :]
    pair = (mask[:, :, None] & mask[:, None, :]
            & (yy[:, :, None] > yy[:, None, :]))
    delta = (torch.abs(gains[:, :, None] - gains[:, None, :])
             * torch.abs(disc[:, :, None] - disc[:, None, :])
             / maxdcg[:, None, None])
    sig = torch.sigmoid(-sigma * sdiff)
    zero = torch.zeros((), device=s.device)
    lam = torch.where(pair, -sigma * sig * delta, zero)
    hpair = torch.where(pair, sigma * sigma * sig * (1.0 - sig) * delta,
                        zero)
    return lam.sum(dim=2) - lam.sum(dim=1), hpair.sum(dim=2) + hpair.sum(dim=1)


def _lambdarank(group_size: int, max_position: int = 20, sigma: float = 1.0,
                label_gain=None):
    """LambdaRank pairwise gradients over fixed-size padded query groups.

    Every group is padded to a static ``group_size`` S, so the all-pairs
    lambdas are one dense ``[G, S, S]`` batch (the JAX package's layout).
    Row weight doubles as the validity mask (0 = in-group padding). The
    ranker takes this layout only over a data group of several ranks;
    one process fits ragged groups (:func:`_lambdarank_ragged`)."""
    S = int(group_size)

    def grad_hess(score, y, w):
        grad, hess = _dense_lambdas(score.reshape(-1, S), y.reshape(-1, S),
                                    w.reshape(-1, S) > 0, max_position,
                                    sigma, label_gain)
        return grad.reshape(-1), torch.clamp(hess, min=1e-9).reshape(-1)

    return Objective("lambdarank", grad_hess, _identity, 1, _zero_init)


class QueryGroups:
    """The query boundaries of rows sorted by query (LightGBM's query
    metadata): query ``q`` holds rows ``[offsets[q], offsets[q + 1])``,
    from row 0 to row ``n``, any length. ``pairs`` counts the pairs
    ``(i, j)`` of one query with ``y_i > y_j`` among its rows of weight
    above 0: the pairs LambdaRank evaluates a round. Device copies of the
    offsets and the plain version's buckets are made once per device."""

    def __init__(self, offsets, y, w=None):
        off = np.asarray(offsets, np.int64).reshape(-1)
        y = np.asarray(y, np.float32).reshape(-1)
        if (off.size < 1 or off[0] != 0 or off[-1] != y.size
                or np.any(np.diff(off) < 0)):
            raise ValueError(
                f"query offsets must rise from 0 to the {y.size} rows, got "
                f"{off.size} offsets from {off[:1]} to {off[-1:]}")
        self.offsets = off
        lengths = np.diff(off)
        self.longest = int(lengths.max()) if lengths.size else 0
        qid = np.repeat(np.arange(lengths.size), lengths)
        keep = (np.ones(y.size, bool) if w is None
                else np.asarray(w, np.float32).reshape(-1) > 0)
        qid, yk = qid[keep], y[keep]
        # pairs of a query with unequal grades: (m^2 - sum of c^2) / 2 over
        # its m kept rows, c the rows of each grade
        order = np.lexsort((yk, qid))
        qs, ys = qid[order], yk[order]
        new = np.r_[True, (qs[1:] != qs[:-1]) | (ys[1:] != ys[:-1])]
        runs = np.diff(np.r_[np.flatnonzero(new), qs.size])
        m = np.bincount(qid, minlength=lengths.size)
        self.pairs = int((np.sum(m.astype(np.int64) ** 2)
                          - np.sum(runs.astype(np.int64) ** 2)) // 2)
        self._on: dict = {}

    @property
    def n(self) -> int:
        return int(self.offsets[-1])

    @property
    def count(self) -> int:
        return int(self.offsets.size - 1)

    def offsets_on(self, device) -> torch.Tensor:
        """The ``[G + 1]`` int64 offsets on ``device``."""
        key = ("offsets", str(device))
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.offsets).to(device)
        return self._on[key]

    def buckets_on(self, device) -> list:
        """``[(queries, rows, mask)]``: the queries grouped by the power of
        two at or above their length W, each group as its query indexes,
        ``[Gb, W]`` row indexes (0 past a query's end) and the mask of its
        real rows."""
        key = ("buckets", str(device))
        if key not in self._on:
            lengths = np.diff(self.offsets)
            width = np.where(lengths <= 1, 1, 1 << np.ceil(np.log2(
                np.maximum(lengths, 1))).astype(np.int64))
            out = []
            for W in np.unique(width[lengths > 0]):
                q = np.flatnonzero((width == W) & (lengths > 0))
                cols = np.arange(W)
                mask = cols[None, :] < lengths[q][:, None]
                rows = np.where(mask, self.offsets[q][:, None] + cols, 0)
                out.append((torch.from_numpy(q).to(device),
                            torch.from_numpy(rows).to(device),
                            torch.from_numpy(mask).to(device)))
            self._on[key] = out
        return self._on[key]


def lambdarank_plain(score, y, w, groups: QueryGroups, max_position: int,
                     sigma: float, label_gain=None):
    """LambdaRank's ``(grad, hess)`` over ragged query groups in plain torch
    ops (the CPU's route, and what the card's ``lambdarank`` kernel is
    held to): each bucket of :meth:`QueryGroups.buckets_on` through the
    padded layout's formula, rows of weight 0 taking no part."""
    lambdarank_plain.calls += 1
    grad = torch.zeros_like(score)
    hess = torch.zeros_like(score)
    for _, rows, real in groups.buckets_on(score.device):
        g, h = _dense_lambdas(score[rows], y[rows], real & (w[rows] > 0),
                              max_position, sigma, label_gain)
        grad[rows[real]] = g[real]
        hess[rows[real]] = h[real]
    return grad, torch.clamp(hess, min=1e-9)


lambdarank_plain.calls = 0


def _lambdarank_ragged(groups: QueryGroups, max_position: int = 20,
                       sigma: float = 1.0, label_gain=None):
    """LambdaRank over query groups of any length, no padding: the padded
    layout's formula (:func:`_dense_lambdas`) query by query. On a CUDA
    tensor one launch of ``csrc/lambdarank.cu`` a round; on the CPU
    :func:`lambdarank_plain`. Inside a ``gbdt.rank.lambdas`` device
    span."""
    tables: dict = {}

    def grad_hess(score, y, w):
        with _spans.span("gbdt.rank.lambdas", device=score.device,
                         publish=False):
            if not score.is_cuda:
                return lambdarank_plain(score, y, w, groups, max_position,
                                        sigma, label_gain)
            dev = str(score.device)
            if label_gain is not None and dev not in tables:
                tables[dev] = torch.tensor(label_gain, dtype=torch.float32,
                                           device=score.device)
            return lambdarank_cuda(
                score, y, w, groups.offsets_on(score.device),
                longest=groups.longest, pairs=groups.pairs,
                max_position=max_position, sigma=sigma,
                gain_table=tables.get(dev))

    return Objective("lambdarank", grad_hess, _identity, 1, _zero_init)


def _ndcg_dense(s, yy, mask, max_position: int, label_gain=None):
    """``[G]`` NDCG@max_position of groups laid out as rows of ``[G, S]``."""
    gains = _label_gains(yy, label_gain) * mask
    ranks = _ranks(s, mask)
    disc = torch.where(ranks < max_position,
                       1.0 / torch.log2(ranks.to(torch.float32) + 2.0),
                       torch.zeros((), device=s.device))
    dcg = (gains * disc * mask).sum(dim=1)
    idcg = torch.clamp(_max_dcg(gains, mask, max_position), min=1e-12)
    return dcg / idcg


def _ndcg_metric(scores, y, w, S: int, max_position: int, label_gain=None):
    """Per-row NDCG@max_position of each row's group (weighted mean by the
    caller: w = 1/group_size on valid rows gives the mean over groups)."""
    ndcg = _ndcg_dense(scores.reshape(-1, S), y.reshape(-1, S),
                       w.reshape(-1, S) > 0, max_position, label_gain)
    return ndcg[:, None].expand(ndcg.shape[0], S).reshape(-1)


def ndcg_ragged(scores, y, w, groups: QueryGroups, max_position: int,
                label_gain=None) -> torch.Tensor:
    """``[G']`` NDCG@max_position of every query with a row of weight above
    0, in query order, query groups of any length."""
    out = torch.zeros(groups.count, dtype=torch.float32, device=scores.device)
    has = torch.zeros(groups.count, dtype=torch.bool, device=scores.device)
    for q, rows, real in groups.buckets_on(scores.device):
        m = real & (w[rows] > 0)
        out[q] = _ndcg_dense(scores[rows], y[rows], m, max_position,
                             label_gain)
        has[q] = m.any(dim=1)
    return out[has]


def get_objective(name: str, num_class: int = 1, alpha: float = 0.9,
                  tweedie_variance_power: float = 1.5,
                  pos_weight: float = 1.0, group_size: int = 0,
                  max_position: int = 20, sigma: float = 1.0,
                  label_gain=None, queries: "QueryGroups" = None,
                  **_metric_only) -> Objective:
    name = (name or "").lower()
    if name in ("binary", "logistic"):
        return _binary(pos_weight)
    if name in ("multiclass", "softmax"):
        return _multiclass(num_class)
    if name in ("regression", "regression_l2", "l2", "mse",
                "mean_squared_error", ""):
        return _regression_l2()
    if name in ("regression_l1", "l1", "mae"):
        return _regression_l1()
    if name == "huber":
        return _huber(alpha)
    if name == "fair":
        return _fair()
    if name == "quantile":
        return _quantile(alpha)
    if name == "poisson":
        return _poisson()
    if name == "tweedie":
        return _tweedie(tweedie_variance_power)
    if name == "mape":
        return _mape()
    if name == "lambdarank":
        if queries is not None:
            return _lambdarank_ragged(queries, max_position, sigma,
                                      label_gain)
        if group_size <= 0:
            # scoring-only: a loaded ranker predicts raw scores without the
            # training-time group layout; only training with it errors
            def _no_train(*_a, **_k):
                raise ValueError(
                    "lambdarank training requires query groups (or "
                    "group_size, the padded group width); this objective "
                    "instance is scoring-only")
            return Objective("lambdarank", _no_train, _identity, 1,
                             _zero_init)
        return _lambdarank(group_size, max_position, sigma, label_gain)
    raise ValueError(f"unknown objective {name!r}")


def score_transform(objective: str, num_class: int = 1, **kwargs):
    """Raw-margin -> prediction-space transform, in f32: ``[n, K] -> [n, K]``
    softmax over classes for multiclass, else ``[n, 1] -> [n]`` with the
    objective's own elementwise transform."""
    if num_class > 1:
        return lambda raw: torch.softmax(raw.to(torch.float32), dim=-1)
    transform = get_objective(objective, num_class, **kwargs).transform
    return lambda raw: transform(raw[:, 0].to(torch.float32))


# -- eval metrics for early stopping (reference: TrainUtils.scala:220-315) ----


HIGHER_IS_BETTER = {"ndcg", "auc", "map"}

# metric-param override support (LightGBM `metric`): which eval metrics each
# objective family accepts. "auc" is computed on the host (an exact rank
# statistic, not a weighted mean); every other metric on the device.
SUPPORTED_EVAL_METRICS = {
    "binary": ("binary_logloss", "binary_error", "auc"),
    "multiclass": ("multi_logloss", "multi_error"),
    "lambdarank": ("ndcg",),
    "_regression": ("rmse", "l2", "mae", "l1"),
}


def metric_family(objective: str) -> str:
    """The ``SUPPORTED_EVAL_METRICS`` key of an objective name."""
    return (objective if objective in ("binary", "multiclass", "lambdarank")
            else "_regression")


def eval_metric(objective: Objective, scores, y, w,
                group_size: int = 0, max_position: int = 20,
                eval_at: int = 0, metric: str = None,
                label_gain=None, queries: QueryGroups = None,
                **_unused) -> Tuple[str, torch.Tensor]:
    """The objective's eval metric as a weighted mean (the caller knows
    whether higher is better).

    ``metric`` overrides the default with another supported metric of the
    same family (validated by the caller against SUPPORTED_EVAL_METRICS).
    ``eval_at`` truncates NDCG independently of the lambdarank training
    truncation ``max_position``. LambdaRank's NDCG is the mean over the
    query groups, ragged (``queries``, the rows' :class:`QueryGroups`) or
    padded to ``group_size``."""
    name = objective.name
    if name == "lambdarank" and queries is None and int(group_size) <= 0:
        raise ValueError(
            "lambdarank training/evaluation requires query groups or "
            "group_size (padded group width); a model loaded for scoring "
            "cannot train")
    if metric:
        if name == "binary" and metric == "binary_error":
            miss = ((scores > 0.0) != (y > 0.5)).to(torch.float32)
            return "binary_error", torch.sum(miss * w) / torch.sum(w)
        if name == "multiclass" and metric == "multi_error":
            pred = torch.argmax(scores, dim=-1)
            miss = (pred != y.long()).to(torch.float32)
            return "multi_error", torch.sum(miss * w) / torch.sum(w)
        if name not in ("binary", "multiclass", "lambdarank"):
            pred = objective.transform(scores)
            if metric in ("mae", "l1"):
                # l1 is LightGBM's alias for mae; the history keeps the
                # requested name
                return metric, (torch.sum(torch.abs(pred - y) * w)
                                / torch.sum(w))
            if metric == "l2":
                # LightGBM l2 is the MSE, not the RMSE
                return "l2", torch.sum((pred - y) ** 2 * w) / torch.sum(w)
        # the remaining supported values are the family defaults (auc is
        # computed on the host and never reaches this function)
    if name == "lambdarank" and queries is not None:
        if scores.shape[0] != queries.n:
            return "ndcg", torch.zeros(())             # shape probe only
        vals = ndcg_ragged(scores, y, w, queries, eval_at or max_position,
                           label_gain)
        return "ndcg", vals.sum() / max(vals.shape[0], 1)
    if name == "lambdarank":
        S = int(group_size)
        if scores.shape[0] < S or scores.shape[0] % S != 0:
            return "ndcg", torch.zeros(())             # shape probe only
        vals = _ndcg_metric(scores, y, w, S, eval_at or max_position,
                            label_gain)
        return "ndcg", (torch.sum(vals * w)
                        / torch.clamp(torch.sum(w), min=1e-12))
    if name == "binary":
        p = torch.clamp(torch.sigmoid(scores), 1e-15, 1 - 1e-15)
        ll = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
        return "binary_logloss", torch.sum(ll * w) / torch.sum(w)
    if name == "multiclass":
        logp = torch.log_softmax(scores, dim=-1)
        pick = logp.gather(1, y.long()[:, None])[:, 0]
        return "multi_logloss", -torch.sum(pick * w) / torch.sum(w)
    pred = objective.transform(scores)
    se = (pred - y) ** 2
    return "rmse", torch.sqrt(torch.sum(se * w) / torch.sum(w))


def auc_weighted(scores, y, w) -> float:
    """Exact weighted AUC with tie-averaged ranks (host numpy; LightGBM's
    binary ``auc`` semantics), for metric="auc" early stopping."""
    scores = np.asarray(scores, np.float64)
    pos = np.asarray(y, np.float64) > 0.5
    w = (np.ones_like(scores) if w is None
         else np.asarray(w, np.float64))
    order = np.argsort(scores, kind="mergesort")
    s, p, ww = scores[order], pos[order], w[order]
    wpos = np.where(p, ww, 0.0)
    wneg = np.where(p, 0.0, ww)
    # tie groups: runs of equal score share a rank; a positive in a group
    # is "above" all lighter negatives plus half the group's own negatives
    starts = np.flatnonzero(np.concatenate([[True], np.diff(s) != 0]))
    gpos = np.add.reduceat(wpos, starts)
    gneg = np.add.reduceat(wneg, starts)
    cneg_before = np.concatenate([[0.0], np.cumsum(gneg)[:-1]])
    tp, tn = wpos.sum(), wneg.sum()
    if tp <= 0 or tn <= 0:
        return 0.5               # degenerate: single class (LightGBM: NaN)
    return float(np.sum(gpos * (cneg_before + 0.5 * gneg)) / (tp * tn))
