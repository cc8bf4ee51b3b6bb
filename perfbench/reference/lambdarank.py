"""The plain reference of a LambdaRank fit: the lambdas in float64, query by
query, and an audit of the fitted trees against them.

The lambdas follow the contract the configuration states (the port's and
the JAX package's formula; ``configs/yahoo-ltr-lambdarank-qgrad.json``
lists where it departs from LightGBM's ``rank_objective.hpp``). For each
query, all of its rows, no padding:

* gains ``2^y - 1`` (or the configuration's table), each row's rank by
  descending score (a stable sort: tied scores keep row order) and its
  discount ``1 / log2(rank + 2)``;
* ``maxDCG``: the gains sorted descending over their first
  ``max_position`` places, each over ``log2(place + 2)``; at least 1e-12;
* for every pair ``y_i > y_j``: ``delta = |gain_i - gain_j| |disc_i -
  disc_j| / maxDCG``, ``sig = 1 / (1 + exp(sigma (s_i - s_j)))``, lambda
  ``-sigma sig delta`` added to row i's gradient and taken from row j's,
  ``sigma^2 sig (1 - sig) delta`` added to both hessians;
* hessians at least 1e-9.

Queries of one length are taken together as the rows of one ``[Q, L]``
batch: each row is one whole query, nothing padded. The audit is
:func:`.gbdt.audit_tree` fed these lambdas, as :func:`.gbdt.audit_fit`
feeds it the learner's gradients, at the margins the learner holds:
float32, each tree's leaf value added in tree order (the configuration's
precision). The ranks read the margins' order, so margins summed in
float64 and rounded once would break near ties the other way and move a
query's lambdas far more than their rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import gbdt


def gains(y: torch.Tensor, label_gain=None) -> torch.Tensor:
    """float64 gains of grades ``y``: ``2^y - 1``, or ``label_gain[y]``."""
    y = y.double()
    if label_gain is None:
        return torch.exp2(y) - 1.0
    table = torch.as_tensor(label_gain, dtype=torch.float64, device=y.device)
    return table[y.long().clamp(0, table.numel() - 1)]


def _by_length(offsets: np.ndarray):
    """``(length, [Q, length] row indexes)`` for each length of query."""
    off = np.asarray(offsets, np.int64)
    lengths = np.diff(off)
    for L in np.unique(lengths[lengths > 0]):
        starts = off[:-1][lengths == L]
        yield int(L), starts[:, None] + np.arange(L)[None, :]


def lambdas(scores: torch.Tensor, y: torch.Tensor, offsets: np.ndarray,
            max_position: int, sigma: float, label_gain=None):
    """float64 ``(grad, hess)`` ``[n]`` of LambdaRank at ``scores``."""
    dev = scores.device
    s_all = scores.double()
    g_all = gains(y, label_gain)
    grad = torch.zeros_like(s_all)
    hess = torch.zeros_like(s_all)
    for L, rows_np in _by_length(offsets):
        rows = torch.from_numpy(rows_np).to(dev)
        s, yy, gn = s_all[rows], y.double()[rows], g_all[rows]
        order = torch.sort(-s, dim=1, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(L, device=dev).expand_as(order))
        disc = 1.0 / torch.log2(rank.double() + 2.0)
        ideal = torch.sort(gn, dim=1, descending=True).values
        place = torch.arange(L, device=dev, dtype=torch.float64)
        top = torch.where(place < max_position, 1.0 / torch.log2(place + 2.0),
                          torch.zeros_like(place))
        maxdcg = (ideal * top).sum(dim=1).clamp(min=1e-12)
        pair = yy[:, :, None] > yy[:, None, :]
        delta = ((gn[:, :, None] - gn[:, None, :]).abs()
                 * (disc[:, :, None] - disc[:, None, :]).abs()
                 / maxdcg[:, None, None])
        sig = 1.0 / (1.0 + torch.exp(sigma * (s[:, :, None] - s[:, None, :])))
        lam = torch.where(pair, -sigma * sig * delta, 0.0)
        h = torch.where(pair, sigma * sigma * sig * (1.0 - sig) * delta, 0.0)
        grad[rows] = lam.sum(dim=2) - lam.sum(dim=1)
        hess[rows] = h.sum(dim=2) + h.sum(dim=1)
    return grad, hess.clamp(min=1e-9)


def lambda_gap(got_grad, got_hess, want_grad, want_hess) -> float:
    """The widest error of the gradients and of the hessians, each against
    the largest magnitude of its kind."""
    out = 0.0
    for got, want in ((got_grad, want_grad), (got_hess, want_hess)):
        scale = float(want.abs().max())
        out = max(out, float((got.double() - want).abs().max())
                  / max(scale, 1e-300))
    return out


def _add_trees_f32(text_model, bins: torch.Tensor, bounds: np.ndarray,
                   scores: torch.Tensor, start: int, stop: int
                   ) -> torch.Tensor:
    """``scores`` ``[n]`` float32 with trees ``[start, stop)`` added one
    at a time, each row's leaf value rounded to float32 and added in
    float32, routing rows on the reference's bins."""
    for t in range(start, stop):
        tree = text_model.trees[t]
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                             device=bins.device).float()
        scores = scores + lv[gbdt._leaves_binned(tree, bins, bounds)]
    return scores


def audit_fit(text_model, bins: torch.Tensor, bounds: np.ndarray,
              y: torch.Tensor, offsets: np.ndarray, lr: gbdt.Learner,
              rounds: Sequence[int], max_position: int, sigma: float,
              label_gain=None, program=None,
              control_stats: Optional[str] = None) -> Dict[str, float]:
    """Audit the trees of the boosting ``rounds`` of a fitted ranker
    (``lr.num_class`` 1, starting margins 0) against these lambdas, and
    hold the program's own lambdas to them: ``program(scores) -> (grad,
    hess)``, the program's objective at float32 ``scores``. The margins
    before round ``r`` are the model's trees of the earlier rounds on the
    reference's bins, added in float32 in tree order. Readings: those of
    :func:`.gbdt.audit_fit` and ``lambda_err`` (:func:`lambda_gap`; with
    ``control_stats``, the reference's own lambdas rounded to that type
    stand in the program's)."""
    n = bins.shape[1]
    dev = bins.device
    s32 = torch.zeros(n, dtype=torch.float32, device=dev)
    done = 0
    parts: Dict[str, List[torch.Tensor]] = {}
    lam_err = 0.0
    for r in sorted(rounds):
        if r > 0:
            s32 = _add_trees_f32(text_model, bins, bounds, s32, done, r)
            done = r
        g, h = lambdas(s32, y, offsets, max_position, sigma, label_gain)
        if control_stats is not None:
            kind = getattr(torch, control_stats)
            pg, ph = g.to(kind), h.to(kind)
        else:
            pg, ph = program(s32)
        lam_err = max(lam_err, lambda_gap(pg, ph, g, h))
        for key, v in gbdt.audit_tree(bins, g.float().double(),
                                      h.float().double(),
                                      text_model.trees[r], bounds, lr, 0.0,
                                      control_stats).items():
            parts.setdefault(key, []).append(v)
    cat = {k: torch.cat(v) for k, v in parts.items()}

    def off(ref, prog):          # a count is a float sum on the program's side
        return int(((ref - prog).abs() > 0.5).sum())

    read = dict(leaf_err=gbdt._widest(cat["leaf_prog"] - cat["leaf_ref"],
                                      cat["leaf_ref"]), gain_gap=0.0,
                left_gain=0.0, splits_off=0, lambda_err=lam_err)
    count_off = off(cat["leaf_count_ref"], cat["leaf_count_prog"])
    chosen = None
    if "best" in cat:
        count_off += off(cat["count_ref"], cat["count_prog"])
        read["splits_off"] = int((~cat["allowed"]).sum())
        read["gain_gap"] = gbdt._widest(
            (cat["best"] - cat["chosen"]).clamp(min=0.0), cat["best"])
        chosen = cat["chosen"].abs().median()
    if "left_gain" in cat:
        left = cat["left_gain"]
        scale = left if chosen is None else torch.maximum(left, chosen)
        read["left_gain"] = float((left / scale.clamp(min=1e-300)).max())
    read["counts_off"] = count_off
    return read
