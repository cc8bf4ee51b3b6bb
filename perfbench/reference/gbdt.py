"""The plain reference of a GBDT fit: binning, and an audit of the fitted
trees against the learner the configuration states.

The reference does not regrow the forest: a regrowth in float64 would part
from the program's float32 one at the first near tie and never meet it
again. It follows the program instead, tree by tree, from the program's own
output. For each audited tree it works out, from the rows, the labels and
the margins of the trees before it, the gradients and, for every node of
the tree, the statistics and the best split the learner allows. What it
compares:

* ingest: the bin bounds, recomputed from the rows, and every row's bin;
* split search: each node's row count, whether the split is one the
  learner allows, and how far its gain lies below the best split at that
  node;
* leaf values: each leaf's Newton step from its rows' gradients;
* predict: the margins of held-out rows (:mod:`.forest`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import forest
from perfbench.reference.lgbm_text import TextModel, TextTree


@dataclass(frozen=True)
class Learner:
    """What the configuration states about the fit."""
    objective: str                 # "binary" or "multiclass"
    num_class: int                 # score columns: 1 for binary
    hessian_factor: float          # multiclass: h = factor * p * (1 - p)
    init_score: str                # "log_odds" (binary) or "zero"
    learning_rate: float
    lambda_l1: float
    lambda_l2: float
    num_leaves: int
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    max_bin: int
    bin_sample_count: int
    bin_seed: int

    @staticmethod
    def from_config(cfg: dict) -> "Learner":
        p, o, b = cfg["params"], cfg["objective"], cfg["binning"]
        return Learner(
            objective=o["name"], num_class=int(o.get("num_class", 1)),
            hessian_factor=float(o.get("hessian_factor", 1.0)),
            init_score=o["init_score"],
            learning_rate=float(p["learningRate"]),
            lambda_l1=float(p["lambdaL1"]), lambda_l2=float(p["lambdaL2"]),
            num_leaves=int(p["numLeaves"]),
            min_data_in_leaf=int(p["minDataInLeaf"]),
            min_sum_hessian_in_leaf=float(p["minSumHessianInLeaf"]),
            max_bin=int(p["maxBin"]),
            bin_sample_count=int(p["binSampleCount"]),
            bin_seed=int(b["sample_seed"]))


# -- ingest -----------------------------------------------------------------

def bin_bounds(X: np.ndarray, lr: Learner) -> np.ndarray:
    """``[F, max_bin - 1]`` float32 upper bounds: the rule the configuration
    states. ``bin_sample_count`` rows drawn without replacement by numpy's
    ``default_rng(sample_seed)``; a feature with at most ``max_bin - 1``
    distinct values bins at the midpoints between them (the rest +inf);
    otherwise at the linear-interpolated quantiles ``j / max_bin``, made
    non-decreasing."""
    n, F = X.shape
    if n > lr.bin_sample_count:
        pick = np.random.default_rng(lr.bin_seed).choice(
            n, lr.bin_sample_count, replace=False)
        X = X[pick]
    B = lr.max_bin
    out = np.empty((F, B - 1), np.float32)
    qs = np.linspace(0.0, 1.0, B + 1)[1:-1]
    for f in range(F):
        col = X[:, f]
        col = col[~np.isnan(col)]
        uniq = np.unique(col)
        if uniq.size <= B - 1:
            mids = ((uniq[:-1] + uniq[1:]) / 2.0 if uniq.size > 1
                    else uniq[:1])
            out[f] = np.concatenate([mids.astype(np.float32),
                                     np.full(B - 1 - mids.size, np.inf,
                                             np.float32)])
        else:
            q = np.quantile(col, qs).astype(np.float32)
            out[f] = np.maximum.accumulate(q)
    return out


def apply_bins(X: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """``[F, n]`` uint8 bins of ``X`` ([n, F] float32): the count of bounds
    strictly below the value; NaN in bin 0."""
    ub = torch.as_tensor(bounds, device=X.device)
    out = torch.empty((X.shape[1], X.shape[0]), dtype=torch.uint8,
                      device=X.device)
    for f in range(X.shape[1]):
        x = X[:, f].contiguous()
        b = torch.searchsorted(ub[f].contiguous(), x, right=False)
        out[f] = torch.where(torch.isnan(x), 0, b).to(torch.uint8)
    return out


# -- the learner ------------------------------------------------------------

def _thr_l1(g: torch.Tensor, l1: float) -> torch.Tensor:
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _leaf_gain(g, h, lr: Learner):
    return _thr_l1(g, lr.lambda_l1) ** 2 / (h + lr.lambda_l2 + 1e-38)


def init_scores(y: torch.Tensor, lr: Learner) -> torch.Tensor:
    """``[K]`` float64 starting margins."""
    if lr.init_score == "log_odds":
        p = y.double().mean().clamp(1e-15, 1 - 1e-15)
        return torch.log(p / (1 - p)).reshape(1)
    return torch.zeros(lr.num_class, dtype=torch.float64, device=y.device)


def grad_hess(scores: torch.Tensor, y: torch.Tensor, lr: Learner):
    """``[n, K]`` float64 gradients and hessians at ``scores``."""
    if lr.objective == "binary":
        p = torch.sigmoid(scores[:, 0])
        yd = y.double()
        return (p - yd)[:, None], (p * (1 - p))[:, None]
    if lr.objective == "multiclass":
        p = torch.softmax(scores, dim=1)
        onehot = torch.nn.functional.one_hot(
            y.long(), lr.num_class).double()
        return p - onehot, lr.hessian_factor * p * (1 - p)
    raise ValueError(f"no reference for objective {lr.objective!r}")


# -- the audit --------------------------------------------------------------

def threshold_bins(tree: TextTree, bounds: np.ndarray):
    """Each internal node's threshold as a bin (split ``bin <= t``) and
    whether the threshold is one of the bounds."""
    n_int = tree.num_leaves - 1
    t_bin = np.zeros(n_int, np.int64)
    on_grid = np.zeros(n_int, bool)
    for i in range(n_int):
        ub = bounds[tree.split_feature[i]]
        t = int(np.searchsorted(ub, tree.threshold[i], side="left"))
        t_bin[i] = t
        on_grid[i] = t < ub.size and ub[t] == tree.threshold[i]
    return t_bin, on_grid


def node_histograms(bins: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    tree: TextTree, t_bin: np.ndarray, B: int):
    """``[L-1, F, 3, B]`` float64 histograms (gradient, hessian, rows) of
    every internal node, from the rows routed through the tree on their
    bins, and each row's leaf."""
    F, n = bins.shape
    dev = bins.device
    n_int = tree.num_leaves - 1
    leaf = torch.zeros(n, dtype=torch.long, device=dev)
    if n_int == 0:
        return torch.zeros((0, F, 3, B), dtype=torch.float64,
                           device=dev), leaf
    hist = torch.zeros((F, n_int * B, 3), dtype=torch.float64, device=dev)
    feat = torch.as_tensor(tree.split_feature, device=dev)
    tb = torch.as_tensor(t_bin, device=dev)
    left = torch.as_tensor(tree.left_child, device=dev)
    right = torch.as_tensor(tree.right_child, device=dev)
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    stats = torch.stack([g, h, torch.ones_like(g)], dim=1)
    while rows.numel():
        base = node * B
        for f in range(F):
            hist[f].index_add_(0, base + bins[f, rows].long(), stats)
        b = bins[feat[node], rows].long()
        child = torch.where(b <= tb[node], left[node], right[node])
        done = child < 0
        leaf[rows[done]] = -child[done] - 1
        keep = ~done
        rows, node, stats = rows[keep], child[keep], stats[keep]
    return hist.view(F, n_int, B, 3).permute(1, 0, 3, 2), leaf


def _split_gains(hist: torch.Tensor, lr: Learner):
    """Every candidate split ``bin <= b`` of nodes with histograms ``hist``
    ``[K, F, 3, B]``: its gain, whether the learner allows it, whether its
    sides hold ``minDataInLeaf`` rows, and the nodes' totals ``[K, 3]``."""
    B = hist.shape[-1]
    tot = hist[:, 0].sum(dim=-1)                            # [K, 3]
    cum = hist.cumsum(dim=-1)
    gl, hl, cl = cum[:, :, 0], cum[:, :, 1], cum[:, :, 2]
    G, H, C = (tot[:, i, None, None] for i in range(3))
    gr, hr, cr = G - gl, H - hl, C - cl
    gain = (_leaf_gain(gl, hl, lr) + _leaf_gain(gr, hr, lr)
            - _leaf_gain(G, H, lr))
    rows_ok = (cl >= lr.min_data_in_leaf) & (cr >= lr.min_data_in_leaf)
    rows_ok[..., B - 1] = False
    ok = (rows_ok & (hl >= lr.min_sum_hessian_in_leaf)
          & (hr >= lr.min_sum_hessian_in_leaf))
    return gain, ok, rows_ok, tot


def _best(gain: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    best = torch.where(ok, gain, torch.full_like(gain, -np.inf))
    return best.reshape(gain.shape[0], -1).amax(dim=1)


def leaf_histograms(bins, g, h, leaf, L: int, B: int) -> torch.Tensor:
    """``[L, F, 3, B]`` float64 histograms of the leaves' rows."""
    F = bins.shape[0]
    hist = torch.zeros((F, L * B, 3), dtype=torch.float64, device=g.device)
    stats = torch.stack([g, h, torch.ones_like(g)], dim=1)
    for f in range(F):
        hist[f].index_add_(0, leaf * B + bins[f].long(), stats)
    return hist.view(F, L, B, 3).permute(1, 0, 3, 2)


def audit_tree(bins, g, h, tree: TextTree, bounds, lr: Learner,
               base: float, control_stats: Optional[str] = None
               ) -> Dict[str, torch.Tensor]:
    """One tree's per-node readings from the rows' float32 gradients and
    hessians ``g``, ``h``, summed exactly (in float64, as LightGBM's double
    histograms): the best gain the learner allows at every internal node
    and the gain of the program's split there, row counts on both sides,
    whether the split is one the learner allows, every leaf's value on both
    sides (the program's replaced by the control's, summed from the
    statistics rounded to ``control_stats``, when that is given) and, in a
    tree that stopped short of ``numLeaves``, the best gain left at each
    leaf."""
    B = lr.max_bin
    dev = bins.device
    L = tree.num_leaves
    t_bin, on_grid = threshold_bins(tree, bounds)
    hist, leaf = node_histograms(bins, g, h, tree, t_bin, B)
    out: Dict[str, torch.Tensor] = {}
    if L > 1:
        k = torch.arange(L - 1, device=dev)
        f = torch.as_tensor(tree.split_feature, device=dev)
        tb = torch.as_tensor(np.minimum(t_bin, B - 1), device=dev)
        gain, ok, rows_ok, tot = _split_gains(hist, lr)
        # the learner tests minSumHessianInLeaf on its own (quantized)
        # sums, which the reference cannot reproduce: a chosen split is
        # held to the rows it leaves on each side and to the bin grid
        out.update(
            best=_best(gain, ok), chosen=gain[k, f, tb],
            allowed=rows_ok[k, f, tb] & torch.as_tensor(on_grid, device=dev),
            count_ref=tot[:, 2],
            count_prog=torch.as_tensor(tree.internal_count, device=dev,
                                       dtype=torch.float64))
    if L < lr.num_leaves:
        gain, ok, _, _ = _split_gains(
            leaf_histograms(bins, g, h, leaf, L, B), lr)
        out["left_gain"] = _best(gain, ok).clamp(min=0.0)
    out.update(
        leaf_ref=leaf_values(leaf, g, h, L, lr) + base,
        leaf_prog=(torch.as_tensor(tree.leaf_value, device=dev)
                   if control_stats is None else base + leaf_values(
                       leaf, *(s.float().to(getattr(torch, control_stats))
                               .double() for s in (g, h)), L, lr)),
        leaf_count_ref=torch.bincount(leaf, minlength=L).double(),
        leaf_count_prog=torch.as_tensor(tree.leaf_count, device=dev,
                                        dtype=torch.float64))
    return out


def leaf_values(leaf: torch.Tensor, g: torch.Tensor, h: torch.Tensor, L: int,
                lr: Learner) -> torch.Tensor:
    """``[L]`` leaf values: the Newton step of each leaf's rows, shrunk by
    the learning rate (0 for an empty leaf)."""
    zeros = torch.zeros(L, dtype=torch.float64, device=g.device)
    lg = zeros.index_add(0, leaf, g)
    lh = zeros.index_add(0, leaf, h)
    lc = torch.bincount(leaf, minlength=L)
    value = -_thr_l1(lg, lr.lambda_l1) / (lh + lr.lambda_l2 + 1e-38)
    return torch.where(lc > 0, value * lr.learning_rate, zeros)


def _widest(diff: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest ``diff`` measured against ``ref`` or the median of
    ``ref``, whichever is larger (some references are all but zero)."""
    if diff.numel() == 0:
        return 0.0
    scale = torch.maximum(ref.abs(), ref.abs().median())
    return float((diff.abs() / scale.clamp(min=1e-300)).max())


def audit_fit(text_model: TextModel, bins: torch.Tensor, bounds: np.ndarray,
              y: torch.Tensor, lr: Learner, rounds: Sequence[int],
              control_stats: Optional[str] = None) -> Dict[str, float]:
    """Audit every tree of the boosting ``rounds`` of a fitted model.
    ``bins`` are the reference's own ``[F, n]`` bins of the training rows,
    ``y`` their labels on the same device. The margins before round ``r``
    are the reference's starting margins for ``r = 0``, else the sum of the
    model's trees of the earlier rounds (the model folds its starting
    margins into its first trees). ``control_stats``: see
    :func:`audit_tree`.

    Readings: ``counts_off``, the nodes whose rows differ from the
    program's count; ``splits_off``, the splits that leave fewer than
    ``minDataInLeaf`` rows on a side or whose threshold is no bin bound;
    ``gain_gap``, the widest shortfall of a chosen split's gain below the
    best at its node; ``left_gain``, the widest best gain left at a leaf of
    a tree that stopped short; ``leaf_err``, the widest leaf value's error.
    The last three are measured against the median of their kind."""
    K = lr.num_class
    n = bins.shape[1]
    dev = bins.device
    start = init_scores(y, lr)
    scores = torch.zeros((n, K), dtype=torch.float64, device=dev)
    done = 0
    parts: Dict[str, List[torch.Tensor]] = {}
    for r in sorted(rounds):
        if r > 0:
            scores = _add_trees_binned(text_model, bins, bounds, scores,
                                       done, r * K)
            done = r * K
            now = scores
        else:
            now = scores + start[None, :]
        g, h = (s.float().double() for s in grad_hess(now, y, lr))
        for k in range(K):
            tree = text_model.trees[r * K + k]
            base = float(start[k]) if r == 0 else 0.0
            for key, v in audit_tree(bins, g[:, k].contiguous(),
                                     h[:, k].contiguous(), tree, bounds, lr,
                                     base, control_stats).items():
                parts.setdefault(key, []).append(v)
    cat = {k: torch.cat(v) for k, v in parts.items()}
    def off(ref, prog):          # a count is a float sum on the program's side
        return int(((ref - prog).abs() > 0.5).sum())

    count_off = off(cat["leaf_count_ref"], cat["leaf_count_prog"])
    read = dict(leaf_err=_widest(cat["leaf_prog"] - cat["leaf_ref"],
                                 cat["leaf_ref"]), gain_gap=0.0,
                left_gain=0.0, splits_off=0)
    chosen = None
    if "best" in cat:
        count_off += off(cat["count_ref"], cat["count_prog"])
        read["splits_off"] = int((~cat["allowed"]).sum())
        read["gain_gap"] = _widest(
            (cat["best"] - cat["chosen"]).clamp(min=0.0), cat["best"])
        chosen = cat["chosen"].abs().median()
    if "left_gain" in cat:
        left = cat["left_gain"]
        scale = left if chosen is None else torch.maximum(left, chosen)
        read["left_gain"] = float((left / scale.clamp(min=1e-300)).max())
    read["counts_off"] = count_off
    return read


def _add_trees_binned(text_model, bins, bounds, scores, start, stop):
    """Add trees ``[start, stop)`` to ``scores``, routing rows on the
    reference's bins (``bin <= t`` where ``t`` is the threshold's bin: the
    same rows as ``x <= threshold`` when the threshold is a bound)."""
    K = text_model.num_class
    dev = bins.device
    for t in range(start, stop):
        tree = text_model.trees[t]
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                             device=dev)
        scores[:, t % K] += lv[_leaves_binned(tree, bins, bounds)]
    return scores


def _leaves_binned(tree: TextTree, bins: torch.Tensor, bounds) -> torch.Tensor:
    n = bins.shape[1]
    dev = bins.device
    node = torch.zeros(n, dtype=torch.long, device=dev)
    if tree.num_leaves == 1:
        return node
    t_bin, _ = threshold_bins(tree, bounds)
    feat = torch.as_tensor(tree.split_feature, device=dev)
    tb = torch.as_tensor(t_bin, device=dev)
    left = torch.as_tensor(tree.left_child, device=dev)
    right = torch.as_tensor(tree.right_child, device=dev)
    rows = torch.arange(n, device=dev)
    for _ in range(tree.num_leaves - 1):
        live = node >= 0
        nd = node.clamp(min=0)
        b = bins[feat[nd], rows].long()
        node = torch.where(live, torch.where(b <= tb[nd], left[nd],
                                             right[nd]), node)
        if not bool((node >= 0).any()):
            break
    return -node - 1


def margin_gap(text_model: TextModel, X: torch.Tensor,
               program_margins: np.ndarray) -> float:
    """Widest absolute gap between the program's raw margins of rows ``X``
    and the reference's traversal of the same model."""
    ref = forest.margins(text_model, X)
    got = torch.as_tensor(np.asarray(program_margins, np.float64),
                          device=X.device).reshape(ref.shape)
    return float((got - ref).abs().max())
