"""Exact K-nearest-neighbors on the device.

Counterpart of ``mmlspark_tpu/nn/knn.py``, with its Params plus ``device``
(default ``cuda``; ``cpu`` only when asked). A brute-force blocked search:
each block of queries takes one f32 matrix product against the whole index
(``q2 - 2 q.x^T + x2``), then the k smallest distances per row in
``lax.top_k``'s order (:func:`..ops.topk.top_k`: equal distances by
ascending index id). The product stays f32: TF32 is not switched on here
(reference: nn/KNN.scala:18-115, nn/ConditionalKNN.scala:18-112). The host
:class:`BallTree` is the JAX package's, in float64, as it is.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Mapping, Optional

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import (HasDevice, HasFeaturesCol, HasLabelCol,
                           HasOutputCol, Param, TypeConverters,
                           set_known_params)
from ..core.pipeline import Estimator, Model, load_pickle
from ..ops.topk import top_k


def _topk_block(index: torch.Tensor, queries: torch.Tensor, k: int,
                blocked: Optional[torch.Tensor] = None):
    """k nearest index rows for each query row (squared L2).

    index: [n, d]; queries: [q, d]; blocked: optional [q, n] bool of pairs
    that may *not* match (the conditional variant). Returns (dists [q, k],
    ids [q, k]) in ``lax.top_k(-d2, k)``'s order. The ``[q, n]`` block is
    formed in place: ``q2 - 2 q.x^T`` in one ``addmm`` (scaling by -2 is
    exact, so it rounds as the JAX package's ``q2 - 2.0 * (q @ x.T)``),
    then ``+ x2``."""
    q2 = (queries * queries).sum(dim=1, keepdim=True)
    x2 = (index * index).sum(dim=1)[None, :]
    d2 = torch.addmm(q2, queries, index.T, alpha=-2.0)
    d2.add_(x2)
    if blocked is not None:
        d2.masked_fill_(blocked, float("inf"))
    dists, ids = top_k(d2, k, largest=False)
    return dists.clamp_(min=0.0), ids


def _search(model, q: np.ndarray, blocked_rows=None):
    """``(d2 [Q, k] f32, ids [Q, k] int64)`` of the query rows ``q`` against
    ``model.index``, ``blockSize`` queries at a time on the model's device.
    ``blocked_rows(lo, hi, device)``, if given, is the ``[hi - lo, n]``
    bool of the block's pairs that may not match."""
    dev = model._device()
    q = np.asarray(q, np.float32)
    k = min(model.get_or_default("k"), len(model.index))
    bs = model.get_or_default("blockSize")
    idx_d = torch.as_tensor(model.index, device=dev)
    d2s, idss = [np.zeros((0, k), np.float32)], [np.zeros((0, k), np.int64)]
    for s in range(0, len(q), bs):
        blocked = None if blocked_rows is None else blocked_rows(s, s + bs,
                                                                 dev)
        d2, ids = _topk_block(idx_d, torch.as_tensor(q[s:s + bs], device=dev),
                              k, blocked)
        del blocked
        d2s.append(d2.cpu().numpy())
        idss.append(ids.cpu().numpy())
    return np.concatenate(d2s), np.concatenate(idss)


class _KNNParamsBase(HasFeaturesCol, HasOutputCol, HasDevice):
    valuesCol = Param("valuesCol", "Column of payload values returned with "
                      "each neighbor", "values", TypeConverters.to_string)
    k = Param("k", "Number of neighbors", 5, TypeConverters.to_int)
    blockSize = Param("blockSize", "Query rows per device batch", 4096,
                      TypeConverters.to_int)


class KNN(Estimator, _KNNParamsBase):
    """Index the fit dataset; transform finds each row's k nearest
    (reference: nn/KNN.scala:18-62)."""

    def fit(self, dataset: Dataset) -> "KNNModel":
        self._device()
        feats = np.asarray(dataset.array(self.get_or_default("featuresCol")),
                           np.float32)
        vcol = self.get_or_default("valuesCol")
        values = list(dataset[vcol]) if vcol in dataset else list(range(len(dataset)))
        model = KNNModel(index=feats, values=values)
        self._copy_params_to(model)
        return model


class KNNModel(Model, _KNNParamsBase):
    def __init__(self, index: Optional[np.ndarray] = None,
                 values: Optional[List] = None, **kwargs):
        super().__init__(**kwargs)
        self.index = index
        self.values = values

    def kneighbors(self, q: np.ndarray):
        """``(d2 [Q, k] f32, ids [Q, k] int64)`` of the query rows ``q``,
        block by block on the device."""
        return _search(self, q)

    def transform(self, dataset: Dataset) -> Dataset:
        d2, ids = self.kneighbors(
            dataset.array(self.get_or_default("featuresCol")))
        out = []
        for r in range(len(ids)):
            out.append([{"value": self.values[int(i)],
                         "distance": float(np.sqrt(dd))}
                        for i, dd in zip(ids[r], d2[r])])
        out_col = self.get_or_default("outputCol") or "matches"
        return dataset.with_column(out_col, out)

    def _save_extra(self, path):
        np.save(os.path.join(path, "index.npy"), self.index)
        with open(os.path.join(path, "values.pkl"), "wb") as f:
            pickle.dump(self.values, f)

    def _load_extra(self, path):
        self.index = np.load(os.path.join(path, "index.npy"))
        with open(os.path.join(path, "values.pkl"), "rb") as f:
            self.values = load_pickle(f)


class ConditionalKNN(Estimator, _KNNParamsBase, HasLabelCol):
    """KNN where each query restricts matches to an allowed label set
    (reference: nn/ConditionalKNN.scala:18-112, ConditionalBallTree:159)."""

    conditionerCol = Param("conditionerCol", "Column holding the set of "
                           "allowed labels per query row", "conditioner",
                           TypeConverters.to_string)

    def fit(self, dataset: Dataset) -> "ConditionalKNNModel":
        self._device()
        feats = np.asarray(dataset.array(self.get_or_default("featuresCol")),
                           np.float32)
        vcol = self.get_or_default("valuesCol")
        values = list(dataset[vcol]) if vcol in dataset else list(range(len(dataset)))
        labels = list(dataset[self.get_or_default("labelCol")])
        model = ConditionalKNNModel(index=feats, values=values, labels=labels)
        self._copy_params_to(model)
        return model


class ConditionalKNNModel(Model, _KNNParamsBase, HasLabelCol):
    conditionerCol = Param("conditionerCol", "Column holding the set of "
                           "allowed labels per query row", "conditioner",
                           TypeConverters.to_string)

    def __init__(self, index: Optional[np.ndarray] = None,
                 values: Optional[List] = None,
                 labels: Optional[List] = None, **kwargs):
        super().__init__(**kwargs)
        self.index = index
        self.values = values
        self.labels = labels

    def kneighbors(self, q: np.ndarray, conds):
        """``(d2, ids)`` as :meth:`KNNModel.kneighbors`, each query row
        matching only index rows whose label is in its entry of ``conds``
        (one label or a collection); ``inf`` where fewer than k match."""
        # labels -> dense ids so the allowed-pair mask is a device-side gather
        uniq = {l: i for i, l in enumerate(dict.fromkeys(self.labels))}
        lab_ids = np.asarray([uniq[l] for l in self.labels], np.int64)

        def blocked_rows(lo, hi, dev):
            block_conds = conds[lo:hi]
            allowed = np.zeros((len(block_conds), len(uniq)), bool)
            for r, c in enumerate(block_conds):
                cset = c if isinstance(c, (list, tuple, set, np.ndarray)) else [c]
                for l in cset:
                    if l in uniq:
                        allowed[r, uniq[l]] = True
            return torch.as_tensor(~allowed, device=dev).index_select(
                1, torch.as_tensor(lab_ids, device=dev))        # [q, n]

        return _search(self, q, blocked_rows)

    def transform(self, dataset: Dataset) -> Dataset:
        q = np.asarray(dataset.array(self.get_or_default("featuresCol")),
                       np.float32)
        d2, ids = self.kneighbors(q, dataset[self.get_or_default(
            "conditionerCol")])
        out = []
        for r in range(len(ids)):
            row = []
            for i, dd in zip(ids[r], d2[r]):
                if np.isinf(dd):
                    continue  # fewer than k allowed matches
                row.append({"value": self.values[int(i)],
                            "distance": float(np.sqrt(dd)),
                            "label": self.labels[int(i)]})
            out.append(row)
        out_col = self.get_or_default("outputCol") or "matches"
        return dataset.with_column(out_col, out)

    def _save_extra(self, path):
        np.save(os.path.join(path, "index.npy"), self.index)
        with open(os.path.join(path, "payload.pkl"), "wb") as f:
            pickle.dump({"values": self.values, "labels": self.labels}, f)

    def _load_extra(self, path):
        self.index = np.load(os.path.join(path, "index.npy"))
        with open(os.path.join(path, "payload.pkl"), "rb") as f:
            d = load_pickle(f)
        self.values, self.labels = d["values"], d["labels"]


def knn_from_jax(index: np.ndarray, values: List,
                 labels: Optional[List] = None,
                 params: Optional[Mapping] = None, device=None):
    """The port's ``KNNModel`` (or ``ConditionalKNNModel`` where ``labels``
    is given) for a JAX model's index, payload values and Param values
    (``extract_param_map()``)."""
    index = np.asarray(index, np.float32)
    model = (KNNModel(index=index, values=list(values)) if labels is None
             else ConditionalKNNModel(index=index, values=list(values),
                                      labels=list(labels)))
    return set_known_params(model, params, device)


class BallTree:
    """Host-side exact ball tree (reference: nn/BallTree.scala:32-272).

    Kept for CPU-bound callers; the device path above is the default. Median
    split on the dimension of max spread; query prunes by ball bound.
    """

    def __init__(self, points: np.ndarray, leaf_size: int = 32):
        self.points = np.asarray(points, np.float64)
        self.leaf_size = leaf_size
        n = len(self.points)
        self._idx = np.arange(n)
        self._nodes = []  # (center, radius, start, end, left, right)
        self._build(0, n)

    def _build(self, start, end) -> int:
        pts = self.points[self._idx[start:end]]
        center = pts.mean(axis=0)
        radius = float(np.sqrt(((pts - center) ** 2).sum(axis=1).max())) if len(pts) else 0.0
        node_id = len(self._nodes)
        self._nodes.append([center, radius, start, end, -1, -1])
        if end - start > self.leaf_size:
            spread_dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
            order = np.argsort(pts[:, spread_dim], kind="stable")
            self._idx[start:end] = self._idx[start:end][order]
            mid = (start + end) // 2
            self._nodes[node_id][4] = self._build(start, mid)
            self._nodes[node_id][5] = self._build(mid, end)
        return node_id

    def query(self, point: np.ndarray, k: int = 1):
        """Returns (indices, distances) of the k nearest points."""
        ids, dists = self.query_batch(np.asarray(point)[None, :], k)
        return [int(i) for i in ids[0]], [float(d) for d in dists[0]]

    def query_batch(self, points: np.ndarray, k: int = 1):
        """k nearest for EVERY query row in one frontier-based traversal.

        The reference answers queries one at a time through a recursive
        visit (nn/BallTree.scala:99-156) — fine per executor row, a crawl
        for large host-side query sets. Here the stack holds
        (node, query-subset) pairs and every step is a vectorized numpy
        op over the subset: ball-bound pruning against each query's
        current k-th distance, batched leaf scans merged by argpartition,
        and per-query nearest-child-first ordering (subsets split by which
        child is nearer; far halves are pushed below near halves, so each
        query still visits its nearer child first — the ordering that
        makes the pruning bound effective).

        Returns ``(indices [Q, k] int64, distances [Q, k] float64)``,
        each row sorted by distance ascending.
        """
        P = np.ascontiguousarray(np.asarray(points, np.float64))
        Q = len(P)
        k = min(k, len(self.points))
        if getattr(self, "_pts_c", None) is None:
            # centered copy for the BLAS leaf scans: the p2 - 2px + x2
            # identity cancels catastrophically when the data carries a
            # large common offset; centering on the root mean removes it
            mu = self._nodes[0][0]
            self._pts_c = self.points - mu
            self._x2c = (self._pts_c ** 2).sum(axis=1)
        Pc = P - self._nodes[0][0]
        pc2 = (Pc ** 2).sum(axis=1)
        best_d = np.full((Q, k), np.inf)
        best_i = np.full((Q, k), -1, np.int64)
        # below this subset size, stop per-query child ordering (order by
        # the subset mean instead): unchecked splitting fragments the
        # frontier into tiny groups whose per-step numpy overhead swamps
        # the pruning win
        split_min = 128
        stack: List = [(0, np.arange(Q))]
        while stack:
            node_id, qs = stack.pop()
            center, radius, start, end, left, right = self._nodes[node_id]
            # exact direct diff: the prune bound must not inherit identity
            # rounding (a deflated d_center could prune the true NN's ball)
            d_center = np.sqrt(((P[qs] - center) ** 2).sum(axis=1))
            qs = qs[d_center - radius <= best_d[qs, -1]]
            if qs.size == 0:
                continue
            if left < 0:
                ids = self._idx[start:end]
                m = len(ids)
                take = min(k, m)
                if take < m:
                    # centered BLAS identity RANKS candidates; the kept
                    # candidates' distances are then recomputed exactly, so
                    # identity rounding (~eps x spread^2 after centering)
                    # can only reorder genuine machine-precision ties
                    d2a = (pc2[qs, None]
                           - 2.0 * (Pc[qs] @ self._pts_c[ids].T)
                           + self._x2c[ids][None])
                    cand = np.argpartition(d2a, take - 1, axis=1)[:, :take]
                    cid = ids[cand]                       # [q_sub, take]
                else:
                    cid = np.broadcast_to(ids, (len(qs), m))
                diff = P[qs][:, None, :] - self.points[cid]
                d = np.sqrt((diff * diff).sum(-1))        # exact
                all_d = np.concatenate([best_d[qs], d], axis=1)
                all_i = np.concatenate([best_i[qs], cid], axis=1)
                rows = np.arange(len(qs))[:, None]
                sel = np.argpartition(all_d, k - 1, axis=1)[:, :k]
                bd, bi = all_d[rows, sel], all_i[rows, sel]
                order = np.argsort(bd, axis=1, kind="stable")
                best_d[qs] = bd[rows, order]
                best_i[qs] = bi[rows, order]
            else:
                # child ordering is a traversal heuristic — identity
                # rounding cannot affect correctness here
                dl = (pc2[qs] - 2.0 * (Pc[qs] @ (self._nodes[left][0]
                                                 - self._nodes[0][0]))
                      + ((self._nodes[left][0]
                          - self._nodes[0][0]) ** 2).sum())
                dr = (pc2[qs] - 2.0 * (Pc[qs] @ (self._nodes[right][0]
                                                 - self._nodes[0][0]))
                      + ((self._nodes[right][0]
                          - self._nodes[0][0]) ** 2).sum())
                if qs.size < split_min:
                    # whole subset, majority-nearest child first
                    first, second = ((left, right)
                                     if (dl <= dr).mean() >= 0.5
                                     else (right, left))
                    stack.append((second, qs))
                    stack.append((first, qs))
                    continue
                near_left = dl <= dr
                gl, gr = qs[near_left], qs[~near_left]
                # pushed far-first so near halves pop first
                if gr.size:
                    stack.append((left, gr))
                if gl.size:
                    stack.append((right, gl))
                if gr.size:
                    stack.append((right, gr))
                if gl.size:
                    stack.append((left, gl))
        return best_i, best_d
