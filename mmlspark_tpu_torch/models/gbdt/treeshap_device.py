"""Exact TreeSHAP on a device: the per-leaf fixed-shape formulation.

Counterpart of ``mmlspark_tpu/models/gbdt/treeshap_device.py``. The host
engines (:mod:`.treeshap`) walk each tree depth first; this one trades the
walk's shared prefixes for fixed shapes. Each leaf's root path is folded on
the host into its unique features (repeated features multiply into one
slot: EXTEND builds a symmetric polynomial, so the order of the path does
not matter), and the O(depth^2) Shapley-weight work runs as torch ops over
``[leaves, slots, rows]``. EXTEND appends (pz, po) to a path of length l by
the two-term recurrence

    w'[i] = pz * (l - i)/(l + 1) * w[i] + po * i/(l + 1) * w[i - 1]

(one vector op per path element); UNWIND's ``next_one`` carry is sequential
in the path position but independent across slots, so all slots unwind
together.

Launch count: the JAX package scans trees inside one compiled program;
eager torch pays a launch per op. The trees of a class only add up, so
their leaves are concatenated into one leaf axis (``[sum of leaves, ...]``)
and each row block costs O(slots) launches per class, not O(trees x
slots^2). Row blocks are sized from a memory budget. The contributions
reach their features through a fixed gather order (leaves in tree order,
then slots), summed one term at a time: a row's values do not depend on
the block it is computed in, or on the device.

Same math as the host engines, in f64 as theirs: the JAX package's
device engine runs f32 (the TPU has no f64), which is held against this
one at 1e-4. f64 keeps the contributions of models with leaves near 1e4
(ROADMAP Queue 3 item 2) exact, where f32 Shapley weights drift by about
1e-6 of the margin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .growth import cat_member
from .treeshap import check_shap_inputs

# the working set a row block may take on the device
_BLOCK_BUDGET_BYTES = 2 << 30
# the Shapley weights' dtype
_DTYPE = torch.float64


def _fold_tree_paths(feat, left, right, is_leaf, cover, n_features):
    """Fold every leaf's root path into unique-feature slots.

    Returns a dict of per-leaf arrays padded to [L, D]:
      step_node / step_left / step_valid — the raw path steps (for o)
      slot — which unique slot each step folds into
      z [L, D] — per-slot cold (cover) fraction products
      ufeat [L, D] — per-slot feature id (n_features for padding)
      m [L] — unique slot count; leaf_id [L]
    """
    M = len(feat)
    parent = np.full(M, -1, np.int64)
    from_left = np.zeros(M, bool)
    for j in range(M):
        if not is_leaf[j]:
            parent[left[j]] = j
            from_left[left[j]] = True
            parent[right[j]] = j
            from_left[right[j]] = False
    leaves = [j for j in range(M) if is_leaf[j] and cover[j] > 0
              and (parent[j] >= 0 or j == 0)]
    paths = []
    for leaf in leaves:
        steps = []                     # (parent_node, went_left, ratio)
        j = leaf
        while parent[j] >= 0:
            p = parent[j]
            r = float(cover[j]) / max(float(cover[p]), 1e-12)
            steps.append((p, bool(from_left[j]), r))
            j = p
        steps.reverse()
        # fold duplicates into unique slots, path order of first occurrence
        slots: dict = {}
        z = []
        slot_of_step = []
        for p, _, r in steps:
            f = int(feat[p])
            if f not in slots:
                slots[f] = len(z)
                z.append(r)
            else:
                z[slots[f]] *= r
            slot_of_step.append(slots[f])
        paths.append((leaf, steps, slot_of_step,
                      np.asarray(z, np.float64),
                      np.fromiter(slots.keys(), np.int64, len(slots))))
    L = len(paths)
    # steps (Ds) and unique slots (Du) pad independently: a chain splitting
    # one feature 60 times has Ds=60 but Du=1
    Ds = max((len(s) for _, s, *_ in paths), default=1) or 1
    Du = max((len(z) for *_, z, _ in paths), default=1) or 1
    out = dict(
        step_node=np.zeros((L, Ds), np.int64),
        step_left=np.zeros((L, Ds), bool),
        step_valid=np.zeros((L, Ds), bool),
        slot=np.zeros((L, Ds), np.int64),
        z=np.ones((L, Du), np.float64),
        ufeat=np.full((L, Du), n_features, np.int64),
        m=np.zeros(L, np.int64),
        leaf_id=np.zeros(L, np.int64),
    )
    for i, (leaf, steps, slot_of_step, z, ufeats) in enumerate(paths):
        d = len(steps)
        out["leaf_id"][i] = leaf
        if d:
            out["step_node"][i, :d] = [s[0] for s in steps]
            out["step_left"][i, :d] = [s[1] for s in steps]
            out["step_valid"][i, :d] = True
            out["slot"][i, :d] = slot_of_step
            u = len(z)
            out["z"][i, :u] = z
            out["ufeat"][i, :u] = ufeats
            out["m"][i] = u
    return out


class _ClassTables:
    """One class's trees as one leaf axis, on the device: the leaves of
    tree ``i`` (``i``-th of the class) follow those of tree ``i - 1``; step
    nodes index the class's ``[trees * M]`` routing rows."""

    def __init__(self, booster, tids, folded, F: int, dev: torch.device):
        trees = booster.trees
        M = trees["feat"].shape[1]
        Ds = max(folded[t]["step_node"].shape[1] for t in tids)
        Du = max(folded[t]["z"].shape[1] for t in tids)
        parts = {k: [] for k in ("step_node", "step_left", "step_valid",
                                 "slot", "z", "ufeat", "m", "vleaf")}
        exp_val = 0.0
        for i, t in enumerate(tids):
            f = folded[t]

            def pad(a, width, fill):
                return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                              constant_values=fill)

            parts["step_node"].append(pad(f["step_node"] + i * M, Ds, 0))
            parts["step_left"].append(pad(f["step_left"], Ds, False))
            parts["step_valid"].append(pad(f["step_valid"], Ds, False))
            parts["slot"].append(pad(f["slot"], Ds, 0))
            parts["z"].append(pad(f["z"], Du, 1.0))
            parts["ufeat"].append(pad(f["ufeat"], Du, F))
            parts["m"].append(f["m"])
            lv = np.asarray(trees["leaf_value"][t], np.float64)
            cv = np.asarray(trees["node_cnt"][t], np.float64)
            il = np.asarray(trees["is_leaf"][t])
            parts["vleaf"].append(lv[f["leaf_id"]])
            sel = il & (cv > 0)
            exp_val += float((lv[sel] * cv[sel]).sum()
                             / max(cv[sel].sum(), 1e-12))
        cat = {k: np.concatenate(v) for k, v in parts.items()}
        self.LL, self.Ds, self.Du, self.T, self.M = (
            cat["m"].shape[0], Ds, Du, len(tids), M)
        self.exp_val = exp_val

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.step_node = up(cat["step_node"])                 # [LL, Ds]
        self.step_left = up(cat["step_left"])[:, :, None]
        self.step_pad = up(~cat["step_valid"])[:, :, None]
        slot_oh = ((cat["slot"][:, None, :]
                    == np.arange(Du)[None, :, None])
                   & cat["step_valid"][:, None, :])           # [LL, Du, Ds]
        self.slot_oh = up(slot_oh.astype(np.float32))
        self.z = up(cat["z"]).to(_DTYPE)[:, :, None]           # [LL, Du, 1]
        self.m = up(cat["m"])                                 # [LL]
        self.vleaf = up(cat["vleaf"]).to(_DTYPE)[:, None, None]
        # the gather plan of the contributions: feature f sums the flat
        # (leaf, slot) entries holding it, in order; pads read a zero row
        live = cat["ufeat"] < F
        flat = np.flatnonzero(live.reshape(-1))
        feats = cat["ufeat"].reshape(-1)[flat]
        counts = np.bincount(feats, minlength=F)
        E = max(int(counts.max()) if counts.size else 0, 1)
        plan = np.full((F, E), self.LL * Du, np.int64)
        for f in range(F):
            sel = flat[feats == f]
            plan[f, :sel.size] = sel
        self.plan = up(plan)                                  # [F, E]
        # the routing rows: [T * M] node features, thresholds, bitsets
        feat = np.asarray(trees["feat"])[tids].reshape(-1)
        self.feat = up(np.maximum(feat, 0).astype(np.int64))
        self.thr = up(np.asarray(booster.thr_raw)[tids].reshape(-1))
        is_cat = booster._is_cat()
        self.node_cat = None
        if is_cat is not None:
            self.node_cat = up(is_cat[np.maximum(feat, 0)])
            bits = np.asarray(trees["cat_bitset"])[tids]
            self.BW = bits.shape[-1]
            self.bits = up(bits.reshape(-1).astype(np.int64))
            self.max_idx = booster._cat_max_idx()
            self.strict = booster._cat_strict()

    def bytes_per_row(self) -> int:
        """Device bytes one row of a block takes (its transients)."""
        size = torch.finfo(_DTYPE).bits // 8
        return (size * self.LL * (16 * (self.Du + 1) + 3 * self.Ds)
                + 12 * self.T * self.M)

    def go_left(self, Xb: torch.Tensor) -> torch.Tensor:
        """``[T * M, nb]`` bool routing of rows ``Xb`` at every node of the
        class's trees (NaN left; categorical features by bitset
        membership)."""
        xv = Xb[:, self.feat]                                 # [nb, T*M]
        g = ~(xv > self.thr[None, :])
        if self.node_cat is not None:
            # one row of bitsets, every (row, node) pair reading its node's
            nb, TM = xv.shape
            word0 = (torch.arange(TM, device=xv.device) * self.BW).expand(
                nb, TM).reshape(1, -1)
            member = cat_member(self.bits[None, :], word0, xv.reshape(1, -1),
                                self.max_idx, self.strict).reshape(nb, TM)
            g = torch.where(self.node_cat[None, :], member, g)
        return g.t()

    def phi(self, Xb: torch.Tensor) -> torch.Tensor:
        """``[F, nb]`` contributions of the class's trees to rows ``Xb``,
        in f64."""
        nb = Xb.shape[0]
        LL, Du, dev, dt = self.LL, self.Du, Xb.device, _DTYPE
        g = self.go_left(Xb)[self.step_node]                  # [LL, Ds, nb]
        ind = torch.where(self.step_left, g, ~g) | self.step_pad
        # o[l, u] is 1 iff no step of slot u missed: count the misses
        misses = torch.bmm(self.slot_oh, (~ind).to(torch.float32))
        o = (misses < 0.5).to(dt)                             # [LL, Du, nb]
        z, m = self.z, self.m

        # EXTEND every slot: w [LL, Du + 1, nb]
        iota = torch.arange(Du + 1, dtype=dt, device=dev)
        w = torch.zeros((LL, Du + 1, nb), dtype=dt, device=dev)
        w[:, 0] = 1.0
        for j in range(Du):
            lj = float(j + 1)                    # path length with the root
            ca = ((lj - iota) / (lj + 1.0))[None, :, None]
            cb = (iota / (lj + 1.0))[None, :, None]
            w_shift = torch.cat([w.new_zeros((LL, 1, nb)), w[:, :-1]], dim=1)
            w_new = z[:, j, None] * ca * w + o[:, j, None, :] * cb * w_shift
            w = torch.where((m > j)[:, None, None], w_new, w)

        # the unwound sum of every slot at once: the next_one carry runs
        # over path positions i, independently per slot
        lm = m.to(dt)[:, None, None]                          # [LL, 1, 1]
        nzmask = o != 0
        safe_of = torch.where(nzmask, o, 1.0)
        slot_live = (m[:, None] > torch.arange(Du, device=dev)[None, :]
                     )[:, :, None]                            # [LL, Du, 1]
        total = torch.zeros_like(o)
        next_one = w.gather(1, m[:, None, None].expand(LL, 1, nb))
        zf_live = z != 0
        for i in range(Du - 1, -1, -1):
            wi = w[:, i:i + 1]                                # [LL, 1, nb]
            alive = (m > i)[:, None, None]
            ta = next_one * (lm + 1.0) / ((i + 1.0) * safe_of)
            tb = torch.where(zf_live, wi * (lm + 1.0)
                             / torch.clamp_min(z * (lm - i), 1e-38), 0.0)
            t = torch.where(nzmask, ta, tb)
            t = torch.where(alive & slot_live, t, 0.0)
            total = total + t
            next_one = torch.where(
                alive, wi - t * z * (lm - i) / (lm + 1.0), next_one)
        contrib = (total * (o - z) * self.vleaf).reshape(LL * Du, nb)
        contrib = torch.cat([contrib, contrib.new_zeros((1, nb))])
        phi = contrib[self.plan[:, 0]]
        for e in range(1, self.plan.shape[1]):
            phi = phi + contrib[self.plan[:, e]]
        return phi


def shap_values_device(booster, X: np.ndarray, device: DeviceLike = None,
                       row_block: Optional[int] = None) -> np.ndarray:
    """Device TreeSHAP on ``device`` (default ``cuda``), the contract of
    :func:`.treeshap.shap_values`: ``[n, (F + 1) * K]`` f64, each class's
    sum accumulated on the host. ``row_block`` rows per block (default: as many as
    ``_BLOCK_BUDGET_BYTES`` holds)."""
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    n, F = X.shape
    K = booster.num_class
    out = np.zeros((n, (F + 1) * K), dtype=np.float64)
    for k in range(K):
        out[:, k * (F + 1) + F] = booster.base_score[k]
    check_shap_inputs(booster, F)
    if not booster.num_trees or n == 0:
        return out
    trees = booster.trees
    folded = [_fold_tree_paths(
        trees["feat"][t], trees["left"][t], trees["right"][t],
        trees["is_leaf"][t], np.asarray(trees["node_cnt"][t], np.float64), F)
        for t in range(booster.num_trees)]
    Xd = torch.from_numpy(X).to(dev)
    for k in range(K):
        tids = list(range(k, booster.num_trees, K))
        tab = _ClassTables(booster, tids, folded, F, dev)
        rows = row_block or max(1, _BLOCK_BUDGET_BYTES // tab.bytes_per_row())
        col = slice(k * (F + 1), k * (F + 1) + F)
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            phi = tab.phi(Xd[lo:hi])
            out[lo:hi, col] += phi.t().cpu().numpy()
        out[:, k * (F + 1) + F] += tab.exp_val
    return out
