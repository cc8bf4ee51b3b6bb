"""Exact TreeSHAP feature contributions on the host.

Counterpart of ``mmlspark_tpu/models/gbdt/treeshap.py`` (reference:
``featuresShapCol``, lightgbm/LightGBMBooster.scala:250-269, which rides
LightGBM's native TreeSHAP). TreeSHAP computes the exact Shapley values of
the tree's cover-conditional value function v(S) = E[f(x) | x_S] in
polynomial time (Lundberg, Erion & Lee 2018, "Consistent Individualized
Feature Attribution for Tree Ensembles", Algorithm 2).

Two engines consume one ``[M, n]`` routing matrix per tree (thresholds,
categorical bitsets and NaN handling are decided here, once):

  * the native C++ per-instance recursion (``native/mmlspark_native.cpp``
    ``mm_treeshap``, threaded over instances), the default;
  * the recursion below, run once per tree over its topology with every
    per-instance quantity (the "one fraction" and the path weights) an
    ``[n]`` / ``[L, n]`` numpy array, so EXTEND/UNWIND are vectorized over
    the rows. It takes every tree the native engine rejects (too deep or
    malformed), and every tree under ``MMLSPARK_TPU_SHAP_NATIVE=0``.

Both compute the same f64 values (pinned against each other at 1e-10).
"""

from __future__ import annotations

import os

import numpy as np


def _extend(d, z, o, w, pz, po, pi):
    """EXTEND: append (pi, pz, po) to the path and update weights.

    d: [l] int features; z: [l] float zero fractions; o: [l, n] one
    fractions; w: [l, n] path weights. Returns extended copies (l+1).
    po is [n]; pz scalar.
    """
    l = len(d)
    n = w.shape[1] if l else len(po)
    d2 = np.append(d, pi)
    z2 = np.append(z, pz)
    o2 = np.concatenate([o, po[None, :]], axis=0) if l else po[None, :].copy()
    w2 = np.concatenate(
        [w, np.full((1, n), 1.0 if l == 0 else 0.0, dtype=np.float64)],
        axis=0)
    for i in range(l - 1, -1, -1):
        w2[i + 1] += po * w2[i] * (i + 1) / (l + 1)
        w2[i] = pz * w2[i] * (l - i) / (l + 1)
    return d2, z2, o2, w2


def _unwind(d, z, o, w, k):
    """UNWIND: remove path element k, inverting its EXTEND. The o[k] == 0
    and != 0 branches of the scalar algorithm are taken elementwise.
    Weights are positional (the scalar algorithm recomputes
    pweight[0..l-1] in place and shifts only d/z/o)."""
    l = len(d) - 1
    of = o[k]                                     # [n]
    zf = z[k]                                     # scalar
    n = w.shape[1]
    nz = of != 0
    safe_of = np.where(nz, of, 1.0)
    next_one = w[l].copy()
    new_w = np.empty((l, n), dtype=np.float64)
    for i in range(l - 1, -1, -1):
        tmp = w[i]
        wa = next_one * (l + 1) / ((i + 1) * safe_of)
        if zf != 0:
            wb = tmp * (l + 1) / (zf * (l - i))
        else:
            wb = np.zeros_like(tmp)
        new_w[i] = np.where(nz, wa, wb)
        next_one = tmp - new_w[i] * zf * (l - i) / (l + 1)
    return (np.delete(d, k), np.delete(z, k),
            np.delete(o, k, axis=0), new_w)


def _unwound_sum(d, z, o, w, k):
    """Sum of path weights after unwinding element k (the leaf-time
    per-feature weight of Algorithm 2), without building the unwound path.
    Returns [n]."""
    l = len(d) - 1
    of = o[k]
    zf = z[k]
    nz = of != 0
    safe_of = np.where(nz, of, 1.0)
    next_one = w[l].copy()
    total = np.zeros_like(next_one)
    for i in range(l - 1, -1, -1):
        tmp_a = next_one * (l + 1) / ((i + 1) * safe_of)
        if zf != 0:
            tmp_b = w[i] * (l + 1) / (zf * (l - i))
        else:
            tmp_b = np.zeros_like(tmp_a)
        t = np.where(nz, tmp_a, tmp_b)
        total += t
        next_one = w[i] - t * zf * (l - i) / (l + 1)
    return total


def tree_shap_single(feat, left, right, is_leaf, cover, values,
                     go_left, n_features):
    """Exact SHAP values for one tree, all instances at once.

    go_left: [M, n] bool, each instance's decision at every node (internal
    nodes only are read). cover: [M] training row weight per node. values:
    [M] leaf values (shrinkage applied). Returns [n, F+1]; the last column
    is the tree's expected value E[f] (the SHAP base value).
    """
    n = go_left.shape[1]
    phi = np.zeros((n, n_features + 1), dtype=np.float64)

    # an explicit stack: leafwise trees can be chains ~num_leaves deep
    d0 = np.empty(0, dtype=np.int64)
    z0 = np.empty(0, dtype=np.float64)
    o0 = np.empty((0, n), dtype=np.float64)
    w0 = np.empty((0, n), dtype=np.float64)
    stack = [(0, d0, z0, o0, w0, 1.0, np.ones(n, dtype=np.float64), -1)]
    while stack:
        j, d, z, o, w, pz, po, pi = stack.pop()
        d, z, o, w = _extend(d, z, o, w, pz, po, pi)
        if is_leaf[j]:
            for i in range(1, len(d)):
                s = _unwound_sum(d, z, o, w, i)
                phi[:, d[i]] += s * (o[i] - z[i]) * float(values[j])
            continue
        f = int(feat[j])
        lo, hi = int(left[j]), int(right[j])
        iz, io = 1.0, np.ones(n, dtype=np.float64)
        # an earlier occurrence of this feature on the path is unwound and
        # its fractions fold into the incoming ones
        for k in range(1, len(d)):
            if d[k] == f:
                iz, io = z[k], o[k].copy()
                d, z, o, w = _unwind(d, z, o, w, k)
                break
        cj = max(float(cover[j]), 1e-12)
        gl = go_left[j].astype(np.float64)
        stack.append((lo, d, z, o, w, float(cover[lo]) / cj * iz, io * gl,
                      f))
        stack.append((hi, d, z, o, w, float(cover[hi]) / cj * iz,
                      io * (1.0 - gl), f))

    phi[:, n_features] = _expected_value(is_leaf, cover, values)
    return phi


def check_shap_inputs(booster, F: int) -> None:
    """The checks both TreeSHAP engines make before any is called: every
    tree needs a positive root cover (a model imported from LightGBM text
    without the count fields has none), and every internal node a split
    feature in ``[0, F)`` (numpy would wrap -1 to the last column and write
    ``F`` into the expected-value column)."""
    trees = booster.trees
    root_covers = np.asarray(trees["node_cnt"])[:, 0]
    if booster.num_trees and not np.all(root_covers > 0):
        raise ValueError(
            "exact TreeSHAP needs per-node training counts, but this "
            "booster has trees with zero root cover (typically a model "
            "imported from a LightGBM text dump without "
            "internal_count/leaf_count fields) — use "
            "predict_contrib(method='saabas') for cover-free attribution")
    feat = np.asarray(trees["feat"])
    is_leaf = np.asarray(trees["is_leaf"]).astype(bool)
    for t in range(booster.num_trees):
        internal_feat = feat[t][~is_leaf[t]]
        if internal_feat.size and (internal_feat.min() < 0
                                   or internal_feat.max() >= F):
            raise ValueError(
                f"tree {t} has an internal node with split feature "
                f"outside [0, {F}) — malformed or truncated model")


def go_left_matrix(booster, t: int, X: np.ndarray) -> np.ndarray:
    """Tree ``t``'s routing of rows ``X`` ([n, F] f32) at every node:
    ``[M, n]`` bool (NaN left; categorical features by bitset
    membership)."""
    trees = booster.trees
    feat = trees["feat"][t]
    xv = X[:, feat]                                   # [n, M]
    gl = (~(xv > booster.thr_raw[t][None, :])).T      # [M, n]
    is_cat = booster._is_cat()
    if is_cat is not None:
        gl = np.where(
            is_cat[feat][:, None],
            _cat_member_np(np.asarray(trees["cat_bitset"][t]), xv.T,
                           booster._cat_max_idx(), booster._cat_strict()),
            gl)
    return gl


def shap_values(booster, X: np.ndarray) -> np.ndarray:
    """Exact TreeSHAP contributions of a :class:`~.booster.Booster` on the
    host: ``[n, (F + 1) * num_class]`` f64, per class block F per-feature
    Shapley values then the expected value (base score plus every tree's
    expectation), predict_contrib's layout."""
    X = np.asarray(X, dtype=np.float32)
    n, F = X.shape
    K = booster.num_class
    trees = booster.trees
    out = np.zeros((n, (F + 1) * K), dtype=np.float64)
    for k in range(K):
        out[:, k * (F + 1) + F] = booster.base_score[k]
    check_shap_inputs(booster, F)
    use_native = os.environ.get("MMLSPARK_TPU_SHAP_NATIVE") != "0"
    if use_native:
        from ...native import treeshap_tree
    for t in range(booster.num_trees):
        k = t % K
        is_leaf = np.asarray(trees["is_leaf"][t])
        gl = go_left_matrix(booster, t, X)
        cover = np.asarray(trees["node_cnt"][t], dtype=np.float64)
        values = np.asarray(trees["leaf_value"][t], dtype=np.float64)
        feat, left, right = (np.asarray(trees[f][t])
                             for f in ("feat", "left", "right"))
        phi_f = None
        if use_native:
            phi_f = treeshap_tree(feat, left, right, is_leaf, cover, values,
                                  gl, F)
        if phi_f is not None:
            out[:, k * (F + 1):k * (F + 1) + F] += phi_f
            out[:, k * (F + 1) + F] += _expected_value(is_leaf, cover,
                                                       values)
        else:
            phi = tree_shap_single(feat, left, right, is_leaf, cover, values,
                                   gl, F)
            out[:, k * (F + 1):k * (F + 1) + F] += phi[:, :F]
            out[:, k * (F + 1) + F] += phi[:, F]
    return out


def _expected_value(is_leaf, cover, values) -> float:
    """Cover-weighted mean of leaf values: the tree's E[f], the base the
    contributions sum from (sum(phi) + E[f] == f(x))."""
    leaves = is_leaf & (cover > 0)
    tot = max(float(cover[leaves].sum()), 1e-12)
    return float((values[leaves] * cover[leaves]).sum() / tot)


def _cat_member_np(bits, x, max_bin_idx, strict):
    """Numpy categorical membership (``growth.cat_member``), broadcast as
    [M, n]. bits: [M, BW] uint32 words; x: [M, n] raw values gathered per
    node."""
    if strict:
        b = np.where(np.isnan(x), -1.0, np.floor(x + 0.5))
        in_range = (b >= 0) & (b <= max_bin_idx)
    else:
        b = np.where(np.isnan(x) | (x < 0), 0.0, np.floor(x + 0.5))
        in_range = np.ones(x.shape, dtype=bool)
    cbin = np.clip(b, 0, max_bin_idx).astype(np.int64)
    word = np.take_along_axis(bits, cbin >> 5, axis=1)   # [M, n]
    return (((word >> (cbin & 31)) & 1).astype(bool)) & in_range
