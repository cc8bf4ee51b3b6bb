"""Isolation Forest anomaly detection, scored on the device.

Counterpart of ``mmlspark_tpu/models/isolation_forest.py``, with its Params
plus ``device`` (default ``cuda``; ``cpu`` only when asked). Isolation trees
are random feature/threshold splits on small subsamples, built on the host
exactly as the JAX package builds them (the same ``default_rng`` draws, so
the trees are bit-equal); scoring — every row's path length through every
tree — is the device work: a loop of ``depth_cap`` steps over ``[T, n]``
node and depth tensors (reference: isolationforest/IsolationForest.scala:15-58).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import (HasDevice, HasFeaturesCol, HasPredictionCol, Param,
                           TypeConverters, set_known_params)
from ..core.pipeline import Estimator, Model

# rows scored at once: the loop's [T, rows] state (node ids, depths, the
# gathered features and thresholds) is about 30 bytes a cell, so 100 trees
# at 2^20 rows hold some 3 GiB
SCORE_ROWS = 1 << 20


def _avg_path_length(n) -> float:
    """c(n): average unsuccessful-search path length in a BST of n nodes."""
    n = np.maximum(np.asarray(n, np.float64), 2.0)
    return 2.0 * (np.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n


class IsolationForest(Estimator, HasFeaturesCol, HasPredictionCol, HasDevice):
    """reference: isolationforest/IsolationForest.scala:15-58 (param parity:
    numEstimators, maxSamples, maxFeatures, bootstrap, contamination,
    scoreCol, predictionCol)."""

    numEstimators = Param("numEstimators", "Number of isolation trees", 100,
                          TypeConverters.to_int)
    maxSamples = Param("maxSamples", "Subsample size per tree (<=1: fraction)",
                       256.0, TypeConverters.to_float)
    maxFeatures = Param("maxFeatures", "Features per tree (<=1: fraction)", 1.0,
                        TypeConverters.to_float)
    bootstrap = Param("bootstrap", "Sample with replacement", False,
                      TypeConverters.to_bool)
    contamination = Param("contamination",
                          "Expected outlier fraction (sets the label threshold; "
                          "0 disables labels)", 0.0, TypeConverters.to_float)
    scoreCol = Param("scoreCol", "Output anomaly-score column", "outlierScore",
                     TypeConverters.to_string)
    randomSeed = Param("randomSeed", "Seed", 1, TypeConverters.to_int)

    def fit(self, dataset: Dataset) -> "IsolationForestModel":
        self._device()
        X = np.asarray(dataset.array(self.get_or_default("featuresCol")),
                       np.float32)
        n, F = X.shape
        T = self.get_or_default("numEstimators")
        ms = self.get_or_default("maxSamples")
        sample_n = int(ms * n) if ms <= 1.0 else int(min(ms, n))
        sample_n = max(sample_n, 2)
        mf = self.get_or_default("maxFeatures")
        feat_n = max(int(mf * F) if mf <= 1.0 else int(min(mf, F)), 1)
        rng = np.random.default_rng(self.get_or_default("randomSeed"))

        depth_cap = int(np.ceil(np.log2(sample_n)))
        M = 2 ** (depth_cap + 1) - 1  # perfect-tree slot layout: kids of i at 2i+1/2i+2

        feat = np.zeros((T, M), np.int32)
        thr = np.zeros((T, M), np.float32)
        is_leaf = np.ones((T, M), bool)
        leaf_size = np.zeros((T, M), np.float32)

        for t in range(T):
            rows = rng.choice(n, sample_n, replace=self.get_or_default("bootstrap"))
            feats = (rng.choice(F, feat_n, replace=False) if feat_n < F
                     else np.arange(F))
            # iterative build over slot ids; each slot holds its row subset
            subsets = {0: X[rows][:, :]}
            for slot in range(M):
                rows_here = subsets.pop(slot, None)
                if rows_here is None:
                    continue
                depth = int(np.floor(np.log2(slot + 1)))
                if len(rows_here) <= 1 or depth >= depth_cap:
                    leaf_size[t, slot] = max(len(rows_here), 1)
                    continue
                f = int(rng.choice(feats))
                lo, hi = rows_here[:, f].min(), rows_here[:, f].max()
                if hi <= lo:  # constant feature here: give up, make a leaf
                    leaf_size[t, slot] = len(rows_here)
                    continue
                s = rng.uniform(lo, hi)
                feat[t, slot], thr[t, slot], is_leaf[t, slot] = f, s, False
                go_left = rows_here[:, f] < s
                subsets[2 * slot + 1] = rows_here[go_left]
                subsets[2 * slot + 2] = rows_here[~go_left]

        model = IsolationForestModel(
            feat=feat, thr=thr, is_leaf=is_leaf, leaf_size=leaf_size,
            depth_cap=depth_cap, sample_n=sample_n)
        self._copy_params_to(model)
        if self.get_or_default("contamination") > 0:
            scores = model._score(X)
            model.set(threshold=float(np.quantile(
                scores, 1.0 - self.get_or_default("contamination"))))
        return model


def path_lengths(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                 is_leaf: torch.Tensor, leaf_size: torch.Tensor,
                 depth_cap: int) -> torch.Tensor:
    """``[T, n]`` f32 path lengths of rows ``X`` [n, F] through the trees
    (``[T, M]`` slot arrays, all on ``X``'s device): ``depth_cap`` steps
    down each tree, then the expected extra length of the subtree a row
    stops in (the JAX ``one_tree`` per tree, all trees at once)."""
    n, F = X.shape
    T = feat.shape[0]
    flat = X.reshape(-1)
    row_base = (torch.arange(n, device=X.device) * F)[None, :]
    node = torch.zeros((T, n), dtype=torch.long, device=X.device)
    depth = torch.zeros((T, n), dtype=torch.float32, device=X.device)
    for _ in range(depth_cap):
        f = feat.gather(1, node)
        x = flat[row_base + f]
        internal = ~is_leaf.gather(1, node)
        nxt = torch.where(x < thr.gather(1, node), 2 * node + 1, 2 * node + 2)
        node = torch.where(internal, nxt, node)
        depth += internal.float()
    # unresolved subtrees contribute the expected extra path length (f32
    # throughout, as the JAX package computes it)
    ls = leaf_size.gather(1, node)
    sz = torch.clamp(ls, min=2.0)
    extra = (2.0 * (torch.log(sz - 1.0 + 1e-9) + 0.5772156649)
             - 2.0 * (sz - 1.0) / sz)
    return depth + torch.where(ls > 1, extra, torch.zeros_like(extra))


class IsolationForestModel(Model, HasFeaturesCol, HasPredictionCol, HasDevice):
    scoreCol = Param("scoreCol", "Output anomaly-score column", "outlierScore",
                     TypeConverters.to_string)
    threshold = Param("threshold", "Score threshold for outlier label", None,
                      TypeConverters.to_float)

    def __init__(self, feat=None, thr=None, is_leaf=None, leaf_size=None,
                 depth_cap: int = 0, sample_n: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.feat, self.thr = feat, thr
        self.is_leaf, self.leaf_size = is_leaf, leaf_size
        self.depth_cap, self.sample_n = depth_cap, sample_n

    def _forest(self, dev: torch.device):
        return (torch.as_tensor(np.asarray(self.feat, np.int64), device=dev),
                torch.as_tensor(np.asarray(self.thr, np.float32), device=dev),
                torch.as_tensor(np.asarray(self.is_leaf, bool), device=dev),
                torch.as_tensor(np.asarray(self.leaf_size, np.float32),
                                device=dev))

    def _score(self, X: np.ndarray) -> np.ndarray:
        dev = self._device()
        forest = self._forest(dev)
        X = np.asarray(X, np.float32)
        paths = np.empty((forest[0].shape[0], len(X)), np.float32)
        for s in range(0, len(X), SCORE_ROWS):
            Xd = torch.as_tensor(X[s:s + SCORE_ROWS], device=dev)
            paths[:, s:s + len(Xd)] = path_lengths(
                Xd, *forest, self.depth_cap).cpu().numpy()
        # the mean over trees on the host, as numpy takes it in the JAX
        # package (the same [T, n] f32 array, the same order)
        e_h = paths.mean(axis=0)
        c = _avg_path_length(self.sample_n)
        return np.power(2.0, -e_h / c)

    def transform(self, dataset: Dataset) -> Dataset:
        X = np.asarray(dataset.array(self.get_or_default("featuresCol")),
                       np.float32)
        scores = self._score(X)
        out = dataset.with_column(self.get_or_default("scoreCol"), scores)
        th = self.get_or_default("threshold")
        if th is not None:
            out = out.with_column(self.get_or_default("predictionCol"),
                                  (scores > th).astype(np.float64))
        return out

    def _save_extra(self, path):
        np.savez_compressed(
            os.path.join(path, "forest.npz"), feat=self.feat, thr=self.thr,
            is_leaf=self.is_leaf, leaf_size=self.leaf_size,
            meta=np.asarray([self.depth_cap, self.sample_n]))

    def _load_extra(self, path):
        z = np.load(os.path.join(path, "forest.npz"))
        self.feat, self.thr = z["feat"], z["thr"]
        self.is_leaf, self.leaf_size = z["is_leaf"], z["leaf_size"]
        self.depth_cap, self.sample_n = int(z["meta"][0]), int(z["meta"][1])


def isolation_forest_from_jax(feat, thr, is_leaf, leaf_size, depth_cap: int,
                              sample_n: int,
                              params: Optional[Mapping] = None,
                              device=None) -> IsolationForestModel:
    """The port's model for a JAX ``IsolationForestModel``'s forest arrays
    (``feat``, ``thr``, ``is_leaf``, ``leaf_size``, ``depth_cap``,
    ``sample_n``) and Param values (``extract_param_map()``)."""
    model = IsolationForestModel(
        feat=np.asarray(feat, np.int32), thr=np.asarray(thr, np.float32),
        is_leaf=np.asarray(is_leaf, bool),
        leaf_size=np.asarray(leaf_size, np.float32),
        depth_cap=int(depth_cap), sample_n=int(sample_n))
    return set_known_params(model, params, device)

