"""SAR — Smart Adaptive Recommendations — on the device.

Counterpart of ``mmlspark_tpu/recommendation/sar.py``, with its Params
plus ``device`` on ``SAR`` and ``SARModel`` (default ``cuda``; ``cpu`` only
when asked). Item-item similarity from co-occurrence / jaccard / lift and
time-decayed user affinity (reference: recommendation/SAR.scala:38-258;
SARModel.scala:23-169; RecommendationIndexer.scala:17-101). On the dense
path the co-occurrence ``seen^T seen`` (exact: 0/1 f32), the per-pair
gather-dot of ``transform`` and ``recommend_for_all_users``' ``aff @ sim``
with its top-k run on the device; the similarity transform, as in the JAX
package, on the host. Above ``DENSE_CELLS_MAX`` cells the matrices stay
scipy CSR on the host (one SpGEMM) and only each user block's top-k runs
on the device. Every top-k keeps ``lax.top_k``'s order (equal scores by
ascending item id): SAR's many zero scores make that order decide which
items come out.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import HasDevice, Param, TypeConverters, set_known_params
from ..core.pipeline import Estimator, Model
from ..ops.topk import top_k

# Above this many user x item cells, fit() switches from the dense in-memory
# formulation to sparse CSR (the reference stays sparse in DataFrames
# throughout — SAR.scala:38-258; the dense path is kept below the threshold
# because it rides single device matmuls with zero indexing overhead).
# ~50M f32 cells = 200 MB per matrix.
DENSE_CELLS_MAX = 50_000_000
# (user, item) pairs ``transform`` scores at once on the dense path: the
# gathered affinity rows and similarity columns are [pairs, I] f32 each
TRANSFORM_CELLS = 1 << 27


def _sparse():
    import scipy.sparse as sp
    return sp


def _is_sparse_mat(x) -> bool:
    return x is not None and not isinstance(x, np.ndarray) and hasattr(x, "tocsr")


class RecommendationIndexer(Estimator):
    """String user/item ids -> dense indices and back
    (reference: recommendation/RecommendationIndexer.scala:17-101)."""

    userInputCol = Param("userInputCol", "raw user column", "user",
                         TypeConverters.to_string)
    itemInputCol = Param("itemInputCol", "raw item column", "item",
                         TypeConverters.to_string)
    userOutputCol = Param("userOutputCol", "indexed user column", "user_idx",
                          TypeConverters.to_string)
    itemOutputCol = Param("itemOutputCol", "indexed item column", "item_idx",
                          TypeConverters.to_string)

    def fit(self, dataset: Dataset) -> "RecommendationIndexerModel":
        users = list(dict.fromkeys(dataset[self.get_or_default("userInputCol")]))
        items = list(dict.fromkeys(dataset[self.get_or_default("itemInputCol")]))
        model = RecommendationIndexerModel(userLevels=users, itemLevels=items)
        self._copy_params_to(model)
        return model


class RecommendationIndexerModel(Model):
    userInputCol = Param("userInputCol", "raw user column", "user",
                         TypeConverters.to_string)
    itemInputCol = Param("itemInputCol", "raw item column", "item",
                         TypeConverters.to_string)
    userOutputCol = Param("userOutputCol", "indexed user column", "user_idx",
                          TypeConverters.to_string)
    itemOutputCol = Param("itemOutputCol", "indexed item column", "item_idx",
                          TypeConverters.to_string)
    userLevels = Param("userLevels", "user id vocabulary", None, is_complex=True)
    itemLevels = Param("itemLevels", "item id vocabulary", None, is_complex=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def transform(self, dataset: Dataset) -> Dataset:
        u_map = {v: i for i, v in enumerate(self.get_or_default("userLevels"))}
        i_map = {v: i for i, v in enumerate(self.get_or_default("itemLevels"))}
        u = np.asarray([u_map.get(v, -1)
                        for v in dataset[self.get_or_default("userInputCol")]],
                       np.int32)
        it = np.asarray([i_map.get(v, -1)
                         for v in dataset[self.get_or_default("itemInputCol")]],
                        np.int32)
        ds = dataset.with_columns({self.get_or_default("userOutputCol"): u,
                                   self.get_or_default("itemOutputCol"): it})
        keep = (u >= 0) & (it >= 0)
        return ds.filter(keep) if not keep.all() else ds

    def recover_user(self, idx: int):
        return self.get_or_default("userLevels")[idx]

    def recover_item(self, idx: int):
        return self.get_or_default("itemLevels")[idx]


class SAR(Estimator, HasDevice):
    """reference: recommendation/SAR.scala:38-258 (param parity:
    similarityFunction, timeDecayCoeff, supportThreshold, ...)."""

    userCol = Param("userCol", "indexed user column", "user_idx",
                    TypeConverters.to_string)
    itemCol = Param("itemCol", "indexed item column", "item_idx",
                    TypeConverters.to_string)
    ratingCol = Param("ratingCol", "rating column (absent: implicit 1.0)",
                      "rating", TypeConverters.to_string)
    timeCol = Param("timeCol", "event-time column (epoch seconds) for decay",
                    None, TypeConverters.to_string)
    similarityFunction = Param("similarityFunction",
                               "cooccurrence | jaccard | lift", "jaccard",
                               TypeConverters.to_string)
    timeDecayCoeff = Param("timeDecayCoeff", "affinity half-life in days", 30,
                           TypeConverters.to_int)
    supportThreshold = Param("supportThreshold",
                             "min co-occurrence count to keep a similarity", 4,
                             TypeConverters.to_int)
    startTime = Param("startTime", "reference timestamp for decay (default: "
                      "max event time)", None, TypeConverters.to_float)

    def fit(self, dataset: Dataset) -> "SARModel":
        dev = self._device()
        u = dataset.array(self.get_or_default("userCol"), np.int32)
        it = dataset.array(self.get_or_default("itemCol"), np.int32)
        rcol = self.get_or_default("ratingCol")
        r = (dataset.array(rcol, np.float32) if rcol in dataset
             else np.ones(len(u), np.float32))
        n_users, n_items = int(u.max()) + 1, int(it.max()) + 1

        # user affinity with optional exponential time decay
        # (reference: SAR.scala user-affinity time decay)
        tcol = self.get_or_default("timeCol")
        if tcol and tcol in dataset:
            t = dataset.array(tcol, np.float64)
            t_ref = self.get_or_default("startTime") or float(t.max())
            half_life_s = self.get_or_default("timeDecayCoeff") * 86400.0
            decay = np.exp2(-(t_ref - t) / half_life_s).astype(np.float32)
            r = r * decay
        thresh = self.get_or_default("supportThreshold")
        sim_fn = self.get_or_default("similarityFunction")
        if sim_fn not in ("cooccurrence", "jaccard", "lift"):
            raise ValueError(f"unknown similarityFunction {sim_fn!r}")

        if n_users * n_items > DENSE_CELLS_MAX:
            model = self._fit_sparse(u, it, r, n_users, n_items, sim_fn,
                                     thresh)
            self._copy_params_to(model)
            return model

        affinity = np.zeros((n_users, n_items), np.float32)
        np.add.at(affinity, (u, it), r)

        # item-item co-occurrence: one device matmul over the binarized
        # matrix (0/1 f32: every count is exact)
        seen = np.zeros((n_users, n_items), np.float32)
        seen[u, it] = 1.0
        seen_d = torch.as_tensor(seen, device=dev)
        cooc = (seen_d.T @ seen_d).cpu().numpy()  # [I, I]
        del seen_d
        occ = np.diag(cooc).copy()

        if sim_fn == "cooccurrence":
            sim = cooc.copy()
        elif sim_fn == "jaccard":
            denom = occ[:, None] + occ[None, :] - cooc
            sim = cooc / np.maximum(denom, 1e-9)
        else:  # lift
            sim = cooc / np.maximum(occ[:, None] * occ[None, :], 1e-9)
        sim = np.where(cooc >= thresh, sim, 0.0).astype(np.float32)

        model = SARModel(itemSimilarity=sim, userAffinity=affinity,
                         seen=seen.astype(bool))
        self._copy_params_to(model)
        return model

    def _fit_sparse(self, u, it, r, n_users: int, n_items: int,
                    sim_fn: str, thresh: float) -> "SARModel":
        """CSR formulation for beyond-RAM-dense scales: affinity and seen
        stay sparse, the co-occurrence is one SpGEMM (S^T S), and the
        similarity transform runs on the nonzero COO entries only. Matches
        the dense path exactly on shared cells (pinned in tests); cells
        the dense path stores as explicit 0 simply don't exist here."""
        sp = _sparse()
        aff = sp.coo_matrix((r, (u, it)), shape=(n_users, n_items),
                            dtype=np.float32).tocsr()
        ones = np.ones(len(u), np.float32)
        seen = sp.coo_matrix((ones, (u, it)), shape=(n_users, n_items),
                             dtype=np.float32).tocsr()
        seen.data[:] = 1.0                       # binarize duplicate events
        cooc = (seen.T @ seen).tocoo()           # [I, I], sparse SpGEMM
        occ = np.zeros(n_items, np.float32)
        diag = cooc.row == cooc.col
        occ[cooc.row[diag]] = cooc.data[diag]

        data, row, col = cooc.data, cooc.row, cooc.col
        keep = data >= thresh
        data, row, col = data[keep], row[keep], col[keep]
        if sim_fn == "cooccurrence":
            sim_data = data
        elif sim_fn == "jaccard":
            sim_data = data / np.maximum(occ[row] + occ[col] - data, 1e-9)
        else:  # lift
            sim_data = data / np.maximum(occ[row] * occ[col], 1e-9)
        sim = sp.csr_matrix((sim_data.astype(np.float32), (row, col)),
                            shape=(n_items, n_items))
        return SARModel(itemSimilarity=sim, userAffinity=aff, seen=seen)


class SARModel(Model, HasDevice):
    userCol = Param("userCol", "indexed user column", "user_idx",
                    TypeConverters.to_string)
    itemCol = Param("itemCol", "indexed item column", "item_idx",
                    TypeConverters.to_string)
    predictionCol = Param("predictionCol", "score column", "prediction",
                          TypeConverters.to_string)
    removeSeenItems = Param("removeSeenItems",
                            "exclude train-time items from recommendations",
                            True, TypeConverters.to_bool)

    def __init__(self, itemSimilarity: Optional[np.ndarray] = None,
                 userAffinity: Optional[np.ndarray] = None,
                 seen: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.itemSimilarity = itemSimilarity
        self.userAffinity = userAffinity
        self.seen = seen

    def transform(self, dataset: Dataset) -> Dataset:
        """Score only the (user, item) pairs present in the dataset —
        one gather + row-wise dot, never the full users x items matrix."""
        u = dataset.array(self.get_or_default("userCol"), np.int32)
        it = dataset.array(self.get_or_default("itemCol"), np.int32)
        n_users, n_items = self.userAffinity.shape
        bad_u, bad_i = (u < 0) | (u >= n_users), (it < 0) | (it >= n_items)
        if bad_u.any() or bad_i.any():
            raise ValueError(
                f"{int(bad_u.sum())} users / {int(bad_i.sum())} items are "
                f"outside the trained range ({n_users} users, {n_items} "
                "items); index with the same RecommendationIndexer used for fit")
        out_col = self.get_or_default("predictionCol")
        if _is_sparse_mat(self.userAffinity):
            # sparse scale: per-pair dot = elementwise product of the user's
            # affinity row and the item's similarity column, both sparse.
            # The CSC view is cached — rebuilding it is O(nnz) and would
            # dominate small-batch scoring.
            if getattr(self, "_sim_csc", None) is None:
                self._sim_csc = self.itemSimilarity.tocsc()
            aff_rows = self.userAffinity[u]                       # [n, I]
            sim_cols = self._sim_csc[:, it].T                     # [n, I]
            scores = np.asarray(
                aff_rows.multiply(sim_cols).sum(axis=1)).ravel()
            return dataset.with_column(out_col, scores.astype(np.float64))
        dev = self._device()
        aff = torch.as_tensor(self.userAffinity, device=dev)
        sim_t = torch.as_tensor(self.itemSimilarity, device=dev).T.contiguous()
        u_d = torch.as_tensor(u.astype(np.int64), device=dev)
        it_d = torch.as_tensor(it.astype(np.int64), device=dev)
        scores = torch.empty(len(u), dtype=torch.float32, device=dev)
        step = max(1, TRANSFORM_CELLS // max(n_items, 1))
        for s in range(0, len(u), step):
            scores[s:s + step] = (aff.index_select(0, u_d[s:s + step])
                                  * sim_t.index_select(0, it_d[s:s + step])
                                  ).sum(dim=1)
        return dataset.with_column(out_col,
                                   scores.cpu().numpy().astype(np.float64))

    def recommend_for_all_users(self, k: int) -> Dataset:
        """Top-k unseen items per user (reference: SARModel.scala:23-169).
        Dense: one device matmul + top-k. Sparse scale: user-blocked
        SpGEMM on the host (aff_block @ sim stays sparse) with each block's
        top-k on the device over the densified [block, I] result — the
        device holds one block, never the users x items matrix."""
        ucol = self.get_or_default("userCol")
        dev = self._device()
        if _is_sparse_mat(self.userAffinity):
            n_users, n_items = self.userAffinity.shape
            k = min(k, n_items)
            remove = self.get_or_default("removeSeenItems")
            block = max(1, min(n_users, 33_554_432 // max(n_items, 1)))
            ids_out, vals_out = [], []
            for lo in range(0, n_users, block):
                hi = min(lo + block, n_users)
                sb = (self.userAffinity[lo:hi] @ self.itemSimilarity)
                dense = np.asarray(sb.todense(), np.float32)
                if remove:
                    seen_b = self.seen[lo:hi].tocoo()
                    dense[seen_b.row, seen_b.col] = -np.inf
                vals, ids = top_k(torch.as_tensor(dense, device=dev), k)
                ids_out.append(ids.cpu().numpy().astype(np.int32))
                vals_out.append(vals.cpu().numpy())
            return Dataset({
                ucol: np.arange(n_users, dtype=np.int32),
                "recommendations": list(np.concatenate(ids_out)),
                "ratings": list(
                    np.concatenate(vals_out).astype(np.float64)),
            })
        aff = torch.as_tensor(self.userAffinity, device=dev)
        sim = torch.as_tensor(self.itemSimilarity, device=dev)
        scores = aff @ sim
        if self.get_or_default("removeSeenItems"):
            scores.masked_fill_(torch.as_tensor(self.seen, device=dev),
                                float("-inf"))
        vals, ids = top_k(scores, k)
        return Dataset({
            ucol: np.arange(scores.shape[0], dtype=np.int32),
            "recommendations": list(ids.cpu().numpy().astype(np.int32)),
            "ratings": list(vals.cpu().numpy().astype(np.float64)),
        })

    recommendForAllUsers = recommend_for_all_users

    def _save_extra(self, path):
        # clear the OTHER format's files: saving over a directory that held
        # the previous format must not leave a stale model that _load_extra
        # would prefer
        sparse_files = ("sar_sim.npz", "sar_aff.npz", "sar_seen.npz")
        if _is_sparse_mat(self.userAffinity):
            dense_f = os.path.join(path, "sar.npz")
            if os.path.exists(dense_f):
                os.unlink(dense_f)
            sp = _sparse()
            sp.save_npz(os.path.join(path, "sar_sim.npz"),
                        self.itemSimilarity.tocsr())
            sp.save_npz(os.path.join(path, "sar_aff.npz"),
                        self.userAffinity.tocsr())
            sp.save_npz(os.path.join(path, "sar_seen.npz"),
                        self.seen.tocsr())
            return
        for f in sparse_files:
            if os.path.exists(os.path.join(path, f)):
                os.unlink(os.path.join(path, f))
        np.savez_compressed(os.path.join(path, "sar.npz"),
                            sim=self.itemSimilarity, aff=self.userAffinity,
                            seen=self.seen)

    def _load_extra(self, path):
        dense = os.path.join(path, "sar.npz")
        if os.path.exists(dense):
            z = np.load(dense)
            self.itemSimilarity, self.userAffinity = z["sim"], z["aff"]
            self.seen = z["seen"]
            return
        sp = _sparse()
        self.itemSimilarity = sp.load_npz(os.path.join(path, "sar_sim.npz"))
        self.userAffinity = sp.load_npz(os.path.join(path, "sar_aff.npz"))
        self.seen = sp.load_npz(os.path.join(path, "sar_seen.npz"))
        self._sim_csc = None            # invalidate any cached CSC view


def sar_from_jax(item_similarity, user_affinity, seen,
                 params: Optional[Mapping] = None,
                 device=None) -> SARModel:
    """The port's ``SARModel`` for a JAX model's similarity, affinity and
    seen matrices (dense numpy or scipy sparse, as the JAX model holds
    them) and Param values (``extract_param_map()``)."""
    return set_known_params(SARModel(itemSimilarity=item_similarity,
                                     userAffinity=user_affinity, seen=seen),
                            params, device)
