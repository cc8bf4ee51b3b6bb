"""AccessAnomaly: collaborative-filtering anomaly scores for access events.

Counterpart of ``mmlspark_tpu/cyber/anomaly.py``, with its Params plus
``device`` on ``AccessAnomaly`` (default ``cuda``; ``cpu`` only when asked).
A re-design of the reference's ALS-based access-anomaly estimator
(reference: src/main/python/mmlspark/cyber/anomaly/collaborative_filtering.py —
AccessAnomaly / AccessAnomalyModel / ConnectedComponents /
ModelNormalizeTransformer). The Spark ALS engine is replaced by alternating
least squares on the device:

- factor updates are *batched normal-equation solves* accumulated sparsely
  from COO observations sharded over the data group (gather + scatter-add +
  one ``all_reduce`` — the analog of Spark ALS's block shuffle), then solved
  as a batch of rank x rank systems; the user x item matrix is never
  densified, so memory is O((U + I) * rank^2 + nnz);
- implicit feedback uses the Hu-Koren-Volinsky confidence weighting
  (C = 1 + alpha * R), explicit feedback a weighted lasso-free ALS over
  observed entries plus complement-set negatives;
- non-negativity (Spark's ``nonnegative=True``) via projection after each
  sweep.

Scoring parity with the reference's normalization trick: user/resource latent
vectors are augmented with two bias dimensions so that a plain dot product
yields the standardized anomaly score (mean 0, std 1 over training accesses,
higher = more anomalous); user/resource pairs in different connected
components score +inf; pairs present in training history score 0. The
per-tenant loop, the normalization and the connected components are host
code, copied from the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.params import HasDevice, Param, set_known_params
from ..core.pipeline import Estimator, Model
from ..device import DeviceLike, resolve_device
from ..parallel import mesh as meshlib
from ..parallel import placement
from ..utils import prng
from .complement import ComplementAccessTransformer
from .feature import IdIndexer, LinearScalarScaler, MultiIndexer

# observations whose [C, k, k] outer products are formed at once (the JAX
# package's chunk), so peak memory stays O((U + I) * k^2 + nnz)
OBS_CHUNK = 65536


class AccessAnomalyConfig:
    """Default values for AccessAnomaly params (reference:
    collaborative_filtering.py AccessAnomalyConfig)."""

    default_tenant_col = "tenant"
    default_user_col = "user"
    default_res_col = "res"
    default_likelihood_col = "likelihood"
    default_output_col = "anomaly_score"

    default_rank = 10
    default_max_iter = 25
    default_reg_param = 1.0
    default_separate_tenants = False

    default_low_value = 5.0
    default_high_value = 10.0

    default_apply_implicit_cf = True
    default_alpha = 1.0

    default_complementset_factor = 2
    default_neg_score = 1.0


# ---------------------------------------------------------------------------
# ALS on the device
# ---------------------------------------------------------------------------


def _als_init(seed: int, n_users: int, n_items: int, rank: int,
              device: DeviceLike = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial user and item factors, uniform in [0, 0.1) f32 on
    ``device``: the JAX package's draws, bit for bit (``utils/prng.py``):
    ``ku, ki = split(PRNGKey(seed))``, then ``uniform(ku, (U, rank)) *
    0.1`` and ``uniform(ki, (I, rank)) * 0.1``. The only draw of
    ``als_fit``."""
    ku, ki = prng.split(prng.prng_key(seed))
    x0 = prng.uniform(ku, (n_users, rank), device=device) * 0.1
    y0 = prng.uniform(ki, (n_items, rank), device=device) * 0.1
    return x0, y0


def _scatter_add(table: torch.Tensor, idx: torch.Tensor,
                 upd: torch.Tensor) -> None:
    """``table[idx] += upd`` in place. ``index_put_(accumulate=True)``:
    on CUDA it sorts the ids stably and adds each run in observation order,
    so a fit's bits do not change from run to run on the card, where
    ``index_add_``'s float atomics would (f32 sums in a fixed order, as
    the VW learners' ``sgd.scatter_add`` takes them, rather than the
    fixed-point sums of kernel 1's deterministic mode, which would cost a
    conversion per cell). On the CPU with one thread it adds in index order, as the JAX
    package's scatter does; with several threads torch adds with atomics,
    and the last bits may vary."""
    table.index_put_((idx,), upd, accumulate=True)


def _solve_side(other: torch.Tensor, idx_self: torch.Tensor,
                idx_other: torch.Tensor, cm1: torch.Tensor, tgt: torch.Tensor,
                n_self: int, base_gram: bool, reg_eye: torch.Tensor,
                mesh: meshlib.Mesh) -> torch.Tensor:
    """One side's factors from the other's: the normal equations from this
    rank's observations, chunk by chunk, summed over the group, then one
    batched solve and the projection onto >= 0."""
    k = other.shape[1]
    a = torch.zeros((n_self, k, k), dtype=torch.float32, device=other.device)
    b = torch.zeros((n_self, k), dtype=torch.float32, device=other.device)
    for s in range(0, idx_self.numel(), OBS_CHUNK):
        ics = idx_self[s:s + OBS_CHUNK]
        c1 = cm1[s:s + OBS_CHUNK]
        tg = tgt[s:s + OBS_CHUNK]
        yo = other.index_select(0, idx_other[s:s + OBS_CHUNK])   # [C, k]
        _scatter_add(a, ics, c1[:, None, None] * yo[:, :, None]
                     * yo[:, None, :])
        bw = c1 * tg + (tg if base_gram else 0.0)
        _scatter_add(b, ics, bw[:, None] * yo)
    a = mesh.all_reduce(a)
    b = mesh.all_reduce(b)
    if base_gram:
        a = a + other.T @ other                           # YtY (all items)
    a = a + reg_eye
    return torch.clamp(torch.linalg.solve(a, b), min=0.0)


def als_fit(user_idx: np.ndarray, item_idx: np.ndarray, rating: np.ndarray,
            n_users: int, n_items: int, rank: int, max_iter: int,
            reg: float, implicit: bool, alpha: float,
            seed: int = 0, device: DeviceLike = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse blocked ALS on ``device`` (default ``cuda``). Returns
    (user_factors, item_factors) as numpy f32.

    The observation matrix is never densified: every rank passes the same
    COO triples and keeps its slice of them (padded to a whole number of
    slices with weight-0 observations, the JAX package's layout); each
    accumulates its partial per-user (and per-item) normal equations

        A_u = [YtY +] sum_{obs of u} cm1 * y_i y_i^T + reg*I
        b_u = sum_{obs of u} (cm1 * t + [t]) * y_i

    by row gather + scatter-add over its observations, and one
    ``all_reduce`` over the default data group combines the [U, k, k]
    partials. The rank x rank systems then solve as one batched
    ``torch.linalg.solve``.

    Implicit mode is Hu-Koren-Volinsky (preference 1 on observed cells,
    confidence 1 + alpha*r, YtY base gram over ALL items); explicit mode is
    weighted ALS over observed cells only (a 0-valued observed rating, e.g.
    negScore=0, still carries weight 1). ``nonnegative=True`` via projection.
    """
    dev = resolve_device(device)
    nnz = len(rating)
    x, y = _als_init(seed, n_users, n_items, rank, dev)

    mesh = meshlib.get_default_mesh()
    nshards = mesh.size
    placement.plan_for("als.fit", mesh=mesh, rows=nnz, device=dev)
    n_pad = -(-max(nnz, 1) // nshards) * nshards
    pad = n_pad - nnz
    nl = n_pad // nshards
    mine = slice(mesh.rank * nl, (mesh.rank + 1) * nl)

    def local(arr, fill, dtype):
        out = np.concatenate([np.asarray(arr), np.full(pad, fill)]).astype(
            dtype)[mine]
        return torch.as_tensor(out, device=dev)

    ul = local(user_idx, 0, np.int64)
    il = local(item_idx, 0, np.int64)
    rl = local(rating, 0.0, np.float32)
    wl = local(np.ones(nnz), 0.0, np.float32)
    if implicit:
        cm1 = alpha * rl * wl             # c - 1, zero on padding
        # Hu-Koren-Volinsky preference p = [r > 0]: an observed
        # zero-likelihood access is NOT a positive preference. Duplicate
        # (user, item) observations accumulate confidence — repeated
        # accesses are genuinely stronger evidence.
        tgt = wl * (rl > 0)
    else:
        cm1 = wl
        tgt = rl * wl
    reg_eye = torch.eye(rank, dtype=torch.float32, device=dev) * reg
    for _ in range(max_iter):
        x = _solve_side(y, ul, il, cm1, tgt, n_users, implicit, reg_eye,
                        mesh)
        y = _solve_side(x, il, ul, cm1, tgt, n_items, implicit, reg_eye,
                        mesh)
    return x.cpu().numpy(), y.cpu().numpy()


# ---------------------------------------------------------------------------
# Connected components (bipartite user-resource graph, per tenant)
# ---------------------------------------------------------------------------


def connected_components(tenants: list, users: list, resources: list
                         ) -> Tuple[Dict, Dict]:
    """Union-find over per-tenant bipartite access edges; returns
    ((tenant, user) -> component, (tenant, res) -> component). Replaces the
    reference's iterative min-propagation joins
    (collaborative_filtering.py ConnectedComponents)."""
    parent: Dict = {}

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    def union(a, b):
        for node in (a, b):
            if node not in parent:
                parent[node] = node
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for t, u, rsc in zip(tenants, users, resources):
        union((t, "u", u), (t, "r", rsc))

    user2comp: Dict = {}
    res2comp: Dict = {}
    labels: Dict = {}
    for node in parent:
        root = find(node)
        if root not in labels:
            labels[root] = len(labels)
        t, kind, name = node
        (user2comp if kind == "u" else res2comp)[(t, name)] = labels[root]
    return user2comp, res2comp


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class AccessAnomalyModel(Model):
    """Scores (tenant, user, res) rows; mean 0 / std 1 on training accesses,
    higher = more anomalous (reference: AccessAnomalyModel)."""

    outputCol = Param("outputCol", "anomaly score output column",
                      AccessAnomalyConfig.default_output_col)
    tenantCol = Param("tenantCol", "tenant column",
                      AccessAnomalyConfig.default_tenant_col)
    userCol = Param("userCol", "user column",
                    AccessAnomalyConfig.default_user_col)
    resCol = Param("resCol", "resource column",
                   AccessAnomalyConfig.default_res_col)
    userMapping = Param("userMapping", "(tenant, user) -> augmented latent "
                        "vector", None, is_complex=True)
    resMapping = Param("resMapping", "(tenant, res) -> augmented latent "
                       "vector", None, is_complex=True)
    userComponents = Param("userComponents", "(tenant, user) -> component id",
                           None, is_complex=True)
    resComponents = Param("resComponents", "(tenant, res) -> component id",
                          None, is_complex=True)
    historyAccess = Param("historyAccess", "set of seen (tenant, user, res) "
                          "triples scoring 0", None, is_complex=True)
    preserveHistory = Param("preserveHistory",
                            "score known training accesses as exactly 0", True)

    @property
    def preserve_history(self) -> bool:
        return self.get_or_default("preserveHistory")

    @preserve_history.setter
    def preserve_history(self, value: bool) -> None:
        self.set(preserveHistory=bool(value))

    @property
    def user_mapping(self) -> Dict:
        return self.get_or_default("userMapping") or {}

    @property
    def res_mapping(self) -> Dict:
        return self.get_or_default("resMapping") or {}

    def transform(self, dataset: Dataset) -> Dataset:
        tenant_col = self.get_or_default("tenantCol")
        user_col = self.get_or_default("userCol")
        res_col = self.get_or_default("resCol")
        out_col = self.get_or_default("outputCol")
        user_map, res_map = self.user_mapping, self.res_mapping
        user_comp = self.get_or_default("userComponents") or {}
        res_comp = self.get_or_default("resComponents") or {}
        history = self.get_or_default("historyAccess") or set()

        tenants = list(dataset[tenant_col])
        users = list(dataset[user_col])
        ress = list(dataset[res_col])

        scores = np.full(len(tenants), np.nan)
        known = []
        uvecs, rvecs = [], []
        for i, (t, u, rsc) in enumerate(zip(tenants, users, ress)):
            uv, rv = user_map.get((t, u)), res_map.get((t, rsc))
            if uv is None or rv is None:
                continue                       # cold user/resource -> NaN
            if self.preserve_history and (t, u, rsc) in history:
                scores[i] = 0.0
                continue
            cu, cr = user_comp.get((t, u)), res_comp.get((t, rsc))
            if cu is not None and cr is not None and cu != cr:
                scores[i] = np.inf             # never-connected pair
                continue
            known.append(i)
            uvecs.append(uv)
            rvecs.append(rv)
        if known:
            dots = np.einsum("nk,nk->n", np.asarray(uvecs), np.asarray(rvecs))
            scores[np.asarray(known)] = dots
        return dataset.with_column(out_col, scores)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class AccessAnomaly(Estimator, HasDevice):
    """Fit per-tenant user/resource latent factors on access likelihoods and
    produce a standardized anomaly scorer (reference: AccessAnomaly)."""

    tenantCol = Param("tenantCol", "tenant column (isolation axis)",
                      AccessAnomalyConfig.default_tenant_col)
    userCol = Param("userCol", "user column",
                    AccessAnomalyConfig.default_user_col)
    resCol = Param("resCol", "resource column",
                   AccessAnomalyConfig.default_res_col)
    likelihoodCol = Param("likelihoodCol", "access likelihood column",
                          AccessAnomalyConfig.default_likelihood_col)
    outputCol = Param("outputCol", "anomaly score output column",
                      AccessAnomalyConfig.default_output_col)
    rankParam = Param("rankParam", "latent factors",
                      AccessAnomalyConfig.default_rank)
    maxIter = Param("maxIter", "ALS sweeps",
                    AccessAnomalyConfig.default_max_iter)
    regParam = Param("regParam", "ALS regularization",
                     AccessAnomalyConfig.default_reg_param)
    separateTenants = Param("separateTenants",
                            "run ALS per tenant in isolation",
                            AccessAnomalyConfig.default_separate_tenants)
    lowValue = Param("lowValue", "likelihood rescale lower bound",
                     AccessAnomalyConfig.default_low_value)
    highValue = Param("highValue", "likelihood rescale upper bound",
                      AccessAnomalyConfig.default_high_value)
    applyImplicitCf = Param("applyImplicitCf", "implicit-feedback ALS",
                            AccessAnomalyConfig.default_apply_implicit_cf)
    alphaParam = Param("alphaParam", "implicit confidence alpha", None)
    complementsetFactor = Param("complementsetFactor",
                                "explicit-mode complement sample factor", None)
    negScore = Param("negScore", "explicit-mode complement score", None)
    seed = Param("seed", "rng seed", 0)

    def _validate(self):
        implicit = self.get_or_default("applyImplicitCf")
        alpha = self.get_or_default("alphaParam")
        factor = self.get_or_default("complementsetFactor")
        neg = self.get_or_default("negScore")
        if implicit:
            if factor is not None or neg is not None:
                raise ValueError("complementsetFactor/negScore apply only to "
                                 "explicit CF (applyImplicitCf=False)")
        elif alpha is not None:
            raise ValueError("alphaParam applies only to implicit CF")
        low, high = self.get_or_default("lowValue"), self.get_or_default("highValue")
        if (low is None) != (high is None):
            raise ValueError("lowValue and highValue must be set together")
        if low is not None and low < 1.0:
            raise ValueError("lowValue must be >= 1.0")
        if low is not None and high is not None and high <= low:
            raise ValueError("highValue must exceed lowValue")
        if low is not None and neg is not None and neg >= low:
            raise ValueError("negScore must be below lowValue so complement "
                             "negatives rank under every real access")

    def fit(self, dataset: Dataset) -> AccessAnomalyModel:
        self._validate()
        dev = self._device()
        tenant_col = self.get_or_default("tenantCol")
        user_col = self.get_or_default("userCol")
        res_col = self.get_or_default("resCol")
        likelihood_col = self.get_or_default("likelihoodCol")
        rank = self.get_or_default("rankParam")
        implicit = self.get_or_default("applyImplicitCf")
        seed = self.get_or_default("seed")
        iu_col, ir_col = user_col + "_index", res_col + "_index"

        indexer = MultiIndexer(indexers=[
            IdIndexer(user_col, tenant_col, iu_col,
                      self.get_or_default("separateTenants")),
            IdIndexer(res_col, tenant_col, ir_col,
                      self.get_or_default("separateTenants")),
        ])
        indexer_model = indexer.fit(dataset)
        indexed = indexer_model.transform(dataset)

        # Rescale likelihoods into [low, high] per tenant so implicit
        # confidences are bounded (reference: _get_scaled_df).
        low, high = self.get_or_default("lowValue"), self.get_or_default("highValue")
        scaled_col = likelihood_col + "_scaled"
        if low is not None:
            scaler = LinearScalarScaler(likelihood_col, tenant_col, scaled_col,
                                        low, high)
            indexed = scaler.fit(indexed).transform(indexed)
        else:
            indexed = indexed.with_column(
                scaled_col, indexed.array(likelihood_col, np.float64))

        tenants = list(indexed[tenant_col])
        u_idx = indexed.array(iu_col).astype(np.int64)
        r_idx = indexed.array(ir_col).astype(np.int64)
        rating = indexed.array(scaled_col, np.float64)

        # Explicit mode: add complement-set negatives (reference:
        # _enrich_and_normalize).
        if not implicit:
            factor = self.get_or_default("complementsetFactor")
            factor = (AccessAnomalyConfig.default_complementset_factor
                      if factor is None else factor)
            neg = self.get_or_default("negScore")
            neg = AccessAnomalyConfig.default_neg_score if neg is None else neg
            comp = ComplementAccessTransformer(
                tenant_col, [iu_col, ir_col], factor,
                seed=seed).transform(
                Dataset({tenant_col: tenants, iu_col: u_idx, ir_col: r_idx}))
            if len(comp):
                tenants = tenants + list(comp[tenant_col])
                u_idx = np.concatenate([u_idx, comp.array(iu_col)])
                r_idx = np.concatenate([r_idx, comp.array(ir_col)])
                rating = np.concatenate(
                    [rating, np.full(len(comp), float(neg))])

        alpha = self.get_or_default("alphaParam")
        alpha = AccessAnomalyConfig.default_alpha if alpha is None else alpha

        # Tenants share no observations, so the joint factorization is
        # block-diagonal: solve one compact dense ALS per tenant (local
        # reindex via np.unique) instead of densifying the full global
        # (all-users x all-resources) matrix, which would be quadratic in
        # tenant count with only the diagonal blocks ever nonzero.
        user_vecs: Dict[Tuple, np.ndarray] = {}
        res_vecs: Dict[Tuple, np.ndarray] = {}
        tenants_arr = np.asarray(tenants)
        for t in sorted(set(tenants)):
            mask = tenants_arr == t
            uu, ui = np.unique(u_idx[mask], return_inverse=True)
            ru, ri = np.unique(r_idx[mask], return_inverse=True)
            x, y = als_fit(ui, ri, rating[mask], len(uu), len(ru), rank,
                           self.get_or_default("maxIter"),
                           self.get_or_default("regParam"),
                           implicit, alpha, seed, device=dev)
            for local, g in enumerate(uu):
                user_vecs[(t, int(g))] = x[local]
            for local, g in enumerate(ru):
                res_vecs[(t, int(g))] = y[local]

        # --- normalization: standardize dot products per tenant, folded into
        # two appended bias dims (reference: ModelNormalizeTransformer).
        #   user' = (-1/std) * [u, -mean, 1];  res' = [r, 1, 0]
        #   => dot(user', res') = (mean - dot(u, r)) / std
        train_dots: Dict = {}
        for t, ui, ri in zip(tenants, u_idx, r_idx):
            uv = user_vecs.get((t, int(ui)))
            rv = res_vecs.get((t, int(ri)))
            if uv is not None and rv is not None:
                train_dots.setdefault(t, []).append(float(uv @ rv))
        stats = {t: (float(np.mean(v)), float(np.std(v)) or 1.0)
                 for t, v in train_dots.items()}

        user_aug = {}
        for (t, i), v in user_vecs.items():
            mean, std = stats.get(t, (0.0, 1.0))
            user_aug[(t, i)] = (-1.0 / std) * np.concatenate(
                [v, [-mean, 1.0]]).astype(np.float64)
        res_aug = {(t, i): np.concatenate([v, [1.0, 0.0]]).astype(np.float64)
                   for (t, i), v in res_vecs.items()}

        # De-index: model keys are original (tenant, name) pairs.
        user_index_model = indexer_model.get_model_by_input_col(user_col)
        res_index_model = indexer_model.get_model_by_input_col(res_col)
        u_inv = {(t, i): v for ((t, v), i)
                 in user_index_model.get_or_default("vocabulary").items()}
        r_inv = {(t, i): v for ((t, v), i)
                 in res_index_model.get_or_default("vocabulary").items()}
        user_mapping = {(t, u_inv[(t, i)]): v
                        for (t, i), v in user_aug.items() if (t, i) in u_inv}
        res_mapping = {(t, r_inv[(t, i)]): v
                       for (t, i), v in res_aug.items() if (t, i) in r_inv}

        orig_tenants = list(dataset[tenant_col])
        orig_users = list(dataset[user_col])
        orig_ress = list(dataset[res_col])
        user_comp, res_comp = connected_components(
            orig_tenants, orig_users, orig_ress)
        history = set(zip(orig_tenants, orig_users, orig_ress))

        model = AccessAnomalyModel()
        model.set(tenantCol=tenant_col, userCol=user_col, resCol=res_col,
                  outputCol=self.get_or_default("outputCol"),
                  userMapping=user_mapping, resMapping=res_mapping,
                  userComponents=user_comp, resComponents=res_comp,
                  historyAccess=history)
        return model


def access_anomaly_from_jax(params: Mapping) -> AccessAnomalyModel:
    """The port's ``AccessAnomalyModel`` for a JAX model's Param values
    (``extract_param_map()``: the augmented factor dicts, the components
    and the access history). The model scores on the host, as the JAX
    model does."""
    return set_known_params(AccessAnomalyModel(), params)
