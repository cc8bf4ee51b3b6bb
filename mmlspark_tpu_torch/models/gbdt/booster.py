"""GBDT training driver, dataset construction and the Booster container.

Counterpart of ``mmlspark_tpu/models/gbdt/booster.py`` for one device:

  * :class:`LightGBMDataset` — quantile-bins once into the device-resident
    column-major ``[F, n]`` matrix tree growth consumes (reference:
    lightgbm/LightGBMDataset.scala:70-159);
  * :func:`train_booster` — the per-iteration host loop for ``gbdt`` with
    ``boost_from_average`` (reference: TrainUtils.scala:220-315): K trees
    per iteration for K score columns (multiclass), leafwise or depthwise
    growth, full-precision or quantized-gradient histograms, a validation
    set scored tree by tree with early stopping, metric overrides and the
    training metric; bagging, dart/goss/rf, warm starts and checkpoints are
    not ported yet;
  * :class:`Booster` — the stacked fixed-shape forest, scoring raw rows on
    the device (``predict_raw`` / ``predict``, categorical splits and the
    missing-value routing of imported models included; ``predict_leaf``;
    ``feature_importances``), saved as ``.npz`` in the JAX package's layout
    and read and written as LightGBM's text model format.

Sparse scipy feature matrices are densified in row blocks
(:func:`_densify`) before binning and scoring.

On one device the padded row count equals the row count (the JAX package
pads rows only to a multiple of the mesh's shard count), so histogram
subtraction and its ``n // 2`` buffer engage exactly as they do there.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...ops.binning import QuantileBinner, bin_cols
from ...ops.histogram import quant_key
from ...core.dataset import _is_sparse
from .growth import (GrowConfig, Tree, forest_leaf_nodes, grow_tree,
                     grow_tree_depthwise, predict_forest_raw,
                     predict_tree_binned, resolve_growth_backend)
from .objectives import (HIGHER_IS_BETTER, SUPPORTED_EVAL_METRICS,
                         auc_weighted, eval_metric, get_objective,
                         metric_family, score_transform)

_BIN_DTYPES = {"int32": (torch.int32, 1 << 31), "int16": (torch.int16, 1 << 15),
               "uint8": (torch.uint8, 256)}

# elements of the [trees, rows] routing transients predict keeps at once
_PREDICT_BUDGET = 1 << 24

# each tree field's host dtype (the JAX package's layout)
TREE_DTYPES = {"feat": np.int32, "thr_bin": np.int32, "left": np.int32,
               "right": np.int32, "is_leaf": np.bool_,
               "leaf_value": np.float32, "node_count": np.int32,
               "node_grad": np.float32, "node_hess": np.float32,
               "node_cnt": np.float32, "split_gain": np.float32,
               "node_value": np.float32, "cat_bitset": np.uint32}


def _bin_dtype(bin_dtype, max_bin: int) -> torch.dtype:
    """Bin-id storage dtype: int32 (default), int16 or uint8. Bin ids are
    < max_bin, so narrow storage is lossless within range."""
    name = "int32" if bin_dtype is None else str(bin_dtype)
    if name not in _BIN_DTYPES:
        raise ValueError(
            f"bin_dtype must be one of {sorted(_BIN_DTYPES)}, got {name}")
    dtype, limit = _BIN_DTYPES[name]
    if max_bin > limit:
        raise ValueError(f"bin_dtype={name} holds bin ids < {limit}, but "
                         f"max_bin={max_bin}")
    return dtype


class LightGBMDataset:
    """Pre-binned, device-resident GBDT training dataset: bin once, train
    many. ``Xbt`` is the ``[F, n_pad]`` bin matrix; ``y``, ``w`` and
    ``vmask`` are ``[n_pad]`` f32."""

    def __init__(self, binner: QuantileBinner, Xbt: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor, vmask: torch.Tensor,
                 n: int, n_pad: int, max_bin: int,
                 categorical_features=()):
        self.binner = binner
        self.Xbt = Xbt
        self.y = y
        self.w = w
        self.vmask = vmask
        self.n = n
        self.n_pad = n_pad
        self.max_bin = max_bin
        self.categorical_features = tuple(
            int(i) for i in categorical_features)

    @property
    def num_features(self) -> int:
        return int(self.Xbt.shape[0])

    @property
    def device(self) -> torch.device:
        return self.Xbt.device

    @classmethod
    def construct(cls, X, y, weight=None, *, max_bin: int = 255,
                  bin_sample_count: int = 200_000, seed: int = 0,
                  bin_dtype=None, max_bin_by_feature=None,
                  row_valid: Optional[np.ndarray] = None,
                  categorical_features=(),
                  device: DeviceLike = None) -> "LightGBMDataset":
        """Fit the quantile binner on the host (numpy), move the raw rows
        to ``device`` and bin them there into ``[F, n]``. ``row_valid``
        ([n], 0 or 1) marks rows that must not count in histograms or
        totals (the ranker's in-group padding); the binner still sees every
        row, as the JAX package's does. ``categorical_features`` (feature
        indexes) bin as category ids (bin ``c`` holds id ``c``; ids past
        ``max_bin - 1`` share the last bin). A scipy sparse ``X`` is
        densified first (:func:`_densify`)."""
        dev = resolve_device(device)
        X = np.asarray(_densify(X), dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n, F = X.shape
        if y.shape != (n,):
            raise ValueError(f"y must have shape ({n},), got {y.shape}")
        bad_cats = [int(i) for i in categorical_features
                    if not (0 <= int(i) < F)]
        if bad_cats:
            raise ValueError(
                f"categorical_features indexes {bad_cats} out of range for "
                f"{F} features")
        bd = _bin_dtype(bin_dtype, max_bin)
        binner = QuantileBinner(max_bin, bin_sample_count, seed,
                                categorical_features,
                                max_bin_by_feature).fit(X)
        X_d = torch.from_numpy(X).to(dev)
        Xbt = bin_cols(X_d, torch.from_numpy(binner.upper_bounds), bd)
        del X_d             # only the bin matrix stays resident
        vmask = (torch.ones(n, dtype=torch.float32, device=dev)
                 if row_valid is None else
                 torch.from_numpy(np.asarray(row_valid, np.float32)).to(dev))
        w = (vmask if weight is None
             else torch.from_numpy(np.asarray(weight, np.float32)).to(dev))
        return cls(binner, Xbt, torch.from_numpy(y).to(dev), w, vmask, n, n,
                   max_bin, categorical_features)


def _densify(X):
    """A scipy sparse matrix (CSR or CSC) as a dense f32 array, filled in
    row blocks of about 8 MB so the host holds the output and one block
    (LGBM_DatasetCreateFromCSR parity, reference:
    lightgbm/LightGBMUtils.scala:227); anything else is returned as is."""
    if not _is_sparse(X):
        return X
    X = X.tocsr()
    n, F = X.shape
    out = np.zeros((n, F), dtype=np.float32)
    step = max(1, (8 << 20) // max(F * 4, 1))
    for start in range(0, n, step):
        out[start:start + step] = X[start:start + step].toarray()
    return out


def _with_tree_defaults(trees: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fill tree fields that older files lack (``node_value`` from
    ``leaf_value``; an all-zero one-word ``cat_bitset``: no categorical
    split) and cast every field to its :data:`TREE_DTYPES` dtype."""
    trees = dict(trees)
    if "node_value" not in trees and "leaf_value" in trees:
        trees["node_value"] = trees["leaf_value"]
    if "cat_bitset" not in trees and "feat" in trees:
        trees["cat_bitset"] = np.zeros(
            (*np.asarray(trees["feat"]).shape, 1), np.uint32)
    return {k: np.asarray(v).astype(TREE_DTYPES[k]) if k in TREE_DTYPES
            else v for k, v in trees.items()}


class Booster:
    """A trained GBDT ensemble: fixed-shape trees stacked on a leading
    ``[T]`` axis, held as numpy on the host and uploaded to a device on
    first use there.

    ``missing_dec`` ([T, M] uint8 LightGBM decision_type bytes: bit 1
    default-left, bits 2-3 the missing type) is set only for models read
    from LightGBM text whose splits store other missing-value handling than
    this package's own (NaN left); None routes NaN left."""

    def __init__(self, trees: Dict[str, np.ndarray], thr_raw: np.ndarray,
                 num_class: int, base_score, objective: str, depth_cap: int,
                 binner_state: Optional[dict] = None, best_iteration: int = -1,
                 eval_history: Optional[Dict[str, List[float]]] = None,
                 objective_kwargs: Optional[dict] = None,
                 missing_dec: Optional[np.ndarray] = None):
        trees = _with_tree_defaults(trees)
        missing = [f for f in Tree._fields if f not in trees]
        if missing:
            raise ValueError(f"tree arrays lack fields {missing}")
        self.trees = {f: trees[f] for f in Tree._fields}
        self.thr_raw = np.asarray(thr_raw, dtype=np.float32)
        self.num_class = int(num_class)
        self.base_score = np.asarray(base_score, dtype=np.float32).reshape(-1)
        self.objective = objective
        # a list (the ranker's label_gain after a JSON round trip) is held
        # as the tuple the estimator fitted with
        self.objective_kwargs = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in (objective_kwargs or {}).items()}
        self.depth_cap = int(depth_cap)
        self.binner_state = binner_state
        self.best_iteration = int(best_iteration)
        self.eval_history = eval_history or {}
        self.missing_dec = (None if missing_dec is None
                            else np.asarray(missing_dec, np.uint8))
        self._dev_forest: Dict[str, dict] = {}
        get_objective(objective, self.num_class, **self.objective_kwargs)

    @property
    def num_trees(self) -> int:
        return int(self.trees["feat"].shape[0])

    @property
    def num_iterations(self) -> int:
        return self.num_trees // self.num_class

    @property
    def num_features(self) -> int:
        return int(self.binner_state["upper_bounds"].shape[0])

    def _cat_max_idx(self) -> int:
        """Largest category bin id: the binner's last bin (the catch-all of
        a model trained here), else the bitsets' last bit."""
        mb = (self.binner_state or {}).get("max_bin") or 0
        if mb > 0:
            return mb - 1
        return int(self.trees["cat_bitset"].shape[-1]) * 32 - 1

    def _cat_strict(self) -> bool:
        """Models without a binner (read from LightGBM text) route
        categories by ``FindInBitset``: ids outside the bitset and NaN go
        right."""
        return ((self.binner_state or {}).get("max_bin") or 0) <= 0

    def _is_cat(self) -> Optional[np.ndarray]:
        """[F] bool mask of categorical features, or None if there is
        none."""
        cats = (self.binner_state or {}).get("categorical_features") or ()
        if self.binner_state is None or not cats:
            return None
        F = self.num_features
        cats = [int(i) for i in cats if 0 <= int(i) < F]
        if not cats:
            return None
        m = np.zeros(F, dtype=bool)
        m[np.asarray(cats, dtype=int)] = True
        return m

    def _forest_on(self, dev: torch.device) -> dict:
        """The routing arrays, base score, categorical bitsets and mask and
        missing-value bytes on ``dev``, uploaded once per device. Bitsets
        go up as int64 words."""
        ent = self._dev_forest.get(str(dev))
        if ent is None:
            t = self.trees
            ent = {k: torch.tensor(a, device=dev) for k, a in (
                ("feat", t["feat"]), ("thr", self.thr_raw),
                ("left", t["left"]), ("right", t["right"]),
                ("is_leaf", t["is_leaf"]), ("leaf", t["leaf_value"]),
                ("base", self.base_score))}
            is_cat = self._is_cat()
            ent["is_cat"] = (None if is_cat is None
                             else torch.tensor(is_cat, device=dev))
            ent["bits"] = (None if is_cat is None else torch.tensor(
                t["cat_bitset"].astype(np.int64), device=dev))
            ent["mdec"] = (None if self.missing_dec is None else torch.tensor(
                self.missing_dec.astype(np.int64), device=dev))
            self._dev_forest[str(dev)] = ent
        return ent

    def _routing(self, ent: dict, t_end: int, missing: bool = True) -> dict:
        """The keyword options of :func:`forest_leaf_nodes` for the first
        ``t_end`` trees (``missing=False``: without ``missing_dec``, NaN
        left)."""
        kw = {}
        if ent["is_cat"] is not None:
            kw.update(is_cat=ent["is_cat"], cat_bitset=ent["bits"][:t_end],
                      cat_max_bin=(0 if self._cat_strict()
                                   else self._cat_max_idx() + 1))
        if missing and ent["mdec"] is not None:
            kw["missing_dec"] = ent["mdec"][:t_end]
        return kw

    def predict_raw_tensor(self, X: torch.Tensor,
                           num_iteration: int = -1) -> torch.Tensor:
        """Raw margins ``[n, num_class]`` f32 for rows ``X`` ([n, F] f32)
        on ``X``'s device: every tree's leaf value, summed per class (tree
        ``t`` scores class ``t % num_class``), plus the base score.

        Trees are added one at a time, in order, so every device rounds the
        same sums the same way: the margins are bit-identical on the CPU and
        the GPU."""
        if num_iteration is None or num_iteration < 0:
            num_iteration = self.num_iterations
        t_end = min(num_iteration * self.num_class, self.num_trees)
        ent = self._forest_on(X.device)
        routing = self._routing(ent, t_end)
        n, K = X.shape[0], self.num_class
        per_class = torch.zeros((K, n), dtype=torch.float32, device=X.device)
        rows = max(1, _PREDICT_BUDGET // max(t_end, 1))
        for s in range(0, n, rows):
            vals = predict_forest_raw(
                ent["feat"][:t_end], ent["thr"][:t_end], ent["left"][:t_end],
                ent["right"][:t_end], ent["is_leaf"][:t_end],
                ent["leaf"][:t_end], X[s:s + rows], self.depth_cap,
                **routing)                                    # [t_end, r]
            for t in range(t_end):
                per_class[t % K, s:s + rows] += vals[t]
        return per_class.t() + ent["base"][None, :]

    def _rows_on(self, X, device: DeviceLike) -> torch.Tensor:
        dev = resolve_device(device)
        return torch.tensor(np.asarray(_densify(X), dtype=np.float32),
                            device=dev)

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    device: DeviceLike = None) -> np.ndarray:
        """Raw margin scores: ``[n, num_class]`` (num_class=1 for binary and
        regression), computed on ``device`` (default ``cuda``)."""
        Xt = self._rows_on(X, device)
        return self.predict_raw_tensor(Xt, num_iteration).cpu().numpy()

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                device: DeviceLike = None) -> np.ndarray:
        """Transformed prediction: ``[n]`` (probability for binary), or
        ``[n, num_class]`` softmax probabilities for multiclass."""
        Xt = self._rows_on(X, device)
        transform = score_transform(self.objective, self.num_class,
                                    **self.objective_kwargs)
        return transform(self.predict_raw_tensor(Xt, num_iteration)
                         ).cpu().numpy()

    # -- introspection -------------------------------------------------------
    def _check_missing_routing(self, X: np.ndarray) -> None:
        """``predict_leaf`` routes NaN left and zeros by the threshold. For
        imported models that store other missing-value handling
        (``missing_dec``), inputs that would take those rules raise rather
        than route differently from ``predict``/``predict_raw``."""
        if self.missing_dec is None:
            return
        # the float32 view the routing traverses: f64 values that underflow
        # to 0.0 in f32 must not slip the check
        X = np.asarray(X, dtype=np.float32)
        mt = (self.missing_dec >> 2) & 3
        internal = ~np.asarray(self.trees["is_leaf"])
        if (bool(((mt == 1) & internal).any())
                and (np.abs(X) <= 1e-35).any()):
            raise NotImplementedError(
                "predict_leaf does not implement zero-as-missing routing "
                "for imported models; use predict()/predict_raw()")
        if np.isnan(X).any():
            raise NotImplementedError(
                "predict_leaf routes NaN left unconditionally, but this "
                "imported model stores different missing handling; impute "
                "NaNs or use predict()/predict_raw()")

    def predict_leaf(self, X: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
        """The node slot each row reaches in each tree: ``[n, T]`` int32
        (predLeaf parity, reference: lightgbm/LightGBMBooster.scala:250-269),
        routed on ``device`` (default ``cuda``)."""
        X32 = np.asarray(_densify(X), dtype=np.float32)
        self._check_missing_routing(X32)
        Xt = self._rows_on(X32, device)
        ent = self._forest_on(Xt.device)
        T = self.num_trees
        routing = self._routing(ent, T, missing=False)
        out = torch.empty((Xt.shape[0], T), dtype=torch.int32,
                          device=Xt.device)
        rows = max(1, _PREDICT_BUDGET // max(T, 1))
        for s in range(0, Xt.shape[0], rows):
            out[s:s + rows] = forest_leaf_nodes(
                ent["feat"], ent["thr"], ent["left"], ent["right"],
                ent["is_leaf"], Xt[s:s + rows], self.depth_cap,
                **routing).t().to(torch.int32)
        return out.cpu().numpy()

    def feature_importances(self, importance_type: str = "split"
                            ) -> np.ndarray:
        """Per-feature importances over the internal nodes: ``split``
        counts, ``gain`` sums split gains (reference:
        LightGBMBooster.scala:306)."""
        out = np.zeros(self.num_features, dtype=np.float64)
        internal = ~self.trees["is_leaf"]
        feats = self.trees["feat"][internal]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, self.trees["split_gain"][internal])
        else:
            raise ValueError(f"importance_type must be split|gain, got "
                             f"{importance_type}")
        return out

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """``.npz`` in the JAX package's layout (``tree_<field>``, bitsets
        as uint32 ``[T, M, BW]``, ``thr_raw``, ``base_score``,
        ``binner_upper_bounds``, ``missing_dec`` where set,
        ``meta_json``)."""
        if self.binner_state is None:
            raise ValueError("a booster without a binner state cannot be "
                             "saved")
        arrays = {f"tree_{k}": v for k, v in self.trees.items()}
        arrays["thr_raw"] = self.thr_raw
        arrays["base_score"] = self.base_score
        arrays["binner_upper_bounds"] = self.binner_state["upper_bounds"]
        if self.missing_dec is not None:
            arrays["missing_dec"] = self.missing_dec
        bs = self.binner_state
        meta = dict(
            num_class=self.num_class, objective=self.objective,
            objective_kwargs=self.objective_kwargs, depth_cap=self.depth_cap,
            best_iteration=self.best_iteration, eval_history=self.eval_history,
            binner=dict(max_bin=bs["max_bin"],
                        sample_count=bs["sample_count"], seed=bs["seed"],
                        num_features=bs["num_features"],
                        categorical_features=list(
                            bs.get("categorical_features") or []),
                        max_bin_by_feature=bs.get("max_bin_by_feature"),
                        feature_names=bs.get("feature_names")))
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "Booster":
        if not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            trees = {k: z[f"tree_{k}"] for k in Tree._fields
                     if f"tree_{k}" in z}
            binner_state = dict(meta["binner"])
            binner_state["upper_bounds"] = z["binner_upper_bounds"]
            thr_raw, base = z["thr_raw"], z["base_score"]
            mdec = z["missing_dec"] if "missing_dec" in z else None
        return Booster(trees, thr_raw, meta["num_class"], base,
                       meta["objective"], meta["depth_cap"], binner_state,
                       meta["best_iteration"], meta["eval_history"],
                       meta.get("objective_kwargs") or {}, missing_dec=mdec)

    def to_lightgbm_string(self) -> str:
        """The model as LightGBM's ``tree`` v3 text format, which any
        LightGBM tooling loads (saveNativeModel parity, reference:
        LightGBMClassifier.scala:172-194, LightGBMBooster.scala:289)."""
        from .lgbm_format import to_lightgbm_string
        return to_lightgbm_string(self)

    @staticmethod
    def from_lightgbm_string(s: str) -> "Booster":
        """Read a LightGBM text model (written by LightGBM or by
        :meth:`to_lightgbm_string`). The base score is 0: LightGBM folds
        any init score into the first iteration's leaves. The binner is a
        stub with ``max_bin=0``, so categorical splits route strictly."""
        from .lgbm_format import parse_lightgbm_string
        (trees, thr_raw, K, objective, kwargs, F,
         cat_features, missing_dec) = parse_lightgbm_string(s)
        M = trees.feat.shape[1]
        depth_cap = max(1, (M + 1) // 2 - 1)
        binner_state = dict(upper_bounds=np.zeros((F, 1), np.float32),
                            max_bin=0, sample_count=0, seed=0,
                            num_features=F,
                            categorical_features=list(cat_features))
        return Booster(trees._asdict(), thr_raw, K, np.zeros(K, np.float32),
                       objective, depth_cap, binner_state,
                       objective_kwargs=kwargs, missing_dec=missing_dec)

    def model_string(self) -> str:
        """The model as this package's JSON string (binner state, base
        score and history kept exactly; the JAX package reads it). For
        LightGBM tools use :meth:`to_lightgbm_string`; :meth:`from_string`
        reads both."""
        d = {
            "version": 1,
            "num_class": self.num_class,
            "objective": self.objective,
            "objective_kwargs": self.objective_kwargs,
            "depth_cap": self.depth_cap,
            "best_iteration": self.best_iteration,
            "base_score": self.base_score.tolist(),
            "thr_raw": self.thr_raw.tolist(),
            "trees": {k: np.asarray(v).tolist()
                      for k, v in self.trees.items()},
            "binner": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in (self.binner_state or {}).items()},
        }
        if self.missing_dec is not None:
            d["missing_dec"] = self.missing_dec.tolist()
        return json.dumps(d)

    @staticmethod
    def from_string(s: str) -> "Booster":
        """Read :meth:`model_string` JSON or LightGBM text (a string that
        starts with ``tree``)."""
        if s.lstrip().startswith("tree"):
            return Booster.from_lightgbm_string(s)
        d = json.loads(s)
        binner_state = dict(d["binner"])
        binner_state["upper_bounds"] = np.asarray(
            binner_state["upper_bounds"], dtype=np.float32)
        return Booster({k: np.asarray(v) for k, v in d["trees"].items()},
                       np.asarray(d["thr_raw"], np.float32), d["num_class"],
                       np.asarray(d["base_score"], np.float32),
                       d["objective"], d["depth_cap"], binner_state,
                       d["best_iteration"],
                       objective_kwargs=d.get("objective_kwargs") or {},
                       missing_dec=d.get("missing_dec"))


def _finalize_trees(trees_list: List[Tree], binner: QuantileBinner,
                    max_bin: int, K: int, base: np.ndarray, objective: str,
                    depth_cap: int, objective_kwargs: dict, best_iter: int,
                    history: Dict[str, List[float]]) -> Booster:
    """Stack grown trees into a Booster (raw thresholds from bin bounds;
    the int64 bitset words become uint32); tree ``t`` scores class
    ``t % K``."""
    stacked = {f: torch.stack([getattr(t, f) for t in trees_list]).cpu()
               .numpy().astype(TREE_DTYPES[f]) for f in Tree._fields}
    upper = binner.bin_upper_raw()                         # [F, B]
    thr_raw = upper[stacked["feat"],
                    np.minimum(stacked["thr_bin"], max_bin - 1)]
    thr_raw = np.where(stacked["is_leaf"], np.float32(np.inf), thr_raw)
    return Booster(stacked, thr_raw.astype(np.float32), K, base, objective,
                   depth_cap, binner.state(), best_iteration=best_iter,
                   eval_history=history, objective_kwargs=objective_kwargs)


def _truncate_booster(b: Booster, num_iterations: int) -> Booster:
    """The first ``num_iterations`` iterations (K trees each) of ``b``."""
    t_end = num_iterations * b.num_class
    return Booster({f: a[:t_end] for f, a in b.trees.items()},
                   b.thr_raw[:t_end], b.num_class, b.base_score, b.objective,
                   b.depth_cap, b.binner_state, b.best_iteration,
                   b.eval_history, b.objective_kwargs)


def _metric_override(objective: str, eval_metric_name: Optional[str]):
    """(early-stopping metric override or None, whether it is the host
    ``auc``), checked against SUPPORTED_EVAL_METRICS."""
    requested = (eval_metric_name or "").strip() or None
    if requested:
        allowed = SUPPORTED_EVAL_METRICS[metric_family(objective)]
        if requested not in allowed:
            raise ValueError(
                f"metric={requested!r} is not supported for the "
                f"{objective!r} objective (choose from {allowed})")
    return requested, requested == "auc"


def train_booster(
    X: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    *,
    dataset: Optional[LightGBMDataset] = None,
    objective: str = "regression",
    num_class: int = 1,
    num_iterations: int = 100,
    cfg: Optional[GrowConfig] = None,
    max_bin: int = 255,
    bin_sample_count: int = 200_000,
    feature_fraction: float = 1.0,
    seed: int = 0,
    valid_set: Optional[Tuple[np.ndarray, np.ndarray,
                              Optional[np.ndarray]]] = None,
    early_stopping_rounds: int = 0,
    boost_from_average: bool = True,
    objective_kwargs: Optional[dict] = None,
    metric_eval_period: int = 1,
    row_valid: Optional[np.ndarray] = None,
    bin_dtype=None,
    early_stopping_tolerance: float = 0.0,
    provide_training_metric: bool = False,
    max_bin_by_feature=None,
    eval_metric_name: Optional[str] = None,
    categorical_features=(),
    device: DeviceLike = None,
) -> Booster:
    """Train a ``gbdt`` ensemble on one device (default ``cuda``).

    Each iteration computes grad/hess from the objective on the current
    ``[n, K]`` margin (K = 1, or ``num_class`` for multiclass), grows one
    tree per score column (``cfg.growth_policy``: leafwise or depthwise) on
    its grad/hess column and adds its leaf values to that column.
    ``dataset`` (a pre-built :class:`LightGBMDataset`) skips the ingest;
    its device wins over ``device``. ``feature_fraction < 1`` draws each
    iteration's feature subset from a ``torch.Generator`` seeded with
    ``seed`` (its draws differ from the JAX package's ``jax.random``). With
    ``cfg.quantized_grad``, iterations below ``cfg.quant_warmup_iters``
    grow at full precision and later ones on int8 histograms, each tree
    stochastically rounded under ``quant_key(seed, iteration, class)`` (the
    JAX package folds ``13 + class`` into its iteration key and draws with
    ``jax.random``, so the two packages round differently).

    ``valid_set`` ``(X, y, weight or None)`` is binned with the dataset's
    binner and scored tree by tree; every ``metric_eval_period``
    iterations (and the last) its metric — the objective's default, or
    ``eval_metric_name`` from ``SUPPORTED_EVAL_METRICS`` (``auc`` on the
    host) — goes into ``eval_history``. An iteration counts as improved
    when it beats the best by more than ``early_stopping_tolerance``; after
    ``early_stopping_rounds`` evaluations without one, training stops and
    the booster is cut to ``best_iteration + 1`` iterations.
    ``provide_training_metric`` records ``training_<metric>`` on the
    training rows. The JAX package runs a plain early-stopped fit as one
    fused device loop; this host loop grows the same trees.

    ``categorical_features`` (feature indexes; the binner's, when
    ``dataset`` is given) split by LightGBM's sorted-subset search. ``X``
    and the validation rows may be scipy sparse matrices.
    """
    cfg = resolve_growth_backend(cfg or GrowConfig())
    if early_stopping_tolerance < 0:
        raise ValueError(f"improvementTolerance must be >= 0, got "
                         f"{early_stopping_tolerance}")
    requested, auc_host = _metric_override(objective, eval_metric_name)
    eval_override = None if auc_host else requested
    objective_kwargs = objective_kwargs or {}
    obj = get_objective(objective, num_class, **objective_kwargs)
    K = obj.num_scores
    if dataset is None:
        if X is None or y is None:
            raise ValueError("either X and y arrays or dataset= must be given")
        dataset = LightGBMDataset.construct(
            X, y, weight, max_bin=max_bin, bin_sample_count=bin_sample_count,
            seed=seed, bin_dtype=bin_dtype,
            max_bin_by_feature=max_bin_by_feature, row_valid=row_valid,
            categorical_features=categorical_features, device=device)
    elif y is not None or weight is not None or row_valid is not None:
        raise ValueError("y/weight/row_valid are baked into the dataset at "
                         "construct() time; do not pass them alongside "
                         "dataset=")
    dev = dataset.device
    max_bin = dataset.max_bin
    cfg = cfg._replace(num_bins=max_bin)
    F = dataset.num_features
    Xbt, y_d, w_d, vmask = dataset.Xbt, dataset.y, dataset.w, dataset.vmask
    # categorical routing mask, None without categorical features
    is_cat_np = dataset.binner.is_cat_mask()
    is_cat = torch.from_numpy(is_cat_np).to(dev) if is_cat_np.any() else None

    base_d = (obj.init_score(y_d, w_d * vmask).reshape(1).expand(K)
              if boost_from_average else torch.zeros(K, device=dev))
    base_d = base_d.to(torch.float32).contiguous()
    scores = base_d.repeat(dataset.n_pad, 1)                 # [n_pad, K]

    depth_cap = (cfg.max_depth if cfg.max_depth > 0
                 else max(1, cfg.num_leaves - 1))
    depth_cap = min(depth_cap, 2 * cfg.num_leaves)
    device_metric = eval_metric(
        obj, torch.zeros((1, K)) if K > 1 else torch.zeros(1),
        torch.zeros(1), torch.ones(1), metric=eval_override,
        **objective_kwargs)[0]
    metric_name = "auc" if auc_host else device_metric

    if valid_set is not None:
        Xv, yv, wv = valid_set
        yv = np.asarray(yv, np.float32)
        wv = np.ones_like(yv) if wv is None else np.asarray(wv, np.float32)
        Xvb = bin_cols(torch.from_numpy(np.asarray(_densify(Xv),
                                                   np.float32)).to(dev),
                       torch.from_numpy(dataset.binner.upper_bounds),
                       Xbt.dtype).t().contiguous()           # [nv, F]
        yv_d, wv_d = torch.from_numpy(yv).to(dev), torch.from_numpy(wv).to(dev)
        vscores = base_d.repeat(len(yv), 1)                  # [nv, K]

    def column(sc):
        return sc if K > 1 else sc[:, 0]

    history: Dict[str, List[float]] = {metric_name: []}
    higher_is_better = metric_name in HIGHER_IS_BETTER
    best_metric = -np.inf if higher_is_better else np.inf
    best_iter, rounds_no_improve = -1, 0
    es_tol = float(early_stopping_tolerance)

    grow = (grow_tree_depthwise if cfg.growth_policy == "depthwise"
            else grow_tree)
    fp_cfg = cfg._replace(quantized_grad=False)
    gen = torch.Generator().manual_seed(int(seed))
    all_trees: List[Tree] = []
    for it in range(num_iterations):
        grad, hess = obj.grad_hess(column(scores), y_d, w_d)
        if K == 1:
            grad, hess = grad[:, None], hess[:, None]
        fmask = torch.ones(F, dtype=torch.bool)
        if feature_fraction < 1.0:
            u = torch.rand(F, generator=gen)
            fmask = u < feature_fraction
            fmask[torch.argmin(u)] = True      # guarantee >= 1 feature
        fmask = fmask.to(dev)
        quantized = cfg.quantized_grad and it >= cfg.quant_warmup_iters
        trees = []
        for k in range(K):
            g_k, h_k = grad[:, k].contiguous(), hess[:, k].contiguous()
            if quantized:
                tree, row_node = grow(Xbt, g_k, h_k, vmask, fmask, cfg,
                                      is_cat, qkey=quant_key(seed, it, k))
            else:
                tree, row_node = grow(Xbt, g_k, h_k, vmask, fmask, fp_cfg,
                                      is_cat)
            scores[:, k] += tree.leaf_value[row_node.long()]
            trees.append(tree)
        all_trees.extend(trees)

        evaluate = it % metric_eval_period == 0 or it == num_iterations - 1
        if provide_training_metric and evaluate:
            history.setdefault(f"training_{device_metric}", []).append(float(
                eval_metric(obj, column(scores), y_d, w_d * vmask,
                            metric=eval_override, **objective_kwargs)[1]))
        if valid_set is None:
            continue
        for k, tree in enumerate(trees):
            vscores[:, k] += predict_tree_binned(tree, Xvb, depth_cap,
                                                 is_cat)
        if not evaluate:
            continue
        if auc_host:
            m = auc_weighted(vscores[:, 0].cpu().numpy(), yv, wv)
        else:
            m = float(eval_metric(obj, column(vscores), yv_d, wv_d,
                                  metric=eval_override,
                                  **objective_kwargs)[1])
        history[metric_name].append(m)
        improved = (m > best_metric + es_tol if higher_is_better
                    else m < best_metric - es_tol)
        if improved:
            best_metric, best_iter, rounds_no_improve = m, it, 0
        else:
            rounds_no_improve += 1
        if 0 < early_stopping_rounds <= rounds_no_improve:
            break

    booster = _finalize_trees(all_trees, dataset.binner, max_bin, K,
                              base_d.cpu().numpy(), objective, depth_cap,
                              objective_kwargs, best_iter, history)
    if early_stopping_rounds > 0 and best_iter >= 0:
        booster = _truncate_booster(booster, best_iter + 1)
    return booster
