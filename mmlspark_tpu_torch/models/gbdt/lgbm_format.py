"""LightGBM text model format: emit + parse for native-model interop.

The reference round-trips real LightGBM model strings through
``saveNativeModel``/``getNativeModel`` (reference:
lightgbm/LightGBMClassifier.scala:172-194, TrainUtils.scala:176-180
``LGBM_BoosterSaveModelToStringSWIG``, LightGBMBooster.scala:289) so saved
models interop with every LightGBM tool. This module implements that
contract for the port's booster: ``to_lightgbm_string`` emits the ``tree``
v3 text format stock LightGBM loads, and ``parse_lightgbm_string`` loads
model strings produced by stock LightGBM (or by us).

A host-only copy of ``mmlspark_tpu/models/gbdt/lgbm_format.py`` (numpy
only), bound to the port's ``Tree`` and its ``Booster``'s dict of stacked
tree arrays. It writes the same text, character for character, for the
same trees.

Format notes (LightGBM C++ ``GBDT::SaveModelToString`` / ``Tree::ToString``):

* node numbering: internal nodes are ``0..num_leaves-2``; child pointers
  ``< 0`` encode leaves as ``-(leaf_index)-1``;
* ``decision_type`` bit 0 = categorical split, bit 1 = default-left for
  missing, bits 2-3 = missing type (0 none, 1 zero, 2 NaN);
* numerical decision is ``x <= threshold -> left`` (same as this repo);
* ``boost_from_average``'s init score is folded into the FIRST iteration's
  tree leaf values — the file carries no separate base score;
* multiclass interleaves ``num_tree_per_iteration`` trees per iteration
  (same it-major/class-minor order as the Booster's tree stack).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .growth import Tree

_KNOWN_MISSING_NAN = 2


def _objective_line(objective: str, num_class: int, kwargs: Dict) -> str:
    if objective == "binary":
        return "binary sigmoid:1"
    if objective == "multiclass":
        return f"multiclass num_class:{num_class}"
    if objective == "lambdarank":
        return "lambdarank"
    if objective == "quantile":
        return f"quantile alpha:{kwargs.get('alpha', 0.5)}"
    if objective == "huber":
        return f"huber alpha:{kwargs.get('alpha', 0.9)}"
    if objective == "tweedie":
        rho = kwargs.get("tweedie_variance_power", 1.5)
        return f"tweedie tweedie_variance_power:{rho}"
    if objective == "poisson":
        return "poisson"
    if objective in ("l1", "regression_l1", "mae"):
        return "regression_l1"
    return "regression"


def _parse_objective_line(line: str):
    parts = line.split()
    head = parts[0] if parts else "regression"
    kwargs: Dict = {}
    num_class = 1
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "num_class":
                num_class = int(v)
            elif k == "alpha":
                kwargs["alpha"] = float(v)
            elif k == "tweedie_variance_power":
                kwargs["tweedie_variance_power"] = float(v)
    if head in ("multiclassova", "ova", "ovr"):
        raise NotImplementedError(
            "one-vs-all multiclass models (multiclassova) are not supported: "
            "this booster applies softmax across classes, which would "
            "silently change the model's probabilities")
    if head == "binary":
        for tok in parts[1:]:
            if tok.startswith("sigmoid:") and float(tok.split(":")[1]) != 1.0:
                raise NotImplementedError(
                    f"binary models with sigmoid scale {tok.split(':')[1]} "
                    "!= 1 are not supported")
    name_map = {"binary": "binary", "multiclass": "multiclass",
                "lambdarank": "lambdarank", "rank_xendcg": "lambdarank",
                "regression_l1": "l1", "regression_l2": "regression",
                "regression": "regression", "quantile": "quantile",
                "huber": "huber", "poisson": "poisson", "tweedie": "tweedie",
                "mape": "regression", "fair": "regression"}
    return name_map.get(head, "regression"), num_class, kwargs


def _fmt(x: float) -> str:
    """LightGBM writes full-precision floats; repr round-trips doubles."""
    return repr(float(x))


def _tree_to_string(tree: Tree, thr_raw: np.ndarray, idx: int,
                    add_bias: float, shrinkage: float,
                    catchall_bin: int = -1,
                    missing_dec: Optional[np.ndarray] = None) -> str:
    """One ``Tree=i`` block from the fixed-shape slot arrays.

    Categorical splits emit LightGBM's bitset encoding: decision_type bit 0
    set, ``threshold`` holding the split's index into ``cat_boundaries``,
    and ``cat_threshold`` carrying the uint32 membership words
    (Tree::ToString / FindInBitset semantics: member -> left).

    Caveat: ids >= maxBin-1 share the binner's catch-all bin during
    training; in the exported format that bin's bit reads as exactly the
    single category maxBin-1, so exports are bit-exact only when every
    category id is < maxBin-1 (keep maxBin above the categorical
    cardinality — a warning fires otherwise)."""
    n_nodes = int(tree.node_count)
    is_leaf = np.asarray(tree.is_leaf)[:n_nodes]
    internal_slots = [s for s in range(n_nodes) if not is_leaf[s]]
    leaf_slots = [s for s in range(n_nodes) if is_leaf[s]]
    # a 1-slot tree is a single leaf; >1 slots have root at slot 0 internal
    num_leaves = max(len(leaf_slots), 1)
    int_index = {s: i for i, s in enumerate(internal_slots)}
    leaf_index = {s: i for i, s in enumerate(leaf_slots)}

    def child_ref(slot: int) -> int:
        return (int_index[slot] if slot in int_index
                else -leaf_index[slot] - 1)

    bits = np.asarray(tree.cat_bitset, np.uint32)
    cat_slots = [s for s in internal_slots if bits[s].any()]
    lines = [f"Tree={idx}", f"num_leaves={num_leaves}",
             f"num_cat={len(cat_slots)}"]
    lv = np.asarray(tree.leaf_value, np.float64)
    nv = np.asarray(tree.node_value, np.float64)
    nh = np.asarray(tree.node_hess, np.float64)
    nc = np.asarray(tree.node_cnt, np.float64)
    gain = np.asarray(tree.split_gain, np.float64)
    if internal_slots:
        feats = [int(np.asarray(tree.feat)[s]) for s in internal_slots]
        # decision_type: numerical splits are default-left w/ missing=NaN
        # (our binning sends NaN to bin 0, i.e. left); categorical splits
        # set bit 0 and route by bitset membership. Imported models carry
        # their original per-node bytes (missing_dec) — re-emission must
        # preserve their missing-value routing, not overwrite it.
        dt_num = 2 | (_KNOWN_MISSING_NAN << 2)
        dts, thrs = [], []
        cat_boundaries = [0]
        cat_words: List[int] = []
        cat_set = set(cat_slots)
        for s_ in internal_slots:
            if s_ in cat_set:
                dts.append(1)
                thrs.append(str(len(cat_boundaries) - 1))   # cat_idx
                words = [int(w) for w in bits[s_]]
                if (catchall_bin >= 0
                        and (words[catchall_bin >> 5]
                             >> (catchall_bin & 31)) & 1):
                    import warnings
                    warnings.warn(
                        "categorical split includes the catch-all bin "
                        f"({catchall_bin}): ids >= maxBin-1 shared that bin "
                        "in training, but stock LightGBM will read it as "
                        "the single category id; re-train with maxBin above "
                        "the categorical cardinality for a bit-exact export")
                # trim trailing zero words (LightGBM stores minimal width)
                while len(words) > 1 and words[-1] == 0:
                    words.pop()
                cat_words.extend(words)
                cat_boundaries.append(len(cat_words))
            else:
                dts.append(dt_num if missing_dec is None
                           else int(missing_dec[s_]))
                thrs.append(_fmt(thr_raw[s_]))
        lines += [
            "split_feature=" + " ".join(str(f) for f in feats),
            "split_gain=" + " ".join(_fmt(gain[s]) for s in internal_slots),
            "threshold=" + " ".join(thrs),
            "decision_type=" + " ".join(str(d) for d in dts),
            "left_child=" + " ".join(
                str(child_ref(int(np.asarray(tree.left)[s])))
                for s in internal_slots),
            "right_child=" + " ".join(
                str(child_ref(int(np.asarray(tree.right)[s])))
                for s in internal_slots),
        ]
        if cat_slots:
            lines += [
                "cat_boundaries=" + " ".join(str(b) for b in cat_boundaries),
                "cat_threshold=" + " ".join(str(w) for w in cat_words),
            ]
    lines += [
        "leaf_value=" + " ".join(_fmt(lv[s] + add_bias) for s in leaf_slots),
        "leaf_weight=" + " ".join(_fmt(nh[s]) for s in leaf_slots),
        "leaf_count=" + " ".join(str(int(nc[s])) for s in leaf_slots),
    ]
    if internal_slots:
        lines += [
            "internal_value=" + " ".join(
                _fmt(nv[s] + add_bias) for s in internal_slots),
            "internal_weight=" + " ".join(
                _fmt(nh[s]) for s in internal_slots),
            "internal_count=" + " ".join(
                str(int(nc[s])) for s in internal_slots),
        ]
    lines.append(f"shrinkage={_fmt(shrinkage)}")
    return "\n".join(lines)


def to_lightgbm_string(booster) -> str:
    """Emit the booster as a stock-LightGBM ``tree`` v3 model string."""
    trees = booster.trees
    T = booster.num_trees
    K = booster.num_class
    F = int(booster.binner_state["upper_bounds"].shape[0])
    ub = np.asarray(booster.binner_state["upper_bounds"], np.float64)
    # slotNames flow through as the emitted feature names (reference:
    # LightGBMParams slotNames); default to LightGBM's Column_<i>
    fnames = booster.binner_state.get("feature_names") or [
        f"Column_{i}" for i in range(F)]

    header = [
        "tree",
        "version=v3",
        f"num_class={K}",
        f"num_tree_per_iteration={K}",
        "label_index=0",
        f"max_feature_idx={F - 1}",
        "objective=" + _objective_line(booster.objective, K,
                                       booster.objective_kwargs),
        "feature_names=" + " ".join(fnames),
        # bin upper bounds give a usable [min:max] range per feature
        "feature_infos=" + " ".join(
            f"[{_fmt(ub[i, 0])}:{_fmt(ub[i, -2] if ub.shape[1] > 1 else ub[i, 0])}]"
            for i in range(F)),
    ]
    blocks = []
    for t in range(T):
        tree = Tree(**{f: np.asarray(trees[f])[t] for f in Tree._fields})
        # base score folds into the first iteration's trees (LightGBM rule)
        bias = float(booster.base_score[t % K]) if t < K else 0.0
        mb = booster.binner_state.get("max_bin") or 0
        mdec = (None if getattr(booster, "missing_dec", None) is None
                else np.asarray(booster.missing_dec[t]))
        blocks.append(_tree_to_string(tree, np.asarray(booster.thr_raw[t]),
                                      t, bias, 1.0,
                                      catchall_bin=mb - 1 if mb else -1,
                                      missing_dec=mdec))
    importances = booster.feature_importances("split")
    imp_lines = [f"{fnames[i]}={int(importances[i])}"
                 for i in np.argsort(-importances) if importances[i] > 0]
    return ("\n".join(header) + "\n\n"
            + "\n\n\n".join(blocks) + "\n\n\n"
            + "end of trees\n\n"
            + "feature_importances:\n" + "\n".join(imp_lines) + "\n\n"
            + "parameters:\n"
            + f"[objective: {_objective_line(booster.objective, K, booster.objective_kwargs).split()[0]}]\n"
            + "end of parameters\n\n"
            + "pandas_categorical:null\n")


def _parse_block(block: str) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for line in block.strip().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip().split()
    return out


def parse_lightgbm_string(s: str):
    """Parse a LightGBM text model into Booster constructor pieces.

    Returns (trees: Tree of numpy arrays stacked [T, M] (``cat_bitset``
    uint32 [T, M, BW]), thr_raw [T, M], num_class,
    objective, objective_kwargs, num_features, categorical_features,
    missing_dec). ``missing_dec`` is a [T, M] uint8 of per-node
    decision_type bytes when any split stores missing handling other than
    the framework's default-left/NaN encoding, else None (fast path).
    The parsed model predicts with base_score = 0: LightGBM folds any init
    score into tree leaves. Categorical splits (decision_type bit 0) load
    their cat_threshold bitsets; the features they split on are returned so
    the Booster routes them by category-id membership.
    """
    if not s.lstrip().startswith("tree"):
        raise ValueError("not a LightGBM text model (must start with 'tree')")
    body = s.split("end of trees")[0]
    parts = body.split("Tree=")
    header = _parse_block(parts[0])
    num_class = int(header.get("num_class", ["1"])[0])
    obj_line = " ".join(header.get("objective", ["regression"]))
    objective, num_class_obj, obj_kwargs = _parse_objective_line(obj_line)
    num_class = max(num_class, num_class_obj)
    F = int(header.get("max_feature_idx", ["0"])[0]) + 1

    tree_blocks = parts[1:]
    max_leaves = 1
    max_cat_words = 1
    for blk in tree_blocks:
        fields = _parse_block("x=" + blk)  # keep first line (index) harmless
        max_leaves = max(max_leaves, int(fields["num_leaves"][0]))
        bounds = [int(x) for x in fields.get("cat_boundaries", [])]
        for a, b in zip(bounds, bounds[1:]):
            max_cat_words = max(max_cat_words, b - a)
    M = 2 * max_leaves - 1
    BW = max_cat_words
    cat_features: set = set()

    def zeros_i():
        return np.zeros(M, np.int32)

    def zeros_f():
        return np.zeros(M, np.float32)

    stacked = {k: [] for k in Tree._fields}
    thr_all = []
    mdec_all = []
    # the framework's own emit: default-left + NaN missing (see _tree_lines
    # dt_num) — the fast `~(x > thr)` predictor implements exactly this
    _DT_NATIVE = 2 | (_KNOWN_MISSING_NAN << 2)
    exotic_missing = False
    for blk in tree_blocks:
        fields = _parse_block("idx=" + blk)
        nl = int(fields["num_leaves"][0])
        n_int = nl - 1
        feat, thr, left, right = zeros_i(), zeros_f(), zeros_i(), zeros_i()
        is_leaf = np.ones(M, bool)
        leaf_value, node_value = zeros_f(), zeros_f()
        node_hess, node_cnt, gain = zeros_f(), zeros_f(), zeros_f()
        mdec = np.full(M, _DT_NATIVE, np.uint8)
        cat_bits = np.zeros((M, BW), np.uint32)
        cat_boundaries = [int(x) for x in fields.get("cat_boundaries", [])]
        cat_words = [int(x) for x in fields.get("cat_threshold", [])]

        def slot(ref: int) -> int:
            # internal i -> slot i; leaf j -> slot n_int + j
            return ref if ref >= 0 else n_int - ref - 1

        lv = [float(x) for x in fields["leaf_value"]]
        lw = [float(x) for x in fields.get("leaf_weight", ["0"] * nl)]
        lc = [float(x) for x in fields.get("leaf_count", ["0"] * nl)]
        for j in range(nl):
            sj = n_int + j
            leaf_value[sj] = lv[j]
            node_value[sj] = lv[j]
            node_hess[sj] = lw[j] if j < len(lw) else 0.0
            node_cnt[sj] = lc[j] if j < len(lc) else 0.0
        if n_int > 0:
            sf = [int(x) for x in fields["split_feature"]]
            th = [float(x) for x in fields["threshold"]]
            dts = [int(float(x)) for x in fields["decision_type"]]
            lch = [int(x) for x in fields["left_child"]]
            rch = [int(x) for x in fields["right_child"]]
            iv = [float(x) for x in fields.get("internal_value",
                                               ["0"] * n_int)]
            iw = [float(x) for x in fields.get("internal_weight",
                                               ["0"] * n_int)]
            ic = [float(x) for x in fields.get("internal_count",
                                               ["0"] * n_int)]
            sg = [float(x) for x in fields.get("split_gain", ["0"] * n_int)]
            for i in range(n_int):
                if dts[i] & 1:
                    # categorical split: threshold holds the cat_idx into
                    # cat_boundaries; membership words -> our bitset rows
                    cat_idx = int(float(fields["threshold"][i]))
                    w0, w1 = cat_boundaries[cat_idx], cat_boundaries[cat_idx + 1]
                    words = cat_words[w0:w1][:BW]
                    cat_bits[i, :len(words)] = np.asarray(words, np.uint32)
                    is_leaf[i] = False
                    feat[i] = sf[i]
                    thr[i] = np.inf       # unused: routing is by bitset
                    left[i] = slot(lch[i])
                    right[i] = slot(rch[i])
                    node_value[i] = iv[i] if i < len(iv) else 0.0
                    node_hess[i] = iw[i] if i < len(iw) else 0.0
                    node_cnt[i] = ic[i] if i < len(ic) else 0.0
                    gain[i] = sg[i] if i < len(sg) else 0.0
                    cat_features.add(sf[i])
                    continue
                # Stock missing-value routing (NumericalDecision, lightgbm
                # tree.h): recorded per node; anything other than the
                # framework's own default-left/NaN-missing encoding flips
                # the predictor onto the decision_type-aware path.
                mdec[i] = dts[i] & 0xFF
                if (dts[i] & 0x0E) != _DT_NATIVE:
                    exotic_missing = True
                is_leaf[i] = False
                feat[i] = sf[i]
                thr[i] = th[i]
                left[i] = slot(lch[i])
                right[i] = slot(rch[i])
                node_value[i] = iv[i] if i < len(iv) else 0.0
                node_hess[i] = iw[i] if i < len(iw) else 0.0
                node_cnt[i] = ic[i] if i < len(ic) else 0.0
                gain[i] = sg[i] if i < len(sg) else 0.0
        stacked["feat"].append(feat)
        stacked["thr_bin"].append(zeros_i())
        stacked["left"].append(left)
        stacked["right"].append(right)
        stacked["is_leaf"].append(is_leaf)
        stacked["leaf_value"].append(leaf_value)
        stacked["node_count"].append(np.int32(2 * nl - 1))
        stacked["node_grad"].append(zeros_f())
        stacked["node_hess"].append(node_hess)
        stacked["node_cnt"].append(node_cnt)
        stacked["split_gain"].append(gain)
        stacked["node_value"].append(node_value)
        stacked["cat_bitset"].append(cat_bits)
        thr_leaf = np.where(is_leaf, np.float32(np.inf), thr)
        thr_all.append(thr_leaf.astype(np.float32))
        mdec_all.append(mdec)

    trees = Tree(**{k: np.stack(v) for k, v in stacked.items()})
    thr_raw = np.stack(thr_all)
    missing_dec = np.stack(mdec_all) if exotic_missing else None
    return (trees, thr_raw, num_class, objective, obj_kwargs, F,
            sorted(cat_features), missing_dec)
