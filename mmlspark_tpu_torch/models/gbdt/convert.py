"""Carry a booster trained by the JAX package over to the port.

The JAX package's ``Booster`` holds its forest as numpy arrays (a ``Tree``
of ``[T, M]`` fields, raw thresholds, base score, objective). This module
takes those arrays — as plain numpy, so nothing of the JAX package is
imported — and builds the port's :class:`~.booster.Booster`, which then
predicts the same margins on any device.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .booster import TREE_DTYPES, Booster
from .growth import Tree

_REQUIRED = ("feat", "thr_bin", "left", "right", "is_leaf", "leaf_value")


def booster_from_jax_arrays(tree_fields: Mapping[str, np.ndarray],
                            thr_raw: np.ndarray, num_class: int, base_score,
                            objective: str, *,
                            depth_cap: Optional[int] = None,
                            binner_state: Optional[dict] = None,
                            objective_kwargs: Optional[dict] = None,
                            missing_dec: Optional[np.ndarray] = None
                            ) -> Booster:
    """The port's Booster for a JAX booster's arrays.

    ``tree_fields``: the JAX ``Tree``'s fields as numpy (``feat``,
    ``thr_bin``, ``left``, ``right``, ``is_leaf`` and ``leaf_value`` are
    required; the bookkeeping fields default to zeros, ``cat_bitset`` to
    no categorical split). ``depth_cap`` defaults to ``num_leaves - 1``
    (``(M - 1) // 2``), which bounds the depth of any tree in ``M`` slots
    grown leafwise. ``num_class`` and ``objective_kwargs`` carry multiclass
    boosters (tree ``t`` scores class ``t % num_class``) and rankers
    (``group_size``, ``label_gain``, ...; a ranker without them scores
    only). Categorical bitsets route the features that
    ``binner_state["categorical_features"]`` names, so bitsets without
    such a feature are refused; ``missing_dec`` ([T, M] decision_type
    bytes) carries the missing-value routing of an imported model.
    """
    feat = np.asarray(tree_fields["feat"])
    if feat.ndim != 2:
        raise ValueError(f"tree fields must be stacked [T, M], got feat "
                         f"{feat.shape}")
    trees = {}
    for name in Tree._fields:
        if name in tree_fields:
            trees[name] = np.asarray(tree_fields[name]).astype(
                TREE_DTYPES[name])
        elif name in _REQUIRED:
            raise ValueError(f"tree_fields lacks the required field {name!r}")
        elif name == "node_count":
            trees[name] = np.zeros(feat.shape[0], np.int32)
        elif name != "cat_bitset":
            trees[name] = np.zeros(feat.shape, TREE_DTYPES[name])
    cat = trees.get("cat_bitset")
    if cat is not None:
        if cat.shape[:2] != feat.shape:
            raise ValueError(f"cat_bitset {cat.shape} does not match the "
                             f"trees {feat.shape}")
        cats = (binner_state or {}).get("categorical_features") or ()
        if np.any(cat) and not cats:
            raise ValueError(
                "cat_bitset holds categorical splits but binner_state names "
                "no categorical_features to route them by")
    thr_raw = np.asarray(thr_raw, np.float32)
    if thr_raw.shape != feat.shape:
        raise ValueError(f"thr_raw {thr_raw.shape} does not match the trees "
                         f"{feat.shape}")
    if missing_dec is not None and np.shape(missing_dec) != feat.shape:
        raise ValueError(f"missing_dec {np.shape(missing_dec)} does not match "
                         f"the trees {feat.shape}")
    if depth_cap is None:
        depth_cap = max(1, (feat.shape[1] - 1) // 2)
    return Booster(trees, thr_raw, num_class, base_score, objective,
                   depth_cap, binner_state,
                   objective_kwargs=objective_kwargs, missing_dec=missing_dec)


class JaxPickledBooster(Booster):
    """Reads a Booster pickled by the JAX package (its ``__dict__``: a
    ``Tree`` of ``[T, M]`` arrays, raw thresholds, base score, objective,
    binner state, history) and becomes the port's :class:`Booster` of those
    arrays. ``core/pipeline.load_pickle`` routes the JAX class here."""

    def __setstate__(self, state):
        trees = state["trees"]
        trees = (trees._asdict() if hasattr(trees, "_asdict")
                 else dict(trees))
        b = Booster({k: np.asarray(v) for k, v in trees.items()},
                    state["thr_raw"], state["num_class"],
                    state["base_score"], state["objective"],
                    state["depth_cap"], state.get("binner_state"),
                    best_iteration=state.get("best_iteration", -1),
                    eval_history=state.get("eval_history"),
                    objective_kwargs=state.get("objective_kwargs"))
        self.__class__ = Booster
        self.__dict__.update(b.__dict__)
