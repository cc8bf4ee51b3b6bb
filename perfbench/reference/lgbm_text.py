"""LightGBM ``tree`` v3 text, parsed into plain arrays.

Node numbering is LightGBM's: internal nodes ``0..num_leaves-2`` with the
root at 0, and a child pointer ``c < 0`` naming leaf ``-c - 1``. A
numerical split sends ``x <= threshold`` left."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class TextTree:
    num_leaves: int
    split_feature: np.ndarray    # [L-1] int64
    threshold: np.ndarray        # [L-1] float32
    decision_type: np.ndarray    # [L-1] int64
    left_child: np.ndarray       # [L-1] int64
    right_child: np.ndarray      # [L-1] int64
    split_gain: np.ndarray       # [L-1] float64
    internal_count: np.ndarray   # [L-1] int64
    leaf_value: np.ndarray       # [L] float64
    leaf_count: np.ndarray       # [L] int64


@dataclass
class TextModel:
    num_class: int
    objective: str
    max_feature_idx: int
    trees: List[TextTree]


def _fields(block: str) -> dict:
    out = {}
    for line in block.strip().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip().split()
    return out


def parse(text: str) -> TextModel:
    if not text.lstrip().startswith("tree"):
        raise ValueError("not a LightGBM text model")
    body = text.split("end of trees")[0]
    parts = body.split("Tree=")
    head = _fields(parts[0])
    trees = []
    for blk in parts[1:]:
        f = _fields("index=" + blk)
        nl = int(f["num_leaves"][0])
        if int(f.get("num_cat", ["0"])[0]) != 0:
            raise ValueError("categorical splits are not part of the "
                             "benchmark's reference")

        def ints(key, size):
            return np.asarray([int(float(x)) for x in f.get(key, [])][:size],
                              np.int64)

        def floats(key, dtype=np.float64):
            return np.asarray([float(x) for x in f.get(key, [])], dtype)

        trees.append(TextTree(
            num_leaves=nl,
            split_feature=ints("split_feature", nl - 1),
            threshold=floats("threshold", np.float32),
            decision_type=ints("decision_type", nl - 1),
            left_child=ints("left_child", nl - 1),
            right_child=ints("right_child", nl - 1),
            split_gain=floats("split_gain"),
            internal_count=ints("internal_count", nl - 1),
            leaf_value=floats("leaf_value"),
            leaf_count=ints("leaf_count", nl)))
    return TextModel(num_class=int(head.get("num_class", ["1"])[0]),
                     objective=" ".join(head.get("objective", ["?"])),
                     max_feature_idx=int(head["max_feature_idx"][0]),
                     trees=trees)


def child_counts(tree: TextTree) -> np.ndarray:
    """``[L-1, 2]`` rows of each internal node's left and right child."""
    out = np.zeros((tree.num_leaves - 1, 2), np.int64)
    for i in range(tree.num_leaves - 1):
        for j, c in enumerate((tree.left_child[i], tree.right_child[i])):
            out[i, j] = (tree.internal_count[c] if c >= 0
                         else tree.leaf_count[-c - 1])
    return out
