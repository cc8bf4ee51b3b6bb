"""A forest's margins by plain traversal, in float64 on the rows' device."""

from __future__ import annotations

import torch

from perfbench.reference.lgbm_text import TextModel, TextTree


def tree_leaves(tree: TextTree, X: torch.Tensor) -> torch.Tensor:
    """Leaf index of each row of ``X`` ([n, F] float32): a numerical split
    sends ``x <= threshold`` and NaN (decision type 10: missing is NaN,
    default left) to the left child."""
    n = X.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=X.device)
    if tree.num_leaves == 1:
        return node
    dev = X.device
    feat = torch.as_tensor(tree.split_feature, device=dev)
    thr = torch.as_tensor(tree.threshold, device=dev)
    left = torch.as_tensor(tree.left_child, device=dev)
    right = torch.as_tensor(tree.right_child, device=dev)
    for _ in range(tree.num_leaves - 1):
        live = node >= 0
        nd = node.clamp(min=0)
        x = X.gather(1, feat[nd][:, None])[:, 0]
        go_left = (x <= thr[nd]) | torch.isnan(x)
        node = torch.where(live, torch.where(go_left, left[nd], right[nd]),
                           node)
        if not bool((node >= 0).any()):
            break
    return -node - 1


def add_trees(model: TextModel, X: torch.Tensor, out: torch.Tensor,
              start: int, stop: int) -> torch.Tensor:
    """Add trees ``[start, stop)`` of ``model`` to the ``[n, K]`` float64
    margins ``out`` in place (tree ``t`` scores class ``t % K``)."""
    K = model.num_class
    for t in range(start, stop):
        tree = model.trees[t]
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float64,
                             device=X.device)
        out[:, t % K] += lv[tree_leaves(tree, X)]
    return out


def margins(model: TextModel, X: torch.Tensor) -> torch.Tensor:
    """``[n, K]`` float64 raw margins of every tree (LightGBM folds the base
    score into the first trees, so the sum is the whole margin)."""
    out = torch.zeros((X.shape[0], model.num_class), dtype=torch.float64,
                      device=X.device)
    return add_trees(model, X, out, 0, len(model.trees))
