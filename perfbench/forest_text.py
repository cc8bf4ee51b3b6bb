"""A forest drawn from a seed, written as LightGBM ``tree`` v3 text: the
model a user brings to batch scoring.

Each tree is grown leafwise on a sample of the rows: the leaf to split is
drawn in proportion to its rows, the feature uniformly, and the threshold
at a quantile between 5% and 95% of that leaf's values, so the trees are
as deep and as lopsided as fitted ones. Leaf values are normal, scaled so
that the summed margins spread over a few units."""

from __future__ import annotations

import numpy as np

from perfbench.seeds import numpy_stream

MIN_SPLIT_ROWS = 40


def _tree(X: np.ndarray, leaves: int, leaf_scale: float,
          rng: np.random.Generator) -> dict:
    F = X.shape[1]
    rows = [np.arange(X.shape[0])]
    parent = [None]                 # (internal node, side) of each leaf
    feat, thr, kids = [], [], []
    while len(rows) < leaves:
        sizes = np.array([r.size for r in rows], np.float64)
        sizes[sizes < MIN_SPLIT_ROWS] = 0.0
        if not sizes.any():
            break
        j = int(rng.choice(len(rows), p=sizes / sizes.sum()))
        f = int(rng.integers(F))
        vals = X[rows[j], f]
        t = np.float32(np.quantile(vals, rng.uniform(0.05, 0.95)))
        go = vals <= t
        if go.all() or not go.any():
            continue
        s = len(feat)
        feat.append(f)
        thr.append(t)
        kids.append([-j - 1, -len(rows) - 1])
        if parent[j] is not None:
            p, side = parent[j]
            kids[p][side] = s
        rows.append(rows[j][~go])
        rows[j] = rows[j][go]
        parent[j] = (s, 0)
        parent.append((s, 1))
    return dict(feat=feat, thr=thr, kids=kids,
                value=rng.normal(0.0, leaf_scale, len(rows)),
                count=[r.size for r in rows])


def _internal_counts(kids, count) -> list:
    out = [0] * len(kids)

    def rows_of(c):
        return count[-c - 1] if c < 0 else out[c]

    for s in reversed(range(len(kids))):     # children come after parents
        out[s] = rows_of(kids[s][0]) + rows_of(kids[s][1])
    return out


def forest_text(X: np.ndarray, trees: int, leaves: int, seed: int,
                leaf_scale: float = 0.1) -> str:
    """A binary model of ``trees`` trees of at most ``leaves`` leaves over
    the features of ``X`` (the sample its thresholds come from)."""
    rng = numpy_stream(seed, 77)
    F = X.shape[1]
    blocks = []
    for i in range(trees):
        t = _tree(X, leaves, leaf_scale, rng)
        n_int = len(t["feat"])
        fmt = " ".join
        lines = [f"Tree={i}", f"num_leaves={n_int + 1}", "num_cat=0"]
        if n_int:
            lines += [
                "split_feature=" + fmt(str(f) for f in t["feat"]),
                "split_gain=" + fmt("1" for _ in t["feat"]),
                "threshold=" + fmt(repr(float(v)) for v in t["thr"]),
                "decision_type=" + fmt("10" for _ in t["feat"]),
                "left_child=" + fmt(str(k[0]) for k in t["kids"]),
                "right_child=" + fmt(str(k[1]) for k in t["kids"])]
        lines += [
            "leaf_value=" + fmt(repr(float(v)) for v in t["value"]),
            "leaf_weight=" + fmt(str(c) for c in t["count"]),
            "leaf_count=" + fmt(str(c) for c in t["count"])]
        if n_int:
            ic = _internal_counts(t["kids"], t["count"])
            lines += ["internal_value=" + fmt("0" for _ in ic),
                      "internal_weight=" + fmt(str(c) for c in ic),
                      "internal_count=" + fmt(str(c) for c in ic)]
        lines.append("shrinkage=1")
        blocks.append("\n".join(lines))
    header = ["tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
              "label_index=0", f"max_feature_idx={F - 1}",
              "objective=binary sigmoid:1",
              "feature_names=" + " ".join(f"Column_{i}" for i in range(F)),
              "feature_infos=" + " ".join("none" for _ in range(F))]
    return ("\n".join(header) + "\n\n" + "\n\n\n".join(blocks)
            + "\n\n\nend of trees\n")
