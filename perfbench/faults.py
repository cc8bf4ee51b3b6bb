"""Faults planted in the port underneath a run, to show that the check
catches each fault a cell can have: a step that returns its state
unchanged, half of the rows left out, a histogram channel read from the
wrong place, an answer altered where it is produced. One card runs every
cell, so no exchange between chips can be left out. Used by the tests
(``tests/test_perfbench_faults.py``) and by ``control.py --fault`` on the
card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def zero_trees():
    """Every tree adds nothing: the boosting step leaves the margins as
    they were."""
    from mmlspark_tpu_torch.models.gbdt import growth

    def make(real):
        def finish(*a, **k):
            t = real(*a, **k)
            return t._replace(leaf_value=torch.zeros_like(t.leaf_value))
        return finish
    return _patched(growth, "_finish_tree", make)


def half_batch():
    """Every histogram sums the first half of the rows, doubled, and leaves
    the rest out."""
    from mmlspark_tpu_torch.models.gbdt import growth

    def make(real):
        def hist(binned_t, row_pos, base_t, *a, **k):
            n = base_t.shape[1]
            base = base_t.clone()
            base[:, n // 2:] = 0
            base[:, :n // 2] *= 2
            return real(binned_t, row_pos, base, *a, **k)
        return hist
    return _patched(growth, "node_histogram", make)


def shifted_gradient():
    """Every histogram's gradient channel read from the neighbouring
    feature, as a kernel that indexes one channel wrongly would: the split
    search scores the wrong gradients, while the rows, the hessians and
    the leaf values stay right."""
    from mmlspark_tpu_torch.models.gbdt import growth

    def make(real):
        def hist(*a, **k):
            out = real(*a, **k).contiguous()          # [F, 3W, B]
            _, W3, B = out.shape[-3:]
            v = out.view(*out.shape[:-2], W3 // 3, 3, B)
            v[..., 0, :] = torch.roll(v[..., 0, :].clone(), 1, dims=-3)
            return out
        return hist
    return _patched(growth, "node_histogram", make)


def altered_leaf():
    """One leaf of every tree moved by 10% where the tree is finished."""
    from mmlspark_tpu_torch.models.gbdt import growth

    def make(real):
        def finish(*a, **k):
            t = real(*a, **k)
            lv = t.leaf_value.clone()
            idx = torch.nonzero(lv).flatten()[:1]
            lv[idx] = lv[idx] * 1.1
            return t._replace(leaf_value=lv)
        return finish
    return _patched(growth, "_finish_tree", make)


def altered_margin():
    """Every margin the booster scores moved by 1e-3."""
    from mmlspark_tpu_torch.models.gbdt import booster

    def make(real):
        def predict_raw(self, *a, **k):
            return real(self, *a, **k) + 1e-3
        return predict_raw
    return _patched(booster.Booster, "predict_raw", make)


FAULTS = {f.__name__: f for f in (zero_trees, half_batch, shifted_gradient,
                                  altered_leaf, altered_margin)}
