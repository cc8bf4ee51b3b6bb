"""The bytes behind ``fit_mfu`` and ``hist_kernel_roofline``, on a small
hand-made LightGBM text."""

import pytest

from perfbench import frozen, peaks, work
from perfbench.reference import lgbm_text

# two trees over 3 features: a root of 100 rows split 30 / 70, its right
# child split 50 / 20; then a single leaf
TEXT = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=2
objective=binary sigmoid:1

Tree=0
num_leaves=3
num_cat=0
split_feature=0 2
split_gain=5.5 1.25
threshold=0.5 1.5
decision_type=10 10
left_child=-1 -2
right_child=1 -3
leaf_value=0.1 -0.2 0.3
leaf_weight=7 12 5
leaf_count=30 50 20
internal_value=0 0
internal_weight=24 17
internal_count=100 70
shrinkage=0.1


Tree=1
num_leaves=1
num_cat=0
leaf_value=0.05
leaf_count=100
shrinkage=0.1


end of trees
"""


def test_parse():
    m = lgbm_text.parse(TEXT)
    assert m.num_class == 1 and m.max_feature_idx == 2
    t = m.trees[0]
    assert list(t.split_feature) == [0, 2]
    assert list(t.left_child) == [-1, -2] and list(t.right_child) == [1, -3]
    assert lgbm_text.child_counts(t).tolist() == [[30, 70], [50, 20]]


def test_hist_logical_bytes():
    m = lgbm_text.parse(TEXT)
    F, B = 3, 255
    # rows: the root's 100, then the smaller children 30 and 20
    rows = 100 + 30 + 20
    nodes = 3            # the root and one child a split; tree 1 has none
    assert work.hist_rows(m) == rows
    assert work.hist_logical_bytes(m, F, B) == (
        rows * (F + work.STAT_BYTES) + nodes * F * 3 * B * 4)


def test_fit_min_bytes_and_share():
    nbytes = work.fit_min_bytes(rows=1000, features=28, trees=10)
    assert nbytes == 10 * 1000 * (28 + 12 + 8)
    # fit_mfu's arithmetic: bytes over the peak rate over the fit's seconds
    share = 100.0 * nbytes / peaks.HBM_BYTES_PER_S / 0.5
    assert share == pytest.approx(100 * 480_000 / 3.35e12 / 0.5)


def test_bound_ms_takes_the_larger():
    t, by = frozen.bound_ms(3_350_000, 0.0, peaks.F32_OPS_PER_S)
    assert by == "bytes" and t == pytest.approx(1e-3)
    t, by = frozen.bound_ms(0, 67e9, peaks.F32_OPS_PER_S)
    assert by == "operations" and t == pytest.approx(1.0)
