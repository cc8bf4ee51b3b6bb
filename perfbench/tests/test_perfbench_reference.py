"""The plain reference against the port, at a tiny size on the CPU."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import forest, gbdt, lgbm_text

def test_fit_cell_agrees(tiny_run):
    r = tiny_run("higgs-qgrad-fit")
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], r["checks"]
    assert c["bins_off"] == 0 and c["counts_off"] == 0
    assert set(r["metrics"]) == {"fit_s", "setup_s"}


def test_score_cell_agrees(tiny_run):
    r = tiny_run("higgs-score")
    assert r["correct"], r["checks"]
    assert r["checks"]["calls_checked"]["value"] >= 2
    assert set(r["metrics"]) == {"score_rows_per_s", "score_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("cell", ["higgs-qgrad-fit", "higgs-score"])
def test_traced_runs_report_per_layer_metrics_only(bench, tiny_run, cell):
    r = tiny_run(cell, trace=True, seconds=3.0)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in bench.metrics_of("per_layer", cell)}
    assert set(r["metrics"]) <= names
    if cell != "higgs-score":          # the host clocks read on the CPU too
        assert {"ingest_s", "boost_ms_per_tree"} <= set(r["metrics"])
    # a CPU run reads no device number: the device metrics stay out
    for name in r["metrics"]:
        assert "roofline" not in name and "idle" not in name
        assert "mfu" not in name and "device" not in name
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("generator", ["higgs_shaped", "covertype_shaped"])
def test_binner_matches_the_port(bench, generator):
    """The reference's bounds equal the port's QuantileBinner on rows with
    more values than bins and on one-hot columns, with sampling."""
    from mmlspark_tpu_torch.ops.binning import QuantileBinner
    run = harness.Run(bench, "higgs-qgrad-fit", 3, 1, False, "cpu", False,
                      {"config": {"data": {"generator": generator}}})
    X, _ = run.datagen().draw(30_000, 3, 0, "cpu")
    X = X.numpy()
    lr = gbdt.Learner.from_config(run.config)
    lr = gbdt.Learner(**{**lr.__dict__, "bin_sample_count": 10_000})
    want = QuantileBinner(lr.max_bin, 10_000, lr.bin_seed).fit(X)
    got = gbdt.bin_bounds(X, lr)
    np.testing.assert_array_equal(got, want.upper_bounds)
    bins = gbdt.apply_bins(torch.from_numpy(X), got)
    np.testing.assert_array_equal(bins.numpy().T, want.transform(X))


def test_forest_margins_follow_the_text():
    text = forest_text_small()
    m = lgbm_text.parse(text)
    X = torch.tensor([[0.0, 2.0], [1.0, 0.0], [float("nan"), 5.0]])
    got = forest.margins(m, X)[:, 0].tolist()
    # tree 0: x0 <= 0.5 -> 0.1, else (x1 <= 1.5 -> -0.2, else 0.3); NaN left
    assert got == pytest.approx([0.1 + 0.05, -0.2 + 0.05, 0.1 + 0.05])


def forest_text_small():
    from perfbench.tests.test_perfbench_work import TEXT
    return TEXT.replace("max_feature_idx=2", "max_feature_idx=1").replace(
        "split_feature=0 2", "split_feature=0 1")
