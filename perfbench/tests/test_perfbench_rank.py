"""The ranking cell and the warm refit cell at a tiny size on the CPU: sound
runs are correct, every timed fit a cache hit; each of the ranking faults
(``rank_faults.py``) and the control come out not correct; set-up stops
with its message where the ranker's rows do not land whole in the
binned-dataset cache. The warm refit cell is correct at the tiny size,
every timed fit a hit, and its set-up stops in the same way."""

import pytest

from perfbench.rank_faults import FAULTS

# the ranking cell at the tiny size: Yahoo LTR's 700 features over a few
# thousand rows. Its own limits: sound tiny runs read lambda_err about
# 1e-7 and leaf_err about 1e-7; the int8 split search over so few rows
# reads gain_gap up to about 0.1
RANK_TINY = {"config": {"data": {"rows": 6000, "queries": 250,
                                 "holdout_rows": 1500,
                                 "holdout_queries": 60},
                        "params": {"numIterations": 4},
                        "trace": {"profiled_iterations": 3}}}
RANK_LIMITS = {"gain_gap": 0.5, "left_gain": 0.5, "leaf_err": 1e-4,
               "lambda_err": 1e-5, "margin_err": 1e-5}


@pytest.fixture
def rank_run(bench):
    from perfbench import harness
    import torch

    def go(seed=2**31 + 11, control=False, trace=False):
        ov = {**RANK_TINY, "limits": RANK_LIMITS}
        torch.set_num_threads(4)
        return harness.run_cell(bench, "yahoo-rank-refit", seed, 1.0, trace,
                                device="cpu", control=control, overrides=ov)
    return go


def test_rank_cell_agrees_and_every_fit_hits_the_cache(rank_run):
    r = rank_run()
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], r["checks"]
    assert c["bins_off"] == 0 and c["counts_off"] == 0
    assert c["cache_hits"] == r["attempted"] and c["cache_misses"] == 0
    assert c["rank_launches"] == 4 * r["attempted"]
    assert c["lambda_err"] < 1e-6
    assert set(r["metrics"]) == {"fit_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_rank_fault_is_not_correct(rank_run, fault):
    with FAULTS[fault]():
        r = rank_run()
    assert not r["correct"], r["checks"]
    assert not r["checks"]["lambda_err"]["value"] <= RANK_LIMITS[
        "lambda_err"]


def test_rank_control_is_not_correct(rank_run):
    r = rank_run(control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["lambda_err"]["value"] > 1e-4


def test_set_up_stops_where_the_rows_miss_the_cache(rank_run, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_BINNED_CACHE", "0")
    with pytest.raises(SystemExit, match="binned-dataset cache holds 0"):
        rank_run()


def test_refit_cell_agrees(tiny_run):
    r = tiny_run("higgs-refit")
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], r["checks"]
    assert c["cache_hits"] == r["attempted"] and c["cache_misses"] == 0
    assert set(r["metrics"]) == {"fit_s", "setup_s"}


def test_refit_set_up_stops_where_the_rows_miss_the_cache(tiny_run,
                                                           monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_BINNED_CACHE", "0")
    with pytest.raises(SystemExit, match="binned-dataset cache holds 0"):
        tiny_run("higgs-refit")
