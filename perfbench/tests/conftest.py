"""CPU tests of the benchmark (``python -m pytest perfbench/tests``), and
its card tests, marked ``card``, which skip without a CUDA device."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a whole run at a size the CPU holds in seconds: rows, trees, partitions
TINY = {"config": {"data": {"rows": 20000, "holdout_rows": 2000},
                   "params": {"numIterations": 6},
                   "trace": {"profiled_iterations": 3}},
        "traffic": {"partition_rows": 8192, "model_sample_rows": 4096,
                    "checked_below": 4, "checked_calls": 2,
                    "profile_from": 1, "profiled_calls": 2}}
# the tiny runs' own limits (the cells' limits are set from full-size
# readings on the card): sound tiny runs read about a hundredth of these
# on the CPU, the control and every fault read above them
TINY_LIMITS = {"gain_gap": 1e-2, "left_gain": 1e-2, "leaf_err": 1e-4,
               "margin_err": 1e-5, "prob_err": 1e-6}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from perfbench import harness
    return harness.Bench(ROOT)


@pytest.fixture
def tiny_run(bench):
    """``tiny_run(cell, seed, control=False, limits=None)``: one whole run
    of ``cell`` on the CPU at the tiny size."""
    from perfbench import harness

    def go(cell, seed=2**31 + 7, control=False, limits=None, seconds=1.0,
           trace=False, on=None):
        ov = {**TINY, "limits": dict(TINY_LIMITS, **(limits or {}))}
        torch.set_num_threads(4)
        return harness.run_cell(on or bench, cell, seed, seconds, trace,
                                device="cpu", control=control, overrides=ov)
    return go
