"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU runs the cell at the tiny
size) and the port is broken in place (``perfbench/faults.py``), once for
each fault a cell can have; and the control comes out not correct."""

import pytest

from perfbench.faults import FAULTS


@pytest.mark.parametrize("cell,fault", [
    ("higgs-qgrad-fit", "zero_trees"), ("higgs-qgrad-fit", "half_batch"),
    ("higgs-qgrad-fit", "shifted_gradient"),
    ("higgs-qgrad-fit", "altered_leaf"),
    ("higgs-qgrad-fit", "altered_margin"), ("higgs-score", "altered_margin")])
def test_fault_is_not_correct(tiny_run, cell, fault):
    with FAULTS[fault]():
        r = tiny_run(cell)
    assert not r["correct"], r["checks"]


def test_shifted_gradient_is_caught_by_the_split_gains_alone(tiny_run):
    """A histogram whose gradient channel is wrong picks wrong splits while
    the rows, the leaves and the margins stay right: only ``gain_gap``
    sees it."""
    with FAULTS["shifted_gradient"]():
        r = tiny_run("higgs-qgrad-fit")
    failed = {k for k, c in r["checks"].items()
              if not c["value"] <= float(c["limit"].split()[-1])}
    assert failed == {"gain_gap"}, r["checks"]


@pytest.mark.parametrize("cell", ["higgs-qgrad-fit", "higgs-score"])
def test_control_is_not_correct_at_the_tiny_size(tiny_run, cell):
    """The control, the configuration's next precision down through the
    program's own path, fails the tiny size's limits."""
    r = tiny_run(cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["higgs-qgrad-fit", "higgs-score"])
def test_control_is_not_correct_on_the_card(card, bench, cell):
    """The control at the cell's own size on the card, against the cell's
    own limits."""
    from perfbench import harness
    r = harness.run_cell(bench, cell, 4242, 0.001, False, control=True)
    assert not r["correct"], r["checks"]
