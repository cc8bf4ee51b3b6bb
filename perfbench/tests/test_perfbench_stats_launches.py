"""``stats_launches_per_tree``'s reader: the fused int8 statistics
kernel's launches over the window's trees, from the ``stats_launches``
count each ``gbdt.round`` span records; None where the rounds carry no
such count (a program without the kernel) or the spans are unsound."""

import pytest

from perfbench.tests.test_perfbench_spans import (  # noqa: F401 (feed)
    _fit_run, _misaligned, _strip_ids, feed)

METRIC = "stats_launches_per_tree"


def _with_launches(events, per_round):
    """The fit spans with ``stats_launches`` on every ``gbdt.round``."""
    return [dict(e, args=dict(e["args"], stats_launches=per_round))
            if e["name"] == "gbdt.round" else e for e in events]


@pytest.mark.parametrize("per_round", [1, 3, 0])
def test_reads_the_launches_a_tree(bench, feed, per_round):
    events, run = _fit_run()
    feed(_with_launches(events, per_round))
    assert bench.reader(METRIC).read(run) == pytest.approx(per_round)


def test_reads_nothing_where_no_round_counts_launches(bench, feed):
    events, run = _fit_run()
    feed(events)
    assert bench.reader(METRIC).read(run) is None


def test_reads_nothing_where_one_round_lacks_the_count(bench, feed):
    events, run = _fit_run()
    events = _with_launches(events, 1)
    last = max(i for i, e in enumerate(events) if e["name"] == "gbdt.round")
    events[last] = dict(events[last], args={
        k: v for k, v in events[last]["args"].items()
        if k != "stats_launches"})
    feed(events)
    assert bench.reader(METRIC).read(run) is None


@pytest.mark.parametrize("fault", ["dropped", "no_ids", "missing",
                                   "misaligned"])
def test_reads_nothing_from_unsound_spans(bench, feed, fault):
    events, run = _fit_run()
    events = _with_launches(events, 1)
    if fault == "dropped":
        feed(events, dropped=1)
    elif fault == "no_ids":
        feed(_strip_ids(events))
    elif fault == "missing":
        feed(events[:len(events) // 3])
    else:
        feed(_misaligned(events))
    assert bench.reader(METRIC).read(run) is None
