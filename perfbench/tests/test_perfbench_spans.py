"""The readers of the port's spans and counters: each, given a hand-built
span list and ``run.layer``, returns its number, and None where the spans
are missing (a program without them), misaligned with the run's calls or
dropped; on the card, device-timed spans resolve their ``device_ms``."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import work
from perfbench.reference import lgbm_text

TREES = 4


class _Ids:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n


def _ev(out, ids, name, parent, ts, dur, **args):
    sid = ids()
    a = dict(args, span_id=sid)
    if parent is not None:
        a["parent_id"] = parent
    out.append({"name": name, "ph": "X", "ts": ts, "dur": dur, "args": a})
    return sid


def _fit_spans(out, ids, ts, trees=TREES):
    """One fit as the port records it (microseconds): 10 s in all, 2 s of
    ingest (0.5 s of it the binner), 7 s of boosting."""
    fit = _ev(out, ids, "LightGBMClassifier.LightGBMClassifier_0004", None,
              ts, 10e6, op="fit", rows_in=1000)
    tb = _ev(out, ids, "LightGBMClassifier_0004.train_booster", fit,
             ts + 1, 9.5e6)
    ing = _ev(out, ids, "gbdt.ingest", tb, ts + 2, 2e6, rows=1000)
    _ev(out, ids, "gbdt.ingest.binner_fit", ing, ts + 3, 0.5e6)
    boost = _ev(out, ids, "gbdt.boost", tb, ts + 2e6 + 10, 7e6, trees=trees)
    for t in range(trees):
        r = _ev(out, ids, "gbdt.round", boost, ts + 2e6 + 20 + t, 1e6,
                iteration=t, host_syncs=7, hist_launches=7, hist_rows=400)
        g = _ev(out, ids, "gbdt.grow", r, ts + 2e6 + 21 + t, 0.9e6,
                device_ms=900.0)
        _ev(out, ids, "gbdt.grow.stats", g, ts + 2e6 + 22 + t, 0.1e6,
            device_ms=2.0)
        _ev(out, ids, "gbdt.grow.renew", g, ts + 2e6 + 23 + t, 0.1e6,
            device_ms=1.0)


class _Booster:
    num_trees = TREES

    def to_lightgbm_string(self):
        return "model"


def _fit_run(n_fits=3):
    out, ids = [], _Ids()
    # the set-up's fit, then the profiled fit and the window's
    for i in range(n_fits + 1):
        _fit_spans(out, ids, 1e12 + i * 20e6, trees=2 if i == 0 else TREES)
    fits = [dict(booster=_Booster(), profiled=i == 0, seconds=10.0)
            for i in range(n_fits)]
    return out, SimpleNamespace(layer={"fits": fits}, attempted=n_fits,
                                failed=0)


def _score_run(calls=5):
    out, ids = [], _Ids()
    for i in range(calls + 2):                  # two warm-up calls first
        c = _ev(out, ids, "LightGBMClassificationModel.LightGBMClassif"
                "icationModel_0001", None, 1e12 + i * 1e6, 300e3,
                op="transform", rows_in=1_000_000, rows_out=1_000_000)
        _ev(out, ids, "gbdt.transform.features", c, 1e12 + i * 1e6 + 1, 1e3)
        _ev(out, ids, "gbdt.predict", c, 1e12 + i * 1e6 + 2, 200e3,
            rows=1_000_000, graph=0)
    return out, SimpleNamespace(layer={"calls": calls}, attempted=calls,
                                failed=0)


@pytest.fixture
def feed(monkeypatch):
    """``feed(events, dropped=0)``: the port's trace buffer as the readers
    see it."""
    from mmlspark_tpu_torch.observability import spans

    def go(events, dropped=0):
        monkeypatch.setattr(spans, "get_trace_events",
                            lambda: [dict(e) for e in events])
        monkeypatch.setattr(spans, "dropped_events", lambda: dropped)
    monkeypatch.setattr(work, "hist_rows", lambda model: 1000)
    monkeypatch.setattr(lgbm_text, "parse", lambda text: text)
    return go


FIT_READINGS = {
    "ingest_span_s": 2.0,
    "boost_span_ms_per_tree": 7e3 / TREES,
    "estimator_self_s": 1.0,
    "ingest_binner_s": 0.5,
    "stats_device_ms_per_tree": 2.0,
    "renew_device_ms_per_tree": 1.0,
    "host_syncs_per_tree": 7.0,
    "hist_rows_useful_pct": 100.0 * 1000 / (TREES * 400),
}


@pytest.mark.parametrize("metric", sorted(FIT_READINGS))
def test_fit_reader_reads_its_spans(bench, feed, metric):
    events, run = _fit_run()
    feed(events)
    assert bench.reader(metric).read(run) == pytest.approx(
        FIT_READINGS[metric])


def _strip_ids(events):
    return [dict(e, args={k: v for k, v in e["args"].items()
                          if k not in ("span_id", "parent_id")})
            for e in events]


def _misaligned(events):
    """The window's last fit grew one tree fewer than its spans say."""
    last = max(i for i, e in enumerate(events) if e["name"] == "gbdt.boost")
    out = list(events)
    out[last] = dict(events[last], args=dict(events[last]["args"],
                                             trees=TREES + 1))
    return out


@pytest.mark.parametrize("metric", sorted(FIT_READINGS) + [
    "transform_host_ms_per_mrow"])
@pytest.mark.parametrize("fault", ["dropped", "no_ids", "missing",
                                   "misaligned"])
def test_readers_read_nothing_from_unsound_spans(bench, feed, metric, fault):
    fit = metric != "transform_host_ms_per_mrow"
    events, run = _fit_run() if fit else _score_run()
    if fault == "dropped":
        feed(events, dropped=1)
    elif fault == "no_ids":                  # a program that keeps no ids
        feed(_strip_ids(events))
    elif fault == "missing":
        feed(events[:len(events) // 3])
    else:
        if fit:
            events = _misaligned(events)
        else:
            run.attempted += 4               # more calls than spans
        feed(events)
    assert bench.reader(metric).read(run) is None


def test_transform_reader_reads_its_spans(bench, feed):
    events, run = _score_run()
    feed(events)
    assert bench.reader("transform_host_ms_per_mrow").read(run) == (
        pytest.approx(100.0))


def test_device_readers_read_nothing_without_device_time(bench, feed):
    events, run = _fit_run()
    feed([dict(e, args={k: v for k, v in e["args"].items()
                        if k != "device_ms"}) for e in events])
    for metric in ("stats_device_ms_per_tree", "renew_device_ms_per_tree"):
        assert bench.reader(metric).read(run) is None


@pytest.mark.card
def test_device_time_and_launch_rows_on_the_card(card):
    """A device-timed span resolves a positive ``device_ms``; a quantized
    fit's rounds record the rows handed to kernel 2's launches, and its
    stats and renewal spans their device time."""
    import numpy as np
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
    from mmlspark_tpu_torch.observability import metrics, spans
    prev = metrics.set_enabled(True)
    try:
        spans.clear_trace()
        x = torch.randn(2048, 2048, device=card)
        with spans.span("card.matmul", device=card, publish=False):
            (x @ x).sum()
        rng = np.random.default_rng(0)
        X = rng.normal(size=(50_000, 8)).astype(np.float32)
        y = (X[:, 0] + 0.3 * rng.normal(size=50_000) > 0).astype(np.float32)
        LightGBMClassifier(device="cuda", numIterations=3,
                           useQuantizedGrad=True, quantWarmupIters=0).fit(
            Dataset({"features": X, "label": y}))
        evs = spans.get_trace_events()
    finally:
        metrics.set_enabled(prev)
        spans.clear_trace()
    (mm,) = [e for e in evs if e["name"] == "card.matmul"]
    assert mm["args"]["device_ms"] > 0
    rounds = [e for e in evs if e["name"] == "gbdt.round"]
    assert len(rounds) == 3
    for r in rounds:
        assert r["args"]["hist_launches"] >= 1
        assert r["args"]["hist_rows"] >= 50_000
        assert r["args"]["host_syncs"] >= 1
    for name in ("gbdt.grow.stats", "gbdt.grow.renew", "gbdt.grow"):
        found = [e for e in evs if e["name"] == name]
        assert len(found) == 3
        assert all(e["args"]["device_ms"] > 0 for e in found)
