"""The port's spans on the profiler's clock, with ids, device time and
counter deltas, and the GBDT phase spans a fit and a ``transform`` open.

  * A tiny ``LightGBMClassifier`` fit and transform record every phase
    span, each under its parent by ``parent_id``, one ``gbdt.round`` per
    iteration carrying its counter deltas (leafwise, depthwise, dart).
  * Two identical fits make as many host syncs; with metrics off nothing
    is recorded or published, only the plain counters move, and the model
    is byte-identical.
  * A ``LightGBMRanker`` fit sorts its rows into query groups in a
    ``gbdt.rank.groups`` span and takes each round's lambdas in a
    ``gbdt.rank.lambdas`` span inside ``gbdt.grad_hess``; each
    ``gbdt.round`` carries the LambdaRank kernel's launches and pairs
    (``rank_launches``, ``rank_pairs``); with metrics off, none of them.
  * A span's ``ts`` lies within 1 ms of the ``torch.profiler`` annotation
    it opens, and ``dump_trace(overlay=...)`` keeps that on the profiler's
    time base.
"""

import json

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt import api, growth
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassifier,
                                                LightGBMRanker)
from mmlspark_tpu_torch.observability import flight, metrics, spans

torch.set_num_threads(1)

ITERS = 3
# each phase span's parent, by name ("fit"/"transform": the pipeline span)
FIT_PARENTS = {
    "gbdt.labels": "fit", "gbdt.extract": "train_booster",
    "gbdt.binned_cache": "train_booster", "gbdt.ingest": "train_booster",
    "gbdt.ingest.binner_fit": "gbdt.ingest",
    "gbdt.ingest.upload": "gbdt.ingest",
    "gbdt.ingest.bin_apply": "gbdt.ingest", "gbdt.ingest.aux": "gbdt.ingest",
    "gbdt.boost": "train_booster", "gbdt.round": "gbdt.boost",
    "gbdt.grad_hess": "gbdt.round", "gbdt.grow": "gbdt.round",
    "gbdt.score_update": "gbdt.round", "gbdt.grow.stats": "gbdt.grow",
    "gbdt.grow.renew": "gbdt.grow",
}
TRANSFORM_PARENTS = {
    "gbdt.transform.features": "transform", "gbdt.predict": "transform",
    "gbdt.transform.columns": "transform",
    "gbdt.predict.plan": "gbdt.predict",
    "gbdt.predict.upload": "gbdt.predict",
    "gbdt.predict.traverse": "gbdt.predict",
    "gbdt.predict.readback": "gbdt.predict",
}


def _cols(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return {"features": X, "label": y}


def _fit(cols, **params):
    api.clear_binned_dataset_cache()       # every fit ingests its rows
    return LightGBMClassifier(device="cpu", numIterations=ITERS, numLeaves=7,
                              useQuantizedGrad=True, quantWarmupIters=0,
                              **params).fit(Dataset(cols))


@pytest.fixture
def telemetry():
    prev = metrics.set_enabled(True)
    spans.clear_trace()
    flight.clear()
    metrics.reset()
    yield
    spans.clear_trace()
    flight.clear()
    metrics.reset()
    metrics.set_enabled(prev)


def _role(e, by_id):
    """A span's parent as FIT_PARENTS / TRANSFORM_PARENTS name it."""
    p = by_id[e["args"]["parent_id"]]
    if p["args"].get("op") in ("fit", "transform"):
        return p["args"]["op"]
    return "train_booster" if p["name"].endswith(".train_booster") else (
        p["name"])


@pytest.mark.parametrize("params", [
    {}, {"growthPolicy": "depthwise"}, {"boostingType": "dart"}],
    ids=["leafwise", "depthwise", "dart"])
def test_fit_and_transform_record_every_phase_span(telemetry, params):
    cols = _cols()
    model = _fit(cols, **params)
    model.transform(Dataset({"features": cols["features"]}))
    evs = spans.get_trace_events()
    by_id = {e["args"]["span_id"]: e for e in evs}
    assert len(by_id) == len(evs)                 # one id a span
    names = {e["name"] for e in evs}
    assert set(FIT_PARENTS) | set(TRANSFORM_PARENTS) <= names
    for e in evs:
        want = {**FIT_PARENTS, **TRANSFORM_PARENTS}.get(e["name"])
        if want is not None:
            assert _role(e, by_id) == want, e["name"]
            assert e["args"]["parent"] == by_id[e["args"]["parent_id"]][
                "name"]
    rounds = [e for e in evs if e["name"] == "gbdt.round"]
    assert [r["args"]["iteration"] for r in rounds] == list(range(ITERS))
    for r in rounds:
        assert r["args"]["host_syncs"] >= 1
        # the CPU runs no kernel: launches and their rows stay 0
        assert r["args"]["hist_launches"] == r["args"]["hist_rows"] == 0
        assert r["args"]["stats_launches"] == 0
        assert r["args"]["stats_amax_launches"] == 0
    for name in ("gbdt.grow", "gbdt.grow.stats", "gbdt.grow.renew"):
        assert len([e for e in evs if e["name"] == name]) == ITERS
    (boost,) = [e for e in evs if e["name"] == "gbdt.boost"]
    assert boost["args"]["trees"] == model.booster.num_trees == ITERS
    (ingest,) = [e for e in evs if e["name"] == "gbdt.ingest"]
    assert (ingest["args"]["rows"], ingest["args"]["features"]) == (3000, 5)
    (cache,) = [e for e in evs if e["name"] == "gbdt.binned_cache"]
    assert cache["args"]["hit"] == 0
    (pred,) = [e for e in evs if e["name"] == "gbdt.predict"]
    assert (pred["args"]["rows"], pred["args"]["graph"]) == (3000, 0)
    # a CPU span takes no device time, and the phase spans publish nothing
    assert not any("device_ms" in e["args"] for e in evs)
    published = {s["labels"]["name"] for s in metrics.get_registry()
                 .snapshot()["span_duration_seconds"]["series"]}
    assert not any(n.startswith("gbdt.") for n in published)
    assert not any(e["name"].startswith("gbdt.") for e in flight.events()
                   if e["kind"] == "span_end")


def test_two_identical_fits_make_as_many_host_syncs(telemetry):
    cols = _cols(seed=1)
    counts = []
    for _ in range(2):
        spans.clear_trace()
        before = growth.host_syncs
        _fit(cols)
        rounds = [e["args"]["host_syncs"] for e in spans.get_trace_events()
                  if e["name"] == "gbdt.round"]
        counts.append((rounds, growth.host_syncs - before))
    assert counts[0] == counts[1]
    assert sum(counts[0][0]) <= counts[0][1]


def test_metrics_off_records_nothing_and_fits_the_same(telemetry):
    cols = _cols(seed=2)
    on = _fit(cols)
    spans.clear_trace()
    flight.clear()
    metrics.reset()
    metrics.set_enabled(False)
    before = growth.host_syncs
    off = _fit(cols)
    off.transform(Dataset({"features": cols["features"]}))
    assert spans.get_trace_events() == []
    assert metrics.get_registry().snapshot() == {}
    assert flight.events() == []
    assert growth.host_syncs > before       # a plain int counts on or off
    assert off.booster.model_string() == on.booster.model_string()


def test_sibling_spans_of_one_name_are_told_apart(telemetry):
    reads = iter([0, 5, 5, 12])
    with spans.span("outer") as outer:
        for _ in range(2):
            with spans.span("inner", counters={"n": lambda: next(reads)},
                            device=torch.device("cpu"), publish=False):
                spans.instant("mark")
    a, b, o = [e for e in spans.get_trace_events() if e["ph"] == "X"]
    marks = [e for e in spans.get_trace_events() if e["ph"] == "i"]
    assert a["args"]["span_id"] != b["args"]["span_id"]
    assert a["args"]["parent_id"] == b["args"]["parent_id"] == outer.span_id
    assert [m["args"]["parent_id"] for m in marks] == [
        a["args"]["span_id"], b["args"]["span_id"]]
    assert (a["args"]["n"], b["args"]["n"]) == (5, 7)
    assert "parent_id" not in o["args"] and "device_ms" not in a["args"]


def test_ranker_fit_records_its_query_and_lambda_spans(telemetry):
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 40, size=60)
    q = np.repeat(np.arange(60), lengths)
    X = rng.normal(size=(len(q), 4)).astype(np.float32)
    y = np.digitize(X[:, 0] + rng.normal(size=len(q)),
                    [-0.5, 0.5, 1.2]).astype(np.float32)
    rows = Dataset({"features": X, "label": y, "q": q[::-1].copy()})

    def fit():
        api.clear_binned_dataset_cache()
        return LightGBMRanker(device="cpu", groupCol="q", numIterations=ITERS,
                              numLeaves=7).fit(rows)
    on = fit()
    evs = spans.get_trace_events()
    by_id = {e["args"]["span_id"]: e for e in evs}
    (groups,) = [e for e in evs if e["name"] == "gbdt.rank.groups"]
    assert _role(groups, by_id) == "fit"
    assert (groups["args"]["queries"], groups["args"]["rows"]) == (60, len(q))
    lam = [e for e in evs if e["name"] == "gbdt.rank.lambdas"]
    assert len(lam) == ITERS
    assert {_role(e, by_id) for e in lam} == {"gbdt.grad_hess"}
    rounds = [e for e in evs if e["name"] == "gbdt.round"]
    assert len(rounds) == ITERS
    for r in rounds:       # the CPU runs the plain version, no kernel
        assert r["args"]["rank_launches"] == r["args"]["rank_pairs"] == 0
    spans.clear_trace()
    metrics.set_enabled(False)
    off = fit()
    assert spans.get_trace_events() == []
    assert off.booster.model_string() == on.booster.model_string()


def _profiled_probe():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        # the process's first annotation under a profiler sets it up
        with spans.span("probe.warm"):
            torch.ones(8).sum()
        with spans.span("probe.clock"):
            torch.ones(8).sum()
    (ours,) = [e for e in spans.get_trace_events()
               if e["name"] == "probe.clock"]
    return prof, ours


def test_span_ts_lies_on_the_profilers_clock(telemetry):
    prof, ours = _profiled_probe()
    (theirs,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == "probe.clock"]
    assert abs(ours["ts"] - theirs.start_ns() / 1e3) < 1000.0


def test_dump_trace_overlays_the_profilers_export(telemetry, tmp_path):
    prof, ours = _profiled_probe()
    exported = str(tmp_path / "profiler.json")
    prof.export_chrome_trace(exported)
    merged = spans.dump_trace(str(tmp_path / "merged.json"),
                              overlay=exported)
    with open(merged) as f:
        doc = json.load(f)
    with open(exported) as f:
        assert len(doc["traceEvents"]) == len(json.load(f)["traceEvents"]) + (
            len(spans.get_trace_events()))
    probe = [e for e in doc["traceEvents"] if e.get("name") == "probe.clock"
             and e.get("ph") == "X"]
    (theirs,) = [e for e in probe if e.get("cat") == "user_annotation"]
    (mine,) = [e for e in probe if e.get("cat") == "mmlspark"]
    assert abs(mine["ts"] - theirs["ts"]) < 1000.0
    assert mine["args"]["span_id"] == ours["args"]["span_id"]
    assert doc["otherData"]["dropped_events"] == 0
