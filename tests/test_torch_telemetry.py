"""The main path's telemetry and knobs: the PyTorch port against the JAX
package.

  * With metrics on, a ``LightGBMClassifier`` fit -> transform (validation
    set, early stopping) publishes the JAX fit's metric families with the
    same label keys, and the same label values for the GBDT and stage
    families; the JAX fit's two families with no counterpart in the port
    are ``gbdt_program_builds_total`` (the port compiles no training
    program) and ``hist_engine_selected_total`` (the port has one
    histogram rule, not three engines).
  * Every stage's fit and transform runs in a span with row counters, and a
    stage that raises leaves a flight ``error`` record, as in the JAX
    package; with metrics off nothing is published and the model is
    byte-identical.
  * ``MMLSPARK_TPU_TELEMETRY_ROUNDS=1``: one ``boost_round`` instant and one
    ``gbdt_boost_rounds_total`` count per round; unset, no callback.
  * ``MMLSPARK_TPU_BINNED_CACHE=0`` leaves the binned-dataset cache empty;
    on, the cached dataset is claimed on the HBM ledger as
    ``binned_cache`` and released with the cache.
  * ``MMLSPARK_TPU_TIMING=1`` prints the phases of a fit;
    ``utils.profiling.trace`` writes a Chrome trace; ``utils.stopwatch``
    is the JAX module's.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.gbdt.api import LightGBMClassifier as JClassifier
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.parallel.mesh import default_mesh, make_mesh
from mmlspark_tpu.utils import stopwatch as jstopwatch
from mmlspark_tpu_torch.core.dataset import Dataset as TDataset
from mmlspark_tpu_torch.models.gbdt import api as tapi
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.observability import flight, hbm, spans
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.utils import profiling, stopwatch

torch.set_num_threads(1)

NO_COUNTERPART = {"gbdt_program_builds_total", "hist_engine_selected_total"}
PARAMS = dict(numIterations=3, numLeaves=7, validationIndicatorCol="v",
              earlyStoppingRound=2)


def _cols(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    v = np.zeros(n, bool)
    v[n - 100:] = True
    return {"features": X, "label": y, "v": v}


def _families(snap):
    return {k: sorted({tuple(sorted(s["labels"])) for s in f["series"]})
            for k, f in snap.items()}


def _values(snap, name):
    """The label sets of one family, uid digits normalised."""
    return sorted(json.dumps({k: re.sub(r"_\d{4}", "_N", str(v))
                              for k, v in s["labels"].items()},
                             sort_keys=True)
                  for s in snap.get(name, {}).get("series", []))


@pytest.fixture
def fresh_registries():
    for m in (jmetrics, tmetrics):
        m.get_registry().reset()
    yield
    for m in (jmetrics, tmetrics):
        m.get_registry().reset()


def test_fit_publishes_the_jax_families_and_labels(fresh_registries):
    cols = _cols()
    with default_mesh(make_mesh(devices=jax.devices()[:1])):
        jm = JClassifier(**PARAMS).fit(JDataset(cols))
        jm.transform(JDataset({"features": cols["features"]}))
    tm = LightGBMClassifier(device="cpu", **PARAMS).fit(TDataset(cols))
    tm.transform(TDataset({"features": cols["features"]}))
    js = jmetrics.get_registry().snapshot()
    ts = tmetrics.get_registry().snapshot()
    jf, tf = _families(js), _families(ts)
    assert set(jf) - set(tf) == NO_COUNTERPART
    assert set(tf) <= set(jf)
    for name in tf:
        assert tf[name] == jf[name], name
    for name in ("gbdt_fits_total", "gbdt_trained_iterations",
                 "gbdt_best_iteration", "gbdt_train_metric",
                 "stage_rows_in_total", "stage_rows_out_total"):
        assert _values(ts, name) == _values(js, name), name
    # the port always runs the host round loop (the JAX package fuses this
    # fit into one scan), whose per-round sentinels feed model "gbdt" too
    extra = set(_values(ts, "training_health")) - set(
        _values(js, "training_health"))
    assert set(_values(js, "training_health")) <= set(
        _values(ts, "training_health"))
    assert extra == {'{"model": "gbdt"}'}
    spans_t = set(_values(ts, "span_duration_seconds"))
    assert '{"name": "LightGBMClassifier.train_booster"}' in spans_t
    assert spans_t >= {'{"name": "LightGBMClassifier"}',
                       '{"name": "LightGBMClassificationModel"}'}
    assert spans_t <= set(_values(js, "span_duration_seconds"))


def test_a_failing_stage_leaves_an_error_record():
    flight.clear()
    est = LightGBMClassifier(device="cpu", numIterations=1)
    with pytest.raises(ValueError):
        est.fit(TDataset({"features": np.zeros((4, 2), np.float32),
                          "label": np.array([0.0, 1.5, 2.0, 0.0])}))
    err = [e for e in flight.events() if e.get("kind") == "error"]
    assert err and err[-1]["stage"] == "LightGBMClassifier"
    assert err[-1]["op"] == "fit" and err[-1]["rows_in"] == 4


def test_metrics_off_publishes_nothing_and_fits_the_same(fresh_registries):
    cols = _cols(seed=1)
    on = LightGBMClassifier(device="cpu", **PARAMS).fit(TDataset(cols))
    tmetrics.get_registry().reset()
    spans.clear_trace()
    tmetrics.set_enabled(False)
    try:
        off = LightGBMClassifier(device="cpu", **PARAMS).fit(TDataset(cols))
        assert tmetrics.get_registry().snapshot() == {}
        assert spans.get_trace_events() == []
    finally:
        tmetrics.set_enabled(True)
    assert off.booster.model_string() == on.booster.model_string()


def test_round_telemetry_is_opt_in(monkeypatch, fresh_registries):
    monkeypatch.delenv("MMLSPARK_TPU_TELEMETRY_ROUNDS", raising=False)
    assert LightGBMClassifier()._round_callback() is None
    monkeypatch.setenv("MMLSPARK_TPU_TELEMETRY_ROUNDS", "1")
    spans.clear_trace()
    m = LightGBMClassifier(device="cpu", **PARAMS).fit(TDataset(_cols()))
    snap = tmetrics.get_registry().snapshot()
    rounds = snap["gbdt_boost_rounds_total"]["series"][0]
    assert rounds["value"] == len(m.booster.eval_history["binary_logloss"])
    ev = [e for e in spans.get_trace_events() if e["name"] == "boost_round"]
    assert len(ev) == rounds["value"]
    assert snap["gbdt_round_metric"]["series"][0]["labels"] == {
        "model": "LightGBMClassifier", "metric": "binary_logloss"}


def test_binned_cache_knob_and_hbm_claims(monkeypatch):
    tapi.clear_binned_dataset_cache()
    assert hbm.claims().get("binned_cache", 0) == 0
    cols = _cols(seed=2)
    del cols["v"]
    monkeypatch.setenv("MMLSPARK_TPU_BINNED_CACHE", "0")
    LightGBMClassifier(device="cpu", numIterations=1).fit(TDataset(cols))
    assert len(tapi._BINNED_CACHE) == 0
    monkeypatch.setenv("MMLSPARK_TPU_BINNED_CACHE", "1")
    LightGBMClassifier(device="cpu", numIterations=1).fit(TDataset(cols))
    assert len(tapi._BINNED_CACHE) == 1
    ds = next(iter(tapi._BINNED_CACHE.values()))
    assert hbm.claims()["binned_cache"] == tapi._dataset_nbytes(ds) > 0
    tapi.clear_binned_dataset_cache()
    assert hbm.claims().get("binned_cache", 0) == 0


def test_timing_knob_prints_the_phases(monkeypatch, capsys):
    from mmlspark_tpu_torch.models.gbdt.booster import train_booster
    monkeypatch.setenv("MMLSPARK_TPU_TIMING", "1")
    cols = _cols(seed=3)
    train_booster(cols["features"], cols["label"], objective="binary",
                  num_iterations=2, device="cpu")
    out = capsys.readouterr()
    names = re.findall(r"\[gbdt-timing\] (\w+):", out.out + out.err)
    assert names == ["binner_fit", "xfer_X", "bin_device", "aux_shards",
                     "base_scores", "boosting"]


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    files = os.listdir(tmp_path)
    assert files == [f"trace-{os.getpid()}.json"]
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_stopwatch_matches_jax():
    for mod in (stopwatch, jstopwatch):
        sw = mod.StopWatch()
        assert sw.elapsed_ns() == 0 and sw.measure(lambda: 7) == 7
        total = sw.stop()
        assert total == sw.elapsed_ns() > 0
        sw.restart()
        assert sw.stop() >= 0


def test_env_registry_lacks_only_the_names_without_counterpart():
    """The JAX registry's names the port does not read: the three
    histogram engines' knobs, XLA's compile cache, the native runtime's
    fallback and prebuilt cache, and the fused DART and validation scans
    (ROADMAP Queue 1 and Queue 2 item A)."""
    from mmlspark_tpu.observability import env_registry as jreg
    from mmlspark_tpu_torch.observability import env_registry as preg
    prefix = "MMLSPARK_TPU_"
    assert {n[len(prefix):] for n in jreg.names() - preg.names()} == {
        "HIST_ENGINE", "DISABLE_PALLAS_HIST", "PALLAS_INTERPRET",
        "HIST_UNROLL_MAX", "COMPILE_CACHE_DIR", "DISABLE_NATIVE",
        "NATIVE_CACHE", "DISABLE_FUSED_DART", "DISABLE_FUSED_VALID"}
    assert {"MMLSPARK_TPU_BINNED_CACHE", "MMLSPARK_TPU_TELEMETRY_ROUNDS",
            "MMLSPARK_TPU_TIMING", "MMLSPARK_TPU_HIST_BLOCKS",
            "MMLSPARK_TPU_MESH_DEVICES"} <= preg.names()
