"""The port's observability modules against the JAX package's.

Each test drives the JAX module and its copy in ``mmlspark_tpu_torch`` with
the same scripted calls, under the same injected clock or id source, and
compares what they return: metrics exposition and snapshots, traceparent
parsing and inbound contexts, the flight ring, log records, SLO burn
rates, the tail reservoir, watchdog stall detection, spans, the device
memory and roofline ledgers; plus the port's own device probes and its
env registry against the knobs its source reads.
"""

import importlib
import json
import os
import re
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch

torch.set_num_threads(1)

MODS = ("metrics", "tracing", "flight", "logging", "slo", "tailsampler",
        "watchdog", "spans", "env_registry", "hbm", "roofline", "device",
        "blackbox")


def _pkg(root):
    return SimpleNamespace(**{m: importlib.import_module(
        f"{root}.observability.{m}") for m in MODS})


J = _pkg("mmlspark_tpu")
P = _pkg("mmlspark_tpu_torch")


def _pair(fn):
    """``fn`` run on the JAX modules, then on the port's."""
    return fn(J), fn(P)


class FakeTime:
    """A clock and sleep the scripts advance by hand."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def sleep(self, s):
        self.t += float(s)


class FakeUuid:
    """uuid4 as a counter, so both packages mint the same ids."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=(self.n * 0x9E3779B97F4A7C15) % (1 << 128))


def _reset(pkg):
    pkg.watchdog.stop()          # no sampler thread writes mid-test
    pkg.metrics.reset()
    pkg.flight.clear()
    pkg.spans.clear_trace()
    pkg.slo.reset()
    pkg.tailsampler.reset()
    pkg.tracing.clear_exemplars()
    pkg.hbm.reset()
    pkg.roofline.reset()


@pytest.fixture(autouse=True)
def _clean():
    """Telemetry on, each package's registry, ring, buffers and ledgers
    empty before and after every test."""
    prev = [J.metrics.set_enabled(True), P.metrics.set_enabled(True)]
    for pkg in (J, P):
        _reset(pkg)
    yield
    for pkg, was in zip((J, P), prev):
        _reset(pkg)
        pkg.metrics.set_enabled(was)


def _clocks(monkeypatch, *names):
    """One fake clock per package, installed as ``time`` in the named
    modules of that package."""
    clocks = []
    for pkg in (J, P):
        ft = FakeTime()
        for n in names:
            monkeypatch.setattr(getattr(pkg, n), "time", ft)
        clocks.append(ft)
    return clocks


# -- metrics -----------------------------------------------------------------

METRIC_SCRIPTS = {
    "counters": [
        ("counter", "requests_total", {"api": "a", "code": "200"}, "inc", 1),
        ("counter", "requests_total", {"api": "a", "code": "200"}, "inc", 2.5),
        ("counter", "requests_total", {"api": "b", "code": "429"}, "inc", 1),
        ("counter", "bytes_total", {}, "inc", 12345678901.0),
    ],
    "gauges": [
        ("gauge", "queue_depth", {"api": "a"}, "set", 7),
        ("gauge", "queue_depth", {"api": "a"}, "inc", 3),
        ("gauge", "queue_depth", {"api": "a"}, "dec", 4.5),
        ("gauge", "device_memory_bytes", {"device": "cuda:0",
                                          "stat": "bytes_limit"},
         "set", 85899345920.0),
        ("gauge", "ratio", {"k": 'quo"te\\n'}, "set", 0.1),
    ],
    "histograms": [
        ("histogram", "latency_seconds", {"api": "a"}, "observe", 0.0004),
        ("histogram", "latency_seconds", {"api": "a"}, "observe", 0.03),
        ("histogram", "latency_seconds", {"api": "a"}, "observe", 75.0),
        ("histogram", "latency_seconds", {"api": "b"}, "observe", 1e-6),
    ],
    "custom_buckets": [
        ("histogram_b", "batch_size", {"api": "a"}, "observe", 1),
        ("histogram_b", "batch_size", {"api": "a"}, "observe", 3),
        ("histogram_b", "batch_size", {"api": "a"}, "observe", 32),
        ("histogram_b", "batch_size", {"api": "a"}, "observe", 2000),
    ],
}
BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _run_metrics(pkg, script):
    reg = pkg.metrics.MetricsRegistry()
    for kind, name, labels, op, arg in script:
        if kind == "histogram_b":
            m = reg.histogram(name, buckets=BUCKETS, **labels)
        else:
            m = getattr(reg, kind)(name, **labels)
        getattr(m, op)(arg)
    return reg.render_prometheus(), reg.snapshot()


@pytest.mark.parametrize("script", sorted(METRIC_SCRIPTS))
def test_metrics_exposition_and_snapshot_match(script):
    (jtext, jsnap), (ptext, psnap) = _pair(
        lambda pkg: _run_metrics(pkg, METRIC_SCRIPTS[script]))
    assert ptext == jtext
    assert psnap == jsnap
    assert json.dumps(psnap) == json.dumps(jsnap)


def test_metrics_kill_switch_matches():
    def run(pkg):
        pkg.metrics.set_enabled(False)
        pkg.metrics.safe_counter("c_total", api="a").inc()
        pkg.metrics.safe_histogram("h_seconds").observe(1.0)
        pkg.metrics.safe_gauge("g").set(3)
        out = pkg.metrics.get_registry().snapshot()
        pkg.metrics.set_enabled(True)
        pkg.metrics.safe_counter("c_total", api="a").inc(2)
        text = pkg.metrics.get_registry().render_prometheus()
        return out, [x for x in text.splitlines() if "c_total" in x]

    jout, pout = _pair(run)
    assert pout == jout and jout[0] == {}


# -- tracing -----------------------------------------------------------------

TRACEPARENTS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0123456789ABCDEF" * 2 + "-" + "0011223344556677" + "-00",
    " 00-" + "c" * 32 + "-" + "d" * 16 + "-01 ",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "",
    None,
]


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_traceparent_parse_and_format_match(value):
    jctx, pctx = _pair(lambda pkg: pkg.tracing.parse_traceparent(value))
    assert (None if pctx is None else (pctx.trace_id, pctx.span_id,
                                       pctx.parent_id)) == \
        (None if jctx is None else (jctx.trace_id, jctx.span_id,
                                    jctx.parent_id))
    if jctx is not None:
        assert (P.tracing.format_traceparent(pctx)
                == J.tracing.format_traceparent(jctx))


INBOUND = [
    {"traceparent": "00-" + "e" * 32 + "-" + "f" * 16 + "-01"},
    {"Traceparent": "00-" + "e" * 32 + "-" + "f" * 16 + "-01"},
    {"X-Request-Id": "ABCDEF0123456789" * 2},
    {"x-request-id": "not-a-trace-id"},
    {"traceparent": "garbage", "X-Request-Id": "1" * 32},
    {},
]


@pytest.mark.parametrize("headers", INBOUND)
@pytest.mark.parametrize("enabled", [True, False])
def test_context_from_headers_matches(monkeypatch, headers, enabled):
    for pkg in (J, P):
        monkeypatch.setattr(pkg.tracing, "uuid", FakeUuid())
        pkg.metrics.set_enabled(enabled)

    def run(pkg):
        ctx = pkg.tracing.context_from_headers(headers)
        out = {}
        if ctx is not None:
            with pkg.tracing.use(ctx):
                out = pkg.tracing.outbound_headers()
        return (None if ctx is None else
                (ctx.trace_id, ctx.span_id, ctx.parent_id)), out

    jout, pout = _pair(run)
    assert pout == jout
    assert P.tracing.TRACEPARENT_HEADER == J.tracing.TRACEPARENT_HEADER
    assert P.tracing.REQUEST_ID_HEADER == J.tracing.REQUEST_ID_HEADER


def test_slow_request_exemplars_match(monkeypatch):
    def run(pkg):
        pkg.tracing.set_slow_threshold(0.5)
        ctx = pkg.tracing.TraceContext("1" * 32, "2" * 16)
        with pkg.tracing.use(ctx):
            pkg.tracing.maybe_mark_slow("serving_request_seconds", 0.7,
                                        api="a")
            pkg.tracing.maybe_mark_slow("serving_request_seconds", 0.2,
                                        api="a")
        ex = pkg.tracing.get_exemplars()
        snap = pkg.metrics.get_registry().snapshot()["slow_requests_total"]
        pkg.tracing.set_slow_threshold(1.0)
        return [{k: v for k, v in e.items() if k != "ts"} for e in ex], snap

    jout, pout = _pair(run)
    assert pout == jout and len(jout[0]) == 1


# -- flight ring ---------------------------------------------------------------

def test_flight_ring_matches(monkeypatch):
    _clocks(monkeypatch, "flight")

    def run(pkg):
        f = pkg.flight
        prev = f.set_capacity(5)
        try:
            f.set_default_fields(role="worker")
            f.record("drain_begin", api="a", queued=3, inflight=1)
            ctx = pkg.tracing.TraceContext("3" * 32, "4" * 16)
            with pkg.tracing.use(ctx):
                f.record("requeue", api="a", request_id="r1")
            for i in range(5):
                f.record("shed", api="a", reason="queue_full", depth=i)
            full = f.snapshot()
            delta = f.snapshot(since=4)
            f.set_default_fields(role=None)
            return full, delta, f.dropped(), f.capacity()
        finally:
            f.set_capacity(prev)

    jout, pout = _pair(run)
    assert pout == jout
    assert jout[2] == 2 and len(jout[0]["events"]) == 5


# -- logging -------------------------------------------------------------------

def test_log_records_match(monkeypatch, tmp_path):
    clocks = _clocks(monkeypatch, "logging", "flight")
    paths = (tmp_path / "jax.log", tmp_path / "port.log")

    def run(pkg, path, clock):
        lg = pkg.logging
        lg.set_log_file(str(path))
        prev = lg.set_rate_limit(3)
        try:
            log = lg.get_logger("parity.records")
            log.info("worker ready", worker_id="w1", port=8900)
            log.warning("slow batch %d of %s", 3, "api", api="a")
            ctx = pkg.tracing.TraceContext("5" * 32, "6" * 16)
            with pkg.tracing.use(ctx):
                log.error("batch transform failed: %s", "boom",
                          batch_size=4)
            for i in range(6):
                log.info("burst", i=i)
            clock.sleep(1.5)
            log.info("after the window")
            log.debug("below the level")
        finally:
            lg.set_rate_limit(prev)
            lg._reset_for_tests()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        logs = [e for e in pkg.flight.events() if e["kind"] == "log"
                and e["logger"] == "parity.records"]
        dropped = pkg.metrics.get_registry().snapshot()[
            "log_records_dropped_total"]
        return recs, logs, dropped

    jout = run(J, paths[0], clocks[0])
    pout = run(P, paths[1], clocks[1])
    assert [sorted(r) for r in pout[0]] == [sorted(r) for r in jout[0]]
    assert pout == jout
    assert any("suppressed" in r for r in jout[0])


# -- SLO burn rates and the tail reservoir --------------------------------------

SLO_TRAFFIC = ([(0.01, 200)] * 40 + [(0.08, 200)] * 3 + [(0.02, 503)] * 2
               + [(0.5, 504)] + [(0.01, 200)] * 10)


@pytest.mark.parametrize("spec", ["api:p99<25ms,err<1%",
                                  "api:p95<50ms;other:err<0.1%",
                                  "api:err<5%"])
def test_slo_burn_rates_and_tail_reservoir_match(monkeypatch, spec):
    monkeypatch.setenv("MMLSPARK_TPU_TAIL_SAMPLES", "4")
    clocks = _clocks(monkeypatch, "slo", "tailsampler")

    def run(pkg, clock):
        pkg.slo.configure(spec)
        pkg.tailsampler.reset()
        for i, (sec, status) in enumerate(SLO_TRAFFIC):
            stages = {"admission": sec * 0.1, "forming_wait": sec * 0.2,
                      "score": sec * 0.6, "write": sec * 0.1}
            pkg.slo.observe_request("api", sec, status, stages=stages,
                                    trace_id=f"{i:032x}")
            clock.sleep(7.0)
        burns = {w: pkg.slo.current_burn("api", w)
                 for w, _ in pkg.slo.WINDOWS}
        return (burns, pkg.slo.snapshot_payload(),
                pkg.tailsampler.snapshot_payload(),
                {k: v for k, v in pkg.metrics.get_registry().snapshot()
                 .items() if k.startswith(("slo_", "tail_"))})

    jout = run(J, clocks[0])
    pout = run(P, clocks[1])
    assert pout == jout
    assert jout[2]["capacity"] == 4


@pytest.mark.parametrize("spec", ["api:p99<25", "api:err<200%",
                                  "api:p99<1ms,p95<2ms", "nocolon"])
def test_slo_spec_errors_match(spec):
    errs = []
    for pkg in (J, P):
        with pytest.raises(ValueError) as e:
            pkg.slo.parse_spec(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- watchdog ------------------------------------------------------------------

def test_watchdog_stall_detection_matches(monkeypatch, tmp_path):
    """A heartbeat that beats, then wedges, is flagged once per episode in
    both packages; a closed one never is."""
    monkeypatch.setenv("MMLSPARK_TPU_FLIGHT_DIR", str(tmp_path))
    prev = [(pkg.watchdog.set_stall_seconds(0.2),
             pkg.watchdog.set_interval_seconds(0.05)) for pkg in (J, P)]
    release = threading.Event()
    threads = []
    try:
        for pkg in (J, P):
            def loop(pkg=pkg):
                hb = pkg.watchdog.register("parity_loop")
                for _ in range(3):
                    hb.beat()
                release.wait(5)
                hb.close()
            quiet = pkg.watchdog.register("parity_closed")
            quiet.close()
            t = threading.Thread(target=loop, daemon=True)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not all(
                pkg.watchdog.stall_counts().get("parity_loop")
                for pkg in (J, P)):
            time.sleep(0.05)
        time.sleep(0.3)          # a second look inside the same episode
        counts = [pkg.watchdog.stall_counts() for pkg in (J, P)]
        stalls = [[(e["site"], e["beats"]) for e in pkg.flight.events()
                   if e["kind"] == "watchdog_stall"
                   and e["site"].startswith("parity_")] for pkg in (J, P)]
        fams = [pkg.metrics.get_registry().snapshot()[
            "watchdog_stalls_total"] for pkg in (J, P)]
    finally:
        release.set()
        for t in threads:
            t.join(5)
        for pkg, (stall, interval) in zip((J, P), prev):
            pkg.watchdog.stop()
            pkg.watchdog.set_stall_seconds(stall)
            pkg.watchdog.set_interval_seconds(interval)
    assert counts[0] == counts[1] == {"parity_loop": 1}
    assert stalls[0] == stalls[1] == [("parity_loop", 3)]
    assert fams[0] == fams[1]


# -- spans, ledgers ------------------------------------------------------------

def test_spans_match(monkeypatch):
    _clocks(monkeypatch, "spans")

    def run(pkg):
        with pkg.spans.span("Pipeline", metric_label="Pipeline", stage=1):
            with pkg.spans.span("Featurize.uid1") as s:
                s.set(rows=10)
        pkg.spans.instant("round", i=3)
        evs = pkg.spans.get_trace_events()
        return (evs, pkg.metrics.get_registry().snapshot()
                ["span_duration_seconds"],
                [e["name"] for e in pkg.flight.events()
                 if e["kind"] == "span_end"])

    jout, pout = _pair(run)
    assert pout == jout and len(jout[0]) == 3


def test_device_memory_ledger_matches():
    def run(pkg):
        pkg.hbm.claim("aserve_slots", 4096)
        pkg.hbm.claim("binned_cache", 1 << 30)
        pkg.hbm.release("aserve_slots", 1024)
        pkg.hbm.set_claim("bundle", 77)
        pkg.metrics.safe_gauge("device_memory_bytes", device="d0",
                               stat="bytes_in_use").set(2 << 30)
        return (pkg.hbm.claims(), pkg.hbm.total(), pkg.hbm.reconcile(),
                pkg.hbm.snapshot_payload())

    jout, pout = _pair(run)
    assert pout == jout


def test_roofline_ledger_matches_under_env_peaks(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MMLSPARK_TPU_PEAK_BYTES_PER_SECOND", "2e11")

    def run(pkg):
        r = pkg.roofline
        r.register_executable("k" * 40, kind="predict", flops=2e9,
                              bytes_accessed=4e8, compile_seconds=0.5,
                              label="n=32", dtype="f32")
        for s in (0.01, 0.02, 0.015):
            r.observe_call("k" * 40, s)
        r.observe_call("unregistered", 0.001)
        snap = r.snapshot_payload()
        snap.pop("device_kind")
        return snap, {k: v for k, v in pkg.metrics.get_registry()
                      .snapshot().items() if k.startswith("roofline_")}

    jout, pout = _pair(run)
    assert pout == jout


def test_roofline_peaks_for_the_card():
    """The port's table holds the H100 under its ``get_device_name()``
    string, with the peaks chip_smoke.py computes its bounds from; other
    kinds degrade to ratios-only, as the JAX package's do off-TPU."""
    r = P.roofline
    assert r.resolve_peaks()["source"] == "unknown"
    r.note_device_kind("NVIDIA H100 80GB HBM3")
    peaks = r.resolve_peaks()
    assert peaks == {"flops_per_second": r.PEAK_F32_OPS_PER_S,
                     "bytes_per_second": r.PEAK_BYTES_PER_S,
                     "source": "table:NVIDIA H100 80GB HBM3"}
    assert (r.PEAK_BYTES_PER_S, r.PEAK_F32_OPS_PER_S,
            r.PEAK_INT8_OPS_PER_S) == (3.35e12, 67e12, 1979e12)
    assert not any(k.startswith("TPU") for k in r._PEAK_TABLE)
    r.note_device_kind("NVIDIA A100-SXM4-80GB")
    assert r.resolve_peaks()["source"] == "unknown"
    assert sorted(r.snapshot_payload()) == sorted(
        J.roofline.snapshot_payload())


def test_fleet_timeline_merge_matches(monkeypatch):
    _clocks(monkeypatch, "flight")

    def run(pkg):
        for i in range(4):
            pkg.flight.record("span_end", name="serving_request",
                              dur_us=100 + i, trace_id="7" * 32)
        snap = pkg.flight.snapshot()
        snap["events"] = [e for e in snap["events"]
                          if e["kind"] == "span_end"]
        tl = pkg.blackbox.FleetTimeline(capacity=16)
        added = [tl.extend("w1", snap), tl.extend("w1", snap)]
        tl.lifecycle("worker_registered", worker="w1")
        evs = [{k: v for k, v in e.items() if k != "ts"}
               for e in tl.events()]
        return added, evs, tl.trace_ids(), tl.cursor("w1")

    jout, pout = _pair(run)
    assert pout == jout and jout[0] == [4, 0]


# -- the port's device probes ------------------------------------------------

class _FakeCuda:
    def __init__(self, initialized):
        self._init = initialized

    def is_initialized(self):
        return self._init

    def device_count(self):
        return 1

    def get_device_name(self, *a):
        return "NVIDIA H100 80GB HBM3"

    def memory_stats(self, i):
        return {"allocated_bytes.all.current": 1000,
                "allocated_bytes.all.peak": 5000,
                "reserved_bytes.all.current": 8192,
                "allocation.all.allocated": 3}

    def mem_get_info(self, i):
        return (70 << 30, 80 << 30)


def test_device_memory_sampling_waits_for_cuda(monkeypatch):
    """Without CUDA initialised the port samples nothing (no context is
    made to poll memory); once it is, the stats come out under the JAX
    package's stat keys."""
    from mmlspark_tpu_torch.utils import profiling

    monkeypatch.setenv("MMLSPARK_TPU_DEVICE_MEMORY_INTERVAL_SECONDS", "1")
    monkeypatch.setattr(P.device, "_last_sample", 0.0)
    assert not torch.cuda.is_initialized()
    assert profiling.device_memory_stats() == {}
    assert P.device.maybe_sample_device_memory(now=1e9) is False
    assert P.device.device_memory_gauges() == {}

    monkeypatch.setattr(torch, "cuda", _FakeCuda(True))
    stats = profiling.device_memory_stats()
    assert set(stats) == {"cuda:0"}
    assert set(J.device._STAT_KEYS) <= set(stats["cuda:0"])
    assert stats["cuda:0"]["bytes_limit"] == 80 << 30
    assert stats["cuda:0"]["pool_bytes"] == 8192
    assert P.device.maybe_sample_device_memory(now=1e9) is True
    rows = P.metrics.get_registry().snapshot()["device_memory_bytes"][
        "series"]
    assert sorted(r["labels"]["stat"] for r in rows) == sorted(
        J.device._STAT_KEYS)
    assert P.device.maybe_sample_device_memory(now=1e9 + 0.5) is False
    P.roofline.reset()
    assert P.roofline._maybe_device_kind() == "NVIDIA H100 80GB HBM3"


def test_annotate_runs_on_the_cpu():
    from mmlspark_tpu_torch.utils import profiling

    @profiling.annotate_fn("parity_region")
    def work(x):
        return x + 1

    with profiling.annotate("outer"):
        assert work(1) == 2


# -- the env registry ----------------------------------------------------------

_ENV_RE = re.compile(r"MMLSPARK_TPU_[A-Z0-9_]+")
_PKG_DIR = os.path.dirname(os.path.abspath(mmlspark_tpu_torch.__file__))


def _names_read_by_the_port():
    found = {}
    for dirpath, dirnames, filenames in os.walk(_PKG_DIR):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith((".py", ".cpp", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, fn)
            if path.endswith(os.path.join("observability",
                                          "env_registry.py")):
                continue
            for name in _ENV_RE.findall(open(path).read()):
                found.setdefault(name, set()).add(
                    os.path.relpath(path, _PKG_DIR))
    return found


def test_env_registry_covers_every_knob_the_port_reads():
    read = _names_read_by_the_port()
    reg = P.env_registry
    assert {n for n in read if reg.get(n) is None} == set()
    stale = {v.name for v in reg.REGISTRY
             if v.where == "python" and v.name not in read}
    assert stale == set()
    assert all(v.doc for v in reg.REGISTRY)
    assert "MMLSPARK_TPU_HIST_ENGINE" not in reg.names()


def test_env_registry_entries_carry_the_jax_defaults():
    jreg, preg = J.env_registry, P.env_registry
    assert preg.names() <= jreg.names()
    for v in preg.REGISTRY:
        j = jreg.get(v.name)
        assert (v.default, v.section, v.where) == (j.default, j.section,
                                                   j.where)
    edited = {v.name for v in preg.REGISTRY
              if v.doc != jreg.get(v.name).doc}
    assert edited == {"MMLSPARK_TPU_DEVICE_MEMORY_INTERVAL_SECONDS",
                      "MMLSPARK_TPU_SHAP_DEVICE", "MMLSPARK_TPU_BUNDLE_DIR",
                      "MMLSPARK_TPU_TELEMETRY_ROUNDS",
                      "MMLSPARK_TPU_HIST_BLOCKS",
                      "MMLSPARK_TPU_MESH_DEVICES",
                      "MMLSPARK_TPU_BINNED_CACHE"}
    assert preg.render_markdown("robustness").splitlines()[:2] == \
        jreg.render_markdown("robustness").splitlines()[:2]


@pytest.mark.parametrize("raw", ["", "2.5", "7", "nope", None])
def test_env_accessors_match(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("MMLSPARK_TPU_LOG_RATE", raising=False)
    else:
        monkeypatch.setenv("MMLSPARK_TPU_LOG_RATE", raw)
    got = _pair(lambda pkg: (pkg.env_registry.env_float(
        "MMLSPARK_TPU_LOG_RATE", 1.5), pkg.env_registry.env_int(
        "MMLSPARK_TPU_LOG_RATE", 3)))
    assert got[0] == got[1]


def test_to_jsonable_matches():
    from mmlspark_tpu.io.http import to_jsonable as jt
    from mmlspark_tpu_torch.io.http import to_jsonable as pt
    v = {"a": np.float32(0.5), "b": np.arange(3), "c": b"x",
         "d": [np.int64(2), (np.bool_(True), "s")]}
    assert pt(v) == jt(v)
    assert json.dumps(pt(v)) == json.dumps(jt(v))


# -- hooks of the port's main path ---------------------------------------------

@pytest.mark.parametrize("env,requested,kw", [
    ("fp4", None, dict(max_bin=63)),
    (None, "int8", dict(max_bin=0)),
    (None, "bf16", dict(max_bin=63, has_mdec=True)),
    (None, "int8", dict(max_bin=63)),
    (None, "f32", dict(max_bin=0, has_mdec=True)),
])
def test_predict_lane_degrade_events_match(monkeypatch, env, requested, kw):
    """One ``predict_dtype`` flight event per distinct degrade, with the
    JAX package's fields; a repeat resolves silently."""
    from mmlspark_tpu.models.gbdt import quantize as jq
    from mmlspark_tpu_torch.models.gbdt import quantize as pq

    if env is None:
        monkeypatch.delenv("MMLSPARK_TPU_PREDICT_DTYPE", raising=False)
    else:
        monkeypatch.setenv("MMLSPARK_TPU_PREDICT_DTYPE", env)
    got = []
    for q, pkg in ((jq, J), (pq, P)):
        monkeypatch.setattr(q, "_SEEN_DEGRADES", set())
        lanes = [q.resolve_predict_dtype(requested, **kw) for _ in range(3)]
        got.append((lanes, [{k: v for k, v in e.items()
                             if k not in ("ts", "tid")}
                            for e in pkg.flight.events()]))
    assert got[1] == got[0]
    assert len(got[0][1]) == (0 if got[0][0][0] == (requested or env)
                              or requested == "f32" else 1)


@pytest.mark.parametrize("disable", ["0", "1"])
def test_prefetch_hooks_match(monkeypatch, disable):
    """The prefetch wait histogram, chunk counter, ``prefetch_wait`` span
    and ``prefetch:{site}`` heartbeat of both packages, with prefetch on
    and off."""
    from mmlspark_tpu.io import prefetch as jp
    from mmlspark_tpu_torch.io import prefetch as pp

    monkeypatch.setenv("MMLSPARK_TPU_DISABLE_PREFETCH", disable)
    got = []
    for mod, pkg in ((jp, J), (pp, P)):
        beats = []
        out = []
        for v in mod.iter_prefetched((lambda i=i: i * i) for i in range(5)):
            beats.append(sorted(h["site"]
                                for h in pkg.watchdog.heartbeats()
                                if h["site"].startswith("prefetch:")))
            out.append(v)
        snap = pkg.metrics.get_registry().snapshot()
        fams = {k: [(r["labels"], r.get("count", r.get("value")))
                    for r in v["series"]]
                for k, v in snap.items() if k.startswith("streaming_")}
        spans = [e["args"].get("site") for e in pkg.spans.get_trace_events()
                 if e["name"] == "prefetch_wait"]
        got.append((out, beats, fams, spans,
                    sorted(h["site"] for h in pkg.watchdog.heartbeats()
                           if h["site"].startswith("prefetch:"))))
        pkg.watchdog.stop()
    assert got[1] == got[0]
    if disable == "0":
        assert got[0][2]["streaming_prefetch_chunks_total"] == [
            ({"site": "stream"}, 5.0)]
        assert got[0][1][0] == ["prefetch:stream"] and got[0][4] == []


def test_prefetch_chunk_failpoint_matches():
    from mmlspark_tpu.io import prefetch as jp
    from mmlspark_tpu.robustness import failpoints as jfp
    from mmlspark_tpu_torch.io import prefetch as pp
    from mmlspark_tpu_torch.robustness import failpoints as pfp

    got = []
    for mod, fp, pkg in ((jp, jfp, J), (pp, pfp, P)):
        fp.configure("prefetch.chunk:error@3", seed=0)
        out = []
        try:
            for v in mod.iter_prefetched((lambda i=i: i) for i in range(6)):
                out.append(v)
        except fp.InjectedFault as e:
            out.append(("fault", e.site, e.hit))
        finally:
            fp.clear()
            pkg.watchdog.stop()
        got.append((out, [e["kind"] for e in pkg.flight.events()
                          if e["kind"] == "failpoint"]))
    assert got[1] == got[0] == ([0, 1, ("fault", "prefetch.chunk", 3)],
                                ["failpoint"])
