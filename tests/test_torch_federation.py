"""Gateway metrics federation of the port
(``mmlspark_tpu_torch/observability/federation.py``) against the JAX
package's: the same Prometheus texts give equal parse, merge and render
output in both packages, and the ``MetricsFederator`` cases (freshness,
ghost-worker ageing, the autoscale hint, the cluster payload, scrape
health and churn, the disabled sweep) agree with an injected clock.

Each package keeps its own metrics registry; both are reset around every
test, and each federator reads the injected clock through its module's
``time`` attribute.
"""

import pytest

from mmlspark_tpu.observability import federation as jfed
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu_torch.observability import federation as tfed
from mmlspark_tpu_torch.observability import metrics as tmetrics

PKGS = ((jfed, jmetrics), (tfed, tmetrics))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    prev = [m.set_enabled(True) for _, m in PKGS]
    for _, m in PKGS:
        m.reset()
    yield
    for (_, m), p in zip(PKGS, prev):
        m.set_enabled(p)
        m.reset()


TEXTS = {
    "counter_gauge_histogram": (
        "# HELP req_total requests\n# TYPE req_total counter\n"
        'req_total{api="a",code="200"} 5\nreq_total{api="b",code="503"} 1\n'
        "# TYPE depth gauge\ndepth 3.5\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{api="a",le="0.005"} 1\n'
        'lat_seconds_bucket{api="a",le="+Inf"} 2\n'
        'lat_seconds_sum{api="a"} 2.003\nlat_seconds_count{api="a"} 2\n'),
    "escapes": ("# TYPE odd_total counter\n"
                'odd_total{path="a\\"b\\\\c\\nd"} 1\n'),
    "garbage": ("# HELP x whatever\nnot a sample\nx{unclosed 3\n"
                "# TYPE ok counter\nok 2\nok{a=\"1\"} nan\n"
                "# TYPE neg gauge\nneg -Inf\n"),
    "untyped": "free_sample{k=\"v\"} 7\nother 1e-3\n",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_merge_render_equal_jax(name):
    text = TEXTS[name]
    j, t = jfed.parse_prometheus_text(text), tfed.parse_prometheus_text(text)
    assert repr(j) == repr(t)
    jm = jfed.merge_worker_families({"w1": j, "w2": j})
    tm = tfed.merge_worker_families({"w1": t, "w2": t})
    assert repr(jm) == repr(tm)
    assert jfed.render_families(jm) == tfed.render_families(tm)


def test_both_registries_render_texts_that_federate_alike():
    for _, m in PKGS:
        m.counter("reqs_total", api="a", code="200").inc(5)
        m.gauge("depth", api="a").set(3.5)
        h = m.histogram("lat_seconds", api="a")
        h.observe(0.003)
        h.observe(2.0)
        m.counter("odd_total", path='a"b\\c\nd').inc()
    texts = [m.get_registry().render_prometheus() for _, m in PKGS]
    fams = [f.parse_prometheus_text(x) for (f, _), x in zip(PKGS, texts)]
    assert repr(fams[0]) == repr(fams[1])
    kind, rows = fams[1]["lat_seconds"]
    assert kind == "histogram" and rows[0][1]["count"] == 2
    merged = [f.merge_worker_families({"w1": fm, "w2": fm})
              for (f, _), fm in zip(PKGS, fams)]
    assert jfed.render_families(merged[0]) == \
        tfed.render_families(merged[1])


class _Clock:
    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):          # sleep, monotonic, ...
        import time
        return getattr(time, name)


EXPOSITION = (
    "# TYPE serving_queue_depth gauge\n"
    'serving_queue_depth{api="a"} 4\nserving_queue_depth{api="b"} 2\n'
    "# TYPE slo_burn_rate gauge\n"
    'slo_burn_rate{api="a",window="fast5m"} 2.5\n'
    'slo_burn_rate{api="a",window="slow1h"} 0.5\n'
    "# TYPE serving_queue_wait_seconds histogram\n"
    'serving_queue_wait_seconds_bucket{api="a",le="+Inf"} 2\n'
    'serving_queue_wait_seconds_sum{api="a"} 1.0\n'
    'serving_queue_wait_seconds_count{api="a"} 2\n'
    "# TYPE serving_responses_total counter\n"
    'serving_responses_total{api="a",code="200"} 9\n')


def _fleet(fed_mod, monkeypatch):
    clock = _Clock(1_000_000.0)
    monkeypatch.setattr(fed_mod, "time", clock)
    fed = fed_mod.MetricsFederator(lambda: [], interval=1.0)
    for label, age, error in (("live", 0.0, None), ("ghost", 3.2, None),
                              ("stale", 3600.0, None),
                              ("failing", 0.0, "HTTP 500")):
        st = fed._worker(label)
        st.families = fed_mod.parse_prometheus_text(EXPOSITION)
        st.last_success = st.last_attempt = clock.now - age
        st.error = error
        st.consecutive_failures = 0 if error is None else 2
    return fed, clock


def test_federator_feeds_equal_jax_with_an_injected_clock(monkeypatch):
    out = []
    for fed_mod, _ in PKGS:
        fed, clock = _fleet(fed_mod, monkeypatch)
        clock.now += 0.5
        out.append({
            "depth": fed.gauge_values("serving_queue_depth"),
            "burn": fed.gauge_max_values("slo_burn_rate"),
            "burn_wide": fed.gauge_max_values("slo_burn_rate",
                                              max_age=7200),
            "missing": fed.gauge_values("no_such_family"),
            "hint": fed.autoscale_hint(),
            "cluster": fed.cluster_payload(),
            "metrics": fed.render_metrics(),
        })
    assert out[0] == out[1]
    got = out[1]
    # series summed per worker, only fresh and healthy workers
    assert got["depth"] == {"live": 6.0}
    assert got["burn"] == {"live": 2.5}
    assert set(got["burn_wide"]) == {"live", "ghost", "stale"}
    assert got["hint"]["live_workers"] == 1
    assert got["hint"]["workers"]["live"]["queue_wait_mean_seconds"] == 0.5
    assert got["cluster"]["workers"]["failing"]["ok"] is False
    assert b'cluster_serving_responses_total{api="a",code="200"} 36' in \
        got["metrics"]


@pytest.mark.parametrize("pkg", [0, 1], ids=["jax", "port"])
def test_scrape_merge_failure_and_churn(pkg):
    import importlib
    fed_mod, m = PKGS[pkg]
    serving = importlib.import_module(
        ("mmlspark_tpu", "mmlspark_tpu_torch")[pkg] + ".io.serving")
    m.counter("served_total", api="x").inc(4)
    srv = serving.ServingServer("localhost", 0, "x").start()
    targets = [("w1", srv.host, srv.port), ("dead", "localhost", 1)]
    fed = fed_mod.MetricsFederator(lambda: targets, interval=999)
    try:
        fed.scrape_once()
        body = fed.render_metrics().decode()
        assert 'cluster_served_total{api="x",worker="w1"} 4' in body
        assert 'cluster_scrape_ok{worker="w1"} 1' in body
        assert 'cluster_scrape_ok{worker="dead"} 0' in body
        payload = fed.cluster_payload()
        assert payload["workers"]["w1"]["ok"] is True
        assert payload["workers"]["dead"]["ok"] is False
        assert payload["workers"]["dead"]["consecutive_failures"] == 1
        targets[:] = [("w1", srv.host, srv.port)]
        fed.scrape_once()
        assert "dead" not in fed.cluster_payload()["workers"]
    finally:
        fed.stop()
        srv.stop()


@pytest.mark.parametrize("pkg", [0, 1], ids=["jax", "port"])
def test_disabled_sweep_is_inert(pkg):
    import time
    fed_mod, m = PKGS[pkg]
    calls = []
    fed = fed_mod.MetricsFederator(lambda: calls.append(1) or [],
                                   interval=0.05)
    m.set_enabled(False)
    try:
        fed.start()
        time.sleep(0.3)
    finally:
        fed.stop()
        m.set_enabled(True)
    assert calls == []
