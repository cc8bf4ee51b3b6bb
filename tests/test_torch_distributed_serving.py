"""Distributed serving of the port (``mmlspark_tpu_torch/io/
distributed_serving.py``): the scenarios of ``tests/test_distributed_
serving.py`` run on a port fleet and on a JAX fleet, and their status codes
and replies compared (replies within 1e-6).

Each scenario returns what a client sees — the status and body of every
request — plus the counters it pins; the port's must equal the JAX
package's. The real-model scenario serves the same forest in both (a JAX
booster carried into the port) from two in-process workers on one
Booster under concurrent clients; the port's replies must also equal its
eager body bit for bit, which holds the predictor cache's per-entry lock
to its contract.
"""

import http.client
import importlib
import json
import socket as socketlib
import threading
import time

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)

PKGS = ("mmlspark_tpu", "mmlspark_tpu_torch")


def _mods(pkg):
    return (importlib.import_module(pkg + ".io.distributed_serving"),
            importlib.import_module(pkg + ".observability.metrics"))


def _transform(ds):
    return ds.with_column(
        "reply", [{"entity": {"y": (v or {}).get("x", 0.0) * 2},
                   "statusCode": 200} for v in ds["value"]])


def _post(host, port, path, payload):
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("POST", path, body=json.dumps(payload))
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, json.loads(body) if body else None


def _both(scenario):
    """Run ``scenario(ds_module, metrics_module)`` for each package."""
    return [scenario(*_mods(pkg)) for pkg in PKGS]


def _spread(dsm, _m):
    d = dsm.DistributedServing(_transform, num_workers=3).start()
    try:
        out = [_post(d.gateway.host, d.gateway.port, "/serving", {"x": i})
               for i in range(30)]
        served = [q.requests_served for q in d.workers]
        deadline = time.monotonic() + 5
        while sum(served) < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
            served = [q.requests_served for q in d.workers]
        return out, sum(served), all(s > 0 for s in served)
    finally:
        d.stop()


def test_requests_spread_across_workers():
    j, t = _both(_spread)
    assert t == j
    assert t[1:] == (30, True)
    assert all(s == 200 and b["y"] == i * 2 for i, (s, b) in enumerate(t[0]))


def _crash(dsm, _m):
    d = dsm.DistributedServing(_transform, num_workers=2).start()
    try:
        first = _post(d.gateway.host, d.gateway.port, "/serving", {"x": 1})
        d.kill_worker(0)
        out = [_post(d.gateway.host, d.gateway.port, "/serving", {"x": i})
               for i in range(12)]
        return [first] + out, d.gateway.failovers >= 1, \
            d.workers[1].requests_served >= 12
    finally:
        d.stop()


def test_worker_crash_fails_over():
    j, t = _both(_crash)
    assert t == j
    assert t[1:] == (True, True)
    assert {s for s, _ in t[0]} == {200}


def _no_workers(dsm, _m):
    g = dsm.GatewayServer(dsm.ServiceRegistry()).start()
    try:
        return _post(g.host, g.port, "/serving", {"x": 1})[0]
    finally:
        g.stop()


def test_no_workers_gives_503():
    assert _both(_no_workers) == [503, 503]


def _routing(dsm, _m):
    fed_mod = importlib.import_module(
        dsm.__name__.rsplit(".io.", 1)[0] + ".observability.federation")
    reg = dsm.ServiceRegistry()
    reg.register(dsm.WorkerInfo("deep", "localhost", 1111))
    reg.register(dsm.WorkerInfo("shallow", "localhost", 2222))
    g = dsm.GatewayServer(reg)
    try:
        fed = g.federation
        now = time.time()
        for label, depth in (("localhost:1111", 7.0),
                             ("localhost:2222", 1.0)):
            st = fed._worker(label)
            st.families = fed_mod.parse_prometheus_text(
                "# TYPE serving_queue_depth gauge\n"
                f'serving_queue_depth{{api="serving"}} {depth}\n')
            st.last_success = st.last_attempt = now
        picks = [{g._pick().worker_id for _ in range(10)}]
        g._inflight["localhost:2222"] = 9
        picks.append({g._pick().worker_id for _ in range(10)})
        g._inflight.clear()
        fed._worker("localhost:2222").last_success = now - 3600
        g._inflight["localhost:2222"] = 5
        picks.append({g._pick().worker_id for _ in range(10)})
        return picks
    finally:
        g._httpd.server_close()


def test_load_aware_routing_prefers_shallow_queue():
    j, t = _both(_routing)
    assert t == j == [{"shallow"}, {"deep"}, {"deep"}]


def test_file_registry_cross_instance(tmp_path):
    """A port registry and a JAX registry on one directory see each
    other's workers: one file format."""
    from mmlspark_tpu.io.distributed_serving import ServiceRegistry as JReg
    from mmlspark_tpu_torch.io.distributed_serving import (ServiceRegistry,
                                                           WorkerInfo)
    r1, r2 = ServiceRegistry(str(tmp_path)), JReg(str(tmp_path))
    r1.register(WorkerInfo("w1", "localhost", 1234))
    r2.register(_mods("mmlspark_tpu")[0].WorkerInfo("w2", "localhost", 1235))
    assert {w.worker_id for w in r1.workers()} == \
        {w.worker_id for w in r2.workers()} == {"w1", "w2"}
    r1.deregister("w2")
    assert {w.worker_id for w in r2.workers()} == {"w1"}


def _pooling(dsm, m):
    d = dsm.DistributedServing(_transform, num_workers=2).start()
    try:
        before = m.counter("gateway_connection_reuse_total",
                           api="serving").value
        out = [_post(d.gateway.host, d.gateway.port, "/serving", {"x": i})
               for i in range(8)]
        reuse = m.counter("gateway_connection_reuse_total",
                          api="serving").value - before
        gw = d.gateway
        stale0 = m.counter("gateway_stale_connections_total",
                           api="serving").value
        fail0 = m.counter("gateway_failovers_total", api="serving").value
        with gw._pool._lock:
            for conns in gw._pool._idle.values():
                for c in conns:
                    if c.sock is not None:
                        c.sock.shutdown(socketlib.SHUT_RDWR)
        out += [_post(d.gateway.host, d.gateway.port, "/serving",
                      {"x": 100 + i}) for i in range(4)]
        stale = m.counter("gateway_stale_connections_total",
                          api="serving").value - stale0
        failovers = m.counter("gateway_failovers_total",
                              api="serving").value - fail0
        closed = {b.state for _, b in gw.breakers.items()}
        return out, reuse >= 6, stale >= 1, failovers, len(closed)
    finally:
        d.stop()


def test_connections_reused_and_stale_sockets_retry_cleanly():
    j, t = _both(_pooling)
    assert t == j
    assert t[1:] == (True, True, 0, 1)


@pytest.fixture(scope="module")
def regressors():
    from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
    from mmlspark_tpu.models.gbdt.growth import GrowConfig
    from mmlspark_tpu.parallel.mesh import make_mesh
    from mmlspark_tpu_torch.models.gbdt.convert import \
        booster_from_jax_arrays
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    y = (X @ np.array([1., -2., 0.5, 0.])).astype(np.float32)
    jb = jtrain(X, y, objective="regression", num_iterations=5,
                cfg=GrowConfig(num_leaves=7, min_data_in_leaf=5),
                mesh=make_mesh(devices=jax.devices()[:1]))
    tb = booster_from_jax_arrays(
        {k: np.asarray(v) for k, v in jb.trees._asdict().items()},
        jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state)
    return jb, tb, X


def _real_model(dsm, _m, predict, X):
    def transform(ds):
        rows = np.asarray([v["features"] for v in ds["value"]], np.float32)
        return ds.with_column("reply", [
            {"entity": {"p": float(p)}, "statusCode": 200}
            for p in predict(rows)])

    d = dsm.DistributedServing(transform, num_workers=2).start()
    out = [None] * 40
    try:
        def client(seed):
            for i in range(seed, 40, 4):
                out[i] = _post(d.gateway.host, d.gateway.port, "/serving",
                               {"features": X[i].tolist()})

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        return out
    finally:
        d.stop()


def test_real_model_on_two_workers_under_concurrent_clients(regressors):
    jb, tb, X = regressors
    j = _real_model(*_mods("mmlspark_tpu"), jb.predict, X)
    t = _real_model(*_mods("mmlspark_tpu_torch"),
                    lambda r: tb.predict(r, device="cpu"), X)
    assert [s for s, _ in t] == [s for s, _ in j] == [200] * 40
    got = np.asarray([b["p"] for _, b in t])
    np.testing.assert_allclose(got, [b["p"] for _, b in j], rtol=0,
                               atol=1e-6)
    # each row's reply equals the eager body's score of that row
    eager = tb.predict_raw_tensor(torch.from_numpy(X[:40]))[:, 0].numpy()
    assert got.tolist() == [float(v) for v in eager]
