"""Serving a port ``Booster``: both port engines against both JAX engines.

One small JAX booster (2,000 x 6 rows, 5 rounds, a fixed seed) is carried
over with ``booster_from_jax_arrays`` and saved by each package; each
package serves its copy on port 0 — the async engine through
``serving_main._build_async_query`` (rows into the slot table), the
threaded engine through ``_load_transform`` behind ``ServingServer`` — the
port with ``device="cpu"``. For the same requests the two must give the
same reply bodies (within 1e-5), status codes (a bad body, a shed with
``Retry-After``, an expired deadline), ``X-Request-Id`` echo, debug routes
and payload keys, metric families, labels and counter values, a drain
without errors and the ``serving.batch`` requeue-once sequence. The slot
tables of the narrow lanes are checked as tensors, against the JAX
package's buffers byte for byte and against the port's own ``predict``.

Every server binds port 0 on ``localhost``; every client connection has a
10 s timeout; threads are joined with timeouts; servers stop in fixture
finalisers.
"""

import http.client
import json
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.io import aserve as jaserve
from mmlspark_tpu.io import serving as jserving
from mmlspark_tpu.io import serving_main as jmain
from mmlspark_tpu.io.aserve import slots as jslots
from mmlspark_tpu.models.gbdt import quantize as jquant
from mmlspark_tpu.models.gbdt.api import \
    LightGBMClassificationModel as JClassificationModel
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.observability import flight as jflight
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.robustness import failpoints as jfp
from mmlspark_tpu_torch.core.dataset import Dataset as PDataset
from mmlspark_tpu_torch.io import aserve as paserve
from mmlspark_tpu_torch.io import serving as pserving
from mmlspark_tpu_torch.io import serving_main as pmain
from mmlspark_tpu_torch.io.aserve import slots as pslots
from mmlspark_tpu_torch.models.gbdt import quantize as pquant
from mmlspark_tpu_torch.models.gbdt.api import \
    LightGBMClassificationModel as PClassificationModel
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.observability import flight as pflight
from mmlspark_tpu_torch.observability import metrics as pmetrics
from mmlspark_tpu_torch.robustness import failpoints as pfp

torch.set_num_threads(1)

TIMEOUT = 10.0
MAX_BATCH = 8
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"

J = SimpleNamespace(name="jax", serving=jserving, aserve=jaserve,
                    main=jmain, metrics=jmetrics, flight=jflight, fp=jfp,
                    Dataset=JDataset, kw={})
P = SimpleNamespace(name="port", serving=pserving, aserve=paserve,
                    main=pmain, metrics=pmetrics, flight=pflight, fp=pfp,
                    Dataset=PDataset, kw={"device": "cpu"})
PKGS = (J, P)
ENGINES = ("async", "threaded")


# -- the model ------------------------------------------------------------------

@pytest.fixture(scope="module")
def model(tmp_path_factory):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    jb = jtrain(X, y, objective="binary", num_iterations=5, max_bin=63,
                cfg=JGrowConfig(num_leaves=15, min_data_in_leaf=20),
                mesh=make_mesh(devices=jax.devices()[:1]))
    fields = {f: np.asarray(getattr(jb.trees, f)) for f in jb.trees._fields}
    pb = booster_from_jax_arrays(
        fields, jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state)
    d = tmp_path_factory.mktemp("serving_models")
    jpath, ppath = str(d / "jax.npz"), str(d / "port.npz")
    jb.save(jpath)
    pb.save(ppath)
    rows = rng.normal(size=(64, 6)).astype(np.float32)
    rows[3, 2] = np.nan
    return SimpleNamespace(jb=jb, pb=pb, X=X, rows=rows,
                           path={"jax": jpath, "port": ppath})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_PREDICT_DTYPE", raising=False)
    monkeypatch.delenv("MMLSPARK_TPU_SERVING_ENGINE", raising=False)
    monkeypatch.delenv("MMLSPARK_TPU_ASERVE_SLOTS", raising=False)
    prev = [pkg.metrics.set_enabled(True) for pkg in PKGS]
    for pkg in PKGS:
        pkg.metrics.reset()
        pkg.flight.clear()
        pkg.fp.clear()
        pkg.serving.set_ready(True)
    yield
    for pkg, was in zip(PKGS, prev):
        pkg.fp.clear()
        pkg.metrics.reset()
        pkg.flight.clear()
        pkg.metrics.set_enabled(was)


def _worker(pkg, engine, model, **overrides):
    """A started query serving ``model`` the way a worker does."""
    args = pmain.worker_args(model.path[pkg.name], host="localhost",
                             port=0, max_batch=MAX_BATCH, **overrides)
    if engine == "async":
        q, _ = pkg.main._build_async_query(args, **pkg.kw)
        return q.start()
    tf, _ = pkg.main._load_transform(args.model, args.input_col,
                                     args.output_col, max_batch=MAX_BATCH,
                                     **pkg.kw)
    server = pkg.serving.ServingServer(
        "localhost", 0, args.api_name,
        max_queue_depth=args.max_queue_depth)
    return pkg.serving.ServingQuery(server, tf, max_batch=MAX_BATCH,
                                    max_latency=0.005).start()


@pytest.fixture
def stopper():
    """Queries registered here stop in the finaliser."""
    queries = []
    yield queries.append
    for q in queries:
        q.stop()


@pytest.fixture(params=ENGINES)
def pair(request, model, stopper):
    qs = [_worker(pkg, request.param, model) for pkg in PKGS]
    for q in qs:
        stopper(q)
    return request.param, qs


def _call(q, path, body=None, headers=None, method=None):
    conn = http.client.HTTPConnection(q.server.host, q.server.port,
                                      timeout=TIMEOUT)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        conn.request(method or ("POST" if body is not None else "GET"),
                     path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _row(x):
    return {"features": [None if np.isnan(v) else float(v) for v in x]}


def _until(cond, timeout=TIMEOUT):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _responses(pkg):
    fam = pkg.metrics.get_registry().snapshot().get(
        "serving_responses_total") or {"series": []}
    return {r["labels"]["code"]: r["value"] for r in fam["series"]}


# -- replies ---------------------------------------------------------------------

def test_reply_bodies_match(pair, model):
    engine, qs = pair
    got = []
    for q in qs:
        out = []
        for x in model.rows[:24]:
            status, body, hdrs = _call(q, "/serving", _row(x))
            assert status == 200, body
            assert hdrs["Content-Type"] == "application/json"
            out.append(json.loads(body)["prediction"])
        got.append(np.asarray(out))
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-5)
    want = model.pb.predict(model.rows[:24], device="cpu")
    np.testing.assert_array_equal(got[1], want.astype(np.float64))


def test_concurrent_replies_match(pair, model):
    engine, qs = pair
    rows = model.rows[:32]
    results = []
    for q in qs:
        out = [None] * len(rows)

        def client(idx, q=q, out=out):
            conn = http.client.HTTPConnection(q.server.host, q.server.port,
                                              timeout=TIMEOUT)
            try:
                for i in idx:
                    conn.request("POST", "/serving",
                                 json.dumps(_row(rows[i])).encode())
                    r = conn.getresponse()
                    out[i] = (r.status, json.loads(r.read()))
            finally:
                conn.close()

        ts = [threading.Thread(target=client, args=(range(k, 32, 4),))
              for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT)
        assert all(o is not None and o[0] == 200 for o in out)
        results.append(np.asarray([o[1]["prediction"] for o in out]))
    np.testing.assert_allclose(results[1], results[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        results[1], model.pb.predict(rows, device="cpu"))


BAD = {
    "not_json": (b"{not json", {}),
    "no_features": ({"other": [1.0]}, {}),
    "short_row": ({"features": [1.0, 2.0]}, {}),
    "expired_deadline": (None, {"X-Deadline-Ms": "0"}),
    "bad_deadline": (None, {"X-Deadline-Ms": "soon"}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_status_codes_match(pair, model, case):
    engine, qs = pair
    body, headers = BAD[case]
    if body is None:
        body = _row(model.rows[0])
    got = [_call(q, "/serving", body, headers) for q in qs]
    if engine == "threaded" and case == "short_row":
        # the JAX predict program scores a row of the wrong width (its
        # gather clamps out-of-range feature ids); the port's predict
        # refuses it, so the batch fails twice and answers 500
        assert (got[0][0], got[1][0]) == (200, 500)
        return
    assert got[1][0] == got[0][0]
    if got[0][0] != 200:
        assert json.loads(got[1][1]).keys() == json.loads(got[0][1]).keys()
    want = {"expired_deadline": 504, "bad_deadline": 200}.get(case)
    if want is not None:
        assert got[0][0] == want
    elif engine == "async":
        assert got[0][0] == 400


@pytest.mark.parametrize("headers,echo", [
    ({"traceparent": TRACEPARENT}, TRACE_ID),
    ({"X-Request-Id": TRACE_ID.upper()}, TRACE_ID),
    ({}, None),
])
def test_request_id_echo_matches(pair, model, headers, echo):
    engine, qs = pair
    got = []
    for q in qs:
        status, _, hdrs = _call(q, "/serving", _row(model.rows[1]), headers)
        assert status == 200
        got.append(hdrs.get("X-Request-Id"))
    if echo is None:
        assert all(g is not None and len(g) == 32 for g in got)
    else:
        assert got == [echo, echo]


# -- debug routes and metrics ------------------------------------------------------

def _route_keys(route, payload):
    keys = set(payload)
    if route == "healthz":
        keys -= {"device_note"}          # the port's CPU run has no CUDA
    return keys


def test_debug_routes_and_payload_keys_match(pair, model):
    engine, qs = pair
    assert pserving.DEBUG_ROUTES == jserving.DEBUG_ROUTES
    _call(qs[0], "/serving", _row(model.rows[0]), {"traceparent":
                                                    TRACEPARENT})
    _call(qs[1], "/serving", _row(model.rows[0]), {"traceparent":
                                                    TRACEPARENT})
    for name, path in jserving.DEBUG_ROUTES:
        for full in (path, "/serving" + path):
            if name == "trace":
                full += f"?id={TRACE_ID}"
            got = [_call(q, full) for q in qs]
            assert [g[0] for g in got] == [200, 200], (full, got)
            ctypes = [g[2]["Content-Type"] for g in got]
            assert ctypes[0] == ctypes[1]
            if name == "metrics":
                continue
            payloads = [json.loads(g[1]) for g in got]
            assert _route_keys(name, payloads[1]) == _route_keys(
                name, payloads[0]), full
            if name == "varz":
                assert payloads[1]["config"].keys() == \
                    payloads[0]["config"].keys()
                assert payloads[1]["config"]["predict_dtype"] == "f32"
                assert "torch" in payloads[1]["build"]
    health = json.loads(_call(qs[1], "/healthz")[1])
    assert health["ready"] is True and health["status"] == "ok"
    assert (health["devices"], health["platform"]) == (None, None)


_TYPE_RE = re.compile(r"^# TYPE (\S+) (\S+)$", re.M)
# families of the model's executable cache and its roofline producers,
# and the ledger site of its packed trees: the JAX package's alone (the
# port has no predict plan yet)
_JAX_ONLY = ("gbdt_", "placement_", "predict_", "roofline_")


def _serving_families(snap):
    out = {k: v for k, v in snap.items() if not k.startswith(_JAX_ONLY)}
    if "hbm_ledger_bytes" in out:
        series = [r for r in out["hbm_ledger_bytes"]["series"]
                  if r["labels"].get("site") != "packed_trees"]
        out["hbm_ledger_bytes"] = {**out["hbm_ledger_bytes"],
                                   "series": series}
        if not series:
            del out["hbm_ledger_bytes"]
    return out


def test_metric_families_labels_and_counts_match(pair, model):
    engine, qs = pair
    for q in qs:
        for x in model.rows[:5]:
            assert _call(q, "/serving", _row(x))[0] == 200
        _call(q, "/serving", _row(model.rows[0]), {"X-Deadline-Ms": "0"})
        _call(q, "/healthz")
    for pkg in PKGS:
        assert _until(lambda pkg=pkg: sum(_responses(pkg).values()) >= 6
                      and "debug_requests_total"
                      in pkg.metrics.get_registry().snapshot())
    snaps = [_serving_families(pkg.metrics.get_registry().snapshot())
             for pkg in PKGS]
    fams = [set(s) for s in snaps]
    assert fams[1] == fams[0]
    for name in fams[0]:
        labels = [sorted({tuple(sorted(r["labels"])) for r in
                          s[name]["series"]}) for s in snaps]
        assert labels[1] == labels[0], name
        assert snaps[1][name]["type"] == snaps[0][name]["type"]
    assert _responses(P) == _responses(J) == {"200": 5.0, "504": 1.0}
    for name in ("serving_deadline_dropped_total", "debug_requests_total"):
        assert snaps[1][name]["series"] == snaps[0][name]["series"], name
    texts = [_call(q, "/metrics")[1].decode() for q in qs]
    types = [{m for m in _TYPE_RE.findall(t) if m[0] in fam}
             for t, fam in zip(texts, fams)]
    assert types[1] == types[0]
    assert {name for name, _ in types[0]} == fams[0]


# -- shed, drain, requeue ------------------------------------------------------------

class Gate:
    """A transform that holds each batch until released."""

    def __init__(self):
        self.open = threading.Event()

    def __call__(self, ds):
        self.open.wait(TIMEOUT)
        return ds.with_column("reply", [
            {"entity": {"i": (v or {}).get("i")}, "statusCode": 200}
            for v in ds["value"]])


def _gated(pkg, engine, gate, **kw):
    if engine == "async":
        server = pkg.aserve.AsyncServingServer("localhost", 0, "gated",
                                               slots=1, **kw)
        return pkg.aserve.AsyncServingQuery(server, transform=gate).start()
    server = pkg.serving.ServingServer("localhost", 0, "gated", **kw)
    return pkg.serving.ServingQuery(server, gate, max_batch=1,
                                    max_latency=0.005).start()


def _send_async(q, body, out, i, headers=None):
    def run():
        out[i] = _call(q, "/gated", body, headers)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _shed_run(pkg, engine, stopper):
    gate = Gate()
    q = _gated(pkg, engine, gate, max_queue_depth=1)
    stopper(q)
    out = [None] * 6
    threads = []
    admitted = 0
    try:
        for i in range(6):
            threads.append(_send_async(q, {"i": i}, out, i))
            ok = _until(lambda: q.server.inflight_count() > admitted
                        or out[i] is not None, timeout=3)
            assert ok
            if out[i] is not None:
                break
            admitted += 1
    finally:
        gate.open.set()
        for t in threads:
            t.join(TIMEOUT)
    shed = [o for o in out if o is not None and o[0] == 429]
    assert len(shed) == 1, out
    status, body, hdrs = shed[0]
    served = sorted(o[0] for o in out if o is not None and o[0] != 429)
    # a handler counts its response after the client has it: wait for
    # the count of every reply the clients read
    _until(lambda: sum(_responses(pkg).values()) >= len(served) + 1)
    return admitted, status, body, int(hdrs["Retry-After"]), served, \
        _responses(pkg)


@pytest.mark.parametrize("engine", ENGINES)
def test_shed_matches(engine, stopper):
    got = [_shed_run(pkg, engine, stopper) for pkg in PKGS]
    assert got[1] == got[0]
    admitted, status, body, retry_after, served, _ = got[0]
    assert status == 429 and retry_after >= 1
    assert served == [200] * admitted


def _drain_run(pkg, engine, stopper):
    gate = Gate()
    q = _gated(pkg, engine, gate)
    stopper(q)
    out = [None] * 4
    threads = [_send_async(q, {"i": i}, out, i) for i in range(4)]
    assert _until(lambda: q.server.inflight_count() == 4)
    stats = {}
    drainer = threading.Thread(target=lambda: stats.update(
        q.drain(settle_seconds=0.0, timeout=TIMEOUT)), daemon=True)
    drainer.start()
    assert _until(lambda: q.server.draining)
    late = _call(q, "/gated", {"i": 99})
    gate.open.set()
    for t in threads:
        t.join(TIMEOUT)
    drainer.join(TIMEOUT)
    return ([o[0] for o in out], late[0], "Retry-After" in late[2],
            {k: stats[k] for k in ("clean", "requests_served",
                                   "leftover_inflight")},
            [e["kind"] for e in pkg.flight.events()
             if e["kind"].startswith("drain")])


@pytest.mark.parametrize("engine", ENGINES)
def test_drain_matches(engine, stopper):
    got = [_drain_run(pkg, engine, stopper) for pkg in PKGS]
    assert got[1] == got[0]
    statuses, late, retry_after, stats, kinds = got[0]
    assert statuses == [200] * 4 and late == 503 and retry_after
    assert stats == {"clean": True, "requests_served": 4,
                     "leftover_inflight": 0}
    assert kinds == ["drain_begin", "drain_complete"]


def _failure_counts(pkg):
    snap = pkg.metrics.get_registry().snapshot()
    return tuple(sum(r["value"] for r in snap.get(n, {"series": []})[
        "series"]) for n in ("serving_batch_failures_total",
                             "serving_requeues_total"))


@pytest.mark.parametrize("spec,want_status,want_counts", [
    ("serving.batch:error@1", 200, (1.0, 1.0)),
    ("serving.batch:error", 500, (2.0, 1.0)),
])
def test_requeue_once_matches(pair, model, spec, want_status, want_counts):
    engine, qs = pair
    got = []
    for pkg, q in zip(PKGS, qs):
        pkg.fp.configure(spec, seed=0)
        status, body, _ = _call(q, "/serving", _row(model.rows[2]))
        pkg.fp.clear()
        assert _until(lambda pkg=pkg: _failure_counts(pkg) == want_counts)
        kinds = [e["kind"] for e in pkg.flight.events()
                 if e["kind"] in ("failpoint", "batch_error", "requeue")]
        got.append((status, _failure_counts(pkg), kinds))
        if status == 200:
            np.testing.assert_allclose(
                json.loads(body)["prediction"],
                model.pb.predict(model.rows[2:3], device="cpu")[0],
                rtol=0, atol=1e-5)
    assert got[1] == got[0]
    assert got[0][:2] == (want_status, want_counts)


# -- lanes and slot tables -------------------------------------------------------

@pytest.mark.parametrize("lane", ["f32", "bf16", "int8"])
def test_slot_tables_as_tensors(model, lane):
    """The port's slot table holds host tensors in the lane's staged dtype,
    byte for byte the JAX package's numpy buffers; a bucket view scores as
    the port's own predict of the raw rows in that lane."""
    rows = model.rows[:5]
    ub = pquant.feature_bounds(model.pb.binner_state)
    tables = (jslots.SlotTable(8, 6, jquant.staging_dtype(lane),
                               jquant.row_quantizer(lane, ub)),
              pslots.SlotTable(8, 6, pquant.staging_dtype(lane),
                               pquant.row_quantizer(lane, ub)))
    views = []
    for t in tables:
        for i, x in enumerate(rows):
            t.write(i, x)
        buf = t.flip()
        view, b = t.bucket_view(buf, len(rows))
        assert b == 8
        views.append(view)
        t.release_claim()
    jv, pv = views
    assert isinstance(pv, torch.Tensor) and pv.device.type == "cpu"
    assert pv.dtype == pquant.staging_dtype(lane)
    if lane == "bf16":
        jbits = jv.view(np.uint16)
        pbits = pv.view(torch.int16).numpy().view(np.uint16)
        nan = np.isnan(jv.astype(np.float32))
        assert np.array_equal(nan, torch.isnan(pv).numpy())
        assert np.array_equal(jbits[~nan], pbits[~nan])
    else:
        assert np.array_equal(jv, pv.numpy(), equal_nan=lane == "f32")
    assert torch.equal(pv[5:], pv[:1].expand(3, -1))
    if lane == "f32":
        assert bool(torch.isnan(pv[3, 2]))
    got = model.pb.predict(pv, device="cpu", predict_dtype=lane)[:5]
    want = model.pb.predict(rows, device="cpu", predict_dtype=lane)
    np.testing.assert_array_equal(got, want)


def test_slot_table_pins_memory_only_for_cuda(monkeypatch):
    seen = []
    real = torch.zeros

    def spy(*a, **kw):
        seen.append(kw.get("pin_memory"))
        kw["pin_memory"] = False
        return real(*a, **kw)

    monkeypatch.setattr(pslots.torch, "zeros", spy)
    pslots.SlotTable(4, 3, torch.float32).release_claim()
    pslots.SlotTable(4, 3, torch.float32, pin_memory=True).release_claim()
    assert seen == [False, False, True, True]


@pytest.mark.parametrize("lane", ["bf16", "int8"])
def test_async_lanes_match(monkeypatch, model, stopper, lane):
    """With the lane pinned, admission stages rows in the lane's dtype;
    replies equal the port's own predict in that lane, and the JAX
    package's within 1e-5. (Rows without nulls: the JAX bf16 lane answers
    400 to a JSON null feature, which its f32 lane and the port read as
    NaN.)"""
    monkeypatch.setenv("MMLSPARK_TPU_PREDICT_DTYPE", lane)
    rows = model.rows[4:20]
    got = []
    for pkg in PKGS:
        q = _worker(pkg, "async", model)
        stopper(q)
        assert q.server.row_spec.dtype in (jquant.staging_dtype(lane),
                                           pquant.staging_dtype(lane))
        out = [json.loads(_call(q, "/serving", _row(x))[1])["prediction"]
               for x in rows]
        got.append(np.asarray(out))
        varz = json.loads(_call(q, "/varz")[1])
        assert varz["config"]["predict_dtype"] == lane
    want = model.pb.predict(rows, device="cpu", predict_dtype=lane)
    np.testing.assert_array_equal(got[1], want)
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-5)
    placement = [e for e in pflight.events() if e["kind"] == "placement"]
    assert placement[-1]["dtype"] == {"bf16": "bfloat16",
                                      "int8": "uint8"}[lane]


def test_pipeline_threaded_matches_transform(model, stopper):
    """``serve().pipeline(model)`` on the threaded engine: replies are the
    classification model's probability vectors, as ``transform`` gives
    them, in both packages."""
    models = (JClassificationModel(model.jb, numClasses=2),
              PClassificationModel(model.pb, numClasses=2, device="cpu"))
    rows = model.rows[:12]
    got = []
    for pkg, m in zip(PKGS, models):
        q = (pkg.serving.serve().address("localhost", 0, "cls")
             .batch(MAX_BATCH, 5.0).engine("threaded")
             .pipeline(m, input_col="features", output_col="probability")
             .start())
        stopper(q)
        out = [json.loads(_call(q, "/cls", [float(v) for v in x])[1])
               for x in rows]
        want = m.transform(pkg.Dataset({"features": rows}))["probability"]
        np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                                   rtol=0, atol=1e-6)
        got.append(np.asarray(out))
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-5)


# -- engine selection and the worker wiring -----------------------------------------

@pytest.mark.parametrize("requested,env", [(None, None), ("async", None),
                                           ("threaded", None),
                                           (None, "threaded"),
                                           (None, "uvloop")])
def test_engine_resolution_matches(monkeypatch, requested, env):
    if env is not None:
        monkeypatch.setenv("MMLSPARK_TPU_SERVING_ENGINE", env)
    got = []
    for pkg in PKGS:
        got.append((pkg.aserve.resolve_engine(requested),
                    pkg.metrics.get_registry().snapshot(),
                    [{k: v for k, v in e.items() if k not in ("ts", "tid",
                                                              "logger")}
                     for e in pkg.flight.events() if e["kind"] != "log"]))
    assert got[1] == got[0]
    assert paserve.DEFAULT_ENGINE == jaserve.DEFAULT_ENGINE == "async"
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.aserve.resolve_engine("uvloop")


def test_worker_wiring_warms_and_defaults_to_cuda(model, monkeypatch):
    """The port's worker wiring takes ``device`` (None -> cuda, which
    raises without a GPU) and uploads the model's forest before it
    returns, building no predict program (a bundle's prewarm, or the first
    request of each bucket, captures those)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pmain.worker_args(model.path["port"], host="localhost")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pmain._build_async_query(args)
    calls = []
    real = model.pb.__class__.predict

    def spy(self, X, *a, **kw):
        calls.append((np.shape(X), kw.get("device")))
        return real(self, X, *a, **kw)

    monkeypatch.setattr(model.pb.__class__, "predict", spy)
    from mmlspark_tpu_torch.models.gbdt import booster as pbooster
    pbooster._PREDICT_CACHE.clear()
    q, b = pmain._build_async_query(args, device="cpu")
    q.server.slot_table.release_claim()
    assert calls == []
    assert list(b._plan_forest) == [("cpu", b.num_trees, "f32")]
    assert len(pbooster._PREDICT_CACHE) == 0
    assert b.num_trees == model.pb.num_trees
    with pytest.raises(TypeError):
        pmain.worker_args("m.npz", nonsense=1)
    assert vars(pmain.worker_args("m.npz")) == {
        "model": "m.npz", "host": "0.0.0.0", "port": 0,
        "api_name": "serving", "input_col": "features",
        "output_col": "prediction", "max_batch": 32,
        "max_latency_ms": 5.0, "max_queue_depth": None}
