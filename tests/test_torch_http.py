"""The port's HTTP stages, Power BI writer and port forwarder
(``mmlspark_tpu_torch/io``) against the JAX package's, on local stub
servers.

Every exchange runs through both packages against the same server: the
same response bodies, outputs, error-column structs and retry counts
(``http_retries_total``). Persistence: a stage saved by either package
loads in the port. Then the port's ``SimpleHTTPTransformer`` drives the
port's own async serving worker on the CPU: the replies equal
``booster.predict(device="cpu")``, and a row of the wrong width lands in
``errorCol`` while the rest succeed.
"""

import json
import socket
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mmlspark_tpu.io as jio
from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.core.pipeline import save_stage as jsave_stage
from mmlspark_tpu.io import port_forwarding as jpf
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.robustness import policy as jpolicy
import mmlspark_tpu_torch.io as tio
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import load_stage, save_stage
from mmlspark_tpu_torch.io import port_forwarding as tpf
from mmlspark_tpu_torch.io import serving_main as pmain
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.robustness import policy as tpolicy

torch.set_num_threads(1)

PKGS = (SimpleNamespace(name="port", io=tio, D=Dataset, metrics=tmetrics,
                        policy=tpolicy, pf=tpf),
        SimpleNamespace(name="jax", io=jio, D=JDataset, metrics=jmetrics,
                        policy=jpolicy, pf=jpf))


class _State:
    fail_next = 0        # respond 503 this many times before succeeding
    posted = []          # bodies received on /collect
    lock = threading.Lock()


class _Handler(BaseHTTPRequestHandler):
    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def do_POST(self):
        body = self._body()
        if self.path == "/double":
            v = json.loads(body)
            self._send(200, json.dumps({"result": v["x"] * 2}))
        elif self.path == "/flaky":
            with _State.lock:
                if _State.fail_next > 0:
                    _State.fail_next -= 1
                    self._send(503, "try later")
                    return
            self._send(200, json.dumps({"ok": True}))
        elif self.path == "/collect":
            with _State.lock:
                _State.posted.append(body)
            self._send(200, "{}")
        elif self.path == "/slow":
            time.sleep(0.5)
            self._send(200, "{}")
        else:
            self._send(404, "nope")

    def do_GET(self):
        if self.path.startswith("/hello"):
            self._send(200, json.dumps({"greeting": "hi"}))
        else:
            self._send(404, "nope")

    def _send(self, code, text):
        payload = text.encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def url():
    httpd = ThreadingHTTPServer(("localhost", 0), _Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(autouse=True)
def _metrics_on():
    prev = [p.metrics.set_enabled(True) for p in PKGS]
    for p in PKGS:
        p.metrics.reset()
    yield
    for p, was in zip(PKGS, prev):
        p.metrics.reset()
        p.metrics.set_enabled(was)


def both(fn):
    """``fn(pkg)`` for the port, then the JAX package."""
    return [fn(p) for p in PKGS]


def _err(e):
    """An error struct without the response's Date header (the two
    packages' exchanges may straddle a second)."""
    if e is None:
        return None
    return dict(e, headers={k: v for k, v in e["headers"].items()
                            if k != "date"})


def _resp(r):
    return None if r is None else (r.status_code, r.entity)


def test_send_request_roundtrip(url):
    def run(p):
        r = p.io.send_request(p.io.HTTPRequestData(
            url=f"{url}/double", method="POST",
            headers={"Content-Type": "application/json"},
            entity=json.dumps({"x": 21}).encode()))
        return r.status_code, r.json(), r.text
    t, j = both(run)
    assert t == j == (200, {"result": 42}, '{"result": 42}')


def test_send_request_connection_error():
    t, j = both(lambda p: p.io.send_request(
        p.io.HTTPRequestData(url="http://localhost:9/none"), timeout=2))
    assert t.status_code == j.status_code == 0
    assert t.reason and type(t.reason) is type(j.reason)


def test_advanced_handling_retries_and_counts(url, monkeypatch):
    def run(p):
        monkeypatch.setattr(p.policy, "backoff", lambda attempt, **kw: 0.0)
        _State.fail_next = 2
        r = p.io.advanced_handling(
            p.io.HTTPRequestData(url=f"{url}/flaky", method="POST",
                                 entity=b"{}"), backoffs=(10, 10, 10))
        refused = p.io.advanced_handling(
            p.io.HTTPRequestData(url="http://localhost:1/refused"),
            backoffs=(1, 1))
        return (r.status_code, r.json(), refused.status_code,
                p.metrics.counter("http_retries_total", reason="503").value,
                p.metrics.counter("http_retries_total",
                                  reason="connection").value)
    t, j = both(run)
    assert t == j == (200, {"ok": True}, 0, 2.0, 2.0)
    # the retry budget runs out: the last 503 is returned
    _State.fail_next = 5
    t, j = both(lambda p: p.io.advanced_handling(
        p.io.HTTPRequestData(url=f"{url}/flaky", method="POST",
                             entity=b"{}"), backoffs=(1,)).status_code)
    _State.fail_next = 0
    assert t == j == 503


def test_async_client_preserves_order_and_timeout(url):
    def run(p):
        reqs = [p.io.HTTPRequestData(
            url=f"{url}/double", method="POST",
            headers={"Content-Type": "application/json"},
            entity=json.dumps({"x": i}).encode()) for i in range(20)]
        reqs[5] = None
        out = p.io.AsyncHTTPClient(concurrency=8).send(reqs)
        slow = p.io.AsyncHTTPClient(concurrency=2, concurrent_timeout=0.1
                                    ).send([p.io.HTTPRequestData(
                                        url=f"{url}/slow", method="POST",
                                        entity=b"{}")])[0]
        single = p.io.SingleThreadedHTTPClient().send(reqs[:3])
        return ([_resp(r) for r in out], (slow.status_code, slow.reason),
                [_resp(r) for r in single])
    t, j = both(run)
    assert t == j
    assert t[0][5] is None and t[0][7] == (200, b'{"result": 14}')
    assert t[1] == (0, "concurrentTimeout exceeded")


def test_shared_variable_single_construction():
    counter = {"n": 0}

    def factory():
        counter["n"] += 1
        return object()

    sv = tio.SharedVariable(factory)
    results = []
    threads = [threading.Thread(target=lambda: results.append(sv.get()))
               for _ in range(8)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert counter["n"] == 1
    assert all(r is results[0] for r in results)


def test_http_transformer(url):
    def run(p):
        reqs = [p.io.HTTPRequestData(url=f"{url}/hello") for _ in range(3)]
        reqs.append({"url": f"{url}/hello", "method": "GET"})
        out = p.io.HTTPTransformer().set(
            inputCol="req", outputCol="resp", concurrency=4).transform(
                p.D({"req": reqs}))
        return [_resp(r) for r in out["resp"]], out.columns
    t, j = both(run)
    assert t == j
    assert t[0] == [(200, b'{"greeting": "hi"}')] * 4


def test_simple_http_transformer_json_and_error_col(url):
    def run(p):
        good = (p.io.SimpleHTTPTransformer()
                .set(inputCol="payload", outputCol="out", errorCol="err",
                     url=f"{url}/double", concurrency=2)
                .transform(p.D({"payload": [{"x": 1}, {"x": 7}]})))
        bad = (p.io.SimpleHTTPTransformer()
               .set(inputCol="payload", outputCol="out", errorCol="err",
                    url=f"{url}/missing", backoffs=[])
               .transform(p.D({"payload": [{"x": 1}]})))
        return (good.columns, list(good["out"]), list(good["err"]),
                list(bad["out"]), [_err(e) for e in bad["err"]])
    t, j = both(run)
    assert t == j
    assert [v["result"] for v in t[1]] == [2, 14] and t[2] == [None, None]
    assert t[3] == [None] and t[4][0]["statusCode"] == 404
    assert t[4][0]["entity"] == "nope"


def test_custom_parsers_and_postprocessor(url):
    def run(p):
        inp = p.io.CustomInputParser(udf=lambda v: p.io.HTTPRequestData(
            url=f"{url}/double", method="POST",
            headers={"Content-Type": "application/json"},
            entity=json.dumps({"x": int(v)}).encode()))
        outp = p.io.CustomOutputParser(udf=lambda r: r.json()["result"])
        custom = (p.io.SimpleHTTPTransformer(input_parser=inp,
                                             output_parser=outp)
                  .set(inputCol="x", outputCol="y", errorCol="err")
                  .transform(p.D({"x": np.array([3, 4])})))
        post = (p.io.SimpleHTTPTransformer(
                    output_parser=p.io.JSONOutputParser().set(
                        postProcessor=["result"]))
                .set(inputCol="v", outputCol="out", errorCol="err",
                     url=f"{url}/double")
                .transform(p.D({"v": [{"x": 5}]})))
        text = (p.io.SimpleHTTPTransformer(
                    output_parser=p.io.StringOutputParser())
                .set(inputCol="v", outputCol="out", errorCol="err",
                     url=f"{url}/double")
                .transform(p.D({"v": [{"x": np.float32(2.5)}]})))
        return list(custom["y"]), list(post["out"]), list(text["out"])
    t, j = both(run)
    assert t == j == ([6, 8], [10], ['{"result": 5.0}'])


def test_json_input_parser_and_consolidator():
    def run(p):
        reqs = (p.io.JSONInputParser()
                .set(inputCol="v", outputCol="r", url="http://h/x",
                     headers={"X-K": "1"})
                .transform(p.D({"v": [{"a": np.int64(3)},
                                      np.arange(2.0)]})))
        cons = (p.io.PartitionConsolidator(fn=lambda v: v * 10)
                .set(inputCol="n").transform(p.D({"n": np.arange(3)})))
        return [r.to_dict() for r in reqs["r"]], list(cons["n"])
    t, j = both(run)
    assert t == j
    assert t[0][0] == {"url": "http://h/x", "method": "POST",
                       "headers": {"Content-Type": "application/json",
                                   "X-K": "1"}, "entity": '{"a": 3}'}
    assert tio.HTTPRequestData.from_dict(t[0][1]).entity == b"[0.0, 1.0]"


def test_simple_http_transformer_persistence(tmp_path, url):
    """A stage saved by either package loads in the port and gives the
    port's outputs."""
    stages = both(lambda p: (p.io.SimpleHTTPTransformer(
        output_parser=p.io.StringOutputParser())
        .set(inputCol="v", outputCol="out", errorCol="err",
             url=f"{url}/double")))
    save_stage(stages[0], str(tmp_path / "t"))
    jsave_stage(stages[1], str(tmp_path / "j"))
    for d in ("t", "j"):
        t2 = load_stage(str(tmp_path / d))
        assert type(t2) is tio.SimpleHTTPTransformer
        assert type(t2.output_parser) is tio.StringOutputParser
        assert t2.input_parser is None
        out = t2.transform(Dataset({"v": [{"x": 2}]}))
        assert json.loads(out["out"][0]) == {"result": 4}


def test_powerbi_writer(url):
    def run(p):
        _State.posted.clear()
        n = p.io.write_to_powerbi(
            p.D({"a": np.arange(5), "b": ["x"] * 5}), f"{url}/collect",
            batch_size=2)
        once = [json.loads(b) for b in _State.posted]
        _State.posted.clear()
        w = p.io.PowerBIWriter(f"{url}/collect", batch_size=3)
        w.write(p.D({"a": np.arange(4), "b": ["y"] * 4}))
        w.flush()
        streamed = [json.loads(b) for b in _State.posted]
        _State.posted.clear()
        p.io.write_to_powerbi(p.D({"a": np.arange(7)}), f"{url}/collect",
                              batch_size=2, concurrency=3)
        concurrent = sorted(r["a"] for b in _State.posted
                            for r in json.loads(b))
        with pytest.raises(IOError, match="PowerBI write failed"):
            p.io.write_to_powerbi(p.D({"a": np.arange(2)}),
                                  f"{url}/missing")
        return n, once, streamed, concurrent
    t, j = both(run)
    assert t == j
    assert t[0] == 3 and sum(len(b) for b in t[1]) == 5
    assert [len(b) for b in t[2]] == [3, 1]
    assert t[3] == list(range(7))


def _echo_server():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def echo():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            data = c.recv(1 << 16)
            c.sendall(b"echo:" + data)
            c.close()

    threading.Thread(target=echo, daemon=True).start()
    return srv


def _relay(port, payload):
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.sendall(payload)
    c.shutdown(socket.SHUT_WR)
    got = b""
    while True:
        chunk = c.recv(1 << 16)
        if not chunk:
            break
        got += chunk
    c.close()
    return got


def test_port_forwarder_round_trip():
    srv = _echo_server()
    try:
        def run(p):
            with p.pf.PortForwarder("127.0.0.1",
                                    srv.getsockname()[1]) as fwd:
                return [_relay(fwd.local_port, m) for m in (b"hello",
                                                            b"world")]
        t, j = both(run)
        assert t == j == [b"echo:hello", b"echo:world"]
    finally:
        srv.close()


def test_port_forwarder_stop_severs_and_restarts():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    fwd = tpf.PortForwarder("127.0.0.1", srv.getsockname()[1]).start()
    c = socket.create_connection(("127.0.0.1", fwd.local_port), timeout=5)
    up, _ = srv.accept()
    c.sendall(b"x")
    assert up.recv(16) == b"x"
    fwd.stop()
    # the established relay is severed: the client sees EOF, not a hang
    c.settimeout(5)
    assert c.recv(16) == b""
    c.close()
    up.close()
    fwd.start()
    c2 = socket.create_connection(("127.0.0.1", fwd.local_port), timeout=5)
    up2, _ = srv.accept()
    c2.sendall(b"y")
    assert up2.recv(16) == b"y"
    fwd.stop()
    c2.close()
    up2.close()
    srv.close()


def test_ssh_forward_builds_the_jax_command(monkeypatch):
    seen = []

    def fake_popen(cmd, *a, **k):
        seen.append(cmd)
        return SimpleNamespace()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    both(lambda p: p.pf.ssh_forward("bastion", "db.internal", 5432, 15432,
                                    ssh_user="ops", key_file="/k",
                                    extra_args=["-v"]))
    assert seen[0] == seen[1]
    assert seen[0][:2] == ["ssh", "-N"] and seen[0][-1] == "ops@bastion"
    assert "15432:db.internal:5432" in seen[0]


def test_simple_http_transformer_on_the_ports_worker(tmp_path):
    """The port's client against the port's async worker on the CPU: each
    reply equals ``booster.predict(device="cpu")``; the row of the wrong
    width is an error row; a PortForwarder in between changes nothing."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    booster = train_booster(X, (X[:, 0] + X[:, 1] > 0).astype(np.float32),
                            objective="binary", num_iterations=3,
                            device="cpu")
    path = str(tmp_path / "m.npz")
    booster.save(path)
    rows = rng.normal(size=(40, 6)).astype(np.float32)
    args = pmain.worker_args(path, host="localhost", port=0, max_batch=8)
    q, _ = pmain._build_async_query(args, device="cpu")
    q.start()
    try:
        values = [{"features": [float(v) for v in r]} for r in rows]
        values[7] = {"features": [1.0, 2.0]}
        ds = Dataset({"value": values})
        base = f"http://localhost:{q.server.port}"
        outs = []
        with tpf.PortForwarder("localhost", q.server.port) as fwd:
            for u, conc in ((base, 1), (base, 16),
                            (f"http://127.0.0.1:{fwd.local_port}", 4)):
                outs.append(tio.SimpleHTTPTransformer().set(
                    inputCol="value", outputCol="reply", errorCol="err",
                    url=f"{u}/serving", concurrency=conc, backoffs=[])
                    .transform(ds))
        want = booster.predict(rows, device="cpu")
        for out in outs:
            err = list(out["err"])
            assert err[7]["statusCode"] == 400 and out["reply"][7] is None
            assert all(e is None for i, e in enumerate(err) if i != 7)
            got = np.asarray([r["prediction"] for i, r in
                              enumerate(out["reply"]) if i != 7])
            np.testing.assert_allclose(got, np.delete(want, 7, axis=0)
                                       .reshape(got.shape), rtol=0,
                                       atol=1e-6)
        assert list(outs[0]["reply"]) == list(outs[1]["reply"]) \
            == list(outs[2]["reply"])
    finally:
        q.stop()
