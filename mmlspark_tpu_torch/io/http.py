"""HTTP-on-X: embed arbitrary web services as pipeline stages.

The port's copy of ``mmlspark_tpu/io/http.py``, the reference's "HTTP on
Spark" package (reference: io/http/HTTPTransformer.scala:79-129,
Clients.scala:20-48, HTTPClients.scala:20-163, HTTPSchema.scala:26-166,
Parsers.scala:24-215, SimpleHTTPTransformer.scala:64,
PartitionConsolidator.scala:19-108, SharedVariable.scala:18-43). The JVM
mapPartitions + Apache HttpClient machinery becomes a host-side
bounded-concurrency thread pool over stdlib urllib. The device never sees
HTTP: requests and responses are plain columnar data, so an HTTP stage
composes with the port's device stages in one Pipeline.

Design notes vs. the reference:
- ``HTTPRequestData``/``HTTPResponseData`` mirror the Spark struct schema of
  HTTPSchema.scala so saved pipelines carry the same information.
- ``AsyncHTTPClient`` keeps the bounded-buffer semantics of
  Clients.scala:48 (``concurrency`` in-flight requests, results re-ordered to
  input order, ``concurrentTimeout`` wait cap).
- ``advanced_handling`` is HandlingUtils.advancedUDF parity: retry with
  backoff schedule on 429/502/503/504 and connection errors.
- ``to_jsonable`` and the keep-alive :class:`HTTPConnectionPool` also serve
  the port's serving engines and gateway.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (HasErrorCol, HasInputCol, HasOutputCol, Param,
                           TypeConverters)
from ..core.pipeline import PipelineModel, Transformer
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..robustness import failpoints as _failpoints
from ..robustness import policy as _policy

# ---------------------------------------------------------------------------
# Schema (reference: io/http/HTTPSchema.scala:26-166)
# ---------------------------------------------------------------------------


@dataclass
class HTTPRequestData:
    """Full HTTP request as data (HTTPSchema.scala request struct)."""

    url: str
    method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "method": self.method,
            "headers": dict(self.headers),
            "entity": self.entity.decode("utf-8", "replace") if self.entity else None,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HTTPRequestData":
        ent = d.get("entity")
        if isinstance(ent, str):
            ent = ent.encode("utf-8")
        return HTTPRequestData(url=d["url"], method=d.get("method", "GET"),
                               headers=dict(d.get("headers") or {}), entity=ent)


@dataclass
class HTTPResponseData:
    """Full HTTP response as data (HTTPSchema.scala response struct)."""

    status_code: int
    reason: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    @property
    def text(self) -> str:
        return (self.entity or b"").decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.text)

    def to_dict(self) -> Dict[str, Any]:
        return {"statusCode": self.status_code, "reason": self.reason,
                "headers": dict(self.headers), "entity": self.text}


# ---------------------------------------------------------------------------
# SharedVariable (reference: io/http/SharedVariable.scala:18-43)
# ---------------------------------------------------------------------------


class SharedVariable:
    """Lazily-constructed per-process singleton (one instance per process, the
    way the reference shares one HttpClient per executor JVM)."""

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._lock = threading.Lock()
        self._value = None
        self._built = False

    def get(self) -> Any:
        if not self._built:
            with self._lock:
                if not self._built:
                    self._value = self._factory()
                    self._built = True
        return self._value


# ---------------------------------------------------------------------------
# Clients (reference: io/http/Clients.scala:20-48, HTTPClients.scala:20-163)
# ---------------------------------------------------------------------------


class _KeepAliveConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle disabled: on a persistent connection a
    request written as two small segments (headers, then body) hits the
    Nagle/delayed-ACK interaction — a ~40 ms stall PER REQUEST that a
    fresh HTTP/1.0 connection never showed. TCP_NODELAY restores
    sub-millisecond turnaround on the pooled hop."""

    def connect(self):
        super().connect()
        import socket
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class HTTPConnectionPool:
    """Bounded keep-alive pool of ``http.client`` connections per
    (host, port) — the reference shared one Apache ``HttpClient`` (with
    its pooling connection manager) per executor JVM
    (HTTPClients.scala:20); this is the same amortization for the
    framework's hot proxy hop. One TCP handshake serves many requests;
    ``acquire`` hands out an idle pooled connection (``reused=True``) or
    a fresh one, ``release`` returns it for the next request.

    A pooled socket can go stale (the far end closed its keep-alive side
    between requests); callers observe that as a connection-level error
    on a *reused* connection and retry on a fresh one — the gateway's
    ``_exchange`` does exactly this. Connections are never shared
    concurrently: acquire pops, release pushes."""

    def __init__(self, max_per_host: int = 4):
        self.max_per_host = max_per_host
        self._lock = threading.Lock()
        self._idle: Dict[tuple, List[http.client.HTTPConnection]] = {}
        self._closed = False

    def acquire(self, host: str, port: int, timeout: float):
        """``(conn, reused)`` — a pooled keep-alive connection when one
        is idle, else a fresh (not-yet-connected) one."""
        with self._lock:
            stack = self._idle.get((host, port))
            conn = stack.pop() if stack else None
        if conn is not None:
            conn.timeout = timeout
            try:
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
            except OSError:      # fd died while pooled: fall through fresh
                conn.close()
        return _KeepAliveConnection(host, port, timeout=timeout), False

    def release(self, host: str, port: int,
                conn: http.client.HTTPConnection,
                reusable: bool = True) -> None:
        """Return a connection after a fully-read response; it is pooled
        unless the far end announced close (``resp.will_close``) or the
        per-host pool is full."""
        if reusable:
            with self._lock:
                # a release racing close() (an in-flight exchange
                # finishing after the owner stopped) must not repopulate
                # an orphaned pool — that socket would leak forever
                if not self._closed:
                    stack = self._idle.setdefault((host, port), [])
                    if len(stack) < self.max_per_host:
                        stack.append(conn)
                        return
        conn.close()

    def clear(self, host: Optional[str] = None,
              port: Optional[int] = None) -> None:
        """Close idle connections — one host's (a worker that left the
        registry or hard-failed: its pooled sockets are dead weight) or
        all of them."""
        with self._lock:
            if host is None:
                conns = [c for s in self._idle.values() for c in s]
                self._idle.clear()
            else:
                conns = list(self._idle.pop((host, port), ()))
        for c in conns:
            c.close()

    def close(self) -> None:
        """Shut the pool for good: closes every idle connection and
        makes any straggler ``release`` close instead of pool."""
        with self._lock:
            self._closed = True
        self.clear()

    def idle_count(self, host: str, port: int) -> int:
        with self._lock:
            return len(self._idle.get((host, port), ()))


def send_request(request: HTTPRequestData, timeout: float = 60.0) -> HTTPResponseData:
    """One blocking HTTP exchange. Never raises for HTTP-level errors; network
    errors surface as status 0 (the reference encodes failures as null rows —
    we keep the row and signal via statusCode/reason)."""
    # fault site: synthetic exchange failure (error_0 = connection-level,
    # matching the status-0 encoding below) or added latency
    act = _failpoints.fault_point("http.send", url=request.url)
    if act is not None and act.status is not None:
        return HTTPResponseData(status_code=act.status,
                                reason="injected fault")
    req = urllib.request.Request(
        request.url, data=request.entity, method=request.method.upper())
    for k, v in (request.headers or {}).items():
        req.add_header(k, v)
    # propagate the active trace context (a no-op when telemetry is off,
    # outside any request, or when the caller set the header explicitly)
    for k, v in _tracing.outbound_headers().items():
        if not req.has_header(k.capitalize()):
            req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return HTTPResponseData(
                status_code=resp.status, reason=resp.reason or "",
                headers={k.lower(): v for k, v in resp.headers.items()},
                entity=resp.read())
    except urllib.error.HTTPError as e:
        return HTTPResponseData(
            status_code=e.code, reason=str(e.reason),
            headers={k.lower(): v for k, v in (e.headers or {}).items()},
            entity=e.read() if hasattr(e, "read") else None)
    except Exception as e:  # URLError, socket.timeout, ConnectionError...
        return HTTPResponseData(status_code=0, reason=f"{type(e).__name__}: {e}")


RETRY_STATUS = (0, 429, 502, 503, 504)


def advanced_handling(request: HTTPRequestData,
                      backoffs: Optional[Sequence[int]] = (100, 500, 1000),
                      timeout: float = 60.0) -> HTTPResponseData:
    """Retry/backoff handler (reference: io/http/HandlingUtils.advancedUDF —
    retries 429/5xx/connection failures on a millisecond backoff schedule,
    honouring Retry-After when present).

    The schedule stays the API, but each step sleeps ``uniform(0, step)``
    through :func:`robustness.policy.backoff` — a fixed unjittered
    schedule makes synchronized clients retry in lockstep, re-spiking the
    service at exactly the cadence it is trying to shed. A parseable
    ``Retry-After`` overrides the schedule (capped at 30 s); retries are
    counted in ``http_retries_total{reason}``.
    """
    resp = send_request(request, timeout)
    if backoffs is None:
        backoffs = (100, 500, 1000)      # callers may pass an unset param
    for attempt in range(len(backoffs)):
        if resp.status_code not in RETRY_STATUS:
            return resp
        _metrics.safe_counter(
            "http_retries_total",
            reason=("connection" if resp.status_code == 0
                    else str(resp.status_code))).inc()
        _policy.backoff(attempt, schedule_ms=backoffs,
                        retry_after=resp.headers.get("retry-after"))
        resp = send_request(request, timeout)
    return resp


class SingleThreadedHTTPClient:
    """Sequential exchange, input order preserved (Clients.scala:20)."""

    def __init__(self, handler: Callable[[HTTPRequestData], HTTPResponseData] = None):
        self.handler = handler or (lambda r: send_request(r))

    def send(self, requests: Sequence[Optional[HTTPRequestData]]
             ) -> List[Optional[HTTPResponseData]]:
        return [None if r is None else self.handler(r) for r in requests]


class AsyncHTTPClient:
    """Bounded-concurrency exchange, results re-ordered to input order
    (Clients.scala:48 ``AsyncClient`` with ``concurrency`` /
    ``concurrentTimeout`` semantics)."""

    def __init__(self, concurrency: int = 8,
                 concurrent_timeout: Optional[float] = None,
                 handler: Callable[[HTTPRequestData], HTTPResponseData] = None):
        self.concurrency = max(1, int(concurrency))
        self.concurrent_timeout = concurrent_timeout
        self.handler = handler or (lambda r: send_request(r))

    def send(self, requests: Sequence[Optional[HTTPRequestData]]
             ) -> List[Optional[HTTPResponseData]]:
        pool = ThreadPoolExecutor(max_workers=self.concurrency)
        try:
            futures = [None if r is None else pool.submit(self.handler, r)
                       for r in requests]
            # one deadline for the whole exchange, not per-future
            deadline = (None if self.concurrent_timeout is None
                        else time.monotonic() + self.concurrent_timeout)
            out: List[Optional[HTTPResponseData]] = []
            for f in futures:
                if f is None:
                    out.append(None)
                    continue
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                try:
                    out.append(f.result(timeout=remaining))
                except FuturesTimeoutError:
                    # Failures are data, not exceptions (matching send_request):
                    # a timed-out slot becomes a status-0 row, completed
                    # responses are preserved.
                    f.cancel()
                    out.append(HTTPResponseData(
                        status_code=0, reason="concurrentTimeout exceeded"))
        finally:
            # don't block on hung handlers past the deadline
            pool.shutdown(wait=False, cancel_futures=True)
        return out


# ---------------------------------------------------------------------------
# HTTPTransformer (reference: io/http/HTTPTransformer.scala:79-129)
# ---------------------------------------------------------------------------


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Request column -> response column through a shared async client."""

    concurrency = Param("concurrency", "max in-flight requests", 1,
                        TypeConverters.to_int)
    concurrentTimeout = Param("concurrentTimeout",
                              "max seconds to wait on a request", None,
                              TypeConverters.to_float)
    timeout = Param("timeout", "per-request timeout seconds", 60.0,
                    TypeConverters.to_float)
    maxRetries = Param("maxRetries", "retries on 429/5xx/conn errors", 3,
                       TypeConverters.to_int)
    backoffs = Param("backoffs", "explicit retry backoff schedule in ms "
                     "(reference: ComputerVision backoffs); overrides "
                     "maxRetries' exponential default", None,
                     TypeConverters.to_list_int)

    def _client(self):
        n = self.get_or_default("concurrency")
        timeout = self.get_or_default("timeout")
        explicit = self.get_or_default("backoffs")
        retries = self.get_or_default("maxRetries")
        # `is not None`: an explicit [] means DISABLE retries (the
        # reference's empty-Seq semantics), not "use the default"
        backoffs = ([int(b) for b in explicit] if explicit is not None
                    else [100 * (2 ** i) for i in range(retries)])
        handler = lambda r: advanced_handling(r, backoffs, timeout)  # noqa: E731
        if n <= 1:
            return SingleThreadedHTTPClient(handler)
        return AsyncHTTPClient(n, self.get_or_default("concurrentTimeout"), handler)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "response"
        reqs = [r if isinstance(r, (HTTPRequestData, type(None)))
                else HTTPRequestData.from_dict(r)
                for r in dataset[in_col]]
        resps = self._client().send(reqs)
        return dataset.with_column(out_col, list(resps))


# ---------------------------------------------------------------------------
# Parsers (reference: io/http/Parsers.scala:24-215)
# ---------------------------------------------------------------------------


class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Row value -> JSON POST request (Parsers.scala JSONInputParser)."""

    url = Param("url", "endpoint url", None, TypeConverters.to_string)
    method = Param("method", "HTTP method", "POST", TypeConverters.to_string)
    headers = Param("headers", "extra headers", None)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "request"
        url = self.get_or_default("url")
        method = self.get_or_default("method")
        headers = {"Content-Type": "application/json"}
        headers.update(self.get_or_default("headers") or {})
        reqs = []
        for v in dataset[in_col]:
            body = json.dumps(to_jsonable(v)).encode("utf-8")
            reqs.append(HTTPRequestData(url=url, method=method,
                                        headers=dict(headers), entity=body))
        return dataset.with_column(out_col, reqs)


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """Arbitrary row -> HTTPRequestData function (Parsers.scala:24).

    ``udfPython`` is the reference's name for the same slot."""

    def __init__(self, udf: Callable[[Any], HTTPRequestData] = None,
                 udfPython: Callable = None, **kwargs):
        super().__init__(**kwargs)
        self.udf = udf or udfPython

    def set_udf(self, udf) -> "CustomInputParser":
        self.udf = udf
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "request"
        return dataset.with_column(out_col, [self.udf(v) for v in dataset[in_col]])

    def _save_extra(self, path: str) -> None:
        import os
        import pickle
        with open(os.path.join(path, "udf.pkl"), "wb") as f:
            pickle.dump(self.udf, f)

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import load_pickle
        with open(os.path.join(path, "udf.pkl"), "rb") as f:
            self.udf = load_pickle(f)


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response -> parsed JSON (optionally projected by ``dataType`` keys)."""

    postProcessor = Param("postProcessor", "key path into parsed json", None)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "parsed"
        path = self.get_or_default("postProcessor")
        out = []
        for resp in dataset[in_col]:
            if resp is None or resp.entity is None:
                out.append(None)
                continue
            try:
                v = resp.json()
            except ValueError:
                out.append(None)
                continue
            if path:
                for key in path:
                    v = v.get(key) if isinstance(v, dict) else None
                    if v is None:
                        break
            out.append(v)
        return dataset.with_column(out_col, out)


class StringOutputParser(Transformer, HasInputCol, HasOutputCol):
    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "parsed"
        return dataset.with_column(
            out_col, [None if r is None else r.text for r in dataset[in_col]])


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    def __init__(self, udf: Callable[[HTTPResponseData], Any] = None, **kwargs):
        super().__init__(**kwargs)
        self.udf = udf

    def set_udf(self, udf) -> "CustomOutputParser":
        self.udf = udf
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "parsed"
        return dataset.with_column(
            out_col, [None if r is None else self.udf(r) for r in dataset[in_col]])


# ---------------------------------------------------------------------------
# SimpleHTTPTransformer (reference: io/http/SimpleHTTPTransformer.scala:64)
# ---------------------------------------------------------------------------


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol, HasErrorCol):
    """parse -> client -> unparse mini-pipeline with an error column.

    Rows whose exchange fails (non-2xx) get None output and an error struct in
    ``errorCol`` (SimpleHTTPTransformer.scala:21-29 ErrorUtils semantics).
    """

    url = Param("url", "endpoint url (JSON parser shortcut)", None,
                TypeConverters.to_string)
    concurrency = Param("concurrency", "max in-flight requests", 1,
                        TypeConverters.to_int)
    timeout = Param("timeout", "per-request timeout seconds", 60.0,
                    TypeConverters.to_float)
    maxRetries = Param("maxRetries", "retries on 429/5xx/conn errors", 3,
                       TypeConverters.to_int)
    backoffs = Param("backoffs", "explicit retry backoff schedule in ms "
                     "(reference: ComputerVision backoffs); overrides "
                     "maxRetries' exponential default", None,
                     TypeConverters.to_list_int)

    flattenOutputBatches = Param(
        "flattenOutputBatches", "Accepted for reference parity: rows map "
        "1:1 through the exchange here, so there are no output batches to "
        "flatten", None, TypeConverters.to_bool)

    def __init__(self, input_parser: Transformer = None,
                 output_parser: Transformer = None,
                 inputParser: Transformer = None,
                 outputParser: Transformer = None, **kwargs):
        super().__init__(**kwargs)
        # camelCase kwargs mirror the reference's param names
        self.input_parser = input_parser or inputParser
        self.output_parser = output_parser or outputParser

    def set_input_parser(self, p) -> "SimpleHTTPTransformer":
        self.input_parser = p
        return self

    def set_output_parser(self, p) -> "SimpleHTTPTransformer":
        self.output_parser = p
        return self

    def _pipeline(self) -> PipelineModel:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "output"
        inp = self.input_parser or JSONInputParser().set(
            url=self.get_or_default("url"))
        inp.set(inputCol=in_col, outputCol="_http_request")
        http = HTTPTransformer().set(
            inputCol="_http_request", outputCol="_http_response",
            concurrency=self.get_or_default("concurrency"),
            timeout=self.get_or_default("timeout"),
            maxRetries=self.get_or_default("maxRetries"),
            backoffs=self.get_or_default("backoffs"))
        outp = self.output_parser or JSONOutputParser()
        outp.set(inputCol="_http_response", outputCol=out_col)
        return PipelineModel([inp, http, outp])

    def transform(self, dataset: Dataset) -> Dataset:
        err_col = self.get_or_default("errorCol") or "error"
        out_col = self.get_or_default("outputCol") or "output"
        out = self._pipeline().transform(dataset)
        errors, values = [], list(out[out_col])
        for i, resp in enumerate(out["_http_response"]):
            if resp is None or not (200 <= resp.status_code < 300):
                errors.append(None if resp is None else resp.to_dict())
                values[i] = None  # error payloads never masquerade as output
            else:
                errors.append(None)
        return (out.drop("_http_request", "_http_response")
                .with_columns({out_col: values, err_col: errors}))

    def _save_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import _save_stage_list
        parsers = [p for p in (self.input_parser, self.output_parser) if p is not None]
        _save_stage_list(parsers, os.path.join(path, "parsers"))
        with open(os.path.join(path, "parser_slots.json"), "w") as f:
            json.dump({"input": self.input_parser is not None,
                       "output": self.output_parser is not None}, f)

    def _load_extra(self, path: str) -> None:
        import os
        from ..core.pipeline import _load_stage_list
        with open(os.path.join(path, "parser_slots.json")) as f:
            slots = json.load(f)
        parsers = _load_stage_list(os.path.join(path, "parsers"))
        it = iter(parsers)
        self.input_parser = next(it) if slots["input"] else None
        self.output_parser = next(it) if slots["output"] else None


# ---------------------------------------------------------------------------
# PartitionConsolidator (reference: io/http/PartitionConsolidator.scala:19-108)
# ---------------------------------------------------------------------------


class PartitionConsolidator(Transformer, HasInputCol, HasOutputCol):
    """Funnel many shards' rows through one shared rate-limited service holder.

    In the columnar runtime "partitions" are row-shards of one host array, so
    consolidation is inherent: the whole column already flows through this one
    stage instance serially (one consumer per host), which is all the
    reference's per-executor SharedSingleton machinery existed to guarantee.
    """

    def __init__(self, fn: Callable[[Any], Any] = None, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn or (lambda v: v)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or in_col
        return dataset.with_column(
            out_col, [self.fn(v) for v in dataset[in_col]])


def to_jsonable(v: Any) -> Any:
    """numpy scalars/arrays, bytes, containers -> JSON-able python values.
    Shared by the JSON parsers, serving replies, and the PowerBI writer."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, dict):
        return {k: to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_jsonable(x) for x in v]
    return v
