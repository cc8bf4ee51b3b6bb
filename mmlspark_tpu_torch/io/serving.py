"""Serving: deploy any pipeline as a low-latency web service.

Counterpart of ``mmlspark_tpu/io/serving.py`` (the reference's "Spark
Serving" subsystem: org/apache/spark/sql/execution/streaming/
HTTPSource.scala:31-216, DistributedHTTPSource.scala:26-420,
HTTPSourceV2.scala:45-700, HTTPSinkV2.scala:21-107,
ServingUDFs.scala:16-20, io/IOImplicits.scala:19-80), serving a port
model on one GPU:

- ``ServingServer``: a threaded HTTP front-end that assigns each request an id
  and parks the client's socket on an event (the "routing table": reply is
  routed back to exactly the open socket that accepted it, id-keyed, like
  WorkerServer.replyTo at HTTPSourceV2.scala:516-534).
- Deadline-driven micro-batching (``maxBatchSize`` / ``maxLatency``). On the
  ``.pipeline(model)`` path, batches are padded to power-of-two buckets, so
  the model sees a bounded set of batch shapes.
- ``ServingQuery``: the streaming-query analog; a worker thread pulls batches,
  runs the user's Dataset -> Dataset transform, and replies by id. Unanswered
  requests from a crashed batch are re-queued once (the historyQueues
  crash-recovery analog, HTTPSourceV2.scala:470-483,545-560).

This module also holds what both engines share (the async engine in
``io/aserve`` imports it): the debug routes and their payloads, the
response funnel, the bucket ladder and ``requests_to_dataset``. Metric
families, labels, span names and ``MMLSPARK_TPU_*`` knobs are the JAX
package's, so dashboards and configs carry over.

Fluent entry (IOImplicits parity)::

    query = (serve()                      # spark.readStream.server()
             .address("localhost", 8898, "my_api")
             .batch(max_batch=32, max_latency_ms=5)
             .transform(my_fn)            # Dataset -> Dataset with 'reply' col
             .reply_to("reply")           # writeStream.server().replyTo
             .start())
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from ..core.dataset import Dataset
from ..observability import blackbox as _blackbox
from ..observability import device as _device
from ..observability import flight as _flight
from ..observability import hbm as _hbm
from ..observability import metrics as _metrics
from ..observability import roofline as _roofline
from ..observability import slo as _slo
from ..observability import spans as _spans
from ..observability import tailsampler as _tailsampler
from ..observability import tracing as _tracing
from ..observability import watchdog as _watchdog
from ..observability.logging import get_logger
from ..robustness import failpoints as _failpoints
from ..robustness import policy as _policy
from .. import tuning as _tuning
from .http import to_jsonable

logger = get_logger("mmlspark_tpu_torch.io.serving")

#: paths (relative to the server root) answered with the Prometheus text
#: rendering of the global registry instead of entering the request queue
METRICS_PATH = "/metrics"
#: liveness + device presence, answered in-band like /metrics
HEALTHZ_PATH = "/healthz"
#: registry JSON + build/config info + slow-request exemplars
VARZ_PATH = "/varz"
#: the flight recorder's ring buffer as JSON
FLIGHT_PATH = "/debug/flight"
#: per-worker scrape health + staleness + last failover (gateway
#: federation view; answers with a "no federation" note elsewhere)
CLUSTER_PATH = "/debug/cluster"
#: roofline + device-memory ledgers: per-executable achieved FLOP/s / bytes/s
#: vs backend peaks, plus named device-memory claims
ROOFLINE_PATH = "/debug/roofline"
#: fleet scale-pressure signal derived from federated queue telemetry
#: (gateway; answers with a "no federation" note elsewhere)
AUTOSCALE_PATH = "/debug/autoscale"
#: declared objectives + multi-window error-budget burn (both engines;
#: the gateway adds the federated per-worker burn view)
SLO_PATH = "/debug/slo"
#: bounded reservoir of objective-breaching request stage timelines
TAIL_PATH = "/debug/tail"
#: auto-tuner decisions + the evidence behind them (tuning store view)
TUNING_PATH = "/debug/tuning"
#: fleet black-box: every worker's flight deltas + lifecycle transitions
#: merged in causal order (gateway federation view; a "no federation"
#: note elsewhere)
TIMELINE_PATH = "/debug/timeline"
#: one stitched edge→gateway→worker trace (``?id=<trace_id>``; the
#: gateway assembles from the fleet timeline, a worker answers with its
#: own hop only)
TRACE_PATH = "/debug/trace"

#: (route name, path) table shared by the serving server and the gateway
DEBUG_ROUTES = (
    ("metrics", METRICS_PATH),
    ("healthz", HEALTHZ_PATH),
    ("varz", VARZ_PATH),
    ("flight", FLIGHT_PATH),
    ("cluster", CLUSTER_PATH),
    ("roofline", ROOFLINE_PATH),
    ("autoscale", AUTOSCALE_PATH),
    ("slo", SLO_PATH),
    ("tail", TAIL_PATH),
    ("tuning", TUNING_PATH),
    ("timeline", TIMELINE_PATH),
    ("trace", TRACE_PATH),
)


def render_metrics() -> bytes:
    """Prometheus text exposition of the process-wide registry."""
    return _metrics.get_registry().render_prometheus().encode("utf-8")


def debug_route(method: str, path: str, api_name: str) -> Optional[str]:
    """Which in-band debug endpoint (if any) a request addresses:
    ``"metrics"`` / ``"healthz"`` / ``"varz"`` / ``"flight"`` — each also
    reachable under ``/{api_name}`` — or None for normal traffic. Shared
    by ``ServingServer`` and the distributed-serving gateway so the path
    normalization and alias set stay defined in exactly one place."""
    if method != "GET":
        return None
    path_only = path.split("?", 1)[0].rstrip("/") or "/"
    for name, route in DEBUG_ROUTES:
        if path_only in (route, f"/{api_name}{route}"):
            return name
    return None


def debug_query(path: str) -> Dict[str, str]:
    """Single-valued query params of a debug request path (the cursor
    grammar ``/debug/flight?since=<seq>`` and ``/debug/trace?id=<id>``
    ride on). ``debug_route`` drops the query before matching, so both
    engines parse it here — one grammar, last value wins."""
    query = urllib.parse.urlsplit(path).query
    return {k: v[-1] for k, v in
            urllib.parse.parse_qs(query).items() if v}


def write_http_response(handler: BaseHTTPRequestHandler, status: int,
                        payload: bytes = b"",
                        headers: Optional[Dict[str, str]] = None,
                        counter: Optional[str] = None,
                        **labels: Any) -> None:
    """The single funnel every ``io/`` HTTP handler's bytes leave
    through: status line, headers, Content-Length, body, and (when
    ``counter`` is given) a per-status-code counter — so no handler
    branch can silently skip accounting. ``tests/test_lint.py`` rejects
    direct ``send_response`` calls anywhere else under ``io/``."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    handler.send_response(status)
    for k, v in (headers or {}).items():
        handler.send_header(k, v)
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)
    if counter:
        _metrics.safe_counter(counter, code=str(status), **labels).inc()


# -- readiness gate ---------------------------------------------------------
# Liveness ("the process answers") and readiness ("route traffic here") are
# different questions for a rolling fleet: a worker prewarming its predictor
# cache from an AOT bundle is alive but must not take traffic yet, or the
# rollout routes requests onto a cold compiler. serving_main flips this gate
# False before prewarm and True only once the worker is warmed, bound, and
# about to register; processes that never gate (tests, ad-hoc serve()) stay
# ready by default.
_ready = True


def set_ready(ready: bool) -> None:
    """Flip the process-wide readiness gate surfaced on ``/healthz``."""
    global _ready
    _ready = bool(ready)
    _metrics.safe_gauge("serving_ready").set(1 if ready else 0)


def is_ready() -> bool:
    return _ready


# the worker's RESOLVED predict lane ("f32"/"bf16"/"int8"), surfaced on
# /varz so operators can confirm which lane a fleet actually runs (env
# typos and capability degrades resolve to f32 silently otherwise —
# only a flight event records the degrade). None until a worker pins it.
_predict_dtype: Optional[str] = None


def set_predict_dtype(dtype: Optional[str]) -> None:
    """Record the worker's resolved predict lane for ``/varz``
    (serving_main pins it once at startup, after resolution)."""
    global _predict_dtype
    _predict_dtype = dtype


_device_probe: Optional[Dict[str, Any]] = None


def _probe_devices() -> Dict[str, Any]:
    """Device presence for /healthz, without side effects.

    Only probes when this process has already initialised CUDA (a worker
    serving a model on the card has; a pure gateway process has not — and
    creating a device context there would contend for a card the
    colocated workers own). The platform is ``"gpu"``, the name the JAX
    package gives the same card, so a probe config reads the same key.
    Successful probes are cached: the device set of a live process
    doesn't change, and liveness checks arrive often. Failures are NOT
    cached — a sick runtime should keep reporting degraded until it
    recovers."""
    global _device_probe
    if _device_probe is not None:
        return _device_probe
    if not _device.cuda_initialized():
        return {"devices": None, "platform": None,
                "device_note": "CUDA not initialised in this process"}
    try:
        import torch
        count = torch.cuda.device_count()
        _device_probe = {"devices": count,
                         "platform": "gpu" if count else None}
        return _device_probe
    except Exception as e:  # noqa: BLE001 — degraded, but still alive
        return {"status": "degraded", "devices": 0,
                "device_error": f"{type(e).__name__}: {e}"}


def healthz_payload() -> Dict[str, Any]:
    """Liveness + device presence. Device enumeration is best-effort: a
    health probe must answer even when the accelerator runtime is sick —
    that is precisely when operators probe it."""
    info: Dict[str, Any] = {"status": "ok", "ready": is_ready(),
                            "pid": os.getpid(), "time": time.time()}
    info.update(_probe_devices())
    return info


def varz_payload(api_name: str, federation: Optional[Any] = None
                 ) -> Dict[str, Any]:
    """Registry JSON + build/config info + slow-request exemplars (the
    ``/varz`` body; name after the Google-style debug endpoint). On a
    federating gateway, also the cluster scrape-health section."""
    from .. import __version__
    build: Dict[str, Any] = {"version": __version__,
                             "python": sys.version.split()[0]}
    torch = sys.modules.get("torch")
    if torch is not None:
        # report-only, never import or initialise: a pure gateway process
        # must not pay for either (same isolation rule as _probe_devices)
        try:
            build["torch"] = torch.__version__
            if _device.cuda_initialized():
                build["device_kind"] = torch.cuda.get_device_name()
            else:
                build["device_note"] = "CUDA not initialised in this process"
        except Exception:  # noqa: BLE001
            pass
    payload = {
        "build": build,
        "config": {
            "api_name": api_name,
            "pid": os.getpid(),
            "predict_dtype": _predict_dtype,
            "slow_request_seconds": _tracing.get_slow_threshold(),
            "flight_capacity": _flight.capacity(),
            "max_trace_events": _spans.get_max_trace_events(),
            "trace_events_dropped": _spans.dropped_events(),
        },
        "exemplars": _tracing.get_exemplars(),
        "metrics": _metrics.get_registry().snapshot(),
    }
    if federation is not None:
        payload["cluster"] = federation.cluster_payload()
    return payload


def debug_body(route: str, api_name: str,
               federation: Optional[Any] = None,
               query: Optional[Dict[str, str]] = None) -> tuple:
    """``(body_bytes, content_type)`` for any debug route — the one
    payload builder both serving engines (the threaded handler below and
    the asyncio front in ``io/aserve``) answer debug traffic from, so
    the exposition formats cannot drift between engines. ``query`` is
    the request's parsed query string (:func:`debug_query`): it carries
    the ``/debug/flight?since=<seq>`` incremental-scrape cursor and the
    ``/debug/trace?id=<trace_id>`` selector."""
    query = query or {}
    if route == "metrics":
        extra = b"" if federation is None else federation.render_metrics()
        return (render_metrics() + extra,
                "text/plain; version=0.0.4; charset=utf-8")
    if route == "healthz":
        payload: Any = healthz_payload()
    elif route == "varz":
        payload = varz_payload(api_name, federation)
    elif route == "cluster":
        payload = (federation.cluster_payload() if federation is not None
                   else {"federation": None,
                         "note": "no federation in this process (cluster "
                                 "view lives on the distributed-serving "
                                 "gateway)"})
    elif route == "roofline":
        payload = roofline_payload()
    elif route == "autoscale":
        payload = (federation.autoscale_hint() if federation is not None
                   else {"federation": None,
                         "note": "no federation in this process (the "
                                 "autoscale signal lives on the "
                                 "distributed-serving gateway)"})
    elif route == "slo":
        payload = _slo.snapshot_payload()
        if federation is not None:
            payload["cluster"] = federation.slo_overview()
    elif route == "tail":
        payload = _tailsampler.snapshot_payload()
    elif route == "tuning":
        payload = _tuning.snapshot_payload()
    elif route == "timeline":
        payload = (federation.timeline_payload() if federation is not None
                   else {"federation": None,
                         "note": "no federation in this process (the "
                                 "fleet timeline lives on the "
                                 "distributed-serving gateway)"})
    elif route == "trace":
        trace_id = query.get("id")
        payload = (federation.trace_payload(trace_id)
                   if federation is not None
                   else _blackbox.local_trace_payload(trace_id))
    else:
        since = None
        try:
            since = int(query["since"])
        except (KeyError, ValueError):    # absent/garbage cursor: full ring
            pass
        payload = _flight.snapshot(since=since)
    return (json.dumps(payload, default=repr).encode("utf-8"),
            "application/json")


def write_debug_response(handler: BaseHTTPRequestHandler, route: str,
                         api_name: str,
                         federation: Optional[Any] = None,
                         query: Optional[Dict[str, str]] = None) -> None:
    """Answer any debug route in-band (never queued: these must work
    even when the batching worker or every backend worker is wedged).
    ``federation`` is the gateway's :class:`MetricsFederator`: it extends
    ``/metrics`` with the merged ``cluster_*`` families, ``/varz`` with
    the scrape-health section, and backs ``/debug/cluster``,
    ``/debug/timeline`` and ``/debug/trace``."""
    body, ctype = debug_body(route, api_name, federation, query)
    if route == "metrics":
        write_http_response(handler, 200, body, {"Content-Type": ctype})
        return
    write_http_response(handler, 200, body, {"Content-Type": ctype},
                        counter="debug_requests_total",
                        api=api_name, endpoint=route)


def roofline_payload() -> Dict[str, Any]:
    """``/debug/roofline`` body: the roofline ledger (per-executable
    achieved FLOP/s & bytes/s vs backend peaks — ratios-only with an
    explicit ``peaks.source: "unknown"`` on a card the peak table does
    not list) plus the device-memory (``hbm``) ledger's
    named claims reconciled against the last PJRT sample."""
    payload = _roofline.snapshot_payload()
    payload["hbm"] = _hbm.snapshot_payload()
    return payload


# -- per-request latency decomposition --------------------------------------
# Both engines stamp monotonic marks on each request's timeline and fold
# them into the same four stages here, so the stage vocabulary (and the
# invariant that stages partition the request wall time) cannot drift
# between the threaded and async planes.

#: stage vocabulary, in timeline order
SERVING_STAGES = ("admission", "forming_wait", "score", "write")


def stage_breakdown(start: float, admitted: float, dispatched: float,
                    scored: float, end: float) -> Optional[Dict[str, float]]:
    """Fold one request's monotonic marks into the four-stage
    decomposition (``admission`` = edge parse + enqueue, ``forming_wait``
    = queue + batch forming, ``score`` = transform/predict,
    ``write`` = reply serialization + socket write). The stages
    partition [start, end] exactly. None when any mark is missing —
    only fully scored round trips decompose (shed/timeout paths answer
    before a timeline exists)."""
    if not (start and admitted and dispatched and scored and end):
        return None
    return {"admission": max(0.0, admitted - start),
            "forming_wait": max(0.0, dispatched - admitted),
            "score": max(0.0, scored - dispatched),
            "write": max(0.0, end - scored)}


def observe_request_stages(api_name: str,
                           stages: Optional[Dict[str, float]]) -> None:
    """Feed one request's stage breakdown into the
    ``serving_stage_seconds{api, stage}`` histograms (both engines)."""
    if not stages:
        return
    for stage, seconds in stages.items():
        _metrics.safe_histogram("serving_stage_seconds", api=api_name,
                                stage=stage).observe(seconds)


# power-of-two ladder matching the batch bucket shapes (bucket_size below)
_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                       256.0, 512.0, 1024.0)

# ---------------------------------------------------------------------------
# Request plumbing
# ---------------------------------------------------------------------------


@dataclass
class ServedRequest:
    """One in-flight request parked on its accepting socket."""

    id: str
    method: str
    path: str
    headers: Dict[str, str]
    body: bytes
    done: threading.Event = field(default_factory=threading.Event)
    response: Optional[Dict[str, Any]] = None
    requeued: bool = False
    #: trace context extracted at the edge (None with telemetry disabled)
    trace: Optional[Any] = None
    #: remaining-time budget parsed from X-Deadline-Ms (None = no deadline)
    deadline: Optional[_policy.Deadline] = None
    #: monotonic admission time — the queue-wait clock
    enqueued_at: float = 0.0
    #: monotonic batch-assembly mark (stage decomposition: end of
    #: forming_wait) — 0.0 until the request joins a batch
    dispatched_at: float = 0.0
    #: monotonic reply mark (end of score) — 0.0 until reply() lands
    scored_at: float = 0.0
    #: withdrawn at admission (drain race): the batch loop must skip it —
    #: its handler already answered 503
    shed: bool = False

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8")) if self.body else None


class ServingServer:
    """Threaded HTTP front-end with id-keyed reply routing.

    Parity: the per-executor ``WorkerServer`` (HTTPSourceV2.scala:457-676).
    ``get_batch`` is the source side (dequeue up to N requests within the
    latency deadline); ``reply`` is the sink side (route response to the exact
    parked socket).
    """

    def __init__(self, host: str = "localhost", port: int = 0,
                 api_name: str = "serving", request_timeout: float = 30.0,
                 max_queue_depth: Optional[int] = None):
        self.api_name = api_name
        self.request_timeout = request_timeout
        # admission control: past this backlog the handler sheds with
        # 429 + Retry-After instead of queueing forever (0 disables).
        # The bound lives in the queue itself (put_nowait admission) —
        # a qsize() check-then-put would admit a burst past the limit.
        self.max_queue_depth = (
            max_queue_depth if max_queue_depth is not None
            else _policy.env_int("MMLSPARK_TPU_MAX_QUEUE_DEPTH", 512))
        self._queue: "queue.Queue[ServedRequest]" = queue.Queue(
            maxsize=max(0, self.max_queue_depth))
        self._inflight: Dict[str, ServedRequest] = {}
        self._lock = threading.Lock()
        self._draining = False
        # pulsed on every reply/requeue/batch so drain and await_served
        # can wait on progress instead of sleep-polling
        self._progress = threading.Event()
        # observed per-request service time + queue wait: the inputs to
        # the Retry-After hint handed to shed/drained clients
        self._service_ewma = _policy.Ewma()
        self._wait_ewma = _policy.Ewma()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: the gateway hop pools one connection per worker
            # instead of paying a TCP handshake per proxied request
            # (write_http_response always sets Content-Length, which is
            # all HTTP/1.1 persistence needs); idle connections reap on
            # the read timeout so parked keep-alive threads are bounded.
            # Nagle off: on a persistent connection the two-segment
            # request/response pattern hits the delayed-ACK stall (~40 ms
            # per request) that per-request HTTP/1.0 sockets never showed
            protocol_version = "HTTP/1.1"
            timeout = 65.0
            disable_nagle_algorithm = True

            def _handle(self, method: str):
                if not outer._started:
                    # stop() already ran — a pooled keep-alive connection
                    # that outlived the server must see EOF (the crash/
                    # kill_worker semantics failover tests rely on), not
                    # a reply from a "dead" worker
                    self.close_connection = True
                    return
                # consume the body up front: EVERY reply path (incl. the
                # shed/drain/failpoint early returns below) must leave the
                # socket positioned at the next request, or a keep-alive
                # peer's following request parses against leftover body
                # bytes. Chunked framing isn't decoded here — reject it
                # loudly and close, never desync on an unread payload
                if self.headers.get("Transfer-Encoding"):
                    self.close_connection = True
                    write_http_response(
                        self, 411,
                        b'{"error": "Transfer-Encoding unsupported; '
                        b'send Content-Length"}',
                        counter="serving_responses_total",
                        api=outer.api_name)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # the enabled() gate keeps the disabled-path contract
                # (set_enabled(False) restores exactly the uninstrumented
                # routing) and gives an API that legitimately owns GET
                # /metrics — or /healthz etc. — a way to reclaim the path
                if _metrics.enabled():
                    route = debug_route(method, self.path, outer.api_name)
                    if route is not None:
                        # answered in-band, never queued: these must work
                        # even when the batching worker is wedged
                        write_debug_response(self, route, outer.api_name,
                                             query=debug_query(self.path))
                        return
                # fault site: admission-side chaos (synthetic 5xx, added
                # latency, connection-drop crash); ordered AFTER the
                # debug routes so /metrics & /debug stay readable mid-run
                act = _failpoints.fault_point("serving.handle",
                                          api=outer.api_name)
                if act is not None and act.status is not None:
                    write_http_response(self, act.status,
                                        b'{"error": "injected"}',
                                        counter="serving_responses_total",
                                        api=outer.api_name)
                    return
                if outer._draining:
                    # new traffic is refused during drain; gateways have
                    # already dropped us from the registry, and a direct
                    # client gets told when capacity elsewhere frees up
                    outer._shed("draining")
                    write_http_response(self, 503,
                                        b'{"error": "draining"}',
                                        outer.retry_after_hint(),
                                        counter="serving_responses_total",
                                        api=outer.api_name)
                    return
                deadline = _policy.Deadline.from_headers(self.headers)
                if deadline is not None and deadline.expired:
                    _metrics.safe_counter("serving_deadline_dropped_total",
                                          api=outer.api_name,
                                          stage="admission").inc()
                    write_http_response(self, 504,
                                        b'{"error": "deadline exceeded"}',
                                        counter="serving_responses_total",
                                        api=outer.api_name)
                    return
                # inbound hop: adopt the caller's trace (gateway/client
                # traceparent) or start one; None while disabled, which
                # also suppresses the X-Request-Id echo
                ctx = _tracing.context_from_headers(self.headers)
                token = _tracing.activate(ctx) if ctx is not None else None
                t0 = time.perf_counter()
                # monotonic twin of t0: the stage decomposition is
                # computed entirely on the monotonic clock the timeline
                # marks use, so stage sums track the observed wall time
                t0_mono = time.monotonic()
                req: Optional[ServedRequest] = None
                # captured once so inc/dec hit the same object even if
                # metrics.set_enabled is toggled while this request is
                # parked on done.wait() — re-resolving in the finally
                # would pair a real inc with a no-op dec and skew the
                # gauge permanently
                inflight = _metrics.safe_gauge("serving_inflight_requests",
                                               api=outer.api_name)
                inflight.inc()
                status = 504
                try:
                    with _spans.span("serving_request",
                                     api=outer.api_name, method=method,
                                     path=self.path):
                        req = ServedRequest(
                            id=uuid.uuid4().hex, method=method,
                            path=self.path,
                            headers={k.lower(): v
                                     for k, v in self.headers.items()},
                            body=body, trace=ctx, deadline=deadline,
                            enqueued_at=time.monotonic())
                        with outer._lock:
                            outer._inflight[req.id] = req
                        try:
                            outer._queue.put_nowait(req)
                        except queue.Full:
                            # admission control: past the backlog bound,
                            # queueing only converts overload into
                            # timeouts — shed now and tell the client
                            # when the queue will have drained.
                            # status (not counter=): these branches sit
                            # inside the try, and the finally counts
                            # serving_responses_total once — a counter=
                            # here double-counted every shed (429 + a
                            # phantom 504), a divergence the async
                            # engine's exact-count parity surfaced
                            with outer._lock:
                                outer._inflight.pop(req.id, None)
                            outer._shed("queue_full")
                            status = 429
                            write_http_response(
                                self, 429, b'{"error": "overloaded"}',
                                outer.retry_after_hint())
                            return
                        if outer._draining and outer._withdraw(req):
                            # drain began between the flag check and the
                            # enqueue: without this withdraw, a request
                            # slipping into an already-flushed queue
                            # would die as a silent 504 after stop()
                            outer._shed("draining")
                            status = 503
                            write_http_response(
                                self, 503, b'{"error": "draining"}',
                                outer.retry_after_hint())
                            return
                        outer._update_queue_depth()
                        # a deadlined request never parks past its budget:
                        # waiting longer only delays the inevitable 504
                        wait_s = outer.request_timeout
                        if deadline is not None:
                            wait_s = min(wait_s,
                                         deadline.remaining_seconds())
                        ok = req.done.wait(wait_s)
                        with outer._lock:
                            outer._inflight.pop(req.id, None)
                        outer._progress.set()
                        echo = ({} if ctx is None else
                                {_tracing.REQUEST_ID_HEADER: ctx.trace_id})
                        if not ok or req.response is None:
                            _flight.record("request_timeout",
                                           api=outer.api_name,
                                           request_id=req.id)
                            write_http_response(self, 504, b"", echo)
                            return
                        resp = req.response
                        status = int(resp.get("statusCode", 200))
                        payload = resp.get("entity", b"")
                        hdrs = {**(resp.get("headers") or {}), **echo}
                        write_http_response(self, status, payload, hdrs)
                finally:
                    inflight.dec()
                    _metrics.safe_counter("serving_responses_total",
                                          api=outer.api_name,
                                          code=str(status)).inc()
                    dt = time.perf_counter() - t0
                    _metrics.safe_histogram(
                        "serving_request_seconds", api=outer.api_name
                    ).observe(dt)
                    stages = None
                    if req is not None and _metrics.enabled():
                        stages = stage_breakdown(
                            t0_mono, req.enqueued_at, req.dispatched_at,
                            req.scored_at, time.monotonic())
                        observe_request_stages(outer.api_name, stages)
                    _slo.observe_request(
                        outer.api_name, dt, status, stages=stages,
                        trace_id=None if ctx is None else ctx.trace_id)
                    _tracing.maybe_mark_slow("serving_request_seconds",
                                             dt, stages=stages,
                                             api=outer.api_name)
                    if token is not None:
                        _tracing.deactivate(token)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def log_message(self, *a):  # quiet
                pass

        class Server(ThreadingHTTPServer):
            # Deep listen backlog: burst traffic must never see connection
            # resets while handler threads are parked on in-flight replies.
            request_queue_size = 128

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingServer":
        # the thread starts under the lock: releasing between the flag
        # flip and start() opens a window where a concurrent stop()
        # closes the socket first and the thread serves a dead fd
        with self._lock:
            if self._started:
                return self
            # flag only after the thread is really running: if start()
            # raises (e.g. restarting a stopped server's used thread),
            # a False flag keeps every retry failing loudly instead of
            # silently no-opping against a dead instance
            self._thread.start()
            self._started = True
        return self

    def stop(self) -> None:
        # flip the flag under the lock, but shut down outside it: a
        # handler thread blocked on _lock must never hold up shutdown
        with self._lock:
            if not self._started:
                return
            self._started = False
        self._httpd.shutdown()
        self._httpd.server_close()
        # persist tuning evidence + any pending decisions so the NEXT
        # process starts tuned (no-op when tuning is disabled)
        _tuning.flush()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/{self.api_name}"

    # -- resilience --------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Refuse new traffic (503 + Retry-After); in-flight requests and
        queued batches keep flowing to completion."""
        self._draining = True
        _metrics.safe_gauge("serving_draining", api=self.api_name).set(1)

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def has_inflight(self, request_id: str) -> bool:
        with self._lock:
            return request_id in self._inflight

    def _shed(self, reason: str) -> None:
        _metrics.safe_counter("serving_shed_total", api=self.api_name,
                              reason=reason).inc()
        _flight.record("shed", api=self.api_name, reason=reason,
                       depth=self._queue.qsize())

    def _withdraw(self, req: ServedRequest) -> bool:
        """Take a just-enqueued request back (the admission/drain race).
        True when this handler still owns the reply — the batch loop
        will skip the marked request; False when the batch side already
        answered it."""
        req.shed = True
        with self._lock:
            owned = self._inflight.pop(req.id, None) is not None
        return owned and not req.done.is_set()

    def _update_queue_depth(self) -> None:
        """The ONE writer of the ``serving_queue_depth`` gauge — every
        queue transition funnels here so the exported depth can never
        diverge between call sites."""
        _metrics.safe_gauge("serving_queue_depth", api=self.api_name).set(
            self._queue.qsize())

    def observe_batch(self, n: int, seconds: float) -> None:
        """ServingQuery reports each batch's service time here, feeding
        the per-request EWMA the Retry-After hint is derived from."""
        if n > 0:
            self._service_ewma.update(seconds / n)

    def retry_after_hint(self) -> Dict[str, str]:
        """Retry-After for shed/drain responses: the estimated time for
        the CURRENT backlog to drain at the observed per-request service
        rate (queue wait EWMA as a floor — it already includes batching
        effects), clamped sane while the estimators are cold."""
        per_req = self._service_ewma.value or 0.0
        est = (self._queue.qsize() + 1) * per_req
        wait = self._wait_ewma.value
        if wait:
            est = max(est, wait)
        return {"Retry-After":
                str(_policy.retry_after_seconds(est))}

    # -- source side -------------------------------------------------------
    def get_batch(self, max_batch: int, max_latency: float,
                  eager: bool = True) -> List[ServedRequest]:
        """Up to ``max_batch`` requests.

        ``eager`` (default): after the first arrival, greedily drain whatever
        is already queued and reply immediately — a lone request never pays
        the batching deadline, so idle-load p50 is the transform time, while
        concurrent load still forms full batches from the backlog (the
        ~1 ms-latency regime of the reference's continuous serving,
        docs/mmlspark-serving.md:10-11). ``eager=False`` restores
        deadline-driven accumulation: wait up to ``max_latency`` after the
        first arrival to fill the batch (fuller device batches under
        staggered arrivals, at the cost of the deadline on p50).
        """
        out: List[ServedRequest] = []
        try:
            out.append(self._queue.get(timeout=max_latency))
        except queue.Empty:
            # idle poll: no batch was assembled, but the depth gauge must
            # still track reality — without this, a service that drains to
            # empty keeps exporting the LAST busy depth forever (the
            # assembly histogram correctly stays untouched: there was no
            # assembly)
            self._update_queue_depth()
            return out
        t_first = time.monotonic()
        if eager:
            while len(out) < max_batch:
                try:
                    out.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            return self._batch_assembled(out, t_first)
        deadline = time.monotonic() + max_latency
        while len(out) < max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                out.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return self._batch_assembled(out, t_first)

    def _batch_assembled(self, out: List[ServedRequest],
                         t_first: float) -> List[ServedRequest]:
        # assembly wait = time after the FIRST arrival spent filling the
        # batch (0 for an eager lone request; bounded by the deadline)
        now = time.monotonic()
        _metrics.safe_histogram("serving_batch_assembly_seconds",
                                api=self.api_name).observe(now - t_first)
        # queue WAIT (admission -> batch), per request — nonzero even on
        # the eager lone-request path, and the signal the shed threshold
        # and Retry-After math key off (assembly time alone hides the
        # time spent parked BEHIND earlier batches)
        wait_h = _metrics.safe_histogram("serving_queue_wait_seconds",
                                         api=self.api_name)
        for r in out:
            r.dispatched_at = now       # stage mark: forming_wait ends
            if r.enqueued_at:
                w = now - r.enqueued_at
                wait_h.observe(w)
                self._wait_ewma.update(w)
        self._update_queue_depth()
        return out

    def requeue(self, req: ServedRequest) -> bool:
        """Crash recovery: put an unanswered request back once
        (historyQueues analog, HTTPSourceV2.scala:470-483)."""
        if req.requeued or req.done.is_set():
            return False
        req.requeued = True
        try:
            # never block the batch thread on a full queue: under shed
            # pressure the crash-recovery slot is gone — the request's
            # handler times out to its normal 504 instead
            self._queue.put_nowait(req)
        except queue.Full:
            self._shed("requeue_full")
            return False
        # queue transition: a crash-recovery requeue is exactly the kind
        # of event a post-mortem flight dump needs in sequence
        _flight.record("requeue", api=self.api_name, request_id=req.id)
        return True

    # -- sink side ---------------------------------------------------------
    def reply(self, request_id: str, entity: Any, status_code: int = 200,
              headers: Optional[Dict[str, str]] = None) -> bool:
        with self._lock:
            req = self._inflight.get(request_id)
        if req is None:
            # late/duplicate replies (request already timed out and its
            # socket released) were silently dropped — make them visible
            _metrics.safe_counter("serving_reply_unknown_total",
                                  api=self.api_name).inc()
            _flight.record("reply_unknown", api=self.api_name,
                           request_id=request_id)
            return False
        if not isinstance(entity, (bytes, str)) and entity is not None:
            entity = json.dumps(entity)
            headers = {"Content-Type": "application/json", **(headers or {})}
        req.response = {"statusCode": status_code, "entity": entity or b"",
                        "headers": headers or {}}
        req.scored_at = time.monotonic()   # stage mark: score ends
        req.done.set()
        self._progress.set()
        return True


# ---------------------------------------------------------------------------
# ServingUDFs parity (reference: ServingUDFs.scala:16-20)
# ---------------------------------------------------------------------------


def requests_to_dataset(batch: List[ServedRequest]) -> Dataset:
    """Batch of parked requests -> columnar Dataset with id + request parts
    (the HTTPSourceV2 Row(id, request) schema)."""
    return Dataset({
        "id": [r.id for r in batch],
        "method": [r.method for r in batch],
        "path": [r.path for r in batch],
        "headers": [r.headers for r in batch],
        "body": [r.body for r in batch],
        "value": [_maybe_json(r.body) for r in batch],
    })


def _maybe_json(body: bytes) -> Any:
    try:
        return json.loads(body.decode("utf-8")) if body else None
    except ValueError:
        return None


def make_reply(entity: Any, status_code: int = 200) -> Dict[str, Any]:
    """Build a reply struct for the reply column (ServingUDFs.makeReplyUDF)."""
    return {"entity": entity, "statusCode": status_code}


# ---------------------------------------------------------------------------
# DynamicBatcher + ServingQuery
# ---------------------------------------------------------------------------


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest bucket >= n (capped): a bounded set of batch shapes, so
    a per-shape program cache holds a bounded set of entries, not one per
    size. Consults the auto-tuner's measured ladder (tuning site 2) when
    one is decided — the SAME resolution ``Booster.predict_plan`` does,
    so the batcher and the predictor cache key can never disagree on
    rung geometry — else the static pow2 grid."""
    ladder = _tuning.resolve_bucket_ladder()
    if ladder:
        for rung in ladder:
            if rung >= n:
                return min(int(rung), max_batch)
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def bucketed_model_transform(model, rows: list, input_col: str,
                             output_col: str, max_batch: int) -> list:
    """Pad ``rows`` to a power-of-two bucket (first row repeated), run the
    model, slice back to ``len(rows)`` outputs. The single shared
    implementation of bucket padding, used by both
    ``ServingBuilder.pipeline`` and the ``serving_main`` worker entrypoint."""
    n = len(rows)
    b = bucket_size(n, max(max_batch, n))
    padded = rows + [rows[0]] * (b - n)
    out = model.transform(Dataset({input_col: padded}))
    return list(out[output_col])[:n]


class ServingQuery:
    """Continuous micro-batch loop: get_batch -> transform -> reply.

    The streaming-query analog of the reference's serving pipeline. ``stop``
    is graceful; an exception inside ``transform`` re-queues the batch once
    then answers 500 (partition-crash recovery semantics).
    """

    def __init__(self, server: ServingServer,
                 transform: Callable[[Dataset], Dataset],
                 reply_col: str = "reply", max_batch: int = 32,
                 max_latency: float = 0.005, eager: bool = True):
        self.server = server
        self.transform = transform
        self.reply_col = reply_col
        self.max_batch = max_batch
        self.max_latency = max_latency
        self.eager = eager
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.batches_served = 0
        self.requests_served = 0

    def start(self) -> "ServingQuery":
        self.server.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.server.stop()

    def drain(self, settle_seconds: Optional[float] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        """Graceful shutdown: serve normally for ``settle_seconds`` (the
        window gateways need to drop this worker from their routing
        tables after deregistration), then refuse new traffic and let
        every queued request and in-flight batch complete before
        stopping — a SIGTERM'd worker exits with zero client-visible
        errors. Returns drain stats for the caller's exit log.

        Env defaults: ``MMLSPARK_TPU_DRAIN_SETTLE_SECONDS`` (0.5),
        ``MMLSPARK_TPU_DRAIN_TIMEOUT_SECONDS`` (30).
        """
        api = self.server.api_name
        if settle_seconds is None:
            settle_seconds = _policy.env_float(
                "MMLSPARK_TPU_DRAIN_SETTLE_SECONDS", 0.5)
        if timeout is None:
            timeout = _policy.env_float(
                "MMLSPARK_TPU_DRAIN_TIMEOUT_SECONDS", 30.0)
        t0 = time.monotonic()
        _flight.record("drain_begin", api=api,
                       queued=self.server._queue.qsize(),
                       inflight=self.server.inflight_count())
        logger.info("drain begin", api=api,
                    settle_seconds=settle_seconds)
        if settle_seconds > 0:
            time.sleep(settle_seconds)
        self.server.begin_drain()
        end = time.monotonic() + timeout
        clean = False
        progress = self.server._progress
        while True:
            if (self.server._queue.qsize() == 0
                    and self.server.inflight_count() == 0):
                clean = True
                break
            remaining = end - time.monotonic()
            if remaining <= 0:
                break
            # woken by every reply/requeue/handler-release pulse; the
            # timeout only bounds the wait between pulses
            progress.wait(min(remaining, 0.05))
            progress.clear()
        self.stop()
        stats = {"clean": clean,
                 "seconds": round(time.monotonic() - t0, 3),
                 "requests_served": self.requests_served,
                 "leftover_inflight": self.server.inflight_count()}
        _flight.record("drain_complete", api=api, **stats)
        logger.info("drain complete", api=api, **stats)
        return stats

    def await_served(self, n: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        progress = self.server._progress
        while self.requests_served < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            progress.wait(min(remaining, 0.05))
            progress.clear()

    def _run(self) -> None:
        api = self.server.api_name
        # watchdog heartbeat: the batch loop iterates at least once per
        # max_latency even when idle, so a silent heartbeat means the
        # transform (or the model under it) is wedged — exactly the state
        # that used to surface only as client 504s
        # 120 s site override: the first batch may pay the model's first
        # upload (and CUDA's start-up) inside transform(), which is
        # slow-but-alive, not wedged
        hb = _watchdog.register(f"serving_batch:{api}", stall_seconds=120.0)
        try:
            self._run_batches(api, hb)
        finally:
            hb.close()

    def _drop_expired(self, batch: List[ServedRequest],
                      api: str) -> List[ServedRequest]:
        """Answer 504 now for co-batched requests whose deadline already
        passed — scoring them would spend a device dispatch on replies
        nobody awaits (their handler threads have stopped waiting)."""
        live: List[ServedRequest] = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired:
                _metrics.safe_counter("serving_deadline_dropped_total",
                                      api=api, stage="batch").inc()
                _flight.record("deadline_dropped", api=api,
                               request_id=r.id)
                # usually the handler (whose wait is capped at the
                # deadline) has already 504'd and released the socket —
                # replying then would misfire the reply_unknown anomaly
                # counter; only route a real 504 to a still-parked one
                if self.server.has_inflight(r.id):
                    self.server.reply(r.id, {"error": "deadline exceeded"},
                                      504)
            else:
                live.append(r)
        return live

    def _run_batches(self, api: str, hb) -> None:
        while not self._stop.is_set():
            hb.beat()
            batch = self.server.get_batch(self.max_batch, self.max_latency,
                                          self.eager)
            if not batch:
                continue
            # requests withdrawn at admission (the drain race) were
            # already answered 503 by their handler — scoring them would
            # double-reply
            batch = [r for r in batch if not r.shed]
            batch = self._drop_expired(batch, api)
            if not batch:
                continue
            _metrics.safe_histogram("serving_batch_size", api=api,
                                    buckets=_BATCH_SIZE_BUCKETS).observe(
                len(batch))
            # tuning evidence (site 2): the batch-size histogram the
            # measured bucket ladder derives from — fed by BOTH engines
            _tuning.observe_batch_size(len(batch))
            ds = requests_to_dataset(batch)
            t0 = time.perf_counter()
            # the queue crosses a thread boundary, so the handler threads'
            # contextvars don't reach this worker: re-activate the first
            # request's trace (exact attribution at the dominant batch
            # size of 1; under larger batches the span's trace_ids attr
            # names every co-batched request)
            traces = [r.trace for r in batch if r.trace is not None]
            ctx = traces[0] if traces else None
            token = _tracing.activate(ctx) if ctx is not None else None
            try:
                # fault site: an `error` rule here is a transform crash —
                # it rides the requeue-once recovery path below exactly
                # like a real one (which is the point)
                _failpoints.fault_point("serving.batch", api=api)
                with _spans.span("serving_transform", api=api,
                                 batch_size=len(batch),
                                 trace_ids=[t.trace_id for t in traces]):
                    out = self.transform(ds)
                replies = out[self.reply_col]
                ids = out["id"]
                for rid, rep in zip(ids, replies):
                    if isinstance(rep, dict) and "entity" in rep:
                        self.server.reply(rid, rep.get("entity"),
                                          int(rep.get("statusCode", 200)))
                    else:
                        self.server.reply(rid, rep)
                self.batches_served += 1
                self.requests_served += len(batch)
                self.server._progress.set()
                dt = time.perf_counter() - t0
                self.server.observe_batch(len(batch), dt)
                _tuning.observe_score(dt)
                _metrics.safe_counter("serving_batches_total", api=api).inc()
                _metrics.safe_histogram("serving_transform_seconds",
                                        api=api).observe(dt)
            except Exception as e:
                survivors = [r for r in batch if self.server.requeue(r)]
                logger.error("batch transform failed: %s: %s",
                             type(e).__name__, e, api=api,
                             batch_size=len(batch),
                             requeued=len(survivors))
                _flight.record("batch_error", api=api,
                               batch_size=len(batch),
                               requeued=len(survivors),
                               error=f"{type(e).__name__}: {e}")
                _metrics.safe_counter("serving_batch_failures_total",
                                      api=api).inc()
                _metrics.safe_counter("serving_requeues_total", api=api).inc(
                    len(survivors))
                for r in batch:
                    if r not in survivors and not r.done.is_set():
                        self.server.reply(r.id, {"error": "internal"}, 500)
            finally:
                if token is not None:
                    _tracing.deactivate(token)


class ServingBuilder:
    """Fluent serving entry (reference: io/IOImplicits.scala:19-80)."""

    def __init__(self):
        self._host, self._port, self._name = "localhost", 0, "serving"
        self._max_batch, self._max_latency = 32, 0.005
        self._eager = True
        self._transform: Optional[Callable[[Dataset], Dataset]] = None
        self._reply_col = "reply"
        self._timeout = 30.0
        self._max_queue_depth: Optional[int] = None
        self._engine: Optional[str] = None

    def address(self, host: str, port: int = 0, api_name: str = "serving"
                ) -> "ServingBuilder":
        self._host, self._port, self._name = host, port, api_name
        return self

    def batch(self, max_batch: int = 32, max_latency_ms: float = 5.0,
              eager: bool = True) -> "ServingBuilder":
        """``eager=False`` opts into deadline accumulation (wait up to
        ``max_latency_ms`` to fill a batch); default replies as soon as the
        queued backlog is drained."""
        self._max_batch, self._max_latency = max_batch, max_latency_ms / 1000.0
        self._eager = eager
        return self

    def request_timeout(self, seconds: float) -> "ServingBuilder":
        self._timeout = seconds
        return self

    def queue_limit(self, max_queue_depth: int) -> "ServingBuilder":
        """Admission bound: past this backlog, requests shed with 429 +
        Retry-After instead of queueing (0 disables; default from
        ``MMLSPARK_TPU_MAX_QUEUE_DEPTH``, 512)."""
        self._max_queue_depth = max_queue_depth
        return self

    def transform(self, fn: Callable[[Dataset], Dataset]) -> "ServingBuilder":
        self._transform = fn
        return self

    def pipeline(self, model, input_col: str = "value",
                 output_col: str = "prediction") -> "ServingBuilder":
        """Serve a fitted pipeline/model: request JSON -> input col, reply =
        output col. The inner batch is padded to a power-of-two bucket (first
        row repeated) so the model sees only log2(maxBatch) distinct
        shapes under varying load."""

        def fn(ds: Dataset) -> Dataset:
            # Read the builder's batch size at call time, so `.batch()` later
            # in the fluent chain still governs the bucketing.
            vals = bucketed_model_transform(
                model, list(ds["value"]), input_col, output_col,
                self._max_batch)
            replies = [make_reply(to_jsonable(v)) for v in vals]
            return ds.with_column(self._reply_col, replies)

        self._transform = fn
        return self

    def reply_to(self, col: str) -> "ServingBuilder":
        self._reply_col = col
        return self

    def engine(self, name: str) -> "ServingBuilder":
        """Pick the serving engine: ``"threaded"`` (this module's
        ``ThreadingHTTPServer`` stack, the default) or ``"async"`` (the
        ``io/aserve`` event-loop plane with continuous batching).
        Unset, ``MMLSPARK_TPU_SERVING_ENGINE`` decides."""
        self._engine = name
        return self

    def start(self):
        if self._transform is None:
            raise ValueError("no transform set; call .transform(fn) or .pipeline(model)")
        # late import: aserve shares this module's funnels (debug_body,
        # bucket_size), so the engine switch must not create an import
        # cycle at module load
        from .aserve import resolve_engine
        if resolve_engine(self._engine) == "async":
            from .aserve import AsyncServingQuery, AsyncServingServer
            aserver = AsyncServingServer(
                self._host, self._port, self._name, self._timeout,
                max_queue_depth=self._max_queue_depth,
                slots=self._max_batch)
            return AsyncServingQuery(aserver, transform=self._transform,
                                     reply_col=self._reply_col).start()
        server = ServingServer(self._host, self._port, self._name,
                               self._timeout,
                               max_queue_depth=self._max_queue_depth)
        return ServingQuery(server, self._transform, self._reply_col,
                            self._max_batch, self._max_latency,
                            self._eager).start()


def serve() -> ServingBuilder:
    return ServingBuilder()


