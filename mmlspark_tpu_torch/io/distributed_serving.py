"""Distributed serving: multi-worker deployment with routing and recovery.

The port's copy of ``mmlspark_tpu/io/distributed_serving.py`` (reference:
org/apache/spark/sql/execution/streaming/DistributedHTTPSource.scala:26-420
— per-executor ``JVMSharedServer``s with a ``MultiChannelMap`` routing
table and epoch-history crash recovery; HTTPSourceV2.scala:45-700 — load
distribution across worker servers, one central service table).

The executors become serving workers (one per process, each scoring on
its card through its own predictor cache); the central service table
becomes a ``ServiceRegistry`` the workers register into; and the public
entry point is a ``GatewayServer`` that load-balances across live workers
with health-driven failover:

- ``ServiceRegistry``: worker address book. In-memory for one process; the
  file backend (atomic JSON writes into a shared directory) is the
  multi-host coordination path — no extra services needed, matching how
  the reference rides Spark itself rather than ZooKeeper.
- ``GatewayServer``: accepts HTTP, picks a live worker (queue-depth aware
  from the federated scrape, else least-inflight with a round-robin
  tie-break — MultiChannelMap.nextList semantics), proxies the request over
  pooled keep-alive connections, and on a connection failure marks the
  worker dead and retries the SAME request on another worker (bounded
  failover, a circuit breaker per worker with half-open probes, a retry
  budget, deadlines and ``Retry-After`` on every 503/504).
- workers are plain ``ServingQuery``s or async queries (io/serving.py,
  io/aserve): each keeps its own micro-batching, so adding workers scales
  the serving throughput the way adding executors did in the reference.
"""

from __future__ import annotations

import http.client
import json
import os
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from ..core.dataset import Dataset
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import slo as _slo
from ..observability import spans as _spans
from ..observability import tracing as _tracing
from ..observability.federation import MetricsFederator
from ..observability.logging import get_logger
from ..robustness import failpoints as _failpoints
from ..robustness import policy as _policy
from .http import HTTPConnectionPool
from .serving import (ServingQuery, ServingServer, debug_query, debug_route,
                      write_debug_response, write_http_response)

logger = get_logger("mmlspark_tpu_torch.io.distributed_serving")

# ---------------------------------------------------------------------------
# Service registry
# ---------------------------------------------------------------------------


@dataclass
class WorkerInfo:
    worker_id: str
    host: str
    port: int
    api_name: str = "serving"
    registered_at: float = field(default_factory=time.time)

    @property
    def address(self):
        return (self.host, self.port)


class ServiceRegistry:
    """Worker address book (the reference's central service table).

    ``directory=None``: in-memory (single-process deployments and tests).
    With a directory, registration writes one JSON file per worker via
    atomic rename — any host sharing the filesystem sees the same table,
    which is the multi-host path (a shared NFS mount).
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._local: Dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()

    def register(self, info: WorkerInfo) -> None:
        with self._lock:
            self._local[info.worker_id] = info
        if self.directory:
            path = os.path.join(self.directory, f"{info.worker_id}.json")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(asdict(info), f)
            os.replace(tmp, path)

    def deregister(self, worker_id: str) -> None:
        with self._lock:
            self._local.pop(worker_id, None)
        if self.directory:
            try:
                os.remove(os.path.join(self.directory, f"{worker_id}.json"))
            except OSError:
                pass

    def workers(self) -> List[WorkerInfo]:
        if not self.directory:
            with self._lock:
                return list(self._local.values())
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out.append(WorkerInfo(**json.load(f)))
            except (OSError, ValueError):
                continue  # torn write/remove race: skip this scan
        return out


# ---------------------------------------------------------------------------
# Gateway
# ---------------------------------------------------------------------------


#: worker statuses the gateway treats as "this worker can't take the
#: request right now" — retried on ANOTHER worker, budget permitting
#: (429 = admission shed; 502 = worker's own backend hop died;
#: 503 = draining / no capacity). 429 does NOT strike the breaker:
#: an overloaded worker is healthy, and opening its breaker would
#: remove capacity exactly when the cluster is short of it.
GATEWAY_RETRY_STATUS = (429, 502, 503)


class GatewayServer:
    """Public HTTP front that load-balances over registered workers.

    Routing: least-loaded worker, skipping workers whose circuit
    breaker is open. The load signal is the federation plane's scraped
    per-worker ``serving_queue_depth`` gauge when every candidate has a
    fresh scrape (a worker's own backlog sees traffic this gateway
    never forwarded), degrading to gateway-local least-inflight with
    round-robin among ties — the MultiChannelMap.nextList distribution
    of the reference — while scrapes are stale. Failover: connection-level
    failures open the worker's breaker immediately (the worker is gone);
    retryable statuses (502/503; a 429 shed retries without a breaker
    strike — overload is not sickness) accumulate toward its error-rate /
    consecutive-failure thresholds. Either way the request is retried on
    another worker, bounded by ``max_failovers`` AND a token-bucket
    retry budget so a fleet-wide outage sheds load instead of
    amplifying it. Half-open breaker probes ride the health loop, and
    ``X-Deadline-Ms`` budgets are honored and attenuated on the worker
    hop.
    """

    def __init__(self, registry: ServiceRegistry, host: str = "localhost",
                 port: int = 0, api_name: str = "serving",
                 health_interval: Optional[float] = None,
                 request_timeout: float = 30.0,
                 max_failovers: Optional[int] = None,
                 breaker_config: Optional[_policy.BreakerConfig] = None,
                 retry_budget: Optional[_policy.RetryBudget] = None):
        self.registry = registry
        self.api_name = api_name
        self.request_timeout = request_timeout
        self.health_interval = (
            health_interval if health_interval is not None
            else _policy.env_float(
                "MMLSPARK_TPU_GATEWAY_HEALTH_INTERVAL_SECONDS", 2.0))
        self.max_failovers = (
            max_failovers if max_failovers is not None
            else _policy.env_int("MMLSPARK_TPU_GATEWAY_MAX_FAILOVERS", 3))
        # breakers key on host:port (bounded slot set — worker ids churn
        # per restart); open cooldown defaults to the health interval so
        # recovery probes start at the next sweep, matching the old
        # dead-list readmission cadence
        self.breakers = _policy.BreakerBoard(
            breaker_config or _policy.BreakerConfig(
                default_open_seconds=self.health_interval))
        self.retry_budget = retry_budget or _policy.RetryBudget(
            api=api_name)
        # keep-alive connections to workers, pooled per host:port — the
        # hop used to pay one TCP handshake per proxied request
        # (ROADMAP item 3 leftover); reuse is counted in
        # gateway_connection_reuse_total, stale pooled sockets retry on
        # a fresh connection inside _exchange
        self._pool = HTTPConnectionPool()
        self._latency = _policy.Ewma()
        self._inflight: Dict[str, int] = {}
        self._rr = 0
        self._lock = threading.Lock()
        self.forwarded = 0
        self.failovers = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive toward clients, mirroring the worker handlers
            # (the gateway->worker hop pools via HTTPConnectionPool);
            # Nagle off for the same delayed-ACK-stall reason
            protocol_version = "HTTP/1.1"
            timeout = 65.0
            disable_nagle_algorithm = True

            def _handle(self, method):
                if outer._stop.is_set():
                    # stopped gateway: EOF, not a ghost reply
                    self.close_connection = True
                    return
                # consume the body before ANY reply path (the worker
                # handler's keep-alive rule): an unread body leaves the
                # persistent connection's next request parsing garbage;
                # chunked framing isn't decoded here — reject and close
                if self.headers.get("Transfer-Encoding"):
                    self.close_connection = True
                    write_http_response(
                        self, 411,
                        b'{"error": "Transfer-Encoding unsupported; '
                        b'send Content-Length"}',
                        counter="gateway_responses_total",
                        api=outer.api_name)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # enabled() gate: same disabled-path contract as
                # ServingServer — set_enabled(False) restores plain
                # proxying of GET /metrics (and /healthz etc.) to the
                # workers
                if _metrics.enabled():
                    route = debug_route(method, self.path, outer.api_name)
                    if route is not None:
                        # the gateway's own view: routing counters,
                        # failovers, live-worker gauge, its flight ring —
                        # not proxied to workers. /metrics additionally
                        # carries the federated cluster_* families and
                        # /debug/cluster the per-worker scrape health.
                        write_debug_response(self, route, outer.api_name,
                                             federation=outer.federation,
                                             query=debug_query(self.path))
                        return
                # edge hop: adopt the client's trace or mint one; the
                # active context is what _route injects into the worker
                # hop, so edge, gateway, and worker spans share a trace_id
                ctx = _tracing.context_from_headers(self.headers)
                token = _tracing.activate(ctx) if ctx is not None else None
                t0 = time.perf_counter()
                try:
                    with _spans.span("gateway_request",
                                     api=outer.api_name, method=method,
                                     path=self.path):
                        status, payload, hdrs = outer._route(
                            method, self.path, body, self.headers)
                except Exception as e:  # noqa: BLE001
                    # e.g. a corrupted file-backed registry blowing up the
                    # worker scan: answer 500 instead of dropping the
                    # connection (and leave the forensics in the ring)
                    status, payload = 500, b'{"error": "gateway internal"}'
                    hdrs = {"Content-Type": "application/json"}
                    _flight.record("gateway_error", api=outer.api_name,
                                   error=f"{type(e).__name__}: {e}")
                finally:
                    dt = time.perf_counter() - t0
                    _metrics.safe_histogram("gateway_request_seconds",
                                            api=outer.api_name).observe(dt)
                    _metrics.safe_counter("gateway_responses_total",
                                          api=outer.api_name,
                                          code=str(status)).inc()
                    # the gateway's own hop in the SLO plane: its sample
                    # carries the same trace_id the worker hop deposits,
                    # so /debug/tail reads stitch edge -> worker
                    _slo.observe_request(
                        outer.api_name, dt, status,
                        trace_id=None if ctx is None else ctx.trace_id,
                        hop="gateway")
                    _tracing.maybe_mark_slow("gateway_request_seconds",
                                             dt, api=outer.api_name)
                    if token is not None:
                        _tracing.deactivate(token)
                if ctx is not None:
                    hdrs = {**hdrs,
                            _tracing.REQUEST_ID_HEADER: ctx.trace_id}
                write_http_response(self, status, payload, hdrs)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def log_message(self, *a):
                pass

        class Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        # cluster federation: scrape every registered worker's /metrics and
        # expose the merged view on this gateway's /metrics + /debug/cluster
        # (inert per-tick while telemetry is disabled)
        self.federation = MetricsFederator(self._federation_targets)
        # /debug/cluster shows which workers the routing plane is
        # currently refusing, next to their scrape health
        self.federation.breaker_states = self.breakers.states
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._health_loop, daemon=True),
        ]
        self._stop = threading.Event()

    def _federation_targets(self):
        return [(f"{w.host}:{w.port}", w.host, w.port)
                for w in self.registry.workers()]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/{self.api_name}"

    def start(self) -> "GatewayServer":
        for t in self._threads:
            if not t.is_alive():
                t.start()
        self.federation.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.federation.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        # close, not clear: an in-flight _exchange releasing after this
        # point must see a closed pool and close its socket
        self._pool.close()

    # -- routing -------------------------------------------------------------
    @staticmethod
    def _addr(w: WorkerInfo) -> str:
        return f"{w.host}:{w.port}"

    def _live_workers(self) -> List[WorkerInfo]:
        # registry scan (filesystem I/O for file-backed registries) and
        # the breaker lookups both run lock-free; only _pick's
        # inflight/round-robin state needs the routing lock
        live = [w for w in self.registry.workers()
                if self.breakers.allow(self._addr(w))]
        _metrics.safe_gauge("gateway_live_workers", api=self.api_name).set(
                 len(live))
        return live

    def _pick(self, exclude=()) -> Optional[WorkerInfo]:
        """Route to the least-loaded live worker.

        Load signal, in preference order: the federation plane's scraped
        per-worker ``serving_queue_depth`` gauges (the worker's OWN
        backlog — it sees queued work this gateway never forwarded:
        other gateways, direct clients, slow batches) PLUS this
        gateway's in-flight delta, used when every candidate has a
        fresh scrape; otherwise gateway-local least-inflight alone,
        with round-robin among ties (the scrape plane being stale or
        partial must degrade routing quality, not bias it toward the
        workers that happen to have data). The inflight term is what
        keeps a burst between federation sweeps from herding onto the
        worker whose scrape happened to read shallow — depths only
        refresh per sweep, inflight moves per request."""
        workers = [w for w in self._live_workers()
                   if w.worker_id not in exclude]
        if not workers:
            return None
        depths = self.federation.gauge_values("serving_queue_depth")
        with self._lock:
            if depths and all(self._addr(w) in depths for w in workers):
                load = [(depths[self._addr(w)]
                         + self._inflight.get(self._addr(w), 0), i)
                        for i, w in enumerate(workers)]
                mode = "queue_depth"
            else:
                load = [(self._inflight.get(self._addr(w), 0), i)
                        for i, w in enumerate(workers)]
                mode = "fallback"
            min_load = min(load)[0]
            candidates = [i for l, i in load if l == min_load]
            self._rr += 1
            picked = workers[candidates[self._rr % len(candidates)]]
        _metrics.safe_counter("gateway_route_mode_total",
                              api=self.api_name, mode=mode).inc()
        return picked

    def _retry_after(self, base: Optional[Dict[str, str]] = None,
                     est: Optional[float] = None) -> Dict[str, str]:
        """Headers for a gateway-generated (or exhausted-failover) error
        response: Retry-After derived from observed worker latency — a
        hint real enough that well-behaved clients back off instead of
        hammering. A worker-supplied Retry-After in ``base`` wins."""
        hdrs = dict(base or {"Content-Type": "application/json"})
        if "Retry-After" not in hdrs:
            if est is None:
                lat = self._latency.value
                est = 2 * lat if lat else self.health_interval
            hdrs["Retry-After"] = str(_policy.retry_after_seconds(est))
        return hdrs

    def _spend_failover(self, attempts: int) -> bool:
        """One more failover attempt? Bounded by max_failovers AND the
        retry budget — under a fleet-wide outage the budget converges
        retry load to a fraction of live traffic."""
        if attempts >= self.max_failovers:
            return False
        return self.retry_budget.try_spend()

    def _route(self, method, path, body, req_headers=None):
        # every admitted request accrues retry budget; retries spend it
        self.retry_budget.deposit()
        deadline = _policy.Deadline.from_headers(req_headers)
        # hard failures (worker GONE) exclude the worker outright; soft
        # ones (it answered 429/502/503) only deprioritize it — with every
        # worker soft-failed, re-trying one beats failing the request,
        # and the budget + max_failovers still bound the loop
        hard_tried: set = set()
        soft_tried: set = set()
        attempts = 0
        last: Optional[tuple] = None           # last retryable worker reply
        while True:
            if deadline is not None and deadline.expired:
                _metrics.safe_counter("gateway_deadline_expired_total",
                                      api=self.api_name).inc()
                _flight.record("deadline_expired", api=self.api_name,
                               attempts=attempts)
                return 504, b'{"error": "deadline exceeded"}', \
                    self._retry_after()
            w = self._pick(exclude=hard_tried | soft_tried)
            if w is None and soft_tried:
                if last is not None and last[0] == 429:
                    # every live worker is shedding: relay the pacing
                    # hint instead of instantly re-hitting a fleet that
                    # just said "overloaded" — zero-delay re-sends are
                    # the amplification the retry budget exists to stop
                    return last[0], last[1], self._retry_after(last[2])
                soft_tried.clear()
                w = self._pick(exclude=hard_tried)
            if w is None:
                if last is not None:
                    # no one else to try: relay the worker's own answer
                    # (already carries its Retry-After when it sent one)
                    return last[0], last[1], self._retry_after(last[2])
                return 503, b'{"error": "no live workers"}', \
                    self._retry_after(est=self.health_interval)
            addr = self._addr(w)
            # when the client's remaining budget (not our own timeout) is
            # what bounds this attempt, a timeout or 504 says "impatient
            # client", not "sick worker" — it must not strike the breaker
            budget_bound = (deadline is not None and
                            deadline.remaining_seconds()
                            < self.request_timeout)
            with self._lock:
                # keyed by address like the breakers: worker ids churn
                # per restart and would grow this dict without bound
                self._inflight[addr] = self._inflight.get(addr, 0) + 1
            try:
                # fault site: the worker hop — a synthetic retryable
                # status stands in for "the picked worker answered
                # sick", exercising failover without touching the wire
                act = _failpoints.fault_point("gateway.route", worker=addr)
                if act is not None and act.status is not None:
                    status, payload = act.status, b'{"error": "injected"}'
                    headers = {"Content-Type": "application/json"}
                else:
                    timeout = self.request_timeout
                    if deadline is not None:
                        timeout = max(0.05, min(
                            timeout, deadline.remaining_seconds()))
                    # outbound hop: the active trace context rides the
                    # wire (worker spans stitch to this gateway's), and
                    # the deadline budget is attenuated for the hop
                    out_headers = _tracing.outbound_headers()
                    if deadline is not None:
                        out_headers[_policy.DEADLINE_HEADER] = \
                            deadline.header_value()
                    status, payload, headers = self._exchange(
                        w, method, body, out_headers, timeout)
                if status in GATEWAY_RETRY_STATUS:
                    # worker answered but can't serve: soft breaker
                    # strike (except shed — overload is not sickness),
                    # then budgeted retry on another worker
                    soft_tried.add(w.worker_id)
                    if status != 429:
                        self.breakers.breaker(addr).record_failure()
                    _metrics.safe_counter("gateway_retries_total",
                                          api=self.api_name,
                                          reason=f"status_{status}").inc()
                    last = (status, payload, headers)
                    if not self._spend_failover(attempts):
                        return status, payload, self._retry_after(headers)
                    attempts += 1
                    self.failovers += 1
                    continue
                if status == 504:
                    # the worker accepted but never answered — a dead
                    # batch thread is not "healthy", so repeated 504s
                    # must accumulate toward its breaker. Exempt under a
                    # client-clamped budget, and never retried either
                    # way: the client's budget is what ran out
                    if not budget_bound:
                        self.breakers.breaker(addr).record_failure()
                    _metrics.safe_counter("gateway_retries_total",
                                          api=self.api_name,
                                          reason="status_504").inc()
                    return status, payload, self._retry_after(headers)
                self.breakers.breaker(addr).record_success()
                self.forwarded += 1
                # labeled by address, not worker_id: ids are minted per
                # worker start, so churn under failover would grow the
                # registry (and every scrape) one dead series per
                # replacement; the host:port slot set is bounded
                _metrics.safe_counter("gateway_forwarded_total",
                                      api=self.api_name,
                                      worker=addr).inc()
                return status, payload, headers
            except (OSError, http.client.HTTPException) as e:
                timed_out = isinstance(e, TimeoutError)
                if timed_out and budget_bound:
                    # the CLIENT's clamped budget expired mid-hop, not
                    # our request_timeout: answering 504 without a
                    # breaker strike keeps impatient clients from
                    # evicting healthy workers
                    _metrics.safe_counter("gateway_retries_total",
                                          api=self.api_name,
                                          reason="client_budget").inc()
                    return 504, b'{"error": "deadline exceeded"}', \
                        self._retry_after()
                # connection-level failure OR a worker dying mid-response
                # (BadStatusLine/IncompleteRead): the worker is GONE —
                # drop its pooled keep-alive sockets (they share the fate
                # of the one that just died), open its breaker now, retry
                # on another worker; the health loop's half-open probes
                # readmit it on recovery.
                self._pool.clear(w.host, w.port)
                # A read TIMEOUT is the one exception: the worker
                # accepted the connection and is merely slow — the same
                # condition the 504 branch above insists must only
                # ACCUMULATE toward the breaker, so a one-strike open
                # here would evict a busy-but-healthy worker exactly
                # when the cluster is short of capacity
                hard_tried.add(w.worker_id)
                self.breakers.breaker(addr).record_failure(
                    hard=not timed_out)
                _metrics.safe_counter("gateway_failovers_total",
                                      api=self.api_name).inc()
                # labeled by failure class (a bounded set), so silent
                # failovers separate into "worker gone" vs "worker sick"
                _metrics.safe_counter("gateway_retries_total",
                                      api=self.api_name,
                                      reason=type(e).__name__).inc()
                logger.warning("failover: worker %s (%s) failed: %s",
                               w.worker_id, addr, e,
                               api=self.api_name,
                               reason=type(e).__name__)
                self.federation.last_failover = {
                    "ts": time.time(), "worker": w.worker_id,
                    "addr": addr,
                    "reason": f"{type(e).__name__}: {e}"}
                _flight.record("gateway_failover",
                               api=self.api_name, worker=w.worker_id,
                               addr=addr,
                               reason=f"{type(e).__name__}: {e}")
                if not self._spend_failover(attempts):
                    # exhaustion precedence: an expired client budget
                    # reads as 504, not a fleet-wide 502
                    if deadline is not None and deadline.expired:
                        return 504, b'{"error": "deadline exceeded"}', \
                            self._retry_after()
                    return 502, b'{"error": "all workers failed"}', \
                        self._retry_after()
                attempts += 1
                self.failovers += 1
            finally:
                with self._lock:
                    self._inflight[addr] = max(
                        0, self._inflight.get(addr, 1) - 1)

    def _exchange(self, w: WorkerInfo, method: str, body,
                  out_headers: Dict[str, str], timeout: float):
        """One gateway->worker HTTP exchange over the keep-alive pool:
        ``(status, payload, headers)``.

        Stale-socket recovery: a failure on a REUSED pooled connection
        retries here on a fresh connection (without a breaker strike or
        failover; each discarded socket is counted in
        ``gateway_stale_connections_total``) ONLY when the worker
        provably never processed the request — the send itself failed,
        or the worker closed its keep-alive side cleanly before emitting
        a single response byte (``RemoteDisconnected``: the idle-reap /
        restart signature). A mid-response failure (``IncompleteRead``,
        a reset after bytes arrived) or a timeout means a handler HAS
        the request — re-sending would double-score, so those propagate
        to the failover/breaker machinery exactly like fresh-socket
        failures."""
        while True:
            conn, reused = self._pool.acquire(w.host, w.port, timeout)
            t0 = time.perf_counter()
            try:
                conn.request(method, f"/{w.api_name}", body=body,
                             headers=out_headers)
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused and not isinstance(e, TimeoutError):
                    _metrics.safe_counter("gateway_stale_connections_total",
                                          api=self.api_name).inc()
                    continue    # drains any other stale pooled sockets too
                raise
            try:
                resp = conn.getresponse()
                payload = resp.read()
            except http.client.RemoteDisconnected:
                conn.close()
                if reused:
                    _metrics.safe_counter("gateway_stale_connections_total",
                                          api=self.api_name).inc()
                    continue
                raise
            except (OSError, http.client.HTTPException):
                conn.close()
                raise
            headers = {"Content-Type":
                       resp.getheader("Content-Type", "text/plain")}
            # shed/drain hints must reach the client
            ra = resp.getheader("Retry-After")
            if ra:
                headers["Retry-After"] = ra
            self._latency.update(time.perf_counter() - t0)
            # a fully-read response leaves the connection reusable unless
            # the worker announced close
            self._pool.release(w.host, w.port, conn,
                               reusable=not resp.will_close)
            if reused:
                _metrics.safe_counter("gateway_connection_reuse_total",
                                      api=self.api_name).inc()
            return resp.status, payload, headers

    # -- health / breaker recovery -------------------------------------------
    def _health_loop(self):
        while not self._stop.wait(self.health_interval):
            try:
                self._probe_half_open()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                _flight.record("health_loop_error", api=self.api_name,
                               error=f"{type(e).__name__}: {e}")

    def _probe_half_open(self):
        """Half-open probes piggyback on the health sweep: an open
        breaker past its cooldown goes half-open and gets ONE probe per
        sweep — live traffic never probes a sick worker itself."""
        addrs = {self._addr(w): w for w in self.registry.workers()}
        for addr, br in self.breakers.items():
            if addr not in addrs:
                # worker left the registry: prune its breaker — under
                # ephemeral-port churn a board keyed by dead addresses
                # would grow (and re-open against) slots nobody routes to
                # — and its pooled keep-alive sockets with it
                self.breakers.forget(addr)
                host, _, port = addr.rpartition(":")
                if port.isdigit():
                    self._pool.clear(host, int(port))
                continue
            if br.state == _policy.OPEN and br.probe_due():
                br.begin_probe()
            if br.state != _policy.HALF_OPEN:
                continue
            if self._probe_worker(addrs[addr], addr):
                br.probe_success()
            else:
                br.probe_failure()

    def _probe_worker(self, w: WorkerInfo, addr: str) -> bool:
        # fault site: a failing probe keeps the breaker open — chaos can
        # hold a recovered worker out of rotation deterministically
        act = _failpoints.fault_point("gateway.probe", worker=addr)
        if act is not None and act.status is not None:
            return False
        try:  # probe: TCP connect is enough to readmit
            conn = http.client.HTTPConnection(w.host, w.port, timeout=1.0)
            conn.connect()
            conn.close()
            return True
        except OSError:
            return False


# ---------------------------------------------------------------------------
# Deployment helper
# ---------------------------------------------------------------------------


class DistributedServing:
    """N serving workers + gateway in one process (per-host worker pools);
    multi-host deployments run one of these per host against a shared
    file-backed registry and any one gateway (or one per region)."""

    def __init__(self, transform: Callable[[Dataset], Dataset],
                 num_workers: int = 2, host: str = "localhost",
                 api_name: str = "serving", max_batch: int = 32,
                 max_latency_ms: float = 5.0,
                 registry: Optional[ServiceRegistry] = None,
                 engine: Optional[str] = None):
        from .aserve import resolve_engine
        self.registry = registry or ServiceRegistry()
        self.workers: List[ServingQuery] = []
        self._infos: List[WorkerInfo] = []
        use_async = resolve_engine(engine) == "async"
        for _ in range(num_workers):
            if use_async:
                from .aserve import AsyncServingQuery, AsyncServingServer
                aserver = AsyncServingServer(host, 0, api_name,
                                             slots=max_batch)
                q: Any = AsyncServingQuery(aserver, transform=transform)
            else:
                server = ServingServer(host, 0, api_name)
                q = ServingQuery(server, transform, max_batch=max_batch,
                                 max_latency=max_latency_ms / 1000.0)
            info = WorkerInfo(worker_id=uuid.uuid4().hex[:12], host=host,
                              port=q.server.port, api_name=api_name)
            self.workers.append(q)
            self._infos.append(info)
        self.gateway = GatewayServer(self.registry, host, 0, api_name)

    def start(self) -> "DistributedServing":
        for q, info in zip(self.workers, self._infos):
            q.start()
            # async workers bind (and learn an ephemeral port) at
            # start() — the registry entry must carry the real port
            info.port = q.server.port
            self.registry.register(info)
        self.gateway.start()
        return self

    def stop(self) -> None:
        self.gateway.stop()
        for q, info in zip(self.workers, self._infos):
            self.registry.deregister(info.worker_id)
            q.stop()

    @property
    def url(self) -> str:
        return self.gateway.url

    def kill_worker(self, i: int) -> WorkerInfo:
        """Crash-simulation hook (tests): stop worker i without deregistering
        — the gateway must discover the failure and fail over."""
        self.workers[i].stop()
        return self._infos[i]
