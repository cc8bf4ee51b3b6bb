"""The async serving plane: loop front + slot admission + one scorer.

Threading model (three kinds of threads, one owner each):

- **the event loop thread** owns every socket and all admission state
  transitions: it parses requests, answers debug routes, sheds, decodes
  feature rows into the forming staging buffer, and resolves reply
  futures (the scoring thread hands replies back via
  ``call_soon_threadsafe`` — exactly one thread ever touches a future).
- **the scoring thread** owns the device: it waits for the forming
  batch to be non-empty, flips the slot table, runs the transform /
  scorer, and ships replies back to the loop. Continuous batching falls
  out of this split — while the scorer is on the device with batch N,
  the loop keeps admitting into batch N+1's slots, so a late request
  joins the already-forming batch and rides the next dispatch instead
  of waiting out a ``get_batch`` window.
- **caller threads** (tests, ``serving_main``) drive lifecycle:
  ``start`` / ``stop`` / ``drain``.

Cross-thread state (``_forming`` / ``_pending`` / ``_inflight``) sits
under one ``threading.Lock`` with an ``Event`` for the scorer's wakeup;
critical sections are a few appends, so the loop never blocks
meaningfully.

Contract parity with ``io/serving.py`` is deliberate and test-enforced:
same metric families (so the gateway's federation-fed routing sees both
engines identically), same debug routes via the shared
:func:`~..serving.debug_body` funnel, same deadline / shed / drain /
requeue-once semantics, same ``serving.handle`` / ``serving.batch``
failpoints.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional


from ...core.dataset import Dataset
from ...observability import flight as _flight
from ...observability import metrics as _metrics
from ...observability import slo as _slo
from ...observability import spans as _spans
from ...observability import tracing as _tracing
from ...observability import watchdog as _watchdog
from ...observability.logging import get_logger
from ...robustness import failpoints as _failpoints
from ...robustness import policy as _policy
from ... import tuning as _tuning
from ..serving import (_BATCH_SIZE_BUCKETS, debug_body, debug_query,
                       debug_route, observe_request_stages, stage_breakdown)
from .http import BadRequest, ParsedRequest, read_request, write_response
from .slots import SlotTable, dtype_name, resolve_slots, staging_torch_dtype

logger = get_logger("mmlspark_tpu_torch.io.aserve")


class RowSpec:
    """Zero-copy admission config: how a request's JSON becomes one row
    of the slot table. ``extract`` is a key into the parsed body (or a
    callable over it) yielding a length-``width`` feature sequence.
    ``dtype`` is the predict lane's STAGING dtype and ``quantizer`` its
    admission transform (``quantize.row_quantizer``; None = plain
    cast) — a quantized lane decodes requests straight into narrow
    staged rows, so the per-dispatch h2d ships int8/bf16 bytes.
    ``pin_memory`` puts the slot table in page-locked host memory (set
    for a ``cuda`` scorer)."""

    __slots__ = ("width", "extract", "dtype", "quantizer", "pin_memory")

    def __init__(self, width: int, extract="features", dtype="float32",
                 quantizer=None, pin_memory: bool = False):
        self.width = int(width)
        self.extract = extract
        self.dtype = dtype
        self.quantizer = quantizer
        self.pin_memory = bool(pin_memory)

    def features(self, value: Any):
        if callable(self.extract):
            return self.extract(value)
        return (value or {})[self.extract]


class AsyncRequest:
    """One in-flight request, parked as a future on the event loop."""

    __slots__ = ("id", "method", "path", "headers", "body", "value",
                 "trace", "deadline", "enqueued_at", "dispatched_at",
                 "scored_at", "requeued", "slot", "future")

    def __init__(self, parsed: ParsedRequest, trace, deadline, future):
        self.id = uuid.uuid4().hex
        self.method = parsed.method
        self.path = parsed.path
        self.headers = parsed.headers
        self.body = parsed.body
        self.value: Any = None
        self.trace = trace
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        # stage-decomposition marks (monotonic): batch dispatch / reply
        self.dispatched_at = 0.0
        self.scored_at = 0.0
        self.requeued = False
        self.slot: Optional[int] = None
        self.future = future


class AsyncServingServer:
    """Event-loop HTTP front with slot-table admission.

    The async analog of :class:`~..serving.ServingServer`: same
    ``host``/``port``/``api_name``/``request_timeout``/
    ``max_queue_depth`` surface, same ``url`` property, same
    ``begin_drain`` semantics — so builders, ``serving_main``, and the
    gateway treat both engines identically.
    """

    def __init__(self, host: str = "localhost", port: int = 0,
                 api_name: str = "serving", request_timeout: float = 30.0,
                 max_queue_depth: Optional[int] = None,
                 slots: int = 32, row_spec: Optional[RowSpec] = None):
        self.api_name = api_name
        self.request_timeout = request_timeout
        self.max_queue_depth = (
            max_queue_depth if max_queue_depth is not None
            else _policy.env_int("MMLSPARK_TPU_MAX_QUEUE_DEPTH", 512))
        row_bytes = (row_spec.width
                     * staging_torch_dtype(row_spec.dtype).itemsize
                     if row_spec is not None else None)
        self.slots = resolve_slots(slots, row_bytes=row_bytes)
        self.row_spec = row_spec
        self.slot_table: Optional[SlotTable] = None
        if row_spec is not None:
            self.slot_table = SlotTable(self.slots, row_spec.width,
                                        row_spec.dtype,
                                        quantizer=row_spec.quantizer,
                                        pin_memory=row_spec.pin_memory)
        # tuning evidence: the geometry the slot-sizing decision (site 4)
        # reconciles against the aserve_slots HBM claim headroom
        if row_bytes:
            _tuning.note_slot_geometry(row_bytes, self.slots)
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        #: pulsed when the forming batch goes non-empty (scorer wakeup)
        self._wake = threading.Event()
        #: pulsed on every reply/requeue so drain/await_served can wait
        #: on progress instead of sleep-polling (threaded parity)
        self._progress = threading.Event()
        self._forming: List[AsyncRequest] = []
        self._first_arrival = 0.0
        self._pending: deque = deque()
        self._inflight: Dict[str, AsyncRequest] = {}
        self._draining = False
        self._started = False
        self._service_ewma = _policy.Ewma()
        self._wait_ewma = _policy.Ewma()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._init_error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AsyncServingServer":
        with self._lock:
            if self._started:
                return self
            # fresh readiness state per attempt: a retry after a failed
            # bind must run the bind again, not read last attempt's error
            self._ready = threading.Event()
            self._init_error = None
            self._thread = threading.Thread(
                target=self._run_loop, name="mmlspark-aserve-loop",
                daemon=True)
            self._thread.start()
            self._started = True
        if self._ready.wait(timeout=10) and self._init_error is None:
            return self
        # failed start keeps failing loudly: the flag must not stay set,
        # or every retry silently no-ops against a dead instance (the
        # ServingServer mid-start rule, async analog)
        err = self._init_error
        with self._lock:
            self._started = False
        raise RuntimeError("async serving loop failed to come up"
                           if err is None
                           else f"async serving bind failed: {err}")

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(
                asyncio.start_server(self._handle_conn, self.host,
                                     self.port, backlog=256))
            addr = self._server.sockets[0].getsockname()
            self.host, self.port = addr[0], addr[1]
        except BaseException as e:  # noqa: BLE001 — surfaced in start()
            with self._lock:
                self._init_error = e
            self._ready.set()
            loop.close()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            to_cancel = asyncio.all_tasks(loop)
            for task in to_cancel:
                task.cancel()
            if to_cancel:
                loop.run_until_complete(
                    asyncio.gather(*to_cancel, return_exceptions=True))
            loop.close()

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            self._started = False
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self._shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.slot_table is not None:
            self.slot_table.release_claim()
        # persist tuning evidence + any pending decisions so the NEXT
        # process starts tuned (no-op when tuning is disabled)
        _tuning.flush()

    def _shutdown(self) -> None:
        # on the loop: close the listener, then stop — run_forever's
        # finally cancels the handler tasks and closes their sockets
        if self._server is not None:
            self._server.close()
        assert self._loop is not None
        self._loop.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/{self.api_name}"

    # -- resilience --------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Refuse new traffic (503 + Retry-After); admitted requests and
        formed batches keep flowing to completion. Safe from any thread:
        admission checks the flag under the same lock."""
        with self._lock:
            self._draining = True
        _metrics.safe_gauge("serving_draining", api=self.api_name).set(1)

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def has_inflight(self, request_id: str) -> bool:
        with self._lock:
            return request_id in self._inflight

    def backlog(self) -> int:
        with self._lock:
            return len(self._pending) + len(self._forming)

    def _shed(self, reason: str) -> None:
        _metrics.safe_counter("serving_shed_total", api=self.api_name,
                              reason=reason).inc()
        _flight.record("shed", api=self.api_name, reason=reason,
                       depth=self.backlog())

    def _update_queue_depth(self) -> None:
        """The ONE writer of ``serving_queue_depth`` for this engine —
        the same single-writer rule (and family name) as the threaded
        stack, so federation-fed gateway routing reads both engines
        identically."""
        _metrics.safe_gauge("serving_queue_depth", api=self.api_name).set(
            self.backlog())

    def observe_batch(self, n: int, seconds: float) -> None:
        if n > 0:
            self._service_ewma.update(seconds / n)
            _tuning.observe_score(seconds)

    def retry_after_hint(self) -> Dict[str, str]:
        per_req = self._service_ewma.value or 0.0
        est = (self.backlog() + 1) * per_req
        wait = self._wait_ewma.value
        if wait:
            est = max(est, wait)
        return {"Retry-After": str(_policy.retry_after_seconds(est))}

    # -- admission (event loop thread) -------------------------------------
    def _admit(self, req: AsyncRequest) -> str:
        """Admission verdict under the lock: ``"slot"`` (decoded into
        the forming batch), ``"queued"`` (parked in pending — it will be
        promoted as slots free), ``"full"`` (shed 429), or
        ``"draining"`` (shed 503)."""
        with self._lock:
            if self._draining:
                return "draining"
            if len(self._forming) < self.slots:
                return self._place(req)
            if self.max_queue_depth and \
                    len(self._pending) >= self.max_queue_depth:
                return "full"
            self._pending.append(req)
            return "queued"

    def _place(self, req: AsyncRequest) -> str:
        # caller holds self._lock; decoding here is safe because only
        # the loop thread writes the forming buffer and only flip()
        # (also under the lock) retargets it
        slot = len(self._forming)
        if self.slot_table is not None:
            self.slot_table.write(slot, self.row_spec.features(req.value))
        req.slot = slot
        if not self._forming:
            self._first_arrival = time.monotonic()
        self._forming.append(req)
        self._wake.set()
        return "slot"

    def _promote(self) -> None:
        """Loop-side refill after a dispatch: move pending requests into
        the freshly-freed forming slots (decoding their rows), i.e.
        "admitted into the in-flight device batch as slots free"."""
        with self._lock:
            while self._pending and len(self._forming) < self.slots:
                req = self._pending.popleft()
                if req.future.done():
                    continue          # handler already gave up (timeout)
                try:
                    self._place(req)
                except Exception as e:  # noqa: BLE001 — decode error
                    self._resolve(req, 400, json.dumps(
                        {"error": f"bad features: {e}"}).encode(),
                        {"Content-Type": "application/json"})
        self._update_queue_depth()

    # -- reply routing (event loop thread) ---------------------------------
    def _resolve(self, req: AsyncRequest, status: int, payload: bytes,
                 headers: Dict[str, str]) -> None:
        req.scored_at = time.monotonic()   # stage mark: score ends
        if not req.future.done():
            req.future.set_result((status, payload, headers))
        self._progress.set()

    def reply_from_scorer(self, req: AsyncRequest, status: int,
                          entity: Any,
                          headers: Optional[Dict[str, str]] = None) -> None:
        """Scoring-thread half of the reply path: serialize here (off
        the loop), hand the bytes across via ``call_soon_threadsafe``."""
        if not isinstance(entity, (bytes, str)) and entity is not None:
            entity = json.dumps(entity)
            headers = {"Content-Type": "application/json", **(headers or {})}
        if isinstance(entity, str):
            entity = entity.encode("utf-8")
        self._post(self._resolve, req, status, entity or b"",
                   headers or {})

    def schedule_promote(self) -> None:
        self._post(self._promote)

    def readmit(self, survivors: List[AsyncRequest]) -> None:
        """Crash recovery (requeue-once): push the batch's unanswered
        requests back at the FRONT of pending, preserving order."""
        def _do():
            with self._lock:
                for req in reversed(survivors):
                    self._pending.appendleft(req)
            self._promote()
        self._post(_do)

    def _post(self, fn, *args) -> None:
        """Hand work to the event loop from the scoring thread; a loop
        already torn down (stop() racing a reply) drops it — the
        handlers those replies were for are gone with the loop."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass

    # -- batch take (scoring thread) ---------------------------------------
    def _hold_forming(self, hold: float) -> None:
        """Tuning site 3 (dispatch pacing): keep the forming buffer open
        up to ``hold`` seconds past its first arrival so a memory-bound,
        under-occupied score stage dispatches fuller batches — the extra
        rows ride the same HBM sweep. Exits early the moment the buffer
        fills, drain starts, or the endpoint's SLO fast-window burn
        exceeds 1 (a breaching endpoint is NEVER held — latency budget
        already gone)."""
        waited = False
        while True:
            with self._lock:
                n = len(self._forming)
                if n == 0 or n >= self.slots or self._draining:
                    break
                deadline = self._first_arrival + hold
            if _slo.current_burn(self.api_name) > 1.0:
                _metrics.safe_counter("tuning_hold_outcomes_total",
                                      api=self.api_name,
                                      outcome="burn_bypass").inc()
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            waited = True
            # ride the admission wake event, not a bare sleep: a new
            # arrival re-checks occupancy immediately (a buffer that
            # fills mid-hold dispatches early), and the slice bound
            # keeps the burn check fresh while idle
            self._wake.clear()
            self._wake.wait(min(remaining, max(hold / 4.0, 0.0002)))
        if waited:
            _metrics.safe_counter("tuning_hold_outcomes_total",
                                  api=self.api_name, outcome="held").inc()

    def take_batch(self, timeout: float):
        """``(batch, buffer)`` the moment anything has formed — the
        continuous half: no latency window by default, the device's
        readiness IS the dispatch trigger (the auto-tuner's hold window,
        when one is decided, is the measured exception — see
        :meth:`_hold_forming`). ``buffer`` is the dispatched staging
        array in rows mode (None in dataset mode)."""
        self._wake.wait(timeout)
        hold = _tuning.resolve_hold_window()
        if hold > 0.0:
            self._hold_forming(hold)
        with self._lock:
            if not self._forming:
                self._wake.clear()
                return [], None
            batch = self._forming
            self._forming = []
            self._wake.clear()
            buf = (self.slot_table.flip()
                   if self.slot_table is not None else None)
            t_first = self._first_arrival
        self.schedule_promote()
        now = time.monotonic()
        _metrics.safe_histogram("serving_batch_assembly_seconds",
                                api=self.api_name).observe(
            max(0.0, now - t_first))
        # tuning evidence feeds (sites 2/3/4): admitted-batch rows +
        # forming wait, matched against observe_batch's score wall
        _tuning.observe_batch_size(len(batch))
        _tuning.observe_forming_wait(max(0.0, now - t_first))
        wait_h = _metrics.safe_histogram("serving_queue_wait_seconds",
                                         api=self.api_name)
        for r in batch:
            r.dispatched_at = now       # stage mark: forming_wait ends
            w = now - r.enqueued_at
            wait_h.observe(w)
            self._wait_ewma.update(w)
        self._update_queue_depth()
        return batch, buf

    # -- connection handling (event loop thread) ---------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    parsed = await read_request(reader)
                except BadRequest as e:
                    await write_response(
                        writer, e.status,
                        json.dumps({"error": str(e)}).encode(),
                        {"Content-Type": "application/json"},
                        keep_alive=False,
                        counter="serving_responses_total",
                        api=self.api_name)
                    return
                if parsed is None:
                    return
                try:
                    keep = await self._handle_request(parsed, writer)
                except _failpoints.InjectedFault:
                    # connection-drop chaos: die like the threaded
                    # handler thread would — no bytes, socket closed
                    return
                if not keep:
                    return
        except (ConnectionError, asyncio.CancelledError):
            return
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — already gone
                pass

    async def _handle_request(self, parsed: ParsedRequest,
                              writer: asyncio.StreamWriter) -> bool:
        api = self.api_name
        keep = parsed.keep_alive
        # debug routes first (parity: they stay readable mid-chaos and
        # mid-overload), behind the same enabled() gate
        if _metrics.enabled():
            route = debug_route(parsed.method, parsed.path, api)
            if route is not None:
                body, ctype = debug_body(route, api,
                                         query=debug_query(parsed.path))
                counter = (None if route == "metrics"
                           else "debug_requests_total")
                if counter:
                    await write_response(writer, 200, body,
                                         {"Content-Type": ctype}, keep,
                                         counter=counter, api=api,
                                         endpoint=route)
                else:
                    await write_response(writer, 200, body,
                                         {"Content-Type": ctype}, keep)
                return keep
        # fault evaluation runs OFF the loop: a `delay` rule sleeps
        # inside fault_point, and one blocking sleep here would stall
        # every in-flight connection instead of the one request chaos
        # meant to slow (the async-blocking-call invariant, applied to
        # a sleep the lint can't see). Gated so the no-chaos hot path
        # stays one falsy check, byte-identical to the threaded engine.
        act = None
        if _failpoints.ensure_configured():
            act = await asyncio.to_thread(
                _failpoints.fault_point, "serving.handle", api=api)
        if act is not None and act.status is not None:
            await write_response(writer, act.status,
                                 b'{"error": "injected"}',
                                 keep_alive=keep,
                                 counter="serving_responses_total",
                                 api=api)
            return keep
        deadline = _policy.Deadline.from_headers(parsed.headers)
        if deadline is not None and deadline.expired:
            _metrics.safe_counter("serving_deadline_dropped_total",
                                  api=api, stage="admission").inc()
            await write_response(writer, 504,
                                 b'{"error": "deadline exceeded"}',
                                 keep_alive=keep,
                                 counter="serving_responses_total",
                                 api=api)
            return keep
        ctx = _tracing.context_from_headers(parsed.headers)
        token = _tracing.activate(ctx) if ctx is not None else None
        t0 = time.perf_counter()
        # monotonic twin of t0: stage marks live on the monotonic clock,
        # so the decomposition sums track the observed wall time
        t0_mono = time.monotonic()
        req: Optional[AsyncRequest] = None
        inflight = _metrics.safe_gauge("serving_inflight_requests",
                                       api=api)
        inflight.inc()
        status = 504
        try:
            with _spans.span("serving_request", api=api,
                             method=parsed.method, path=parsed.path):
                assert self._loop is not None
                req = AsyncRequest(parsed, ctx, deadline,
                                   self._loop.create_future())
                if self.row_spec is not None:
                    try:
                        req.value = (json.loads(parsed.body.decode("utf-8"))
                                     if parsed.body else None)
                    except ValueError:
                        await write_response(
                            writer, 400, b'{"error": "bad json"}',
                            keep_alive=keep)
                        status = 400
                        return keep
                try:
                    verdict = self._admit(req)
                except Exception as e:  # noqa: BLE001 — row decode error
                    await write_response(
                        writer, 400,
                        json.dumps({"error":
                                    f"bad features: {e}"}).encode(),
                        {"Content-Type": "application/json"}, keep)
                    status = 400
                    return keep
                if verdict == "draining":
                    self._shed("draining")
                    await write_response(writer, 503,
                                         b'{"error": "draining"}',
                                         self.retry_after_hint(), keep)
                    status = 503
                    return keep
                if verdict == "full":
                    self._shed("queue_full")
                    await write_response(writer, 429,
                                         b'{"error": "overloaded"}',
                                         self.retry_after_hint(), keep)
                    status = 429
                    return keep
                with self._lock:
                    self._inflight[req.id] = req
                self._update_queue_depth()
                wait_s = self.request_timeout
                if deadline is not None:
                    wait_s = min(wait_s, deadline.remaining_seconds())
                try:
                    resp_status, payload, hdrs = await asyncio.wait_for(
                        req.future, timeout=max(0.0, wait_s))
                except asyncio.TimeoutError:
                    _flight.record("request_timeout", api=api,
                                   request_id=req.id)
                    echo = ({} if ctx is None else
                            {_tracing.REQUEST_ID_HEADER: ctx.trace_id})
                    await write_response(writer, 504, b"", echo, keep)
                    return keep
                finally:
                    with self._lock:
                        self._inflight.pop(req.id, None)
                    self._progress.set()
                status = resp_status
                echo = ({} if ctx is None else
                        {_tracing.REQUEST_ID_HEADER: ctx.trace_id})
                await write_response(writer, status, payload,
                                     {**hdrs, **echo}, keep)
                return keep
        finally:
            inflight.dec()
            _metrics.safe_counter("serving_responses_total", api=api,
                                  code=str(status)).inc()
            dt = time.perf_counter() - t0
            _metrics.safe_histogram("serving_request_seconds",
                                    api=api).observe(dt)
            stages = None
            if req is not None and _metrics.enabled():
                stages = stage_breakdown(
                    t0_mono, req.enqueued_at, req.dispatched_at,
                    req.scored_at, time.monotonic())
                observe_request_stages(api, stages)
            _slo.observe_request(
                api, dt, status, stages=stages,
                trace_id=None if ctx is None else ctx.trace_id)
            _tracing.maybe_mark_slow("serving_request_seconds", dt,
                                     stages=stages, api=api)
            if token is not None:
                _tracing.deactivate(token)


class AsyncServingQuery:
    """Scoring loop over the slot table: the async ``ServingQuery``.

    Two scoring modes share the batching machinery:

    - **dataset mode** (``transform=``): the threaded engine's exact
      contract — ``Dataset -> Dataset`` with a reply column, fed from
      ``requests_to_dataset``. How ``serve().engine("async")`` and the
      gateway-transparent deployments run.
    - **rows mode** (``scorer=`` on a server built with a
      :class:`RowSpec`): zero-copy — the scorer receives the dispatched
      staging buffer's pow2-bucket VIEW (no per-batch materialization)
      and returns one prediction per live row. ``reply_fn(req, pred)``
      builds each reply entity (default ``{"prediction": pred}``).
    """

    def __init__(self, server: AsyncServingServer,
                 transform: Optional[Callable[[Dataset], Dataset]] = None,
                 reply_col: str = "reply",
                 scorer: Optional[Callable] = None,
                 reply_fn: Optional[Callable] = None):
        if (transform is None) == (scorer is None):
            raise ValueError("exactly one of transform= (dataset mode) "
                             "or scorer= (rows mode) is required")
        if scorer is not None and server.slot_table is None:
            raise ValueError("rows mode needs a server built with a "
                             "RowSpec (the slot table)")
        self.server = server
        self.transform = transform
        self.reply_col = reply_col
        self.scorer = scorer
        self.reply_fn = reply_fn or (lambda req, pred:
                                     {"prediction": _to_jsonable(pred)})
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mmlspark-aserve-score",
                                        daemon=True)
        self.batches_served = 0
        self.requests_served = 0

    # -- lifecycle (threaded-parity surface) -------------------------------
    def start(self) -> "AsyncServingQuery":
        self.server.start()
        if self.scorer is not None:
            # observability parity for the zero-copy path: the staging
            # decision (slot count, dtype) lands in the flight ring like
            # every placement decision (the h2d itself is the upload in
            # Booster.predict)
            _flight.record("placement", site="aserve.slots",
                           decision="staging",
                           slots=self.server.slots,
                           width=self.server.row_spec.width,
                           dtype=dtype_name(self.server.row_spec.dtype))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.server._wake.set()
        self._thread.join(timeout=5)
        self.server.stop()

    def drain(self, settle_seconds: Optional[float] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
        """Graceful shutdown, same contract (and env knobs) as the
        threaded engine: settle, refuse (503 + Retry-After), flush every
        admitted request, stop — zero client-visible errors."""
        api = self.server.api_name
        if settle_seconds is None:
            settle_seconds = _policy.env_float(
                "MMLSPARK_TPU_DRAIN_SETTLE_SECONDS", 0.5)
        if timeout is None:
            timeout = _policy.env_float(
                "MMLSPARK_TPU_DRAIN_TIMEOUT_SECONDS", 30.0)
        t0 = time.monotonic()
        _flight.record("drain_begin", api=api,
                       queued=self.server.backlog(),
                       inflight=self.server.inflight_count())
        logger.info("drain begin", api=api, settle_seconds=settle_seconds)
        if settle_seconds > 0:
            time.sleep(settle_seconds)
        self.server.begin_drain()
        end = time.monotonic() + timeout
        clean = False
        progress = self.server._progress
        while True:
            if (self.server.backlog() == 0
                    and self.server.inflight_count() == 0):
                clean = True
                break
            remaining = end - time.monotonic()
            if remaining <= 0:
                break
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

    # -- scoring loop (the one thread that owns the device) ----------------
    def _run(self) -> None:
        api = self.server.api_name
        hb = _watchdog.register(f"serving_batch:{api}", stall_seconds=120.0)
        try:
            while not self._stop.is_set():
                hb.beat()
                batch, buf = self.server.take_batch(timeout=0.05)
                if not batch:
                    continue
                batch, buf = self._drop_expired(batch, buf, api)
                if not batch:
                    continue
                self._score_one(batch, buf, api)
        finally:
            hb.close()

    def _drop_expired(self, batch: List[AsyncRequest], buf, api: str):
        """504 co-batched requests whose deadline already passed, and
        compact the staging rows over the holes (error path only — the
        happy path moves zero rows)."""
        live: List[AsyncRequest] = []
        for r in batch:
            if r.deadline is not None and r.deadline.expired:
                _metrics.safe_counter("serving_deadline_dropped_total",
                                      api=api, stage="batch").inc()
                _flight.record("deadline_dropped", api=api,
                               request_id=r.id)
                if self.server.has_inflight(r.id):
                    self.server.reply_from_scorer(
                        r, 504, {"error": "deadline exceeded"})
            else:
                live.append(r)
        if buf is not None and len(live) != len(batch):
            for j, r in enumerate(live):
                if r.slot != j:
                    buf[j] = buf[r.slot]
                    r.slot = j
        return live, buf

    def _score_one(self, batch: List[AsyncRequest], buf, api: str) -> None:
        _metrics.safe_histogram("serving_batch_size", api=api,
                                buckets=_BATCH_SIZE_BUCKETS).observe(
            len(batch))
        t0 = time.perf_counter()
        traces = [r.trace for r in batch if r.trace is not None]
        ctx = traces[0] if traces else None
        token = _tracing.activate(ctx) if ctx is not None else None
        try:
            _failpoints.fault_point("serving.batch", api=api)
            with _spans.span("serving_transform", api=api,
                             batch_size=len(batch),
                             trace_ids=[t.trace_id for t in traces]):
                if self.scorer is not None:
                    self._score_rows(batch, buf)
                else:
                    self._score_dataset(batch)
            self.batches_served += 1
            self.requests_served += len(batch)
            self.server._progress.set()
            dt = time.perf_counter() - t0
            self.server.observe_batch(len(batch), dt)
            _metrics.safe_counter("serving_batches_total", api=api).inc()
            _metrics.safe_histogram("serving_transform_seconds",
                                    api=api).observe(dt)
        except Exception as e:  # noqa: BLE001 — requeue-once recovery
            survivors = [r for r in batch
                         if not r.requeued and not r.future.done()]
            for r in survivors:
                r.requeued = True
            logger.error("batch transform failed: %s: %s",
                         type(e).__name__, e, api=api,
                         batch_size=len(batch), requeued=len(survivors))
            _flight.record("batch_error", api=api, batch_size=len(batch),
                           requeued=len(survivors),
                           error=f"{type(e).__name__}: {e}")
            _metrics.safe_counter("serving_batch_failures_total",
                                  api=api).inc()
            _metrics.safe_counter("serving_requeues_total", api=api).inc(
                len(survivors))
            for r in batch:
                if r not in survivors and not r.future.done():
                    self.server.reply_from_scorer(
                        r, 500, {"error": "internal"})
            if survivors:
                _flight.record("requeue", api=api, count=len(survivors))
                self.server.readmit(survivors)
        finally:
            if token is not None:
                _tracing.deactivate(token)

    def _score_rows(self, batch: List[AsyncRequest], buf) -> None:
        n = len(batch)
        view, _bucket = SlotTable.bucket_view(buf, n)
        # the scorer returns host results: its d2h waited for the stream
        # that carried the (pinned, non-blocking) upload of ``view``, so
        # ``buf`` is free once this call returns — the next flip() may
        # hand it back to the loop for rewriting
        preds = self.scorer(view)
        for i, req in enumerate(batch):
            self.server.reply_from_scorer(req, 200,
                                          self.reply_fn(req, preds[i]))

    def _score_dataset(self, batch: List[AsyncRequest]) -> None:
        from ..serving import requests_to_dataset
        by_id = {r.id: r for r in batch}
        out = self.transform(requests_to_dataset(batch))
        for rid, rep in zip(out["id"], out[self.reply_col]):
            req = by_id.pop(rid, None)
            if req is None:
                _metrics.safe_counter("serving_reply_unknown_total",
                                      api=self.server.api_name).inc()
                _flight.record("reply_unknown", api=self.server.api_name,
                               request_id=rid)
                continue
            if isinstance(rep, dict) and "entity" in rep:
                self.server.reply_from_scorer(
                    req, int(rep.get("statusCode", 200)),
                    rep.get("entity"),
                    rep.get("headers") or None)
            else:
                self.server.reply_from_scorer(req, 200, rep)


def _to_jsonable(v):
    """Late-bound import shim: keeps this module importable without
    dragging io/http.py's optional deps at package import."""
    from ..http import to_jsonable
    return to_jsonable(v)
