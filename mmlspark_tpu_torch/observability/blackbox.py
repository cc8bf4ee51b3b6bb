"""Fleet black-box recorder: the flight ring that survives its process.

Every per-process surface (flight ring, spans, SLO burn, tail samples)
dies with its process — a SIGKILLed worker takes its last seconds with
it. This module is the gateway-side answer: a bounded
:class:`FleetTimeline` the :class:`~.federation.MetricsFederator` sweep
feeds by pulling incremental ``/debug/flight?since=<seq>`` deltas from
every registered worker, merged with the gateway's own ring and with
worker lifecycle transitions (register/deregister, scrape death and
recovery, restarts, breaker flips arriving as flight events, autoscale
hints crossing 1.0) recorded as first-class timeline events.

The timeline is served at ``/debug/timeline``, dumped on
SIGUSR2/excepthook alongside the local ring (via
``flight.add_dump_callback``), and is the substrate for distributed
trace assembly: ``/debug/trace?id=<trace_id>`` groups timeline + span
events by ``trace_id`` into the stitched edge→gateway→worker tree, with
a Chrome trace-event export built on the one timebase every process
shares (wall clock).

Dedup contract: events are keyed ``(worker, seq)`` — the per-worker
scrape cursor only ever advances, so an event can enter the timeline at
most once even across scrape retries, worker deregister/re-register,
and ring wrap on the worker side. A pid change under the same label
resets the cursor (new process, new seq space) and records a
``worker_restarted`` lifecycle event.

Knobs: ``MMLSPARK_TPU_TIMELINE_EVENTS`` caps the timeline ring (default
8192); ``MMLSPARK_TPU_FLIGHT_SCRAPE=0`` disables the flight-delta pull
(the /metrics sweep continues untouched). Everything here is inert
behind the global telemetry kill switch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import env_registry as _env
from . import flight as _flight
from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "FleetTimeline", "assemble_trace", "local_trace_payload",
    "flight_scrape_enabled", "DEFAULT_TIMELINE_EVENTS",
    "TIMELINE_EVENTS_ENV", "FLIGHT_SCRAPE_ENV",
]

TIMELINE_EVENTS_ENV = "MMLSPARK_TPU_TIMELINE_EVENTS"
FLIGHT_SCRAPE_ENV = "MMLSPARK_TPU_FLIGHT_SCRAPE"
DEFAULT_TIMELINE_EVENTS = 8192

_FALSY = frozenset({"0", "false", "no", "off"})


def flight_scrape_enabled() -> bool:
    """The ``MMLSPARK_TPU_FLIGHT_SCRAPE`` toggle (default on). When off,
    the federation sweep never issues a ``/debug/flight`` request and
    never touches the timeline — byte-identical to the pre-timeline
    sweep."""
    return os.environ.get(FLIGHT_SCRAPE_ENV, "").strip().lower() \
        not in _FALSY


def _env_capacity() -> int:
    return max(1, _env.env_int(TIMELINE_EVENTS_ENV, DEFAULT_TIMELINE_EVENTS))


class FleetTimeline:
    """Bounded, thread-safe merge of a fleet's flight rings plus
    gateway-observed lifecycle transitions, in causal order."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = _env_capacity()
        self._lock = threading.Lock()
        self._buf: "collections.deque" = collections.deque(
            maxlen=max(1, int(capacity)))
        self._dropped = 0
        self._arrival = 0
        self._cursors: Dict[str, int] = {}
        self._pids: Dict[str, Any] = {}

    # -- ingest --------------------------------------------------------------
    def cursor(self, worker: str) -> int:
        """The next ``?since=`` value for ``worker`` (0 before any
        merge)."""
        with self._lock:
            return self._cursors.get(worker, 0)

    def extend(self, worker: str, snap: Dict[str, Any]) -> int:
        """Merge one worker's ``/debug/flight`` payload (full or
        ``?since=`` delta); returns the number of events added.

        Only events with ``seq >`` the stored cursor merge — the
        ``(worker, seq)`` dedup key. The payload's ``last_seq`` advances
        the cursor past events the worker's ring already evicted, so a
        slow scraper never re-requests a hole it can no longer fill."""
        events = snap.get("events") or []
        pid = snap.get("pid")
        restarted = False
        prev_pid = None
        with self._lock:
            cur = self._cursors.get(worker, 0)
            prev_pid = self._pids.get(worker)
            if pid is not None:
                if prev_pid is not None and prev_pid != pid:
                    restarted, cur = True, 0
                self._pids[worker] = pid
            added = 0
            for ev in events:
                seq = ev.get("seq")
                if not isinstance(seq, int) or seq <= cur:
                    continue
                cur = seq
                self._append_locked({**ev, "worker": worker,
                                     "source": "flight"})
                added += 1
            last = snap.get("last_seq")
            if isinstance(last, int) and last > cur:
                cur = last
            self._cursors[worker] = cur
        if restarted:
            self.lifecycle("worker_restarted", worker=worker,
                           pid=pid, prev_pid=prev_pid)
        return added

    def lifecycle(self, kind: str, worker: Optional[str] = None,
                  **fields: Any) -> None:
        """Record a fleet transition (register/deregister/scrape-death/
        restart/autoscale crossing) as a first-class timeline event."""
        if not _metrics.enabled():
            return
        ev: Dict[str, Any] = {"kind": kind, "ts": time.time(),
                              "source": "lifecycle"}
        if worker is not None:
            ev["worker"] = worker
        ev.update(fields)
        with self._lock:
            self._append_locked(ev)

    def _append_locked(self, ev: Dict[str, Any]) -> None:
        self._arrival += 1  # graftlint: disable=lock-discipline (caller holds self._lock; _append_locked is only reached from under it)
        ev["timeline_seq"] = self._arrival
        if len(self._buf) == self._buf.maxlen:
            self._dropped += 1  # graftlint: disable=lock-discipline (caller holds self._lock; deque maxlen evicts the oldest)
        self._buf.append(ev)

    def forget(self, worker: str) -> None:
        """Drop cursor/pid state for ``worker`` (tests; NOT called on
        deregister — keeping the cursor is what makes a deregister +
        re-register of the same process duplicate-free)."""
        with self._lock:
            self._cursors.pop(worker, None)
            self._pids.pop(worker, None)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._cursors.clear()
            self._pids.clear()
            self._dropped = 0
            self._arrival = 0

    # -- views ---------------------------------------------------------------
    def capacity(self) -> int:
        return self._buf.maxlen or DEFAULT_TIMELINE_EVENTS

    def dropped(self) -> int:
        return self._dropped

    def events(self) -> List[Dict[str, Any]]:
        """Causal-order copy: sorted by each event's wall-clock ``ts``
        (the one timebase all processes share), gateway arrival order as
        the tiebreak."""
        with self._lock:
            evs = [dict(e) for e in self._buf]
        evs.sort(key=lambda e: (float(e.get("ts") or 0.0),
                                e.get("timeline_seq") or 0))
        return evs

    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._cursors)

    def trace_ids(self, limit: int = 50) -> List[str]:
        """Distinct trace ids present, newest-first (the ``/debug/trace``
        listing when no ``?id=`` is given)."""
        seen: List[str] = []
        with self._lock:
            evs = list(self._buf)
        for ev in reversed(evs):
            tid = ev.get("trace_id")
            if tid and tid not in seen:
                seen.append(tid)
                if len(seen) >= limit:
                    break
        return seen

    def snapshot_payload(self) -> Dict[str, Any]:
        """The ``/debug/timeline`` body (and the dump format)."""
        with self._lock:
            cursors = dict(self._cursors)
            pids = dict(self._pids)
            drop = self._dropped
        return {
            "pid": os.getpid(),
            "time": time.time(),
            "capacity": self.capacity(),
            "dropped": drop,
            "scrape_enabled": flight_scrape_enabled(),
            "cursors": cursors,
            "worker_pids": pids,
            "events": self.events(),
        }

    def trace_payload(self, trace_id: Optional[str]) -> Dict[str, Any]:
        """The ``/debug/trace`` body: the stitched tree for one trace,
        or the id listing when none is named."""
        if not trace_id:
            return {"trace_id": None, "trace_ids": self.trace_ids(),
                    "note": "pass ?id=<trace_id> (32 hex) to stitch one "
                            "trace; ids listed newest-first from the "
                            "fleet timeline"}
        return assemble_trace(trace_id, self.events(),
                              _span_events_for(trace_id))

    # -- persistence / crash hook --------------------------------------------
    def dump(self, path: Optional[str] = None) -> str:
        """Write the timeline next to the flight ring's dumps (same
        naming funnel, ``timeline-`` prefix); returns the path."""
        if path is None:
            path = _flight.dump_path("timeline")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            f.write(json.dumps(self.snapshot_payload(),
                               default=repr).encode("utf-8"))
        return path

    def install_dump_hook(self) -> None:
        """Dump alongside the ring on SIGUSR2/excepthook (idempotent)."""
        _flight.add_dump_callback(self.dump)

    def uninstall_dump_hook(self) -> None:
        _flight.remove_dump_callback(self.dump)


# ---------------------------------------------------------------------------
# Distributed trace assembly
# ---------------------------------------------------------------------------

def _span_events_for(trace_id: str) -> List[Dict[str, Any]]:
    """This process's span-buffer events belonging to ``trace_id``
    (Chrome 'X' records, ``ts`` in Unix-epoch microseconds; they ride the
    payload as-is and stay out of the wall-clock export)."""
    out = []
    for e in _spans.get_trace_events():
        args = e.get("args") or {}
        if args.get("trace_id") == trace_id:
            out.append(dict(e))
    return out


def _chrome_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event doc from wall-clock timeline events: one fake
    pid per worker label (named via process_name metadata), ``span_end``
    events rendered as duration slices (start = ts - dur), everything
    else as instants. Loads in chrome://tracing / ui.perfetto.dev."""
    pids: Dict[str, int] = {}
    rows: List[Dict[str, Any]] = []
    for ev in events:
        worker = str(ev.get("worker") or f"pid:{ev.get('pid', '?')}")
        pid = pids.setdefault(worker, len(pids) + 1)
        ts_us = float(ev.get("ts") or 0.0) * 1e6
        base = {
            "cat": "mmlspark_fleet", "pid": pid,
            "tid": int(ev.get("tid") or 0) % 100000,
            "args": {k: v for k, v in ev.items() if k != "ts"},
        }
        dur_us = ev.get("dur_us")
        if ev.get("kind") == "span_end" and dur_us:
            rows.append({**base, "name": str(ev.get("name") or "span"),
                         "ph": "X", "ts": ts_us - float(dur_us),
                         "dur": float(dur_us)})
        else:
            rows.append({**base, "name": str(ev.get("kind") or "event"),
                         "ph": "i", "s": "p", "ts": ts_us})
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": worker}} for worker, pid in pids.items()]
    return {"traceEvents": meta + rows, "displayTimeUnit": "ms",
            "otherData": {"timebase": "wall_clock_us"}}


def assemble_trace(trace_id: str, events: List[Dict[str, Any]],
                   span_events: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    """Group ``events`` (timeline or flight records) by hop for one
    ``trace_id``: the stitched edge→gateway→worker tree. Hops appear in
    causal order — the gateway's edge-ingress ``gateway_request`` span
    lands first, the worker hop after it — each with its events and
    first/last timestamps; a Chrome trace export rides along."""
    evs = sorted((e for e in events if e.get("trace_id") == trace_id),
                 key=lambda e: (float(e.get("ts") or 0.0),
                                e.get("timeline_seq") or 0))
    order: List[str] = []
    hops: Dict[str, List[Dict[str, Any]]] = {}
    for ev in evs:
        w = str(ev.get("worker") or "local")
        if w not in hops:
            hops[w] = []
            order.append(w)
        hops[w].append(ev)
    tree = [{
        "hop": w,
        "role": "gateway" if w == "gateway" else "worker",
        "first_ts": hops[w][0].get("ts"),
        "last_ts": hops[w][-1].get("ts"),
        "events": hops[w],
    } for w in order]
    return {
        "trace_id": trace_id,
        "found": bool(evs),
        "hops": order,
        "tree": tree,
        "events": evs,
        "spans": span_events or [],
        "chrome_trace": _chrome_trace(evs),
    }


def local_trace_payload(trace_id: Optional[str]) -> Dict[str, Any]:
    """``/debug/trace`` on a non-gateway process: this process's own hop
    only, from its flight ring + span buffer (the gateway's view is the
    stitched one)."""
    label = f"local:{os.getpid()}"
    evs = [{**e, "worker": label} for e in _flight.events()]
    if not trace_id:
        seen: List[str] = []
        for ev in reversed(evs):
            tid = ev.get("trace_id")
            if tid and tid not in seen:
                seen.append(tid)
                if len(seen) >= 50:
                    break
        return {"trace_id": None, "trace_ids": seen, "federation": None,
                "note": "no federation in this process — local hop only; "
                        "the stitched fleet view lives on the "
                        "distributed-serving gateway. Pass ?id=<trace_id> "
                        "to view one local trace."}
    payload = assemble_trace(trace_id, evs, _span_events_for(trace_id))
    payload["federation"] = None
    payload["note"] = ("local hop only (no federation in this process); "
                       "the stitched edge→gateway→worker view lives on "
                       "the gateway")
    return payload
