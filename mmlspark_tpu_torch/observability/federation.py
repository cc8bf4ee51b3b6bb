"""Cluster metrics federation: one scrape surface for a worker fleet.

The port's copy of ``mmlspark_tpu/observability/federation.py``.

Each serving worker exposes its own in-band ``/metrics``; on a pod that
means operators scrape N addresses and mentally merge them. This module
gives the distributed-serving gateway the cluster view: a background
:class:`MetricsFederator` periodically scrapes every registered worker's
``/metrics``, parses the Prometheus text exposition, and merges families
under a ``worker`` label:

- **counters** — exported per worker (``worker="host:port"``) AND as a
  cluster sum (no ``worker`` label);
- **gauges** — per worker only (a summed queue depth hides the one
  wedged worker the gauge exists to show);
- **histograms** — bucket-merged across workers (bucket counts, sum and
  count are additive).

Merged families are renamed ``cluster_<name>`` so the gateway's own
process metrics and the fleet view coexist in one exposition without
family collisions. Scrape health itself is part of the product:
``cluster_scrape_ok{worker=...}`` / ``cluster_scrape_age_seconds`` ride
the same payload, and ``/debug/cluster`` reports per-worker scrape
status, staleness, consecutive failures, and the gateway's last
failover.

Kill-switch contract: the scrape loop checks ``metrics.enabled()`` every
tick and does nothing while disabled (and the gateway only routes debug
paths while enabled), so federation adds zero behavior to a disabled
deployment.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import blackbox as _blackbox
from . import device as _device
from . import flight as _flight
from . import metrics as _metrics

__all__ = [
    "parse_prometheus_text", "merge_worker_families", "render_families",
    "MetricsFederator", "DEFAULT_INTERVAL_SECONDS",
]

_INTERVAL_ENV = "MMLSPARK_TPU_FEDERATION_INTERVAL_SECONDS"
DEFAULT_INTERVAL_SECONDS = 5.0

#: family name -> (kind, [(labels, value)]) — histogram "values" are
#: dicts {"buckets": {le_str: count}, "sum": float, "count": float}
Families = Dict[str, Tuple[str, List[Tuple[Dict[str, str], Any]]]]


def _parse_labels(body: str) -> Dict[str, str]:
    """``a="x",b="y"`` -> dict. Handles escaped quotes/backslashes."""
    out: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            break
        key = body[i:eq].strip().strip(",")
        j = eq + 1
        if j >= n or body[j] != '"':
            break
        j += 1
        val: List[str] = []
        while j < n and body[j] != '"':
            if body[j] == "\\" and j + 1 < n:
                nxt = body[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                val.append(body[j])
                j += 1
        out[key] = "".join(val)
        i = j + 1
    return out


def _parse_sample(line: str) -> Optional[Tuple[str, Dict[str, str], float]]:
    brace = line.find("{")
    if brace >= 0:
        close = line.rfind("}")
        if close < brace:
            return None
        name = line[:brace].strip()
        labels = _parse_labels(line[brace + 1:close])
        rest = line[close + 1:].strip()
    else:
        parts = line.split(None, 1)
        if len(parts) != 2:
            return None
        name, rest = parts[0], parts[1]
        labels = {}
    try:
        value = float(rest.split()[0].replace("+Inf", "inf")
                      .replace("-Inf", "-inf"))
    except (ValueError, IndexError):
        return None
    return name, labels, value


def parse_prometheus_text(text: str) -> Families:
    """Total parse of a text exposition (format 0.0.4) into families.

    Histogram ``_bucket``/``_sum``/``_count`` samples are folded back
    into one histogram entry per label set. Unknown/malformed lines are
    skipped — a half-written scrape must never break the federator.
    """
    kinds: Dict[str, str] = {}
    flat: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        parsed = _parse_sample(line)
        if parsed is not None:
            flat.append(parsed)

    out: Families = {}
    hist: Dict[str, Dict[Tuple, Dict[str, Any]]] = {}
    for name, labels, value in flat:
        base = None
        part = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    kinds.get(name[: -len(suffix)]) == "histogram":
                base, part = name[: -len(suffix)], suffix
                break
        if base is not None:
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            slot = hist.setdefault(base, {}).setdefault(
                key, {"labels": dict(labels), "buckets": {},
                      "sum": 0.0, "count": 0.0})
            if part == "_bucket" and le is not None:
                slot["buckets"][le] = value
            elif part == "_sum":
                slot["sum"] = value
            elif part == "_count":
                slot["count"] = value
            continue
        kind = kinds.get(name, "gauge")
        if kind == "histogram":
            continue                      # bare histogram base name: skip
        fam = out.setdefault(name, (kind, []))
        fam[1].append((labels, value))
    for base, rows in hist.items():
        fam = out.setdefault(base, ("histogram", []))
        for slot in rows.values():
            fam[1].append((slot["labels"],
                           {"buckets": slot["buckets"], "sum": slot["sum"],
                            "count": slot["count"]}))
    return out


def _labels_key(labels: Dict[str, str]) -> Tuple:
    return tuple(sorted(labels.items()))


def merge_worker_families(
        per_worker: Dict[str, Families]) -> Families:
    """Merge scrapes from several workers into one ``cluster_``-prefixed
    family set, per the counter/gauge/histogram rules in the module doc."""
    merged: Families = {}

    def fam(name: str, kind: str):
        return merged.setdefault(f"cluster_{name}", (kind, []))

    # counters: per-worker series + cluster sum per original label set
    sums: Dict[str, Dict[Tuple, Tuple[Dict[str, str], float]]] = {}
    for worker, families in sorted(per_worker.items()):
        for name, (kind, rows) in sorted(families.items()):
            if kind == "counter":
                f = fam(name, "counter")
                acc = sums.setdefault(name, {})
                for labels, value in rows:
                    f[1].append(({**labels, "worker": worker}, value))
                    key = _labels_key(labels)
                    prev = acc.get(key, (labels, 0.0))
                    acc[key] = (prev[0], prev[1] + float(value))
            elif kind == "histogram":
                f = fam(name, "histogram")
                for labels, h in rows:
                    # fold into the existing aggregate row for this label set
                    row = next((r for r in f[1]
                                if _labels_key(r[0]) == _labels_key(labels)),
                               None)
                    if row is None:
                        f[1].append((dict(labels),
                                     {"buckets": dict(h["buckets"]),
                                      "sum": float(h["sum"]),
                                      "count": float(h["count"])}))
                    else:
                        agg = row[1]
                        for le, c in h["buckets"].items():
                            agg["buckets"][le] = \
                                agg["buckets"].get(le, 0.0) + float(c)
                        agg["sum"] += float(h["sum"])
                        agg["count"] += float(h["count"])
            else:                                     # gauges: per-worker
                f = fam(name, "gauge")
                for labels, value in rows:
                    f[1].append(({**labels, "worker": worker}, value))
    for name, acc in sums.items():
        f = merged[f"cluster_{name}"]
        for labels, total in acc.values():
            f[1].append((dict(labels), total))
    return merged


def _le_sort_key(le: str) -> float:
    try:
        return float(le.replace("+Inf", "inf"))
    except ValueError:
        return float("inf")


def render_families(families: Families) -> str:
    """Families back to text exposition (the federated half of the
    gateway's ``/metrics`` body)."""
    lines: List[str] = []
    for name, (kind, rows) in sorted(families.items()):
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in sorted(
                rows, key=lambda r: _labels_key(r[0])):
            if kind == "histogram":
                for le in sorted(value["buckets"], key=_le_sort_key):
                    lines.append(_metrics._sample(
                        f"{name}_bucket", {**labels, "le": le},
                        value["buckets"][le]))
                lines.append(_metrics._sample(f"{name}_sum", labels,
                                              value["sum"]))
                lines.append(_metrics._sample(f"{name}_count", labels,
                                              value["count"]))
            else:
                lines.append(_metrics._sample(name, labels, value))
    return "\n".join(lines) + ("\n" if lines else "")


class _WorkerState:
    __slots__ = ("label", "families", "last_attempt", "last_success",
                 "consecutive_failures", "error")

    def __init__(self, label: str):
        self.label = label
        self.families: Families = {}
        self.last_attempt = 0.0
        self.last_success = 0.0
        self.consecutive_failures = 0
        self.error: Optional[str] = None


class MetricsFederator:
    """Background scraper + merger over a dynamic worker set.

    ``targets`` returns the current ``[(label, host, port), ...]`` —
    the gateway passes a closure over its :class:`ServiceRegistry`, so
    worker churn is picked up on the next sweep without coordination.
    """

    def __init__(self, targets: Callable[[], List[Tuple[str, str, int]]],
                 interval: Optional[float] = None, timeout: float = 2.0):
        import os
        self.targets = targets
        if interval is None:
            try:
                interval = float(os.environ.get(_INTERVAL_ENV, "")
                                 or DEFAULT_INTERVAL_SECONDS)
            except ValueError:
                interval = DEFAULT_INTERVAL_SECONDS
        self.interval = max(0.05, float(interval))
        self.timeout = timeout
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: set by the gateway on failover (surfaced in /debug/cluster)
        self.last_failover: Optional[Dict[str, Any]] = None
        #: optional callable -> {worker: breaker_state}; the gateway
        #: installs its BreakerBoard view so /debug/cluster shows which
        #: workers the routing plane is currently refusing
        self.breaker_states: Optional[Callable[[], Dict[str, str]]] = None
        #: fleet black-box: worker flight deltas + lifecycle transitions
        #: merged in causal order (/debug/timeline, /debug/trace); fed by
        #: the sweep below when MMLSPARK_TPU_FLIGHT_SCRAPE allows
        self.timeline = _blackbox.FleetTimeline()
        # previous autoscale hint, for crossing-1.0 lifecycle events
        self._prev_hint = 0.0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MetricsFederator":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                # fresh event per sweeper generation: a start() racing a
                # concurrent stop() must not clear the event the old
                # (not-yet-joined) sweeper is watching — reusing one
                # event could un-stop it and leave two sweepers running
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._run, args=(self._stop,),
                    name="mmlspark-federation", daemon=True)
                self._thread.start()
        # a crash/SIGUSR2 dump of THIS process also leaves the fleet
        # timeline on disk, next to its own ring (same naming funnel)
        self.timeline.install_dump_hook()
        return self

    def stop(self) -> None:
        self.timeline.uninstall_dump_hook()
        # swap the handles under the lock, signal + join outside it: the
        # sweep thread takes _lock in scrape_once, so joining under it
        # could stall stop() for a full scrape timeout
        with self._lock:
            stop, t = self._stop, self._thread
            self._thread = None
        stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            if not _metrics.enabled():
                continue
            # piggyback the periodic device-memory sample on the sweep
            # (throttled inside; a process that never started CUDA skips)
            _device.maybe_sample_device_memory()
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the sweep must never die
                pass

    # -- scraping ------------------------------------------------------------
    #: consecutive scrape failures before a worker is declared
    #: scrape-dead on the timeline (the freshness rule's 3-sweep horizon)
    SCRAPE_DEAD_AFTER = 3

    def scrape_once(self) -> None:
        """One synchronous sweep over the current target set (tests call
        this directly for determinism). Besides ``/metrics``, the sweep
        pulls each worker's flight delta (``/debug/flight?since=``) into
        the fleet timeline and records lifecycle transitions — both
        gated so the disabled deployment's sweep is byte-identical to
        the pre-timeline one."""
        pull = _metrics.enabled() and _blackbox.flight_scrape_enabled()
        targets = list(self.targets())
        seen = set()
        for label, host, port in targets:
            seen.add(label)
            with self._lock:
                known = label in self._workers
            st = self._worker(label)
            if pull and not known:
                self.timeline.lifecycle("worker_registered", worker=label,
                                        addr=f"{host}:{port}")
            was_failing = st.consecutive_failures
            st.last_attempt = time.time()
            try:
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=self.timeout)
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                body = resp.read()
                conn.close()
                if resp.status != 200:
                    raise OSError(f"HTTP {resp.status}")
                st.families = parse_prometheus_text(
                    body.decode("utf-8", "replace"))
                st.last_success = time.time()
                st.consecutive_failures = 0
                st.error = None
                _metrics.safe_counter("federation_scrapes_total",
                                      worker=label, outcome="ok").inc()
                if pull and was_failing:
                    self.timeline.lifecycle("worker_scrape_recovered",
                                            worker=label,
                                            after_failures=was_failing)
                if pull:
                    self._pull_flight(label, host, int(port))
            except Exception as e:  # noqa: BLE001 — a sick worker is data
                st.consecutive_failures += 1
                st.error = f"{type(e).__name__}: {e}"
                _metrics.safe_counter("federation_scrapes_total",
                                      worker=label, outcome="error").inc()
                if pull and was_failing == 0:
                    self.timeline.lifecycle("worker_scrape_failed",
                                            worker=label, error=st.error)
                if pull and st.consecutive_failures == self.SCRAPE_DEAD_AFTER:
                    # the same horizon _fresh_states ages the worker out
                    # of every derived signal at — a SIGKILLed worker's
                    # death certificate on the timeline
                    self.timeline.lifecycle("worker_scrape_dead",
                                            worker=label, error=st.error,
                                            consecutive_failures=st
                                            .consecutive_failures)
        with self._lock:
            # deregistered workers leave the cluster view at the sweep
            # AFTER they leave the registry — no ghost series
            gone = [label for label in self._workers if label not in seen]
            for label in gone:
                del self._workers[label]
        if pull:
            for label in gone:
                self.timeline.lifecycle("worker_deregistered", worker=label)
            # the gateway's own ring joins the fleet timeline the same
            # incremental way (no HTTP, same (worker, seq) dedup key) —
            # breaker flips, failovers and deadline drops recorded by the
            # routing plane become timeline events automatically
            self.timeline.extend(
                "gateway",
                _flight.snapshot(since=self.timeline.cursor("gateway")))
        try:
            hint_payload = self.autoscale_hint()  # refresh every sweep
            if pull:
                hint = float(hint_payload.get("hint") or 0.0)
                if self._prev_hint < 1.0 <= hint:
                    self.timeline.lifecycle("autoscale_pressure_high",
                                            hint=hint)
                elif hint < 1.0 <= self._prev_hint:
                    self.timeline.lifecycle("autoscale_pressure_cleared",
                                            hint=hint)
                self._prev_hint = hint
        except Exception:  # noqa: BLE001 — advisory signal only
            pass

    def _pull_flight(self, label: str, host: str, port: int) -> None:
        """Incremental flight scrape of one worker into the timeline.
        Failures are counted but never fail the sweep — the /metrics
        scrape already succeeded, and flight data is forensics, not
        health."""
        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout)
            conn.request(
                "GET",
                f"/debug/flight?since={self.timeline.cursor(label)}")
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            if resp.status != 200:
                raise OSError(f"HTTP {resp.status}")
            snap = json.loads(body.decode("utf-8", "replace"))
            added = self.timeline.extend(label, snap)
            _metrics.safe_counter("timeline_events_total",
                                  worker=label).inc(added)
            _metrics.safe_counter("timeline_scrapes_total",
                                  worker=label, outcome="ok").inc()
        except Exception:  # noqa: BLE001 — forensics must not fail health
            _metrics.safe_counter("timeline_scrapes_total",
                                  worker=label, outcome="error").inc()

    # -- timeline / trace views (the /debug/timeline and /debug/trace
    # bodies; thin delegates so debug_body only ever holds the federator)
    def timeline_payload(self) -> Dict[str, Any]:
        payload = self.timeline.snapshot_payload()
        payload["interval_seconds"] = self.interval
        return payload

    def trace_payload(self, trace_id: Optional[str]) -> Dict[str, Any]:
        return self.timeline.trace_payload(trace_id)

    def _worker(self, label: str) -> _WorkerState:
        with self._lock:
            st = self._workers.get(label)
            if st is None:
                st = self._workers[label] = _WorkerState(label)
            return st

    def _fresh_states(self, max_age: Optional[float] = None
                      ) -> List[Tuple[str, "_WorkerState"]]:
        """THE freshness rule for every federated read: workers whose
        last scrape failed, never happened, or is older than ``max_age``
        (default 3 sweep intervals) are omitted. One filter — the
        routing feed, the SLO burn fold, and the autoscale hint's
        queue-wait read all pass through here, so a ghost worker ages
        out of every derived signal at the same instant instead of
        lingering in whichever reader had the laxest rule (the staleness
        contract is pinned in tests/test_federation.py)."""
        if max_age is None:
            max_age = 3.0 * self.interval
        now = time.time()
        with self._lock:
            states = list(self._workers.items())
        return [(label, st) for label, st in states
                if st.error is None and st.last_success
                and now - st.last_success <= max_age]

    def gauge_values(self, family: str,
                     max_age: Optional[float] = None) -> Dict[str, float]:
        """Per-worker value of one gauge family from each worker's last
        successful scrape — the feed for load-aware gateway routing
        (``cluster_serving_queue_depth`` is ``serving_queue_depth`` seen
        from here). Stale/failed workers are omitted (see
        :meth:`_fresh_states`), so the caller can tell "depth 0" apart
        from "no fresh data" and fall back. Series within a family
        (label sets, e.g. one per api) sum per worker."""
        out: Dict[str, float] = {}
        for label, st in self._fresh_states(max_age):
            fam = st.families.get(family)
            if fam is None:
                continue
            kind, rows = fam
            if kind == "histogram":
                continue
            out[label] = sum(float(v) for _labels, v in rows)
        return out

    def gauge_max_values(self, family: str,
                         max_age: Optional[float] = None
                         ) -> Dict[str, float]:
        """Per-worker MAX across one gauge family's series from each
        fresh scrape (same freshness rule: :meth:`_fresh_states`). The
        burn-rate fold reads ``slo_burn_rate`` this way: a worker
        exports one series per (api, window) and summing them
        (``gauge_values``' queue-depth semantics) would double a breach
        just for having two windows."""
        out: Dict[str, float] = {}
        for label, st in self._fresh_states(max_age):
            fam = st.families.get(family)
            if fam is None:
                continue
            kind, rows = fam
            if kind == "histogram" or not rows:
                continue
            out[label] = max(float(v) for _labels, v in rows)
        return out

    def slo_overview(self) -> Dict[str, Any]:
        """Federated SLO view for the gateway's ``/debug/slo``: each
        worker's worst burn rate from its last scrape (any api, either
        window) and the fleet maximum."""
        burns = self.gauge_max_values("slo_burn_rate")
        return {
            "workers": {label: {"burn_rate_max": burns[label]}
                        for label in sorted(burns)},
            "max_burn_rate": max(burns.values()) if burns else None,
            "note": "per-worker max slo_burn_rate from the federation "
                    "sweep; absent workers export no SLO gauges (no "
                    "objective configured or no scrape yet)",
        }

    def autoscale_hint(self) -> Dict[str, Any]:
        """Scale-pressure signal from the fleet's own backpressure
        telemetry (ROADMAP item 1's observability half — the signal
        only, no supervisor acts on it here).

        Two feeds fold into one hint: the mean queue depth per live
        worker (``0`` = arrivals absorbed as they come, sustained
        ``>= 1`` = standing backlog on every worker) and the fleet's
        worst SLO burn rate when it exceeds ``1.0`` — a fleet spending
        error budget faster than it accrues is failing users even with
        shallow queues, so user-visible pain raises the hint too. The
        hint is the max of the two. Per-worker mean queue wait
        (histogram ``sum / count`` from the same scrape) rides along so
        an operator can tell deep-but-fast queues from genuinely slow
        ones. Also sets the ``cluster_autoscale_hint`` gauge."""
        depths = self.gauge_values("serving_queue_depth")
        waits: Dict[str, Optional[float]] = {}
        # the queue-wait read rides the SAME freshness filter as the
        # depth and burn feeds (one _fresh_states rule, not a raw
        # st.families walk): a ghost worker's last samples age out of
        # every component of the hint together
        for label, st in self._fresh_states():
            if label not in depths:
                continue
            mean = None
            fam = st.families.get("serving_queue_wait_seconds")
            if fam is not None and fam[0] == "histogram":
                total = sum(float(h["sum"]) for _l, h in fam[1])
                count = sum(float(h["count"]) for _l, h in fam[1])
                if count > 0:
                    mean = total / count
            waits[label] = mean
        live = len(depths)
        total_depth = sum(depths.values())
        queue_hint = (total_depth / live) if live else 0.0
        burns = self.gauge_max_values("slo_burn_rate")
        burn_max = max(burns.values()) if burns else None
        # burn <= 1.0 is inside budget — only user-visible pain adds
        # pressure beyond what the backlog already shows
        slo_pressure = burn_max if (burn_max or 0.0) > 1.0 else 0.0
        hint = max(queue_hint, slo_pressure)
        _metrics.safe_gauge("cluster_autoscale_hint").set(hint)
        observed = [w for w in waits.values() if w is not None]
        workers = {label: {"queue_depth": depths[label],
                           "queue_wait_mean_seconds": waits.get(label)}
                   for label in sorted(depths)}
        for label, burn in burns.items():
            workers.setdefault(label, {})["slo_burn_rate_max"] = burn
        return {
            "hint": hint,
            "queue_hint": queue_hint,
            "slo_burn_rate_max": burn_max,
            "live_workers": live,
            "total_queue_depth": total_depth,
            "mean_queue_wait_seconds":
                (sum(observed) / len(observed)) if observed else None,
            "workers": workers,
            "note": "max(mean queue depth per live worker, fleet-worst "
                    "slo_burn_rate when > 1); sustained >= 1 suggests "
                    "adding capacity, 0 means arrivals are absorbed "
                    "within objectives (advisory only)",
        }

    # -- export --------------------------------------------------------------
    def _scrape_health_families(self) -> Families:
        now = time.time()
        ok_rows: List[Tuple[Dict[str, str], Any]] = []
        age_rows: List[Tuple[Dict[str, str], Any]] = []
        with self._lock:
            states = list(self._workers.values())
        for st in states:
            ok_rows.append(({"worker": st.label},
                            1.0 if st.error is None and st.last_success
                            else 0.0))
            age_rows.append(({"worker": st.label},
                             round(now - st.last_success, 3)
                             if st.last_success else -1.0))
        return {"cluster_scrape_ok": ("gauge", ok_rows),
                "cluster_scrape_age_seconds": ("gauge", age_rows)}

    def render_metrics(self) -> bytes:
        """The federated suffix of the gateway's ``/metrics`` body:
        merged worker families + scrape-health gauges."""
        with self._lock:
            per_worker = {label: st.families
                          for label, st in self._workers.items()
                          if st.families}
        merged = merge_worker_families(per_worker)
        merged.update(self._scrape_health_families())
        return render_families(merged).encode("utf-8")

    def cluster_payload(self) -> Dict[str, Any]:
        """``/debug/cluster`` body: per-worker scrape health + staleness
        + the gateway's last failover."""
        now = time.time()
        workers: Dict[str, Any] = {}
        with self._lock:
            states = list(self._workers.items())
        for label, st in states:
            workers[label] = {
                "ok": st.error is None and st.last_success > 0,
                "last_attempt": st.last_attempt or None,
                "last_success": st.last_success or None,
                "staleness_seconds": (round(now - st.last_success, 3)
                                      if st.last_success else None),
                "consecutive_failures": st.consecutive_failures,
                "error": st.error,
                "families": len(st.families),
            }
        payload = {"time": now, "interval_seconds": self.interval,
                   "workers": workers, "last_failover": self.last_failover}
        if self.breaker_states is not None:
            try:
                payload["breakers"] = dict(self.breaker_states())
            except Exception:  # noqa: BLE001 — diagnostics must not 500
                pass
        return payload
