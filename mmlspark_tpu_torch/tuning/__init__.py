"""Measurement-driven auto-tuning: close the roofline's measure→decide
loop.

The measurement plane — the roofline ledger's
``bound: compute|memory`` verdicts, per-stage serving histograms, SLO
burn rates — but every performance-relevant knob still resolved by
static heuristics without it. This package is the decision layer: it turns those
ledgers into resolved knob values at four sites, all sharing one
pattern — *observe* (EWMAs / histograms recorded here), *decide
deterministically* (:mod:`.decisions`: pure functions of the evidence,
no wall-clock or device reads), *resolve BEFORE any compiled-program
cache key is assembled*, *emit* a
``tuning`` flight event + ``tuning_decisions_total{site, choice}``
counter, and *degrade to today's static rule* whenever evidence is
missing or the store's fingerprint skews.

The four sites:

1. **hist_engine** — ``ops/histogram.resolve_engine``'s ``auto``
   consults the per-(engine, shape-bucket) winner measured by a short
   calibration on the first tuned fit (one real histogram round per
   candidate engine, on the fit's own binned data); the
   ``hist_subtraction``/``compact_selector`` tri-states take the same
   measured hint (:func:`growth_tristate_hint`).
2. **bucket_ladder** — the predict bucket ladder derives from the
   observed serving batch-size histogram instead of the fixed pow2
   grid; ``Booster.predict_plan`` and ``serving.bucket_size`` both
   resolve it, so the hot path, the bundle builder and the key manifest
   can never disagree.
3. **hold_window** — when the score stage is memory-bound and
   under-occupied, the async dispatcher holds the forming buffer up to
   this window to dispatch fuller batches; a breaching endpoint (SLO
   fast-window burn > 1) is never held — that check is runtime state,
   applied at dispatch in ``io/aserve``.
4. **slots** — ``MMLSPARK_TPU_ASERVE_SLOTS=auto`` sizes the slot table
   from the p99.9 of admitted-batch rows, reconciled against the
   ``aserve_slots`` HBM claim headroom.

Decisions persist to a fingerprinted JSON store (:mod:`.store`) so the
second process starts tuned: its resolvers answer from the store
(flight events say ``source=store``) with zero calibration rounds.
``/debug/tuning`` (both serving engines) renders
:func:`snapshot_payload`.

Stdlib + observability only — no jax: a pure gateway process renders
``/debug/tuning`` without dragging an accelerator runtime in.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..observability import flight as _flight
from ..observability import hbm as _hbm
from ..observability import metrics as _metrics
from ..observability import roofline as _roofline
from ..observability.env_registry import env_float, env_int
from ..observability.logging import get_logger
from . import decisions as _decisions
from . import store as _store
from .decisions import ladder_pad, shape_bucket
from .store import TUNING_DIR_ENV

logger = get_logger("mmlspark_tpu_torch.tuning")

#: evidence bar for the serving-side decisions (ladder / slots / hold)
MIN_SAMPLES_ENV = "MMLSPARK_TPU_TUNE_MIN_SAMPLES"
#: pin the dispatch hold window (ms; empty = tuner decides, 0 = off)
HOLD_MS_ENV = "MMLSPARK_TPU_TUNE_HOLD_MS"
#: cap on the tuner-computed hold window (ms)
HOLD_CAP_MS_ENV = "MMLSPARK_TPU_TUNE_HOLD_CAP_MS"

_SITES = ("hist_engine", "bucket_ladder", "hold_window", "slots")

__all__ = ["TUNING_DIR_ENV", "enabled", "reset", "configure",
           "observe_batch_size", "observe_score", "observe_forming_wait",
           "note_slot_geometry", "resolve_hist_engine",
           "resolve_bucket_ladder", "resolve_hold_window",
           "resolve_slots_auto", "growth_tristate_hint", "ladder_pad",
           "shape_bucket", "snapshot_payload", "provenance", "flush"]


def _device_memory_limit() -> Optional[float]:
    """Sum of the last-sampled ``device_memory_bytes{stat="bytes_limit"}``
    rows (the HBM ledger's PJRT feed) — None when never sampled (CPU)."""
    try:
        fam = _metrics.get_registry().snapshot().get("device_memory_bytes")
    except Exception:  # noqa: BLE001 — evidence, not a hot path
        return None
    if not fam:
        return None
    vals = [row.get("value") for row in fam.get("series", ())
            if row.get("labels", {}).get("stat") == "bytes_limit"]
    vals = [v for v in vals if v is not None]
    return float(sum(vals)) if vals else None


def _predict_bound() -> Optional[str]:
    """Majority ``bound`` verdict across the roofline ledger's predict
    executables — the hold-window decision's memory-vs-compute evidence.
    Pure function of the ledger snapshot (deterministic on replay)."""
    votes = {"memory": 0, "compute": 0}
    for e in _roofline.snapshot_payload().get("executables", []):
        if e.get("kind") == "predict" and e.get("bound") in votes:
            votes[e["bound"]] += 1
    if votes["memory"] + votes["compute"] == 0:
        return None
    return "memory" if votes["memory"] > votes["compute"] else "compute"


class _Tuner:
    """Per-store-directory tuner state. One instance per process per
    store dir; all mutation under one re-entrant lock (decisions are
    triggered from observe paths)."""

    def __init__(self, directory: str):
        self.dir = directory
        self._lock = threading.RLock()
        self._loaded = False
        self._degraded = False
        self._mismatches: List[str] = []
        self._model_sha256: Optional[str] = None
        self._evidence: Dict[str, Any] = {}
        self._decisions: Dict[str, Any] = {}
        self._emitted: Dict[str, Tuple[Any, str]] = {}
        self._serving_decided = False
        self._batch_total = 0.0

    # -- store lifecycle ---------------------------------------------------

    def _ensure_loaded(self) -> None:
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            try:
                payload = _store.load_store(self.dir)
            except _store.StoreError as e:
                self._degrade("unreadable", error=str(e))
                return
            self._evidence = payload.get("evidence", {}) or {}
            self._decisions = payload.get("decisions", {}) or {}
            # a decision read back from disk resolves with source=store —
            # the warm-start proof keys off this relabeling
            for d in self._decisions.values():
                if isinstance(d, dict):
                    d["source"] = "store"
            self._check_fingerprint(payload.get("fingerprint", {}) or {})
            # a loaded serving decision set is pinned: evidence keeps
            # accumulating but this process will not re-decide
            if any(k in self._decisions
                   for k in ("bucket_ladder", "hold_window", "slots")):
                self._serving_decided = True
            self._batch_total = sum(
                (self._evidence.get("batch_sizes") or {}).values())

    def _check_fingerprint(self, built: Dict[str, Any]) -> None:
        if not built or not self._decisions:
            return
        now = self._fingerprint()
        mismatches = _store.fingerprint_mismatches(built, now)
        if mismatches:
            self._degrade("fingerprint_mismatch", mismatches=mismatches)

    def _degrade(self, status: str, **fields: Any) -> None:
        """THE loud degradation to static rules: one structured warning +
        one flight event + the status-labeled counter. Stored decisions
        are dropped (not deleted on disk — an operator can still inspect
        the skewed store), so every resolver answers static."""
        with self._lock:  # re-entrant: callers already hold it
            self._degraded = True
            self._mismatches = list(fields.get("mismatches", ()))
            self._decisions = {}
            # never persist over a skewed store
            self._serving_decided = True
        logger.warning("tuning store unusable, using static rules: %s",
                       status, store=self.dir, status=status, **fields)
        _flight.record("tuning", event="store_degraded", status=status,
                       store=self.dir, **fields)
        _metrics.safe_counter("tuning_store_degraded_total",
                              status=status).inc()

    def _fingerprint(self) -> Dict[str, Any]:
        kind = _roofline.snapshot_payload().get("device_kind")
        return _store.store_fingerprint(device_kind=kind,
                                        model_sha256=self._model_sha256)

    def configure(self, model_sha256: Optional[str] = None) -> None:
        with self._lock:
            if model_sha256 is not None:
                self._model_sha256 = model_sha256
                if self._loaded and not self._degraded:
                    try:
                        payload = _store.load_store(self.dir)
                    except _store.StoreError:
                        return
                    self._check_fingerprint(
                        payload.get("fingerprint", {}) or {})

    def save(self) -> None:
        with self._lock:
            if self._degraded:
                return
            payload = {"format_version": _store.FORMAT_VERSION,
                       "fingerprint": self._fingerprint(),
                       "evidence": self._evidence,
                       "decisions": self._decisions}
            try:
                _store.save_store(self.dir, payload)
            except OSError as e:
                logger.warning("tuning store write failed: %s", e,
                               store=self.dir)

    # -- emit --------------------------------------------------------------

    def _emit(self, site: str, choice: Any, source: str,
              **fields: Any) -> None:
        """One flight event + counter per (site, choice, source) change —
        resolvers run per request/fit, the telemetry records decisions."""
        label = "static" if choice is None else str(choice)
        with self._lock:
            if self._emitted.get(site) == (label, source):
                return
            self._emitted[site] = (label, source)
        _flight.record("tuning", site=site, choice=label, source=source,
                       **fields)
        _metrics.safe_counter("tuning_decisions_total", site=site,
                              choice=label).inc()

    # -- observation (hot paths: keep tiny) --------------------------------

    def observe_batch_size(self, n: int) -> None:
        if n <= 0:
            return
        decide = False
        with self._lock:
            self._ensure_loaded()
            counts = self._evidence.setdefault("batch_sizes", {})
            key = str(int(n))
            counts[key] = counts.get(key, 0) + 1
            self._batch_total += 1
            if not self._serving_decided and \
                    self._batch_total >= self._min_samples():
                self._serving_decided = True
                decide = True
        if decide:
            self._decide_serving()

    def observe_score(self, seconds: float) -> None:
        with self._lock:
            self._ensure_loaded()
            st = self._evidence.setdefault("stage", {})
            st["score_ewma"] = _decisions.ewma_update(
                st.get("score_ewma"), seconds)
            st["score_samples"] = st.get("score_samples", 0) + 1

    def observe_forming_wait(self, seconds: float) -> None:
        with self._lock:
            self._ensure_loaded()
            st = self._evidence.setdefault("stage", {})
            st["forming_wait_ewma"] = _decisions.ewma_update(
                st.get("forming_wait_ewma"), seconds)

    def note_slot_geometry(self, row_bytes: int, max_batch: int) -> None:
        with self._lock:
            self._ensure_loaded()
            self._evidence["slot_geometry"] = {
                "row_bytes": int(row_bytes), "max_batch": int(max_batch)}

    def observe_hist_engine(self, bucket: str, engine: str,
                            seconds: float) -> None:
        with self._lock:
            self._ensure_loaded()
            buckets = self._evidence.setdefault("hist_engine", {})
            ev = buckets.setdefault(bucket, {}).setdefault(
                engine, {"ewma_seconds": None, "samples": 0})
            ev["ewma_seconds"] = _decisions.ewma_update(
                ev["ewma_seconds"], seconds)
            ev["samples"] += 1

    def _min_samples(self) -> int:
        return max(1, env_int(MIN_SAMPLES_ENV, 64))

    # -- decisions ---------------------------------------------------------

    def _decide_serving(self) -> None:
        """Decide the three serving sites once, at the evidence bar —
        each a pure function of the recorded ledgers — then persist."""
        with self._lock:
            if self._degraded:
                return
            counts = self._evidence.get("batch_sizes") or {}
            min_samples = self._min_samples()
            geometry = self._evidence.get("slot_geometry") or {}
            stage = self._evidence.get("stage") or {}
            total = sum(counts.values())

            if "bucket_ladder" not in self._decisions:
                ladder = _decisions.decide_bucket_ladder(counts, min_samples)
                self._decisions["bucket_ladder"] = {
                    "choice": list(ladder) if ladder else None,
                    "source": "measured",
                    "evidence": {"batch_samples": total,
                                 "p50": _decisions.percentile_from_counts(
                                     counts, 0.50),
                                 "p99": _decisions.percentile_from_counts(
                                     counts, 0.99)}}

            if "slots" not in self._decisions and geometry:
                limit = _device_memory_limit()
                headroom = None
                if limit is not None:
                    claims = _hbm.claims()
                    headroom = limit - (sum(claims.values())
                                        - claims.get("aserve_slots", 0.0))
                slots = _decisions.decide_slots(
                    counts, geometry.get("max_batch", 0), min_samples,
                    row_bytes=geometry.get("row_bytes"),
                    headroom_bytes=headroom)
                self._decisions["slots"] = {
                    "choice": slots, "source": "measured",
                    "evidence": {"batch_samples": total,
                                 "p999": _decisions.percentile_from_counts(
                                     counts, 0.999),
                                 "headroom_bytes": headroom,
                                 **geometry}}

            if "hold_window" not in self._decisions:
                bound = _predict_bound()
                mean_batch = (total and sum(
                    int(k) * v for k, v in counts.items()) / total) or 0.0
                hold = _decisions.decide_hold_window(
                    bound, stage.get("forming_wait_ewma") or 0.0,
                    stage.get("score_ewma") or 0.0, mean_batch,
                    geometry.get("max_batch", 0),
                    env_float(HOLD_CAP_MS_ENV, 2.0) / 1000.0)
                self._decisions["hold_window"] = {
                    "choice": round(hold, 6), "source": "measured",
                    "evidence": {"bound": bound,
                                 "score_ewma": stage.get("score_ewma"),
                                 "forming_wait_ewma":
                                     stage.get("forming_wait_ewma"),
                                 "mean_batch": round(mean_batch, 2)}}
        self.save()

    # -- resolvers (the four sites) ----------------------------------------

    def resolve_hist_engine(self, n_rows: int, num_features: int,
                            num_bins: int, candidates: Sequence[str],
                            measure: Optional[Callable[[str], float]] = None,
                            ) -> Optional[str]:
        bucket = shape_bucket(n_rows, num_features, num_bins)
        site_key = f"hist_engine/{bucket}"
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                self._emit("hist_engine", None, "static", bucket=bucket)
                return None
            decision = self._decisions.get(site_key)
        if decision is not None:
            choice = decision.get("choice")
            if choice is not None and choice not in candidates:
                choice = None     # measured on hardware this host lacks
            self._emit("hist_engine", choice,
                       decision.get("source", "store") if choice is not None
                       else "static", bucket=bucket)
            return choice
        if measure is None or len(candidates) < 2:
            self._emit("hist_engine", None, "static", bucket=bucket)
            return None
        # calibration: one real measured round per candidate engine, on
        # the caller's own data (the caller owns device + timing; the
        # DECISION below is a pure function of the recorded EWMAs)
        for engine in candidates:
            try:
                seconds = float(measure(engine))
            except Exception as e:  # noqa: BLE001 — a candidate that
                # cannot lower here simply drops out of the evidence
                _flight.record("tuning", event="calibrate_failed",
                               site="hist_engine", bucket=bucket,
                               engine=engine,
                               error=f"{type(e).__name__}: {e}")
                continue
            self.observe_hist_engine(bucket, engine, seconds)
            _flight.record("tuning", event="calibrate", site="hist_engine",
                           bucket=bucket, engine=engine,
                           seconds=round(seconds, 6))
        with self._lock:
            bucket_ev = (self._evidence.get("hist_engine") or {}).get(
                bucket, {})
            choice = _decisions.decide_hist_engine(bucket_ev)
            self._decisions[site_key] = {
                "choice": choice, "source": "calibration",
                "evidence": {eng: {"ewma_seconds":
                                   round(ev["ewma_seconds"], 6),
                                   "samples": ev["samples"]}
                             for eng, ev in sorted(bucket_ev.items())}}
        self.save()
        self._emit("hist_engine", choice, "calibration", bucket=bucket)
        return choice

    def bucket_ladder(self) -> Optional[Tuple[int, ...]]:
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                return None
            decision = self._decisions.get("bucket_ladder")
        if decision is None:
            return None
        choice = decision.get("choice")
        if not choice:
            self._emit("bucket_ladder", None, "static")
            return None
        ladder = tuple(int(r) for r in choice)
        self._emit("bucket_ladder", ladder,
                   decision.get("source", "measured"))
        return ladder

    def hold_window(self) -> float:
        pinned = os.environ.get(HOLD_MS_ENV)
        if pinned:
            try:
                value = max(0.0, float(pinned) / 1000.0)
            except ValueError:
                value = 0.0
            self._emit("hold_window", round(value, 6), "pinned")
            return value
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                return 0.0
            decision = self._decisions.get("hold_window")
        if decision is None:
            return 0.0
        choice = float(decision.get("choice") or 0.0)
        self._emit("hold_window", round(choice, 6),
                   decision.get("source", "measured"))
        return choice

    def slots_auto(self, max_batch: int,
                   row_bytes: Optional[int] = None) -> Optional[int]:
        if row_bytes:
            self.note_slot_geometry(row_bytes, max_batch)
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                self._emit("slots", None, "static")
                return None
            decision = self._decisions.get("slots")
        if decision is None or not decision.get("choice"):
            self._emit("slots", None, "static")
            return None
        choice = int(decision["choice"])
        self._emit("slots", choice, decision.get("source", "measured"))
        return min(choice, _decisions.pow2_ceil(max_batch))

    def growth_hint(self) -> Optional[str]:
        """The measured engine winner the growth tri-states key off:
        the majority winner across decided shape buckets (lexicographic
        tie-break — deterministic), None when nothing is decided."""
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                return None
            winners = [d.get("choice") for k, d in self._decisions.items()
                       if k.startswith("hist_engine/") and d.get("choice")]
        if not winners:
            return None
        tally: Dict[str, int] = {}
        for w in winners:
            tally[w] = tally.get(w, 0) + 1
        return sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))[0][0]

    # -- introspection -----------------------------------------------------

    def snapshot_payload(self) -> Dict[str, Any]:
        with self._lock:
            self._ensure_loaded()
            counts = self._evidence.get("batch_sizes") or {}
            return {
                "enabled": True,
                "store": _store.store_path(self.dir),
                "status": "degraded" if self._degraded else "ok",
                "fingerprint": self._fingerprint(),
                "mismatches": list(self._mismatches),
                "decisions": {k: dict(v)
                              for k, v in sorted(self._decisions.items())},
                "applied": {site: {"choice": c, "source": s}
                            for site, (c, s)
                            in sorted(self._emitted.items())},
                "evidence": {
                    "batch_size_samples": sum(counts.values()),
                    "hist_engine_buckets": sorted(
                        self._evidence.get("hist_engine") or {}),
                    "stage": dict(self._evidence.get("stage") or {}),
                },
            }

    def provenance(self) -> Dict[str, Any]:
        """Compact {site: choice} view for bench-round stamping and the
        bundle manifest — what a regression harness diffs to tell "the
        tuner flipped" from "the code got slower"."""
        with self._lock:
            self._ensure_loaded()
            out: Dict[str, Any] = {"status": "degraded" if self._degraded
                                   else "ok"}
            for key, d in sorted(self._decisions.items()):
                out[key] = d.get("choice")
            return out

    def flush(self) -> None:
        """Persist accumulated evidence (engine drain/stop, bench
        epilogue) and take any serving decisions the evidence now
        supports."""
        with self._lock:
            self._ensure_loaded()
            if self._degraded:
                return
            should_decide = self._batch_total >= 1
            if should_decide:
                self._serving_decided = True
        if should_decide:
            # idempotent: already-decided sites are pinned and skipped
            self._decide_serving()
        else:
            self.save()


_TUNER: Optional[_Tuner] = None
_DIR_OVERRIDE: Optional[str] = None
_LOCK = threading.Lock()


def _tuner() -> Optional[_Tuner]:
    global _TUNER
    directory = _DIR_OVERRIDE or os.environ.get(TUNING_DIR_ENV) or None
    if not directory:
        return None
    with _LOCK:
        if _TUNER is None or _TUNER.dir != directory:
            _TUNER = _Tuner(directory)
        return _TUNER


def enabled() -> bool:
    return _tuner() is not None


def reset() -> None:
    """Drop all in-process tuner state (tests; the store file stays)."""
    global _TUNER, _DIR_OVERRIDE
    with _LOCK:
        _TUNER = None
        _DIR_OVERRIDE = None


def configure(model_sha256: Optional[str] = None,
              store_dir: Optional[str] = None) -> None:
    """Pin fingerprint inputs / point the tuner at an explicit store
    (``bundles build --tuned-from``). Either argument may be omitted."""
    global _DIR_OVERRIDE
    if store_dir is not None:
        with _LOCK:
            _DIR_OVERRIDE = os.path.abspath(store_dir)
    t = _tuner()
    if t is not None and model_sha256 is not None:
        t.configure(model_sha256=model_sha256)


def observe_batch_size(n: int) -> None:
    t = _tuner()
    if t is not None:
        t.observe_batch_size(n)


def observe_score(seconds: float) -> None:
    t = _tuner()
    if t is not None:
        t.observe_score(seconds)


def observe_forming_wait(seconds: float) -> None:
    t = _tuner()
    if t is not None:
        t.observe_forming_wait(seconds)


def note_slot_geometry(row_bytes: int, max_batch: int) -> None:
    t = _tuner()
    if t is not None:
        t.note_slot_geometry(row_bytes, max_batch)


def resolve_hist_engine(n_rows: int, num_features: int, num_bins: int,
                        candidates: Sequence[str],
                        measure: Optional[Callable[[str], float]] = None,
                        ) -> Optional[str]:
    """Site 1: the measured histogram-engine winner for this fit's shape
    bucket (store hit, or calibrated now via ``measure``), or None for
    the static rule. The caller applies the hint and MUST do so before
    any compiled-program cache key is assembled (lint-anchored)."""
    t = _tuner()
    if t is None:
        return None
    return t.resolve_hist_engine(n_rows, num_features, num_bins,
                                 candidates, measure)


def resolve_bucket_ladder() -> Optional[Tuple[int, ...]]:
    """Site 2: the tuned predict bucket ladder (ascending ints), or None
    for the static pow2 ladder. Resolved by ``Booster.predict_plan``
    before its key tuple and by ``serving.bucket_size`` — cheap enough
    for both hot paths (two dict probes when tuning is disabled)."""
    t = _tuner()
    if t is None:
        return None
    return t.bucket_ladder()


def resolve_hold_window() -> float:
    """Site 3: dispatch hold window in seconds (0.0 = dispatch on first
    formed request, the static rule). ``MMLSPARK_TPU_TUNE_HOLD_MS`` pins
    it; the SLO-burn override is applied at dispatch, not here."""
    t = _tuner()
    if t is None:
        return 0.0
    return t.hold_window()


def resolve_slots_auto(max_batch: int,
                       row_bytes: Optional[int] = None) -> Optional[int]:
    """Site 4: measured slot-table size for ``ASERVE_SLOTS=auto``, or
    None when the store holds no decision (first process: static cap)."""
    t = _tuner()
    if t is None:
        return None
    return t.slots_auto(max_batch, row_bytes=row_bytes)


def growth_tristate_hint() -> Optional[str]:
    """The measured engine winner (``pallas``/``onehot``/``scatter``)
    the ``hist_subtraction``/``compact_selector`` tri-states key off, or
    None for the static backend-name rule."""
    t = _tuner()
    if t is None:
        return None
    return t.growth_hint()


def snapshot_payload() -> Dict[str, Any]:
    """``/debug/tuning`` body (both engines)."""
    t = _tuner()
    if t is None:
        return {"enabled": False, "status": "disabled",
                "note": f"set {TUNING_DIR_ENV} to enable the "
                        "measure→decide loop (docs/performance.md "
                        "§Auto-tuning)"}
    return t.snapshot_payload()


def provenance() -> Optional[Dict[str, Any]]:
    """Compact decision stamp for bench rounds / bundle manifests; None
    when tuning is disabled."""
    t = _tuner()
    return None if t is None else t.provenance()


def flush() -> None:
    """Persist evidence + take pending decisions (drain/stop paths)."""
    t = _tuner()
    if t is not None:
        t.flush()
