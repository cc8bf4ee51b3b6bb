"""Central registry of every ``MMLSPARK_TPU_*`` environment variable.

Counterpart of ``mmlspark_tpu/observability/env_registry.py``, holding
the knobs this package reads (same names, defaults and docs, so an
operator's settings carry over). Two consumers:

* **the port's tests** (``tests/test_torch_observability.py``): a
  ``MMLSPARK_TPU_*`` literal anywhere in ``mmlspark_tpu_torch/`` that is
  not declared here — or an entry here that nothing reads — fails, so
  the table cannot drift from the code.
* **humans**: ``python -c "from mmlspark_tpu_torch.observability import
  env_registry as e; print(e.render_markdown())"``.

Entries read outside the Python package declare it: ``where="native"``
(the C++ host runtime) — the test then exempts them from the
must-be-read-in-package check. Keep ``doc`` to one line; defaults are
the *effective* defaults (what an unset variable behaves like), quoted
as the reader would type them.

Stdlib-only on purpose: observability modules are imported by every
layer and must stay cycle-free (the ``obs-import-cycle`` rule).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["EnvVar", "REGISTRY", "get", "names", "render_markdown",
           "SECTIONS", "env_float", "env_int"]


def env_float(name: str, default: float) -> float:
    """Read a float knob; unset, empty, or unparseable -> ``default``
    (the one fallback semantics every consumer shares — keep parsing
    here so it cannot drift between subsystems)."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: section id -> docs file the generated table lives in
SECTIONS: Dict[str, str] = {"observability": "docs/observability.md",
                            "performance": "docs/performance.md",
                            "robustness": "docs/robustness.md"}

#: who reads an entry: "python" (the package — lint-checked), "native"
#: (the C++ host runtime, exempt from the must-be-read check)
_WHERE = ("python", "native")


@dataclass(frozen=True)
class EnvVar:
    #: exact variable name (the string literal read sites use)
    name: str
    #: effective default when unset, as a human-readable value
    default: str
    #: one-line purpose, rendered into the docs tables
    doc: str
    #: docs table this entry renders into
    section: str = "observability"
    #: who reads it: "python" (the package — lint-checked), "native"
    #: (the C++ host runtime)
    where: str = "python"

    def __post_init__(self) -> None:
        # a typo'd section silently drops the knob from every generated
        # docs table, and a typo'd where silently exempts it from the
        # staleness check — both defeat the single-source-of-truth
        # contract, so they fail at import instead
        if self.section not in SECTIONS:
            raise ValueError(f"{self.name}: unknown section "
                             f"{self.section!r} (known: {sorted(SECTIONS)})")
        if self.where not in _WHERE:
            raise ValueError(f"{self.name}: unknown where "
                             f"{self.where!r} (known: {list(_WHERE)})")
        if not self.name.startswith("MMLSPARK_TPU_"):
            raise ValueError(f"{self.name}: registry entries must be "
                             "MMLSPARK_TPU_* variables")


REGISTRY: Tuple[EnvVar, ...] = (
    # -- logging -----------------------------------------------------------
    EnvVar(name="MMLSPARK_TPU_LOG_LEVEL", default="info",
           doc="log funnel threshold: `debug`/`info`/`warning`/`error` "
               "(runtime: `logging.set_level`)"),
    EnvVar(name="MMLSPARK_TPU_LOG_FILE", default="(stderr)",
           doc="append JSON log lines to this file instead of stderr; an "
               "unopenable path degrades to stderr with one console "
               "notice (runtime: `logging.set_log_file`)"),
    EnvVar(name="MMLSPARK_TPU_LOG_RATE", default="200",
           doc="per-logger records/second cap, 0 = unlimited; overflow "
               "bumps `log_records_dropped_total{logger=...}` and emits "
               "one suppression notice when the window reopens"),
    # -- tracing / flight recorder ----------------------------------------
    EnvVar(name="MMLSPARK_TPU_MAX_TRACE_EVENTS", default="100000",
           doc="span ring-buffer capacity; oldest events drop once full "
               "(`trace_events_dropped_total`; runtime: "
               "`spans.set_max_trace_events`)"),
    EnvVar(name="MMLSPARK_TPU_SLOW_REQUEST_SECONDS", default="1.0",
           doc="requests slower than this record a {metric, seconds, "
               "trace_id} exemplar + `slow_requests_total` (runtime: "
               "`tracing.set_slow_threshold`)"),
    EnvVar(name="MMLSPARK_TPU_FLIGHT_EVENTS", default="4096",
           doc="flight-recorder ring capacity (runtime: "
               "`flight.set_capacity`)"),
    EnvVar(name="MMLSPARK_TPU_FLIGHT_DIR", default="(system temp dir)",
           doc="directory flight-ring dumps land in (crash, SIGUSR2, "
               "watchdog stall, `/debug/flight`); shared-dir safe — "
               "every dump is suffixed pid + per-process counter"),
    EnvVar(name="MMLSPARK_TPU_TIMELINE_EVENTS", default="8192",
           doc="fleet-timeline ring capacity on the gateway (merged "
               "worker flight deltas + lifecycle events; "
               "`/debug/timeline`)"),
    EnvVar(name="MMLSPARK_TPU_FLIGHT_SCRAPE", default="1",
           doc="`0` disables the federation sweep's incremental "
               "`/debug/flight?since=` pull into the fleet timeline "
               "(the `/metrics` scrape itself is unaffected)"),
    # -- watchdog ---------------------------------------------------------
    EnvVar(name="MMLSPARK_TPU_FEDERATION_INTERVAL_SECONDS", default="5.0",
           doc="gateway metrics-federation sweep period over registered "
               "workers"),
    EnvVar(name="MMLSPARK_TPU_WATCHDOG_STALL_SECONDS", default="30",
           doc="global heartbeat stall threshold; per-site floors take "
               "the max (runtime: `watchdog.set_stall_seconds`)"),
    EnvVar(name="MMLSPARK_TPU_WATCHDOG_INTERVAL_SECONDS",
           default="stall/4, clamped to [0.05 s, 5 s]",
           doc="watchdog sampling period (runtime: "
               "`watchdog.set_interval_seconds`)"),
    EnvVar(name="MMLSPARK_TPU_WATCHDOG_LOSS_WINDOW", default="8",
           doc="training-health sentinel window length (divergence / "
               "throughput-collapse detection)"),
    EnvVar(name="MMLSPARK_TPU_TELEMETRY_ROUNDS", default="(off)",
           doc="`1` enables the per-boost-round telemetry callback of the "
               "estimators (a `boost_round` instant, "
               "`gbdt_boost_rounds_total` and `gbdt_round_metric` per "
               "round)"),
    # -- SLO plane / tail attribution --------------------------------------
    EnvVar(name="MMLSPARK_TPU_SLO", default="(off)",
           doc="per-endpoint serving objectives, `;`-separated "
               "`endpoint:p99<25ms,err<0.1%` entries (`p<P><<T>ms|s` = "
               "latency clause, `err<C%` = 5xx ceiling); drives the "
               "`slo_burn_rate`/`slo_budget_remaining` gauges, "
               "`/debug/slo`, and the tail sampler on both engines; a "
               "malformed spec degrades to unconfigured with a flight "
               "event (runtime: `slo.configure`)"),
    EnvVar(name="MMLSPARK_TPU_TAIL_SAMPLES", default="128",
           doc="tail-sampler reservoir capacity: how many objective-"
               "breaching request timelines `/debug/tail` retains "
               "(oldest evicted and counted in `dropped_total`)"),
    # -- roofline / device-memory ledgers ---------------------------------
    EnvVar(name="MMLSPARK_TPU_PEAK_FLOPS", default="(per-device_kind table)",
           doc="backend peak FLOP/s the roofline ledger computes "
               "%-of-peak against; overrides the built-in per-"
               "`device_kind` table (unknown backends degrade to "
               "ratios-only)"),
    EnvVar(name="MMLSPARK_TPU_PEAK_BYTES_PER_SECOND",
           default="(per-device_kind table)",
           doc="backend peak HBM bytes/s for the roofline ledger's "
               "memory-bound axis; same override/degradation semantics "
               "as `MMLSPARK_TPU_PEAK_FLOPS`"),
    EnvVar(name="MMLSPARK_TPU_DEVICE_MEMORY_INTERVAL_SECONDS",
           default="30",
           doc="period of the background `device_memory_bytes` sampling "
               "hooked into the watchdog tick and federation sweep "
               "(0 disables; samples only once CUDA is initialised)"),
    # -- training ---------------------------------------------------------
    EnvVar(name="MMLSPARK_TPU_HIST_BLOCKS", default="0",
           section="performance",
           doc="canonical histogram-reduction block count for "
               "topology-independent GBDT training: world sizes dividing "
               "it grow bit-identical trees (`8` covers 1/2/4/8 ranks); "
               "0 keeps the plain all-reduce path (resolved via "
               "`placement.resolve_hist_blocks` before training; a value "
               "the group or the rows cannot tile degrades to 0 with a "
               "flight event)"),
    EnvVar(name="MMLSPARK_TPU_MESH_DEVICES", default="(all devices)",
           section="performance",
           doc="cap the default data group to its first N ranks "
               "(scaling A/B legs, placement debugging); an explicit "
               "`make_mesh` group is honored as given"),
    EnvVar(name="MMLSPARK_TPU_TIMING", default="(off)",
           section="performance",
           doc="`1` prints a wall-time phase breakdown per "
               "`train_booster` call (console output by design — an "
               "explicit operator request, independent of the telemetry "
               "kill switch)"),
    EnvVar(name="MMLSPARK_TPU_BINNED_CACHE", default="1",
           section="performance",
           doc="`0` disables the binned-device-dataset fit cache (the "
               "cache pins up to two [F, n] bin matrices in device "
               "memory; `clear_binned_dataset_cache()` releases them)"),
    # -- predict lanes / ingest -------------------------------------------
    EnvVar(name="MMLSPARK_TPU_PREDICT_DTYPE", default="f32",
           section="performance",
           doc="fused-predict lane: `f32` / `bf16` (thresholds + features "
               "cast, f32 leaves) / `int8` (bin-id routing + quantized "
               "leaves); resolved once in `quantize.resolve_predict_dtype` "
               "before any predictor cache key — unknown values degrade "
               "to `f32` with a flight event; per-call "
               "`predict(..., predict_dtype=...)` overrides"),
    EnvVar(name="MMLSPARK_TPU_INGEST_HOST_QUANT", default="(off)",
           section="performance",
           doc="`1` bins streaming-ingest chunks on the host (same "
               "searchsorted grid as the device binner — bit-identical "
               "matrices) and ships uint8 instead of f32, 4x fewer h2d "
               "bytes; default off because host binning costs CPU per "
               "chunk"),
    # -- streaming / serving ----------------------------------------------
    EnvVar(name="MMLSPARK_TPU_DISABLE_PREFETCH", default="(off)",
           section="performance",
           doc="`1`/`true`/`yes` degrades every streaming adopter to the "
               "plain sequential loop (no background reader thread)"),
    EnvVar(name="MMLSPARK_TPU_SERVING_ENGINE", default="async",
           section="performance",
           doc="serving engine behind `serve()` / `serving_main`: "
               "`async` (io/aserve event loop, continuous batching, "
               "zero-copy slot admission) or `threaded` (deprecated: "
               "ThreadingHTTPServer + get_batch windows — selecting it "
               "logs a structured warning and bumps "
               "`serving_engine_deprecated_total`); `serve().engine(...)` "
               "and `serving_main --engine` override; an unknown env "
               "value degrades to `async` with a flight event"),
    EnvVar(name="MMLSPARK_TPU_ASERVE_SLOTS", default="(max_batch)",
           section="performance",
           doc="async engine slot-table size — rows per pre-pinned "
               "staging buffer, i.e. the device batch cap the compiled "
               "predictor sees (pow2-rounded; 0 follows the query's "
               "`max_batch`; `auto` sizes from the auto-tuner's measured "
               "p99.9 admitted-batch rows reconciled against HBM "
               "headroom — needs `MMLSPARK_TPU_TUNING_DIR`); the "
               "admission backlog bound stays "
               "`MMLSPARK_TPU_MAX_QUEUE_DEPTH`"),
    # -- auto-tuning (docs/performance.md §Auto-tuning) --------------------
    EnvVar(name="MMLSPARK_TPU_TUNING_DIR", default="(off)",
           section="performance",
           doc="directory of the auto-tuner's decision store — setting "
               "it enables the measure→decide loop (engine selection, "
               "bucket ladder, dispatch hold window, slot sizing); "
               "decisions persist here so the second process starts "
               "tuned, fingerprinted on device kind + model hash + "
               "framework version (skew degrades loudly to the static "
               "rules)"),
    EnvVar(name="MMLSPARK_TPU_TUNE_MIN_SAMPLES", default="64",
           section="performance",
           doc="observed-batch evidence bar: the serving-side tuning "
               "decisions (ladder / slots / hold window) are taken once "
               "this many admitted batches have been recorded"),
    EnvVar(name="MMLSPARK_TPU_TUNE_HOLD_MS", default="(tuner decides)",
           section="performance",
           doc="pin the async dispatch hold window in ms (`0` disables "
               "holding entirely) — the opt-out for tuning site 3; "
               "unset lets the tuner derive it from the roofline "
               "`bound` verdict and stage EWMAs"),
    EnvVar(name="MMLSPARK_TPU_TUNE_HOLD_CAP_MS", default="2.0",
           section="performance",
           doc="upper bound on the tuner-computed dispatch hold window "
               "(the latency the pacing decision may spend forming a "
               "fuller batch; the SLO-burn override dispatches "
               "immediately regardless)"),
    # -- explainability ----------------------------------------------------
    EnvVar(name="MMLSPARK_TPU_SHAP_HOST", default="(auto by backend)",
           section="performance",
           doc="`1` forces the host TreeSHAP recursion (the reference "
               "the device path is pinned against)"),
    EnvVar(name="MMLSPARK_TPU_SHAP_DEVICE", default="(auto by backend)",
           section="performance",
           doc="`1` forces the fixed-shape device TreeSHAP program "
               "(default on cuda; the host engine on cpu)"),
    EnvVar(name="MMLSPARK_TPU_SHAP_NATIVE", default="1",
           section="performance",
           doc="`0` disables the native C++ TreeSHAP engine inside the "
               "host path (falls back to vectorized numpy recursion)"),
    # -- robustness: fault injection --------------------------------------
    EnvVar(name="MMLSPARK_TPU_FAILPOINTS", default="(off)",
           section="robustness",
           doc="fault-injection rules, `site:kind[:arg][@N]` "
               "comma-separated (kinds `error_<status>`/`error`/`delay`/"
               "`exit`; grammar + site table in docs/robustness.md); "
               "byte-identical no-op when unset"),
    EnvVar(name="MMLSPARK_TPU_FAILPOINTS_SEED", default="0",
           section="robustness",
           doc="seed for probabilistic fault rules — the same spec + "
               "seed replays the same fired-fault sequence"),
    # -- robustness: retry policy -----------------------------------------
    EnvVar(name="MMLSPARK_TPU_RETRY_MAX_ATTEMPTS", default="3",
           section="robustness",
           doc="`RetryPolicy` total attempts including the first"),
    EnvVar(name="MMLSPARK_TPU_RETRY_BASE_MS", default="25",
           section="robustness",
           doc="`RetryPolicy` full-jitter backoff base (delay drawn "
               "uniform(0, min(cap, base·2^attempt)))"),
    EnvVar(name="MMLSPARK_TPU_RETRY_MAX_MS", default="2000",
           section="robustness",
           doc="`RetryPolicy` backoff cap per sleep"),
    EnvVar(name="MMLSPARK_TPU_RETRY_BUDGET_RATIO", default="0.1",
           section="robustness",
           doc="retry-budget tokens accrued per admitted request — under "
               "a total outage retry load converges to this fraction of "
               "live traffic"),
    EnvVar(name="MMLSPARK_TPU_RETRY_BUDGET_MIN", default="10",
           section="robustness",
           doc="retry-budget starting balance (cold starts can fail over "
               "before traffic has accrued tokens)"),
    EnvVar(name="MMLSPARK_TPU_RETRY_BUDGET_CAP", default="100",
           section="robustness",
           doc="retry-budget token ceiling"),
    # -- robustness: circuit breakers -------------------------------------
    EnvVar(name="MMLSPARK_TPU_BREAKER_CONSECUTIVE", default="5",
           section="robustness",
           doc="consecutive soft failures that open a worker's breaker"),
    EnvVar(name="MMLSPARK_TPU_BREAKER_ERROR_RATE", default="0.5",
           section="robustness",
           doc="windowed error-rate threshold that opens a breaker (at "
               "`MIN_VOLUME`+ observations)"),
    EnvVar(name="MMLSPARK_TPU_BREAKER_WINDOW", default="20",
           section="robustness",
           doc="breaker outcome-window length for the error-rate trip"),
    EnvVar(name="MMLSPARK_TPU_BREAKER_MIN_VOLUME", default="10",
           section="robustness",
           doc="minimum windowed observations before the error rate can "
               "trip a breaker"),
    EnvVar(name="MMLSPARK_TPU_BREAKER_OPEN_SECONDS",
           default="(gateway health interval)", section="robustness",
           doc="open-state cooldown before a half-open probe is due"),
    EnvVar(name="MMLSPARK_TPU_BREAKER_HALF_OPEN_SUCCESSES", default="1",
           section="robustness",
           doc="successful health-loop probes needed to re-close a "
               "half-open breaker"),
    EnvVar(name="MMLSPARK_TPU_DEADLINE_MARGIN_MS", default="5",
           section="robustness",
           doc="per-hop attenuation subtracted from the re-emitted "
               "`X-Deadline-Ms` budget (wire + serialization slack)"),
    # -- robustness: admission / drain / gateway --------------------------
    EnvVar(name="MMLSPARK_TPU_MAX_QUEUE_DEPTH", default="512",
           section="robustness",
           doc="worker bounded-queue admission limit — past it requests "
               "shed with 429 + a queue-drain-derived Retry-After "
               "(0 = unbounded)"),
    EnvVar(name="MMLSPARK_TPU_DRAIN_SETTLE_SECONDS", default="0.5",
           section="robustness",
           doc="SIGTERM drain: keep serving this long after "
               "deregistration while gateways drop the worker from "
               "their routing tables"),
    EnvVar(name="MMLSPARK_TPU_DRAIN_TIMEOUT_SECONDS", default="30",
           section="robustness",
           doc="SIGTERM drain: seconds to finish queued + in-flight "
               "work before the worker stops"),
    EnvVar(name="MMLSPARK_TPU_GATEWAY_HEALTH_INTERVAL_SECONDS",
           default="2.0", section="robustness",
           doc="gateway health-sweep period — also the cadence of "
               "half-open breaker probes"),
    EnvVar(name="MMLSPARK_TPU_GATEWAY_MAX_FAILOVERS", default="3",
           section="robustness",
           doc="failover retries per routed request (each also spends "
               "one retry-budget token)"),
    # -- robustness: preemption-safe training -----------------------------
    EnvVar(name="MMLSPARK_TPU_STRICT_RESUME", default="(off)",
           section="robustness",
           doc="`1` = resume-or-die: checkpoints that exist but mismatch "
               "the run's fingerprint raise `CheckpointMismatchError` "
               "instead of silently retraining from scratch"),
    EnvVar(name="MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY", default="(off)",
           section="robustness",
           doc="`1` = a watchdog stall or training-health sentinel "
               "during a checkpointed fit dumps the newest HEALTHY "
               "state immediately (one-shot per fit)"),
    EnvVar(name="MMLSPARK_TPU_BUNDLE_DIR", default="(off)",
           section="performance",
           doc="serving-bundle directory whose predict graphs "
               "`serving_main` workers capture before binding "
               "(`--bundle` overrides; build with `python -m "
               "mmlspark_tpu_torch.bundles build`); a mismatched or "
               "corrupt bundle degrades to capture on first use with a "
               "structured warning"),
    # -- native host runtime ----------------------------------------------
    EnvVar(name="MMLSPARK_TPU_NATIVE_THREADS", default="(hardware "
           "concurrency, budget-clamped)", section="performance",
           where="native",
           doc="caps the native TreeSHAP thread pool (read by the C++ "
               "runtime; threads are also clamped to the 256 MiB arena "
               "budget)"),
)

_BY_NAME: Dict[str, EnvVar] = {v.name: v for v in REGISTRY}


def get(name: str) -> Optional[EnvVar]:
    return _BY_NAME.get(name)


def names() -> frozenset:
    return frozenset(_BY_NAME)


def render_markdown(section: Optional[str] = None) -> str:
    """GitHub-markdown table of the registry (one ``section``, or all)."""
    rows = [v for v in REGISTRY
            if section is None or v.section == section]
    out = ["| Variable | Default | Purpose |",
           "| --- | --- | --- |"]
    for v in rows:
        out.append(f"| `{v.name}` | {v.default} | {v.doc} |")
    return "\n".join(out)
