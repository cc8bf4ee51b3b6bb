"""Pure decision functions: ledger evidence in, knob values out.

Every function here is a deterministic map from recorded evidence to a
resolved knob value — no wall-clock reads, no environment reads, no
device queries. That purity IS the replay contract the tuner promises
(same ledger bytes → same decisions, pinned by byte-comparing stores),
and it keeps each decision unit-testable without jax, a server, or a
clock.

The four decision sites (see the package docstring for where each is
applied) all follow the same shape: return the measured choice when the
evidence clears the bar, return ``None`` (or the neutral value) when it
does not — the caller then degrades to today's static rule.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

#: EWMA smoothing for wall-time evidence (matches the roofline ledger's
#: per-executable call EWMA, so the two planes age samples identically)
EWMA_ALPHA = 0.2

#: a calibration winner must beat the runner-up by this margin — inside
#: it the measurement noise exceeds the signal and the static rule's
#: choice is kept (re-deciding on noise would flip engines per process)
ENGINE_WIN_MARGIN = 0.03

#: ladder rungs snap up to multiples of this (sublane-friendly, and it
#: bounds the rung set against high-cardinality batch-size workloads)
LADDER_STEP = 8

#: at most this many measured rungs join the pow2 head of the ladder —
#: the "bounded set" contract that keeps iter_predict_plans enumerable
LADDER_MAX_RUNGS = 4

__all__ = ["EWMA_ALPHA", "ENGINE_WIN_MARGIN", "LADDER_STEP",
           "LADDER_MAX_RUNGS", "ewma_update", "shape_bucket",
           "decide_hist_engine", "decide_bucket_ladder", "ladder_pad",
           "percentile_from_counts", "decide_hold_window", "decide_slots",
           "pow2_ceil"]


def ewma_update(prev: Optional[float], sample: float,
                alpha: float = EWMA_ALPHA) -> float:
    if prev is None:
        return float(sample)
    return (1.0 - alpha) * float(prev) + alpha * float(sample)


def pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def shape_bucket(n_rows: int, num_features: int, num_bins: int) -> str:
    """The granularity engine measurements generalize across: pow2 row
    and feature buckets plus the exact bin width (bin width changes the
    engines' relative cost structure directly)."""
    return f"r{pow2_ceil(n_rows)}f{pow2_ceil(num_features)}b{int(num_bins)}"


def decide_hist_engine(
        bucket_evidence: Dict[str, Dict[str, float]]) -> Optional[str]:
    """Measured histogram-engine winner for one shape bucket, or None
    when the evidence cannot support a decision (fewer than two engines
    measured, or the win is inside the noise margin).

    ``bucket_evidence``: ``{engine: {"ewma_seconds": s, "samples": n}}``.
    Ties break lexicographically — deterministic across replays.
    """
    timed = sorted(
        (float(ev["ewma_seconds"]), eng)
        for eng, ev in bucket_evidence.items()
        if ev.get("samples", 0) and float(ev.get("ewma_seconds", 0)) > 0)
    if len(timed) < 2:
        return None
    best, runner = timed[0], timed[1]
    if best[0] >= runner[0] * (1.0 - ENGINE_WIN_MARGIN):
        return None
    return best[1]


def percentile_from_counts(counts: Dict[str, float], q: float) -> int:
    """q-th percentile of an integer-valued empirical distribution
    stored as ``{str(value): count}`` (nearest-rank)."""
    total = sum(counts.values())
    if total <= 0:
        return 0
    rank = max(1.0, q * total)
    acc = 0.0
    for value in sorted(counts, key=int):
        acc += counts[value]
        if acc >= rank:
            return int(value)
    return int(max(counts, key=int))


def decide_bucket_ladder(counts: Dict[str, float],
                         min_samples: int) -> Optional[Tuple[int, ...]]:
    """Tuned predict bucket ladder from the observed batch-size
    histogram, or None below the evidence bar.

    The ladder keeps the pow2 head (1..8 — single/trickle requests pad
    well already) and adds up to :data:`LADDER_MAX_RUNGS` measured rungs
    at the workload's p50/p90/p99/max, each snapped UP to a multiple of
    :data:`LADDER_STEP`. Batches above the top rung fall back to pow2 in
    :func:`ladder_pad`, so the ladder stays a bounded, enumerable set.
    A workload that pow2 already fits (every rung lands on a power of
    two) returns None — no decision beats re-keying every compiled
    program for nothing.
    """
    total = sum(counts.values())
    if total < max(1, min_samples):
        return None
    rungs = set()
    for q in (0.50, 0.90, 0.99, 1.0):
        p = percentile_from_counts(counts, q)
        if p > LADDER_STEP:
            rungs.add(-(-p // LADDER_STEP) * LADDER_STEP)
    rungs = set(sorted(rungs)[:LADDER_MAX_RUNGS])
    if not rungs or all(r == pow2_ceil(r) for r in rungs):
        return None
    head = {b for b in (1, 2, 4, 8) if b < min(rungs)}
    return tuple(sorted(head | rungs))


def ladder_pad(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= n; pow2 above the top rung (the ladder
    only covers the measured workload — out-of-distribution batches keep
    today's static behavior)."""
    for rung in ladder:
        if rung >= n:
            return int(rung)
    return pow2_ceil(n)


def decide_hold_window(bound: Optional[str], forming_wait_ewma: float,
                       score_ewma: float, mean_batch: float,
                       slots: int, cap_seconds: float) -> float:
    """Dispatch hold window (seconds; 0.0 = dispatch immediately, the
    static rule).

    Holding the forming buffer only pays when all three are true: the
    score stage is MEMORY-bound (a fuller batch rides the same HBM
    sweep, so rows are nearly free), batches form much faster than they
    score (``forming_wait << score`` — the hold costs little relative
    wall), and the slot table runs under-occupied (there is room to
    fill). A compute-bound stage scales wall time with rows — holding
    would just trade latency for nothing. The SLO-burn override is NOT
    here: burn is time-varying runtime state, checked at dispatch.
    """
    if bound != "memory" or score_ewma <= 0.0 or cap_seconds <= 0.0:
        return 0.0
    if slots <= 0 or mean_batch >= 0.5 * slots:
        return 0.0
    if forming_wait_ewma >= 0.25 * score_ewma:
        return 0.0
    return min(float(cap_seconds), max(0.0005, 2.0 * score_ewma))


def decide_slots(counts: Dict[str, float], max_batch: int,
                 min_samples: int, row_bytes: Optional[int] = None,
                 headroom_bytes: Optional[float] = None) -> Optional[int]:
    """Measured slot-table size: the p99.9 of admitted-batch rows,
    pow2-rounded, clamped to the batch cap — then reconciled against the
    HBM headroom the ``aserve_slots`` claim must fit in (ping-pong = 2
    buffers of ``slots * row_bytes``). None below the evidence bar;
    unknown geometry or headroom skips the reconcile, not the decision.
    """
    total = sum(counts.values())
    if total < max(1, min_samples):
        return None
    p999 = percentile_from_counts(counts, 0.999)
    if p999 <= 0:
        return None
    n = min(pow2_ceil(p999), pow2_ceil(max_batch))
    if row_bytes and headroom_bytes is not None:
        while n > 1 and 2.0 * n * row_bytes > headroom_bytes:
            n //= 2
    return max(1, n)
