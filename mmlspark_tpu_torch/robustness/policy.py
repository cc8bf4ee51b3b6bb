"""Resilience policy: jittered backoff, retry budgets, breakers, deadlines.

The primitives the serving request plane (io/serving.py,
io/distributed_serving.py, io/http.py) degrades gracefully through —
factored out of the call sites so the async engine (``io/aserve``)
inherits the policy wholesale:

- :func:`backoff` / :class:`RetryPolicy` — exponential backoff with FULL
  jitter (a fixed schedule retries synchronized clients in lockstep;
  jitter decorrelates them), honoring ``Retry-After`` in BOTH RFC 9110
  forms (delta-seconds and HTTP-date), deadline-aware, with an attempt
  budget. The ONLY sanctioned sleep in an ``io/`` retry loop
  (graftlint's ``retry-sleep-funnel`` rule).
- :class:`RetryBudget` — token bucket that caps retries at a fraction of
  live traffic, so a failing backend sees load shed instead of a retry
  storm that finishes it off.
- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-worker
  closed/open/half-open state driven by consecutive failures, error rate,
  or hard (connection-level) failures; half-open probes piggyback on the
  gateway health loop.
- :class:`Deadline` — ``X-Deadline-Ms`` propagation, attenuated per hop,
  so no hop scores work nobody is still waiting for.
- :func:`retry_after_seconds` — the shared Retry-After math, derived
  from observed latency so well-behaved clients back off realistically.

Everything is observable: breaker transitions, budget exhaustion, and
deadline expiries land in the metrics registry and the flight ring.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from collections import deque
from email.utils import parsedate_to_datetime
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Sequence, Tuple)

from ..observability import flight as _flight
from ..observability import metrics as _metrics
# the one shared env-parsing fallback semantics (re-exported: io/ and
# the gateway read their knobs through policy)
from ..observability.env_registry import env_float, env_int  # noqa: F401
from ..observability.logging import get_logger

logger = get_logger("mmlspark_tpu_torch.robustness.policy")

__all__ = [
    "DEADLINE_HEADER", "RETRY_AFTER_CAP_SECONDS",
    "CLOSED", "OPEN", "HALF_OPEN",
    "backoff", "backoff_delay", "parse_retry_after",
    "env_float", "env_int",
    "RetryPolicy", "RetryBudget",
    "BreakerConfig", "CircuitBreaker", "BreakerBoard",
    "Deadline", "Ewma", "retry_after_seconds",
]

#: remaining-milliseconds deadline header, attenuated at every hop (the
#: one definition — graftlint's ``deadline-header-literal`` rule pins
#: the literal to this module, like the trace headers)
DEADLINE_HEADER = "X-Deadline-Ms"

#: RFC-compliant servers may send huge Retry-After values; we never
#: honour more than this (both delta-seconds and HTTP-date forms)
RETRY_AFTER_CAP_SECONDS = 30.0


class Ewma:
    """Tiny thread-safe exponentially-weighted moving average; ``value``
    is None until the first observation (callers pick their fallback)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._value: Optional[float] = None
        self._lock = threading.Lock()

    def update(self, x: float) -> float:
        with self._lock:
            if self._value is None:
                self._value = float(x)
            else:
                self._value += self.alpha * (float(x) - self._value)
            return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value


# ---------------------------------------------------------------------------
# Backoff with full jitter
# ---------------------------------------------------------------------------

_rng = random.Random()


def parse_retry_after(value: Optional[str],
                      now: Optional[float] = None) -> Optional[float]:
    """Seconds to wait per a ``Retry-After`` header value — RFC 9110
    accepts delta-seconds ("120") *and* an HTTP-date ("Wed, 21 Oct 2015
    07:28:00 GMT"); both are honoured and both are capped at
    :data:`RETRY_AFTER_CAP_SECONDS`. Returns None for absent,
    unparseable, or non-positive values — a past HTTP-date (clock skew)
    or "0" carries no pacing information, and a zero-second override
    would turn the retry loop into a zero-delay hammer on a recovering
    server; the caller's own backoff schedule applies instead."""
    if not value:
        return None
    value = value.strip()
    try:
        delay = float(value)
    except ValueError:
        try:
            dt = parsedate_to_datetime(value)
        except (TypeError, ValueError):
            return None
        if dt is None:
            return None
        if dt.tzinfo is None:
            from datetime import timezone
            dt = dt.replace(tzinfo=timezone.utc)
        delay = dt.timestamp() - (time.time() if now is None else now)
    if delay <= 0:
        return None
    return min(delay, RETRY_AFTER_CAP_SECONDS)


def backoff_delay(attempt: int, *, schedule_ms: Optional[Iterable[float]] = None,
                  base_ms: float = 100.0, cap_ms: float = 10_000.0,
                  retry_after: Optional[str] = None,
                  rng: Optional[random.Random] = None) -> float:
    """Delay in seconds for retry ``attempt`` (0-based).

    A parseable ``Retry-After`` (either RFC 9110 form) wins outright,
    capped at :data:`RETRY_AFTER_CAP_SECONDS` — the server said when to
    come back; jittering *that* would defeat it. Otherwise: full jitter,
    ``uniform(0, upper)`` where ``upper`` is the schedule entry (last
    entry repeats) or ``min(cap, base * 2^attempt)``.
    """
    ra = parse_retry_after(retry_after)
    if ra is not None:
        return ra
    if schedule_ms is not None:
        sched = list(schedule_ms)
        upper = float(sched[min(attempt, len(sched) - 1)]) if sched else 0.0
    else:
        upper = min(float(cap_ms), float(base_ms) * (2.0 ** max(0, attempt)))
    if upper <= 0:
        return 0.0
    return (rng or _rng).uniform(0.0, upper) / 1000.0


def backoff(attempt: int, *, schedule_ms: Optional[Iterable[float]] = None,
            base_ms: float = 100.0, cap_ms: float = 10_000.0,
            retry_after: Optional[str] = None,
            rng: Optional[random.Random] = None,
            sleep: Optional[Callable[[float], None]] = None) -> float:
    """Compute the jittered delay AND sleep it; returns the seconds slept.
    This is the funnel ``io/`` retry loops must route their sleeps
    through (tests/test_lint.py bans bare ``time.sleep`` there)."""
    d = backoff_delay(attempt, schedule_ms=schedule_ms, base_ms=base_ms,
                      cap_ms=cap_ms, retry_after=retry_after, rng=rng)
    if d > 0:
        (sleep or time.sleep)(d)
    return d


class RetryPolicy:
    """Attempt budget + full-jitter backoff, deadline-aware.

    ``sleep_before(attempt)`` (attempt 0 = first retry) routes through
    :func:`backoff`: full jitter by default, an explicit millisecond
    ``schedule`` for the HTTP-on-X ``backoffs`` parity path, and a
    server-directed ``Retry-After`` (either RFC 9110 form) overriding
    both. With a :class:`Deadline`, sleeps are clamped to the remaining
    budget and :meth:`should_retry` refuses attempts the budget can no
    longer cover. An optional :class:`RetryBudget` gates every retry —
    token-bucket exhaustion stops the loop even when attempts remain.

    Env defaults: ``MMLSPARK_TPU_RETRY_MAX_ATTEMPTS`` (3),
    ``MMLSPARK_TPU_RETRY_BASE_MS`` (25), ``MMLSPARK_TPU_RETRY_MAX_MS``
    (2000).
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_ms: Optional[float] = None,
                 max_ms: Optional[float] = None,
                 schedule_ms: Optional[Sequence[float]] = None,
                 budget: Optional["RetryBudget"] = None,
                 rng: Optional[random.Random] = None):
        self.max_attempts = max(1, int(
            max_attempts if max_attempts is not None
            else env_int("MMLSPARK_TPU_RETRY_MAX_ATTEMPTS", 3)))
        self.base_ms = max(0.0, float(
            base_ms if base_ms is not None
            else env_float("MMLSPARK_TPU_RETRY_BASE_MS", 25.0)))
        self.max_ms = max(0.0, float(
            max_ms if max_ms is not None
            else env_float("MMLSPARK_TPU_RETRY_MAX_MS", 2000.0)))
        self.schedule_ms = (None if schedule_ms is None
                            else [float(s) for s in schedule_ms])
        if self.schedule_ms is not None:
            self.max_attempts = len(self.schedule_ms) + 1
        self.budget = budget
        self._rng = rng

    @classmethod
    def from_schedule(cls, backoffs_ms: Sequence[float],
                      budget: Optional["RetryBudget"] = None
                      ) -> "RetryPolicy":
        """Explicit millisecond schedule: one retry per entry
        (HandlingUtils.advancedUDF parity; each step still jitters
        ``uniform(0, step)`` unless Retry-After overrides)."""
        return cls(schedule_ms=list(backoffs_ms), budget=budget)

    def should_retry(self, attempt: int,
                     deadline: Optional["Deadline"] = None) -> bool:
        """True when retry ``attempt`` (0-based) exists in the attempt
        budget, the deadline (if any) has time left, and the token
        bucket (if any) grants it. The bucket is spent HERE — call once
        per retry decision."""
        if attempt + 1 >= self.max_attempts:
            return False
        if deadline is not None and deadline.expired:
            return False
        return self.budget is None or self.budget.try_spend()

    def sleep_before(self, attempt: int,
                     retry_after: Optional[str] = None,
                     deadline: Optional["Deadline"] = None,
                     sleep: Optional[Callable[[float], None]] = None
                     ) -> float:
        """Back off before retry ``attempt`` (0-based) via the
        :func:`backoff` funnel; the delay is clamped to the deadline's
        remaining budget. Returns the seconds slept."""
        d = backoff_delay(attempt, schedule_ms=self.schedule_ms,
                          base_ms=self.base_ms, cap_ms=self.max_ms,
                          retry_after=retry_after, rng=self._rng)
        if deadline is not None:
            d = deadline.clamp(d)
        if d > 0:
            (sleep or time.sleep)(d)
        return max(0.0, d)

    def run(self, fn: Callable[[], Any], *,
            retry_on: Tuple[type, ...] = (Exception,),
            deadline: Optional["Deadline"] = None) -> Any:
        """Call ``fn`` under the attempt budget; re-raises the last
        exception when attempts (or the deadline / token bucket) run
        out."""
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                if not self.should_retry(attempt, deadline):
                    raise
                self.sleep_before(attempt, deadline=deadline)
                attempt += 1


# ---------------------------------------------------------------------------
# Retry budget (token bucket)
# ---------------------------------------------------------------------------


class RetryBudget:
    """Retries capped at a fraction of live traffic.

    Every admitted request deposits ``ratio`` tokens (clamped to
    ``cap``); every retry spends one. Under a total backend outage the
    retry load converges to ``ratio`` × the request rate instead of
    multiplying it — the storm a fixed retry count produces.
    ``min_tokens`` is the starting balance, so cold starts and tests can
    fail over before any traffic has accrued budget.

    Env defaults: ``MMLSPARK_TPU_RETRY_BUDGET_RATIO`` (0.1),
    ``MMLSPARK_TPU_RETRY_BUDGET_MIN`` (10),
    ``MMLSPARK_TPU_RETRY_BUDGET_CAP`` (100).
    """

    def __init__(self, ratio: Optional[float] = None,
                 min_tokens: Optional[float] = None,
                 cap: Optional[float] = None, **labels: Any):
        self.ratio = (ratio if ratio is not None else
                      env_float("MMLSPARK_TPU_RETRY_BUDGET_RATIO", 0.1))
        self.min_tokens = (min_tokens if min_tokens is not None else
                           env_float("MMLSPARK_TPU_RETRY_BUDGET_MIN", 10.0))
        self.cap = (cap if cap is not None else
                    env_float("MMLSPARK_TPU_RETRY_BUDGET_CAP", 100.0))
        self.cap = max(self.cap, self.min_tokens)
        self._tokens = float(self.min_tokens)
        self._labels = {str(k): str(v) for k, v in labels.items()}
        self._lock = threading.Lock()
        self._publish()

    def _publish(self) -> None:
        _metrics.safe_gauge("retry_budget_tokens",
                            **self._labels).set(self._tokens)

    @property
    def tokens(self) -> float:
        return self._tokens

    def deposit(self, n: float = 1.0) -> None:
        """Called once per admitted request: accrue ``ratio`` per unit."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio * n)
        self._publish()

    def try_spend(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens for a retry; False (and accounting) when the
        budget is exhausted — the caller must NOT retry then."""
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                ok = True
            else:
                ok = False
        if ok:
            _metrics.safe_counter("retry_budget_spent_total",
                                  **self._labels).inc(n)
        else:
            _metrics.safe_counter("retry_budget_exhausted_total",
                                  **self._labels).inc()
            _flight.record("retry_budget_exhausted", tokens=self._tokens,
                           **self._labels)
        self._publish()
        return ok


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
#: breaker_state gauge encoding
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class BreakerConfig:
    """Thresholds shared by every breaker on a board.

    Env defaults: ``MMLSPARK_TPU_BREAKER_CONSECUTIVE`` (5),
    ``MMLSPARK_TPU_BREAKER_ERROR_RATE`` (0.5),
    ``MMLSPARK_TPU_BREAKER_WINDOW`` (20),
    ``MMLSPARK_TPU_BREAKER_MIN_VOLUME`` (10),
    ``MMLSPARK_TPU_BREAKER_OPEN_SECONDS`` (caller default),
    ``MMLSPARK_TPU_BREAKER_HALF_OPEN_SUCCESSES`` (1).
    """

    def __init__(self, consecutive_failures: Optional[int] = None,
                 error_rate: Optional[float] = None,
                 window: Optional[int] = None,
                 min_volume: Optional[int] = None,
                 open_seconds: Optional[float] = None,
                 half_open_successes: Optional[int] = None,
                 default_open_seconds: float = 10.0):
        env_open = os.environ.get("MMLSPARK_TPU_BREAKER_OPEN_SECONDS")
        self.consecutive_failures = (
            consecutive_failures if consecutive_failures is not None
            else env_int("MMLSPARK_TPU_BREAKER_CONSECUTIVE", 5))
        self.error_rate = (error_rate if error_rate is not None else
                           env_float("MMLSPARK_TPU_BREAKER_ERROR_RATE", 0.5))
        self.window = (window if window is not None else
                       env_int("MMLSPARK_TPU_BREAKER_WINDOW", 20))
        self.min_volume = (min_volume if min_volume is not None else
                           env_int("MMLSPARK_TPU_BREAKER_MIN_VOLUME", 10))
        if open_seconds is not None:
            self.open_seconds = open_seconds
        elif env_open:
            self.open_seconds = env_float(
                "MMLSPARK_TPU_BREAKER_OPEN_SECONDS", default_open_seconds)
        else:
            self.open_seconds = default_open_seconds
        self.half_open_successes = (
            half_open_successes if half_open_successes is not None
            else env_int("MMLSPARK_TPU_BREAKER_HALF_OPEN_SUCCESSES", 1))


class CircuitBreaker:
    """closed → open → half_open → closed, per backend.

    Opens on: a hard failure (connection-level — the worker is GONE, one
    strike is enough, matching the old dead-marking), ``consecutive``
    soft failures, or a windowed error rate past the threshold at
    minimum volume. While open, :meth:`allow` is False (callers route
    around). After ``open_seconds``, :meth:`probe_due` turns true and the
    owner's health loop calls :meth:`begin_probe` (→ half_open) and
    probes; probe success(es) close it, a probe failure reopens it.
    Request traffic never probes a half-open backend itself — the health
    loop owns recovery, so one sick worker can't eat live requests.
    """

    def __init__(self, key: str, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 label: str = "worker"):
        self.key = key
        self.cfg = config or BreakerConfig()
        self._clock = clock
        self._label = {label: key}
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._window = deque(maxlen=max(1, self.cfg.window))
        self._opened_at = 0.0
        self._half_open_hits = 0
        _metrics.safe_gauge("breaker_state", **self._label).set(0.0)

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """May live traffic go to this backend right now?"""
        return self._state == CLOSED

    def probe_due(self) -> bool:
        return (self._state == OPEN
                and self._clock() - self._opened_at >= self.cfg.open_seconds)

    def begin_probe(self) -> bool:
        """open → half_open when the cooldown has elapsed (health loop)."""
        with self._lock:
            if not self.probe_due():
                return False
            self._transition(HALF_OPEN)
            return True

    def record_success(self) -> None:
        """Live-traffic outcome. Deliberately inert outside CLOSED: a
        success arriving while OPEN/HALF_OPEN is from a request that was
        in flight before the breaker tripped — recovery is the probe
        path's call (:meth:`probe_success`), not a stale reply's."""
        with self._lock:
            self._window.append(True)
            self._consecutive = 0

    def record_failure(self, hard: bool = False) -> None:
        """Live-traffic outcome. ``hard``: connection-level — the
        backend is unreachable, open immediately. Soft failures
        (retryable statuses) accumulate. Inert while HALF_OPEN for the
        same stale-in-flight reason as :meth:`record_success` — only a
        failed probe (:meth:`probe_failure`) may re-open from there."""
        with self._lock:
            self._window.append(False)
            self._consecutive += 1
            if self._state == CLOSED:
                if hard or self._consecutive >= self.cfg.consecutive_failures \
                        or self._rate_tripped():
                    self._transition(OPEN)
            # already OPEN: stale in-flight failures don't restart the clock

    def probe_success(self) -> None:
        """Health-loop probe verdict: counts toward closing a HALF_OPEN
        breaker (``half_open_successes`` of these close it)."""
        with self._lock:
            self._window.append(True)
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._half_open_hits += 1
                if self._half_open_hits >= self.cfg.half_open_successes:
                    self._transition(CLOSED)

    def probe_failure(self) -> None:
        """Health-loop probe verdict: re-opens a HALF_OPEN breaker (and
        restarts its cooldown)."""
        with self._lock:
            self._window.append(False)
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._transition(OPEN)

    def _rate_tripped(self) -> bool:
        if len(self._window) < max(1, self.cfg.min_volume):
            return False
        failures = sum(1 for ok in self._window if not ok)
        return failures / len(self._window) >= self.cfg.error_rate

    def _transition(self, to: str) -> None:
        # caller holds self._lock (every public mutator takes it before
        # delegating here — the lexical with-block lives one frame up)
        frm = self._state
        if frm == to:
            return
        self._state = to
        if to == OPEN:
            self._opened_at = self._clock()
        if to == HALF_OPEN:
            self._half_open_hits = 0  # graftlint: disable=lock-discipline (caller holds self._lock; _transition is only reached from under it)
        if to == CLOSED:
            self._consecutive = 0  # graftlint: disable=lock-discipline (caller holds self._lock; _transition is only reached from under it)
            self._window.clear()
        _metrics.safe_gauge("breaker_state",
                            **self._label).set(_STATE_VALUE[to])
        _metrics.safe_counter("breaker_transitions_total", to=to,
                              **self._label).inc()
        _flight.record("breaker_transition", breaker=self.key,
                       frm=frm, to=to)
        if to == OPEN:
            logger.warning("breaker opened: %s", self.key, breaker=self.key)
        elif frm != CLOSED and to == CLOSED:
            logger.info("breaker closed: %s", self.key, breaker=self.key)

    def describe(self) -> Dict[str, Any]:
        return {"state": self._state, "consecutive": self._consecutive,
                "window": len(self._window),
                "failures": sum(1 for ok in self._window if not ok)}


class BreakerBoard:
    """Per-key breakers sharing one config (the gateway keys by
    ``host:port`` — a bounded slot set, per the federation labeling
    rule, so worker churn can't grow the registry unboundedly)."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 label: str = "worker"):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._label = label
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(key, self.config, self._clock,
                                   self._label)
                self._breakers[key] = b
            return b

    def get(self, key: str) -> Optional[CircuitBreaker]:
        return self._breakers.get(key)

    def allow(self, key: str) -> bool:
        """True when no breaker exists yet (innocent until failing) or
        the existing one is closed."""
        b = self._breakers.get(key)
        return True if b is None else b.allow()

    def items(self) -> Tuple[Tuple[str, CircuitBreaker], ...]:
        with self._lock:
            return tuple(self._breakers.items())

    def states(self) -> Dict[str, str]:
        return {k: b.state for k, b in self.items()}

    def forget(self, key: str) -> None:
        """Drop state for a deregistered backend (the gateway health
        sweep prunes addresses that left the registry — ephemeral-port
        churn must not grow the board without bound)."""
        with self._lock:
            self._breakers.pop(key, None)

    def describe(self) -> Dict[str, Dict[str, Any]]:
        return {k: b.describe() for k, b in self.items()}


# ---------------------------------------------------------------------------
# Deadline propagation
# ---------------------------------------------------------------------------


class Deadline:
    """A request's remaining time, carried as ``X-Deadline-Ms`` and
    attenuated per hop: each hop converts the remaining-milliseconds
    header into an absolute local deadline on arrival, then re-emits
    what is left (minus a safety margin for the wire) on the way out —
    remaining-time transfer needs no clock sync between hosts."""

    __slots__ = ("expires_at", "_clock")

    #: per-hop attenuation margin (network + serialization slack)
    MARGIN_MS_ENV = "MMLSPARK_TPU_DEADLINE_MARGIN_MS"

    def __init__(self, expires_at: float,
                 clock: Callable[[], float] = time.monotonic):
        self.expires_at = expires_at
        self._clock = clock

    @classmethod
    def from_ms(cls, ms: float,
                clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + float(ms) / 1000.0, clock)

    @classmethod
    def from_headers(cls, headers: Optional[Mapping[str, str]],
                     clock: Callable[[], float] = time.monotonic
                     ) -> Optional["Deadline"]:
        """Parse the deadline header from any header mapping (stdlib
        ``Message`` is case-insensitive; plain dicts are tried both
        spelled and lowercased). Unparseable values mean no deadline —
        a malformed client header must not fail the request."""
        if headers is None:
            return None
        raw = headers.get(DEADLINE_HEADER)
        if raw is None and hasattr(headers, "get"):
            raw = headers.get(DEADLINE_HEADER.lower())
        if raw is None:
            return None
        try:
            return cls.from_ms(float(raw), clock)
        except (TypeError, ValueError):
            return None

    def remaining_seconds(self) -> float:
        return max(0.0, self.expires_at - self._clock())

    def clamp(self, timeout: float) -> float:
        """``timeout`` bounded by the remaining budget."""
        return min(float(timeout), self.remaining_seconds())

    def remaining_ms(self) -> float:
        return self.remaining_seconds() * 1000.0

    @property
    def expired(self) -> bool:
        return self._clock() >= self.expires_at

    def header_value(self, margin_ms: Optional[float] = None) -> str:
        """The attenuated remaining budget for the NEXT hop."""
        if margin_ms is None:
            margin_ms = env_float(self.MARGIN_MS_ENV, 5.0)
        return str(max(0, int(self.remaining_ms() - margin_ms)))


# ---------------------------------------------------------------------------
# Retry-After math
# ---------------------------------------------------------------------------


def retry_after_seconds(est_seconds: Optional[float], floor: float = 1.0,
                        cap: float = 60.0) -> int:
    """Integer Retry-After from an estimated time-to-capacity (observed
    queue drain time, worker latency, or a health-sweep interval);
    clamped so a cold estimator still produces a sane hint."""
    est = float(est_seconds) if est_seconds else 0.0
    return int(math.ceil(min(max(est, floor), cap)))
