"""Resilience plane: fault injection + the policy the stack degrades through.

Two halves, consumed by ``io/serving.py``, ``io/distributed_serving.py``,
``io/http.py``, ``io/prefetch.py``, ``models/gbdt/booster.py`` and
``parallel/distributed.py``:

- :mod:`.failpoints` — seeded, rule-driven fault injection
  (``MMLSPARK_TPU_FAILPOINTS=site:kind[:arg][@N]``): named sites across
  the edge→gateway→worker path, training rounds, streaming, and
  barriers inject synthetic errors, latency, crashes, or hard process
  exits deterministically, each fired fault counted and flight-logged
  so chaos runs replay from the ring. Byte-identical no-op when no
  rules are set.
- :mod:`.policy` — the resilience policy those paths degrade through:
  deadline-budgeted retries (full-jitter backoff honoring both RFC 9110
  Retry-After forms), token-bucket retry budgets, per-worker circuit
  breakers (half-open probes ride the gateway health loop),
  ``X-Deadline-Ms`` propagation attenuated per hop, and the shared
  Retry-After math for 429/503/504 responses.

See docs/robustness.md for the rule grammar, env knobs, drain
semantics, and the chaos-run recipe.
"""

from . import failpoints, policy  # noqa: F401
from .failpoints import (FaultAction, InjectedFault, SITES,  # noqa: F401
                         fault_point)
from .policy import (BreakerBoard, BreakerConfig, CircuitBreaker,  # noqa: F401
                     DEADLINE_HEADER, Deadline, RetryBudget, RetryPolicy,
                     backoff, backoff_delay, parse_retry_after,
                     retry_after_seconds)

__all__ = [
    "failpoints", "policy",
    "SITES", "InjectedFault", "FaultAction", "fault_point",
    "BreakerBoard", "BreakerConfig", "CircuitBreaker", "RetryBudget",
    "RetryPolicy", "Deadline", "DEADLINE_HEADER", "backoff",
    "backoff_delay", "parse_retry_after", "retry_after_seconds",
]
