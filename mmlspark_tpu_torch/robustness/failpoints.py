"""Seeded, rule-driven fault injection: named failpoints for chaos runs.

The reference survives executor crashes by construction (history-queue
requeue, web-service retry schedules) but never *proves* it: there is no
way to make an executor fail on demand. This module is that switch for
the rebuild — chaos runs become deterministic, replayable inputs
instead of hardware folklore, the way a fleet that rolls and fails
continuously has to be tested.

One env var drives everything::

    MMLSPARK_TPU_FAILPOINTS="gateway.route:error_503:0.2,gbdt.round:exit@5"

Grammar (comma-separated rules)::

    rule := site ":" kind [":" arg] ["@" N]

    kind = "error_<status>"  synthetic HTTP failure returned at the site
                             (arg = fire probability, default 1.0;
                             status 0 = connection failure for http.send)
         | "error"           raise InjectedFault at the site
                             (arg = fire probability)
         | "delay"           added latency; arg REQUIRED: "250ms", "1.5s",
                             or a plain number of milliseconds (an extra
                             ":p" field sets a fire probability)
         | "exit"            os._exit at the site — the preemption
                             simulation; no cleanup handlers run, exactly
                             like a real SIGKILL (arg = status, default 17)
    @N   = fire ONLY on the Nth evaluation of the site (1-based; the
           site's hit counter is process-wide), so "kill the fit at
           round 5" or "fail only the first forward" replay exactly

Sites are a closed set (:data:`SITES`): a typo'd site fails loudly at
:func:`configure` time instead of silently never firing, and graftlint's
``failpoint-site-grammar`` rule pins every call-site literal to the same
set.

Determinism: every rule owns a :class:`random.Random` seeded from
``MMLSPARK_TPU_FAILPOINTS_SEED`` (default 0) plus the rule's position,
site, and kind — string seeding hashes via sha512, stable across
processes and ``PYTHONHASHSEED``, so the same spec and seed replay the
same fire pattern and a chaos run that found a bug is a regression
test, not an anecdote.

Kill-switch contract (the telemetry idiom): with no rules configured,
:func:`fault_point` is one falsy check and the instrumented paths are
byte-identical to the uninstrumented build. Every fired fault is
recorded as a ``failpoint`` flight event and counted in
``failpoints_fired_total{site,kind}`` BEFORE its effect, so the ring
replays the chaos sequence even when the effect kills the thread (or,
for ``exit``, the process).
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..observability import flight as _flight
from ..observability import metrics as _metrics

__all__ = [
    "SITES", "InjectedFault", "FaultAction", "Rule",
    "configure", "clear", "active", "ensure_configured", "rules",
    "hit_count", "fault_point",
    "FAILPOINTS_ENV", "SEED_ENV",
]

FAILPOINTS_ENV = "MMLSPARK_TPU_FAILPOINTS"
SEED_ENV = "MMLSPARK_TPU_FAILPOINTS_SEED"

_SITE_RE = re.compile(r"^[a-z_.]+$")

#: The registered injection sites — the closed set a rule may name,
#: spanning the edge→gateway→worker request path, training rounds,
#: streaming, and barriers. Wiring lives next to the code it perturbs;
#: descriptions here are the single source for docs/robustness.md.
SITES: Dict[str, str] = {
    "serving.handle": "worker HTTP handler, before a request is admitted "
                      "to the batch queue (io/serving.py)",
    "serving.batch": "ServingQuery micro-batch loop, before the transform "
                     "runs — `error` rides the requeue-once recovery path "
                     "(io/serving.py)",
    "gateway.route": "gateway worker hop: the picked worker's reply is "
                     "replaced, delayed, or crashed before any bytes hit "
                     "the wire (io/distributed_serving.py)",
    "gateway.probe": "gateway health-loop probe of a half-open worker "
                     "(io/distributed_serving.py)",
    "http.send": "outbound HTTP-on-X exchange in send_request "
                 "(io/http.py)",
    "gbdt.round": "GBDT host round loop, top of each boosting round — "
                  "`exit` is the mid-fit preemption drill the resume "
                  "path is tested against (models/gbdt/booster.py)",
    "checkpoint.write": "CheckpointManager.save, between the payload "
                        "write and the atomic publish — a torn-write "
                        "crash (utils/checkpoint.py)",
    "prefetch.chunk": "streaming prefetch, at the consumer's yield point "
                      "— a failing or slow chunk load (io/prefetch.py)",
    "barrier.wait": "distributed barrier: a peer stuck (delay) or lost "
                    "(error) at the rendezvous (parallel/distributed.py)",
}


class InjectedFault(RuntimeError):
    """Raised by ``error`` rules — deliberately a plain RuntimeError
    subclass so it rides the same recovery paths a real crash would."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"failpoint {site!r} fired (hit {hit})")
        self.site = site
        self.hit = hit


@dataclass(frozen=True)
class FaultAction:
    """What a fired, non-raising rule did at the call site."""

    site: str
    kind: str                      # "error_503" / "delay"
    status: Optional[int]          # set for error_<status> rules
    delay_s: float                 # set (and already slept) for delay
    rule: str                      # the spec text, for forensics


class Rule:
    """One parsed fault rule with its own deterministic RNG + @N pin."""

    __slots__ = ("site", "kind", "status", "delay_s", "exit_code", "p",
                 "at", "fired", "spec", "_rng")

    def __init__(self, site: str, kind: str, status: Optional[int],
                 delay_s: float, exit_code: int, p: float,
                 at: Optional[int], spec: str, seed: Any, index: int):
        self.site = site
        self.kind = kind               # "error" | "error_status" | "delay" | "exit"
        self.status = status
        self.delay_s = delay_s
        self.exit_code = exit_code
        self.p = p
        self.at = at
        self.fired = 0
        self.spec = spec
        self._rng = random.Random(f"{seed}|{index}|{site}|{kind}")

    @property
    def kind_label(self) -> str:
        return (f"error_{self.status}" if self.kind == "error_status"
                else self.kind)

    def try_fire(self, hit: int) -> bool:
        """One draw; caller holds the module lock (the RNG is not
        thread-safe and the @N pin must not race). An @N pin and a
        probability compose as the grammar documents ([:arg][@N]):
        the draw happens only at the pinned hit."""
        if self.at is not None and hit != self.at:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def describe(self) -> Dict[str, Any]:
        return {"site": self.site, "kind": self.kind_label,
                "delay_s": self.delay_s, "p": self.p, "at": self.at,
                "fired": self.fired, "spec": self.spec}


def _parse_prob(tok: str, part: str) -> float:
    try:
        p = float(tok)
    except ValueError:
        raise ValueError(f"failpoint rule {part!r}: bad probability "
                         f"{tok!r}") from None
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"failpoint rule {part!r}: probability {p} "
                         "outside [0, 1]")
    return p


def _parse_duration(tok: str, part: str) -> float:
    try:
        if tok.endswith("ms"):
            return float(tok[:-2]) / 1000.0
        if tok.endswith("s"):
            return float(tok[:-1])
        return float(tok) / 1000.0     # bare number = milliseconds
    except ValueError:
        raise ValueError(f"failpoint rule {part!r}: bad duration "
                         f"{tok!r} (want 250ms / 1.5s / plain ms)") from None


def _parse_rule(part: str, seed: Any, index: int) -> Rule:
    at: Optional[int] = None
    body = part
    if "@" in body:
        body, at_s = body.rsplit("@", 1)
        try:
            at = int(at_s)
        except ValueError:
            raise ValueError(f"failpoint rule {part!r}: @N must be an "
                             f"integer, got {at_s!r}") from None
        if at < 1:
            raise ValueError(f"failpoint rule {part!r}: @N is 1-based")
    fields = [f.strip() for f in body.split(":")]
    if len(fields) < 2 or not fields[0] or not fields[1]:
        raise ValueError(
            f"failpoint rule {part!r}: expected site:kind[:arg][@N]")
    site, kindf = fields[0], fields[1]
    if not _SITE_RE.match(site):
        raise ValueError(f"failpoint site {site!r} must match [a-z_.]+")
    if site not in SITES:
        raise ValueError(f"failpoint rule {part!r}: unknown site {site!r} "
                         f"(registered: {sorted(SITES)})")
    arg = fields[2] if len(fields) > 2 else None
    status: Optional[int] = None
    delay_s, exit_code, p = 0.0, 17, 1.0
    if kindf.startswith("error_"):
        kind = "error_status"
        try:
            status = int(kindf[len("error_"):])
        except ValueError:
            raise ValueError(f"failpoint rule {part!r}: bad status in "
                             f"{kindf!r}") from None
        if not 0 <= status <= 599:
            raise ValueError(f"failpoint rule {part!r}: status {status} "
                             "out of range (0..599; 0 = connection "
                             "failure for http.send)")
        if arg is not None:
            p = _parse_prob(arg, part)
    elif kindf == "error":
        kind = "error"
        if arg is not None:
            p = _parse_prob(arg, part)
    elif kindf == "delay":
        kind = "delay"
        if arg is None:
            raise ValueError(f"failpoint rule {part!r}: delay needs a "
                             "duration (site:delay:250ms)")
        delay_s = _parse_duration(arg, part)
        if delay_s <= 0:
            raise ValueError(f"failpoint rule {part!r}: delay must be "
                             "positive")
        if len(fields) > 3:
            p = _parse_prob(fields[3], part)
    elif kindf == "exit":
        kind = "exit"
        if arg is not None:
            try:
                exit_code = int(arg)
            except ValueError:
                raise ValueError(f"failpoint rule {part!r}: bad exit "
                                 f"code {arg!r}") from None
    else:
        raise ValueError(f"failpoint rule {part!r}: unknown kind "
                         f"{kindf!r} (error_<status> | error | delay | "
                         "exit)")
    return Rule(site, kind, status, delay_s, exit_code, p, at, part,
                seed, index)


def parse_spec(spec: str, seed: Any = 0) -> Tuple[Rule, ...]:
    """Parse a ``MMLSPARK_TPU_FAILPOINTS`` spec; raises ValueError on
    unknown sites/kinds or malformed fields (a chaos config must never
    be silently half-applied)."""
    out = []
    for index, part in enumerate(p.strip() for p in spec.split(",")):
        if not part:
            continue
        out.append(_parse_rule(part, seed, index))
    return tuple(out)


# ---------------------------------------------------------------------------
# Module state: None = env not read yet; () = loaded, no rules (the
# byte-identical fast path is then one falsy check per fault_point call)
# ---------------------------------------------------------------------------

_rules: Optional[Tuple[Rule, ...]] = None
_hits: Dict[str, int] = {}
_lock = threading.Lock()


def configure(spec: Optional[str] = None,
              seed: Optional[Any] = None) -> Tuple[Rule, ...]:
    """Install a rule set (``spec=None`` reads ``MMLSPARK_TPU_FAILPOINTS``);
    returns the parsed rules and resets every site's hit counter. Seed
    defaults to ``MMLSPARK_TPU_FAILPOINTS_SEED`` (or 0)."""
    global _rules
    if spec is None:
        spec = os.environ.get(FAILPOINTS_ENV, "")
    if seed is None:
        seed = os.environ.get(SEED_ENV, "") or 0
    parsed = parse_spec(spec, seed)
    with _lock:
        _rules = parsed
        _hits.clear()
    return parsed


def clear() -> None:
    """Drop every rule (tests); fault points go back to the no-op path."""
    global _rules
    with _lock:
        _rules = ()
        _hits.clear()


def active() -> bool:
    return bool(_rules)


def ensure_configured() -> bool:
    """Load the env spec if this process hasn't yet; True when any
    rules are installed. The async serving plane gates its off-loop
    fault evaluation on this — a ``delay`` rule sleeps inside
    :func:`fault_point`, which must never run ON the event loop (one
    injected delay there would stall every in-flight connection, not
    the one request chaos meant to slow)."""
    if _rules is None:
        configure()
    return bool(_rules)


def rules() -> Tuple[Rule, ...]:
    return _rules or ()


def hit_count(site: str) -> int:
    """Evaluations of ``site`` since configure() (0 when never hit)."""
    with _lock:
        return _hits.get(site, 0)


def fault_point(site: str, **ctx: Any) -> Optional[FaultAction]:
    """The one call a production site makes. No rules configured: returns
    None after a single check, touching nothing (the byte-identity
    contract). With matching rules: ``delay`` sleeps here (call sites
    stay one-liners), ``error_<status>`` returns a :class:`FaultAction`
    whose ``status`` the site turns into a synthetic failure, ``error``
    raises :class:`InjectedFault`, and ``exit`` hard-kills the process.
    Every fired rule is counted and flight-logged before its effect, so
    the ring replays the chaos sequence even when the effect kills the
    thread."""
    rules_now = _rules
    if rules_now is None:
        configure()
        rules_now = _rules or ()
    if not rules_now:
        return None
    site_rules = [r for r in rules_now if r.site == site]
    if not site_rules:
        return None
    with _lock:
        hit = _hits.get(site, 0) + 1
        _hits[site] = hit
        fired = [r for r in site_rules if r.try_fire(hit)]
    action: Optional[FaultAction] = None
    for rule in fired:
        _metrics.safe_counter("failpoints_fired_total", site=site,
                              kind=rule.kind_label).inc()
        _flight.record("failpoint", site=site, fault=rule.kind_label,
                       rule=rule.spec, hit=hit, **ctx)
        if rule.kind == "exit":
            os._exit(rule.exit_code)
        if rule.kind == "error":
            raise InjectedFault(site, hit)
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            if action is None:
                action = FaultAction(site, "delay", None, rule.delay_s,
                                     rule.spec)
        else:
            # error_<status> is terminal for this site: first one wins
            return FaultAction(site, rule.kind_label, rule.status, 0.0,
                               rule.spec)
    return action
