"""The port's robustness modules against the JAX package's.

``failpoints``: the same spec parsing (and the same refusals), the same
fire pattern for a seeded spec, the same actions, counters and flight
events. ``policy``: the same ``Ewma``, ``Deadline`` and Retry-After
arithmetic, the same seeded backoff draws, the same retry-budget and
circuit-breaker state sequences under one scripted clock.
"""

import random
from types import SimpleNamespace

import pytest
import torch

from mmlspark_tpu.observability import flight as jflight
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.robustness import failpoints as jfp
from mmlspark_tpu.robustness import policy as jpol
from mmlspark_tpu_torch.observability import flight as pflight
from mmlspark_tpu_torch.observability import metrics as pmetrics
from mmlspark_tpu_torch.robustness import failpoints as pfp
from mmlspark_tpu_torch.robustness import policy as ppol

torch.set_num_threads(1)

PKGS = ((jfp, jpol, jmetrics, jflight), (pfp, ppol, pmetrics, pflight))


@pytest.fixture(autouse=True)
def _clean():
    prev = [m.set_enabled(True) for _, _, m, _ in PKGS]
    for fp, _, m, f in PKGS:
        fp.clear()
        m.reset()
        f.clear()
    yield
    for (fp, _, m, f), was in zip(PKGS, prev):
        fp.clear()
        m.reset()
        f.clear()
        m.set_enabled(was)


def _events(flight):
    """The ring without clock and thread fields, log events under the
    package-neutral logger name (each package names its own loggers)."""
    out = []
    for e in flight.events():
        e = {k: v for k, v in e.items() if k not in ("ts", "tid")}
        if "logger" in e:
            e["logger"] = e["logger"].replace("mmlspark_tpu_torch.",
                                              "mmlspark_tpu.")
        out.append(e)
    return out


# -- failpoints ----------------------------------------------------------------

SPECS = [
    "serving.handle:error_503@1",
    "serving.batch:error",
    "gateway.route:error_503:0.3,serving.batch:error:0.5@2",
    "http.send:error_0:0.25",
    "prefetch.chunk:delay:250ms,prefetch.chunk:delay:1.5s:0.5",
    "gbdt.round:exit@5",
    "checkpoint.write:exit:3",
    " serving.handle:delay:40 , barrier.wait:error@3 ",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, "7"])
def test_failpoint_spec_parsing_matches(spec, seed):
    got = [[r.describe() for r in fp.parse_spec(spec, seed)]
           for fp in (jfp, pfp)]
    assert got[0] == got[1]


BAD_SPECS = ["serving.nope:error", "serving.batch:explode",
             "serving.batch:error:2.0", "serving.batch:delay",
             "serving.batch:delay:soon", "serving.batch:error@0",
             "serving.batch", "Serving.batch:error"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_failpoint_spec_refusals_match(spec):
    errs = []
    for fp in (jfp, pfp):
        with pytest.raises(ValueError) as e:
            fp.parse_spec(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _drive(fp, site, n):
    out = []
    for _ in range(n):
        try:
            act = fp.fault_point(site, api="a")
        except fp.InjectedFault as e:
            out.append(("raise", e.site, e.hit))
        else:
            out.append(None if act is None else
                       (act.kind, act.status, act.delay_s, act.rule))
    return out


@pytest.mark.parametrize("spec,site", [
    ("serving.handle:error_503@2", "serving.handle"),
    ("serving.batch:error@1", "serving.batch"),
    ("gateway.route:error_503:0.3", "gateway.route"),
    ("serving.batch:error:0.5,serving.handle:error_429", "serving.batch"),
    ("prefetch.chunk:delay:5ms:0.5,prefetch.chunk:error_500@4",
     "prefetch.chunk"),
])
@pytest.mark.parametrize("seed", [0, 11])
def test_failpoint_actions_match(monkeypatch, spec, site, seed):
    slept = []
    results = []
    for fp, _, m, f in PKGS:
        monkeypatch.setattr(fp, "time", SimpleNamespace(sleep=slept.append))
        fp.configure(spec, seed=seed)
        outs = _drive(fp, site, 12)
        results.append((outs, fp.hit_count(site),
                        [r.describe() for r in fp.rules()],
                        m.get_registry().snapshot().get(
                            "failpoints_fired_total"),
                        _events(f)))
    assert results[0] == results[1]
    assert slept[:len(slept) // 2] == slept[len(slept) // 2:]


def test_failpoints_off_is_a_no_op(monkeypatch):
    for fp, _, m, f in PKGS:
        monkeypatch.delenv("MMLSPARK_TPU_FAILPOINTS", raising=False)
        fp.configure()
        assert fp.fault_point("serving.batch") is None
        assert not fp.active() and not fp.ensure_configured()
        assert m.get_registry().snapshot() == {}
    assert pfp.SITES == jfp.SITES


def test_failpoints_read_the_env(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_FAILPOINTS",
                       "serving.handle:error_503:0.5")
    monkeypatch.setenv("MMLSPARK_TPU_FAILPOINTS_SEED", "3")
    outs = []
    for fp, _, _, _ in PKGS:
        fp.configure()
        outs.append(_drive(fp, "serving.handle", 10))
    assert outs[0] == outs[1]
    assert any(o is not None for o in outs[0])


# -- policy ---------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("alpha", [0.2, 0.5, 1.0])
def test_ewma_sequences_match(alpha):
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.6]
    seqs = []
    for _, pol, _, _ in PKGS:
        e = pol.Ewma(alpha)
        seqs.append([None if e.value is None else e.value]
                    + [e.update(x) for x in xs])
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("est", [None, 0.0, 0.2, 1.0, 1.01, 17.3, 59.9,
                                 61.0, 1e9])
def test_retry_after_seconds_match(est):
    assert (ppol.retry_after_seconds(est)
            == jpol.retry_after_seconds(est))
    assert (ppol.retry_after_seconds(est, floor=0.5, cap=10.0)
            == jpol.retry_after_seconds(est, floor=0.5, cap=10.0))


@pytest.mark.parametrize("value", ["120", "0", "-3", "1.5", "31",
                                   "Wed, 21 Oct 2015 07:28:00 GMT",
                                   "Wed, 21 Oct 2015 07:28:40 GMT",
                                   "garbage", "", None])
def test_parse_retry_after_matches(value):
    now = 1445412480.0          # 2015-10-21 07:28:00 UTC
    assert (ppol.parse_retry_after(value, now=now)
            == jpol.parse_retry_after(value, now=now))


def test_deadline_sequences_match():
    seqs = []
    for _, pol, _, _ in PKGS:
        clock = Clock()
        d = pol.Deadline.from_headers({"x-deadline-ms": "250"}, clock)
        out = [d.remaining_ms(), d.header_value(5), d.expired,
               d.clamp(1.0)]
        clock.t += 0.2
        out += [d.remaining_seconds(), d.header_value(5), d.expired,
                d.clamp(0.01)]
        clock.t += 0.06
        out += [d.remaining_ms(), d.header_value(5), d.expired]
        out += [pol.Deadline.from_headers({pol.DEADLINE_HEADER: "x"}, clock),
                pol.Deadline.from_headers(None, clock),
                pol.Deadline.from_headers({}, clock)]
        seqs.append(out)
    assert seqs[0] == seqs[1]
    assert ppol.DEADLINE_HEADER == jpol.DEADLINE_HEADER


@pytest.mark.parametrize("kw", [dict(), dict(schedule_ms=[10, 20, 40]),
                                dict(base_ms=5.0, cap_ms=30.0),
                                dict(retry_after="2")])
def test_backoff_draws_match(kw):
    draws = []
    for _, pol, _, _ in PKGS:
        rng = random.Random(1234)
        draws.append([pol.backoff_delay(a, rng=rng, **kw)
                      for a in range(6)])
    assert draws[0] == draws[1]


def test_retry_policy_and_budget_match():
    outs = []
    for _, pol, m, f in PKGS:
        budget = pol.RetryBudget(ratio=0.5, min_tokens=2, cap=3,
                                 api="a")
        policy = pol.RetryPolicy(max_attempts=4, base_ms=10, max_ms=40,
                                 budget=budget, rng=random.Random(5))
        seq = []
        for attempt in range(5):
            seq.append(policy.should_retry(attempt))
            seq.append(budget.tokens)
        for _ in range(5):
            budget.deposit()
        seq.append(budget.tokens)
        slept = []
        seq.append(policy.sleep_before(1, sleep=slept.append))
        seq.append(slept)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("down")
            return "ok"

        pol_fast = pol.RetryPolicy(max_attempts=4, base_ms=0, max_ms=0)
        seq.append((pol_fast.run(flaky), len(calls)))
        outs.append((seq, m.get_registry().snapshot(), _events(f)))
    assert outs[0] == outs[1]


BREAKER_SCRIPT = [
    ("failure", False), ("failure", False), ("success", None),
    ("failure", False), ("failure", False), ("failure", False),
    ("advance", 4.0), ("begin_probe", None), ("advance", 2.0),
    ("begin_probe", None), ("failure", False), ("probe_failure", None),
    ("advance", 5.0), ("begin_probe", None), ("probe_success", None),
    ("failure", True), ("advance", 5.0), ("begin_probe", None),
    ("probe_success", None), ("probe_success", None),
] + [("failure", False), ("success", None)] * 6


@pytest.mark.parametrize("cfg", [
    dict(consecutive_failures=3, open_seconds=5.0),
    dict(consecutive_failures=50, error_rate=0.4, window=8, min_volume=6,
         open_seconds=5.0, half_open_successes=2),
])
def test_breaker_state_sequences_match(cfg):
    outs = []
    for _, pol, m, f in PKGS:
        clock = Clock()
        board = pol.BreakerBoard(pol.BreakerConfig(**cfg), clock=clock)
        b = board.breaker("localhost:8900")
        states = []
        for op, arg in BREAKER_SCRIPT:
            if op == "advance":
                clock.t += arg
            elif op == "failure":
                b.record_failure(hard=arg)
            elif op == "success":
                b.record_success()
            else:
                states.append(getattr(b, op)())
            states.append((b.state, b.allow(), b.probe_due(),
                           b.describe()))
        states.append((board.states(), board.allow("localhost:8900"),
                       board.allow("other:1")))
        outs.append((states, m.get_registry().snapshot(), _events(f)))
    assert outs[0] == outs[1]
    assert any(s[0] == "open" for s in outs[0][0] if isinstance(s, tuple)
               and len(s) == 4)


def test_breaker_config_reads_the_env(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_BREAKER_CONSECUTIVE", "2")
    monkeypatch.setenv("MMLSPARK_TPU_BREAKER_OPEN_SECONDS", "1.5")
    monkeypatch.setenv("MMLSPARK_TPU_BREAKER_HALF_OPEN_SUCCESSES", "3")
    cfgs = [vars(pol.BreakerConfig()) for _, pol, _, _ in PKGS]
    assert cfgs[0] == cfgs[1]
    assert cfgs[0]["consecutive_failures"] == 2
