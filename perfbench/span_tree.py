"""The port's spans as the per-layer readers find them: the trace buffer
of ``mmlspark_tpu_torch.observability.spans``, each span's parent by its
``parent_id``, each fit or scoring call by the span the pipeline layer
opens around it (``args["op"]`` ``fit`` or ``transform``).

Every function returns None where the spans are missing, misaligned with
the run's calls, or were dropped from the buffer: a program without these
spans (an older commit) reads as nothing, never as a number."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


class Spans:
    """The completed spans of one run, indexed by id and by parent."""

    def __init__(self, events: List[dict]):
        self.events = sorted((e for e in events if e.get("ph") == "X"),
                             key=lambda e: e["ts"])
        self.children: Dict[object, List[dict]] = defaultdict(list)
        for e in self.events:
            pid = e.get("args", {}).get("parent_id")
            if pid is not None:
                self.children[pid].append(e)

    def stage_calls(self, op: str) -> List[dict]:
        """The pipeline layer's spans of ``op`` (``fit``, ``transform``),
        oldest first."""
        return [e for e in self.events
                if e.get("args", {}).get("op") == op
                and "span_id" in e["args"]]

    def below(self, span: dict, name: str) -> List[dict]:
        """The spans named ``name`` anywhere below ``span``."""
        out, todo = [], [span["args"]["span_id"]]
        while todo:
            for c in self.children.get(todo.pop(), []):
                if c["name"] == name:
                    out.append(c)
                if "span_id" in c["args"]:
                    todo.append(c["args"]["span_id"])
        return out

    def seconds(self, span: dict, name: str) -> float:
        """Host seconds of the spans named ``name`` below ``span``."""
        return sum(e["dur"] for e in self.below(span, name)) / 1e6


def read_spans() -> Optional[Spans]:
    """The port's buffered spans, or None where the buffer dropped any."""
    from mmlspark_tpu_torch.observability import spans
    if spans.dropped_events():
        return None
    return Spans(spans.get_trace_events())


def fit_calls(run, spans: Optional[Spans] = None) -> Optional[List[tuple]]:
    """``(spans, fit span, fit)`` for each fit of ``run.layer["fits"]``, the
    last that many pipeline fit spans in order, each holding one
    ``gbdt.boost`` span with as many trees as that fit's booster; None
    where they do not line up."""
    spans = spans or read_spans()
    fits = run.layer.get("fits") or []
    if spans is None or not fits:
        return None
    calls = spans.stage_calls("fit")[-len(fits):]
    if len(calls) != len(fits):
        return None
    for call, fit in zip(calls, fits):
        boost = spans.below(call, "gbdt.boost")
        if (len(boost) != 1
                or boost[0]["args"].get("trees") != fit["booster"].num_trees):
            return None
    return [(spans, call, fit) for call, fit in zip(calls, fits)]


def window_fits(run) -> Optional[List[tuple]]:
    """:func:`fit_calls` without the first fit, which a traced run profiles
    before its window (the first alone where it is the only one)."""
    calls = fit_calls(run)
    return None if calls is None else calls[1:] or calls


def trees(calls: List[tuple]) -> int:
    return sum(fit["booster"].num_trees for _, _, fit in calls)


def device_ms_per_tree(run, name: str) -> Optional[float]:
    """Device milliseconds of the spans named ``name`` in the window's fits
    over their trees; None where any of them has no device time (the
    CPU)."""
    calls = window_fits(run)
    if not calls or not trees(calls):
        return None
    total = 0.0
    for spans, call, _ in calls:
        found = spans.below(call, name)
        if not found or any("device_ms" not in e["args"] for e in found):
            return None
        total += sum(e["args"]["device_ms"] for e in found)
    return total / trees(calls)
