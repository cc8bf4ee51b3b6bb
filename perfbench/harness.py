"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the one JSON line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix ``traffic/<mix>.json``, the module of
``drivers/`` the mix names (set-up, window and check for one kind of
call), the data generator the configuration names (``datagen/<name>.py``),
the cell's limits ``limits/<cell>.json`` and one reader per per-layer
metric (``metrics/<metric>.py``). Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package (the port's own name begins with the
# latter's, so names are compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mmlspark_tpu")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dir = os.path.join(root, self.spec["paths"][0])

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._named("configs", name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def module(self, kind: str, name: str) -> ModuleType:
        path = os.path.join(self.dir, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> ModuleType:
        """The per-layer metric's reader, ``metrics/<metric>.py``."""
        return self.module("metrics", metric)

    def metrics_of(self, kind: str, cell: str) -> List[dict]:
        """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that
        ``cell`` reports: those that list it, or that list no cells and
        move an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])}
        out = []
        for m in self.spec[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def _merge(base: dict, extra: dict) -> dict:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


class Run:
    """What one run knows: the cell, its files, and what the cell's
    ``drivers/`` module leaves for the metric readers (``layer``,
    ``trace``)."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float,
                 trace: bool, device: str, control: bool,
                 overrides: Optional[dict]):
        self.bench = bench
        self.cell = bench.cell(cell)
        self.name = cell
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.limits = bench.limits(cell)
        if overrides:
            _merge(self.config, copy.deepcopy(overrides.get("config", {})))
            _merge(self.traffic, copy.deepcopy(overrides.get("traffic", {})))
            _merge(self.limits, copy.deepcopy(overrides.get("limits", {})))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.tracing = bool(trace)
        self.device = torch.device(device)
        self.control = bool(control)
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.layer: Dict[str, Any] = {}
        self.trace = None

    def datagen(self) -> ModuleType:
        return self.bench.module("datagen", self.config["data"]["generator"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def say(self, line: str) -> None:
        """A line of the run's log on standard output, before the result."""
        print(line, flush=True)


def named(dotted: str):
    """The object a configuration names by its dotted path."""
    mod, attr = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(mod), attr)


def check(name: str, value: float, op: str, limit: float) -> dict:
    ok = {"<=": value <= limit, ">=": value >= limit,
          "==": value == limit}[op]
    return {"name": name, "value": value, "op": op, "limit": limit,
            "ok": bool(ok)}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             overrides: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """Run ``cell`` once and return its result (``None`` values never
    appear: a metric that could not be read is left out)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(bench, cell, seed, seconds, trace, device, control, overrides)
    driver = bench.module("drivers", run.traffic["driver"])
    from mmlspark_tpu_torch.observability import metrics as port_metrics
    port_metrics.set_enabled(run.tracing)
    state = driver.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    driver.window(run, state)
    run.sync()
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    if run.trace is not None:
        run.trace.finish()
    checks = driver.check(run, state)
    metrics: Dict[str, dict] = {}
    if run.tracing:
        for m in bench.metrics_of("per_layer", cell):
            v = bench.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in bench.metrics_of("end_to_end", cell):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": bool(run.attempted > 0 and run.failed == 0
                        and all(c["ok"] for c in checks)),
        "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": dev}
    if run.tracing and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": f"{c['op']} {c['limit']}"}
                        for c in checks}
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("modules of JAX or of the JAX package were loaded: "
                         + ", ".join(names))
        self.names = names


def print_result(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
