"""Accuracy-regression harness: checked-in metric baselines with tolerances.

Counterpart of ``mmlspark_tpu/core/benchmarks.py``: the reference's benchmark
system (reference:
core/test/benchmarks/Benchmarks.scala:16-60+ — each suite records metric
values to a CSV, compares them against a checked-in baseline file with
per-metric precision, fails on mismatch, and writes a ``new_benchmarks`` file
so an intentional change can be promoted by copying it over the baseline).

CSV format (one metric per line): ``name,value,precision``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class BenchmarkEntry:
    name: str
    value: float
    precision: float


@dataclass
class Benchmarks:
    """Collect metrics, then verify against (or regenerate) a baseline CSV."""

    suite: str
    entries: List[BenchmarkEntry] = field(default_factory=list)

    def record(self, name: str, value: float, precision: float = 1e-5) -> None:
        self.entries.append(BenchmarkEntry(name, float(value),
                                           float(precision)))

    # -- files -------------------------------------------------------------
    @property
    def filename(self) -> str:
        return f"benchmarks_{self.suite}.csv"

    def write(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self.filename)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for e in self.entries:
                w.writerow([e.name, repr(e.value), repr(e.precision)])
        return path

    @staticmethod
    def read(path: str) -> Dict[str, BenchmarkEntry]:
        out: Dict[str, BenchmarkEntry] = {}
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                name, value, precision = row[0], float(row[1]), float(row[2])
                out[name] = BenchmarkEntry(name, value, precision)
        return out

    # -- verification ------------------------------------------------------
    def verify(self, baseline_dir: str,
               new_dir_name: str = "new_benchmarks") -> None:
        """Compare recorded metrics to the checked-in baseline. On any
        mismatch (or a missing baseline), write the would-be baseline to
        ``<baseline_dir>/new_benchmarks/`` and raise AssertionError with a
        per-metric report (reference: Benchmarks.scala compare-and-promote
        flow)."""
        baseline_path = os.path.join(baseline_dir, self.filename)
        new_dir = os.path.join(baseline_dir, new_dir_name)
        if not os.path.exists(baseline_path):
            path = self.write(new_dir)
            raise AssertionError(
                f"no baseline {baseline_path}; wrote candidate to {path} — "
                "inspect and copy it into the baseline directory to promote")
        baseline = self.read(baseline_path)
        problems = []
        seen = set()
        for e in self.entries:
            seen.add(e.name)
            ref = baseline.get(e.name)
            if ref is None:
                problems.append(f"metric {e.name!r} missing from baseline "
                                f"(got {e.value})")
            elif abs(e.value - ref.value) > ref.precision:
                problems.append(
                    f"metric {e.name!r}: got {e.value}, baseline {ref.value} "
                    f"(tolerance {ref.precision})")
        for name in baseline:
            if name not in seen:
                problems.append(f"baseline metric {name!r} was not recorded")
        if problems:
            path = self.write(new_dir)
            raise AssertionError(
                "benchmark regression vs {}:\n  {}\n(candidate written to {})"
                .format(baseline_path, "\n  ".join(problems), path))
