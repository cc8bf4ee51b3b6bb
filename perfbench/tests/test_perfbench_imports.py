"""Nothing a run loads is JAX or the JAX package; the reference loads
nothing of the port; a run refuses to report with either loaded, or
without the devices the cell asks for."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT, TINY

REFERENCE = os.path.join(ROOT, "perfbench", "reference")


def test_a_whole_run_loads_no_jax():
    body = ("import json, sys\n"
            "from perfbench import harness\n"
            f"ov = json.loads({json.dumps(json.dumps(TINY))!s})\n"
            "b = harness.Bench()\n"
            "for cell in ('higgs-qgrad-fit', 'higgs-score'):\n"
            "    harness.run_cell(b, cell, 5, 0.5, True, device='cpu',\n"
            "                     overrides=ov)\n"
            "print(json.dumps(sorted({m.split('.')[0]"
            " for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", body], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "mmlspark_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES), loaded


def test_names_compare_whole(monkeypatch):
    assert "mmlspark_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mmlspark_tpu_torch_extra",
                        types.ModuleType("mmlspark_tpu_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_with_jax_loaded_reports_nothing(bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(harness.ForbiddenImport):
        harness.run_cell(bench, "higgs-score", 5, 0.2, False, device="cpu",
                         overrides=TINY)


def test_reference_imports_nothing_of_the_port():
    for name in os.listdir(REFERENCE):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top in ("numpy", "torch", "perfbench", "dataclasses",
                               "typing", "__future__"), (name, m)
                assert not m.startswith("perfbench.") or m.startswith(
                    "perfbench.reference"), (name, m)


def test_run_py_without_a_card_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "higgs-qgrad-fit", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_run_py_without_the_port_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ cannot run."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "higgs-score", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
