"""The PyTorch port stands alone and never falls back.

  * Importing every module of ``mmlspark_tpu_torch`` (in a fresh
    interpreter) leaves ``jax`` and every ``mmlspark_tpu`` module out of
    ``sys.modules``; no source of the package, nor ``chip_smoke.py`` or
    the GPU tools (``tools/profile_torch_gbdt.py``,
    ``tools/ab_node_hist.py``, ``tools/node_hist_sweeps.py``), imports
    either.
  * The device resolver raises when ``cuda`` is asked for (or defaulted to)
    and no GPU is present; entry points that default to ``cuda`` raise with
    it instead of moving to the CPU.
  * The kernel build raises when ``nvcc`` is missing, and the kernel
    wrapper refuses inputs the kernel does not take.
  * The port's test files lint clean under ``tools.graftlint``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch
from mmlspark_tpu_torch import device as devmod
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import Booster, train_booster
from mmlspark_tpu_torch.ops import _build
from mmlspark_tpu_torch.ops import histogram as TH

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(mmlspark_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "mmlspark_tpu")


def _package_modules():
    mods = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      os.path.dirname(PKG))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    mods = _package_modules()
    assert "mmlspark_tpu_torch.models.gbdt.growth" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'mmlspark_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'mmlspark_tpu.')))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_torch_gbdt.py"),
             os.path.join(ROOT, "tools", "ab_node_hist.py"),
             os.path.join(ROOT, "tools", "node_hist_sweeps.py")]
    for dirpath, _, filenames in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    assert all(os.path.isfile(p) for p in paths[:4])
    bad = [(os.path.relpath(p, ROOT), line, name) for p in paths
           for line, name in _imports(p) if _forbidden(name)]
    assert bad == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("request_", [None, "cuda", "cuda:0",
                                      torch.device("cuda")])
def test_resolver_raises_without_gpu(no_gpu, request_):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        devmod.resolve_device(request_)


def test_resolver_honours_cpu_and_refuses_others():
    assert devmod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devmod.resolve_device("meta")


def test_entry_points_default_to_cuda_and_raise(no_gpu):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_booster(X, y, objective="binary", num_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LightGBMClassifier(numIterations=1).fit(
            Dataset({"features": X, "label": y}))
    b = train_booster(X, y, objective="binary", num_iterations=1,
                      device="cpu")
    assert isinstance(b, Booster)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        b.predict_raw(X)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    n = 16
    pos = torch.zeros(n, dtype=torch.int32)
    base = torch.zeros(3, n)
    with pytest.raises(TypeError, match="int32, int16 or uint8"):
        TH._node_hist_cuda(torch.zeros(2, n), pos, base, 1, 4)
    with pytest.raises(TypeError, match="row_pos"):
        TH._node_hist_cuda(torch.zeros(2, n, dtype=torch.int32),
                           pos.long(), base, 1, 4)
    with pytest.raises(TypeError, match="base_t"):
        TH._node_hist_cuda(torch.zeros(2, n, dtype=torch.int32), pos,
                           base.double(), 1, 4)
    with pytest.raises(ValueError, match="shared memory"):
        TH._node_hist_cuda(torch.zeros(2, n, dtype=torch.int32), pos,
                           base, 1, 20_000)
    with pytest.raises(ValueError, match="unsupported device"):
        TH.node_histogram(torch.zeros(2, n, dtype=torch.int32,
                                      device="meta"), pos, base, 1, 4)


def test_int8_and_cols_wrappers_refuse_what_their_kernels_do_not_take():
    n = 16
    binned = torch.zeros(2, n, dtype=torch.int32)
    pos = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(TypeError, match="base_t must be torch.int8"):
        TH._node_hist_int8_cuda(binned, pos, torch.zeros(3, n), 1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        TH._node_hist_int8_cuda(binned, pos, torch.zeros(
            n, 3, dtype=torch.int8).t(), 1, 4)
    with pytest.raises(TypeError, match="stats_t must be float32"):
        TH._hist_cuda(binned, torch.zeros(2, n, dtype=torch.float16), 4,
                      torch.bfloat16)
    with pytest.raises(TypeError, match="stats_t must be"):
        TH._hist_cuda(binned, torch.zeros(2, n + 1), 4, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        TH._hist_cuda(binned, torch.zeros(2, n), 60_000, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        TH.histogram_cols(torch.zeros(2, n, dtype=torch.int32,
                                      device="meta"), torch.zeros(2, n), 4)


def test_int8_wrapper_refuses_stats_that_could_overflow_int32():
    """Past 2^24 rows a full int8 range could overflow a cell: the stats
    must then stay within quant_q_max(n)."""
    n = 2 ** 24 + 1
    binned = torch.zeros(1, n, dtype=torch.uint8)
    pos = torch.zeros(n, dtype=torch.int32)
    base = torch.zeros(3, n, dtype=torch.int8)
    base[0, 0] = -128
    with pytest.raises(ValueError, match="overflow"):
        TH._node_hist_int8_cuda(binned, pos, base, 1, 4)


def test_port_tests_lint_clean():
    sys.path.insert(0, ROOT)
    try:
        from tools.graftlint import core
    finally:
        sys.path.remove(ROOT)
    active, _ = core.run(core.Repo(ROOT))
    mine = [f for f in active if f.path.startswith("tests/test_torch_")]
    assert mine == []
