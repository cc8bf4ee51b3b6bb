"""The PyTorch port stands alone and never falls back.

  * Importing every module of ``mmlspark_tpu_torch`` (in a fresh
    interpreter) leaves ``jax`` and every ``mmlspark_tpu`` module out of
    ``sys.modules``, and so does importing each serving entry module alone
    (which also starts no CUDA context); no source of the package, nor ``chip_smoke.py`` or
    the port's tools (``tools/profile_torch_gbdt.py``,
    ``tools/ab_node_hist.py``, ``tools/node_hist_sweeps.py``,
    ``tools/rehearse_chip_smoke.py``, ``tools/ab_predict.py``,
    ``tools/multi_card_fit.py``, ``tools/chip_phase15.py``,
    ``tools/chip_phase16.py``, ``tools/chip_phase17.py``,
    ``tools/chip_phase18.py``, ``tools/chip_phase19.py``,
    ``tools/chip_phase20.py``, ``tools/chip_phase21.py``,
    ``tools/dnn_tolerances.py``), imports either; nor does the port's copy
    of the JAX package's random streams, ``utils/prng.py``.
  * The device resolver raises when ``cuda`` is asked for (or defaulted to)
    and no GPU is present; entry points that default to ``cuda`` raise with
    it instead of moving to the CPU.
  * The kernel build raises when ``nvcc`` is missing, and the kernel
    wrapper refuses inputs the kernel does not take; the murmur hash
    raises when the native host library cannot be built, instead of
    hashing in Python.
  * The VW learners' entry points (``VowpalWabbitClassifier.fit``,
    ``VowpalWabbitContextualBandit.fit``, ``predict_sgd``) default to
    ``cuda`` and raise without a GPU; they run with ``device="cpu"``.
  * The estimators of slice 14 (``IsolationForest``, ``KNN``,
    ``ConditionalKNN``, ``SAR``, ``AccessAnomaly``), their models and
    ``als_fit`` default to ``cuda`` and raise without a GPU; they run with
    ``device="cpu"``.
  * The stages of slice 15 with device work (``ImageTransformer``,
    ``ResizeImageTransformer``, ``DNNModel``, ``ImageFeaturizer``) and
    ``resize_image``/``blur_image`` default to ``cuda`` and raise without a
    GPU; they run with ``device="cpu"``.
  * The automl entry points (``TuneHyperparameters``, ``FindBestModel``
    and the sweep) fit on their estimators' device: ``cuda`` by default,
    raising without a GPU; they run with ``device="cpu"``.
  * The random streams' draws (``prng.bits``, ``uniform``, ``normal``) and
    ``booster._row_uniforms`` default to ``cuda`` and raise without a GPU;
    key derivation (``prng_key``, ``fold_in``, ``split``) needs no device.
  * The transformer's entry points (``init_params``, ``shard_params``,
    ``shard_opt_state``, ``make_train_step``, ``make_forward``,
    ``transformer_params_from_jax``) default to ``cuda`` and raise without
    a GPU; they run with ``device="cpu"``. So does a stage fitted through
    the port's generated ``mmlspark`` namespace, until ``setDevice("cpu")``.
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


#: the serving stack and the host modules it stands on
SERVING_MODULES = (
    "mmlspark_tpu_torch.observability",
    "mmlspark_tpu_torch.observability.metrics",
    "mmlspark_tpu_torch.observability.device",
    "mmlspark_tpu_torch.observability.roofline",
    "mmlspark_tpu_torch.observability.blackbox",
    "mmlspark_tpu_torch.robustness",
    "mmlspark_tpu_torch.robustness.policy",
    "mmlspark_tpu_torch.tuning",
    "mmlspark_tpu_torch.tuning.store",
    "mmlspark_tpu_torch.io.serving",
    "mmlspark_tpu_torch.io.aserve",
    "mmlspark_tpu_torch.io.aserve.server",
    "mmlspark_tpu_torch.io.serving_main",
    "mmlspark_tpu_torch.utils.profiling",
    "mmlspark_tpu_torch.observability.federation",
    "mmlspark_tpu_torch.io.distributed_serving",
    "mmlspark_tpu_torch.io.http",
    "mmlspark_tpu_torch.bundles",
    "mmlspark_tpu_torch.bundles.bundle",
    "mmlspark_tpu_torch.bundles.__main__",
)


#: the shared host stages, featurizers, TrainClassifier and the VW learners
SLICE_13_MODULES = (
    "mmlspark_tpu_torch.ops.murmur",
    "mmlspark_tpu_torch.stages.udfs",
    "mmlspark_tpu_torch.stages.basic",
    "mmlspark_tpu_torch.stages.batching",
    "mmlspark_tpu_torch.featurize.core",
    "mmlspark_tpu_torch.featurize.text",
    "mmlspark_tpu_torch.train.core",
    "mmlspark_tpu_torch.utils.plot",
    "mmlspark_tpu_torch.core.datagen",
    "mmlspark_tpu_torch.core.benchmarks",
    "mmlspark_tpu_torch.core.fuzzing",
    "mmlspark_tpu_torch.models.vw",
    "mmlspark_tpu_torch.models.vw.featurizer",
    "mmlspark_tpu_torch.models.vw.sgd",
    "mmlspark_tpu_torch.models.vw.api",
    "mmlspark_tpu_torch.models.vw.bandit",
    "mmlspark_tpu_torch.models.vw.convert",
)


#: isolation forest, exact KNN, SAR with the ranking tools, CyberML
SLICE_14_MODULES = (
    "mmlspark_tpu_torch.ops.topk",
    "mmlspark_tpu_torch.models.isolation_forest",
    "mmlspark_tpu_torch.nn",
    "mmlspark_tpu_torch.nn.knn",
    "mmlspark_tpu_torch.recommendation",
    "mmlspark_tpu_torch.recommendation.sar",
    "mmlspark_tpu_torch.recommendation.ranking",
    "mmlspark_tpu_torch.cyber",
    "mmlspark_tpu_torch.cyber.feature",
    "mmlspark_tpu_torch.cyber.complement",
    "mmlspark_tpu_torch.cyber.dataset",
    "mmlspark_tpu_torch.cyber.anomaly",
)


#: the DNN scoring path: image ops, the CNN catalog, DNNModel and
#: ImageFeaturizer, the model repository, binary files, streamed
#: featurizing (in io.streaming) and LIME
SLICE_15_MODULES = (
    "mmlspark_tpu_torch.io.binary",
    "mmlspark_tpu_torch.image",
    "mmlspark_tpu_torch.image.ops",
    "mmlspark_tpu_torch.models.dnn",
    "mmlspark_tpu_torch.models.dnn.cnn",
    "mmlspark_tpu_torch.models.dnn.convert",
    "mmlspark_tpu_torch.models.dnn.digits_fixture",
    "mmlspark_tpu_torch.models.dnn.downloader",
    "mmlspark_tpu_torch.models.dnn.scoring",
    "mmlspark_tpu_torch.explain",
    "mmlspark_tpu_torch.explain.lime",
)


#: AutoML, and the HTTP, Power BI, port-forwarding and cognitive-service
#: stages (the rest of io.http is in SERVING_MODULES)
SLICE_16_MODULES = (
    "mmlspark_tpu_torch.automl",
    "mmlspark_tpu_torch.automl.core",
    "mmlspark_tpu_torch.automl.sweep",
    "mmlspark_tpu_torch.io.powerbi",
    "mmlspark_tpu_torch.io.port_forwarding",
    "mmlspark_tpu_torch.cognitive",
    "mmlspark_tpu_torch.cognitive.base",
    "mmlspark_tpu_torch.cognitive.services",
    "mmlspark_tpu_torch.cognitive.speech_sdk",
)


#: sequence parallelism (the named-axis mesh's collectives, ring and
#: Ulysses attention), the SPMD transformer and codegen
SLICE_17_MODULES = (
    "mmlspark_tpu_torch.parallel.collectives",
    "mmlspark_tpu_torch.parallel.ring_attention",
    "mmlspark_tpu_torch.parallel.ulysses",
    "mmlspark_tpu_torch.models.dnn.transformer",
    "mmlspark_tpu_torch.codegen",
    "mmlspark_tpu_torch.codegen.__main__",
)


#: the JAX package's random streams (threefry2x32 as torch integer ops)
SLICE_19_MODULES = (
    "mmlspark_tpu_torch.utils.prng",
)


def test_importing_the_port_loads_no_jax():
    mods = _package_modules()
    assert {"mmlspark_tpu_torch.models.gbdt.growth",
            "mmlspark_tpu_torch.models.gbdt.lgbm_format",
            "mmlspark_tpu_torch.parallel",
            "mmlspark_tpu_torch.parallel.mesh",
            "mmlspark_tpu_torch.parallel.distributed",
            "mmlspark_tpu_torch.parallel.placement",
            "mmlspark_tpu_torch.utils.stopwatch"} <= set(mods)
    assert set(SERVING_MODULES) <= set(mods)
    assert set(SLICE_13_MODULES) <= set(mods)
    assert set(SLICE_14_MODULES) <= set(mods)
    assert set(SLICE_15_MODULES) <= set(mods)
    assert set(SLICE_16_MODULES) <= set(mods)
    assert set(SLICE_17_MODULES) <= set(mods)
    assert set(SLICE_19_MODULES) <= set(mods)
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


@pytest.mark.parametrize("mod", ["mmlspark_tpu_torch.io.aserve",
                                 "mmlspark_tpu_torch.io.serving_main",
                                 "mmlspark_tpu_torch.observability",
                                 "mmlspark_tpu_torch.io.distributed_serving",
                                 "mmlspark_tpu_torch.bundles"])
def test_serving_imports_load_no_jax_and_start_no_cuda(mod):
    """Each serving entry module alone, in a fresh interpreter: no jax, no
    JAX package, and no CUDA context (the device probes wait for one)."""
    code = ("import importlib, sys\n"
            f"m = importlib.import_module({mod!r})\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'mmlspark_tpu'))\n"
            "t = sys.modules.get('torch')\n"
            "cuda = bool(t is not None and t.cuda.is_initialized())\n"
            "print(bad, cuda)\n"
            "sys.exit(1 if bad or cuda else 0)\n")
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
             os.path.join(ROOT, "tools", "node_hist_sweeps.py"),
             os.path.join(ROOT, "tools", "rehearse_chip_smoke.py"),
             os.path.join(ROOT, "tools", "ab_predict.py"),
             os.path.join(ROOT, "tools", "multi_card_fit.py"),
             os.path.join(ROOT, "tools", "chip_phase15.py"),
             os.path.join(ROOT, "tools", "chip_phase16.py"),
             os.path.join(ROOT, "tools", "chip_phase17.py"),
             os.path.join(ROOT, "tools", "chip_phase18.py"),
             os.path.join(ROOT, "tools", "chip_phase19.py"),
             os.path.join(ROOT, "tools", "chip_phase20.py"),
             os.path.join(ROOT, "tools", "chip_phase21.py"),
             os.path.join(ROOT, "tools", "dnn_tolerances.py")]
    for dirpath, _, filenames in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    assert all(os.path.isfile(p) for p in paths[:15])
    assert os.path.join(PKG, "models", "gbdt", "lgbm_format.py") in paths
    for sub in ("observability", "robustness", "tuning", "parallel",
                os.path.join("io", "aserve")):
        assert os.path.join(PKG, sub, "__init__.py") in paths
    for f in (os.path.join("io", "serving.py"),
              os.path.join("io", "serving_main.py"),
              os.path.join("utils", "profiling.py"),
              os.path.join("io", "distributed_serving.py"),
              os.path.join("observability", "federation.py"),
              os.path.join("bundles", "bundle.py"),
              os.path.join("parallel", "mesh.py"),
              os.path.join("parallel", "distributed.py"),
              os.path.join("parallel", "placement.py"),
              os.path.join("utils", "stopwatch.py")):
        assert os.path.join(PKG, f) in paths
    for mod in (SLICE_13_MODULES + SLICE_14_MODULES + SLICE_15_MODULES
                + SLICE_16_MODULES + SLICE_17_MODULES + SLICE_19_MODULES):
        rel = mod.split(".", 1)[1].replace(".", os.sep)
        assert (os.path.join(PKG, rel + ".py") in paths
                or os.path.join(PKG, rel, "__init__.py") in paths), mod
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


def test_serving_entry_points_default_to_cuda_and_raise(no_gpu, tmp_path):
    """The predict path, the bundle build and prewarm and the
    worker role all default to cuda, and raise without a GPU."""
    from mmlspark_tpu_torch.bundles import build_bundle, prewarm
    from mmlspark_tpu_torch.io import serving_main
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    b = train_booster(X, (X[:, 0] > 0).astype(np.float32),
                      objective="binary", num_iterations=1, device="cpu")
    path = str(tmp_path / "m.npz")
    b.save(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        b.predict(X)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_bundle(path, str(tmp_path / "b"), max_batch=2)
    build_bundle(path, str(tmp_path / "b"), max_batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        prewarm(path, str(tmp_path / "b"), boosters=[b])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serving_main.main(["worker", "--model", path, "--registry",
                           str(tmp_path / "reg"), "--host", "localhost"])


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


def _vw_rows(n=64):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1 << 10, size=(n, 3)).astype(np.int32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    y = (val[:, 0] > 0).astype(np.float32)
    return idx, val, y


def _bandit_rows(n=12):
    return Dataset({
        "shared": np.eye(3, dtype=np.float32)[np.arange(n) % 3],
        "features": [[np.eye(3, dtype=np.float32)[a] for a in range(3)]
                     for _ in range(n)],
        "chosenAction": (np.arange(n) % 3) + 1,
        "label": np.ones(n), "probability": np.full(n, 1.0 / 3)})


def test_vw_entry_points_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.models.vw import (VowpalWabbitClassifier,
                                              VowpalWabbitContextualBandit)
    from mmlspark_tpu_torch.models.vw.sgd import predict_sgd
    idx, val, y = _vw_rows()
    ds = Dataset({"features_indices": idx, "features_values": val,
                  "label": y})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        VowpalWabbitClassifier(numBits=10).fit(ds)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        VowpalWabbitContextualBandit().fit(_bandit_rows())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        predict_sgd(idx, val, np.zeros(1 << 10, np.float32))
    m = VowpalWabbitClassifier(numBits=10, device="cpu").fit(ds)
    assert m.transform(ds).array("probability").shape == (64, 2)
    m.set(device=None)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        m.transform(ds)
    b = VowpalWabbitContextualBandit(device="cpu").fit(_bandit_rows())
    assert len(b.transform(_bandit_rows())["prediction"]) == 12
    assert predict_sgd(idx, val, m.weights, device="cpu").shape == (64,)


def test_slice_14_entry_points_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.cyber import AccessAnomaly
    from mmlspark_tpu_torch.cyber.anomaly import als_fit
    from mmlspark_tpu_torch.models.isolation_forest import IsolationForest
    from mmlspark_tpu_torch.nn.knn import ConditionalKNN, KNN
    from mmlspark_tpu_torch.recommendation.sar import SAR
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    feats = Dataset({"features": X, "label": np.arange(40) % 2,
                     "conditioner": [[0]] * 40})
    inter = Dataset({"user_idx": np.arange(40) % 5,
                     "item_idx": np.arange(40) % 7})
    access = Dataset({"tenant": [0] * 40, "user": list(np.arange(40) % 5),
                      "res": list(np.arange(40) % 7),
                      "likelihood": np.ones(40)})
    for est, ds in ((IsolationForest(numEstimators=3), feats),
                    (KNN(k=2), feats), (ConditionalKNN(k=2), feats),
                    (SAR(supportThreshold=1), inter),
                    (AccessAnomaly(maxIter=2), access)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            est.fit(ds)
        model = est.set(device="cpu").fit(ds)
        if hasattr(model, "device"):
            model.set(device=None)
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                (model.recommend_for_all_users(2) if isinstance(est, SAR)
                 else model.transform(feats))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        als_fit(np.arange(4), np.arange(4), np.ones(4), 4, 4, 2, 1, 1.0,
                True, 1.0)


def test_slice_15_entry_points_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.image import (ImageTransformer,
                                          ResizeImageTransformer, blur_image,
                                          resize_image)
    from mmlspark_tpu_torch.models.dnn import (CNNConfig, DNNModel,
                                              ImageFeaturizer,
                                              init_cnn_params)
    img = np.random.default_rng(0).integers(0, 256, (12, 10, 3)).astype(
        np.uint8)
    cfg = CNNConfig(num_classes=3, stage_sizes=(1,), width=4,
                    input_hw=(8, 8))
    spec = {"kind": "cnn", "config": {"num_classes": 3, "stage_sizes": (1,),
                                      "width": 4, "input_hw": (8, 8)}}
    from mmlspark_tpu_torch.utils import prng
    dnn = DNNModel(init_cnn_params(cfg, prng.prng_key(0)),
                   apply_spec=spec).set(inputCol="x", outputNode="pool")
    ds = Dataset({"img": [img], "x": np.zeros((1, 8, 8, 3), np.float32)})
    stages = (ImageTransformer().set(inputCol="img").resize(8, 8),
              ResizeImageTransformer().set(inputCol="img", outputCol="r",
                                           height=8, width=8),
              dnn,
              ImageFeaturizer(dnn, input_hw=(8, 8)).set(inputCol="img"))
    for stage in stages:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            stage.transform(ds)
        assert len(stage.set(device="cpu").transform(ds)) == 1
    for fn in (lambda: resize_image(img, 4, 4),
               lambda: blur_image(img.astype(np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn()
    assert resize_image(img, 4, 4, device="cpu").shape == (4, 4, 3)


def test_murmur_raises_when_the_native_build_fails(monkeypatch):
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops import murmur
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        murmur.murmur3_32("abc", 0)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        murmur.murmur3_batch(["abc"], [0])


def test_automl_entry_points_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.automl.core import (DiscreteHyperParam,
                                                FindBestModel, GridSpace,
                                                TuneHyperparameters)
    from mmlspark_tpu_torch.automl.sweep import swept_fit
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    ds = Dataset({"features": X, "label": (X[:, 0] > 0).astype(np.float64)})
    space = GridSpace({"learningRate": DiscreteHyperParam([0.1, 0.3])})
    maps = list(space.param_maps())
    for dev in (None, "cpu"):
        est = LightGBMClassifier(numIterations=1, minDataInLeaf=2,
                                 device=dev)
        calls = [lambda p=p: TuneHyperparameters(
                     models=[est], numFolds=2, paramSpace=space,
                     parallelism=p).fit(ds) for p in (1, 2)]
        calls += [lambda: FindBestModel(models=[est]).fit(ds),
                  lambda: swept_fit(est, maps, ds)]
        for call in calls:
            if dev is None:
                with pytest.raises(RuntimeError, match="no CUDA GPU"):
                    call()
            else:
                assert call() is not None


def test_transformer_entry_points_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.models.dnn import transformer as T
    from mmlspark_tpu_torch.models.dnn.convert import (
        transformer_params_from_jax)
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    cfg = T.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                              d_head=8, n_layers=1, d_ff=32, max_len=16,
                              dtype=torch.float32)
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1})
    params = T.init_params(cfg, 0, device="cpu")
    tree = {k: (v.numpy() if not isinstance(v, dict) else
                {n: t.numpy() for n, t in v.items()})
            for k, v in params.items()}
    toks = np.zeros((1, 8), np.int64)
    calls = [lambda: T.init_params(cfg, 0),
             lambda: T.shard_params(params, cfg, mesh),
             lambda: T.shard_opt_state(T.adamw_init(params), cfg, mesh),
             lambda: T.make_train_step(cfg, mesh),
             lambda: T.make_forward(cfg, mesh),
             lambda: transformer_params_from_jax(tree, cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    step = T.make_train_step(cfg, mesh, device="cpu")
    _, _, loss = step(params, T.adamw_init(params), toks, toks)
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    logits = T.make_forward(cfg, mesh, device="cpu")(params, toks)
    assert logits.shape == (1, 8, 32)


def test_prng_draws_default_to_cuda_and_raise(no_gpu):
    from mmlspark_tpu_torch.models.gbdt.booster import _row_uniforms
    from mmlspark_tpu_torch.utils import prng
    key = prng.fold_in(prng.prng_key(3), 5)
    assert prng.split(key, 2).device.type == "cpu"
    calls = [lambda: prng.bits(key, (4,)), lambda: prng.uniform(key, 4),
             lambda: prng.normal(key, (2, 2)),
             lambda: _row_uniforms(3, 0, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert prng.uniform(key, 4, device="cpu").device.type == "cpu"
    assert _row_uniforms(3, 0, 8, device="cpu").shape == (8,)


def test_generated_namespace_stages_default_to_cuda_and_raise(no_gpu,
                                                              tmp_path):
    from mmlspark_tpu_torch.codegen import generate_compat_namespace
    generate_compat_namespace(str(tmp_path))
    for mod in [m for m in sys.modules if m == "mmlspark"
                or m.startswith("mmlspark.")]:
        del sys.modules[mod]
    sys.path.insert(0, str(tmp_path))
    try:
        from mmlspark.lightgbm import LightGBMClassifier as Generated
        rng = np.random.default_rng(0)
        X = rng.normal(size=(64, 3)).astype(np.float32)
        ds = Dataset({"features": X,
                      "label": (X[:, 0] > 0).astype(np.float64)})
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Generated().setNumIterations(1).setMinDataInLeaf(2).fit(ds)
        assert Generated().setNumIterations(1).setMinDataInLeaf(2) \
            .setDevice("cpu").fit(ds) is not None
    finally:
        sys.path.remove(str(tmp_path))
        for mod in [m for m in sys.modules if m == "mmlspark"
                    or m.startswith("mmlspark.")]:
            del sys.modules[mod]
