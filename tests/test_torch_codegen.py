"""The port's codegen (``mmlspark_tpu_torch.codegen``) against the JAX one.

Each case of ``tests/test_codegen.py`` runs against the port's generator,
writing under ``tmp_path``: the generated ``mmlspark`` namespace and its
reference-style imports, the accessors (a ``LightGBMClassifier`` fitted
through them with ``setDevice("cpu")``), the API document, the migration
table (its rows equal to the JAX package's checked-in table with the
module paths renamed), the R wrappers and the generated smoke tests. Then:
the port's stage list and each stage's params equal the JAX generator's
(the port adds one Param, ``device``, to its device stages); and
``python -m mmlspark_tpu_torch.codegen`` writes ``build/python_api_torch``
under the current directory and leaves ``python_api/`` as it was.

Both generators emit a package named ``mmlspark``: the fixture purges
``mmlspark`` and ``mmlspark.*`` from ``sys.modules`` (never
``mmlspark_tpu*``) before and after, as the JAX fixture does.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu import codegen as jcodegen
from mmlspark_tpu_torch.codegen import (_group_stages,
                                        attach_pyspark_accessors,
                                        generate_all, generate_api_docs,
                                        generate_migration_table)
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.fuzzing import discover_stages

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _purge_generated():
    for mod in [m for m in sys.modules if m == "mmlspark"
                or m.startswith("mmlspark.")]:
        del sys.modules[mod]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("api_torch"))
    result = generate_all(out)
    _purge_generated()
    sys.path.insert(0, out)
    yield out, result
    sys.path.remove(out)
    _purge_generated()


def test_namespace_layout(generated):
    out, result = generated
    assert os.path.exists(os.path.join(out, "mmlspark", "__init__.py"))
    assert os.path.exists(os.path.join(out, "mmlspark", "lightgbm.py"))
    assert os.path.exists(os.path.join(out, "mmlspark", "io", "http.py"))
    assert len(result["namespace_files"]) > 10
    text = open(os.path.join(out, "mmlspark", "lightgbm.py")).read()
    assert "from mmlspark_tpu_torch.codegen import" in text
    assert "mmlspark_tpu." not in text


def test_reference_style_imports_work(generated):
    from mmlspark.lightgbm import LightGBMClassifier
    from mmlspark.vw import VowpalWabbitClassifier  # noqa: F401
    from mmlspark.cognitive import TextSentiment  # noqa: F401
    from mmlspark.stages import DropColumns  # noqa: F401
    from mmlspark.cyber import AccessAnomaly  # noqa: F401
    from mmlspark.cntk import CNTKModel, DNNModel

    assert CNTKModel is DNNModel               # reference-name alias
    assert LightGBMClassifier.__module__ == \
        "mmlspark_tpu_torch.models.gbdt.api"


def test_generated_accessors_roundtrip_and_fit(generated):
    from mmlspark.lightgbm import LightGBMClassifier

    clf = (LightGBMClassifier()
           .setNumIterations(4).setNumLeaves(7).setMinDataInLeaf(2)
           .setLabelCol("label").setDevice("cpu"))
    assert clf.getNumIterations() == 4
    assert clf.getNumLeaves() == 7
    assert clf.getDevice() == "cpu"
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    model = clf.fit(Dataset({"features": X, "label": y}))
    acc = (model.transform(Dataset({"features": X})).array("prediction")
           == y).mean()
    assert acc > 0.85


def test_accessor_reflection_covers_all_params():
    from mmlspark_tpu_torch.models.vw.api import VowpalWabbitRegressor

    cls = attach_pyspark_accessors(VowpalWabbitRegressor)
    stage = cls()
    for p in cls.params():
        cap = p.name[0].upper() + p.name[1:]
        assert callable(getattr(stage, f"set{cap}"))
        assert callable(getattr(stage, f"get{cap}"))
    assert stage.setNumPasses(7).getNumPasses() == 7


def test_api_docs_generated(generated, tmp_path):
    path = generate_api_docs(str(tmp_path / "API.md"))
    text = open(path).read()
    assert "## mmlspark.lightgbm" in text
    assert "LightGBMClassifier" in text
    assert "numIterations" in text
    assert "## mmlspark.cyber" in text


def _rows(text: str) -> list:
    return [line for line in text.splitlines()
            if line.startswith(("|", "## "))]


def test_migration_table_generated(generated, tmp_path):
    path = generate_migration_table(str(tmp_path / "MIG.md"))
    text = open(path).read()
    assert "## mmlspark.lightgbm" in text
    assert "`from mmlspark.lightgbm import LightGBMClassifier`" in text
    assert "`mmlspark_tpu_torch.models.gbdt.api.LightGBMClassifier`" in text
    assert "## mmlspark.vw" in text
    # every row of the JAX package's checked-in table, its native column
    # renamed to the port's modules
    jax_copy = open(os.path.join(ROOT, "python_api",
                                 "MIGRATION_TABLE.md")).read()
    assert _rows(text) == [r.replace("`mmlspark_tpu.", "`mmlspark_tpu_torch.")
                           for r in _rows(jax_copy)]


def test_r_wrappers_generated(generated):
    out, result = generated
    assert any(p.endswith("mmlspark_lightgbm.R") for p in result["r_files"])
    core = next(p for p in result["r_files"]
                if p.endswith("mmlspark_runtime.R"))
    assert "mmlspark_initialize" in open(core).read()
    lgbm = next(p for p in result["r_files"]
                if p.endswith("mmlspark_lightgbm.R"))
    text = open(lgbm).read()
    # the JAX generator's R name for the same class
    assert f"{jcodegen._r_fn_name('LightGBMClassifier')} <- function(...)" \
        in text
    assert 'mod <- .mmlspark_module("mmlspark_tpu_torch.models.gbdt.api")' \
        in text
    for p in result["r_files"]:
        s = open(p).read()
        assert s.count("{") == s.count("}"), p


def test_generated_smoke_tests_pass(generated):
    out, result = generated
    env = dict(os.environ, PYTHONPATH=out + os.pathsep + ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", result["tests"], "-q", "-p",
         "no:cacheprovider"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "mmlspark_tpu_torch.core.pipeline" in open(result["tests"]).read()


def test_stage_and_param_lists_equal_jax():
    port = {ns: [q.replace("mmlspark_tpu_torch.", "mmlspark_tpu.", 1)
                 for q in quals] for ns, quals in _group_stages().items()}
    assert port == jcodegen._group_stages()
    from mmlspark_tpu.core.fuzzing import discover_stages as jdiscover

    jstages, tstages = jdiscover(), discover_stages()
    with_device = []
    for qual, jcls in jstages.items():
        tcls = tstages[qual.replace("mmlspark_tpu.", "mmlspark_tpu_torch.",
                                    1)]
        jp = [(p.name, repr(p.default)) for p in jcls.params()]
        tp = [(p.name, repr(p.default)) for p in tcls.params()]
        if ("device", "None") in tp:
            with_device.append(tcls.__name__)
            tp.remove(("device", "None"))
        assert tp == jp, qual
    assert {"LightGBMClassifier", "VowpalWabbitClassifier", "KNN", "SAR",
            "DNNModel", "AccessAnomaly"} <= set(with_device)


def _tree_digest(path: str) -> str:
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(path)):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, path).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_cli_writes_build_python_api_torch_and_not_python_api(tmp_path):
    before = _tree_digest(os.path.join(ROOT, "python_api"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.codegen"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    out = tmp_path / "build" / "python_api_torch"
    assert (out / "mmlspark" / "lightgbm.py").exists()
    assert (out / "MIGRATION_TABLE.md").exists()
    assert not (tmp_path / "python_api").exists()
    assert _tree_digest(os.path.join(ROOT, "python_api")) == before
