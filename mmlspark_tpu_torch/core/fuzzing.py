"""Generic stage fuzzing harness: smoke-fit, save/load round-trips, coverage.

Counterpart of ``mmlspark_tpu/core/fuzzing.py``: the reference's property-test
framework (reference:
src/test/scala/com/microsoft/ml/spark/core/test/fuzzing/Fuzzing.scala —
``TestObject``/``ExperimentFuzzing``/``SerializationFuzzing``; coverage
enforcement in fuzzing/FuzzingTest.scala:27-185, which reflects over every
registered stage and fails the build when one lacks generic tests).

Usage (see tests/test_fuzzing.py): each stage registers a ``TestObject`` with
a ready-to-use stage instance plus fit/transform datasets; the harness then

- ``experiment_fuzz``: Estimators fit then their model transforms; plain
  Transformers transform (the fit-and-transform smoke of ExperimentFuzzing);
- ``serialization_fuzz``: stage save -> load -> re-run, asserting the loaded
  stage produces the same output (SerializationFuzzing's save/load round-trip
  of both the stage and its fitted model);
- ``discover_stages``: walks the installed package and returns every concrete
  PipelineStage subclass, powering the FuzzingTest-style coverage gate.
"""

from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

import numpy as np

from .dataset import Dataset
from .pipeline import Estimator, Model, PipelineStage, Transformer


@dataclass
class TestObject:
    """One fuzzable stage configuration (reference: Fuzzing.scala:16-28)."""

    __test__ = False  # not a pytest class despite the name

    stage: PipelineStage
    fit_ds: Dataset
    trans_ds: Optional[Dataset] = None
    # extra model classes this object's fit is expected to produce (coverage)
    produces: List[type] = field(default_factory=list)

    @property
    def transform_dataset(self) -> Dataset:
        return self.trans_ds if self.trans_ds is not None else self.fit_ds


def discover_stages(root_package: str = "mmlspark_tpu_torch",
                    skip_modules: tuple = ()) -> Dict[str, Type[PipelineStage]]:
    """All concrete public PipelineStage subclasses in the package
    (reference: FuzzingTest.scala reflection over registered stages)."""
    root = importlib.import_module(root_package)
    for m in pkgutil.walk_packages(root.__path__, root_package + "."):
        if any(m.name.startswith(s) for s in skip_modules):
            continue
        importlib.import_module(m.name)

    found: Dict[str, Type[PipelineStage]] = {}

    def walk(cls):
        for sub in cls.__subclasses__():
            if sub.__module__.startswith(root_package):
                if not sub.__name__.startswith("_"):
                    found[f"{sub.__module__}.{sub.__name__}"] = sub
            walk(sub)

    walk(PipelineStage)
    # the abstract contract classes are not themselves stages to cover
    for base in (Estimator, Transformer, Model, PipelineStage):
        found.pop(f"{base.__module__}.{base.__name__}", None)
    return found


def run_stage(obj: TestObject) -> Dataset:
    """Fit (if estimator) and transform; returns the transformed output."""
    stage = obj.stage
    if isinstance(stage, Estimator):
        model = stage.fit(obj.fit_ds)
        return model.transform(obj.transform_dataset)
    if isinstance(stage, Transformer):
        return stage.transform(obj.transform_dataset)
    raise TypeError(f"{type(stage).__name__} is neither Estimator nor "
                    "Transformer")


def experiment_fuzz(obj: TestObject) -> Dataset:
    """Fit+transform smoke test (reference: ExperimentFuzzing:75-103)."""
    out = run_stage(obj)
    assert isinstance(out, Dataset), (
        f"{type(obj.stage).__name__} produced {type(out).__name__}, "
        "expected Dataset")
    return out


def _columns_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        if a.shape != b.shape:
            return False
        if np.issubdtype(a.dtype, np.number) and np.issubdtype(b.dtype, np.number):
            return bool(np.allclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True))
        return bool(np.array_equal(a, b))
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        xe = np.asarray(x) if isinstance(x, (np.ndarray, list)) else x
        ye = np.asarray(y) if isinstance(y, (np.ndarray, list)) else y
        if isinstance(xe, np.ndarray) and isinstance(ye, np.ndarray):
            if xe.shape != ye.shape:
                return False
            if np.issubdtype(xe.dtype, np.number):
                if not np.allclose(xe, ye, rtol=1e-5, atol=1e-6,
                                   equal_nan=True):
                    return False
            elif not np.array_equal(xe, ye):
                return False
        elif x != y:
            return False
    return True


def _params_equivalent(a, b) -> bool:
    if isinstance(a, PipelineStage) and isinstance(b, PipelineStage):
        # stage-valued params (inner models, wrapped stages): equivalent when
        # same class with pairwise-equivalent params
        return type(a) is type(b) and set(a._paramMap) == set(b._paramMap) \
            and all(_params_equivalent(v, b._paramMap[k])
                    for k, v in a._paramMap.items())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _params_equivalent(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(
            _params_equivalent(v, b[k]) for k, v in a.items())
    try:
        if bool(a == b):
            return True
    except Exception:
        pass
    # plain value objects (hyperparameter spaces etc.): structural comparison
    if type(a) is type(b) and hasattr(a, "__dict__"):
        return _params_equivalent(vars(a), vars(b))
    if type(a) is type(b):
        # stateful objects without __dict__ (e.g. np.random.Generator):
        # equivalent when their pickled state matches
        import pickle
        try:
            return pickle.dumps(a) == pickle.dumps(b)
        except Exception:
            return False
    return False


def assert_datasets_equal(a: Dataset, b: Dataset) -> None:
    assert set(a.columns) == set(b.columns), (
        f"column mismatch: {sorted(a.columns)} vs {sorted(b.columns)}")
    for c in a.columns:
        assert _columns_equal(a[c], b[c]), f"column {c!r} differs"


def serialization_fuzz(obj: TestObject, tmpdir: str) -> None:
    """Save/load round-trip of the stage (and its fitted model); the loaded
    copy must reproduce outputs (reference: SerializationFuzzing:105+)."""
    import os

    stage = obj.stage
    stage_path = os.path.join(tmpdir, "stage")
    stage.save(stage_path)
    reloaded = PipelineStage.load(stage_path)
    assert type(reloaded) is type(stage)

    if isinstance(stage, Estimator):
        assert reloaded._paramMap == stage._paramMap or all(
            _params_equivalent(reloaded._paramMap.get(k), v)
            for k, v in stage._paramMap.items()), "estimator params corrupted"
        model = stage.fit(obj.fit_ds)
        out1 = model.transform(obj.transform_dataset)
        model_path = os.path.join(tmpdir, "model")
        model.save(model_path)
        model2 = PipelineStage.load(model_path)
        assert type(model2) is type(model)
        out2 = model2.transform(obj.transform_dataset)
    else:
        out1 = stage.transform(obj.transform_dataset)
        out2 = reloaded.transform(obj.transform_dataset)
    assert_datasets_equal(out1, out2)
