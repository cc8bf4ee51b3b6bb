"""Estimator / Transformer / Model / Pipeline — the stage contract.

The PyTorch port's own copy of ``mmlspark_tpu/core/pipeline.py``. Equivalent
of the Spark ML pipeline layer the reference builds on (reference: every
stage extends Spark's Estimator/Transformer; pipeline persistence via
org/apache/spark/ml/Serializer.scala:21-130). Persistence is a directory of
``metadata.json`` + per-param payloads, and any class importable by qualified
name can be restored. Every stage's ``fit`` and ``transform`` runs in a
telemetry span (:func:`_instrumented`).
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import spans as _spans
from .dataset import Dataset
from .params import Params


def _row_count(ds: Any) -> Optional[int]:
    try:
        return len(ds)
    except Exception:  # noqa: BLE001 — telemetry must never break a stage
        return None


def _instrumented(method, op: str):
    """Wrap a stage's ``fit``/``transform`` in a ``{ClassName}.{uid}`` span
    recording input/output row counts (the reference's per-scope
    StopWatch names). Disabled telemetry short-circuits to the raw method
    — behavior and results are byte-identical either way."""

    @functools.wraps(method)
    def wrapped(self, dataset, *args, **kwargs):
        if not _metrics.enabled():
            return method(self, dataset, *args, **kwargs)
        cls = type(self).__name__
        with _spans.span(f"{cls}.{self.uid}", metric_label=cls,
                         op=op) as sp:
            rows_in = _row_count(dataset)
            if rows_in is not None:
                sp.set(rows_in=rows_in)
                _metrics.safe_counter("stage_rows_in_total",
                                      stage=cls, op=op).inc(rows_in)
            try:
                out = method(self, dataset, *args, **kwargs)
            except Exception as e:
                # the flight recorder's error record: which stage blew
                # up, on how many rows
                _flight.record("error", stage=cls, uid=self.uid, op=op,
                               rows_in=rows_in,
                               error=f"{type(e).__name__}: {e}")
                raise
            if op == "transform":
                rows_out = _row_count(out)
                if rows_out is not None:
                    sp.set(rows_out=rows_out)
                    _metrics.safe_counter("stage_rows_out_total",
                                          stage=cls, op=op).inc(rows_out)
        return out

    wrapped._telemetry_wrapped = True
    return wrapped


class PipelineStage(Params):
    """Common base: anything placeable in a Pipeline.

    Every subclass's own ``fit`` / ``transform`` is wrapped in a telemetry
    span when the class is created (``__init_subclass__``), so every stage
    reports its timing and row counts without opting in."""

    uid_counter = 0

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr, op in (("fit", "fit"), ("transform", "transform")):
            m = cls.__dict__.get(attr)
            if callable(m) and not getattr(m, "_telemetry_wrapped", False):
                setattr(cls, attr, _instrumented(m, op))

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        PipelineStage.uid_counter += 1
        self.uid = f"{type(self).__name__}_{PipelineStage.uid_counter:04d}"

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        save_stage(self, path)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        stage = load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    # Complex (non-JSON) state beyond params; subclasses override.
    # Mirrors ComplexParam persistence (reference: core/serialize/ComplexParam.scala:13-34).
    def _save_extra(self, path: str) -> None:
        pass

    def _load_extra(self, path: str) -> None:
        pass


class Transformer(PipelineStage):
    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class Estimator(PipelineStage):
    def fit(self, dataset: Dataset) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class UnaryTransformer(Transformer):
    """inputCol -> outputCol via :meth:`_transform_column`."""

    def _transform_column(self, col):
        raise NotImplementedError

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or f"{in_col}_out"
        return dataset.with_column(out_col, self._transform_column(dataset[in_col]))


class Pipeline(Estimator):
    """Sequential stages; estimators are fit then their models transform.

    Parity with Spark ML Pipeline semantics used throughout the reference.
    ``fit`` additionally records a per-stage timing table — the analog
    of wrapping each stage in the reference's Timer
    (stages/Timer.scala:57-92) — retrievable via :meth:`last_fit_report`.
    """

    # class-level default: instances restored via load_stage bypass __init__
    _last_fit_report: List[Dict[str, Any]] = []

    def __init__(self, stages: Optional[List[PipelineStage]] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages: List[PipelineStage] = list(stages or [])

    def set_stages(self, stages: List[PipelineStage]) -> "Pipeline":
        self.stages = list(stages)
        return self

    def get_stages(self) -> List[PipelineStage]:
        return self.stages

    def fit(self, dataset: Dataset) -> "PipelineModel":
        fitted: List[Transformer] = []
        report: List[Dict[str, Any]] = []
        current = dataset
        for i, stage in enumerate(self.stages):
            t0 = time.perf_counter()
            rows_in = _row_count(current)
            if isinstance(stage, Estimator):
                op = "fit"
                model = stage.fit(current)
                fitted.append(model)
                if i < len(self.stages) - 1:
                    op = "fit+transform"
                    current = model.transform(current)
            elif isinstance(stage, Transformer):
                # the final transformer is only collected during fit (it
                # first runs at PipelineModel.transform time)
                op = "transform" if i < len(self.stages) - 1 else "collect"
                fitted.append(stage)
                if i < len(self.stages) - 1:
                    current = stage.transform(current)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
            report.append({
                "stage": type(stage).__name__, "uid": stage.uid, "op": op,
                "seconds": time.perf_counter() - t0,
                "rows_in": rows_in,
                # the final stage never transforms during fit ('fit' /
                # 'collect'), so there is no output to count — reporting
                # the untouched input's length would claim it emitted rows
                "rows_out": (_row_count(current)
                             if i < len(self.stages) - 1 else None),
            })
        self._last_fit_report = report
        return PipelineModel(fitted)

    def last_fit_report(self) -> List[Dict[str, Any]]:
        """Per-stage timing of the most recent :meth:`fit`: one entry per
        stage with ``stage``/``uid``/``op``/``seconds``/``rows_in``/
        ``rows_out`` (empty before any fit; ``rows_out`` is None for the
        final stage, which does not transform during fit)."""
        return [dict(r) for r in self._last_fit_report]

    def _save_extra(self, path: str) -> None:
        _save_stage_list(self.stages, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        self.stages = _load_stage_list(os.path.join(path, "stages"))


class PipelineModel(Model):
    def __init__(self, stages: Optional[List[Transformer]] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages: List[Transformer] = list(stages or [])

    def transform(self, dataset: Dataset) -> Dataset:
        current = dataset
        for stage in self.stages:
            current = stage.transform(current)
        return current

    def _save_extra(self, path: str) -> None:
        _save_stage_list(self.stages, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        self.stages = _load_stage_list(os.path.join(path, "stages"))


class Lambda(Transformer):
    """Arbitrary Dataset -> Dataset function as a (picklable) pipeline stage.

    Parity: stages/Lambda.scala:21. The function is persisted with pickle, the
    same trade-off as the reference's UDF serialization.
    """

    def __init__(self, fn=None, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn

    def transform(self, dataset: Dataset) -> Dataset:
        return self.fn(dataset)

    def _save_extra(self, path: str) -> None:
        with open(os.path.join(path, "fn.pkl"), "wb") as f:
            pickle.dump(self.fn, f)

    def _load_extra(self, path: str) -> None:
        with open(os.path.join(path, "fn.pkl"), "rb") as f:
            self.fn = load_pickle(f)


# ---------------------------------------------------------------------------
# Persistence (reference: org/apache/spark/ml/Serializer.scala:52-130 — here a
# plain directory format: metadata.json with class + simple params; numpy /
# pickle payloads for complex params; nested dirs for sub-stages).
#
# Directories saved by the JAX package load here too: their metadata and
# pickles name classes under ``mmlspark_tpu.``, which are read as their
# ``mmlspark_tpu_torch.`` counterparts without importing the JAX package.
# ---------------------------------------------------------------------------

_JAX_ROOT = "mmlspark_tpu"
_PORT_ROOT = "mmlspark_tpu_torch"

#: JAX classes whose pickled state differs from their counterpart's: the
#: port reads them through a class of its own
_JAX_PICKLED = {
    ("mmlspark_tpu.models.gbdt.booster", "Booster"):
        ("mmlspark_tpu_torch.models.gbdt.convert", "JaxPickledBooster"),
}


def port_module(name: str) -> str:
    """The port's module for a module of the JAX package
    (``mmlspark_tpu.x`` -> ``mmlspark_tpu_torch.x``); other names as given."""
    if name == _JAX_ROOT or name.startswith(_JAX_ROOT + "."):
        return _PORT_ROOT + name[len(_JAX_ROOT):]
    return name


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        module, name = _JAX_PICKLED.get((module, name), (module, name))
        return super().find_class(port_module(module), name)


def load_pickle(f):
    """``pickle.load`` with the JAX package's classes read as the port's."""
    return _PortUnpickler(f).load()


def _is_jsonable(v: Any) -> bool:
    # JSON must round-trip *faithfully*: json.dumps silently stringifies
    # non-str dict keys and turns tuples into lists, which corrupts params
    # (e.g. a float->weight table); such values go to the pickle path instead.
    try:
        return json.loads(json.dumps(v)) == v
    except (TypeError, ValueError):
        return False


def save_stage(stage: PipelineStage, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    simple, complex_names = {}, []
    for name, value in stage._paramMap.items():
        if _is_jsonable(value):
            simple[name] = value
        else:
            complex_names.append(name)
            payload = os.path.join(path, f"param_{name}")
            if isinstance(value, np.ndarray):
                np.save(payload + ".npy", value)
            else:
                with open(payload + ".pkl", "wb") as f:
                    pickle.dump(value, f)
    meta = {
        "class": f"{type(stage).__module__}.{type(stage).__qualname__}",
        "uid": stage.uid,
        "params": simple,
        "complexParams": complex_names,
        "formatVersion": 1,
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    stage._save_extra(path)


def load_stage(path: str) -> PipelineStage:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    module, _, qualname = meta["class"].rpartition(".")
    cls = importlib.import_module(port_module(module))
    for part in qualname.split("."):
        cls = getattr(cls, part)
    stage = cls.__new__(cls)
    PipelineStage.__init__(stage)
    stage.uid = meta["uid"]
    stage.set(**meta["params"])
    for name in meta["complexParams"]:
        npy = os.path.join(path, f"param_{name}.npy")
        pkl = os.path.join(path, f"param_{name}.pkl")
        if os.path.exists(npy):
            stage._paramMap[name] = np.load(npy, allow_pickle=False)
        else:
            with open(pkl, "rb") as f:
                stage._paramMap[name] = load_pickle(f)
    stage._load_extra(path)
    return stage


def _save_stage_list(stages: List[PipelineStage], path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "order.json"), "w") as f:
        json.dump([f"{i:03d}" for i in range(len(stages))], f)
    for i, s in enumerate(stages):
        save_stage(s, os.path.join(path, f"{i:03d}"))


def _load_stage_list(path: str) -> List[PipelineStage]:
    with open(os.path.join(path, "order.json")) as f:
        order = json.load(f)
    return [load_stage(os.path.join(path, name)) for name in order]
