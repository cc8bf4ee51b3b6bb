"""Param system: typed, documented, defaultable parameters for pipeline stages.

The PyTorch port's own copy of ``mmlspark_tpu/core/params.py`` (the port
imports nothing of the JAX package). A re-design of the reference's param layer
(reference: core/contracts/Params.scala:8-216 and the 19 injected param types in
org/apache/spark/ml/param/). Instead of JVM Param objects + reflection codegen,
params are Python descriptors on stage classes; everything is introspectable at
runtime, so the "generated Python API" of the reference is simply *the* API here.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterable, List, Optional


class Param:
    """A single named, documented parameter attached to a stage class.

    Acts as a descriptor: ``stage.paramName`` returns the *value* when accessed on
    an instance and the :class:`Param` itself when accessed on the class.
    """

    def __init__(
        self,
        name: str,
        doc: str = "",
        default: Any = None,
        type_converter: Optional[Callable[[Any], Any]] = None,
        is_complex: bool = False,
    ):
        self.name = name
        self.doc = doc
        self.default = default
        self.type_converter = type_converter
        # Complex params (models, functions, arrays) are persisted out-of-band,
        # mirroring ComplexParam (reference: core/serialize/ComplexParam.scala:13-34).
        self.is_complex = is_complex

    def __set_name__(self, owner, attr):
        if attr != self.name:
            # allow attribute name to define param name if constructed positionally
            self.name = attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get_or_default(self.name)

    def __set__(self, obj, value):
        obj.set(**{self.name: value})

    def convert(self, value: Any) -> Any:
        if self.type_converter is not None and value is not None:
            return self.type_converter(value)
        return value

    def __repr__(self):
        return f"Param({self.name!r})"


# -- type converters (parity with pyspark.ml.param.TypeConverters surface) ------


class TypeConverters:
    @staticmethod
    def to_int(v):
        return int(v)

    @staticmethod
    def to_float(v):
        return float(v)

    @staticmethod
    def to_bool(v):
        if isinstance(v, str):
            return v.lower() in ("true", "1", "yes")
        return bool(v)

    @staticmethod
    def to_string(v):
        return str(v)

    @staticmethod
    def to_list_string(v):
        return [str(x) for x in v]

    @staticmethod
    def to_list_float(v):
        return [float(x) for x in v]

    @staticmethod
    def to_list_int(v):
        return [int(x) for x in v]

    @staticmethod
    def identity(v):
        return v


class Params:
    """Base for anything that carries Params (stages, models).

    Mirrors the semantics of the reference's param layer: explicit set vs default,
    ``explainParams``, copy-with-extra. ``set_if_present`` reproduces the VW
    "only pass what the user set" convention
    (reference: vw/VowpalWabbitBase.scala:91-93).
    """

    def __init__(self, **kwargs):
        self._paramMap: Dict[str, Any] = {}
        self.set(**kwargs)

    # -- introspection ----------------------------------------------------------
    @classmethod
    def params(cls) -> List[Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if isinstance(v, Param):
                    out[v.name] = v
        return list(out.values())

    @classmethod
    def has_param(cls, name: str) -> bool:
        return any(p.name == name for p in cls.params())

    @classmethod
    def get_param(cls, name: str) -> Param:
        for p in cls.params():
            if p.name == name:
                return p
        raise AttributeError(f"{cls.__name__} has no param {name!r}")

    # -- get/set ----------------------------------------------------------------
    def set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            p = self.get_param(k)
            self._paramMap[k] = p.convert(v)
        return self

    def is_set(self, name: str) -> bool:
        return name in self._paramMap

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self.get_param(name).default is not None

    def get(self, name: str) -> Any:
        return self._paramMap[name]

    def get_or_default(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        return self.get_param(name).default

    def get_if_set(self, name: str, otherwise=None) -> Any:
        return self._paramMap.get(name, otherwise)

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def extract_param_map(self) -> Dict[str, Any]:
        # through the class: a stage may hold an instance attribute named
        # ``params`` (DNNModel's param tree)
        out = {p.name: p.default for p in type(self).params()
               if p.default is not None}
        out.update(self._paramMap)
        return out

    def explain_params(self) -> str:
        lines = []
        for p in sorted(type(self).params(), key=lambda p: p.name):
            cur = self.get_or_default(p.name)
            lines.append(f"{p.name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    # -- copies -----------------------------------------------------------------
    def copy(self, extra: Optional[Dict[str, Any]] = None):
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        if extra:
            that.set(**extra)
        return that

    def _copy_params_to(self, other: "Params"):
        for k, v in self._paramMap.items():
            if other.has_param(k):
                other._paramMap[k] = v

    def __repr__(self):
        cls = type(self).__name__
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items()))
        return f"{cls}({body})"


def make_params(**specs) -> Callable[[type], type]:
    """Class decorator: declare params compactly.

    ``@make_params(numIterations=(100, "number of boosting iterations", int))``
    attaches ``Param('numIterations', ...)`` descriptors to the class.
    Spec is ``(default, doc[, converter])``.
    """

    def deco(cls):
        for name, spec in specs.items():
            default, doc = spec[0], spec[1]
            conv = spec[2] if len(spec) > 2 else None
            if conv in (int, float, bool, str):
                conv = {int: TypeConverters.to_int, float: TypeConverters.to_float,
                        bool: TypeConverters.to_bool, str: TypeConverters.to_string}[conv]
            setattr(cls, name, Param(name, doc, default, conv))
        return cls

    return deco


# -- shared column mixins (reference: core/contracts/Params.scala:17-216) --------


class HasInputCol(Params):
    inputCol = Param("inputCol", "The name of the input column", None, TypeConverters.to_string)

    def set_input_col(self, v):
        return self.set(inputCol=v)

    def get_input_col(self):
        return self.get_or_default("inputCol")


class HasOutputCol(Params):
    outputCol = Param("outputCol", "The name of the output column", None, TypeConverters.to_string)

    def set_output_col(self, v):
        return self.set(outputCol=v)

    def get_output_col(self):
        return self.get_or_default("outputCol")


class HasInputCols(Params):
    inputCols = Param("inputCols", "The names of the input columns", None,
                      TypeConverters.to_list_string)


class HasOutputCols(Params):
    outputCols = Param("outputCols", "The names of the output columns", None,
                       TypeConverters.to_list_string)


class HasLabelCol(Params):
    labelCol = Param("labelCol", "The name of the label column", "label",
                     TypeConverters.to_string)


class HasFeaturesCol(Params):
    featuresCol = Param("featuresCol", "The name of the features column", "features",
                        TypeConverters.to_string)


class HasPredictionCol(Params):
    predictionCol = Param("predictionCol", "The name of the prediction column", "prediction",
                          TypeConverters.to_string)


class HasProbabilityCol(Params):
    probabilityCol = Param("probabilityCol", "Column for predicted class probabilities",
                           "probability", TypeConverters.to_string)


class HasRawPredictionCol(Params):
    rawPredictionCol = Param("rawPredictionCol", "Raw prediction (margin) column",
                             "rawPrediction", TypeConverters.to_string)


class HasWeightCol(Params):
    weightCol = Param("weightCol", "The name of the instance-weight column", None,
                      TypeConverters.to_string)


class HasInitScoreCol(Params):
    initScoreCol = Param("initScoreCol", "The name of the initial-score column", None,
                         TypeConverters.to_string)


class HasGroupCol(Params):
    groupCol = Param("groupCol", "The name of the query/group column (ranking)", None,
                     TypeConverters.to_string)


class HasValidationIndicatorCol(Params):
    validationIndicatorCol = Param(
        "validationIndicatorCol",
        "Boolean column: true rows are used for validation / early stopping", None,
        TypeConverters.to_string)


class HasSeed(Params):
    seed = Param("seed", "Random seed", 0, TypeConverters.to_int)


class HasBatchSize(Params):
    batchSize = Param("batchSize", "Mini-batch size", 256, TypeConverters.to_int)


class HasErrorCol(Params):
    errorCol = Param("errorCol", "Column to hold per-row errors", "errors",
                     TypeConverters.to_string)


class HasDevice(Params):
    """The port's ``device`` Param: None means the default, ``cuda``
    (resolved by :func:`mmlspark_tpu_torch.device.resolve_device`, which
    raises without a GPU); ``cpu`` only when asked."""

    device = Param("device", "Device to fit and score on: 'cuda' (default) "
                   "or 'cpu'", None, lambda v: None if v is None else str(v))

    def _device(self):
        from ..device import resolve_device
        return resolve_device(self.get_or_default("device"))


def set_known_params(stage: Params, params: Optional[Dict[str, Any]],
                     device=None) -> Params:
    """Set the values of ``params`` (a JAX stage's ``extract_param_map()``)
    that ``stage``'s class has, then ``device``: the caller's, never the
    JAX stage's, which has none."""
    stage.set(**{k: v for k, v in (params or {}).items()
                 if stage.has_param(k) and k != "device" and v is not None})
    if device is not None:
        stage.set(device=device)
    return stage
