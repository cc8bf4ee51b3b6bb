"""Serving worker wiring: build a worker's query from a saved model.

Counterpart of the model wiring of ``mmlspark_tpu/io/serving_main.py``:
:func:`_load_booster`, :func:`_load_transform` and
:func:`_build_async_query` turn a ``.npz`` booster, a LightGBM ``.txt``
model or a saved port pipeline into the transform or async query a
serving worker runs. The CLI (``main()`` with its worker and gateway
roles, the service registry and the gateway) is not ported yet.

Like every port entry point these take ``device`` (``None`` -> ``cuda``;
``"cpu"`` only when asked). Every model is warmed before the query is
returned — one predict of one row on the worker's device — so the forest
upload and CUDA's start-up land before the caller starts the query and
flips ``serving.set_ready(True)``, not on the first requests.

    args = worker_args("model.npz", host="localhost", port=0)
    query, booster = _build_async_query(args)
    query.start()
    serving.set_ready(True)
"""

from __future__ import annotations

import argparse
from typing import Any

from ..device import DeviceLike, resolve_device


def worker_args(model: str, **overrides: Any) -> argparse.Namespace:
    """A worker's settings with the JAX worker CLI's defaults (``host``
    ``0.0.0.0``, ``port`` 0, ``api_name`` ``serving``, ``input_col``
    ``features``, ``output_col`` ``prediction``, ``max_batch`` 32,
    ``max_latency_ms`` 5, ``max_queue_depth`` None), overridden by
    keyword."""
    args = argparse.Namespace(
        model=model, host="0.0.0.0", port=0, api_name="serving",
        input_col="features", output_col="prediction", max_batch=32,
        max_latency_ms=5.0, max_queue_depth=None)
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise TypeError(f"unknown worker setting {k!r}")
        setattr(args, k, v)
    return args


def _load_booster(model_path: str, booster_cls):
    if model_path.endswith(".npz"):
        return booster_cls.load(model_path)
    with open(model_path) as f:
        return booster_cls.from_string(f.read())


def _warm(booster, pdt: str, device) -> None:
    """One predict of one row of zeros in lane ``pdt`` on ``device``:
    uploads the lane's forest and starts CUDA on the calling thread."""
    import numpy as np

    width = int(booster.num_features)
    booster.predict(np.zeros((1, width), np.float32), device=device,
                    predict_dtype=pdt)


def _set_device(model, device) -> None:
    """Point every stage of a loaded pipeline that has a ``device`` Param
    at ``device``."""
    for stage in [model, *getattr(model, "stages", [])]:
        if hasattr(stage, "has_param") and stage.has_param("device"):
            stage.set(device=str(device))


def _load_transform(model_path: str, input_col: str, output_col: str,
                    max_batch: int = 64, device: DeviceLike = None):
    """``(transform, model)`` — the model object rides along so a caller
    can reuse it instead of parsing the file twice."""
    import numpy as np

    from .http import to_jsonable
    from .serving import make_reply

    dev = resolve_device(device)
    # LightGBM native model string, or this package's .npz persistence —
    # .npz keeps the binner grid a .txt roundtrip loses, so it is the
    # format the int8 lane serves without degrading to f32
    if model_path.endswith((".txt", ".npz")):
        from ..models.gbdt.booster import Booster
        from .serving import set_predict_dtype
        booster = _load_booster(model_path, Booster)
        # pin the predict lane ONCE at startup (env + capability degrades
        # resolve here, not per request) and surface it on /varz
        pdt = booster.resolved_predict_dtype()
        set_predict_dtype(pdt)
        _warm(booster, pdt, dev)

        def transform(ds):
            rows = np.asarray([v[input_col] for v in ds["value"]], np.float32)
            preds = booster.predict(rows, device=dev, predict_dtype=pdt)
            return ds.with_column("reply", [
                make_reply({output_col: to_jsonable(p)}) for p in preds])

        return transform, booster

    from ..core.pipeline import load_stage
    from .serving import bucketed_model_transform
    model = load_stage(model_path)
    if device is not None:
        _set_device(model, dev)

    def transform(ds):
        rows = [v[input_col] for v in ds["value"]]
        vals = bucketed_model_transform(model, rows, input_col, output_col,
                                        max_batch)
        return ds.with_column("reply", [
            make_reply({output_col: to_jsonable(v)}) for v in vals])

    return transform, model


def _build_async_query(args, device: DeviceLike = None):
    """``(query, model)`` for an async-engine worker: a ``.txt``/``.npz``
    booster rides the zero-copy rows path (requests decode straight into
    the slot table in the lane's staged dtype, pinned for ``cuda``; one
    upload per device dispatch); saved pipelines keep the Dataset
    transform contract on the same event-loop front. ``args`` carries the
    worker's settings (:func:`worker_args`)."""
    from .aserve import AsyncServingQuery, AsyncServingServer
    from .aserve.server import RowSpec
    from .http import to_jsonable

    dev = resolve_device(device)
    if args.model.endswith((".txt", ".npz")):
        from ..models.gbdt import quantize as _quantize
        from ..models.gbdt.booster import Booster
        from .serving import set_predict_dtype
        booster = _load_booster(args.model, Booster)
        width = int(booster.binner_state.get("num_features") or 0)
        if width > 0:
            # the quantized admission path: resolve the lane once, decode
            # request rows straight into narrow staged slots (the slot
            # table's quantizer), and score with the matching lane — the
            # staged dtype goes up as it is, so the one upload per
            # dispatch ships narrow bytes
            pdt = booster.resolved_predict_dtype()
            set_predict_dtype(pdt)
            _warm(booster, pdt, dev)
            quantizer = _quantize.row_quantizer(
                pdt, _quantize.feature_bounds(booster.binner_state)
                if pdt == "int8" else None)
            server = AsyncServingServer(
                args.host, args.port, args.api_name,
                max_queue_depth=args.max_queue_depth,
                slots=args.max_batch,
                row_spec=RowSpec(width, extract=args.input_col,
                                 dtype=_quantize.staging_dtype(pdt),
                                 quantizer=quantizer,
                                 pin_memory=dev.type == "cuda"))

            def scorer(X):
                return booster.predict(X, device=dev, predict_dtype=pdt)

            out_col = args.output_col
            return AsyncServingQuery(
                server, scorer=scorer,
                reply_fn=lambda req, p: {out_col: to_jsonable(p)}), booster
    transform, model = _load_transform(args.model, args.input_col,
                                       args.output_col,
                                       max_batch=args.max_batch,
                                       device=device)
    server = AsyncServingServer(args.host, args.port, args.api_name,
                                max_queue_depth=args.max_queue_depth,
                                slots=args.max_batch)
    return AsyncServingQuery(server, transform=transform), model
