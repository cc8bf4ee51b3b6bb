"""Deployment entry point: run a serving worker or gateway from the CLI.

Counterpart of ``mmlspark_tpu/io/serving_main.py``:

    python -m mmlspark_tpu_torch.io.serving_main worker \
        --model /models/m.npz --registry /mnt/registry --port 8900
    python -m mmlspark_tpu_torch.io.serving_main gateway \
        --registry /mnt/registry --port 8898

Workers load a ``.npz`` booster, a LightGBM ``.txt`` model or a saved
port pipeline, serve it with micro-batching on the card (``--device``,
default ``cuda``), and register into the shared file-backed
``ServiceRegistry``; any number of gateways load-balance over whatever
the registry holds. :func:`_load_booster`, :func:`_load_transform` and
:func:`_build_async_query` are the model wiring both roles' tests drive
in process.

Like every port entry point these take ``device`` (``None`` -> ``cuda``;
``"cpu"`` only when asked). Every booster is warmed before the query is
returned — its forest uploaded to the worker's device — so the upload and
CUDA's start-up land before the caller starts the query and flips
``serving.set_ready(True)``, not on the first requests.

    args = worker_args("model.npz", host="localhost", port=0)
    query, booster = _build_async_query(args)
    query.start()
    serving.set_ready(True)
"""

from __future__ import annotations

import argparse
import signal
import threading
import uuid
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
    """Upload the full model's forest arguments in lane ``pdt`` to
    ``device`` (starting CUDA on the calling thread). No predict program
    is built here: a bundle's prewarm captures the programs, else each
    batch bucket is captured on its first request."""
    dev = resolve_device(device)
    booster.predict_plan_args(booster.predict_plan(1, predict_dtype=pdt),
                              dev)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mmlspark_tpu_torch.io.serving_main")
    sub = p.add_subparsers(dest="role", required=True)

    w = sub.add_parser("worker", help="serve a model + register")
    w.add_argument("--model", required=True,
                   help="saved pipeline dir, LightGBM .txt model, or "
                        "native .npz booster (the format that serves "
                        "the int8 lane without degrading)")
    w.add_argument("--registry", required=True,
                   help="shared registry directory")
    w.add_argument("--engine", choices=["threaded", "async"], default=None,
                   help="serving engine (default: "
                        "MMLSPARK_TPU_SERVING_ENGINE or async). "
                        "async = io/aserve event loop with continuous "
                        "batching; .txt/.npz booster models additionally "
                        "get zero-copy slot-table admission")
    w.add_argument("--device", default=None,
                   help="device the worker scores on (default cuda; cpu "
                        "only when asked)")
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--advertise-host", default=None,
                   help="address other hosts reach this worker at "
                        "(default: --host)")
    w.add_argument("--port", type=int, default=0)
    w.add_argument("--api-name", default="serving")
    w.add_argument("--input-col", default="features")
    w.add_argument("--output-col", default="prediction")
    w.add_argument("--max-batch", type=int, default=32)
    w.add_argument("--max-latency-ms", type=float, default=5.0)
    w.add_argument("--bundle", default=None,
                   help="serving-bundle directory whose predict graphs "
                        "are captured before binding (default: "
                        "MMLSPARK_TPU_BUNDLE_DIR; see `python -m "
                        "mmlspark_tpu_torch.bundles build`). /healthz "
                        "reports ready:false until the prewarm completes, "
                        "and the worker registers with the gateway only "
                        "after")
    w.add_argument("--max-queue-depth", type=int, default=None,
                   help="shed (429 + Retry-After) above this many queued "
                        "requests (default: MMLSPARK_TPU_MAX_QUEUE_DEPTH "
                        "or 512; 0 = unbounded)")
    w.add_argument("--drain-settle-seconds", type=float, default=None,
                   help="after SIGTERM + deregistration, keep serving "
                        "this long while gateways drop us from their "
                        "routing tables (default: "
                        "MMLSPARK_TPU_DRAIN_SETTLE_SECONDS or 0.5)")
    w.add_argument("--drain-timeout", type=float, default=None,
                   help="seconds to finish queued + in-flight work on "
                        "SIGTERM (default: "
                        "MMLSPARK_TPU_DRAIN_TIMEOUT_SECONDS or 30)")

    g = sub.add_parser("gateway", help="load-balance over registry workers")
    g.add_argument("--registry", required=True)
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--port", type=int, default=8898)
    g.add_argument("--api-name", default="serving")

    for role_parser in (w, g):
        role_parser.add_argument(
            "--slow-request-seconds", type=float, default=None,
            help="slow-request exemplar threshold (default: "
                 "MMLSPARK_TPU_SLOW_REQUEST_SECONDS or 1.0)")
        role_parser.add_argument(
            "--flight-dir", default=None,
            help="directory for flight-recorder dumps on crash or SIGUSR2 "
                 "(default: MMLSPARK_TPU_FLIGHT_DIR or the system temp dir)")

    args = p.parse_args(argv)
    # a worker without its device fails before it touches any process
    # state (signal handlers, the flight recorder)
    dev = resolve_device(args.device) if args.role == "worker" else None

    from ..observability import flight as _flight
    from ..observability import logging as _logging
    from ..observability import tracing as _tracing
    from .distributed_serving import (GatewayServer, ServiceRegistry,
                                      WorkerInfo)
    from .serving import ServingQuery, ServingServer

    # arm the flight recorder: SIGUSR2 pokes a live dump out of a wedged
    # process, the excepthook catches the dying one
    if args.flight_dir:
        import os
        os.environ["MMLSPARK_TPU_FLIGHT_DIR"] = args.flight_dir
    if args.slow_request_seconds is not None:
        _tracing.set_slow_threshold(args.slow_request_seconds)
    _flight.set_default_fields(role=args.role)
    _logging.set_default_fields(role=args.role)
    _flight.install()
    log = _logging.get_logger("mmlspark_tpu_torch.io.serving_main")

    registry = ServiceRegistry(args.registry)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())

    if args.role == "worker":
        import os

        from .aserve import resolve_engine
        from .serving import set_ready
        engine = resolve_engine(args.engine)
        # readiness gate DOWN before any model or bundle work: a probe
        # that reaches this worker early reads ready:false, and no gateway
        # routes here because registration happens last
        set_ready(False)
        bundle_dir = args.bundle or \
            (os.environ.get("MMLSPARK_TPU_BUNDLE_DIR") or "").strip()

        def maybe_prewarm(model) -> None:
            # prewarm BEFORE binding: the predictor cache fills from the
            # bundle (graphs captured), or degrades loudly to capture on
            # first use; the just-loaded model rides along
            if bundle_dir:
                from ..bundles import boosters_of, prewarm
                prewarm(args.model, bundle_dir,
                        boosters=boosters_of(model), device=dev)

        if engine == "async":
            # the async server binds at start(), safely after prewarm
            query, model = _build_async_query(args, device=dev)
            server = query.server
            maybe_prewarm(model)
        else:
            # ServingServer binds at CONSTRUCTION — build it only after
            # the prewarm, so nothing connects into a cold worker's
            # accept backlog
            transform, model = _load_transform(args.model, args.input_col,
                                               args.output_col,
                                               max_batch=args.max_batch,
                                               device=dev)
            maybe_prewarm(model)
            server = ServingServer(args.host, args.port, args.api_name,
                                   max_queue_depth=args.max_queue_depth)
            query = ServingQuery(server, transform,
                                 max_batch=args.max_batch,
                                 max_latency=args.max_latency_ms / 1000.0)
        advertise = args.advertise_host or args.host
        if advertise in ("0.0.0.0", "::"):
            # a wildcard bind address is not reachable from other hosts
            import socket
            advertise = socket.gethostname()
        # start BEFORE building the registry entry: the async engine
        # binds its socket (and learns an ephemeral port) at start()
        query.start()
        # ready only once warmed AND bound; registration strictly after
        set_ready(True)
        info = WorkerInfo(worker_id=uuid.uuid4().hex[:12],
                          host=advertise,
                          port=server.port, api_name=args.api_name)
        registry.register(info)
        # console, not the JSON funnel: orchestration parses this line
        _logging.console(f"worker {info.worker_id} serving on "
                         f"{server.host}:{server.port}")
        log.info("worker ready", worker_id=info.worker_id,
                 host=server.host, port=server.port, model=args.model,
                 device=str(dev))
        try:
            stop.wait()
        finally:
            # graceful drain: deregister FIRST, keep serving through the
            # settle window, then refuse new traffic and finish every
            # queued request and in-flight batch
            registry.deregister(info.worker_id)
            stats = query.drain(
                settle_seconds=args.drain_settle_seconds,
                timeout=args.drain_timeout)
            _logging.console(f"worker {info.worker_id} drained")
            log.info("worker drained", worker_id=info.worker_id, **stats)
        return 0

    gateway = GatewayServer(registry, args.host, args.port, args.api_name)
    gateway.start()
    _logging.console(f"gateway on {gateway.host}:{gateway.port}")
    log.info("gateway ready", host=gateway.host, port=gateway.port,
             registry=args.registry)
    try:
        stop.wait()
    finally:
        gateway.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
