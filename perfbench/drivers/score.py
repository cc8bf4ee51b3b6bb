"""Batch scoring: ``transform`` on partitions of host rows, one after
another, with a model the user brings as LightGBM text.

The mix (``traffic/<mix>.json``): ``partition_rows`` a call, ``chunks``
distinct seeded partitions taken in turn, ``warmup_calls`` in the set-up,
``checked_calls`` call indices drawn from the seed (below
``checked_below``) whose outputs are kept and checked with the last call's,
and ``profiled_calls`` (from ``profile_from`` on) that a traced run
profiles. The model is drawn from the seed: ``numIterations`` trees of at
most ``numLeaves`` leaves, thresholds at quantiles of ``model_sample_rows``
rows of the first partition.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.seeds import numpy_stream
from perfbench.forest_text import forest_text
from perfbench.reference import forest, lgbm_text
from perfbench.trace import DeviceTrace


def setup(run):
    from mmlspark_tpu_torch.core.dataset import Dataset
    tr, p = run.traffic, run.config["params"]
    rows = int(tr["partition_rows"])
    X, _ = run.datagen().draw(rows * int(tr["chunks"]), run.seed, 2,
                              run.device)
    X = X.cpu().numpy()
    chunks = [X[i * rows:(i + 1) * rows] for i in range(int(tr["chunks"]))]
    text = forest_text(chunks[0][:int(tr["model_sample_rows"])],
                       int(p["numIterations"]), int(p["numLeaves"]), run.seed)
    fd, path = tempfile.mkstemp(suffix=".txt", prefix="perfbench-model-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        model = harness.named(
            run.config["score_model"]).load_native_model(path)
    finally:
        os.remove(path)
    model.set(device=str(run.device))
    saved = {}
    if run.control:
        saved = {k: os.environ.get(k) for k in run.config["control"]["env"]}
        os.environ.update(run.config["control"]["env"])
    parts = [Dataset({"features": c}) for c in chunks]
    for i in range(int(tr["warmup_calls"])):
        model.transform(parts[i % len(parts)])
    return dict(model=model, text=text, chunks=chunks, parts=parts,
                saved_env=saved)


def window(run, st):
    tr = run.traffic
    model, parts = st["model"], st["parts"]
    rng = numpy_stream(run.seed, 3)
    keep = set(int(i) for i in rng.choice(int(tr["checked_below"]),
                                          int(tr["checked_calls"]),
                                          replace=False))
    first, count = int(tr["profile_from"]), int(tr["profiled_calls"])
    times, kept, profiled_rows = [], {}, 0
    tracer = DeviceTrace(run.device) if run.tracing else None
    out = None
    i = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < run.seconds:
        part = parts[i % len(parts)]
        profiled = tracer is not None and first <= i < first + count
        if profiled and i == first:
            tracer.__enter__()
            run.trace = tracer
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            out = model.transform(part)
        except Exception as e:  # noqa: BLE001 — a failed call is counted
            run.failed += 1
            out = None
            run.say(f"call {i} failed: {type(e).__name__}: {e}")
        t1 = time.perf_counter()
        if profiled and i == first + count - 1:
            tracer.__exit__(None, None, None)
        if out is not None:
            times.append(t1 - t0)
            profiled_rows += len(part) if profiled else 0
            if i in keep:
                kept[i] = out.array("probability")
        i += 1
    t_end = time.perf_counter()
    if run.trace is not None and first < i < first + count:
        tracer.__exit__(None, None, None)     # the window closed mid-stretch
    if out is not None:
        kept[i - 1] = out.array("probability")
    rows = len(parts[0]) * len(times)
    run.say(f"{len(times)} calls in {t_end - t_start:.3f} s; call ms "
            f"median {1e3 * float(np.median(times)) if times else 0:.3f}")
    if times:
        run.e2e["score_rows_per_s"] = rows / (t_end - t_start)
        run.e2e["score_p95_ms"] = 1e3 * float(np.percentile(times, 95))
    run.layer.update(calls=len(times), call_s=times, kept=kept,
                     profiled_rows=profiled_rows)


def check(run, st):
    """Every kept call's probabilities against the reference's traversal of
    the same model text over the same partition."""
    kept = run.layer["kept"]
    chunks = st["chunks"]
    st.pop("model")
    st.pop("parts")
    for k, v in st["saved_env"].items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    model = lgbm_text.parse(st["text"])
    err = 0.0
    for c in sorted({i % len(chunks) for i in kept}):
        X = torch.from_numpy(chunks[c]).to(run.device)
        m = forest.margins(model, X)
        ref = (torch.softmax(m, dim=1) if model.num_class > 1
               else torch.cat([1 - torch.sigmoid(m), torch.sigmoid(m)], 1))
        ref = ref.cpu().numpy()
        for i, got in kept.items():
            if i % len(chunks) == c:
                err = max(err, float(np.abs(got - ref).max()))
        del X, m
    return [harness.check("calls_checked", len(kept), ">=", 1),
            harness.check("prob_err", err, "<=", run.limits["prob_err"])]
