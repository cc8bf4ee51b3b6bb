"""Back-to-back fits of the configuration's estimator on host rows.

The mix (``traffic/<mix>.json``): ``warmup_iterations`` (the set-up's fit,
at the cell's shapes), ``cold_cache`` (empty the binned-dataset cache before
every fit, so each fit bins its rows anew, as a new training job does).
The window starts fits until ``--seconds`` have passed and counts each
whole: ``fit_s`` is the time the fits span over their number. A traced run
profiles one more fit first, before the window, of the configuration's
``trace.profiled_iterations`` rounds (a stretch of a long fit keeps the
trace small enough to read within the run).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.seeds import numpy_stream
from perfbench.reference import gbdt, lgbm_text
from perfbench.trace import DeviceTrace


def _estimator(run, **extra):
    params = dict(run.config["params"], device=str(run.device), **extra)
    return harness.named(run.config["estimator"])(**params)


def _counts(hist_ops, scatter) -> dict:
    return dict(kernel1=hist_ops.node_histogram.launches,
                kernel2=hist_ops.node_histogram.int8_launches,
                det=hist_ops.node_histogram.det_launches,
                cols=hist_ops.histogram_cols.launches,
                plain=scatter.node_hist_plain.calls + scatter.hist_plain.calls)


def _reset_counts(hist_ops, scatter) -> None:
    hist_ops.node_histogram.launches = 0
    hist_ops.node_histogram.int8_launches = 0
    hist_ops.node_histogram.det_launches = 0
    hist_ops.histogram_cols.launches = 0
    scatter.node_hist_plain.calls = 0
    scatter.hist_plain.calls = 0


def setup(run):
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.models.gbdt import api
    d = run.config["data"]
    gen = run.datagen()
    X, y = gen.draw(d["rows"], run.seed, 0, run.device)
    Xh, yh = gen.draw(d["holdout_rows"], run.seed, 1, run.device)
    X, y, Xh = X.cpu().numpy(), y.cpu().numpy(), Xh.cpu().numpy()
    del yh
    train = Dataset({"features": X, "label": y})
    warm = _estimator(run, numIterations=run.traffic["warmup_iterations"])
    api.clear_binned_dataset_cache()
    warm.fit(train)
    run.sync()
    return dict(X=X, y=y, Xh=Xh, train=train, est=_estimator(run),
                profiled=_estimator(run, numIterations=run.config["trace"][
                    "profiled_iterations"]))


@contextlib.contextmanager
def _layer_clocks(run, sink):
    """Time the calls into ingest (``LightGBMDataset.construct``) and the
    boosting loop (``train_booster`` as the estimator calls it), each up to
    the device's end, under profiler annotations of the same names."""
    from mmlspark_tpu_torch.models.gbdt import api, booster
    cls = booster.LightGBMDataset
    construct, train = cls.__dict__["construct"], api.train_booster

    def timed(name, fn):
        def call(*a, **k):
            with torch.profiler.record_function(f"perfbench.{name}"):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                run.sync()
                sink.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    cls.construct = classmethod(timed("ingest", construct.__func__))
    api.train_booster = timed("boost", train)
    try:
        yield
    finally:
        cls.construct = construct
        api.train_booster = train


def window(run, st):
    from mmlspark_tpu_torch.models.gbdt import api
    from mmlspark_tpu_torch.ops import histogram as hist_ops
    from mmlspark_tpu_torch.ops import histogram_scatter as scatter
    est, train = st["est"], st["train"]
    clocks: dict = {}
    fits = []
    _reset_counts(hist_ops, scatter)
    api.binned_cache_stats(reset=True)
    layer = (_layer_clocks(run, clocks) if run.tracing
             else contextlib.nullcontext())

    def one_fit(profiled: bool) -> None:
        if run.traffic["cold_cache"]:
            api.clear_binned_dataset_cache()
        tracer = DeviceTrace(run.device) if profiled else None
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            with tracer or contextlib.nullcontext():
                model = (st["profiled"] if profiled else est).fit(train)
                run.sync()
                t1 = time.perf_counter()        # before the profiler stops
        except Exception as e:  # noqa: BLE001 — a failed fit is counted
            run.failed += 1
            run.say(f"fit {len(fits)} failed: {type(e).__name__}: {e}")
            return
        fits.append(dict(seconds=t1 - t0, booster=model.booster,
                         profiled=profiled))
        if profiled:
            run.trace = tracer

    with layer:
        if run.tracing:
            one_fit(True)
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < run.seconds:
            one_fit(False)
    t_end = time.perf_counter()
    counts = _counts(hist_ops, scatter)
    cache = api.binned_cache_stats()
    trees = sum(f["booster"].num_trees for f in fits)
    run.say(f"{len(fits)} fits in {t_end - t_start:.3f} s: "
            + ", ".join(f"{f['seconds']:.3f}" for f in fits)
            + f"; {trees} trees")
    run.say(f"launches: kernel 1 {counts['kernel1']}, kernel 2 "
            f"{counts['kernel2']}, deterministic {counts['det']}, kernel 3 "
            f"{counts['cols']}, plain versions {counts['plain']}; binned "
            f"cache {cache['misses']} misses, {cache['hits']} hits")
    timed = [f for f in fits if not f["profiled"]]
    if timed:
        run.e2e["fit_s"] = (t_end - t_start) / len(timed)
    run.layer.update(fits=fits, counts=counts, cache=cache, clocks=clocks,
                     trees=trees, rows=run.config["data"]["rows"],
                     features=st["X"].shape[1],
                     max_bin=int(run.config["params"]["maxBin"]))


def check(run, st):
    """The last fit against the reference: its bins, a seeded sample of its
    boosting rounds (round 0 always), and held-out margins."""
    from mmlspark_tpu_torch.models.gbdt import api
    lim = run.limits
    fits = run.layer["fits"]
    out = []
    cuda = run.device.type == "cuda"
    if cuda:
        counts, cache = run.layer["counts"], run.layer["cache"]
        kernel = run.config["check"]["kernel_counter"]
        out += [harness.check(f"{kernel}_launches", counts[kernel], ">=", 1),
                harness.check("plain_calls", counts["plain"], "<=", 0)]
        if run.traffic["cold_cache"]:
            out += [harness.check("cache_hits", cache["hits"], "<=", 0),
                    harness.check("cache_misses", cache["misses"], "==",
                          run.attempted)]
    if not fits:
        return out
    booster = fits[-1]["booster"]
    text = booster.to_lightgbm_string()
    prog_bounds = np.asarray(booster.binner_state["upper_bounds"])
    ds = next(reversed(api._BINNED_CACHE.values()))
    n = st["X"].shape[0]
    prog_bins = ds.Xbt[:, :n]
    st.pop("est")
    st.pop("profiled")
    st.pop("train")
    api.clear_binned_dataset_cache()
    del ds
    lr = gbdt.Learner.from_config(run.config)
    bounds = gbdt.bin_bounds(st["X"], lr)
    X = torch.from_numpy(st["X"]).to(run.device)
    bins = gbdt.apply_bins(X, bounds)
    del X
    off = int((bounds != prog_bounds).sum()) if (
        bounds.shape == prog_bounds.shape) else bounds.size
    off += int((prog_bins.to(torch.int32) != bins.to(torch.int32)).sum())
    del prog_bins
    if cuda:
        torch.cuda.empty_cache()
    model = _with_float_counts(lgbm_text.parse(text), booster)
    R = len(model.trees) // lr.num_class
    k = int(run.config["check"]["rounds"]) - 1
    rng = numpy_stream(run.seed, 2)
    later = (rng.choice(np.arange(2, R), size=min(k, max(R - 2, 0)),
                        replace=False) if R > 2 else [])
    rounds = [0] + sorted(int(r) for r in later)
    y = torch.from_numpy(st["y"]).to(run.device)
    read = gbdt.audit_fit(
        model, bins, bounds, y, lr, rounds,
        run.config["control"]["leaf_stats"] if run.control else None)
    del bins, y
    Xh = torch.from_numpy(st["Xh"]).to(run.device)
    read["margin_err"] = gbdt.margin_gap(
        model, Xh, booster.predict_raw(st["Xh"], device=str(run.device)))
    read["bins_off"] = off
    run.say(f"audited rounds {rounds} of the last fit")
    for name in ("bins_off", "counts_off", "splits_off", "gain_gap",
                 "left_gain", "leaf_err", "margin_err"):
        out.append(harness.check(name, read[name], "<=", lim[name]))
    return out


def _with_float_counts(model, booster):
    """``model`` with each tree's node counts taken from the fitted
    booster's own arrays (float32 sums of its count channel) in the text's
    node order: the text truncates them to integers, so a count a hair
    under a whole number is written one row short."""
    trees = booster.trees
    for t, tree in enumerate(model.trees):
        n = int(np.asarray(trees["node_count"])[t])
        leaf = np.asarray(trees["is_leaf"])[t][:n]
        cnt = np.asarray(trees["node_cnt"], np.float64)[t][:n]
        tree.internal_count = cnt[~leaf]
        tree.leaf_count = cnt[leaf]
    return model
