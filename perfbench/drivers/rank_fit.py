"""Back-to-back ``LightGBMRanker`` fits of one judged query log.

The mix (``traffic/<mix>.json``) takes ``fit.py``'s keys, and the window is
``fit.py``'s: fits started until ``--seconds`` have passed, each counted
whole, ``fit_s`` the time they span over their number. The rows carry a
query column (rows grouped by query, any length). Set-up fits
``warmup_iterations`` rounds and then requires the binned-dataset cache to
hold one dataset of exactly the configuration's rows: a ranker that pads,
drops or copies its rows elsewhere stops the run there. With the cache warm
(``cold_cache`` false) every timed fit must be a cache hit, which the check
counts. The check holds the last fit to ``reference/lambdarank.py``: the
bins, the trees of round 0 and two seeded later rounds audited against the
reference's float64 lambdas, the program's own lambdas at those rounds'
margins (``lambda_err``), and held-out margins.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import harness
from perfbench.drivers import fit as fit_driver
from perfbench.reference import gbdt, lambdarank, lgbm_text
from perfbench.seeds import numpy_stream


def _rank_launches() -> int:
    """Launches of the program's LambdaRank lambdas: the kernel's on the
    card, the plain version's calls on the CPU."""
    from mmlspark_tpu_torch.models.gbdt import objectives
    from mmlspark_tpu_torch.ops import lambdarank as rank_ops
    return (rank_ops.lambdarank_cuda.launches
            + objectives.lambdarank_plain.calls)


def setup(run):
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.models.gbdt import api
    d = run.config["data"]
    gen = run.datagen()
    X, y, q = gen.draw(d["rows"], d["queries"], run.seed, 0, run.device)
    Xh, _, _ = gen.draw(d["holdout_rows"], d["holdout_queries"], run.seed, 1,
                        run.device)
    X, y, Xh = X.cpu().numpy(), y.cpu().numpy(), Xh.cpu().numpy()
    group = run.config["params"]["groupCol"]
    train = Dataset({"features": X, "label": y, group: q})
    warm = fit_driver._estimator(
        run, numIterations=run.traffic["warmup_iterations"])
    api.clear_binned_dataset_cache()
    warm.fit(train)
    run.sync()
    held = [int(ds.n) for ds in api._BINNED_CACHE.values()]
    if held != [d["rows"]]:
        raise SystemExit(
            f"perfbench: after the warm-up fit the binned-dataset cache holds "
            f"{len(held)} dataset(s) of {held} rows, not one of the "
            f"{d['rows']} training rows: the ranker does not fit its query "
            f"groups whole through the cache")
    offsets = np.r_[np.flatnonzero(np.r_[True, q[1:] != q[:-1]]), q.size]
    run.layer.update(offsets=offsets, labels=y)
    return dict(X=X, y=y, offsets=offsets, Xh=Xh, train=train,
                est=fit_driver._estimator(run),
                profiled=fit_driver._estimator(run, numIterations=run.config[
                    "trace"]["profiled_iterations"]))


def window(run, st):
    before = _rank_launches()
    fit_driver.window(run, st)
    run.layer["rank_launches"] = _rank_launches() - before


def check(run, st):
    """The cache hits and launches, then the last fit against the
    reference."""
    from mmlspark_tpu_torch.models.gbdt import api
    from mmlspark_tpu_torch.models.gbdt.objectives import get_objective
    lim = run.limits
    fits = run.layer["fits"]
    cache = run.layer["cache"]
    out = [harness.check("cache_hits", cache["hits"], ">=", run.attempted),
           harness.check("cache_misses", cache["misses"], "<=", 0),
           # one launch a round
           harness.check("rank_launches", run.layer["rank_launches"], "==",
                         run.layer["trees"])]
    if run.device.type == "cuda":
        counts = run.layer["counts"]
        kernel = run.config["check"]["kernel_counter"]
        out += [harness.check(f"{kernel}_launches", counts[kernel], ">=", 1),
                harness.check("plain_calls", counts["plain"], "<=", 0)]
    if not fits:
        return out
    booster = fits[-1]["booster"]
    text = booster.to_lightgbm_string()
    prog_bounds = np.asarray(booster.binner_state["upper_bounds"])
    ds = next(reversed(api._BINNED_CACHE.values()))
    n = st["X"].shape[0]
    prog_bins = ds.Xbt[:, :n]
    objective = get_objective("lambdarank", queries=ds.queries,
                              **booster.objective_kwargs)
    y_prog, w_prog = ds.y, ds.w

    def program(scores: torch.Tensor):
        return objective.grad_hess(scores.to(run.device).contiguous(),
                                   y_prog, w_prog)

    for key in ("est", "profiled", "train"):
        st.pop(key)
    lr = gbdt.Learner.from_config(run.config)
    bounds = gbdt.bin_bounds(st["X"], lr)
    X = torch.from_numpy(st["X"]).to(run.device)
    bins = gbdt.apply_bins(X, bounds)
    del X
    off = int((bounds != prog_bounds).sum()) if (
        bounds.shape == prog_bounds.shape) else bounds.size
    off += int((prog_bins.to(torch.int32) != bins.to(torch.int32)).sum())
    del prog_bins
    model = fit_driver._with_float_counts(lgbm_text.parse(text), booster)
    R = len(model.trees)
    k = int(run.config["check"]["rounds"]) - 1
    rng = numpy_stream(run.seed, 2)
    later = (rng.choice(np.arange(2, R), size=min(k, max(R - 2, 0)),
                        replace=False) if R > 2 else [])
    rounds = [0] + sorted(int(r) for r in later)
    kw = booster.objective_kwargs
    read = lambdarank.audit_fit(
        model, bins, bounds, torch.from_numpy(st["y"]).to(run.device),
        st["offsets"], lr, rounds, int(kw.get("max_position", 20)),
        float(kw.get("sigma", 1.0)), kw.get("label_gain"), program,
        run.config["control"]["lambdas"] if run.control else None)
    del bins, objective, ds
    api.clear_binned_dataset_cache()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    Xh = torch.from_numpy(st["Xh"]).to(run.device)
    read["margin_err"] = gbdt.margin_gap(
        model, Xh, booster.predict_raw(st["Xh"], device=str(run.device)))
    read["bins_off"] = off
    run.say(f"audited rounds {rounds} of the last fit")
    for name in ("bins_off", "counts_off", "splits_off", "gain_gap",
                 "left_gain", "leaf_err", "lambda_err", "margin_err"):
        out.append(harness.check(name, read[name], "<=", lim[name]))
    return out
