"""``boost_ms_per_tree``: milliseconds a tree in ``train_booster`` (the
boosting loop and growth, the call the estimator makes after ingest), on
the benchmark's clock around that call up to the device's end; over the
window's unprofiled fits."""


def read(run):
    spans = run.layer.get("clocks", {}).get("boost") or []
    fits = run.layer.get("fits") or []
    if not spans or len(spans) != len(fits):
        return None
    keep = list(range(1, len(fits))) or [0]
    trees = sum(fits[i]["booster"].num_trees for i in keep)
    return 1e3 * sum(spans[i] for i in keep) / trees if trees else None
