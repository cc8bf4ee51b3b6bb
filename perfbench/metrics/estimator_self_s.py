"""``estimator_self_s``: seconds of a fit outside ingest and the boosting
loop: the pipeline layer's fit span less its ``gbdt.ingest`` and
``gbdt.boost`` spans (the label scan, the arrays' extraction, the binned
cache's fingerprint, the booster's telemetry); the mean over the window's
unprofiled fits."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls:
        return None
    return sum(c["dur"] / 1e6 - s.seconds(c, "gbdt.ingest")
               - s.seconds(c, "gbdt.boost") for s, c, _ in calls) / len(calls)
