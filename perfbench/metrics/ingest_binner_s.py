"""``ingest_binner_s``: host seconds a fit spends fitting the quantile
binner (the port's ``gbdt.ingest.binner_fit`` span, on the host's rows);
the mean over the window's unprofiled fits."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls:
        return None
    return (sum(s.seconds(c, "gbdt.ingest.binner_fit") for s, c, _ in calls)
            / len(calls))
