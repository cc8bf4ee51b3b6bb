"""``ingest_span_s``: seconds a fit spends in the port's ``gbdt.ingest``
span (``LightGBMDataset.construct``, which waits for its copies to the
device); the mean over the window's unprofiled fits."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls:
        return None
    return sum(s.seconds(c, "gbdt.ingest") for s, c, _ in calls) / len(calls)
