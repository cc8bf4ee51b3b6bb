"""``host_syncs_per_tree``: the host's blocking reads of device values
(the port's ``growth.host_syncs``, as each ``gbdt.round`` span records its
change) over the trees of the window's unprofiled fits."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls or not span_tree.trees(calls):
        return None
    rounds = [r for s, c, _ in calls for r in s.below(c, "gbdt.round")]
    if not rounds or any("host_syncs" not in r["args"] for r in rounds):
        return None
    return sum(r["args"]["host_syncs"] for r in rounds) / span_tree.trees(
        calls)
