"""``boost_span_ms_per_tree``: milliseconds a tree in the port's
``gbdt.boost`` span (``train_booster`` from its dataset to the booster,
whose read-back waits for the device), over the window's unprofiled fits'
trees."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls or not span_tree.trees(calls):
        return None
    return (1e3 * sum(s.seconds(c, "gbdt.boost") for s, c, _ in calls)
            / span_tree.trees(calls))
