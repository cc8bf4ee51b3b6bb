"""``rank_launches_per_tree``: the launches of the port's LambdaRank
kernel (``lambdarank_cuda.launches``, as each ``gbdt.round`` span records
its change as ``rank_launches``) over the trees of the window's unprofiled
fits. None where no round carries the count (a program without the
kernel)."""

from perfbench import span_tree


def read(run):
    calls = span_tree.window_fits(run)
    if not calls or not span_tree.trees(calls):
        return None
    rounds = [r for s, c, _ in calls for r in s.below(c, "gbdt.round")]
    if not rounds or any("rank_launches" not in r["args"] for r in rounds):
        return None
    return sum(r["args"]["rank_launches"] for r in rounds) / (
        span_tree.trees(calls))
