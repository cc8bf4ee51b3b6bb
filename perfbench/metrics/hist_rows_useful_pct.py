"""``hist_rows_useful_pct``: the rows the profiled fit's trees need
histogrammed (``work.hist_rows`` of its model text: each root and, per
split, the smaller child) over the rows its rounds handed to the histogram
kernels' launches (the ``hist_rows`` change each ``gbdt.round`` span
records), in %."""

from perfbench import span_tree, work
from perfbench.reference import lgbm_text


def read(run):
    calls = span_tree.fit_calls(run)
    if not calls or not calls[0][2]["profiled"]:
        return None
    spans, call, fit = calls[0]
    rounds = spans.below(call, "gbdt.round")
    handed = sum(r["args"].get("hist_rows", 0) for r in rounds)
    if handed <= 0:
        return None
    model = lgbm_text.parse(fit["booster"].to_lightgbm_string())
    return 100.0 * work.hist_rows(model) / handed
