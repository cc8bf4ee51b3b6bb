"""``transform_host_ms_per_mrow``: host milliseconds of a scoring call
outside the predictor, per million rows: the pipeline layer's transform
span less its ``gbdt.predict`` span (the features' extraction, the output
columns), over every call of the window."""

from perfbench import span_tree


def read(run):
    spans = span_tree.read_spans()
    n = run.attempted
    if spans is None or not n or run.failed:
        return None
    calls = spans.stage_calls("transform")[-n:]
    if len(calls) != n:
        return None
    outside, rows = 0.0, 0
    for c in calls:
        predict = spans.below(c, "gbdt.predict")
        if len(predict) != 1 or not c["args"].get("rows_in"):
            return None
        outside += (c["dur"] - predict[0]["dur"]) / 1e6
        rows += c["args"]["rows_in"]
    return 1e3 * outside / (rows / 1e6)
