"""``hist_kernel_roofline``: the profiled fit's histogram work at the
H100's published peaks (``work.hist_logical_bytes`` from the fitted model's
own text against 3 float32 adds a histogrammed row and feature; the larger
bound, bytes here) over the profiler's device time of the port's histogram
kernels (``mm_hist::hist_kernel``), in %."""

from perfbench import frozen, peaks, work
from perfbench.reference import lgbm_text


def read(run):
    fits = [f for f in run.layer.get("fits") or [] if f["profiled"]]
    if run.trace is None or not fits:
        return None
    kernel_s = run.trace.kernel_s("mm_hist::")
    if kernel_s <= 0:
        return None
    model = lgbm_text.parse(fits[0]["booster"].to_lightgbm_string())
    F, B = run.layer["features"], run.layer["max_bin"]
    bound, _ = frozen.bound_ms(work.hist_logical_bytes(model, F, B),
                               3.0 * F * work.hist_rows(model),
                               peaks.F32_OPS_PER_S)
    return 100.0 * bound / 1e3 / kernel_s
