"""``predict_device_ms_per_mrow``: the device's busy milliseconds over the
profiled scoring calls (kernels, copies and fills, from the profiler) per
million rows those calls scored."""


def read(run):
    rows = run.layer.get("profiled_rows")
    if run.trace is None or not rows or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / (rows / 1e6)
