"""``fit_mfu``: the least bytes a fit's trees need (``work.fit_min_bytes``,
from the configuration's shapes) over the H100's published memory rate and
the mean seconds of the window's unprofiled fits, in %. A GBDT fit has
almost no arithmetic, so the share is of the memory peak."""

from perfbench import peaks, work


def read(run):
    fits = run.layer.get("fits") or []
    plain = [f for f in fits if not f["profiled"]] or fits
    if run.device.type != "cuda" or not plain:
        return None
    seconds = sum(f["seconds"] for f in plain) / len(plain)
    nbytes = work.fit_min_bytes(run.layer["rows"], run.layer["features"],
                                plain[0]["booster"].num_trees)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / seconds
