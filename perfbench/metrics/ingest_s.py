"""``ingest_s``: seconds a fit spends in ``LightGBMDataset.construct``
(the binner's fit, the upload and the bin apply), on the benchmark's clock
around that call up to the device's end; the mean over the window's
unprofiled fits."""


def read(run):
    spans = run.layer.get("clocks", {}).get("ingest") or []
    spans = spans[1:] or spans        # the first fit ran under the profiler
    return sum(spans) / len(spans) if spans else None
