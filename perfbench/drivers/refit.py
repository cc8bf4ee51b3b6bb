"""Back-to-back fits of one training set with the binned-dataset cache
warm: ``fit.py``'s set-up, window and check, and the cache held to it.

Set-up fits ``warmup_iterations`` rounds and then requires the cache to
hold one dataset of exactly the configuration's rows: a fit that bins its
rows elsewhere stops the run there. The check adds to ``fit.py``'s that
every fit of the window was a cache hit and none a miss.
"""

from __future__ import annotations

from perfbench import harness
from perfbench.drivers import fit as fit_driver

window = fit_driver.window


def setup(run):
    from mmlspark_tpu_torch.models.gbdt import api
    st = fit_driver.setup(run)
    rows = run.config["data"]["rows"]
    held = [int(ds.n) for ds in api._BINNED_CACHE.values()]
    if held != [rows]:
        raise SystemExit(
            f"perfbench: after the warm-up fit the binned-dataset cache holds "
            f"{len(held)} dataset(s) of {held} rows, not one of the {rows} "
            f"training rows: the fit does not go through the cache")
    return st


def check(run, st):
    cache = run.layer["cache"]
    return [harness.check("cache_hits", cache["hits"], ">=", run.attempted),
            harness.check("cache_misses", cache["misses"], "<=", 0)
            ] + fit_driver.check(run, st)
