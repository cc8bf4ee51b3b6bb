"""Where the time of the port's GBDT fit goes, on one NVIDIA GPU.

    python3 tools/profile_torch_gbdt.py [--rows 1000000] [--out FILE]

Runs ``chip_smoke.py``'s main-path fits (HIGGS-shaped synthetic rows,
28 features, maxBin 255, numLeaves 31, 10 rounds) piece by piece:

  * dataset construction, split into the host binner fit and the device
    upload + bin apply;
  * for each of two fits on the constructed dataset — the default (bf16
    histograms, kernel 1) and the quantized leafwise one
    (``quantized_grad=True, quant_warmup_iters=0``: kernel 2) —
    ``train_booster``'s wall time, then once more under ``torch.profiler``:
    the share of the wall the device was busy, device ms and launches by
    kernel, and the device ms of the half-pass gathers (the
    ``index_select`` of the ``[F, n/2]`` bins and ``[3, n/2]`` stats
    before every smaller-child pass, ``growth.py:_subtracted_pair_hists``);
  * ``Booster.predict_raw`` on 200,000 rows.

Needs a CUDA GPU; prints a report (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import card_line, higgs_shaped  # noqa: E402
from mmlspark_tpu_torch.models.gbdt.booster import (  # noqa: E402
    LightGBMDataset, train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as hist_ops  # noqa: E402
from mmlspark_tpu_torch.ops.binning import QuantileBinner, bin_cols  # noqa: E402


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_fit(say, label, ds, cfg, h_buf: int):
    """Wall time of a 10-round ``train_booster``, then one profiled run:
    device busy share, device ms and launches by kernel, and the device ms
    of the half-pass gathers (``aten::index_select`` calls whose index has
    ``h_buf`` rows). Returns the booster."""
    def fit():
        return train_booster(dataset=ds, objective="binary",
                             num_iterations=10, cfg=cfg)

    fit()                                               # warm
    hist_ops.node_histogram.launches = 0
    hist_ops.node_histogram.int8_launches = 0
    booster, t_train = wall(fit)
    say(f"== {label}: train_booster (10 rounds, dataset built) "
        f"{t_train:.3f} s, {10 / t_train:.3f} trees/s; launches kernel 1 "
        f"{hist_ops.node_histogram.launches}, kernel 2 "
        f"{hist_ops.node_histogram.int8_launches}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        _, t_prof = wall(fit)
    # kernel-level events only: an operator's row repeats its kernels'
    # device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in events)
    say(f"profiled train_booster {t_prof:.3f} s wall; device busy "
        f"{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / t_prof:.1f}% of the wall")
    for e in events[:15]:
        say(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")
    gathers = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key == "aten::index_select" and len(e.input_shapes) > 2
               and list(e.input_shapes[2]) == [h_buf]]
    g_us = sum(e.device_time_total for e in gathers)
    say(f"half-pass gathers (index_select of {h_buf} rows): "
        f"{g_us / 1e3:.3f} ms device, {sum(e.count for e in gathers)} calls"
        + "".join(f"; {list(e.input_shapes[0])}: "
                  f"{e.device_time_total / 1e3:.3f} ms x{e.count}"
                  for e in gathers))
    return booster


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_gbdt: no CUDA GPU is available")
    lines = [card_line()]

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    X, y = higgs_shaped(args.rows, seed=0)
    Xh, _ = higgs_shaped(200_000, seed=1)
    torch.zeros(1, device="cuda")                       # CUDA context
    binner, t_fit = wall(lambda: QuantileBinner(255, 200_000, 3).fit(X))
    _, t_bin = wall(lambda: bin_cols(torch.from_numpy(X).cuda(),
                                     torch.from_numpy(binner.upper_bounds)))
    say(f"construct pieces: host binner fit {t_fit:.3f} s, upload + device "
        f"bin apply {t_bin:.3f} s")
    ds, t_ds = wall(lambda: LightGBMDataset.construct(
        X, y, max_bin=255, seed=3, device="cuda"))
    say(f"LightGBMDataset.construct {t_ds:.3f} s")

    fits = {"default (bf16, kernel 1)": None,
            "quantized leafwise, warmup 0 (kernel 2)": GrowConfig(
                quantized_grad=True, quant_warmup_iters=0)}
    for label, cfg in fits.items():
        booster = profile_fit(say, label, ds, cfg, h_buf=args.rows // 2)

    booster.predict_raw(Xh, device="cuda")              # upload the forest
    _, t_pred = wall(lambda: booster.predict_raw(Xh, device="cuda"))
    say(f"predict_raw 200000 rows {t_pred:.4f} s "
        f"({200_000 / t_pred:.0f} rows/s)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if np.isfinite(booster.trees["leaf_value"]).all() else 1


if __name__ == "__main__":
    sys.exit(main())
