"""Kernel 1's time against its row blocks and threads, on one NVIDIA GPU.

    python3 tools/node_hist_sweeps.py [--out FILE]

A block of the node-histogram kernels (``csrc/node_hist_common.cuh``) takes
one row vector per thread per sweep, sweeps dealt to the row blocks in
turn, so the pass lasts as many sweeps as its busiest block takes; a
partial extra sweep costs about a whole one. At three passes of F=28
features (n=500,000 W=1 B=63 over int16 and int32 bins, n=1,000,000 W=1
B=255 over int32 bins), kernel 1 runs with the geometry
``ops/histogram.py:_node_geometry`` chooses, then with its feature group
and cluster kept and the row blocks stepped one cluster at a time around
it (512 threads, so some steps leave a block a partial extra sweep), and
with the chosen row blocks at 512 threads. Each is checked against the
chosen geometry's count channel and timed with ``chip_smoke.time_ms``
(mean device ms of 20 launches).

Needs a CUDA GPU; prints a report (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import card_line, hist_inputs, time_ms  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as hist_ops  # noqa: E402

F = 28
PASSES = ((500_000, 1, 63, torch.int16), (500_000, 1, 63, torch.int32),
          (1_000_000, 1, 255, torch.int32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("node_hist_sweeps: no CUDA GPU is available")
    lines = [card_line()]
    print(lines[0], flush=True)
    dev = torch.cuda.current_device()
    for n, W, B, dt in PASSES:
        gen = torch.Generator(device="cuda").manual_seed(n + B)
        binned, pos, base = hist_inputs(gen, n, F, W, B)
        binned = binned.to(dt)
        bin_bytes = hist_ops._BIN_BYTES[dt]
        chosen = hist_ops._geometry_on("node_hist", dev, n, F, W, B,
                                       bin_bytes)
        want = hist_ops._node_hist_cuda(binned, pos, base, W, B)
        vectors = n // hist_ops._node_rows(bin_bytes)
        c = chosen.cluster
        trials = [("chosen", chosen)]
        for step in range(-4, 3):
            rb = chosen.row_blocks + step * c
            if step and rb >= c:
                trials.append((f"row blocks {step:+d} x {c}",
                               chosen._replace(row_blocks=rb, threads=512)))
        if chosen.threads != 512:
            trials.append(("chosen row blocks, 512 threads",
                           chosen._replace(threads=512)))
        head = (f"n={n} W={W} B={B} {str(dt).replace('torch.', '')} bins: "
                f"{vectors} row vectors; chosen {chosen}")
        print(head, flush=True)
        lines.append(head)
        for label, geo in trials:
            got = hist_ops._node_hist_cuda(binned, pos, base, W, B,
                                           geometry=geo)
            if not torch.equal(got[:, 2::3], want[:, 2::3]):
                raise AssertionError(f"{label}: count channel differs")
            ms = time_ms(lambda geo=geo: hist_ops._node_hist_cuda(
                binned, pos, base, W, B, geometry=geo), reps=20)
            sweeps = -(-vectors // geo.threads)
            busiest = -(-sweeps // geo.row_blocks)
            msg = (f"  {label:32s} {geo.row_blocks:4d} row blocks x "
                   f"{geo.threads} threads: {sweeps} sweeps, the busiest "
                   f"block {busiest} ({sweeps / geo.row_blocks:.2f} on "
                   f"average): {ms:.4f} ms")
            print(msg, flush=True)
            lines.append(msg)
        del binned, pos, base, want
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
