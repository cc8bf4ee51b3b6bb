"""Run phase 16 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase16.py [--out chiprun_out/p16.txt]

Runs ``chip_smoke.phase_estimators``: the isolation forest on 1,000,000
HIGGS-shaped rows with planted outliers, exact KNN and ConditionalKNN at
sift-128-euclidean's shape with the BallTree beside them, SAR at
MovieLens-1M's shape with the ranking split and evaluation, and
AccessAnomaly on about 1.1M access events, each against a cpu run. No
histogram kernel runs in this phase, so none is built. Every hold of the
phase applies; a failed one exits non-zero. The phase's JSON record is the
last line (and, with ``--out``, written there too). A quicker call than the
whole script while phase 16 is being worked on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase16: no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.phase_estimators(chip_smoke.card_line())
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
