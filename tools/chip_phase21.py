"""Run phase 21 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase21.py [--out FILE]

Builds kernel 1, its deterministic mode, kernel 2 and the fused int8
statistics (``csrc/node_hist.cu``, ``csrc/node_hist_det.cu``,
``csrc/node_hist_int8.cu``, ``csrc/quant_stats.cu``), then runs
``chip_smoke.phase_prng``: the JAX package's random streams drawn on the
card against the CPU and against ``PRNG_GOLDEN`` (21a), a quantized tree's
int8 statistics through ``quant_stats`` bit-equal to the eager chain and
timed (21c), and phase 4's rows fitted under bagging, ``featureFraction``,
GOSS and stochastic rounding, plain and blocked, with their 20,000-row
twins on cuda against cpu (21b). Every hold of the phase
applies; a failed one exits non-zero. The phase's JSON record is the last
line (and, with ``--out``, written there too). A quicker call than the
whole script while phase 21 is being worked on.
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
from mmlspark_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase21: no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["node_hist", "node_hist_int8", "node_hist_det",
                      "quant_stats"], verbose=True)
    card = chip_smoke.card_line()
    out = chip_smoke.phase_prng(card)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(card, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
