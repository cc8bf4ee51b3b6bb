"""Run phase 18 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase18.py [--out chiprun_out/p18.txt]

Builds kernels 1 and 2 (``csrc/node_hist.cu``, ``csrc/node_hist_int8.cu``),
fits phases 4 and 4b for the models phase 18 reads (1,000,000 x 28 rows,
10 rounds), then runs ``chip_smoke.phase_automl_and_http``: the tuning's
swept and sequential routes, the small tuning cuda against cpu and
``FindBestModel``, ``SimpleHTTPTransformer`` against a ``serving_main``
worker with the port forwarder and the Power BI writer, and the model
repository over ``http://``. Every hold of those phases applies; a failed
one exits non-zero. The phase's JSON record is the last line (and, with
``--out``, written there too). A quicker call than the whole script while
phase 18 is being worked on.
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
        raise SystemExit("chip_phase18: no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["node_hist", "node_hist_int8"], verbose=True)
    card = chip_smoke.card_line()
    data = (*chip_smoke.higgs_shaped(chip_smoke.HIGGS_ROWS, seed=0),
            *chip_smoke.higgs_shaped(chip_smoke.HIGGS_HOLDOUT, seed=1))
    _, base = chip_smoke.phase_end_to_end("4", ["node_hist_bf16"], data)
    _, quantized = chip_smoke.phase_end_to_end(
        "4b", ["node_hist_int8"], data, useQuantizedGrad=True,
        quantWarmupIters=0)
    out = chip_smoke.phase_automl_and_http(data, base, quantized, card)
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
