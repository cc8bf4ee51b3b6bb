"""Run phase 17 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase17.py [--out chiprun_out/p17.txt]

Builds kernel 1 (``csrc/node_hist.cu``, the one hand kernel phase 17
reaches: the GBDT head of 17c), then runs ``chip_smoke.phase_dnn``: the
ResNet/AlexNet catalog through ``DNNModel`` in f32 and bf16 against the
cpu, ``ImageFeaturizer`` on ragged pictures, the transfer-learning head
with kernel 1's passes at F=2,048, streamed featurizing, ImageLIME and the
DigitsConvNet fixture. Every hold of the phase applies; a failed one exits
non-zero. The phase's JSON record is the last line (and, with ``--out``,
written there too). A quicker call than the whole script while phase 17 is
being worked on.
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
        raise SystemExit("chip_phase17: no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["node_hist"], verbose=True)
    out = chip_smoke.phase_dnn(chip_smoke.card_line())
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
