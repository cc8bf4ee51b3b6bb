"""Run phase 22 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase22.py [--out FILE]

Builds the LambdaRank kernel (``csrc/lambdarank.cu``; ``nvcc -Xptxas -v``
prints its registers, shared memory and spills), then runs
``chip_smoke.phase_lambdarank``: the kernel against its plain version at
Yahoo LTR's queries and at one query of 4,096 rows, two launches
bit-equal, and both timed against the kernel's bound. Every hold of the
phase applies; a failed one exits non-zero. The phase's JSON record is the
last line (and, with ``--out``, written there too).
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
        raise SystemExit("chip_phase22: no CUDA GPU is available")
    _build.build_all(["lambdarank"], verbose=True)
    card = chip_smoke.card_line()
    out = chip_smoke.phase_lambdarank(card)
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
