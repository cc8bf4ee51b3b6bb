"""Run phase 19 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase19.py [--out chiprun_out/p19.txt]

Runs ``chip_smoke.phase_transformer``: the SPMD transformer's train step at
``TransformerConfig()``'s full width for each sequence strategy on the
card (19a, with the narrow f32 config on cuda against cpu), then the
four-rank ``{"data": 1, "seq": 2, "model": 2}`` mesh as gloo processes on
the one card against world size 1 (19b). No kernel is built: phase 19
launches none. Every hold of the phase applies; a failed one exits
non-zero. The phase's JSON record is the last line (and, with ``--out``,
written there too). A quicker call than the whole script while phase 19
is being worked on.
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
        raise SystemExit("chip_phase19: no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    out = chip_smoke.phase_transformer(card)
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
