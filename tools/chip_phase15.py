"""Run phase 15 of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase15.py [--out chiprun_out/p15.txt]

Builds kernel 1 (``node_hist``, which 15e's fit launches) and the host
library, then runs ``chip_smoke.phase_vw_and_host_stages``: the VW fit at
full width with its step costs, the small VW fits on cuda against cpu, L-BFGS,
the contextual bandit and ``TrainClassifier``. Every hold of the phase
applies; a failed one exits non-zero. The phase's JSON record is the last
line (and, with ``--out``, written there too). A quicker call than the
whole script while phase 15 is being worked on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mmlspark_tpu_torch import native  # noqa: E402
from mmlspark_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    _build.build_all(["node_hist"])
    _build.load("node_hist")
    native.get_lib()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    out = chip_smoke.phase_vw_and_host_stages(chip_smoke.card_line())
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
