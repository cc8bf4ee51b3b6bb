"""The readings that a cell's limits are set from, on the card: the
compared numbers of sound runs over many seeds and of the control (the
program's next precision down, the configuration's ``control``) over a
few, all in one process so that the set-up's imports and kernel build are
paid once. The benchmark's own runs never run the control.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault NAME] [--override JSON]
        [--seconds 0.001] [--out FILE]

Each run is a whole run of the cell (set-up, a window of ``--seconds``,
the check) whose compared numbers are printed as one JSON line; the
default window holds one call or one fit. ``--fault`` plants one of
``faults.py``'s faults under every run; ``--override`` merges a JSON object
into the cell's files (``{"config": {"params": {...}}}``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--override", default=None)
    ap.add_argument("--seconds", type=float, default=0.001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import contextlib
    import torch
    from perfbench import harness
    from perfbench.faults import FAULTS
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    lines = []
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        with (FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            r = harness.run_cell(
                bench, args.workload, seed, args.seconds, False,
                control=control, overrides=json.loads(args.override or "{}"))
        line = json.dumps(dict(
            workload=args.workload, seed=seed, control=control,
            fault=args.fault, override=args.override,
            correct=r["correct"], seconds=time.perf_counter() - t0,
            checks={k: v["value"] for k, v in r["checks"].items()},
            metrics={k: v["value"] for k, v in r["metrics"].items()}))
        print(line, flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
