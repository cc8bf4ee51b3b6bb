"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the port (``mmlspark_tpu_torch``). Prints the run's log, then one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, a breakdown of the traced stretch and the device's
busy time. Exits non-zero, printing no result, without the CUDA devices the
cell asks for, without the port, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernels under build/mmlspark_tpu_torch/ itself)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from perfbench import harness

    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s), {have} "
              "available", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.ForbiddenImport as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
