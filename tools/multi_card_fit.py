"""Fit phase 4's rows over 1, 2 and 4 ranks, one card each (nccl).

    python3 tools/multi_card_fit.py [--worlds 1 2 4] [--rows 1000000]
        [--out chiprun_out/multi_card.json]
    python3 tools/multi_card_fit.py --device cpu --rows 40000   # gloo, CPU

For each world size the script starts that many processes of itself; rank
``r`` trains on ``cuda:r`` (the card's ranks joined by nccl through a TCP
rendezvous on localhost; ``--device cpu`` joins gloo on the CPU instead).
Every rank passes the same global HIGGS-shaped rows (``chip_smoke.
higgs_shaped``, 28 features, binary) and keeps its slice. Each rank fits
``LightGBMClassifier`` three ways, 10 rounds, 31 leaves, 255 bins: the
plain data-parallel fit, and the deterministic blocked reduction
(``MMLSPARK_TPU_HIST_BLOCKS=8``) in bf16 and quantized (warmup 0). Each
fit runs twice and the second is timed (the first pays the kernels' load
and the allocator's growth).

It fails unless every rank of a world returns one model and each blocked
fit's model is byte-equal at every world size. It prints, and writes to
``--out``, each world's fit seconds per rank, the plain fit's model digest
per world (its sums cross the group in another order, so it may differ
across world sizes) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FITS = (("plain", None, {}),
        ("blocked_bf16", "8", {}),
        ("blocked_quantized", "8",
         {"useQuantizedGrad": True, "quantWarmupIters": 0}))


def rank_main(args) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import higgs_shaped
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.models.gbdt import api as gbdt_api
    from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
    from mmlspark_tpu_torch.parallel import distributed

    rank, world = args.rank, args.world
    device = f"cuda:{rank}" if args.device == "cuda" else "cpu"
    if args.device == "cuda":
        torch.cuda.set_device(rank)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if world > 1:
        distributed.initialize(args.init, world, rank, device=device)
    X, y = higgs_shaped(args.rows, seed=0)
    train = Dataset({"features": X, "label": y})
    out = {}
    for name, blocks, params in FITS:
        if blocks is None:
            os.environ.pop("MMLSPARK_TPU_HIST_BLOCKS", None)
        else:
            os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = blocks
        est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                                 device=device, **params)
        for _ in range(2):
            gbdt_api.clear_binned_dataset_cache()
            if args.device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est.fit(train)
            if args.device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        out[name] = {"seconds": secs, "digest": hashlib.sha256(
            model.booster.model_string().encode()).hexdigest()}
    with open(args.result, "w") as f:
        json.dump(out, f)
    if world > 1:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(args, world: int, tmp: str) -> list:
    init = f"tcp://localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MMLSPARK_TPU_HIST_BLOCKS", None)
    procs, outs = [], []
    for r in range(world):
        outs.append(os.path.join(tmp, f"w{world}_r{r}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--init", init, "--rows",
             str(args.rows), "--device", args.device, "--result", outs[-1]],
            env=env, cwd=ROOT))
    try:
        for r, p in enumerate(procs):
            if p.wait(timeout=args.timeout) != 0:
                raise SystemExit(f"world {world}: rank {r} exited "
                                 f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for path in outs:
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "multi_card.json"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init", default="")
    ap.add_argument("--result", default="")
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.device == "cuda":
        import torch
        sys.path.insert(0, ROOT)
        from mmlspark_tpu_torch.ops import _build
        from mmlspark_tpu_torch.ops.histogram import KERNELS
        have = torch.cuda.device_count()
        if max(args.worlds) > have:
            raise SystemExit(f"{max(args.worlds)} ranks need as many cards; "
                             f"{have} found")
        _build.build_all(KERNELS)          # once, before the ranks load
    tmp = os.path.join(ROOT, "build", "multi_card_fit")
    os.makedirs(tmp, exist_ok=True)
    report = {"card": card_line() if args.device == "cuda" else "cpu",
              "rows": args.rows, "worlds": {}}
    for world in args.worlds:
        t0 = time.perf_counter()
        recs = run_world(args, world, tmp)
        for name, _, _ in FITS:
            if len({r[name]["digest"] for r in recs}) != 1:
                raise SystemExit(f"world {world}: ranks disagree on {name}")
        report["worlds"][world] = {
            name: {"seconds": [r[name]["seconds"] for r in recs],
                   "digest": recs[0][name]["digest"]}
            for name, _, _ in FITS}
        report["worlds"][world]["wall_s"] = time.perf_counter() - t0
        print(f"world {world}: " + json.dumps(report["worlds"][world]),
              flush=True)
    first = report["worlds"][args.worlds[0]]
    for world in args.worlds[1:]:
        for name in ("blocked_bf16", "blocked_quantized"):
            if report["worlds"][world][name]["digest"] != first[name][
                    "digest"]:
                raise SystemExit(f"{name}: world {world} differs from world "
                                 f"{args.worlds[0]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"], flush=True)
    print(json.dumps({"ok": True, "worlds": args.worlds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
