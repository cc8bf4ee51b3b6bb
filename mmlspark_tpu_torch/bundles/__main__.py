"""CLI for serving bundles.

    python -m mmlspark_tpu_torch.bundles build \
        --model /models/churn.txt --out /models/churn.bundle \
        --max-batch 32
    python -m mmlspark_tpu_torch.bundles inspect /models/churn.bundle

``build`` writes the predict plans of every pow2 batch bucket the
serving engines dispatch (override with ``--batch-sizes``) for the card
named by ``--device`` (default ``cuda``), atomically. ``inspect`` prints
the manifest without touching a device — safe on any machine.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mmlspark_tpu_torch.bundles")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="AOT-build a serving bundle")
    b.add_argument("--model", required=True,
                   help="saved pipeline dir, LightGBM .txt model, or "
                        "native .npz booster (.npz keeps the binner "
                        "grid the int8 lane needs)")
    b.add_argument("--out", required=True, help="bundle directory to write")
    b.add_argument("--batch-sizes", default=None,
                   help="comma-separated batch sizes (default: the pow2 "
                        "ladder up to --max-batch — the only shapes the "
                        "serving engines dispatch)")
    b.add_argument("--max-batch", type=int, default=32,
                   help="serving batch cap the pow2 ladder runs to "
                        "(match the worker's --max-batch)")
    b.add_argument("--num-iterations", default="-1",
                   help="comma-separated num_iteration values to bundle "
                        "(-1 = the full model)")
    b.add_argument("--include-raw", action="store_true",
                   help="also bundle the untransformed predict_raw "
                        "programs")
    b.add_argument("--predict-dtypes", default="f32",
                   help="comma-separated predict lanes to bundle "
                        "(f32,bf16,int8; default f32) — match the "
                        "fleet's MMLSPARK_TPU_PREDICT_DTYPE so the "
                        "quantized programs warm-start too")
    b.add_argument("--tuned-from", default=None, metavar="STORE_DIR",
                   help="tuning store directory (MMLSPARK_TPU_TUNING_DIR "
                        "of a measured deployment): bakes the measured "
                        "bucket ladder into the enumeration next to the "
                        "pow2 grid and stamps tuning provenance into the "
                        "manifest")
    b.add_argument("--force", action="store_true",
                   help="replace an existing bundle directory")
    b.add_argument("--device", default=None,
                   help="device the bundle is for (default cuda; its name "
                        "and compute capability join the fingerprint)")

    i = sub.add_parser("inspect", help="print a bundle's manifest")
    i.add_argument("bundle", help="bundle directory")

    args = p.parse_args(argv)

    from ..observability.logging import console
    if args.cmd == "inspect":
        from .bundle import read_manifest
        # console, not the JSON log funnel: CLI output parsed by humans
        # and scripts, like the serving_main ready-line
        console(json.dumps(read_manifest(args.bundle), indent=2,
                           sort_keys=True))
        return 0

    from .bundle import build_bundle
    if getattr(args, "tuned_from", None):
        from .. import tuning as _tuning
        # point the tuner at the measured store BEFORE the enumeration
        # runs; the model hash joins the fingerprint check so a store
        # measured against a different model degrades loudly
        from .bundle import model_hash
        _tuning.configure(store_dir=args.tuned_from,
                          model_sha256=model_hash(args.model))
    batch_sizes = None
    if args.batch_sizes:
        batch_sizes = [int(x) for x in args.batch_sizes.split(",") if x]
    num_iterations = tuple(
        int(x) for x in args.num_iterations.split(",") if x)
    predict_dtypes = tuple(
        x.strip() for x in args.predict_dtypes.split(",") if x.strip())
    manifest = build_bundle(
        args.model, args.out, batch_sizes=batch_sizes,
        max_batch=args.max_batch, num_iterations=num_iterations,
        include_raw=args.include_raw, predict_dtypes=predict_dtypes,
        force=args.force, device=args.device)
    console(f"bundle written: {args.out} "
            f"({len(manifest['entries'])} programs, "
            f"fingerprint {manifest['fingerprint']['device_name']}/"
            f"{manifest['fingerprint']['torch_version']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
