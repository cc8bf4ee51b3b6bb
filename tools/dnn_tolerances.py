"""On the CPU: what phase 17's cuda-vs-cpu tolerances rest on.

    python tools/dnn_tolerances.py [--threads 8]

1. For ResNet-50 at 224x224 (the port's seeded ``builtin://`` draws) on 4
   seeded inputs in [-1, 1): the f32 forward's error against an f64
   forward of the same params, as a multiple of the spread that one ulp
   of input (an f32 ulp) makes; the same for the bf16 forward and one
   bf16 ulp of input. Two forwards each that accurate differ by up to
   about twice the ratio, which is what ``DNN_SPREAD_FACTOR`` covers.
2. ImageLIME's lasso (1,000 masks at the default keep share 0.7, 150 and
   196 superpixels): its coefficients' largest change, relative to their
   largest magnitude, when the scores move by 1e-6 relative, which is
   what ``LIME_COEF_RTOL`` covers.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mmlspark_tpu_torch.explain.lime import (  # noqa: E402
    lasso_coordinate_descent)
from mmlspark_tpu_torch.models.dnn import cnn  # noqa: E402
from mmlspark_tpu_torch.models.dnn.downloader import (  # noqa: E402
    ModelDownloader)


def forward_errors() -> None:
    import tempfile
    with tempfile.TemporaryDirectory() as repo:
        params, cfg, _ = ModelDownloader(repo).load_model("ResNet50")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 224, 224, 3)).astype(np.float32))

    def fwd(dtype, xx):
        with torch.inference_mode():
            logits, acts = cnn.apply_cnn(params, xx, replace(cfg, dtype=dtype),
                                         ["pool"])
        return {"logits": logits.double(), "pool": acts["pool"].double()}

    exact = fwd(torch.float64, x.double())
    for lane, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if lane == "f32":
            up = torch.nextafter(x, torch.tensor(float("inf")))
        else:
            up = (x.to(torch.bfloat16).view(torch.int16) + 1).view(
                torch.bfloat16).float()
        got, moved = fwd(dtype, x), fwd(dtype, up)
        for node in ("logits", "pool"):
            err = float((got[node] - exact[node]).abs().max())
            spread = float((moved[node] - got[node]).abs().max())
            print(f"ResNet50 {lane} {node}: error against f64 {err:.4g}, "
                  f"one ulp of input {spread:.4g}, ratio {err / spread:.2f}")


def lasso_sensitivity() -> None:
    rng = np.random.default_rng(0)
    for k in (196, 150):
        masks = (rng.random((1000, k)) < 0.7).astype(np.float64)
        for scale in (1.0, 300.0):
            y = masks @ rng.normal(size=k) * scale * 0.01 \
                + rng.normal(size=1000) * scale
            base = lasso_coordinate_descent(masks, y, None, 0.01)[:k]
            worst = 0.0
            for _ in range(5):
                moved = lasso_coordinate_descent(
                    masks, y * (1 + rng.normal(size=1000) * 1e-6), None,
                    0.01)[:k]
                worst = max(worst, float(np.abs(moved - base).max()
                                         / np.abs(base).max()))
            print(f"lasso, {k} superpixels, scores x{scale:g}: coefficients "
                  f"move {worst / 1e-6:.2f} times a 1e-6 relative score "
                  "change")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    forward_errors()
    lasso_sensitivity()
    return 0


if __name__ == "__main__":
    sys.exit(main())
