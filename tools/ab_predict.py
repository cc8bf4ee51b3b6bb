"""Time ``Booster.predict_raw`` on 200,000 x 28 rows and ``predict`` on 32
rows, per predict lane, with the ``mmlspark_tpu_torch`` of a given root.

    python3 tools/ab_predict.py <repo root>

Run it on the card for two roots in turns in one call (an older commit
unpacked with ``git archive <commit> mmlspark_tpu_torch | tar -x -C
build/ab_parent``, then this tree): parent, change, change, parent. Each
run fits a 10-round, 31-leaf binary model on 20,000 HIGGS-shaped rows on
the CPU (the same trees in both roots), then prints one JSON line: the
seven 200,000-row times sorted (ms, the card synchronized around each)
and the mean host ms of 50 32-row calls.
"""

import json
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmlspark_tpu_torch.models.gbdt.booster import train_booster  # noqa: E402
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig  # noqa: E402


def higgs(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=10).astype(np.float32)
    z = X[:, :10] @ w * 0.4 + np.sin(2 * X[:, 10]) + X[:, 11] * X[:, 12]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-1.5 * z))).astype(np.float32)
    return X, y


def main() -> None:
    X, y = higgs(20000, 0)
    Xh, _ = higgs(200000, 1)
    b = train_booster(X, y, objective="binary", num_iterations=10,
                      cfg=GrowConfig(num_leaves=31), device="cpu")
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for lane in ("f32", "bf16", "int8"):
        b.predict_raw(Xh[:1000], device="cuda", predict_dtype=lane)
        b.predict_raw(Xh, device="cuda", predict_dtype=lane)
        ts = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.predict_raw(Xh, device="cuda", predict_dtype=lane)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[lane + "_200k_ms"] = sorted(ts)
        for _ in range(3):
            b.predict(Xh[:32], device="cuda", predict_dtype=lane)
        t0 = time.perf_counter()
        for _ in range(50):
            b.predict(Xh[:32], device="cuda", predict_dtype=lane)
        out[lane + "_32_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    print(json.dumps(out))


if __name__ == "__main__":
    main()
