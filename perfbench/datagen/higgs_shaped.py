"""Synthetic rows of HIGGS's shape: 28 float features, a binary label.

A frozen copy of ``chip_smoke.py:higgs_shaped`` (a fixed random signal
with interactions, labels drawn through a sigmoid: learnable, not
separable) with one change: the rows and labels are drawn by a
``torch.Generator`` on the device in a few large calls, not by numpy on the
host. The signal's ten weights are still numpy's ``default_rng(7)``."""

import numpy as np
import torch

from perfbench.seeds import torch_stream

FEATURES = 28


def draw(rows: int, seed: int, stream: int, device):
    """``(X [rows, 28] float32, y [rows] float32)`` on ``device``."""
    g = torch_stream(seed, stream, device)
    X = torch.randn((rows, FEATURES), generator=g, device=device)
    w = torch.as_tensor(np.random.default_rng(7).normal(size=10)
                        .astype(np.float32), device=device)
    z = ((X[:, :10] * w).sum(dim=1) * 0.4 + torch.sin(2 * X[:, 10])
         + X[:, 11] * X[:, 12] - 0.5 * X[:, 13].abs())
    p = torch.sigmoid(1.5 * z)
    y = (torch.rand(rows, generator=g, device=device) < p).float()
    return X, y
