"""Synthetic rows of UCI Covertype's shape: 10 continuous features, a
one-hot of 4 (wilderness area) and a one-hot of 40 (soil type), 7 classes.

A frozen copy of ``chip_smoke.py:covertype_shaped`` (the class drawn
through a softmax of a fixed seeded function of the features) with one
change: the rows and classes are drawn by a ``torch.Generator`` on the
device in a few large calls, not by numpy on the host. The function's
weights are still numpy's ``default_rng(17)``."""

import numpy as np
import torch

from perfbench.seeds import torch_stream

FEATURES = 54
CLASSES = 7


def draw(rows: int, seed: int, stream: int, device):
    """``(X [rows, 54] float32, y [rows] float32 class ids)`` on
    ``device``."""
    g = torch_stream(seed, stream, device)
    cont = torch.randn((rows, 10), generator=g, device=device)
    area = torch.randint(0, 4, (rows,), generator=g, device=device)
    soil = torch.randint(0, 40, (rows,), generator=g, device=device)
    X = torch.zeros((rows, FEATURES), device=device)
    X[:, :10] = cont
    r = torch.arange(rows, device=device)
    X[r, 10 + area] = 1.0
    X[r, 14 + soil] = 1.0
    f = np.random.default_rng(17)
    wc, wa, ws = (torch.as_tensor(f.normal(size=s).astype(np.float32),
                                  device=device)
                  for s in ((10, CLASSES), (4, CLASSES), (40, CLASSES)))
    logits = (0.7 * (cont[:, :, None] * wc).sum(dim=1) + wa[area]
              + 0.6 * ws[soil] + 0.5 * cont[:, :CLASSES].abs())
    cum = torch.softmax(logits, dim=1).cumsum(dim=1)
    u = torch.rand((rows, 1), generator=g, device=device)
    y = (u > cum).sum(dim=1).clamp(max=CLASSES - 1)
    return X, y.float()
