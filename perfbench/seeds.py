"""One seed, many independent streams: every draw of a run comes from the
``--seed`` and a stream number of its own (train rows 0, held-out rows 1,
scoring partitions 2, the audited rounds 2 and the kept calls 3 on numpy's
side, the model 77)."""

import numpy as np
import torch


def torch_stream(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) % (1 << 63))
    return g


def numpy_stream(seed: int, stream: int) -> np.random.Generator:
    """numpy's generator for one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), int(stream)])
