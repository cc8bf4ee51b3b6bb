"""Synthetic rows of the Yahoo! Learning to Rank Challenge's shape (set 1):
700 float32 features in [0, 1], relevance grades 0-4, rows grouped by
query and sorted by it, as the challenge's files are.

Query lengths are seeded, log-normal about a mean of 23.7 rows (the train
split's 473,134 rows over 19,944 queries), capped at ``LONGEST`` rows and
made to add up to the rows asked for. Each feature takes the value 0 on a
fixed share of the rows (an assumed stand-in for features absent from a row),
uniform in (0, 1) elsewhere. The grade is a fixed seeded function of 22
features plus a per-query offset and noise, cut at the quantiles of the
grade mix ``GRADE_SHARES``: learnable, not separable. The rows and grades
are drawn by a ``torch.Generator`` on the device in a few large calls; the
query lengths by numpy from the seed; the function's weights and the zero
shares by numpy's ``default_rng(29)``."""

import numpy as np
import torch

from perfbench.seeds import numpy_stream, torch_stream

FEATURES = 700
LONGEST = 139
MEAN_LENGTH = 23.7
# the shares of grades 0-4 (assumed; the configuration lists it)
GRADE_SHARES = (0.24, 0.37, 0.27, 0.09, 0.03)


def query_lengths(rows: int, queries: int, seed: int, stream: int
                  ) -> np.ndarray:
    """``[queries]`` int64 lengths in [1, LONGEST] adding up to ``rows``,
    log-normal (sigma 0.8) about the mean ``rows / queries``."""
    if not queries <= rows <= queries * LONGEST:
        raise ValueError(f"{rows} rows do not fit {queries} queries of 1 to "
                         f"{LONGEST} rows")
    rng = numpy_stream(seed, 10 + stream)
    mu = np.log(rows / queries) - 0.32
    n = np.clip(np.rint(np.exp(rng.normal(mu, 0.8, size=queries))), 1,
                LONGEST).astype(np.int64)
    while n.sum() != rows:
        step = 1 if n.sum() < rows else -1
        room = np.flatnonzero((n < LONGEST) if step > 0 else (n > 1))
        k = min(abs(int(rows - n.sum())), room.size)
        n[rng.choice(room, size=k, replace=False)] += step
    return n


def draw(rows: int, queries: int, seed: int, stream: int, device):
    """``(X [rows, 700] float32, y [rows] float32 grades, query [rows] int64
    ids, ascending)``: X and y on ``device``, the ids on the host."""
    lengths = query_lengths(rows, queries, seed, stream)
    qid = np.repeat(np.arange(queries, dtype=np.int64), lengths)
    g = torch_stream(seed, stream, device)
    f = np.random.default_rng(29)
    zero_share = torch.as_tensor(f.uniform(0.0, 0.6, size=FEATURES)
                                 .astype(np.float32), device=device)
    w = torch.as_tensor(f.normal(size=20).astype(np.float32), device=device)
    X = torch.rand((rows, FEATURES), generator=g, device=device)
    X.masked_fill_(torch.rand((rows, FEATURES), generator=g, device=device)
                   < zero_share, 0.0)
    offset = torch.randn(queries, generator=g, device=device)
    q_d = torch.from_numpy(qid).to(device)
    z = (((X[:, :20] - 0.5) * w).sum(dim=1) * (12.0 ** 0.5 / float(w.norm()))
         + 4.0 * (X[:, 20] - 0.5) * (X[:, 21] - 0.5) + 0.5 * offset[q_d]
         + 0.7 * torch.randn(rows, generator=g, device=device))
    cuts = torch.quantile(z[:min(rows, 1 << 24)].float(), torch.tensor(
        np.cumsum(GRADE_SHARES)[:-1], dtype=torch.float32, device=device))
    y = torch.bucketize(z, cuts).float()
    return X, y, qid
