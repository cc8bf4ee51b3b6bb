"""Row-wise top-k in ``jax.lax.top_k``'s order.

``lax.top_k`` returns each row's k largest entries by value, descending,
and among equal values the lower column id first. ``torch.topk`` selects
the right values but promises no order among equal ones (on CUDA none
holds), nor which of several entries equal to the k-th value it keeps
when there are more of them than slots. KNN's distances and SAR's scores
tie often (integer-valued vectors; the many zero scores of a user with
few items), so the ids that come out depend on it.

Design, exact on ties: ``torch.topk`` picks k + 1 entries; they are put in
order by a stable sort by id, then a stable sort by value. Where the
(k+1)-th value differs from the k-th, the first k are the row's top k in
that order. Where they are equal, a tie crosses the boundary and
``torch.topk`` may have kept any of the tied entries: such rows are
chosen again by a stable sort of the whole row, in chunks. A full
stable sort of every row would cost far more than the distances at KNN's
widths; the one extra entry costs nothing, and no pass over the block is
added (a ``[q, n]`` compare and its count would be one, and the count's
int64 copy of a ``[4096, 1M]`` block 32 GB).
"""

from __future__ import annotations

from typing import Tuple

import torch

# elements of a row chunk re-sorted at once (values, ids and the gathered
# copy: about 16 bytes an element, so 4 GiB)
_RESORT_ELEMENTS = 1 << 28


def top_k(x: torch.Tensor, k: int,
          largest: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [q, k], ids [q, k])`` of ``x`` [q, n] in ``lax.top_k``'s
    order (``largest=False``: the k smallest, ascending, which is
    ``lax.top_k(-x, k)`` with its values negated back). ``k`` is capped at
    ``n``."""
    q, n = x.shape
    k = min(int(k), n)
    if k == 0 or q == 0:
        return (x.new_empty((q, k)),
                torch.empty((q, k), dtype=torch.long, device=x.device))
    take = min(k + 1, n)
    vals, ids = torch.topk(x, take, dim=1, largest=largest, sorted=False)
    ids, perm = torch.sort(ids, dim=1)
    vals, perm = torch.sort(vals.gather(1, perm), dim=1, descending=largest,
                            stable=True)
    ids = ids.gather(1, perm)
    if take == k:
        return vals, ids
    crowded = torch.nonzero(vals[:, k] == vals[:, k - 1]).flatten()
    vals, ids = vals[:, :k].contiguous(), ids[:, :k].contiguous()
    step = max(1, _RESORT_ELEMENTS // n)
    for s in range(0, crowded.numel(), step):
        rows = crowded[s:s + step]
        v, i = torch.sort(x.index_select(0, rows), dim=1,
                          descending=largest, stable=True)
        vals[rows] = v[:, :k]
        ids[rows] = i[:, :k]
    return vals, ids
