"""Ulysses-style sequence parallelism: all-to-all head/sequence resharding.

Counterpart of ``mmlspark_tpu/parallel/ulysses.py``, the second of the two
long-context strategies beside :mod:`.ring_attention` (DeepSpeed-Ulysses,
Jacobs et al. 2023, arXiv 2309.14509). With activations sequence-sharded,
a tiled all-to-all turns [B, H, S/n, D] into [B, H/n, S, D] — every rank
then holds the full sequence for a subset of heads — so blockwise
attention runs locally with no collective in its inner loop, and a second
all-to-all restores sequence sharding. Two large exchanges instead of the
ring's n small ones; H must be divisible by the shard count.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import all_to_all
from .mesh import Mesh
from .ring_attention import blockwise_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis: str = "seq", causal: bool = True,
                      scale: Optional[float] = None,
                      block_size: int = 512) -> torch.Tensor:
    """Exact attention over sequence shards via head/sequence all-to-all.

    q, k, v: [B, H, S_local, D], this rank's contiguous sequence shard. H
    must be divisible by the ``axis`` shard count. The kernel between the
    two exchanges is :func:`.ring_attention.blockwise_attention` over
    ``block_size`` K/V blocks. Returns [B, H, S_local, D] in q's dtype.
    """
    n = mesh.axis_size(axis)
    H = q.shape[1]
    if H % n:
        raise ValueError(
            f"ulysses_attention needs heads ({H}) divisible by the "
            f"'{axis}' shard count ({n}); use ring_attention for "
            "uneven head counts")

    def to_heads(x):
        # [B, H, S/n, D] -> [B, H/n, S, D]; the tiled all-to-all
        # concatenates in axis-index order, so contiguous sequence shards
        # reassemble in global order and causal masking needs no position
        # bookkeeping
        return all_to_all(x, mesh, axis, split_dim=1, concat_dim=2)

    out = blockwise_attention(to_heads(q), to_heads(k), to_heads(v),
                              causal=causal, scale=scale,
                              block_size=block_size)
    return all_to_all(out, mesh, axis, split_dim=2,
                      concat_dim=1).to(q.dtype)
