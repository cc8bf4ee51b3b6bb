"""LambdaRank's lambdas over query groups of any length on the card.

:func:`lambdarank_cuda` launches ``csrc/lambdarank.cu`` once: one block a
query, ranks by counting, each row's gradient and hessian summed by one
thread in a fixed order. Its plain version, the CPU's route, is
``models/gbdt/objectives.py:lambdarank_plain``. Counters: ``launches`` and
``pairs`` (the pairs ``y_i > y_j`` of one query each launch evaluates).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .histogram import _launch

# rows of a query the kernel stages in shared memory at most (20 bytes a
# row); a longer query goes through a scratch of three floats a row
SMEM_ROWS = 1024


def launch_shape(longest: int) -> Tuple[int, int]:
    """``(threads, smem_rows)`` of the launch for queries of at most
    ``longest`` rows: a block of 64 threads for queries of up to 256 rows
    (many blocks then share an SM), 256 past that; shared memory for the
    longest query, up to ``SMEM_ROWS``."""
    return (64 if longest <= 256 else 256), max(1, min(int(longest),
                                                       SMEM_ROWS))


def lambdarank_cuda(score: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor, *, longest: int, pairs: int,
                    max_position: int, sigma: float,
                    gain_table: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(grad, hess)`` ``[n]`` f32 of LambdaRank over the queries
    ``[offsets[q], offsets[q + 1])`` (``offsets`` ``[G + 1]`` int64, from 0
    to n; ``longest`` their longest length, ``pairs`` their pairs, for the
    counter), rows of weight 0 taking no part. ``gain_table``: labelGain as
    ``[k]`` f32 on the device, or None for ``2^y - 1``."""
    n = score.shape[0]
    for name, t in dict(score=score, y=y, w=w).items():
        if t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = dict(score=score, y=y, w=w, offsets=offsets)
    if gain_table is not None:
        if gain_table.dtype != torch.float32 or gain_table.dim() != 1:
            raise ValueError("gain_table must be a 1-D float32 tensor")
        tensors["gain_table"] = gain_table
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != score.device:
            raise ValueError(f"{name} is on {t.device}, score on "
                             f"{score.device}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise ValueError(f"offsets must be 1-D int64, got {offsets.dtype}")
    G = offsets.shape[0] - 1
    grad = torch.empty_like(score)
    hess = torch.empty_like(score)
    threads, smem_rows = launch_shape(longest)
    scratch = (torch.empty(3 * n, dtype=torch.float32, device=score.device)
               if longest > smem_rows else None)
    c = ctypes
    _launch("lambdarank", "mm_lambdarank",
            [(c.c_void_p, score.data_ptr()), (c.c_void_p, y.data_ptr()),
             (c.c_void_p, w.data_ptr()), (c.c_void_p, offsets.data_ptr()),
             (c.c_longlong, G), (c.c_longlong, n), (c.c_int, threads),
             (c.c_int, smem_rows),
             (c.c_void_p, None if scratch is None else scratch.data_ptr()),
             (c.c_void_p, None if gain_table is None
              else gain_table.data_ptr()),
             (c.c_int, 0 if gain_table is None else gain_table.shape[0]),
             (c.c_int, int(max_position)), (c.c_float, float(sigma)),
             (c.c_void_p, grad.data_ptr()), (c.c_void_p, hess.data_ptr())],
            score.device)
    lambdarank_cuda.launches += 1
    lambdarank_cuda.pairs += int(pairs)
    return grad, hess


lambdarank_cuda.launches = 0
lambdarank_cuda.pairs = 0
