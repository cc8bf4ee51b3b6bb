"""Plain PyTorch histograms: the references the CUDA kernels are held to.

Counterparts of ``mmlspark_tpu/ops/histogram_scatter.py``:

  * :func:`node_hist_plain` (``node_hist_scatter``) — per-frontier-node
    histograms::

        out[f, w*3 + s, b] = sum_{r : pos_r == w, binned[f, r] == b} base[s, r]

    With f32 stats (``acc_dtype=torch.float32``) the stats are rounded to
    bf16 first and accumulated in f32 — the input rounding every engine of
    the JAX package applies (``histogram.py:300-302``) — so the count
    channel is exact and grad/hess differ from any other engine only by
    summation order. With int8 stats (``acc_dtype=torch.int32``, the
    quantized-gradient path) they are accumulated exactly in int32, with
    no rounding.
  * :func:`node_hist_blocked_plain` — the same per fixed row block
    (``GrowConfig.hist_blocks``): ``[blocks, F, 3W, B]``, one partial per
    block of ``n / blocks`` consecutive rows;
  * :func:`hist_plain` (``hist_scatter``) — the unfused ``[F, S, B]``
    histogram of ``histogram_cols``: stats rounded to ``stats_dtype``,
    summed in f32.

Each is one ``index_add_`` per feature over a flattened segment id; rows
with ``pos == -1`` and bins outside ``[0, B)`` go to an overflow segment
that is dropped. :mod:`.histogram` runs these for tensors on the CPU;
``chip_smoke.py`` runs them on the card to check the kernels.
"""

from __future__ import annotations

import torch


def node_hist_plain(binned_t: torch.Tensor, row_pos: torch.Tensor,
                    base_t: torch.Tensor, num_nodes: int, num_bins: int,
                    acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[F, 3W, B]`` per-frontier-node histograms in ``acc_dtype``.

    binned_t: [F, n] int32/int16/uint8 bin ids in [0, B); row_pos: [n] int32
    in [-1, W); base_t: [3, n] — f32 (grad*mask, hess*mask, mask) with
    ``acc_dtype=torch.float32``, or int8 (their quantized values) with
    ``acc_dtype=torch.int32``.
    """
    if acc_dtype not in (torch.float32, torch.int32):
        raise ValueError(f"acc_dtype must be float32 or int32, got "
                         f"{acc_dtype}")
    node_hist_plain.calls += 1
    F, n = binned_t.shape
    W, B = int(num_nodes), int(num_bins)
    if acc_dtype == torch.int32:
        data = base_t.to(torch.int32).t()                        # [n, 3]
    else:
        data = base_t.to(torch.bfloat16).to(torch.float32).t()
    valid = row_pos >= 0
    node_off = row_pos.long() * B
    out = torch.empty((F, W * B, 3), dtype=acc_dtype, device=binned_t.device)
    for f in range(F):
        b = binned_t[f].long()
        seg = torch.where(valid & (b >= 0) & (b < B), node_off + b, W * B)
        h = torch.zeros((W * B + 1, 3), dtype=acc_dtype,
                        device=binned_t.device)
        h.index_add_(0, seg, data)
        out[f] = h[:W * B]
    return out.reshape(F, W, B, 3).permute(0, 1, 3, 2).reshape(F, 3 * W, B)


node_hist_plain.calls = 0


def node_hist_blocked_plain(binned_t: torch.Tensor, row_pos: torch.Tensor,
                            base_t: torch.Tensor, num_nodes: int,
                            num_bins: int, blocks: int,
                            acc_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """``[blocks, F, 3W, B]``: :func:`node_hist_plain` of each of
    ``blocks`` consecutive row blocks of ``n / blocks`` rows, in one call —
    block ``j``'s rows take nodes ``j*W .. j*W + W - 1``, so each cell
    sums its own block's rows only, in row order."""
    F, n = binned_t.shape
    W = int(num_nodes)
    out = node_hist_plain(binned_t, blocks_as_nodes(row_pos, W, blocks),
                          base_t, blocks * W, num_bins, acc_dtype)
    return out.reshape(F, blocks, 3 * W, -1).permute(1, 0, 2, 3).contiguous()


def blocks_as_nodes(row_pos: torch.Tensor, num_nodes: int,
                    blocks: int) -> torch.Tensor:
    """``[n]`` int32 positions of ``blocks * W`` nodes: block ``j``'s rows
    (``n / blocks`` consecutive) move to nodes ``j*W .. j*W + W - 1``;
    rows at -1 stay there. One histogram pass over them holds each block's
    partial apart."""
    n = row_pos.shape[0]
    if blocks < 1 or n % blocks:
        raise ValueError(f"{n} rows do not tile into {blocks} blocks")
    block = torch.arange(n, device=row_pos.device) // (n // blocks)
    return torch.where(row_pos >= 0,
                       row_pos + (block * int(num_nodes)).to(torch.int32),
                       row_pos).to(torch.int32)


def hist_plain(binned_t: torch.Tensor, stats_t: torch.Tensor, num_bins: int,
               stats_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``[F, S, B]`` f32 histogram of ``[S, n]`` stats over ``[F, n]`` bins.

    Each stat is rounded to ``stats_dtype`` (bf16, or f32 for no rounding)
    and accumulated in f32; bins outside ``[0, B)`` are dropped.
    """
    hist_plain.calls += 1
    F, n = binned_t.shape
    S, B = stats_t.shape[0], int(num_bins)
    data = stats_t.to(stats_dtype).to(torch.float32).t()         # [n, S]
    out = torch.empty((F, B, S), dtype=torch.float32, device=binned_t.device)
    for f in range(F):
        b = binned_t[f].long()
        seg = torch.where((b >= 0) & (b < B), b, B)
        h = torch.zeros((B + 1, S), dtype=torch.float32,
                        device=binned_t.device)
        h.index_add_(0, seg, data)
        out[f] = h[:B]
    return out.permute(0, 2, 1).contiguous()


hist_plain.calls = 0
