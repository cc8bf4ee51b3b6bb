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
  * :func:`node_hist_det_plain` — what kernel 1's deterministic mode
    (``csrc/node_hist_det.cu``) computes, bit for bit: the blocked partials
    as exact fixed-point int64 sums at the shifts of :func:`_det_shifts`,
    each converted once. It serves the tests and ``chip_smoke.py``; the
    CPU route of ``node_histogram(..., blocks=)`` stays
    :func:`node_hist_blocked_plain`;
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
    if acc_dtype == torch.int32:
        data = base_t.to(torch.int32).t()                        # [n, 3]
    else:
        data = base_t.to(torch.bfloat16).to(torch.float32).t()
    return _node_scatter(binned_t, row_pos, data, num_nodes, num_bins)


node_hist_plain.calls = 0


def _node_scatter(binned_t: torch.Tensor, row_pos: torch.Tensor,
                  data: torch.Tensor, num_nodes: int,
                  num_bins: int) -> torch.Tensor:
    """``[F, 3W, B]`` sums of the rows' ``[n, 3]`` ``data``, in its dtype:
    one ``index_add_`` per feature over the segment id ``pos * B + bin``."""
    F, n = binned_t.shape
    W, B = int(num_nodes), int(num_bins)
    valid = row_pos >= 0
    node_off = row_pos.long() * B
    out = torch.empty((F, W * B, 3), dtype=data.dtype, device=binned_t.device)
    for f in range(F):
        b = binned_t[f].long()
        seg = torch.where(valid & (b >= 0) & (b < B), node_off + b, W * B)
        h = torch.zeros((W * B + 1, 3), dtype=data.dtype,
                        device=binned_t.device)
        h.index_add_(0, seg, data)
        out[f] = h[:W * B]
    return out.reshape(F, W, B, 3).permute(0, 1, 3, 2).reshape(F, 3 * W, B)


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


NONFINITE_SHIFT = -2 ** 31   # the shift of a block with a non-finite value


def fixed_point_shifts(amax: torch.Tensor, rows: int) -> torch.Tensor:
    """int32 shifts of an exact fixed-point block sum, one per entry of
    ``amax`` (a block's largest |value|, over ``rows`` values): each value
    is added as ``round(x * 2^shift)`` in int64, with ``shift = 62 - e -
    ceil(log2(rows))`` for ``amax < 2^e``, so the block's sum stays below
    2^62 and no summation order moves it. Values below ``2^-shift`` lose
    only their bits under it, far below f32's rounding of the sum. A
    non-finite ``amax`` gets :data:`NONFINITE_SHIFT`: its sums come out
    NaN. Computed on ``amax``'s device, with no sync.

    The deterministic mode's kernel applies the same rule on the card
    (``csrc/node_hist_det.cu``: ``amax_bits``; ``csrc/node_hist_common.cuh``:
    ``FixedStats::shift_of``): a change here must be made there too.
    ``chip_smoke.py``'s ``check_det_edges`` holds the two bit for bit at
    the rule's edges, on both of the kernel's flush routes."""
    e = torch.frexp(amax).exponent.to(torch.int32)
    shift = 62 - (max(rows, 1) - 1).bit_length() - e
    return torch.where(torch.isfinite(amax), shift,
                       torch.full_like(shift, NONFINITE_SHIFT))


def _det_shifts(base_t: torch.Tensor, blocks: int) -> torch.Tensor:
    """``[blocks, 3]`` :func:`fixed_point_shifts` of the deterministic
    mode, from each block's largest |bf16 stat| (rounding to bf16 is
    monotone, so that is the rounded largest |stat|)."""
    rows = base_t.shape[1] // blocks
    amax = base_t.reshape(3, blocks, rows).abs().amax(dim=2).t()
    return fixed_point_shifts(amax.to(torch.bfloat16).to(torch.float32),
                              rows).contiguous()


def node_hist_det_plain(binned_t: torch.Tensor, row_pos: torch.Tensor,
                        base_t: torch.Tensor, num_nodes: int, num_bins: int,
                        blocks: int) -> torch.Tensor:
    """``[blocks, F, 3W, B]`` f32, bit-equal to kernel 1's deterministic
    mode on the same inputs: stat ``s`` of block ``j`` (``n / blocks``
    consecutive rows) is rounded to bf16 and added as ``round(x *
    2^shift[j][s])`` (:func:`_det_shifts`; half to even) with exact int64
    ``index_add_``, whose sums no order moves; each sum is converted once,
    ``(float)((double)sum * 2^-shift)``, and a (block, stat) with a
    non-finite value comes out NaN."""
    F, n = binned_t.shape
    W, B = int(num_nodes), int(num_bins)
    shift = _det_shifts(base_t, blocks)                        # [blocks, 3]
    ok = shift != NONFINITE_SHIFT
    shift = torch.where(ok, shift, torch.zeros_like(shift))
    row_ok = ok.t().repeat_interleave(n // blocks, dim=1)      # [3, n]
    bf = base_t.to(torch.bfloat16).to(torch.float64)
    bf = torch.where(row_ok, bf, torch.zeros_like(bf))
    scale = pow2(shift).t().repeat_interleave(n // blocks, dim=1)
    q = torch.round(bf * scale).to(torch.int64)   # exact product, half to even
    acc = _node_scatter(binned_t, blocks_as_nodes(row_pos, W, blocks), q.t(),
                        blocks * W, B)
    acc = acc.reshape(F, blocks, 3 * W, B).permute(1, 0, 2, 3)
    chan = torch.arange(3 * W, device=shift.device) % 3
    unscale = pow2(-shift)[:, chan][:, None, :, None]
    out = (acc.to(torch.float64) * unscale).to(torch.float32)
    return torch.where(ok[:, chan][:, None, :, None], out,
                       torch.full_like(out, float("nan"))).contiguous()


def pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` in f64, exactly, for int ``k`` in [-1022, 1023]: built from
    the exponent bits (a library ``pow`` or ``exp2`` need not be exact)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


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
