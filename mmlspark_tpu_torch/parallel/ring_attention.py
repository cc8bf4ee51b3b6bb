"""Ring attention: exact attention over sequence shards of a mesh axis.

Counterpart of ``mmlspark_tpu/parallel/ring_attention.py``. Each rank of
the sequence axis holds a sequence shard of Q, K and V; the K/V blocks
rotate around the ring (:func:`.collectives.ppermute`) while every rank
accumulates its Q block's attention with a running max and denominator
(flash-style online softmax), so memory stays O(S_local) per step. Causal
masking uses global positions, so the rotated blocks keep exact semantics.

The JAX package runs these inside ``shard_map`` with a named axis; here
they take ``(mesh, axis)``. Its ``lax.cond`` skips of fully masked blocks
are Python ``if``s on host integers (the ring position and the chunk ids
are known on the host), so a skipped block costs nothing forward or
backward. The math is the JAX package's, step for step: f32 scores and
accumulators, the ``-inf`` guards of :func:`_block_attend` and the
``1e-30`` floor of the final division. K and V travel as one stacked
tensor, one exchange a ring step, so every rank's backward runs its
exchanges in one order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .collectives import ppermute
from .mesh import Mesh

_NEG_INF = float("-inf")


def _block_attend(q, k, v, bias, acc, m, denom, scale):
    """One blockwise attention accumulation step (online softmax).

    q: [B, H, Sq, D]; k/v: [B, H, Sk, D]; bias: [Sq, Sk] additive (-inf
    masks); acc: [B, H, Sq, D] running numerator; m: [B, H, Sq] running
    max; denom: [B, H, Sq] running denominator.
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    s = s + bias[None, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows: exp(-inf - -inf) -> exp(0); zero them via where
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    denom = denom * alpha + p.sum(dim=-1)
    return acc, m_new, denom


def _init_state(B, H, S, D, device):
    return (torch.zeros((B, H, S, D), dtype=torch.float32, device=device),
            torch.full((B, H, S), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, H, S), dtype=torch.float32, device=device))


def _finish(acc, denom):
    return acc / torch.clamp(denom[..., None], min=1e-30)


def _causal_bias(q_pos, k_pos):
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], zero,
                       torch.full_like(zero, _NEG_INF))


def _ring_schedule(mesh: Mesh, axis: str, n_shards: int, me: int, k0, v0,
                   state, attend):
    """Shared K/V-rotation schedule for both ring variants: attend the
    local block, then n-1 rounds of rotate-from-neighbour + attend
    (rotating on loop exit would be a dead neighbour exchange).
    ``attend(src, k_blk, v_blk, state) -> state`` where ``src`` is the
    ring position the block started at."""
    state = attend(me, k0, v0, state)
    kv = torch.stack([k0, v0]) if n_shards > 1 else None
    for i in range(1, n_shards):
        kv = ppermute(kv, mesh, axis, 1)
        state = attend((me - i) % n_shards, kv[0], kv[1], state)
    return state


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = "seq", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact (flash-equivalent) attention with K/V rotating over ``axis``.

    q, k, v: [B, H, S_local, D], this rank's sequence shard (contiguous
    shards in axis order). Returns [B, H, S_local, D] in q's dtype.
    """
    B, H, S, D = q.shape
    n_shards = mesh.axis_size(axis)
    my_idx = mesh.axis_index(axis)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    dev = q.device

    q32 = q.float()
    ar = torch.arange(S, device=dev)
    q_pos = my_idx * S + ar

    def attend(src, k_blk, v_blk, state):
        acc, m, denom = state
        if causal:
            bias = _causal_bias(q_pos, src * S + ar)
        else:
            bias = torch.zeros((S, S), dtype=torch.float32, device=dev)
        return _block_attend(q32, k_blk, v_blk, bias, acc, m, denom, scale)

    acc, m, denom = _ring_schedule(mesh, axis, n_shards, my_idx, k.float(),
                                   v.float(), _init_state(B, H, S, D, dev),
                                   attend)
    return _finish(acc, denom).to(q.dtype)


def zigzag_global_positions(n_shards: int, seq_len: int) -> np.ndarray:
    """Global token positions each shard holds under the zig-zag layout:
    shard ``d`` gets chunk ``d`` and chunk ``2*n_shards-1-d`` of the
    ``2*n_shards`` equal chunks. Returns an int32 ``[n_shards, S_local]``
    numpy array (``S_local = seq_len // n_shards``)."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zig-zag layout needs seq_len divisible by 2*n_shards "
            f"({seq_len} vs 2*{n_shards})")
    C = seq_len // (2 * n_shards)
    rows = []
    for d in range(n_shards):
        rows.append(np.concatenate([
            d * C + np.arange(C), (2 * n_shards - 1 - d) * C + np.arange(C)]))
    return np.stack(rows).astype(np.int32)


def zigzag_permute(x, n_shards: int, axis: int) -> np.ndarray:
    """Reorder a *global* sequence axis so that a plain contiguous shard
    split over ``n_shards`` yields the zig-zag layout. Host-side prep for
    :func:`zigzag_ring_attention` callers (numpy in, numpy out)."""
    idx = zigzag_global_positions(n_shards, x.shape[axis]).reshape(-1)
    return np.take(np.asarray(x), idx, axis=axis)


def zigzag_unpermute(x, n_shards: int, axis: int) -> np.ndarray:
    """Inverse of :func:`zigzag_permute` (restores natural sequence order)."""
    idx = zigzag_global_positions(n_shards, x.shape[axis]).reshape(-1)
    inv = np.argsort(idx)
    return np.take(np.asarray(x), inv, axis=axis)


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh: Mesh, axis: str = "seq", causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causally load-balanced ring attention over zig-zag sequence shards.

    Each rank holds chunk ``me`` AND chunk ``2n-1-me`` of the ``2n`` equal
    chunks, so under a causal mask every rank computes ``2n+1`` of its
    ``4n`` chunk pairs, and the fully masked pairs (``q_chunk <
    k_chunk``) are skipped on the host. Without ``causal`` it is the plain
    ring schedule over the four pairs (nothing is skippable).

    q, k, v: ``[B, H, S_local, D]`` in the zig-zag layout (``S_local =
    2C``: first half chunk ``me``, second half chunk ``2n-1-me``; see
    :func:`zigzag_permute`). Returns the same layout.
    """
    B, H, S2, D = q.shape
    if S2 % 2:
        raise ValueError(f"zig-zag local sequence must be even, got {S2}")
    C = S2 // 2
    n_shards = mesh.axis_size(axis)
    me = mesh.axis_index(axis)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    dev = q.device

    q32 = q.float()
    ar = torch.arange(C, device=dev)
    my_chunks = (me, 2 * n_shards - 1 - me)
    q_halves = (q32[:, :, :C], q32[:, :, C:])
    # one (acc, m, denom) state per query half
    state0 = [_init_state(B, H, C, D, dev) for _ in range(2)]

    def attend_pairs(src, k_blk, v_blk, state):
        """All four (q half, k half) chunk pairs against the K/V block that
        started at ring position ``src``; fully-masked pairs skipped."""
        state = list(state)
        k_chunks = (src, 2 * n_shards - 1 - src)
        for kh in range(2):
            kc = k_chunks[kh]
            k_half = k_blk[:, :, kh * C:(kh + 1) * C]
            v_half = v_blk[:, :, kh * C:(kh + 1) * C]
            for qh in range(2):
                qc = my_chunks[qh]
                if causal and qc < kc:
                    continue
                if causal:
                    bias = _causal_bias(qc * C + ar, kc * C + ar)
                else:
                    bias = torch.zeros((C, C), dtype=torch.float32,
                                       device=dev)
                state[qh] = _block_attend(q_halves[qh], k_half, v_half, bias,
                                          *state[qh], scale)
        return state

    state = _ring_schedule(mesh, axis, n_shards, me, k.float(), v.float(),
                           state0, attend_pairs)
    out = torch.cat([_finish(acc, denom) for acc, _, denom in state], dim=2)
    return out.to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        block_size: int = 512) -> torch.Tensor:
    """Exact flash-style attention on one rank: online softmax over K/V
    blocks of ``block_size``, never materializing the [S, S] score matrix
    (memory O(S * block_size)) — the single-device analog of the ring loop
    and the local kernel Ulysses runs after its all-to-all.

    Under ``causal`` the queries are blocked too, and each Q block scans
    only its ``qb+1`` at-or-below-diagonal K blocks: the strictly-above
    blocks are fully masked and skipped, exactly."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    bs = min(int(block_size), S)
    nb = -(-S // bs)
    S_pad = nb * bs
    dev = q.device
    k32, v32 = k.float(), v.float()
    if S_pad != S:
        pad = (0, 0, 0, S_pad - S)
        k32 = torch.nn.functional.pad(k32, pad)
        v32 = torch.nn.functional.pad(v32, pad)
    q32 = q.float()
    ar = torch.arange(bs, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full_like(zero, _NEG_INF)

    def attend_block(i, q_blk, q_pos, state):
        """One K-block online-softmax accumulation against one Q block."""
        k_blk = k32[:, :, i * bs:(i + 1) * bs]
        v_blk = v32[:, :, i * bs:(i + 1) * bs]
        k_pos = i * bs + ar
        ok = (k_pos[None, :] < S).expand(q_pos.shape[0], bs)  # padded keys
        if causal:
            ok = ok & (q_pos[:, None] >= k_pos[None, :])
        bias = torch.where(ok, zero, neg)
        return _block_attend(q_blk, k_blk, v_blk, bias, *state, scale)

    if not causal:
        q_pos = torch.arange(S, device=dev)
        state = _init_state(B, H, S, D, dev)
        for i in range(nb):
            state = attend_block(i, q32, q_pos, state)
        acc, _, denom = state
        return _finish(acc, denom).to(q.dtype)

    q_pad = (torch.nn.functional.pad(q32, (0, 0, 0, S_pad - S))
             if S_pad != S else q32)
    outs = []
    for qb in range(nb):
        q_blk = q_pad[:, :, qb * bs:(qb + 1) * bs]
        q_pos = qb * bs + ar
        state = _init_state(B, H, bs, D, dev)
        for i in range(qb + 1):
            state = attend_block(i, q_blk, q_pos, state)
        acc, _, denom = state
        outs.append(_finish(acc, denom))
    return torch.cat(outs, dim=2)[:, :, :S].to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-shard reference attention (same math, no ring) for testing."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
