"""Differentiable collectives over one axis of a :class:`~.mesh.Mesh`.

Counterpart of the ``lax`` collectives the JAX package's sequence- and
tensor-parallel code calls inside ``shard_map(..., check_vma=False)``.
Under that setting JAX transposes each collective as a linear map of the
values of every device, so the backward of each function here is that
transpose, not the gradient of one rank's replica:

============  ============================  ==============================
function      forward                       backward
============  ============================  ==============================
``psum``      all-reduce sum                ``psum``
``pmean``     all-reduce mean               ``pmean``
``all_gather``  all-gather (tiled: concat)  reduce-scatter sum
``ppermute``  ring shift by ``shift``       the shift by ``-shift``
``all_to_all``  tiled: split, concatenate   the reverse all-to-all
``pmax``      all-reduce max                none (callers stop it first)
============  ============================  ==============================

So the gradient of ``psum(x).sum()`` over an axis of two ranks is 2 per
element, as in JAX. An axis of size 1 makes each of them the identity.
With ``gloo`` a CUDA tensor goes through a host copy
(:func:`.mesh.host_copy`), so several ranks may share one card. Every
rank of an axis must call the same collectives in the same order, forward
and backward.

:func:`stats` counts the calls and the bytes each rank sends per
collective (forward and backward), from :func:`reset_stats` on.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch
import torch.distributed as dist

from .mesh import Mesh, host_copy

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, Dict[str, int]] = {}


def reset_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()


def stats() -> Dict[str, Dict[str, int]]:
    """``{collective: {"calls": n, "bytes": b}}``: calls over an axis of
    more than one rank and the bytes this rank sent in them (a reduction
    counts its input once)."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _STATS.items()}


def _count(name: str, t: torch.Tensor) -> None:
    with _STATS_LOCK:
        s = _STATS.setdefault(name, {"calls": 0, "bytes": 0})
        s["calls"] += 1
        s["bytes"] += t.numel() * t.element_size()


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the contiguous buffer a collective over ``group`` takes."""
    t = t.detach()
    return (t.cpu() if host_copy(t, group) else t).contiguous()


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op,
                name: str) -> torch.Tensor:
    group = mesh.axis_group(axis)
    buf = _staged(x, group)
    if buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    _count(name, buf)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _gather(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    group = mesh.axis_group(axis)
    src = _staged(x, group)
    _count("all_gather", src)
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n = mesh.axis_size(axis)
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, "pmean") / n

    @staticmethod
    def backward(ctx, g):
        return pmean(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.mesh, ctx.axis, ctx.dim, ctx.tiled = mesh, axis, dim, tiled
        parts = _gather(x, mesh, axis)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: gloo has none, so the sum over the axis, then
        # this rank's slice
        total = _all_reduce(g, ctx.mesh, ctx.axis, dist.ReduceOp.SUM,
                            "reduce_scatter")
        i = ctx.mesh.axis_index(ctx.axis)
        if ctx.tiled:
            part = total.chunk(ctx.mesh.axis_size(ctx.axis), ctx.dim)[i]
        else:
            part = total.select(ctx.dim, i)
        return part.contiguous(), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, shift: int):
    """Send ``x`` to the rank ``shift`` places on along ``axis`` and take
    the one from ``shift`` places back (one paired send and receive)."""
    ranks = mesh.axis_ranks(axis)
    n, i = len(ranks), mesh.axis_index(axis)
    group = mesh.axis_group(axis)
    src = _staged(x, group)
    _count("ppermute", src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        # the same exchange with the two dimensions' roles swapped
        mesh, axis, split_dim, concat_dim = ctx.args
        return (all_to_all(g, mesh, axis, concat_dim, split_dim),
                None, None, None, None)


def _exchange(x, mesh, axis, split_dim, concat_dim):
    """Chunk ``j`` of ``x`` along ``split_dim`` goes to rank ``j`` of the
    axis; the chunks received are concatenated along ``concat_dim`` in
    rank order."""
    n = mesh.axis_size(axis)
    group = mesh.axis_group(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    src = _staged(torch.stack(x.chunk(n, split_dim), 0), group)
    _count("all_to_all", src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(list(out.to(x.device).unbind(0)), concat_dim)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (JAX ``lax.psum``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PSum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean of ``x`` over ``axis`` (JAX ``lax.pmean``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PMean.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Max of ``x`` over ``axis``, with no gradient: the JAX package stops
    the gradient before its ``pmax``, so ``x`` must not need one."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("pmax has no gradient: detach its input first")
    if mesh.axis_size(axis) == 1:
        return x
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in rank order: concatenated
    along ``dim`` (``tiled``) or stacked as a new ``dim`` (JAX
    ``lax.all_gather``)."""
    if mesh.axis_size(axis) == 1:
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, mesh, axis, dim, tiled)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             shift: int = 1) -> torch.Tensor:
    """The ring shift along ``axis``: rank ``i`` sends ``x`` to rank
    ``i + shift`` and returns the tensor of rank ``i - shift`` (JAX
    ``lax.ppermute`` with ``perm=[(j, (j + shift) % n)]``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PPermute.apply(x, mesh, axis, shift)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX ``lax.all_to_all(..., tiled=True)``: ``x`` split into ``n``
    chunks along ``split_dim``, chunk ``j`` to rank ``j``, the chunks
    received concatenated along ``concat_dim`` in rank order. (The JAX
    package calls only the tiled form; its untiled one has no working
    transpose to copy.)"""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
