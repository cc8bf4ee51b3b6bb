"""The data group: the ranks rows are sharded over, and their collectives.

Counterpart of ``mmlspark_tpu/parallel/mesh.py``. The JAX package's mesh is
a grid of devices with named axes; its GBDT trainer shards rows over the
``data`` axis and sums histograms with ``psum``. Here the ``data`` axis is
a :class:`Mesh` over a ``torch.distributed`` process group — the default
group, or one process when none is initialised — with one rank per
process, each on the device its ``device=`` argument names (several ranks
may share one card). Every rank passes the same global rows; each keeps
the slice its rank selects (:func:`..placement.shard_rows`).

The collectives the trainer needs are methods of the mesh, in rank order:
:meth:`Mesh.all_reduce` (``SUM`` or ``MAX``) and :meth:`Mesh.all_gather`.
On one process they are the identity. With the ``gloo`` backend a CUDA
tensor goes through a host copy (gloo's collectives on CUDA tensors are
partial), so a two-rank check on one card can run where ``nccl`` refuses
two ranks on one GPU.

Canonical axis name: ``data``. The ``model`` and ``seq`` axes of the JAX
package are not ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..observability.env_registry import env_int

DATA_AXIS = "data"


class Mesh:
    """The data group of this process: ``ranks`` (global ranks, in order;
    position ``i`` holds row shard ``i``), the process group over them
    (None: the default group, or no group on one process) and this
    process's position in it."""

    def __init__(self, ranks: Sequence[int] = (0,), group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        me = dist.get_rank() if dist.is_initialized() else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def __repr__(self) -> str:
        return f"Mesh(data={self.size}, ranks={self.ranks}, rank={self.rank})"

    def _host_copy(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (``op``: ``sum`` or ``max``); every
        rank gets the same bits. Returns a new tensor on ``t``'s device."""
        if self.size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = t.detach().cpu() if self._host_copy(t) else t.detach().clone()
        buf = buf.contiguous()
        dist.all_reduce(buf, op=red, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0 in rank order (the
        JAX package's ``all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return t
        src = t.detach().cpu() if self._host_copy(t) else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0).to(t.device)


_default_mesh: Optional[Mesh] = None
# the world the cached default mesh was built in: a group initialised
# later makes it stale
_default_world: Optional[int] = None


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Optional[Dict[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The data group over the first ``shape["data"]`` ranks, ``ranks``, or
    (by default) every rank of the initialised world — one process when
    ``torch.distributed`` is not initialised. ``MMLSPARK_TPU_MESH_DEVICES``
    caps the default group to its first N ranks; an explicit ``shape`` or
    ``ranks`` is honored as given. A group smaller than the world is a
    ``new_group``, which every rank of the world must create together."""
    world = _world()
    if ranks is None:
        n = world
        if shape is not None:
            extra = set(shape) - {DATA_AXIS}
            if extra:
                raise NotImplementedError(
                    f"mesh axes {sorted(extra)} are not ported: the data "
                    "axis is the only one")
            n = int(shape.get(DATA_AXIS, world))
        else:
            cap = env_int("MMLSPARK_TPU_MESH_DEVICES", 0)
            if cap > 0:
                n = min(n, cap)
        ranks = range(n)
    ranks = tuple(int(r) for r in ranks)
    if not ranks or max(ranks) >= world or min(ranks) < 0:
        raise ValueError(f"mesh ranks {ranks} do not fit a world of {world}")
    if world == 1 or len(ranks) == world and ranks == tuple(range(world)):
        return Mesh(ranks)
    return Mesh(ranks, dist.new_group(list(ranks)))


def get_default_mesh() -> Mesh:
    global _default_mesh, _default_world
    if _default_mesh is None or _default_world != _world():
        _default_mesh, _default_world = make_mesh(), _world()
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh, _default_world
    _default_mesh, _default_world = mesh, _world()


@contextlib.contextmanager
def default_mesh(mesh: Mesh):
    global _default_mesh, _default_world
    prev = (_default_mesh, _default_world)
    _default_mesh, _default_world = mesh, _world()
    try:
        yield mesh
    finally:
        _default_mesh, _default_world = prev


def num_shards(mesh: Optional[Mesh] = None, axis: str = DATA_AXIS) -> int:
    mesh = mesh or get_default_mesh()
    return mesh.size if axis == DATA_AXIS else 1


def pad_rows(arr: np.ndarray, multiple: int, fill=0) -> Tuple[np.ndarray, int]:
    """Pad the row axis to a multiple so every shard is equal-sized.
    Returns (padded, original_row_count)."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), n


def validity_mask(n_valid: int, n_total: int) -> np.ndarray:
    m = np.zeros(n_total, dtype=np.float32)
    m[:n_valid] = 1.0
    return m
