"""The mesh: a grid of ``torch.distributed`` ranks with named axes.

Counterpart of ``mmlspark_tpu/parallel/mesh.py``. The JAX package's mesh is
a grid of devices with named axes; its GBDT trainer shards rows over the
``data`` axis and sums histograms with ``psum``, and its transformer adds
``seq`` and ``model``. Here a :class:`Mesh` is a grid of ranks of a
``torch.distributed`` process group — the default group, or one process
when none is initialised — with one rank per process, each on the device
its ``device=`` argument names (several ranks may share one card). Ranks
are laid out row-major over the axes in the order given, as the JAX
package reshapes its device list. Each axis has one process group per line
of the grid along it; :meth:`Mesh.axis_index` and :meth:`Mesh.axis_size`
place this process on each axis, and :mod:`.collectives` runs the
differentiable collectives over one axis.

The data axis keeps its own surface, which the GBDT, VW and ALS trainers
read: ``size``, ``rank``, ``ranks``, ``group``, and the collectives
:meth:`Mesh.all_reduce` (``SUM`` or ``MAX``) and :meth:`Mesh.all_gather`,
in rank order; for host objects :meth:`Mesh.from_first` (rank 0 computes,
every rank receives, rank 0's exception is raised everywhere) and
:meth:`Mesh.check_same` (under ``nccl`` these pickle through the current
CUDA device, so each rank must have set its own). Every rank passes the
same global rows; each keeps the slice its data rank selects
(:func:`..placement.shard_rows`). On one
process every axis has size 1 and the collectives are the identity. With
the ``gloo`` backend a CUDA tensor goes through a host copy (gloo's
collectives on CUDA tensors are partial), so a check of several ranks on
one card can run where ``nccl`` refuses two ranks on one GPU.

Canonical axis names: ``data`` (rows, batch), ``seq`` (sequence shards)
and ``model`` (tensor-parallel shards).
"""

from __future__ import annotations

import contextlib
import pickle
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..observability.env_registry import env_int

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def host_copy(t: torch.Tensor, group=None) -> bool:
    """Whether a collective over ``group`` takes ``t`` through the host:
    a CUDA tensor under ``gloo``."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class Mesh:
    """This process's place in a grid of ranks.

    ``ranks``/``group``: the data axis (global ranks in order, position
    ``i`` holds row shard ``i``; the process group over them, None for the
    default group or no group on one process). ``axes``: for a mesh of
    more axes, ``{name: (ranks, group)}`` in the mesh's order, each the
    line of the grid through this process along that axis (the data axis
    included)."""

    def __init__(self, ranks: Sequence[int] = (0,), group=None,
                 axes: Optional[Dict[str, Tuple[Sequence[int], Any]]] = None):
        if axes is None:
            axes = {DATA_AXIS: (ranks, group)}
        self.axes = {name: (tuple(int(r) for r in rs), g)
                     for name, (rs, g) in axes.items()}
        data = self.axes.get(DATA_AXIS, ((self._me(),), None))
        self.ranks, self.group = data
        me = self._me()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @staticmethod
    def _me() -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return {name: len(rs) for name, (rs, _) in self.axes.items()}

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return len(self.axes[axis][0]) if axis in self.axes else 1

    def axis_index(self, axis: str) -> int:
        """This process's position along ``axis`` (0 for an axis the mesh
        does not have; -1 outside the mesh)."""
        if axis == DATA_AXIS:
            return self.rank
        if axis not in self.axes:
            return 0
        rs = self.axes[axis][0]
        me = self._me()
        return rs.index(me) if me in rs else -1

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this process's line along ``axis``."""
        return self.axes[axis][0] if axis in self.axes else (self._me(),)

    def axis_group(self, axis: str):
        return self.axes[axis][1] if axis in self.axes else None

    def __repr__(self) -> str:
        if list(self.axes) == [DATA_AXIS]:
            return (f"Mesh(data={self.size}, ranks={self.ranks}, "
                    f"rank={self.rank})")
        where = ", ".join(f"{a}={self.axis_index(a)}/{self.axis_size(a)}"
                          for a in self.axes)
        return f"Mesh({where})"

    def _host_copy(self, t: torch.Tensor) -> bool:
        return host_copy(t, self.group)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the data group (``op``: ``sum`` or ``max``);
        every rank gets the same bits. Returns a new tensor on ``t``'s
        device."""
        if self.size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = t.detach().cpu() if self._host_copy(t) else t.detach().clone()
        buf = buf.contiguous()
        dist.all_reduce(buf, op=red, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` concatenated along axis 0 in rank order
        (the JAX package's ``all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return t
        src = t.detach().cpu() if self._host_copy(t) else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0).to(t.device)

    def from_first(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on the data group's rank 0 alone, its result
        handed to every rank (``broadcast_object_list`` over the group).
        An exception on rank 0 is raised on every rank (its own type where
        it pickles, else a ``RuntimeError`` naming it), so no rank waits
        on a peer that has given up."""
        out = err = None
        if self.rank == 0:
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — raised on every rank
                err = e
        if self.size > 1:
            sent = err
            if err is not None:
                try:
                    pickle.dumps(err)
                except Exception:  # noqa: BLE001
                    sent = RuntimeError(f"rank 0 of {self} failed: {err!r}")
            box = [(out, sent)]
            dist.broadcast_object_list(box, src=self.ranks[0],
                                       group=self.group)
            if self.rank != 0:
                out, err = box[0]
        if err is not None:
            raise err
        return out

    def check_same(self, value: Any, what: str) -> None:
        """Raise ``ValueError`` on every rank unless ``value`` (a small
        picklable object) is equal on every rank of the data group."""
        if self.size == 1:
            return
        got = [None] * self.size
        dist.all_gather_object(got, value, group=self.group)
        if any(g != got[0] for g in got[1:]):
            raise ValueError(f"{what} differs across the data group's ranks "
                             f"{self.ranks}: {got}")


_default_mesh: Optional[Mesh] = None
# the world the cached default mesh was built in: a group initialised
# later makes it stale
_default_world: Optional[int] = None


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _grid_mesh(shape: Dict[str, int], ranks: Tuple[int, ...],
               world: int) -> Mesh:
    """The mesh of ``shape`` over ``ranks``, row-major. Every rank of the
    world creates every line's group, axis by axis, line by line, in the
    same order; an axis of size 1 (or a one-process world) needs none."""
    sizes = [int(s) for s in shape.values()]
    grid = np.array(ranks, dtype=np.int64).reshape(sizes)
    me = Mesh._me()
    axes = {}
    for i, name in enumerate(shape):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        mine = None
        for line in lines:
            line = tuple(int(r) for r in line)
            group = None
            if sizes[i] > 1 and world > 1 and line != tuple(range(world)):
                group = dist.new_group(list(line))
            if me in line:
                mine = (line, group)
        # a process outside the grid keeps the first line (it is no
        # member: its axis indices read -1)
        axes[name] = mine if mine is not None else (
            tuple(int(r) for r in lines[0]), None)
    return Mesh(axes=axes)


def make_mesh(shape: Optional[Dict[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the first ``prod(shape)`` ranks, ``ranks``, or (by
    default) every rank of the initialised world on the ``data`` axis —
    one process when ``torch.distributed`` is not initialised.

    ``shape`` maps axis name -> size, in order (``data``, ``seq``,
    ``model``); ranks are laid out row-major over it. A data-only shape
    keeps the data group of before: ``MMLSPARK_TPU_MESH_DEVICES`` caps the
    default group to its first N ranks, an explicit ``shape`` or ``ranks``
    is honored as given, and a group smaller than the world is a
    ``new_group``. A shape of more axes builds one group per line of the
    grid along each axis; every rank of the world must call this
    together."""
    world = _world()
    if shape is not None and set(shape) - {DATA_AXIS}:
        total = int(np.prod([int(s) for s in shape.values()]))
        ranks = tuple(range(total)) if ranks is None else tuple(
            int(r) for r in ranks)
        if len(ranks) != total:
            raise ValueError(f"mesh shape {shape} needs {total} ranks, "
                             f"given {len(ranks)}")
        if not ranks or max(ranks) >= world or min(ranks) < 0:
            raise ValueError(f"mesh shape {shape} needs {total} ranks, "
                             f"have a world of {world}")
        return _grid_mesh(dict(shape), ranks, world)
    if ranks is None:
        n = world
        if shape is not None:
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
    return mesh.axis_size(axis)


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
