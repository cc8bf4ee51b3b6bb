"""The placement decisions of multi-process GBDT training.

Counterpart of ``mmlspark_tpu/parallel/placement.py``:

* :func:`plan_for` decides per site, from the data group, whether rows are
  sharded or replicated, and records every distinct decision as a
  ``placement`` flight event (deduplicated; :func:`reset_decision_log`);
* :func:`shard_rows` (:func:`local_rows` on the host) pads rows to the
  shard multiple and keeps this rank's slice on a device — every rank
  passes the same global rows, as the JAX package's multi-host callers
  do;
* :func:`resolve_hist_blocks` validates the canonical block count of
  ``GrowConfig.hist_blocks`` against the group and the padded rows before
  training reads the config.

The JAX module's sharding constructors (``pspec``, ``sharding``,
``NamedSharding``, ``put_replicated``, ``put_tree``) have no counterpart:
a rank holds its rows as plain tensors on its own device, and the
collectives are explicit calls on the :class:`..mesh.Mesh`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, DeviceLike
from ..observability import flight as _flight
from ..observability.env_registry import env_int
from . import mesh as meshlib

DATA_AXIS = meshlib.DATA_AXIS

__all__ = ["DATA_AXIS", "PlacementPlan", "plan_for", "local_rows",
           "shard_rows", "resolve_hist_blocks", "reset_decision_log"]


def local_rows(arr: np.ndarray, mesh: Optional[meshlib.Mesh] = None,
               fill=0) -> np.ndarray:
    """This rank's slice of ``arr``'s rows padded to the shard multiple,
    on the host: rank ``i`` of ``k`` holds padded rows ``[i * n_pad / k,
    (i + 1) * n_pad / k)``."""
    mesh = mesh or meshlib.get_default_mesh()
    padded, _ = meshlib.pad_rows(np.asarray(arr), mesh.size, fill=fill)
    per = padded.shape[0] // mesh.size
    return np.ascontiguousarray(padded[mesh.rank * per:
                                       (mesh.rank + 1) * per])


def shard_rows(arr: np.ndarray, mesh: Optional[meshlib.Mesh] = None,
               fill=0, device: DeviceLike = None
               ) -> Tuple[torch.Tensor, int]:
    """:func:`local_rows` as a tensor on ``device``, with the global count
    of real rows. Callers carry a validity mask where padding could bias a
    result."""
    part = local_rows(arr, mesh, fill)
    return (torch.from_numpy(part).to(device or DEFAULT_DEVICE),
            int(np.shape(arr)[0]))


@dataclass(frozen=True)
class PlacementPlan:
    """A resolved placement decision: the group, its shard count, the
    backend (``cuda`` or ``cpu``) and the decision."""

    mesh: meshlib.Mesh
    nshards: int
    backend: str
    decision: str            # "shard_rows" | "replicate"
    axis: str = DATA_AXIS


# one flight event per DISTINCT decision, not per transfer
_SEEN_DECISIONS: set = set()


def reset_decision_log() -> None:
    """Forget emitted decisions (tests assert fresh events)."""
    _SEEN_DECISIONS.clear()


def plan_for(site: str, *, mesh: Optional[meshlib.Mesh] = None,
             rows: Optional[int] = None, replicate: bool = False,
             axis: Optional[str] = None, device: DeviceLike = None,
             **note) -> PlacementPlan:
    """Resolve the placement decision for one site: rows are sharded
    whenever the group has more than one rank, else replicated
    (``replicate=True`` forces it). ``rows`` is recorded on the event and
    does not flip the decision; ``device`` (default ``cuda``) names the
    backend. Every distinct decision is emitted as a ``placement`` flight
    event."""
    mesh = mesh or meshlib.get_default_mesh()
    axis = axis or DATA_AXIS
    nshards = meshlib.num_shards(mesh, axis)
    backend = torch.device(device or DEFAULT_DEVICE).type
    decision = "replicate" if replicate or nshards <= 1 else "shard_rows"
    mesh_shape = tuple(sorted(mesh.shape.items()))
    seen_key = (site, mesh_shape, backend, decision, axis,
                tuple(sorted(note.items())))
    if seen_key not in _SEEN_DECISIONS:
        _SEEN_DECISIONS.add(seen_key)
        _flight.record("placement", site=site, decision=decision,
                       mesh=dict(mesh.shape), nshards=nshards,
                       backend=backend, axis=axis,
                       rows=-1 if rows is None else int(rows), **note)
    return PlacementPlan(mesh=mesh, nshards=nshards, backend=backend,
                         decision=decision, axis=axis)


def resolve_hist_blocks(requested, mesh: meshlib.Mesh, n_pad: int,
                        voting: bool = False) -> int:
    """Resolve ``GrowConfig.hist_blocks`` to a concrete block count.

    ``"auto"`` reads ``MMLSPARK_TPU_HIST_BLOCKS`` (0 = the plain
    all-reduce path). An explicit count pins the canonical reduction
    geometry: histograms are computed per row block and folded in block
    order, so every world size dividing the block count grows
    bit-identical trees. Must run before training reads the config.

    An explicit request that cannot hold on this group and padding raises;
    the environment knob degrades to 0 with a flight event instead (an
    operator hint must not kill unrelated fits)."""
    nshards = meshlib.num_shards(mesh)
    from_env = False
    if requested == "auto":
        requested, from_env = env_int("MMLSPARK_TPU_HIST_BLOCKS", 0), True
    if not isinstance(requested, int) or isinstance(requested, bool):
        raise ValueError(
            f"hist_blocks must be an int or 'auto', got {requested!r}")
    if requested in (0, 1):
        return 0
    hb = int(requested)
    problem = None
    if voting:
        problem = "voting_parallel's shard-local ballot is inherently " \
                  "topology-dependent"
    elif hb % nshards:
        problem = f"block count {hb} is not a multiple of the group's " \
                  f"{nshards} data shards"
    elif n_pad % hb:
        problem = f"padded row count {n_pad} is not a multiple of {hb} " \
                  "(pad rows to the block count for topology-independent " \
                  "training)"
    if problem is None:
        return hb
    if from_env:
        _flight.record("placement", site="gbdt.hist_blocks",
                       decision="fallback_plain", requested=hb,
                       nshards=nshards, reason=problem)
        return 0
    raise ValueError(f"hist_blocks={hb}: {problem}")
