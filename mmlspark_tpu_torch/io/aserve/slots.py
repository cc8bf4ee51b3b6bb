"""Pinned staging buffers: the zero-copy half of continuous batching.

Counterpart of ``mmlspark_tpu/io/aserve/slots.py``. The threaded engine
builds every device batch as list-of-rows -> array — one full
Python-side copy per batch, on the scoring thread, while the device
waits. Here the copy disappears: rows decode straight into a
pre-allocated ``[slots, width]`` host tensor in the predict lane's
staged dtype at ADMISSION time (on the event loop, overlapped with
device compute), and the scoring call receives a pow2-bucket *view* of
that tensor — the only remaining transfers are the one h2d upload of
the view in ``Booster.predict`` and the one d2h of its results. The
buffers are torch tensors because the bf16 lane has no numpy dtype
without ``ml_dtypes``; with a ``cuda`` scorer they sit in pinned
memory, so the upload runs without a staging copy.

Two ping-pong buffers make this safe without copies: the loop fills
the FORMING buffer while the scoring thread reads the DISPATCHED one;
:meth:`SlotTable.flip` swaps them at dispatch. One scoring thread owns
the device, so two buffers are exactly enough. A pinned buffer must not
be rewritten while its upload is in flight: the scorer returns only
after the d2h of its results (``.cpu()`` waits for the stream that also
carried the upload), and the buffer becomes the forming target again
only at the NEXT flip, after that return.

Sizing: ``slots`` is the device-batch slot count — the pow2 bucket cap
the predictor sees. ``MMLSPARK_TPU_ASERVE_SLOTS`` overrides it
fleet-wide (0 keeps the per-query ``max_batch``); the admission
backlog bound stays ``MMLSPARK_TPU_MAX_QUEUE_DEPTH``, shared with the
threaded engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...observability import hbm as _hbm
from ...observability.env_registry import env_int
from ..serving import bucket_size

SLOTS_ENV = "MMLSPARK_TPU_ASERVE_SLOTS"


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def resolve_slots(max_batch: int, row_bytes: "int | None" = None) -> int:
    """The effective slot count: the env override when set (>0), else
    ``max_batch``; always rounded up to a power of two so the bucket
    ladder is exact.

    ``MMLSPARK_TPU_ASERVE_SLOTS=auto`` asks the auto-tuner (tuning
    site 4) for the measured size — the p99.9 of observed admitted-batch
    rows reconciled against the ``aserve_slots`` HBM claim headroom. A
    first process with no measured decision sizes statically (the
    untuned rule); the raw-string check matters because ``env_int``
    maps any unparseable value to its default, which would silently turn
    ``auto`` into the static path with no tuner consult."""
    import os

    raw = (os.environ.get(SLOTS_ENV) or "").strip().lower()
    if raw == "auto":
        from ... import tuning as _tuning
        tuned = _tuning.resolve_slots_auto(max_batch, row_bytes=row_bytes)
        return _pow2_ceil(tuned if tuned else max_batch)
    n = env_int(SLOTS_ENV, 0)
    if n <= 0:
        n = max_batch
    return _pow2_ceil(n)


def staging_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or anything numpy names
    (``"float32"``, ``np.uint8``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def dtype_name(dtype) -> str:
    """The numpy-style name of a staging dtype (``float32``,
    ``bfloat16``, ``uint8``), as the JAX package's flight events carry
    it."""
    return str(staging_torch_dtype(dtype)).replace("torch.", "")


class SlotTable:
    """Ping-pong pow2 staging for one serving query's feature rows.

    ``dtype`` is the LANE's staging dtype (``quantize.staging_dtype``):
    a narrow predict lane allocates narrow buffers, so the
    ``aserve_slots`` device-memory claim — and the one h2d per dispatch
    — shrinks 4x (int8) / 2x (bf16) with no further code. ``quantizer``
    is the admission transform from ``quantize.row_quantizer`` (None =
    plain cast): raw float rows MUST pass through it on a narrow table,
    since a bare cast of floats to bin-id ``uint8`` would truncate
    values instead of binning them. ``pin_memory`` allocates the buffers
    in page-locked host memory (for a ``cuda`` scorer).
    """

    def __init__(self, slots: int, width: int, dtype=torch.float32,
                 quantizer=None, pin_memory: bool = False):
        if slots < 1 or width < 1:
            raise ValueError(f"slot table needs slots>=1 and width>=1, "
                             f"got {slots}x{width}")
        self.slots = _pow2_ceil(slots)
        self.width = int(width)
        self.quantizer = quantizer
        self.dtype = staging_torch_dtype(dtype)
        self._bufs = tuple(torch.zeros((self.slots, self.width),
                                       dtype=self.dtype,
                                       pin_memory=pin_memory)
                           for _ in range(2))
        self._active = 0
        # device-memory ledger claim: both ping-pong staging buffers,
        # held for the table's lifetime (released via release_claim() at
        # server stop)
        self._claimed = float(sum(b.numel() * b.element_size()
                                  for b in self._bufs))
        _hbm.claim("aserve_slots", self._claimed)

    def release_claim(self) -> None:
        """Give the staging buffers' ledger claim back (idempotent —
        the owning server calls this once at stop)."""
        if self._claimed:
            _hbm.release("aserve_slots", self._claimed)
            self._claimed = 0.0

    @property
    def forming(self) -> torch.Tensor:
        """The buffer the loop is currently decoding arrivals into."""
        return self._bufs[self._active]

    def write(self, slot: int, row) -> None:
        """Decode one request's features into ``forming[slot]`` — THE
        admission-time copy (list/JSON -> staged row), after which the
        row is never touched again until the device upload."""
        if self.quantizer is not None:
            row = self.quantizer(row)
        if not isinstance(row, torch.Tensor):
            row = np.asarray(row)
            if row.dtype == object or row.dtype.kind not in "biuf":
                row = row.astype(np.float32)
            row = torch.from_numpy(row)
        if tuple(row.shape) != (self.width,):
            raise ValueError(f"feature row has shape {tuple(row.shape)}, "
                             f"expected ({self.width},)")
        self._bufs[self._active][slot].copy_(row.to(self.dtype))

    def flip(self) -> torch.Tensor:
        """Dispatch: hand the forming buffer to the scoring thread and
        make the other buffer the new forming target."""
        dispatched = self._bufs[self._active]
        self._active ^= 1
        return dispatched

    @staticmethod
    def bucket_view(buf: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
        """``(view, bucket)``: the pow2-bucket slice the predictor
        scores. Padding rows repeat row 0 (the
        ``bucketed_model_transform`` convention) so stale bytes from a
        previous batch can't leak NaN-shaped behavior into the pad."""
        b = bucket_size(n, buf.shape[0])
        if n < b:
            if n:
                buf[n:b] = buf[0]
            else:
                buf[:b].zero_()
        return buf[:b], b
