"""Bound arithmetic, a frozen copy of ``chip_smoke.py``'s ``bound_ms``,
taken as it stood when the benchmark was defined, so that later changes to
``chip_smoke.py`` leave the yardstick alone. Only the peaks now come from
:mod:`perfbench.peaks`."""

from __future__ import annotations

from perfbench.peaks import HBM_BYTES_PER_S


def bound_ms(nbytes: int, ops: float, peak_ops: float) -> tuple:
    """Least time for the work: ``nbytes`` (each input read once, each
    output written once) at the memory rate against ``ops`` at
    ``peak_ops``; the larger one, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
