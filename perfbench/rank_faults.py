"""Faults planted in the port's LambdaRank lambdas underneath a run of a
ranking cell, to show that its check catches each: the lambdas of rows past
the 128th of a query left out (the padded layout's truncation), every
query's boundary moved by one row, and maxDCG taken over every place
instead of the first ``max_position``. Each wraps the objective the port
builds for ragged query groups, so it acts on both of its routes (the
kernel on the card, the plain version on the CPU). ``rank_control.py`` adds them to
``faults.FAULTS`` for ``control.py --fault``."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TRUNCATE_AT = 128


@contextlib.contextmanager
def _patched(make):
    """Every ragged LambdaRank objective the port makes while the context
    is open comes from ``make(real)``, wrapped around the real maker
    (``objectives._lambdarank_ragged(groups, max_position, sigma,
    label_gain)``)."""
    from mmlspark_tpu_torch.models.gbdt import objectives
    real = objectives._lambdarank_ragged
    objectives._lambdarank_ragged = make(real)
    try:
        yield
    finally:
        objectives._lambdarank_ragged = real


def _past(offsets: np.ndarray) -> np.ndarray:
    """Rows past the ``TRUNCATE_AT``-th of their query."""
    lengths = np.diff(offsets)
    place = np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], lengths)
    return place >= TRUNCATE_AT


def dropped_rows():
    """Rows past the 128th of their query take no part and get no lambda,
    as the padded layout's truncation leaves them."""
    def make(real):
        def build(groups, *a):
            obj = real(groups, *a)
            past = torch.from_numpy(_past(groups.offsets))

            def grad_hess(score, y, w):
                return obj.grad_hess(score, y, torch.where(
                    past.to(w.device), 0.0, w))
            return obj._replace(grad_hess=grad_hess)
        return build
    return _patched(make)


def shifted_offsets():
    """Every boundary between two queries one row later."""
    from mmlspark_tpu_torch.models.gbdt.objectives import QueryGroups

    def make(real):
        def build(groups, *a):
            moved = groups.offsets.copy()
            moved[1:-1] = np.minimum(moved[1:-1] + 1, moved[-1])
            made = {}

            def grad_hess(score, y, w):
                if "obj" not in made:
                    made["obj"] = real(QueryGroups(moved, y.cpu().numpy()),
                                       *a)
                return made["obj"].grad_hess(score, y, w)
            return real(groups, *a)._replace(grad_hess=grad_hess)
        return build
    return _patched(make)


def untruncated_maxdcg():
    """maxDCG summed over every place of the ideal order."""
    def make(real):
        def build(groups, max_position, *a):
            return real(groups, 1 << 30, *a)
        return build
    return _patched(make)


FAULTS = {f.__name__: f for f in (dropped_rows, shifted_offsets,
                                  untruncated_maxdcg)}
