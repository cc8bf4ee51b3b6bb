"""Carry a VW model trained by the JAX package over to the port.

The JAX package's VW models hold plain numpy: the hashed weight table and
its training statistics (the linear models), the ensemble's weight blocks
and IPS/SNIPS counters (the contextual bandit). This module takes those
arrays and the model's Param values (``model.extract_param_map()`` of the
JAX model) — nothing of the JAX package is imported — and builds the port's
model, which then scores the same rows on any device.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ...core.params import set_known_params
from .api import VowpalWabbitClassificationModel, VowpalWabbitRegressionModel
from .bandit import ContextualBanditMetrics, VowpalWabbitContextualBanditModel

_LINEAR = {"classifier": VowpalWabbitClassificationModel,
           "regressor": VowpalWabbitRegressionModel}


def vw_model_from_jax(weights: np.ndarray, params: Optional[Mapping] = None,
                      stats: Optional[Mapping] = None,
                      kind: str = "classifier", device=None):
    """The port's VW classification (``kind="classifier"``) or regression
    model for a JAX model's weight table, Param values and statistics."""
    if kind not in _LINEAR:
        raise ValueError(f"kind must be one of {sorted(_LINEAR)}, got "
                         f"{kind!r}")
    w = np.asarray(weights, np.float32)
    if w.ndim != 1 or w.size & (w.size - 1):
        raise ValueError(f"weights must be one table of 2^numBits entries, "
                         f"got shape {w.shape}")
    model = _LINEAR[kind](w, dict(stats or {}))
    set_known_params(model, params, device)
    bits = int(model.get_or_default("numBits"))
    if (1 << bits) != w.size:
        model.set(numBits=int(w.size).bit_length() - 1)
    return model


def bandit_model_from_jax(shared_weights: np.ndarray,
                          action_weights: np.ndarray,
                          interaction_weights: Optional[np.ndarray] = None,
                          params: Optional[Mapping] = None,
                          metrics: Optional[Mapping] = None, device=None
                          ) -> VowpalWabbitContextualBanditModel:
    """The port's contextual-bandit model for a JAX model's weight blocks
    (``[N, d_s]``, ``[N, d_a]``, ``[N, d_s, d_a]`` or None), Param values
    and IPS/SNIPS counters (``vars(model.metrics)`` of the JAX model)."""
    skip = {"sharedWeights", "actionWeights", "interactionWeights"}
    model = VowpalWabbitContextualBanditModel(
        shared_weights=np.asarray(shared_weights, np.float32),
        action_weights=np.asarray(action_weights, np.float32),
        interaction_weights=(None if interaction_weights is None else
                             np.asarray(interaction_weights, np.float32)),
        metrics=ContextualBanditMetrics(**dict(metrics or {})))
    set_known_params(model, {k: v for k, v in (params or {}).items()
                             if k not in skip}, device)
    return model
