"""Vowpal-Wabbit-parity online learners: hashed linear SGD, L-BFGS and
contextual bandits on the device (counterpart of ``mmlspark_tpu/models/vw``)."""

from .api import (VowpalWabbitClassificationModel, VowpalWabbitClassifier,
                  VowpalWabbitRegressionModel, VowpalWabbitRegressor)
from .bandit import (ContextualBanditMetrics, VectorZipper,
                     VowpalWabbitContextualBandit,
                     VowpalWabbitContextualBanditModel,
                     VowpalWabbitInteractions)
from .featurizer import VowpalWabbitFeaturizer

__all__ = [
    "ContextualBanditMetrics", "VectorZipper", "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel", "VowpalWabbitContextualBandit",
    "VowpalWabbitContextualBanditModel", "VowpalWabbitFeaturizer",
    "VowpalWabbitInteractions", "VowpalWabbitRegressionModel",
    "VowpalWabbitRegressor",
]
