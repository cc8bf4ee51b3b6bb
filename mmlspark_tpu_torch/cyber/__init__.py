"""CyberML: security-analytics estimators (access-anomaly detection).

Counterpart of ``mmlspark_tpu/cyber/`` (reference: src/main/python/mmlspark/
cyber/ — 1,962 LoC). The Spark ALS substrate is replaced with ALS on the
device (batched normal-equation solves, :func:`.anomaly.als_fit`); the
per-tenant dataframe joins become columnar numpy group-bys on the host,
copied from the JAX package.
"""

from .feature import (IdIndexer, IdIndexerModel, LinearScalarScaler,
                      LinearScalarScalerModel, MultiIndexer, MultiIndexerModel,
                      StandardScalarScaler, StandardScalarScalerModel)
from .complement import ComplementAccessTransformer
from .anomaly import AccessAnomaly, AccessAnomalyConfig, AccessAnomalyModel
from .dataset import DataFactory

__all__ = [
    "DataFactory",
    "AccessAnomaly", "AccessAnomalyConfig", "AccessAnomalyModel",
    "ComplementAccessTransformer", "IdIndexer", "IdIndexerModel",
    "LinearScalarScaler", "LinearScalarScalerModel", "MultiIndexer",
    "MultiIndexerModel", "StandardScalarScaler", "StandardScalarScalerModel",
]
