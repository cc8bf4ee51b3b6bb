"""DNN scoring path (counterpart of ``mmlspark_tpu/models/dnn``; reference:
cntk/ + image featurization).

``cnn``: torch convnets for featurization; ``scoring``:
DNNModel/ImageFeaturizer pipeline stages (CNTKModel parity); ``downloader``:
pretrained-model repository; ``convert``: param trees and models between
the JAX package and the port. The JAX package's ``transformer`` (a
training path over ring attention) is not ported here.
"""

from .cnn import (AlexNetConfig, CNNConfig, alexnet_feature_dim,
                  apply_alexnet, apply_cnn, feature_dim, fold_bn,
                  from_torch_resnet_state_dict, init_alexnet_params,
                  init_cnn_params)
from .downloader import ModelDownloader, ModelSchema, retry_with_timeout
from .scoring import DNNModel, ImageFeaturizer

__all__ = [
    "CNNConfig", "DNNModel", "ImageFeaturizer", "ModelDownloader",
    "ModelSchema", "apply_cnn", "feature_dim", "init_cnn_params",
    "retry_with_timeout",
]
