"""DNN path (counterpart of ``mmlspark_tpu/models/dnn``; reference:
cntk/ + image featurization).

``cnn``: torch convnets for featurization; ``scoring``:
DNNModel/ImageFeaturizer pipeline stages (CNTKModel parity); ``downloader``:
pretrained-model repository; ``transformer``: the SPMD transformer's train
step over a data x seq x model mesh (ring, zig-zag ring or Ulysses
attention); ``convert``: param trees and models between the JAX package
and the port.
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
