"""Serving bundles: plans written offline, graphs captured before binding.

``python -m mmlspark_tpu_torch.bundles build --model m.npz --out m.bundle``
writes an atomic, versioned, checksummed directory of the predict plans a
deployment dispatches to; ``serving_main worker --bundle`` (or
``MMLSPARK_TPU_BUNDLE_DIR``) captures each plan's CUDA graph and fills the
worker's predictor cache before the worker binds or registers, so its
first request meets no capture. The port's counterpart of
``mmlspark_tpu/bundles``.
"""

from .bundle import (BundleError, FORMAT_VERSION, MANIFEST_NAME,
                     boosters_of, build_bundle, load_model_boosters,
                     model_hash, prewarm, read_manifest,
                     runtime_fingerprint)

__all__ = ["BundleError", "FORMAT_VERSION", "MANIFEST_NAME", "boosters_of",
           "build_bundle", "load_model_boosters", "model_hash", "prewarm",
           "read_manifest", "runtime_fingerprint"]
