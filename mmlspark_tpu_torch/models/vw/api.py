"""VowpalWabbit-style estimators: online linear learners on the device.

Counterpart of ``mmlspark_tpu/models/vw/api.py``, with every Param, plus one,
``device`` (default ``cuda``; ``cpu`` only when asked), as the GBDT
estimators have. Parity with the reference's VW stages (reference: vw/VowpalWabbitBase.scala:71-521,
VowpalWabbitClassifier.scala, VowpalWabbitRegressor.scala,
VowpalWabbitBaseModel.scala:23-115). Param names match the reference; the
``passThroughArgs`` escape hatch accepts a VW-style argument string and maps
the supported subset onto SGDConfig (the reference forwards it to C++;
:77-81), so existing VW invocations port over.
"""

from __future__ import annotations

import os
import shlex
from typing import Optional

import numpy as np

import torch

from ...core.dataset import Dataset
from ...core.params import (HasFeaturesCol, HasLabelCol, HasPredictionCol,
                            HasProbabilityCol, HasRawPredictionCol,
                            HasWeightCol, Param, TypeConverters)
from ...core.pipeline import Estimator, Model
from ...utils.stopwatch import StopWatch
from .sgd import SGDConfig, predict_sgd, train_sgd


def _to_device(v):
    return None if v is None else str(v)

# VW's hardcoded intercept ("constant") feature index — every example gets
# it unless --noconstant (reference: the vw core's `constant` symbol; the
# JNI learners inherit it from libvw)
VW_CONSTANT_INDEX = 11650396


class _VowpalWabbitBaseParams(HasLabelCol, HasFeaturesCol, HasWeightCol,
                              HasPredictionCol):
    device = Param("device", "Device to fit and score on: 'cuda' (default) "
                   "or 'cpu'", None, _to_device)
    featuresCol = Param("featuresCol", "Base name of the hashed features columns "
                        "(expects <name>_indices / <name>_values)", "features",
                        TypeConverters.to_string)
    numBits = Param("numBits", "Weight space is 2^numBits", 18, TypeConverters.to_int)
    learningRate = Param("learningRate", "SGD learning rate", 0.5,
                         TypeConverters.to_float)
    powerT = Param("powerT", "Learning-rate decay exponent", 0.5,
                   TypeConverters.to_float)
    initialT = Param("initialT", "Initial example count t", 0.0,
                     TypeConverters.to_float)
    l1 = Param("l1", "L1 regularization", 0.0, TypeConverters.to_float)
    l2 = Param("l2", "L2 regularization", 0.0, TypeConverters.to_float)
    numPasses = Param("numPasses", "Passes over the data "
                      "(sync/AllReduce at each pass end)", 1, TypeConverters.to_int)
    adaptive = Param("adaptive", "AdaGrad-style adaptive updates (--adaptive)",
                     True, TypeConverters.to_bool)
    batchSize = Param("batchSize", "Minibatch size of the SGD loop "
                      "(1 = strict online order)", 128, TypeConverters.to_int)
    passThroughArgs = Param("passThroughArgs", "VW-style argument string", "",
                            TypeConverters.to_string)
    noConstant = Param("noConstant", "Drop VW's implicit intercept feature "
                       "(--noconstant)", False, TypeConverters.to_bool)
    initialModel = Param("initialModel",
                         "Warm-start weights: a raw weight array, or a "
                         "fitted VW model (preferred — its constant-feature "
                         "format marker is then checked against this "
                         "estimator's noConstant; raw pre-v2 arrays require "
                         "noConstant=True by hand)", None, is_complex=True)
    checkpointDir = Param("checkpointDir",
                          "Pass-level checkpoint directory: each finished "
                          "pass saves full optimizer state and training "
                          "resumes from the newest one (preemption-safe)",
                          None, TypeConverters.to_string)
    additionalFeatures = Param(
        "additionalFeatures", "Additional hashed feature column base names "
        "appended to featuresCol — each column acts as a VW namespace "
        "(reference: VowpalWabbitBase additionalFeatures)", None,
        TypeConverters.to_list_string)
    ignoreNamespaces = Param(
        "ignoreNamespaces", "Drop feature columns (namespaces) whose name "
        "starts with one of these letters (VW --ignore; here a namespace "
        "is a features column, so the first letter of its base name is "
        "matched)", None, TypeConverters.to_string)
    useBarrierExecutionMode = Param(
        "useBarrierExecutionMode", "Ignored: every rank of the data group "
        "runs every step", False, TypeConverters.to_bool)
    performanceStatistics = Param(
        "performanceStatistics", "Accepted for reference parity: the "
        "fitted model's get_performance_statistics() returns the same "
        "TrainingStats table the reference stored under this param", None,
        is_complex=True)

    def _parse_args(self) -> dict:
        """Map the supported subset of VW command-line args onto config."""
        out = {}
        args = self.get_or_default("passThroughArgs")
        if not args:
            return out
        toks = shlex.split(args)
        i = 0
        while i < len(toks):
            t = toks[i]

            def val():
                return toks[i + 1]

            if t in ("-b", "--bit_precision"):
                out["num_bits"] = int(val()); i += 2
            elif t in ("-l", "--learning_rate"):
                out["learning_rate"] = float(val()); i += 2
            elif t == "--l1":
                out["l1"] = float(val()); i += 2
            elif t == "--l2":
                out["l2"] = float(val()); i += 2
            elif t == "--passes":
                out["num_passes"] = int(val()); i += 2
            elif t == "--adaptive":
                out["adaptive"] = True; i += 1
            elif t == "--sgd":
                out["adaptive"] = False; i += 1
            elif t == "--bfgs":
                # VW batch mode: full-batch L-BFGS, --passes bounds iterations
                out["optimizer"] = "bfgs"; i += 1
            elif t == "--loss_function":
                out["loss"] = val(); i += 2
            elif t == "--power_t":
                out["power_t"] = float(val()); i += 2
            elif t == "--initial_t":
                out["initial_t"] = float(val()); i += 2
            elif t == "--quantile_tau":
                out["quantile_tau"] = float(val()); i += 2
            else:
                i += 1  # unknown args tolerated (defaults live downstream)
        return out

    def _sgd_config(self, default_loss: str) -> SGDConfig:
        cfg = SGDConfig(
            num_bits=self.get_or_default("numBits"),
            loss=default_loss,
            learning_rate=self.get_or_default("learningRate"),
            power_t=self.get_or_default("powerT"),
            initial_t=self.get_or_default("initialT"),
            l1=self.get_or_default("l1"),
            l2=self.get_or_default("l2"),
            adaptive=self.get_or_default("adaptive"),
            num_passes=self.get_or_default("numPasses"),
            batch_size=self.get_or_default("batchSize"),
        )
        overrides = self._parse_args()
        return cfg._replace(**overrides) if overrides else cfg

    def _effective_no_constant(self) -> bool:
        """The constant feature is dropped by EITHER the noConstant Param or
        a --noconstant token in passThroughArgs (_features honors both);
        format-compatibility checks must compare this effective flag."""
        return bool(self.get_or_default("noConstant")
                    or "--noconstant" in shlex.split(
                        self.get_or_default("passThroughArgs")))

    def _features(self, dataset: Dataset):
        bases = [self.get_or_default("featuresCol")]
        bases += list(self.get_or_default("additionalFeatures") or [])
        ign = self.get_or_default("ignoreNamespaces") or ""
        kept = [b for b in bases if not (b and b[0] in ign)]
        if not kept:
            raise ValueError(
                f"ignoreNamespaces={ign!r} drops every features column "
                f"({bases}); no feature columns remain")
        if len(kept) == 1:       # common case: no extra copy
            idx = dataset.array(f"{kept[0]}_indices", np.int32)
            val = dataset.array(f"{kept[0]}_values", np.float32)
        else:
            idx = np.concatenate(
                [dataset.array(f"{b}_indices", np.int32) for b in kept],
                axis=1)
            val = np.concatenate(
                [dataset.array(f"{b}_values", np.float32) for b in kept],
                axis=1)
        no_const = self._effective_no_constant()
        if not no_const:
            # VW adds an implicit intercept ("constant") feature to every
            # example at its hardcoded index (vw's `constant = 11650396`),
            # folded by the same 2^b weight-table mask as everything else.
            # Shared by fit and transform so feature identity always agrees.
            n = idx.shape[0]
            idx = np.concatenate(
                [idx, np.full((n, 1), VW_CONSTANT_INDEX, np.int32)], axis=1)
            val = np.concatenate([val, np.ones((n, 1), np.float32)], axis=1)
        return idx, val

    def _resolve_initial_weights(self, cfg: SGDConfig):
        init = self.get_or_default("initialModel")
        if init is not None and hasattr(init, "weights"):
            # fitted-model warm start: the model carries its constant-feature
            # format (pre-v2 loads set noConstant=True in _load_extra); its
            # weight table only matches an estimator with the same EFFECTIVE
            # setting (Param or --noconstant passthrough, like _features)
            m_nc = (init._effective_no_constant()
                    if hasattr(init, "_effective_no_constant")
                    else bool(init.get_or_default("noConstant")))
            e_nc = self._effective_no_constant()
            if m_nc != e_nc:
                raise ValueError(
                    f"initialModel was trained with noConstant={m_nc} but "
                    f"this estimator has noConstant={e_nc}; set them equal "
                    "(models saved before the implicit constant feature "
                    "existed load with noConstant=True)")
            init = init.weights
        if init is not None and len(init) != (1 << cfg.num_bits):
            raise ValueError(
                f"initialModel weight table has {len(init)} entries but "
                f"numBits={cfg.num_bits} implies {1 << cfg.num_bits}; set "
                "numBits to match the warm-start model's")
        return init

    def _fit_weights_streamed(self, index_path, value_path, label_path,
                              weight_path, cfg: SGDConfig,
                              chunk_rows):  # None -> trainer default
        """Out-of-core fit: pre-hashed .npy shards -> weights + stats.

        The streamed counterpart of ``_fit_weights`` (reference VW trains
        from streamed Spark partitions; here the stream is explicit disk
        shards, mirroring GBDT's ``construct(path=...)``). Shards carry
        ALREADY-HASHED features — the output of
        :class:`VowpalWabbitFeaturizer` written chunk-wise — including the
        constant feature if the estimator expects one (noConstant=False),
        since hashing happens at write time, not here.
        """
        if cfg.optimizer == "bfgs":
            raise ValueError(
                "--bfgs is a batch solver over in-memory arrays; the "
                "streamed path supports the sgd optimizer only")
        if self.get_or_default("checkpointDir"):
            raise ValueError(
                "checkpointDir is not supported with streamed fits yet; "
                "chunk-level state already bounds re-run cost")
        if self.get_or_default("weightCol") and weight_path is None:
            raise ValueError(
                "weightCol is set but no weight_path was given; streamed "
                "fits read sample weights from shards — pass weight_path= "
                "or clear weightCol to train unweighted")
        from ..gbdt.ingest import ShardedMatrixSource
        from .sgd import train_sgd_streamed
        init = self._resolve_initial_weights(cfg)
        # coerce once; train_sgd_streamed accepts sources, so the shard
        # headers are parsed a single time and n comes from the same object
        label_src = ShardedMatrixSource.coerce(label_path)
        n = label_src.n
        sw_time = StopWatch()
        with sw_time:
            weights = train_sgd_streamed(
                index_path, value_path, label_src, weight_path,
                cfg=cfg, initial_weights=init, chunk_rows=chunk_rows,
                device=self.get_or_default("device"))
        stats = {
            "numExamples": n,
            "learnTimeNs": sw_time.elapsed_ns(),
            "numBits": cfg.num_bits,
            "numPasses": cfg.num_passes,
            "numWeights": int((weights != 0).sum()),
        }
        return weights, stats

    def _fit_weights(self, dataset: Dataset, cfg: SGDConfig):
        idx, val = self._features(dataset)
        # VW semantics: the weight table masks hashes by 2^numBits (-b at
        # access time), so a featurizer hashed wider than the learner folds
        # by masking — never by index clamping
        idx = idx & ((1 << cfg.num_bits) - 1)
        y = dataset.array(self.get_or_default("labelCol"), np.float32)
        wcol = self.get_or_default("weightCol")
        sw = dataset.array(wcol, np.float32) if wcol else None
        init = self._resolve_initial_weights(cfg)
        ckpt_dir = self.get_or_default("checkpointDir")
        dev = self.get_or_default("device")
        sw_time = StopWatch()
        with sw_time:
            if cfg.optimizer == "bfgs":
                if ckpt_dir:
                    raise ValueError(
                        "checkpointDir is not supported with --bfgs "
                        "(batch iterations are cheap to rerun; step-level "
                        "checkpointing covers the sgd path)")
                from .sgd import train_bfgs
                weights = train_bfgs(idx, val, y, sw, cfg,
                                     initial_weights=init, device=dev)
            elif ckpt_dir:
                from .sgd import train_sgd_checkpointed
                weights = train_sgd_checkpointed(idx, val, y, sw, cfg,
                                                 ckpt_dir,
                                                 initial_weights=init,
                                                 device=dev)
            else:
                weights = train_sgd(idx, val, y, sw, cfg,
                                    initial_weights=init, device=dev)
        stats = {
            "numExamples": len(y),
            "learnTimeNs": sw_time.elapsed_ns(),
            "numBits": cfg.num_bits,
            "numPasses": cfg.num_passes,
            "numWeights": int((weights != 0).sum()),
        }
        return weights, stats


class _VowpalWabbitModelBase(Model, _VowpalWabbitBaseParams):
    """Trained linear model (reference: vw/VowpalWabbitBaseModel.scala:23-115)."""

    def __init__(self, weights: Optional[np.ndarray] = None, stats: Optional[dict] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.weights = weights
        self.stats = stats or {}

    def _margin(self, dataset: Dataset) -> np.ndarray:
        idx, val = self._features(dataset)
        # same 2^numBits weight-table mask as training
        idx = idx & (len(self.weights) - 1)
        return predict_sgd(idx, val, self.weights,
                           device=self.get_or_default("device"))

    def predict_margin_streamed(self, index_path, value_path, *,
                                chunk_rows: int = 262_144, out_dir=None):
        """Margins over pre-hashed ``.npy`` shards in bounded row chunks —
        the scoring side of the out-of-core story (``fit_streamed`` is
        the training side). Chunks are independent dot products, so
        streamed margins equal in-memory margins bit-for-bit. Index
        shards fold by ``2^numBits`` at read time like ``fit_streamed``.
        Returns concatenated margins, or shard paths with ``out_dir``.
        """
        from ...device import resolve_device
        from ...io.streaming import stream_apply
        from ..gbdt.ingest import ShardedMatrixSource

        idx_src = ShardedMatrixSource.coerce(index_path)
        val_src = ShardedMatrixSource.coerce(value_path)
        if idx_src.n != val_src.n:
            raise ValueError(
                f"index rows {idx_src.n} != value rows {val_src.n}")
        if idx_src.row_shape != val_src.row_shape:
            raise ValueError(
                f"index row shape {idx_src.row_shape} != value row shape "
                f"{val_src.row_shape}")
        # swapped-argument guard: both sources are [n, nnz], but float
        # index shards silently truncate to garbage hashes
        probe = idx_src.read(0, 1, dtype=None)
        if probe.size and probe.dtype.kind not in "iu":
            raise ValueError(
                f"index shards must be integer dtype, got {probe.dtype} — "
                "were index_path and value_path swapped?")
        if out_dir is not None:
            # stream_apply guards out_dir against the VALUE source only;
            # overwriting the index shards mid-stream must also be refused
            out_real = os.path.realpath(os.fspath(out_dir))
            if any(os.path.realpath(os.path.dirname(p)) == out_real
                   for p in idx_src.paths):
                raise ValueError(
                    "out_dir contains the index shards; writing outputs "
                    "there would delete inputs mid-stream")
        mask = len(self.weights) - 1
        dev = resolve_device(self.get_or_default("device"))
        # one upload for all chunks: the table stays resident
        w_dev = torch.from_numpy(np.asarray(self.weights, np.float32)).to(dev)
        # stream_apply's contract walks [0, n) in order, one bounded chunk
        # at a time — the cursor below pairs each value chunk with the
        # matching index rows without loading the index side whole
        pos = [0]

        def score(val_chunk: np.ndarray) -> np.ndarray:
            start = pos[0]
            stop = start + len(val_chunk)
            pos[0] = stop
            idx = (idx_src.read(start, stop, dtype=None)
                   .astype(np.int64) & mask).astype(np.int32)
            return predict_sgd(idx, val_chunk, w_dev, device=dev)

        return stream_apply(val_src, score, chunk_rows=chunk_rows,
                            out_dir=out_dir)

    def get_performance_statistics(self) -> Dataset:
        """Diagnostics DataFrame parity (reference: VowpalWabbitBase.scala:27-46
        TrainingStats surfaced at VowpalWabbitBaseModel.scala:86-92)."""
        return Dataset({k: np.asarray([v]) for k, v in self.stats.items()})

    def get_readable_model(self) -> Dataset:
        """Non-zero weights as (index, weight) rows
        (readable-model dump parity, VowpalWabbitBaseModel.scala:70-84)."""
        nz = np.nonzero(self.weights)[0]
        return Dataset({"index": nz.astype(np.int64),
                        "weight": self.weights[nz].astype(np.float64)})

    def _save_extra(self, path: str) -> None:
        import os
        # format marker v2: weights were trained WITH the implicit constant
        # feature (unless noConstant); its absence on load identifies models
        # saved before the constant feature existed
        np.savez_compressed(os.path.join(path, "weights"), w=self.weights,
                            vw_format=np.asarray(2),
                            **{f"stat_{k}": np.asarray(v) for k, v in self.stats.items()})

    def _load_extra(self, path: str) -> None:
        import os
        z = np.load(os.path.join(path, "weights.npz"))
        self.weights = z["w"]
        self.stats = {k[5:]: z[k].item() for k in z.files if k.startswith("stat_")}
        if "vw_format" not in z.files:
            # pre-constant-feature model: scoring must not append a feature
            # the training run never saw (its hash slot holds an unrelated
            # colliding weight)
            self.set(noConstant=True)


class VowpalWabbitClassifier(Estimator, _VowpalWabbitBaseParams,
                             HasRawPredictionCol, HasProbabilityCol):
    """Binary linear classifier, logistic loss (reference:
    vw/VowpalWabbitClassifier.scala)."""

    lossFunction = Param("lossFunction", "logistic or hinge", "logistic",
                         TypeConverters.to_string)
    labelConversion = Param(
        "labelConversion", "True (default): labels arrive as 0/1 and are "
        "converted to VW's convention internally (reference: "
        "VowpalWabbitClassifier labelConversion). False: labels are "
        "already -1/+1", True, TypeConverters.to_bool)

    def fit(self, dataset: Dataset) -> "VowpalWabbitClassificationModel":
        if not self.get_or_default("labelConversion"):
            lab = self.get_or_default("labelCol")
            y = np.asarray(dataset[lab], np.float32)
            vals = set(np.unique(y).tolist())
            if not vals <= {-1.0, 1.0}:
                raise ValueError(
                    "labelConversion=False expects -1/+1 labels; got "
                    f"values {sorted(vals)[:5]}")
            dataset = dataset.with_column(lab, (y + 1.0) / 2.0)
        cfg = self._sgd_config(self.get_or_default("lossFunction"))
        weights, stats = self._fit_weights(dataset, cfg)
        model = VowpalWabbitClassificationModel(weights, stats)
        self._copy_params_to(model)
        return model

    def fit_streamed(self, index_path, value_path, label_path,
                     weight_path=None, *, chunk_rows: int = None
                     ) -> "VowpalWabbitClassificationModel":
        """Fit from pre-hashed disk shards with bounded host memory (see
        ``_fit_weights_streamed``). Label shards must hold 0/1 labels (the
        in-memory default); labelConversion=False's -1/+1 convention would
        need a disk rewrite, so it is rejected here."""
        if not self.get_or_default("labelConversion"):
            raise ValueError(
                "labelConversion=False is not supported with fit_streamed; "
                "store 0/1 labels in the shards (the default convention)")
        cfg = self._sgd_config(self.get_or_default("lossFunction"))
        weights, stats = self._fit_weights_streamed(
            index_path, value_path, label_path, weight_path, cfg, chunk_rows)
        model = VowpalWabbitClassificationModel(weights, stats)
        self._copy_params_to(model)
        return model


class VowpalWabbitClassificationModel(_VowpalWabbitModelBase,
                                      HasRawPredictionCol, HasProbabilityCol):
    def transform(self, dataset: Dataset) -> Dataset:
        margin = self._margin(dataset)
        # stable sigmoid: exp only of non-positive args (BFGS-fit models can
        # produce very large margins on separable data)
        p1 = np.where(margin >= 0,
                      1.0 / (1.0 + np.exp(-np.clip(margin, 0, None))),
                      np.exp(np.clip(margin, None, 0))
                      / (1.0 + np.exp(np.clip(margin, None, 0))))
        probs = np.stack([1 - p1, p1], axis=1)
        return dataset.with_columns({
            self.get_or_default("rawPredictionCol"): np.stack([-margin, margin], 1),
            self.get_or_default("probabilityCol"): probs,
            self.get_or_default("predictionCol"): (margin > 0).astype(np.float64),
        })


class VowpalWabbitRegressor(Estimator, _VowpalWabbitBaseParams):
    """Linear regressor, squared/quantile loss (reference:
    vw/VowpalWabbitRegressor.scala)."""

    lossFunction = Param("lossFunction", "squared or quantile", "squared",
                         TypeConverters.to_string)

    def fit(self, dataset: Dataset) -> "VowpalWabbitRegressionModel":
        cfg = self._sgd_config(self.get_or_default("lossFunction"))
        weights, stats = self._fit_weights(dataset, cfg)
        model = VowpalWabbitRegressionModel(weights, stats)
        self._copy_params_to(model)
        return model

    def fit_streamed(self, index_path, value_path, label_path,
                     weight_path=None, *, chunk_rows: int = None
                     ) -> "VowpalWabbitRegressionModel":
        """Fit from pre-hashed disk shards with bounded host memory (see
        ``_fit_weights_streamed``)."""
        cfg = self._sgd_config(self.get_or_default("lossFunction"))
        weights, stats = self._fit_weights_streamed(
            index_path, value_path, label_path, weight_path, cfg, chunk_rows)
        model = VowpalWabbitRegressionModel(weights, stats)
        self._copy_params_to(model)
        return model


class VowpalWabbitRegressionModel(_VowpalWabbitModelBase):
    def transform(self, dataset: Dataset) -> Dataset:
        margin = self._margin(dataset)
        return dataset.with_column(self.get_or_default("predictionCol"),
                                   margin.astype(np.float64))
