"""DNNModel: batched DNN inference as a pipeline stage (CNTKModel parity).

Counterpart of ``mmlspark_tpu/models/dnn/scoring.py`` (reference:
cntk/CNTKModel.scala:30-532 — broadcast eval in mapPartitions, feed/fetch
dicts :204-223, minibatching via FixedMiniBatchTransformer + FlattenBatch
:374,496-528, GPU-or-CPU device pick :94). The JAX package's jitted forward
becomes an eager forward under ``torch.inference_mode()``, one per capture
spec, on the stage's ``device`` (default ``cuda``): rows go up in batches of
``miniBatchSize``, the tail padded to that size so that every batch has one
shape — one convolution algorithm for every row, which is what makes a
row's output independent of the rows around it, and streamed features
bit-equal to in-memory ones. On the card the f32 forward runs without TF32
(:func:`~mmlspark_tpu_torch.device.exact_f32`); batches are staged through
pinned memory and read back asynchronously, two in flight.

A rank scores the rows it is given on its one device: the JAX package's
``_pad_to_mesh`` (rows padded to the mesh's shard count) has no
counterpart; the site is logged as ``placement.plan_for("dnn.transform")``.

Model surgery (SerializableFunction.clone + output-node pick,
com/microsoft/CNTK/SerializableFunction.scala:67-102) is the ``outputNode``
param resolved through the model's ``capture`` mechanism.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.dataset import Dataset
from ...core.params import (HasBatchSize, HasDevice, HasInputCol,
                            HasOutputCol, Param, TypeConverters)
from ...core.pipeline import Model, Transformer, load_pickle
from ...device import exact_f32
from ...parallel import placement
from ...utils.profiling import annotate
from .convert import params_from_jax, params_to_jax

# batches staged on the card ahead of the one being read back
_IN_FLIGHT = 2


class DNNModel(Model, HasInputCol, HasOutputCol, HasBatchSize, HasDevice):
    """Wraps a functional model (params + apply) as a scoring Transformer.

    ``apply_fn(params, x) -> output`` or, with ``output_node`` set,
    ``apply_fn(params, x, capture=[node]) -> (logits, {node: act})``; ``x``
    and the outputs are tensors on the stage's device, ``params`` the
    model's tree moved there.
    """

    outputNode = Param("outputNode", "intermediate node to fetch (model "
                       "surgery; None = final output)", None,
                       TypeConverters.to_string)
    miniBatchSize = Param("miniBatchSize", "rows per device batch", 64,
                          TypeConverters.to_int)
    feedDict = Param(
        "feedDict", "Map of model input name -> dataset column (reference: "
        "CNTKModel feedDict). Multiple entries feed a multi-input apply_fn "
        "as a dict of batches; a single entry is an inputCol alias", None,
        is_complex=True)
    fetchDict = Param(
        "fetchDict", "Map of output column -> capture node (reference: "
        "CNTKModel fetchDict). One forward pass captures every requested "
        "node and writes each to its column", None, is_complex=True)
    convertOutputToDenseVector = Param(
        "convertOutputToDenseVector", "Accepted for reference parity; "
        "outputs here are always dense ndarrays", True,
        TypeConverters.to_bool)
    batchInput = Param(
        "batchInput", "Accepted for reference parity; scoring always "
        "micro-batches to one padded batch shape", True,
        TypeConverters.to_bool)
    shapeOutput = Param(
        "shapeOutput", "Accepted for reference parity: outputs keep the "
        "model's natural [n, ...] array shape (the reference's flag "
        "reshaped CNTK's flattened outputs)", False,
        TypeConverters.to_bool)

    def __init__(self, params: Any = None, apply_fn: Callable = None,
                 apply_spec: Optional[Dict[str, Any]] = None, **kwargs):
        super().__init__(**kwargs)
        self.params = params
        self.apply_spec = apply_spec
        self.apply_fn = apply_fn or (
            _build_apply(apply_spec) if apply_spec else None)
        self._compiled: Dict[Any, Callable] = {}
        self._dev_params: Dict[str, Any] = {}

    @classmethod
    def from_downloader(cls, repo_dir: str, name: str, **kwargs) -> "DNNModel":
        """Load a repository model (ModelDownloader) as a scoring stage."""
        from .downloader import ModelDownloader

        d = ModelDownloader(repo_dir)
        params, cfg, _ = d.load_model(name)
        if type(cfg).__name__ == "AlexNetConfig":
            spec = {"kind": "alexnet",
                    "config": {"num_classes": cfg.num_classes,
                               "input_hw": tuple(cfg.input_hw),
                               "width_mult": cfg.width_mult}}
        else:
            spec = {"kind": "cnn",
                    "config": {"num_classes": cfg.num_classes,
                               "stage_sizes": tuple(cfg.stage_sizes),
                               "width": cfg.width,
                               "block": cfg.block,
                               "input_hw": tuple(cfg.input_hw)}}
        return cls(params, apply_spec=spec, **kwargs)

    # -- model surgery (CNTKModel.setOutputNode analog) ---------------------
    def set_output_node(self, name: Optional[str]) -> "DNNModel":
        return self.set(outputNode=name)

    def cloned_with_shared_params(self) -> "DNNModel":
        """ParameterCloningMethod.Share parity: same param tensors, fresh
        stage (SerializableFunction.scala:96-102); the forwards and the
        params' device copies are shared too."""
        c = DNNModel(self.params, self.apply_fn, self.apply_spec)
        c._paramMap = dict(self._paramMap)
        c._compiled = self._compiled
        c._dev_params = self._dev_params
        return c

    # -- forward ------------------------------------------------------------
    def _forward(self, node) -> Callable:
        """The forward for one capture spec: ``None`` (final output), a
        node name, or a TUPLE of node names (fetchDict — one pass captures
        all of them and returns the dict)."""
        if node not in self._compiled:
            apply_fn = self.apply_fn
            if node is None:
                fn = apply_fn
            elif isinstance(node, tuple):
                def fn(p, x, _nodes=node):
                    _, acts = apply_fn(p, x, capture=list(_nodes))
                    return {k: acts[k] for k in _nodes}
            else:
                def fn(p, x):
                    _, acts = apply_fn(p, x, capture=[node])
                    return acts[node]
            self._compiled[node] = fn
        return self._compiled[node]

    def _params_on(self, dev: torch.device):
        """The params on ``dev``, once per device and params object:
        tensors moved there (an
        apply_spec model's also cast as its forward casts them, and its
        convolution weights in channels_last memory)."""
        key = str(dev)
        held = self._dev_params.get(key)
        if held is None or held[0] is not self.params:
            prepare = getattr(self.apply_fn, "prepare", None)
            held = (self.params, prepare(self.params, dev) if prepare
                    else _tree_to(self.params, dev))
            self._dev_params[key] = held
        return held[1]

    @staticmethod
    def _column_matrix(dataset: Dataset, col: str) -> np.ndarray:
        data = dataset[col]
        return data if isinstance(data, np.ndarray) else np.stack(
            [np.asarray(v, np.float32) for v in data])

    def transform(self, dataset: Dataset) -> Dataset:
        dev = self._device()
        out_col = self.get_or_default("outputCol") or "output"
        node = self.get_or_default("outputNode")
        bs = int(self.get_or_default("miniBatchSize"))
        feed = self.get_or_default("feedDict")
        fetch = self.get_or_default("fetchDict")
        if fetch:
            if node is not None:
                raise ValueError(
                    "set either outputNode or fetchDict, not both (fetchDict "
                    "routes every capture to its own column)")
            # fetchDict: one pass captures every node; column order fixed
            out_cols = sorted(fetch)
            node = tuple(fetch[c] for c in out_cols)
        if feed:
            # Dataset enforces uniform column lengths at construction, so
            # the feed batches are aligned by invariant
            xs = {name: self._column_matrix(dataset, c)
                  for name, c in feed.items()}
            if len(xs) == 1:
                xs = next(iter(xs.values()))   # plain single-input apply
        else:
            xs = self._column_matrix(dataset,
                                     self.get_or_default("inputCol"))
        fwd = self._forward(node)
        multi_in = isinstance(xs, dict)
        n = (next(iter(xs.values())) if multi_in else xs).shape[0]
        placement.plan_for("dnn.transform", replicate=True, device=dev,
                           rows=n, scope="rank_rows")

        def one(a, start):
            b = a[start:start + bs]
            real = b.shape[0]
            if real < bs:
                # one batch shape: pad the tail batch, drop padding after
                b = np.concatenate(
                    [b, np.repeat(b[-1:], bs - real, axis=0)], axis=0)
            return _upload(b, dev), real

        def batch_at(start):
            if multi_in:
                pairs = {k: one(a, start) for k, a in xs.items()}
                return ({k: v[0] for k, v in pairs.items()},
                        next(iter(pairs.values()))[1])
            return one(xs, start)

        params = self._params_on(dev)
        outs: List[Any] = []
        pending: deque = deque()
        with annotate(f"dnn_score:{type(self).__name__}"), \
                torch.inference_mode(), exact_f32(dev):
            for start in range(0, n, bs):
                batch, real = batch_at(start)
                out = fwd(params, batch)
                if isinstance(out, dict):
                    outs.append({k: _download(v[:real]) for k, v in
                                 out.items()})
                else:
                    outs.append(_download(out[:real]))
                if dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    pending.append(ev)
                    if len(pending) > _IN_FLIGHT:
                        pending.popleft().synchronize()
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        if isinstance(node, tuple):
            cols = {c: np.concatenate([o[nd].numpy() for o in outs], axis=0)
                    if outs else np.zeros((0,))
                    for c, nd in zip(out_cols, node)}
            return dataset.with_columns(cols)
        result = (np.concatenate([o.numpy() for o in outs], axis=0)
                  if outs else np.zeros((0,)))
        return dataset.with_column(out_col, result)

    # -- persistence --------------------------------------------------------
    # The JAX package's format: params (numpy, the JAX layout) + a
    # reconstructable apply spec, so a directory saved by either package
    # loads in the other. Without a spec the port pickles its own apply_fn
    # under another key; the JAX package's pickled apply_fn is a JAX
    # function, which the port refuses to load.
    def _save_extra(self, path: str) -> None:
        payload: Dict[str, Any] = {"params": params_to_jax(self.params),
                                   "apply_spec": self.apply_spec}
        if self.apply_spec is None:
            try:
                payload["torch_apply_fn"] = pickle.dumps(self.apply_fn)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise ValueError(
                    "DNNModel.apply_fn is not picklable and no apply_spec was "
                    "given; construct with apply_spec (e.g. via "
                    "DNNModel.from_downloader) to make the stage persistable"
                ) from e
        with open(os.path.join(path, "model.pkl"), "wb") as f:
            pickle.dump(payload, f)

    def _load_extra(self, path: str) -> None:
        with open(os.path.join(path, "model.pkl"), "rb") as f:
            d = load_pickle(f)
        self.apply_spec = d.get("apply_spec")
        if self.apply_spec:
            self.apply_fn = _build_apply(self.apply_spec)
        elif "torch_apply_fn" in d:
            self.apply_fn = pickle.loads(d["torch_apply_fn"])
        else:
            raise ValueError(
                f"{path}: this DNNModel was saved by the JAX package with a "
                "pickled apply_fn, a JAX function the PyTorch port cannot "
                "run; save it with an apply_spec (DNNModel.from_downloader) "
                "to load it here")
        self.params = params_from_jax(d["params"])
        self._compiled = {}
        self._dev_params = {}


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One batch on ``dev``; on the card staged through pinned memory and
    copied without blocking the host. Float64 rows go as f32 and int64 as
    int32, as the JAX package's arrays are."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _download(t: torch.Tensor) -> torch.Tensor:
    """One batch's output on the host (bfloat16 as f32, exact); from the
    card an asynchronous copy into pinned memory, read after the stream
    is synchronised."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type != "cuda":
        return t.contiguous()
    return t.contiguous().to("cpu", non_blocking=True)


def _tree_to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


class _SpecApply:
    """The apply of an ``apply_spec``: ``(params, x, capture=())`` on the
    port's ``cnn``, and :meth:`prepare`, which puts params on a device with
    the forward's casts made once and convolution weights in
    channels_last memory."""

    def __init__(self, kind: str, cfg):
        from . import cnn
        self.cfg = cfg
        self._apply = cnn.apply_alexnet if kind == "alexnet" else cnn.apply_cnn
        self._cast = cnn.cast_params

    def __call__(self, p, x, capture=()):
        return self._apply(p, x, self.cfg, capture)

    def prepare(self, params, dev: torch.device):
        def place(t):
            if isinstance(t, dict):
                return {k: place(v) for k, v in t.items()}
            t = t.to(dev)
            return (t.contiguous(memory_format=torch.channels_last)
                    if t.dim() == 4 else t)
        return place(self._cast(params, self.cfg))


def _build_apply(spec: Dict[str, Any]) -> _SpecApply:
    """Rebuild an apply function from its declarative spec."""
    from .cnn import AlexNetConfig, CNNConfig

    kind = spec["kind"]
    cfg_d = dict(spec["config"])
    cfg_d["input_hw"] = tuple(cfg_d["input_hw"])
    if isinstance(cfg_d.get("dtype"), str):
        # a dtype by name ("bfloat16"), which the JAX package reads too
        cfg_d["dtype"] = getattr(torch, cfg_d["dtype"])
    if kind == "cnn":
        cfg_d["stage_sizes"] = tuple(cfg_d["stage_sizes"])
        return _SpecApply(kind, CNNConfig(**cfg_d))
    if kind == "alexnet":
        return _SpecApply(kind, AlexNetConfig(**cfg_d))
    raise ValueError(f"unknown apply_spec kind {kind!r}")


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Transfer-learning featurizer: resize -> normalize -> CNN -> cut layer.

    Parity: image/ImageFeaturizer.scala:40-191 (resize→unroll→CNTKModel with
    ``cutOutputLayers`` — :96-141). ``cutOutputLayers=1`` (default) fetches
    the global-average-pool features; 0 fetches logits. ``device`` runs the
    resize and the inner model's forward.
    """

    dropNa = Param("dropNa", "drop rows whose image is missing/undecodable "
                   "before featurizing (reference: ImageFeaturizer "
                   "dropNa); False keeps them as None outputs", True,
                   TypeConverters.to_bool)
    cutOutputLayers = Param("cutOutputLayers", "how many layers to cut", 1,
                            TypeConverters.to_int)
    miniBatchSize = Param("miniBatchSize", "rows per device batch", 32,
                          TypeConverters.to_int)
    featureNode = Param("featureNode", "capture node for featurization; "
                        "None = infer from the model's apply_spec "
                        "(pool for resnets, fc7 for alexnet)", None)

    # IMAGENET_STATS: pass as mean/std when featurizing with weights trained
    # on torchvision-preprocessed ImageNet (0..255 pixel scale)
    IMAGENET_MEAN = (123.675, 116.28, 103.53)
    IMAGENET_STD = (58.395, 57.12, 57.375)

    def __init__(self, dnn_model: DNNModel = None, input_hw=(224, 224),
                 mean=(127.5, 127.5, 127.5), std=(127.5, 127.5, 127.5),
                 **kwargs):
        """``mean``/``std``: input normalization in 0..255 pixel units.
        The default maps pixels to [-1, 1] (fine for the seeded builtin
        catalog); for genuinely pretrained torchvision imports use
        ``mean=ImageFeaturizer.IMAGENET_MEAN, std=ImageFeaturizer.
        IMAGENET_STD`` to match the checkpoint's training preprocessing."""
        super().__init__(**kwargs)
        self.dnn_model = dnn_model
        self.input_hw = tuple(input_hw)
        self.norm_mean = tuple(mean)
        self.norm_std = tuple(std)

    def set_model(self, m: DNNModel) -> "ImageFeaturizer":
        self.dnn_model = m
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        from ...image.ops import ImageTransformer

        device = self.get_or_default("device")
        self._device()
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "features"
        imgs = dataset[in_col]

        def _present(v) -> bool:
            # Missing = None (DecodeImage's failure value) OR a decoded-but-
            # garbage array: empty, or containing non-finite pixels (any NaN
            # or inf pixel propagates through the conv stack and poisons the
            # whole feature vector, so partially-bad counts as missing too)
            if v is None:
                return False
            a = np.asarray(v)
            if a.size == 0:
                return False
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                return False
            return True

        keep = np.asarray([i for i, v in enumerate(imgs) if _present(v)],
                          dtype=np.int64)
        if len(keep) == 0:
            # nothing featurizable: empty dataset under dropNa, or
            # all-None outputs with rows preserved
            if self.get_or_default("dropNa"):
                return dataset.take(keep).with_column(out_col, [])
            return dataset.with_column(out_col, [None] * len(dataset))
        missing = len(keep) != len(dataset)
        if missing and self.get_or_default("dropNa"):
            # reference ImageFeaturizer dropNa: undecodable rows leave
            # the dataset entirely
            dataset = dataset.take(keep)
            missing = False
        valid = dataset.take(keep) if missing else dataset
        h, w = self.input_hw
        prep = (ImageTransformer()
                .set(inputCol=in_col, outputCol="_img_prepped",
                     device=device)
                .resize(h, w)
                .normalize(mean=self.norm_mean, std=self.norm_std))
        # the featurization layer is architecture-specific: global-average
        # pool for resnets, fc7 for alexnet (image/ImageFeaturizer.scala's
        # per-model cut-layer map); featureNode overrides for models
        # constructed without an apply_spec
        feat_node = self.get_or_default("featureNode")
        if feat_node is None:
            spec = getattr(self.dnn_model, "apply_spec", None) or {}
            feat_node = "fc7" if spec.get("kind") == "alexnet" else "pool"
        node = (feat_node if self.get_or_default("cutOutputLayers") >= 1
                else "logits")
        if not hasattr(self, "_dnn_clone"):
            self._dnn_clone = self.dnn_model.cloned_with_shared_params()
        dnn = self._dnn_clone.set(
            inputCol="_img_prepped", outputCol=out_col, outputNode=node,
            miniBatchSize=self.get_or_default("miniBatchSize"),
            device=device)
        out = dnn.transform(prep.transform(valid)).drop("_img_prepped")
        if not missing:
            return out
        # dropNa=False with gaps: featurized the valid subset once (no
        # re-scan), reinsert None outputs at the missing positions
        feats = out[out_col]
        outs: List[Any] = [None] * len(dataset)
        for j, i in enumerate(keep):
            outs[int(i)] = feats[j]
        return dataset.with_column(out_col, outs)

    def _save_extra(self, path: str) -> None:
        from ...core.pipeline import save_stage
        save_stage(self.dnn_model, os.path.join(path, "dnn"))
        with open(os.path.join(path, "hw.pkl"), "wb") as f:
            pickle.dump({"input_hw": self.input_hw, "mean": self.norm_mean,
                         "std": self.norm_std}, f)

    def _load_extra(self, path: str) -> None:
        from ...core.pipeline import load_stage
        self.dnn_model = load_stage(os.path.join(path, "dnn"))
        with open(os.path.join(path, "hw.pkl"), "rb") as f:
            d = pickle.load(f)
        if isinstance(d, dict):
            self.input_hw = tuple(d["input_hw"])
            self.norm_mean, self.norm_std = tuple(d["mean"]), tuple(d["std"])
        else:                       # pre-mean/std save format
            self.input_hw = tuple(d)
            self.norm_mean = self.norm_std = (127.5, 127.5, 127.5)
