"""Convolutional networks for the image featurization path, in torch.

Counterpart of ``mmlspark_tpu/models/dnn/cnn.py`` (reference: the
pretrained CNTK CNNs scored by cntk/CNTKModel.scala:30-532 and fetched by
downloader/ModelDownloader.scala:37-276). A model is a param tree (nested
dicts of tensors) and a functional ``apply``; "model surgery" (pick an
intermediate output node, ImageFeaturizer's layer cutting,
image/ImageFeaturizer.scala:96-141) is a ``capture`` argument: apply
returns ``(logits, {node_name: activation})``.

Layouts: the port's param tree holds convolution weights as torch's
``[out, in, kh, kw]`` (the JAX package's are ``[kh, kw, in, out]``;
``convert.py`` moves trees between the two), dense weights as ``[in,
out]`` as in the JAX package. ``apply`` takes ``[N, H, W, C]`` input as
the JAX package does and runs NCHW convolutions on it in
``torch.channels_last`` memory (the permute is free); every captured
activation comes back ``[N, H, W, C]``, so ``outputNode="stage1_block0"``
gives the same array in both packages.

Two block styles cover the reference's featurizer catalog: ``basic``
(ResNet-18/34) and ``bottleneck`` (ResNet-50/101/152: 1x1 -> 3x3 -> 1x1
with 4x channel expansion), plus a classic AlexNet tower. Batch-norm is
folded into an inference scale and shift (this is the scoring path).
``dtype`` casts the parameters where the JAX forward casts them, so a
bfloat16 config runs the same ops in the same dtypes. Callers on the card
scope f32 forwards with :func:`~mmlspark_tpu_torch.device.exact_f32`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import prng


@dataclass(frozen=True)
class CNNConfig:
    """ResNet-v1-style config.

    block="basic": two 3x3 convs per block (stage_sizes=[2,2,2,2] ~ ResNet-18,
    [3,4,6,3] ~ ResNet-34). block="bottleneck": 1x1/3x3/1x1 with expansion 4
    ([3,4,6,3] ~ ResNet-50, [3,4,23,3] ~ ResNet-101, [3,8,36,3] ~ ResNet-152).
    """

    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    width: int = 64
    input_hw: Tuple[int, int] = (224, 224)
    dtype: Any = torch.float32
    block: str = "basic"


# single source of truth for per-block structure, shared with the
# downloader catalog (numLayers) and the weight importer
BLOCK_SPECS = {"basic": {"convs": 2, "expansion": 1},
               "bottleneck": {"convs": 3, "expansion": 4}}
_EXPANSION = {k: v["expansion"] for k, v in BLOCK_SPECS.items()}


def _scaled_normal(key, shape, scale: float) -> torch.Tensor:
    """The JAX package's ``jax.random.normal(key, shape) * scale`` (an f32
    product), on the host (the params are CPU tensors; the draw is the
    same bits on any device)."""
    return prng.normal(key, shape, device="cpu") * float(np.float32(scale))


def _conv_init(key, kh, kw, cin, cout) -> torch.Tensor:
    """He-normal ``[cout, cin, kh, kw]`` weights: the JAX package's draw
    in its ``(kh, kw, cin, cout)`` shape, permuted to the port's layout."""
    w = _scaled_normal(key, (kh, kw, cin, cout),
                       np.sqrt(2.0 / (kh * kw * cin)))
    return w.permute(3, 2, 0, 1).contiguous()


def _bn_unit(cout) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(cout), "bias": torch.zeros(cout)}


def init_cnn_params(cfg: CNNConfig, key) -> Dict[str, Any]:
    """Fresh ResNet params under the PRNG key ``key`` (``utils/prng.py``:
    two words, e.g. ``prng.prng_key(seed)``): He-normal convolutions,
    identity batch-norm, zero head bias, as CPU tensors. The keys of
    ``split(key, ...)`` are consumed in the JAX package's order and each
    draw is taken at its shape, so the weights are the JAX
    ``init_cnn_params``' under the same key, within a few f32 ulps
    (:func:`~mmlspark_tpu_torch.utils.prng.normal`)."""
    expansion = BLOCK_SPECS[cfg.block]["expansion"]
    n_convs = BLOCK_SPECS[cfg.block]["convs"]
    keys = iter(prng.split(key, 4 + (n_convs + 1) * sum(cfg.stage_sizes)
                           + 2))
    params: Dict[str, Any] = {
        "stem": {"w": _conv_init(next(keys), 7, 7, 3, cfg.width),
                 **_bn_unit(cfg.width)}}
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_sizes):
        mid = cfg.width * (2 ** s)
        cout = mid * expansion
        for b in range(n_blocks):
            if cfg.block == "basic":
                blk = {
                    "conv1": {"w": _conv_init(next(keys), 3, 3, cin, mid),
                              **_bn_unit(mid)},
                    "conv2": {"w": _conv_init(next(keys), 3, 3, mid, cout),
                              **_bn_unit(cout)},
                }
            else:
                blk = {
                    "conv1": {"w": _conv_init(next(keys), 1, 1, cin, mid),
                              **_bn_unit(mid)},
                    "conv2": {"w": _conv_init(next(keys), 3, 3, mid, mid),
                              **_bn_unit(mid)},
                    "conv3": {"w": _conv_init(next(keys), 1, 1, mid, cout),
                              **_bn_unit(cout)},
                }
            if cin != cout:
                blk["proj"] = {"w": _conv_init(next(keys), 1, 1, cin, cout)}
            params[f"stage{s}_block{b}"] = blk
            cin = cout
    params["head"] = {
        "w": _scaled_normal(next(keys), (cin, cfg.num_classes),
                            np.sqrt(1.0 / cin)),
        "b": torch.zeros(cfg.num_classes)}
    return params


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    # explicit symmetric (k-1)//2 padding, not "SAME": under stride 2 SAME
    # pads asymmetrically, which would de-align pretrained weights imported
    # via from_torch_resnet_state_dict (torch pads symmetrically). The
    # weight is cast at use, as the JAX forward casts it.
    ph, pw = (w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(ph, pw))


def _bn_affine(x: torch.Tensor, p) -> torch.Tensor:
    c = x.shape[1]
    return (x * p["scale"].to(x.dtype).view(1, c, 1, 1)
            + p["bias"].to(x.dtype).view(1, c, 1, 1))


def _bn_relu(x: torch.Tensor, p) -> torch.Tensor:
    return torch.relu_(_bn_affine(x, p))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw_in(x: torch.Tensor, dtype) -> torch.Tensor:
    """``[N, H, W, C]`` input as an NCHW view in channels_last memory."""
    return x.to(dtype).contiguous().permute(0, 3, 1, 2)


def apply_cnn(params: Dict[str, Any], x: torch.Tensor, cfg: CNNConfig,
              capture: Sequence[str] = ()
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward pass. ``x``: (N, H, W, 3) float in [0,1] or normalized, a
    tensor on the params' device. ``capture`` names intermediate nodes to
    return: 'stem', 'stageS_blockB' (both ``[N, H, W, C]``), 'pool'
    (global avg pool — the standard featurization layer), 'logits'.
    """
    acts: Dict[str, torch.Tensor] = {}
    x = _nchw_in(x, cfg.dtype)
    stem = params["stem"]
    x = _bn_relu(_conv(x, stem["w"], stride=2), stem)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    if "stem" in capture:
        acts["stem"] = _nhwc(x)
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            name = f"stage{s}_block{b}"
            blk = params[name]
            stride = 2 if (b == 0 and s > 0) else 1
            if cfg.block == "basic":
                h = _bn_relu(_conv(x, blk["conv1"]["w"], stride), blk["conv1"])
                h = _bn_affine(_conv(h, blk["conv2"]["w"]), blk["conv2"])
            else:
                h = _bn_relu(_conv(x, blk["conv1"]["w"]), blk["conv1"])
                h = _bn_relu(_conv(h, blk["conv2"]["w"], stride), blk["conv2"])
                h = _bn_affine(_conv(h, blk["conv3"]["w"]), blk["conv3"])
            shortcut = x
            if "proj" in blk:
                shortcut = _conv(x, blk["proj"]["w"], stride)
            elif stride != 1:
                shortcut = x[:, :, ::stride, ::stride]
            x = torch.relu_(h + shortcut)
            if name in capture:
                acts[name] = _nhwc(x)
    pooled = x.mean(dim=(2, 3))
    if "pool" in capture:
        acts["pool"] = pooled
    logits = (pooled @ params["head"]["w"].to(pooled.dtype)
              + params["head"]["b"].to(pooled.dtype))
    if "logits" in capture:
        acts["logits"] = logits
    return logits, acts


def feature_dim(cfg: CNNConfig) -> int:
    return (cfg.width * (2 ** (len(cfg.stage_sizes) - 1))
            * _EXPANSION[cfg.block])


# ---------------------------------------------------------------------------
# AlexNet (the reference catalog's other featurizer family —
# downloader/ModelDownloader.scala:37-276 fetches CNTK AlexNet; featurization
# cuts at fc7, image/ImageFeaturizer.scala:96-141)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlexNetConfig:
    num_classes: int = 1000
    input_hw: Tuple[int, int] = (224, 224)
    width_mult: float = 1.0           # shrink for tests
    dtype: Any = torch.float32


def _alex_dims(cfg: AlexNetConfig):
    m = cfg.width_mult
    chans = [int(c * m) or 1 for c in (64, 192, 384, 256, 256)]
    fc = int(4096 * m) or 1
    return chans, fc


def _alex_spatial(cfg: AlexNetConfig) -> Tuple[int, int]:
    """Spatial dims entering fc6: stride-4 stem then three stride-2 SAME
    pools, each with ceil semantics — exact for any (even non-square,
    non-multiple-of-32) input size."""
    def axis(d):
        d = -(-d // 4)            # stem conv, stride 4, symmetric padding
        for _ in range(3):        # pools after conv1, conv2, conv5
            d = -(-d // 2)
        return d
    return axis(cfg.input_hw[0]), axis(cfg.input_hw[1])


def init_alexnet_params(cfg: AlexNetConfig, key) -> Dict[str, Any]:
    """Fresh AlexNet params under the PRNG key ``key``, as CPU tensors: the
    JAX ``init_alexnet_params``' draws, as :func:`init_cnn_params`."""
    chans, fc = _alex_dims(cfg)
    keys = iter(prng.split(key, 16))
    specs = [(11, 3, chans[0]), (5, chans[0], chans[1]),
             (3, chans[1], chans[2]), (3, chans[2], chans[3]),
             (3, chans[3], chans[4])]
    params: Dict[str, Any] = {}
    for i, (k, cin, cout) in enumerate(specs):
        params[f"conv{i + 1}"] = {"w": _conv_init(next(keys), k, k, cin,
                                                  cout),
                                  "b": torch.zeros(cout)}
    h, w = _alex_spatial(cfg)
    flat = chans[4] * h * w
    for i, (din, dout) in enumerate([(flat, fc), (fc, fc),
                                     (fc, cfg.num_classes)]):
        params[f"fc{i + 6}"] = {
            "w": _scaled_normal(next(keys), (din, dout),
                                np.sqrt(2.0 / din)),
            "b": torch.zeros(dout)}
    return params


def _same_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with "SAME" padding: ``ceil(d / 2)`` outputs,
    the pad split low-first (an odd ``d`` pads (1, 1), an even one (0,
    1)), padded with -inf. ``ceil_mode`` agrees with this only on even
    sizes."""
    pads = []
    for d in (x.shape[3], x.shape[2]):
        total = max((-(-d // 2) - 1) * 2 + 3 - d, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, stride=2)


def apply_alexnet(params: Dict[str, Any], x: torch.Tensor,
                  cfg: AlexNetConfig, capture: Sequence[str] = ()):
    """AlexNet forward; capture nodes: conv1..conv5 (``[N, H, W, C]``),
    fc6, fc7 (the featurization layer), logits.

    As in the JAX forward, the convolution weights are cast to the
    activations' dtype and the biases are not: a bfloat16 config runs conv1
    in bfloat16, and its f32 bias promotes the rest of the net to f32."""
    acts: Dict[str, torch.Tensor] = {}
    x = _nchw_in(x, cfg.dtype)
    strides = [4, 1, 1, 1, 1]
    pools = [True, True, False, False, True]
    for i in range(5):
        p = params[f"conv{i + 1}"]
        x = torch.relu_(_conv(x, p["w"], strides[i])
                        + p["b"].view(1, -1, 1, 1))
        if pools[i]:
            x = _same_pool(x)
        if f"conv{i + 1}" in capture:
            acts[f"conv{i + 1}"] = _nhwc(x)
    # flatten in the JAX package's HWC order: fc6's rows follow it
    x = _nhwc(x).reshape(x.shape[0], -1)
    for name in ("fc6", "fc7"):
        p = params[name]
        x = torch.relu_(x @ p["w"] + p["b"])
        if name in capture:
            acts[name] = x
    p = params["fc8"]
    logits = x @ p["w"] + p["b"]
    if "logits" in capture:
        acts["logits"] = logits
    return logits, acts


def alexnet_feature_dim(cfg: AlexNetConfig) -> int:
    return _alex_dims(cfg)[1]


# ---------------------------------------------------------------------------
# Real-weight import: torchvision ResNet state_dicts -> the port's tree.
# ---------------------------------------------------------------------------


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Inference-fold batch-norm into (scale, bias): y = x*scale + bias."""
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def from_torch_resnet_state_dict(sd: Dict[str, Any],
                                 cfg: CNNConfig) -> Dict[str, Any]:
    """Convert a torchvision ``resnet*`` state_dict (numpy arrays or
    tensors; OIHW conv weights, which is the port's layout) into the
    apply_cnn param tree, folding batch-norm running stats into inference
    scale/bias. The folds are the JAX package's numpy arithmetic, so the
    values equal its converter's bit for bit (in the port's layout)."""
    sd = {k: _as_numpy(v) for k, v in sd.items()}

    def conv(prefix):
        return sd[prefix + ".weight"].astype(np.float32)

    def bn(prefix):
        s, b = fold_bn(sd[prefix + ".weight"], sd[prefix + ".bias"],
                       sd[prefix + ".running_mean"],
                       sd[prefix + ".running_var"])
        return {"scale": s, "bias": b}

    params: Dict[str, Any] = {"stem": {"w": conv("conv1"), **bn("bn1")}}
    n_convs = BLOCK_SPECS[cfg.block]["convs"]
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            t = f"layer{s + 1}.{b}"
            blk: Dict[str, Any] = {}
            for c in range(1, n_convs + 1):
                blk[f"conv{c}"] = {"w": conv(f"{t}.conv{c}"),
                                   **bn(f"{t}.bn{c}")}
            if f"{t}.downsample.0.weight" in sd:
                # torchvision's downsample = conv + bn; fold the bn into the
                # projection by scaling its output channels
                dbn = bn(f"{t}.downsample.1")
                blk["proj"] = {"w": conv(f"{t}.downsample.0")
                               * dbn["scale"][:, None, None, None]}
                # bn bias on the shortcut shifts the sum pre-relu; carry it
                # into the main-path bias of the last conv block
                last = f"conv{n_convs}"
                blk[last] = dict(blk[last])
                blk[last]["bias"] = blk[last]["bias"] + dbn["bias"]
            params[f"stage{s}_block{b}"] = blk
    params["head"] = {
        "w": np.ascontiguousarray(sd["fc.weight"].T).astype(np.float32),
        "b": sd["fc.bias"].astype(np.float32)}
    return _tensors(params)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def cast_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """``params`` with the casts the forward makes at use made once: a
    ResNet casts every parameter to ``cfg.dtype``; AlexNet casts conv1's
    weight only (its f32 bias then promotes the rest), so its tree is
    returned as it is. The forward's own casts are then no-ops."""
    if not isinstance(cfg, CNNConfig):
        return params

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(cfg.dtype)
    return cast(params)
