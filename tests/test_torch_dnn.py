"""The port's DNN scoring path (``mmlspark_tpu_torch/models/dnn``) against
the JAX package's, on the CPU, at small widths.

* ``apply_cnn`` (basic and bottleneck blocks) and ``apply_alexnet`` (an
  even and an odd input size: the "SAME" pools pad (0, 1) and (1, 1)), on
  the JAX package's params carried over with ``params_from_jax``, every
  capture node in the JAX layout (NHWC): f32 within 1e-5 of each node's
  largest magnitude (the convolutions sum in another order; 1.2e-6
  measured), bfloat16 within 1e-2 (a few bf16 ulps; equal measured).
* ``from_torch_resnet_state_dict`` against a forward written with
  ``F.conv2d``/``F.batch_norm`` on the raw state_dict (2e-4, as the JAX
  package's own test), its values equal to the JAX converter's.
* ``DNNModel``: batching with a padded tail equal to one unbatched call,
  ``outputNode``, ``feedDict``/``fetchDict`` (one pass, several columns; a
  two-input apply on tensors) and their validation; its outputs against
  the JAX ``DNNModel``'s at the f32 tolerance.
* ``ImageFeaturizer`` end to end on ragged uint8 images (resize 1e-3 on
  0..255, then the forward), ``cutOutputLayers`` 1 and 0, ``dropNa`` both
  ways, NaN and empty images as missing.
* ``ModelDownloader``: builtins (catalog, cache hit, hash bookkeeping),
  ``file://`` with its hash check, the ``package://`` DigitsConvNet fixture
  (pinned hash, a tampered fixture refused), ``http://`` fetched from a
  local server (hash checked, other or corrupt payloads refused);
  repositories written by either package load in the other and score
  equal; the payload's keys and config bytes are the JAX package's.
* Stage directories saved by either package load in the other and score
  equal; a JAX-saved stage with a pickled apply_fn is refused; a
  JAX-saved stage loads in a process where JAX cannot be imported.
* The DigitsConvNet transfer-learning accuracy pin of the JAX package's
  test, in the port (features from the port, the port's GBDT head).
* The entry points default to ``cuda`` and raise without a GPU;
  ``exact_f32`` turns TF32 off inside its scope and restores the flags.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import jax
import jax.numpy as jnp

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.dnn import cnn as J
from mmlspark_tpu.models.dnn import downloader as jdl
from mmlspark_tpu.models.dnn.scoring import DNNModel as JDNNModel
from mmlspark_tpu.models.dnn.scoring import ImageFeaturizer as JFeaturizer
from _torch_parity import f32_ulps
from mmlspark_tpu_torch import device as devmod
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.dnn import cnn as T
from mmlspark_tpu_torch.models.dnn import downloader as tdl
from mmlspark_tpu_torch.models.dnn.convert import (dnn_model_from_jax,
                                                   params_from_jax,
                                                   params_to_jax)
from mmlspark_tpu_torch.models.dnn.scoring import DNNModel, ImageFeaturizer
from mmlspark_tpu_torch.utils import prng

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_RTOL = 1e-5         # of each output's largest magnitude
BF16_RTOL = 1e-2
RESIZE_ATOL = 1e-3      # 0..255 scale


def _close(got, want, rtol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _resnet_nodes(stage_sizes):
    return (["stem"] + [f"stage{s}_block{b}" for s, n in
                        enumerate(stage_sizes) for b in range(n)]
            + ["pool", "logits"])


ALEX_NODES = [f"conv{i}" for i in range(1, 6)] + ["fc6", "fc7", "logits"]
DTYPES = {"f32": (jnp.float32, torch.float32, F32_RTOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_RTOL)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block,stage_sizes,hw", [
    ("basic", (1, 1, 1, 1), (32, 32)),
    ("bottleneck", (1, 1, 1, 1), (32, 32)),
    ("basic", (2, 1), (29, 35)),
    ("bottleneck", (1, 2), (27, 22)),
])
def test_apply_cnn_matches_jax_at_every_node(block, stage_sizes, hw, dtype):
    jd, td, rtol = DTYPES[dtype]
    kw = dict(num_classes=7, stage_sizes=stage_sizes, width=8, block=block,
              input_hw=hw)
    jc, tc = J.CNNConfig(dtype=jd, **kw), T.CNNConfig(dtype=td, **kw)
    p = _np(J.init_cnn_params(jc, jax.random.PRNGKey(1)))
    x = np.random.default_rng(2).normal(size=(3, *hw, 3)).astype(np.float32)
    nodes = _resnet_nodes(stage_sizes)
    jl, ja = J.apply_cnn(p, jnp.asarray(x), jc, nodes)
    tl, ta = T.apply_cnn(params_from_jax(p), torch.from_numpy(x), tc, nodes)
    assert set(ta) == set(nodes)
    for k in nodes:
        assert ta[k].dtype == td, k
        _close(ta[k].float(), np.asarray(ja[k]).astype(np.float32), rtol, k)
    _close(tl.float(), np.asarray(jl).astype(np.float32), rtol, "logits")
    assert T.feature_dim(tc) == J.feature_dim(jc) == ta["pool"].shape[1]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(64, 64), (67, 61), (56, 50)])
def test_apply_alexnet_matches_jax_even_and_odd_sizes(hw, dtype):
    jd, td, rtol = DTYPES[dtype]
    jc = J.AlexNetConfig(num_classes=6, input_hw=hw, width_mult=0.0625,
                         dtype=jd)
    tc = T.AlexNetConfig(num_classes=6, input_hw=hw, width_mult=0.0625,
                         dtype=td)
    p = _np(J.init_alexnet_params(jc, jax.random.PRNGKey(2)))
    x = np.random.default_rng(3).normal(size=(2, *hw, 3)).astype(np.float32)
    jl, ja = J.apply_alexnet(p, jnp.asarray(x), jc, ALEX_NODES)
    tl, ta = T.apply_alexnet(params_from_jax(p), torch.from_numpy(x), tc,
                             ALEX_NODES)
    for k in ALEX_NODES:
        want = np.asarray(ja[k])
        # conv1 runs in bf16 and its f32 bias promotes the rest, as in JAX
        assert str(ta[k].dtype).split(".")[1] == str(want.dtype), k
        _close(ta[k].float(), want.astype(np.float32), rtol, k)
    assert T.alexnet_feature_dim(tc) == ta["fc7"].shape[1]


def test_init_params_have_the_jax_tree_and_shapes():
    jc = J.CNNConfig(num_classes=5, stage_sizes=(1, 2), width=4,
                     block="bottleneck")
    tc = T.CNNConfig(num_classes=5, stage_sizes=(1, 2), width=4,
                     block="bottleneck")
    jp = _np(J.init_cnn_params(jc, jax.random.PRNGKey(0)))
    tp = params_to_jax(T.init_cnn_params(tc, prng.prng_key(0)))
    ja = J.AlexNetConfig(num_classes=4, input_hw=(45, 37), width_mult=0.05)
    ta = T.AlexNetConfig(num_classes=4, input_hw=(45, 37), width_mult=0.05)
    jpa = _np(J.init_alexnet_params(ja, jax.random.PRNGKey(0)))
    tpa = params_to_jax(T.init_alexnet_params(ta, prng.prng_key(0)))
    for a, b in ((jp, tp), (jpa, tpa)):
        fa = jdl._flatten(a)
        fb = tdl._flatten(b)
        assert list(fa) == list(fb)
        for k in fa:
            assert fa[k].shape == fb[k].shape and fb[k].dtype == np.float32
            # the JAX draws under the same key (tests/test_torch_prng.py)
            assert f32_ulps(fb[k], fa[k]) <= 4, k
    # He-normal scale, identity batch-norm
    w = tp["stage0_block0"]["conv2"]["w"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 4))) < 0.1
    np.testing.assert_array_equal(tp["stem"]["scale"], 1.0)


def test_params_round_trip_between_layouts():
    p = _np(J.init_cnn_params(J.CNNConfig(num_classes=3, stage_sizes=(1,),
                                          width=4), jax.random.PRNGKey(5)))
    t = params_from_jax(p)
    assert t["stem"]["w"].shape == (4, 3, 7, 7)          # OIHW
    assert t["head"]["w"].shape == (4, 3)                # [in, out]
    back = params_to_jax(t)
    for k, v in tdl._flatten(p).items():
        np.testing.assert_array_equal(tdl._flatten(back)[k], v)
    # leaves already in the target layout pass through
    assert params_from_jax(t)["stem"]["w"] is t["stem"]["w"]
    assert params_to_jax(back)["stem"]["w"] is back["stem"]["w"]


def _rand_sd(rng, cfg):
    """A torchvision-format resnet state_dict for ``cfg`` (bottleneck or
    basic; every first block of a stage with a downsample)."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = rng.normal(
            size=(cout, cin, k, k)).astype(np.float32) * 0.1

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.normal(size=c).astype(np.float32) * 0.1
        sd[name + ".running_mean"] = rng.normal(size=c).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)

    conv("conv1", cfg.width, 3, 7)
    bn("bn1", cfg.width)
    cin = cfg.width
    exp = T.BLOCK_SPECS[cfg.block]["expansion"]
    for s, nb in enumerate(cfg.stage_sizes):
        mid = cfg.width * 2 ** s
        for b in range(nb):
            t = f"layer{s + 1}.{b}"
            if cfg.block == "bottleneck":
                specs = [(mid, cin, 1), (mid, mid, 3), (mid * exp, mid, 1)]
            else:
                specs = [(mid, cin, 3), (mid, mid, 3)]
            for c, (co, ci, k) in enumerate(specs, 1):
                conv(f"{t}.conv{c}", co, ci, k)
                bn(f"{t}.bn{c}", co)
            if b == 0 and (s > 0 or cin != mid * exp):
                conv(f"{t}.downsample.0", mid * exp, cin, 1)
                bn(f"{t}.downsample.1", mid * exp)
            cin = mid * exp
    sd["fc.weight"] = rng.normal(size=(10, cin)).astype(np.float32) * 0.1
    sd["fc.bias"] = rng.normal(size=10).astype(np.float32) * 0.1
    return sd


def _torch_forward(sd, x_nchw, cfg):
    """torchvision resnet (v1.5) inference from the raw state_dict."""
    t = {k: torch.from_numpy(v) for k, v in sd.items()}

    def bn(x, p):
        return Fn.batch_norm(x, t[p + ".running_mean"],
                             t[p + ".running_var"], t[p + ".weight"],
                             t[p + ".bias"], training=False, eps=1e-5)

    x = Fn.relu(bn(Fn.conv2d(torch.from_numpy(x_nchw), t["conv1.weight"],
                             stride=2, padding=3), "bn1"))
    x = Fn.max_pool2d(x, 3, stride=2, padding=1)
    n_convs = T.BLOCK_SPECS[cfg.block]["convs"]
    for s, nb in enumerate(cfg.stage_sizes):
        for b in range(nb):
            pre = f"layer{s + 1}.{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            idn = x
            if pre + ".downsample.0.weight" in t:
                idn = bn(Fn.conv2d(x, t[pre + ".downsample.0.weight"],
                                   stride=stride), pre + ".downsample.1")
            h = x
            for c in range(1, n_convs + 1):
                w = t[f"{pre}.conv{c}.weight"]
                # the strided conv: a bottleneck's 3x3, a basic block's first
                st = stride if c == (1 if cfg.block == "basic" else 2) else 1
                h = bn(Fn.conv2d(h, w, stride=st,
                                 padding=(w.shape[2] - 1) // 2),
                       f"{pre}.bn{c}")
                if c < n_convs:
                    h = Fn.relu(h)
            x = Fn.relu(h + idn)
    x = x.mean(dim=(2, 3))
    return (x @ t["fc.weight"].T + t["fc.bias"]).numpy()


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_from_torch_resnet_state_dict_against_conv2d(block):
    cfg = T.CNNConfig(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8,
                      block=block, input_hw=(64, 64))
    rng = np.random.default_rng(7)
    sd = _rand_sd(rng, cfg)
    params = T.from_torch_resnet_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    got, _ = T.apply_cnn(params, torch.from_numpy(x), cfg)
    want = _torch_forward(sd, np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                          cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    jcfg = J.CNNConfig(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8,
                       block=block, input_hw=(64, 64))
    jp = J.from_torch_resnet_state_dict(sd, jcfg)
    mine = tdl._flatten(params_to_jax(params))
    for k, v in tdl._flatten(jp).items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    """A small basic ResNet in both packages: the JAX params, the port's
    DNNModel and the JAX DNNModel (both from the same apply_spec)."""
    cfg = J.CNNConfig(num_classes=5, stage_sizes=(1, 1), width=4,
                      input_hw=(16, 16))
    params = _np(J.init_cnn_params(cfg, jax.random.PRNGKey(0)))
    spec = {"kind": "cnn", "config": {
        "num_classes": 5, "stage_sizes": (1, 1), "width": 4,
        "block": "basic", "input_hw": (16, 16)}}
    return params, spec


def _x(n, seed, hw=(16, 16)):
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(
        np.float32)


def test_dnn_model_batches_with_a_padded_tail(tiny):
    params, spec = tiny
    model = DNNModel(params_from_jax(params), apply_spec=spec,
                     device="cpu").set(inputCol="x", outputCol="y",
                                       outputNode="logits", miniBatchSize=4)
    x = _x(10, 1)
    calls = []
    inner = model.apply_fn

    def spy(p, xb, capture=()):
        calls.append(tuple(xb.shape))
        return inner(p, xb, capture)

    model.apply_fn = spy
    out = model.transform(Dataset({"x": x}))["y"]
    assert calls == [(4, 16, 16, 3)] * 3           # one batch shape
    ref, _ = inner(model.params, torch.from_numpy(x))
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-6)
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="x", outputCol="y", outputNode="logits", miniBatchSize=4)
    _close(out, jm.transform(JDataset({"x": x}))["y"], F32_RTOL)


@pytest.mark.parametrize("node", ["pool", "stem", "stage1_block0",
                                  "logits"])
def test_dnn_model_output_node_matches_jax(tiny, node):
    params, spec = tiny
    x = _x(5, 2)
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="x", outputCol="f", outputNode=node, miniBatchSize=2)
    tm = dnn_model_from_jax(jm, device="cpu")
    assert tm.get_or_default("miniBatchSize") == 2
    got = tm.transform(Dataset({"x": x}))["f"]
    _close(got, jm.transform(JDataset({"x": x}))["f"], F32_RTOL, node)
    clone = tm.cloned_with_shared_params()
    assert clone.params is tm.params
    np.testing.assert_array_equal(clone.transform(Dataset({"x": x}))["f"],
                                  got)
    tm.set_output_node("pool")
    assert tm.get_or_default("outputNode") == "pool"


def test_apply_spec_dtype_by_name_runs_bf16_in_both(tiny):
    params, spec = tiny
    bf16 = {**spec, "config": {**spec["config"], "dtype": "bfloat16"}}
    x = _x(3, 7)
    kw = dict(inputCol="x", outputCol="y", outputNode="pool")
    jm = JDNNModel(params, apply_spec=bf16).set(**kw)
    tm = DNNModel(params_from_jax(params), apply_spec=bf16,
                  device="cpu").set(**kw)
    got = tm.transform(Dataset({"x": x}))["y"]
    assert got.dtype == np.float32             # bf16 read back exactly
    _close(got, jm.transform(JDataset({"x": x}))["y"], BF16_RTOL)
    f32 = DNNModel(params_from_jax(params), apply_spec=spec,
                   device="cpu").set(**kw).transform(Dataset({"x": x}))["y"]
    assert not np.array_equal(got, f32)


def test_param_map_reads_through_the_class(tiny):
    """The stage's ``params`` attribute (its param tree) does not shadow
    ``Params.params()``: the JAX DNNModel's ``extract_param_map`` raises
    on it (ROADMAP Queue 3), the port's does not."""
    params, spec = tiny
    m = DNNModel(params_from_jax(params), apply_spec=spec).set(
        miniBatchSize=7)
    pm = m.extract_param_map()
    assert pm["miniBatchSize"] == 7 and "outputNode" not in pm
    assert "miniBatchSize: rows per device batch" in m.explain_params()
    with pytest.raises(TypeError, match="not callable"):
        JDNNModel(params, apply_spec=spec).extract_param_map()


def test_dnn_model_from_jax_refuses_a_jax_function(tiny):
    params, spec = tiny
    with pytest.raises(ValueError, match="JAX function"):
        dnn_model_from_jax(JDNNModel(params, lambda p, x: x), device="cpu")


def test_feed_fetch_dicts(tiny):
    params, spec = tiny
    x = _x(6, 3)
    m = DNNModel(params_from_jax(params), apply_spec=spec,
                 device="cpu").set(feedDict={"input": "img"},
                                   fetchDict={"scores": "logits",
                                              "feats": "pool"},
                                   miniBatchSize=4)
    out = m.transform(Dataset({"img": x}))
    assert out["scores"].shape == (6, 5) and out["feats"].shape == (6, 8)
    jm = JDNNModel(params, apply_spec=spec).set(
        feedDict={"input": "img"}, fetchDict={"scores": "logits",
                                              "feats": "pool"},
        miniBatchSize=4)
    want = jm.transform(JDataset({"img": x}))
    _close(out["scores"], want["scores"], F32_RTOL)
    _close(out["feats"], want["feats"], F32_RTOL)

    def two_input_apply(p, xd, capture=()):
        s = xd["a"] * 2.0 + xd["b"]
        return s, {"sum": s.sum(dim=1)}

    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.ones((6, 2), np.float32)
    m2 = DNNModel(None, two_input_apply, device="cpu").set(
        feedDict={"a": "ca", "b": "cb"}, fetchDict={"s": "sum"},
        miniBatchSize=4)
    out2 = m2.transform(Dataset({"ca": a, "cb": b}))
    np.testing.assert_array_equal(out2["s"], (a * 2 + b).sum(axis=1))


def test_feed_fetch_validation(tiny):
    params, spec = tiny
    with pytest.raises(ValueError, match="not both"):
        DNNModel(params_from_jax(params), apply_spec=spec, device="cpu").set(
            outputNode="pool", fetchDict={"s": "logits"},
            miniBatchSize=4).transform(Dataset({"img": _x(4, 0)}))


def _imgs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in shapes]


@pytest.mark.parametrize("cut", [1, 0])
def test_image_featurizer_matches_jax(tiny, cut):
    params, spec = tiny
    imgs = _imgs([(30, 40), (50, 20), (30, 40), (16, 16), (41, 17)])
    jf = JFeaturizer(JDNNModel(params, apply_spec=spec),
                     input_hw=(16, 16)).set(inputCol="img", outputCol="f",
                                            cutOutputLayers=cut,
                                            miniBatchSize=2)
    tf = ImageFeaturizer(dnn_model_from_jax(jf.dnn_model),
                         input_hw=(16, 16), device="cpu").set(
        inputCol="img", outputCol="f", cutOutputLayers=cut, miniBatchSize=2)
    want = jf.transform(JDataset({"img": imgs}))["f"]
    got = tf.transform(Dataset({"img": imgs}))["f"]
    assert got.shape == want.shape == (5, 8 if cut else 5)
    # the resize's 1e-3 on 0..255 enters the net as 1e-3 / 127.5
    _close(got, want, 1e-4)


def test_image_featurizer_drop_na(tiny):
    params, spec = tiny
    feat = ImageFeaturizer(DNNModel(params_from_jax(params), apply_spec=spec),
                           input_hw=(16, 16), device="cpu").set(
        inputCol="img", outputCol="f", miniBatchSize=4)
    good = np.random.default_rng(0).normal(size=(16, 16, 3)).astype(
        np.float32)
    imgs = [good, None, good + 1]
    dropped = feat.set(dropNa=True).transform(Dataset({"img": imgs}))
    assert len(dropped) == 2
    kept = feat.set(dropNa=False).transform(Dataset({"img": imgs}))
    assert len(kept) == 3 and kept["f"][1] is None
    np.testing.assert_array_equal(kept["f"][0], dropped["f"][0])
    np.testing.assert_array_equal(kept["f"][2], dropped["f"][1])
    none_ds = Dataset({"img": [None, None], "id": np.array([1, 2])})
    assert len(feat.set(dropNa=True).transform(none_ds)) == 0
    assert list(feat.set(dropNa=False).transform(none_ds)["f"]) == [None,
                                                                    None]
    nan_img = np.full((16, 16, 3), np.nan, dtype=np.float32)
    weird = [good, nan_img, np.zeros((0, 0, 3), np.float32)]
    assert len(feat.set(dropNa=True).transform(Dataset({"img": weird}))) == 1
    kept2 = feat.set(dropNa=False).transform(Dataset({"img": weird}))
    assert kept2["f"][1] is None and kept2["f"][2] is None
    jf = JFeaturizer(JDNNModel(params, apply_spec=spec),
                     input_hw=(16, 16)).set(inputCol="img", outputCol="f",
                                            miniBatchSize=4, dropNa=False)
    want = jf.transform(JDataset({"img": imgs}))["f"]
    _close(kept["f"][0], want[0], F32_RTOL)


# -- the model repository ----------------------------------------------------


def test_downloader_builtin_catalog_and_cache(tmp_path):
    d = tdl.ModelDownloader(str(tmp_path / "repo"))
    jd = jdl.ModelDownloader(str(tmp_path / "jrepo"))
    assert [s.to_json() for s in d.remote_models()] == [
        s.to_json() for s in jd.remote_models()]
    schema = d.download_model("ConvNetMNIST")
    payload = tmp_path / "repo" / "ConvNetMNIST" / "model.pkl"
    assert schema.sha256 == hashlib.sha256(payload.read_bytes()).hexdigest()
    assert "pool" in schema.layerNames
    again = d.download_model("ConvNetMNIST")
    assert again.sha256 == schema.sha256
    assert [s.name for s in d.local_models()] == ["ConvNetMNIST"]
    params, cfg, apply_fn = d.load_model("ConvNetMNIST")
    assert isinstance(params["stem"]["w"], torch.Tensor)
    logits, _ = apply_fn(params, torch.zeros(1, 28, 28, 3))
    assert logits.shape == (1, 10)
    # the same flattened keys and config bytes as the JAX package's payload
    jd.download_model("ConvNetMNIST")
    mine = np.load(str(payload))
    theirs = np.load(str(tmp_path / "jrepo" / "ConvNetMNIST" / "model.pkl"))
    assert sorted(mine.files) == sorted(theirs.files)
    assert bytes(mine["config_json"]) == bytes(theirs["config_json"])
    for k in theirs.files:
        assert mine[k].shape == theirs[k].shape and (
            mine[k].dtype == theirs[k].dtype), k
    with open(tmp_path / "jrepo" / "ConvNetMNIST" / "schema.json") as f:
        js = json.load(f)
    with open(tmp_path / "repo" / "ConvNetMNIST" / "schema.json") as f:
        ts = json.load(f)
    assert {k: v for k, v in js.items() if k != "sha256"} == {
        k: v for k, v in ts.items() if k != "sha256"}


def test_builtin_is_seeded_from_the_name(tmp_path):
    a = tdl.ModelDownloader(str(tmp_path / "a")).download_model("ResNet10Micro")
    b = tdl.ModelDownloader(str(tmp_path / "b")).download_model("ResNet10Micro")
    pa = tdl.ModelDownloader(str(tmp_path / "a")).load_model(
        "ResNet10Micro")[0]
    pb = tdl.ModelDownloader(str(tmp_path / "b")).load_model(
        "ResNet10Micro")[0]
    assert torch.equal(pa["stem"]["w"], pb["stem"]["w"])
    assert a.name == b.name


def test_downloader_file_uri_and_hash_check(tmp_path):
    blob = b"fake model payload"
    src = tmp_path / "m.pkl"
    src.write_bytes(blob)
    d = tdl.ModelDownloader(str(tmp_path / "repo"))
    d.download_model(tdl.ModelSchema(
        name="ext", uri=f"file://{src}",
        sha256=hashlib.sha256(blob).hexdigest()))
    assert (tmp_path / "repo" / "ext" / "model.pkl").read_bytes() == blob
    with pytest.raises(IOError, match="hash mismatch"):
        d.download_model(tdl.ModelSchema(name="ext2", uri=f"file://{src}",
                                         sha256="0" * 64))


def test_downloader_refuses_http(tmp_path):
    """``http://`` payloads are fetched through the port's
    ``advanced_handling``: the hash is checked, a tampered payload and a
    non-npz one are refused, and the schema written equals the JAX
    ``ModelDownloader``'s from the same server."""
    import threading
    import zipfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    fixture = os.path.join(tdl.FIXTURES_DIR, "digits_convnet.npz")
    with open(fixture, "rb") as f:
        data = f.read()
    mid = len(data) // 2
    other = tdl.serialize_payload(
        {"w": np.zeros((2, 2), np.float32)}, {"arch": "none"})
    bodies = {"/m.npz": data,
              "/flipped.npz": data[:mid] + bytes([data[mid] ^ 1])
              + data[mid + 1:],
              "/other.npz": other,
              "/m.pkl": b"\x80\x04K\x01."}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = bodies.get(self.path)
            self.send_response(200 if body is not None else 404)
            self.send_header("Content-Length", str(len(body or b"")))
            self.end_headers()
            self.wfile.write(body or b"")

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("localhost", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://localhost:{httpd.server_address[1]}"
    sha = hashlib.sha256(data).hexdigest()
    try:
        got = {}
        for name, mod in (("port", tdl), ("jax", jdl)):
            schema = mod.ModelDownloader(str(tmp_path / name)).download_model(
                mod.ModelSchema(name="web", uri=f"{base}/m.npz", sha256=sha))
            assert (tmp_path / name / "web" / "model.pkl").read_bytes() \
                == data
            got[name] = json.loads(schema.to_json())
        assert got["port"] == got["jax"]
        d = tdl.ModelDownloader(str(tmp_path / "r2"))
        # a payload other than the pinned one, and the pinned one with a
        # byte flipped (its zip no longer reads), are refused unwritten
        with pytest.raises(IOError, match="hash mismatch"):
            d.download_model(tdl.ModelSchema(
                name="t", uri=f"{base}/other.npz", sha256=sha))
        with pytest.raises(zipfile.BadZipFile):
            d.download_model(tdl.ModelSchema(
                name="t", uri=f"{base}/flipped.npz", sha256=sha))
        assert not (tmp_path / "r2" / "t" / "model.pkl").exists()
        with pytest.raises(IOError, match="npz"):
            d.download_model(tdl.ModelSchema(name="p", uri=f"{base}/m.pkl"))
        with pytest.raises(IOError, match="404"):
            d._fetch(tdl.ModelSchema(name="x", uri=f"{base}/missing"))
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_package_fixture_hash_and_tampering(tmp_path, monkeypatch):
    fixture = os.path.join(tdl.FIXTURES_DIR, "digits_convnet.npz")
    with open(fixture, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == \
        tdl._TRAINED_FIXTURES["DigitsConvNet"]["sha256"]
    with open(os.path.join(os.path.dirname(jdl.__file__), "fixtures",
                           "digits_convnet.npz"), "rb") as f:
        assert f.read() == data
    d = tdl.ModelDownloader(str(tmp_path / "repo"))
    assert d.download_model("DigitsConvNet").sha256 == \
        tdl._TRAINED_FIXTURES["DigitsConvNet"]["sha256"]
    schema = d._builtin_schema("DigitsConvNet")
    schema.sha256 = "0" * 64
    with pytest.raises(IOError, match="hash mismatch"):
        tdl.ModelDownloader(str(tmp_path / "r2")).download_model(schema)
    # a fixture whose bytes were altered fails its pinned hash
    fake = tmp_path / "fixtures"
    fake.mkdir()
    mid = len(data) // 2
    (fake / "digits_convnet.npz").write_bytes(
        data[:mid] + bytes([data[mid] ^ 1]) + data[mid + 1:])
    monkeypatch.setattr(tdl, "FIXTURES_DIR", str(fake))
    with pytest.raises(IOError, match="hash mismatch"):
        tdl.ModelDownloader(str(tmp_path / "r3")).download_model(
            "DigitsConvNet")


@pytest.mark.parametrize("name", ["ResNet10Micro", "ResNet50Tiny",
                                  "AlexNetTiny"])
def test_repositories_load_across_packages(tmp_path, name):
    x = _x(3, 4, hw=(64, 64))
    for writer in ("jax", "port"):
        repo = str(tmp_path / writer)
        (jdl if writer == "jax" else tdl).ModelDownloader(
            repo).download_model(name)
        jm = JDNNModel.from_downloader(repo, name).set(
            inputCol="x", outputCol="y", outputNode="logits")
        tm = DNNModel.from_downloader(repo, name, device="cpu").set(
            inputCol="x", outputCol="y", outputNode="logits")
        assert tm.apply_spec == jm.apply_spec
        _close(tm.transform(Dataset({"x": x}))["y"],
               jm.transform(JDataset({"x": x}))["y"], F32_RTOL, writer)


def test_import_torch_resnet_and_save_model(tmp_path):
    cfg = T.CNNConfig(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8,
                      block="bottleneck", input_hw=(64, 64))
    sd = _rand_sd(np.random.default_rng(8), cfg)
    d = tdl.ModelDownloader(str(tmp_path))
    schema = d.import_torch_resnet("Mine", sd, arch_name="ResNet50Tiny")
    assert schema.sha256
    jparams, jcfg, _ = jdl.ModelDownloader(str(tmp_path)).load_model("Mine")
    params, tcfg, apply_fn = d.load_model("Mine")
    assert tcfg.block == "bottleneck" and tcfg.num_classes == 10
    x = _x(2, 9, hw=(64, 64))
    want, _ = J.apply_cnn(jparams, jnp.asarray(x), jcfg)
    got, _ = apply_fn(params, torch.from_numpy(x))
    _close(got, np.asarray(want), F32_RTOL)
    d.save_model("Again", params, {"arch": "resnet", "num_classes": 10,
                                   "stage_sizes": (1, 1, 1, 1), "width": 8,
                                   "block": "bottleneck",
                                   "input_hw": (64, 64)})
    back = d.load_model("Again")[0]
    assert torch.equal(back["stage3_block0"]["proj"]["w"],
                       params["stage3_block0"]["proj"]["w"])


# -- stage directories --------------------------------------------------------


def test_stage_directories_load_across_packages(tmp_path, tiny):
    params, spec = tiny
    x = _x(3, 5)
    imgs = _imgs([(20, 24), (31, 17)])
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="x", outputCol="y", outputNode="pool", miniBatchSize=2)
    jf = JFeaturizer(jm, input_hw=(16, 16), mean=(100.0,) * 3,
                     std=(50.0,) * 3).set(inputCol="img", outputCol="f")
    jm.save(str(tmp_path / "jm"))
    jf.save(str(tmp_path / "jf"))
    tm = PipelineStage.load(str(tmp_path / "jm")).set(device="cpu")
    tf = PipelineStage.load(str(tmp_path / "jf")).set(device="cpu")
    assert type(tm) is DNNModel and type(tf) is ImageFeaturizer
    assert tf.norm_mean == (100.0,) * 3
    want_m = jm.transform(JDataset({"x": x}))["y"]
    want_f = jf.transform(JDataset({"img": imgs}))["f"]
    _close(tm.transform(Dataset({"x": x}))["y"], want_m, F32_RTOL)
    _close(tf.transform(Dataset({"img": imgs}))["f"], want_f, 1e-4)
    # the port's saves hold the JAX package's payloads: with the classes
    # named in their metadata mapped back, they load in the JAX package
    tm.clear("device").save(str(tmp_path / "tm"))
    tf.clear("device").save(str(tmp_path / "tf"))
    for meta in ("tm", "tf", os.path.join("tf", "dnn")):
        path = tmp_path / meta / "metadata.json"
        path.write_text(path.read_text().replace("mmlspark_tpu_torch.",
                                                 "mmlspark_tpu."))
    from mmlspark_tpu.core.pipeline import load_stage as jload
    jm2, jf2 = jload(str(tmp_path / "tm")), jload(str(tmp_path / "tf"))
    assert type(jm2) is JDNNModel and type(jf2) is JFeaturizer
    _close(jm2.transform(JDataset({"x": x}))["y"], want_m, F32_RTOL)
    _close(jf2.transform(JDataset({"img": imgs}))["f"], want_f, F32_RTOL)


def _plus_one(p, x):
    return x + 1.0


def _jax_negative(p, x):
    return jnp.negative(x)


def test_pickled_apply_fn_dirs(tmp_path, tiny):
    params, _ = tiny
    JDNNModel(params, _jax_negative).set(inputCol="x").save(
        str(tmp_path / "jfn"))
    with pytest.raises(ValueError, match="JAX function"):
        PipelineStage.load(str(tmp_path / "jfn"))
    m = DNNModel(None, _plus_one, device="cpu").set(inputCol="x",
                                                    miniBatchSize=2)
    m.save(str(tmp_path / "tfn"))
    back = PipelineStage.load(str(tmp_path / "tfn"))
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(back.transform(Dataset({"x": x}))["output"],
                                  x + 1.0)
    with pytest.raises(ValueError, match="not picklable"):
        DNNModel(None, lambda p, x: x).set(inputCol="x").save(
            str(tmp_path / "lam"))


def test_jax_saved_stage_loads_without_jax(tmp_path, tiny):
    params, spec = tiny
    x = _x(4, 6)
    jm = JDNNModel(params, apply_spec=spec).set(
        inputCol="x", outputCol="y", outputNode="logits", miniBatchSize=3)
    jm.save(str(tmp_path / "jm"))
    want = DNNModel(params_from_jax(params), apply_spec=spec,
                    device="cpu").set(inputCol="x", outputCol="y",
                                      outputNode="logits",
                                      miniBatchSize=3).transform(
        Dataset({"x": x}))["y"]
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "want.npy"), want)
    code = textwrap.dedent(f"""
    import sys
    for m in ("jax", "jaxlib", "mmlspark_tpu"):
        sys.modules[m] = None
    import numpy as np, torch
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    m = PipelineStage.load({str(tmp_path / 'jm')!r}).set(device="cpu")
    x = np.load({str(tmp_path / 'x.npy')!r})
    got = m.transform(Dataset({{"x": x}}))["y"]
    assert np.array_equal(got, np.load({str(tmp_path / 'want.npy')!r}))
    print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


# -- the trained fixture --------------------------------------------------------


def test_digits_fixture_is_trained_and_transfer_accuracy_pinned(tmp_path):
    """The JAX package's transfer-learning anchor, in the port: pooled
    features of the trained DigitsConvNet, 100 labels, a GBDT head, held-out
    digits; the trained features must beat raw pixels by 0.03 and the same
    net with random weights by 0.1, and clear 0.75."""
    from sklearn.datasets import load_digits

    from mmlspark_tpu_torch.models.dnn.digits_fixture import (
        digits_images, heldout_split, prep_digits)
    from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier

    X, y = load_digits(return_X_y=True)
    Xtr, Xte, ytr, yte = heldout_split(X, y)
    d = tdl.ModelDownloader(str(tmp_path))
    d.download_model("DigitsConvNet")
    params, cfg, apply_fn = d.load_model("DigitsConvNet")
    logits, _ = apply_fn(params, torch.from_numpy(
        prep_digits(Xte).astype(np.float32)))
    assert float((logits.argmax(1).numpy() == yte).mean()) > 0.9
    Xte, yte = Xte[:250], yte[:250]
    lab = np.random.default_rng(1).choice(len(Xtr), size=100, replace=False)
    dnn = DNNModel.from_downloader(str(tmp_path), "DigitsConvNet")

    def head_acc(featurizer):
        tr = Dataset({"img": digits_images(Xtr[lab]),
                      "pixels": Xtr[lab].astype(np.float32),
                      "label": ytr[lab].astype(np.float64)})
        te = Dataset({"img": digits_images(Xte),
                      "pixels": Xte.astype(np.float32)})
        col = "pixels"
        if featurizer is not None:
            tr, te, col = featurizer.transform(tr), featurizer.transform(te), \
                "f"
        clf = LightGBMClassifier(numIterations=30, numLeaves=7,
                                 minDataInLeaf=3, featuresCol=col,
                                 device="cpu").fit(tr)
        return float((clf.transform(te).array("prediction") == yte).mean())

    def featurizer_for(model):
        return ImageFeaturizer(model, input_hw=(32, 32), device="cpu").set(
            inputCol="img", outputCol="f", cutOutputLayers=1)

    acc_trained = head_acc(featurizer_for(dnn))
    acc_pixels = head_acc(None)
    rand = DNNModel(T.init_cnn_params(T.CNNConfig(**{
        **dnn.apply_spec["config"]}), prng.prng_key(3)),
        apply_spec=dnn.apply_spec)
    acc_random = head_acc(featurizer_for(rand))
    assert acc_trained > 0.75, acc_trained
    assert acc_trained > acc_pixels + 0.03, (acc_trained, acc_pixels)
    assert acc_trained > acc_random + 0.1, (acc_trained, acc_random)


# -- device defaults ------------------------------------------------------------


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise(no_gpu, tiny):
    params, spec = tiny
    ds = Dataset({"x": _x(2, 0), "img": _imgs([(20, 20), (18, 22)])})
    m = DNNModel(params_from_jax(params), apply_spec=spec).set(
        inputCol="x", outputNode="pool")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        m.transform(ds)
    f = ImageFeaturizer(m, input_hw=(16, 16)).set(inputCol="img")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        f.transform(ds)
    assert m.set(device="cpu").transform(ds)["output"].shape == (2, 8)
    assert f.set(device="cpu").transform(ds)["features"].shape == (2, 8)


def test_exact_f32_scopes_the_tf32_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with devmod.exact_f32(torch.device("cpu")):
            assert cudnn.allow_tf32 and matmul.allow_tf32
        with devmod.exact_f32(torch.device("cuda")):
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
            with devmod.exact_f32(torch.device("cuda")):
                assert not cudnn.allow_tf32
            assert not cudnn.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
        with pytest.raises(KeyError):
            with devmod.exact_f32(torch.device("cuda")):
                raise KeyError("inside")
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
