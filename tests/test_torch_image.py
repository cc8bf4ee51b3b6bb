"""The port's image ops (``mmlspark_tpu_torch/image``) against the JAX
package's, on the CPU, on seeded images.

* ``resize_image`` against ``jax.image.resize(..., "bilinear")``: shrinking
  (which both antialias) within 1e-3 on the 0..255 scale (the two
  separable passes round in another order: 5.5e-4 measured at 500x375 ->
  224x224), growing and same-size within 1e-4; a stack of same-shape
  images through ``ImageTransformer``'s grouped path is bit-equal to one
  call per image.
* ``blur_image`` (reflect borders, two depthwise convolutions) within
  1e-5 on unit-scale inputs, one image and a stack, odd and even sizes.
* The host stages (crop, centre crop, grayscale, flip, threshold,
  normalize), ``UnrollImage``'s CHW order, ``ImageSetAugmenter`` and
  ``DecodeImage`` equal to the JAX package's exactly; every chain of
  ``ImageTransformer`` within the resize and blur tolerances above.
* ``decode_image`` returns None for bytes that do not decode and raises
  when PIL is missing (the JAX package decodes every image to None then).
* A JAX-saved ``ImageTransformer`` loads in the port and transforms equal.
* The device stages default to ``cuda`` and raise without a GPU.
"""

import io as _io
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.image import ops as J
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.image import ops as T

torch.set_num_threads(1)

SHRINK_ATOL = 1e-3      # 0..255 scale
GROW_ATOL = 1e-4
BLUR_ATOL = 1e-5        # unit-scale inputs


def _img(h, w, seed=0, c=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, c)).astype(np.uint8)


def _png(arr):
    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("hw,out,atol", [
    ((500, 375), (224, 224), SHRINK_ATOL),
    ((375, 500), (224, 224), SHRINK_ATOL),
    ((64, 64), (32, 32), SHRINK_ATOL),
    ((37, 53), (20, 17), SHRINK_ATOL),
    ((20, 30), (64, 48), GROW_ATOL),
    ((33, 17), (33, 17), GROW_ATOL),
    ((24, 40), (48, 20), SHRINK_ATOL),
])
def test_resize_matches_jax_both_directions(hw, out, atol):
    img = _img(*hw, seed=hw[0])
    want = J.resize_image(img, *out)
    got = T.resize_image(img, *out, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    stack = np.stack([img, _img(*hw, seed=7)])
    np.testing.assert_allclose(T.resize_image(stack, *out, device="cpu"),
                               J.resize_image(stack, *out), rtol=0,
                               atol=atol)


def test_grouped_resize_is_bit_equal_to_one_call_per_image(monkeypatch):
    shapes = [(50, 40), (40, 50), (50, 40), (33, 31), (50, 40), (40, 50)]
    imgs = [_img(h, w, seed=i) for i, (h, w) in enumerate(shapes)]
    imgs.insert(2, None)
    monkeypatch.setattr(T, "RESIZE_CHUNK", 2)
    tr = (T.ImageTransformer(device="cpu").set(inputCol="i", outputCol="o")
          .resize(24, 24).normalize(mean=(1, 2, 3), std=(4, 5, 6)))
    out = tr.transform(Dataset({"i": imgs}))["o"]
    assert out[2] is None
    for img, got in zip(imgs, out):
        if img is None:
            continue
        one = T.normalize_image(T.resize_image(img, 24, 24, device="cpu"),
                                (1, 2, 3), (4, 5, 6))
        np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("ksize,sigma,hw", [(3, 0.0, (19, 23)),
                                            (5, 1.5, (16, 16)),
                                            (7, 0.0, (12, 9)),
                                            (1, 0.0, (5, 6))])
def test_blur_matches_jax_with_reflect_borders(ksize, sigma, hw):
    rng = np.random.default_rng(ksize)
    img = rng.normal(size=(*hw, 3)).astype(np.float32)
    np.testing.assert_allclose(T.blur_image(img, ksize, sigma, device="cpu"),
                               J.blur_image(img, ksize, sigma), rtol=0,
                               atol=BLUR_ATOL)
    stack = rng.normal(size=(2, *hw, 1)).astype(np.float32)
    np.testing.assert_allclose(
        T.blur_image(stack, ksize, sigma, device="cpu"),
        J.blur_image(stack, ksize, sigma), rtol=0, atol=BLUR_ATOL)


def test_gaussian_kernel_equal():
    for k, s in ((3, 0.0), (5, 1.5), (9, 2.0)):
        np.testing.assert_array_equal(T.gaussian_kernel(k, s),
                                      J.gaussian_kernel(k, s))


@pytest.mark.parametrize("name,fn", [
    ("center_crop", lambda m, img: m.center_crop(img, 10, 7)),
    ("crop", lambda m, img: m.crop_image(img, 3, 2, 9, 11)),
    ("gray", lambda m, img: m.to_grayscale(img)),
    ("flip_h", lambda m, img: m.flip_image(img, 1)),
    ("flip_v", lambda m, img: m.flip_image(img, 0)),
    ("flip_both", lambda m, img: m.flip_image(img, -1)),
    ("binary", lambda m, img: m.threshold_image(img, 100.0)),
    ("binary_inv", lambda m, img: m.threshold_image(img, 50.0, 200.0,
                                                    "binary_inv")),
    ("trunc", lambda m, img: m.threshold_image(img, 128.0, method="trunc")),
    ("tozero", lambda m, img: m.threshold_image(img, 90.0,
                                                method="tozero")),
    ("normalize", lambda m, img: m.normalize_image(
        img, (120.0, 110.0, 100.0), (60.0, 50.0, 40.0), 1.5)),
])
def test_host_stage_functions_equal_jax(name, fn):
    img = _img(21, 17, seed=3)
    want, got = fn(J, img), fn(T, img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_threshold_refuses_unknown_method():
    with pytest.raises(ValueError, match="unknown threshold"):
        T.threshold_image(_img(4, 4), 1.0, method="otsu")


def _chains():
    return {
        "resize_normalize": lambda t: t.resize(24, 20).normalize(
            (127.5,) * 3, (127.5,) * 3),
        "crop_flip_gray": lambda t: t.center_crop(20, 18).flip(1)
        .color_format("gray"),
        "blur_threshold": lambda t: t.gaussian_blur(5, 1.0).threshold(
            100.0, method="tozero"),
        "crop_resize_blur": lambda t: t.crop(2, 3, 25, 21).resize(16, 16)
        .gaussian_blur(3),
    }


# a stacked column runs each stage once on the whole [N, H, W, C] array;
# the crop and flip stages index its first axes as an image's (the JAX
# package's behaviour, kept), so stacked chains use the per-pixel stages
STACKED_CHAINS = ("resize_normalize", "blur_threshold")


@pytest.mark.parametrize("chain,stacked", [
    (c, False) for c in sorted(_chains())] + [
    (c, True) for c in STACKED_CHAINS])
def test_image_transformer_chains_match_jax(chain, stacked):
    build = _chains()[chain]
    if stacked:
        col = np.stack([_img(30, 28, seed=s) for s in range(3)])
    else:
        col = [_img(30, 28, seed=0), _img(41, 33, seed=1), None,
               _img(30, 28, seed=2)]
    jt = build(J.ImageTransformer().set(inputCol="i", outputCol="o"))
    tt = build(T.ImageTransformer(device="cpu").set(inputCol="i",
                                                    outputCol="o"))
    want = jt.transform(JDataset({"i": col}))["o"]
    got = tt.transform(Dataset({"i": col}))["o"]
    assert type(got) is type(want) and len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=SHRINK_ATOL)


def test_resize_transformer_and_nchannels():
    imgs = [_img(30, 40), _img(50, 20, seed=3)]
    jr = J.ResizeImageTransformer().set(inputCol="i", outputCol="r",
                                        height=16, width=12)
    tr = T.ResizeImageTransformer(device="cpu").set(
        inputCol="i", outputCol="r", height=16, width=12)
    np.testing.assert_allclose(tr.transform(Dataset({"i": imgs}))["r"],
                               jr.transform(JDataset({"i": imgs}))["r"],
                               rtol=0, atol=SHRINK_ATOL)
    with pytest.raises(ValueError, match="channels"):
        tr.set(nChannels=1).transform(Dataset({"i": imgs}))


def test_unroll_image_chw_order_equals_jax():
    stack = np.stack([_img(5, 4, seed=s) for s in range(3)])
    ragged = [_img(5, 4), _img(3, 6, seed=1), None]
    for col in (stack, ragged, [_img(5, 4), _img(4, 5, seed=2)]):
        want = J.UnrollImage().set(inputCol="i", outputCol="u").transform(
            JDataset({"i": col}))["u"]
        got = T.UnrollImage().set(inputCol="i", outputCol="u").transform(
            Dataset({"i": col}))["u"]
        assert type(got) is type(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    # CHW: the first H*W values are the red plane
    u = T.UnrollImage().set(inputCol="i").transform(
        Dataset({"i": stack}))["unrolled"]
    np.testing.assert_array_equal(u[0, :20], stack[0, :, :, 0].reshape(-1))
    with pytest.raises(ValueError, match="channels"):
        T.UnrollImage().set(inputCol="i", nChannels=1).transform(
            Dataset({"i": stack}))


@pytest.mark.parametrize("lr,ud", [(True, False), (True, True),
                                   (False, True)])
@pytest.mark.parametrize("stacked", [False, True])
def test_image_set_augmenter_equals_jax(lr, ud, stacked):
    imgs = [_img(6, 5, seed=s) for s in range(3)]
    col = np.stack(imgs) if stacked else imgs[:2] + [None]
    labels = np.arange(3)
    want = J.ImageSetAugmenter().set(
        inputCol="i", outputCol="o", flipLeftRight=lr,
        flipUpDown=ud).transform(JDataset({"i": col, "label": labels}))
    got = T.ImageSetAugmenter().set(
        inputCol="i", outputCol="o", flipLeftRight=lr,
        flipUpDown=ud).transform(Dataset({"i": col, "label": labels}))
    assert len(got) == len(want)
    np.testing.assert_array_equal(got["label"], want["label"])
    for g, w in zip(got["o"], want["o"]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_decode_image_roundtrip_and_bad_bytes():
    img = _img(9, 7, seed=5)
    blobs = [_png(img), b"not an image", b"", _png(_img(4, 4, seed=1)[..., :1]
                                                   .repeat(3, axis=2))]
    want = J.DecodeImage().set(inputCol="b", outputCol="img").transform(
        JDataset({"b": blobs}))["img"]
    got = T.DecodeImage().set(inputCol="b", outputCol="img").transform(
        Dataset({"b": blobs}))["img"]
    np.testing.assert_array_equal(got[0], img)
    assert got[1] is None and got[2] is None
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_decode_image_raises_without_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        T.decode_image(_png(_img(4, 4)))
    # the JAX package swallows the ImportError: every image decodes to None
    assert J.decode_image(b"\x89PNG") is None


def test_jax_saved_image_transformer_loads_and_transforms_equal(tmp_path):
    jt = (J.ImageTransformer().set(inputCol="i", outputCol="o")
          .resize(12, 10).flip(1).normalize((10.0,) * 3, (2.0,) * 3))
    jt.save(str(tmp_path / "t"))
    tt = PipelineStage.load(str(tmp_path / "t"))
    assert type(tt) is T.ImageTransformer
    tt.set(device="cpu")
    col = [_img(20, 16), _img(15, 22, seed=1)]
    want = jt.transform(JDataset({"i": col}))["o"]
    got = tt.transform(Dataset({"i": col}))["o"]
    np.testing.assert_allclose(got, want, rtol=0, atol=SHRINK_ATOL)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_stages_default_to_cuda_and_raise(no_gpu):
    img = _img(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.resize_image(img, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.blur_image(img.astype(np.float32))
    ds = Dataset({"i": [img]})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.ImageTransformer().set(inputCol="i").resize(4, 4).transform(ds)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.ResizeImageTransformer().set(inputCol="i", height=4,
                                       width=4).transform(ds)
    out = T.ResizeImageTransformer(device="cpu").set(
        inputCol="i", outputCol="r", height=4, width=4).transform(ds)
    assert out["r"].shape == (1, 4, 4, 3)
