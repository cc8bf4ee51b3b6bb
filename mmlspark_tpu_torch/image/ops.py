"""Image pipeline stages: decode, resize, crop, color, flip, blur, threshold.

Counterpart of ``mmlspark_tpu/image/ops.py`` (reference:
opencv/ImageTransformer.scala:26-395 — the stage classes ResizeImage,
CenterCrop, ColorFormat, Flip, Blur, Threshold, GaussianKernel — and
image/UnrollImage.scala:24-223, ResizeImageTransformer.scala:21-58,
ImageSetAugmenter.scala:15-17). Decode runs on the host (PIL); the stage
functions take and return numpy arrays, one ``HxWxC`` image or an
``NxHxWxC`` stack. :func:`resize_image` and :func:`blur_image` run on the
device (``device=``, default ``cuda``), the rest on the host in numpy, as
in the JAX package.

An "image column" is either a list of HxWxC uint8/float arrays (ragged
sizes) or one stacked (N, H, W, C) array once sizes agree (post-resize).
:class:`ImageTransformer` sends the images of a ragged column that share a
shape through one device call per chunk where every stage of its chain
computes each pixel from its own image alone (resize and the elementwise
stages): the result is bit-equal to one call per image.
"""

from __future__ import annotations

import io as _io
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dataset import Dataset
from ..core.params import (HasDevice, HasInputCol, HasOutputCol, Param,
                           TypeConverters)
from ..core.pipeline import Transformer
from ..device import DeviceLike, exact_f32, resolve_device

# images of one shape sent to the device in one resize call, at most
RESIZE_CHUNK = 256

# ---------------------------------------------------------------------------
# Decode (host side; reference decodes via ImageSchema/ImageInjections)
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """bytes -> HxWxC uint8 RGB array, or None if the bytes do not decode
    (the reference emits null rows for bad images). Raises ImportError
    when PIL itself is missing, instead of decoding every image to None
    as the JAX package does."""
    from PIL import Image
    try:
        img = Image.open(_io.BytesIO(data))
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    except (OSError, ValueError, SyntaxError, EOFError, TypeError,
            Image.DecompressionBombError):
        return None


class DecodeImage(Transformer, HasInputCol, HasOutputCol):
    """bytes column -> image arrays (io/image/ImageUtils.scala:26)."""

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "image"
        return dataset.with_column(
            out_col, [decode_image(b) for b in dataset[in_col]])


# ---------------------------------------------------------------------------
# Stage functions (act on one HxWxC array or a stacked NxHxWxC batch)
# ---------------------------------------------------------------------------


def _as_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) if img.dtype != np.float32 else img


def _check_channels(img_or_batch, nc: Optional[int]) -> None:
    """Validate channel count for one HxWxC image or an NxHxWxC batch."""
    if nc is None or img_or_batch is None:
        return
    nd = getattr(img_or_batch, "ndim", 0)
    got = img_or_batch.shape[-1] if nd in (3, 4) else 1
    if got != nc:
        raise ValueError(f"nChannels={nc} but images have {got} channels")


def _nchw_on(img: np.ndarray, dev: torch.device) -> Tuple[torch.Tensor, bool]:
    """One image or a stack as an f32 ``[N, C, H, W]`` tensor on ``dev``
    (uploaded in its own dtype, converted there: integer pixels convert
    exactly), and whether the input was a single image."""
    single = img.ndim == 3
    x = torch.from_numpy(np.ascontiguousarray(img[None] if single else img))
    x = x.to(dev).to(torch.float32)
    return x.permute(0, 3, 1, 2), single


def _nhwc_host(x: torch.Tensor, single: bool) -> np.ndarray:
    out = x.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return out[0] if single else out


def resize_image(img: np.ndarray, height: int, width: int,
                 device: DeviceLike = None) -> np.ndarray:
    """Bilinear resize on the device (replaces cv::resize). Accepts one
    HxWxC image or a stacked NxHxWxC batch; returns f32.

    Matches ``jax.image.resize(..., "bilinear")``, which antialiases when
    it shrinks: ``F.interpolate`` agrees with it only with
    ``antialias=True`` (half-pixel centres, ``align_corners=False``)."""
    dev = resolve_device(device)
    x, single = _nchw_on(img, dev)
    y = F.interpolate(x, size=(int(height), int(width)), mode="bilinear",
                      align_corners=False, antialias=True)
    return _nhwc_host(y, single)


def center_crop(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - height) // 2)
    left = max(0, (w - width) // 2)
    return img[top:top + height, left:left + width]


def crop_image(img: np.ndarray, x: int, y: int, height: int, width: int
               ) -> np.ndarray:
    return img[y:y + height, x:x + width]


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma (cv::cvtColor COLOR_RGB2GRAY coefficients)."""
    f = _as_float(img)
    gray = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    return gray[..., None]


def flip_image(img: np.ndarray, flip_code: int = 1) -> np.ndarray:
    """cv::flip semantics: 1 = horizontal, 0 = vertical, -1 = both."""
    if flip_code == 1:
        return img[:, ::-1]
    if flip_code == 0:
        return img[::-1]
    return img[::-1, ::-1]


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel parity (opencv/ImageTransformer GaussianKernel)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def blur_image(img: np.ndarray, ksize: int = 3, sigma: float = 0.0,
               device: DeviceLike = None) -> np.ndarray:
    """Separable gaussian blur on the device (replaces cv::GaussianBlur):
    reflect borders (cv::BORDER_REFLECT_101), then a vertical and a
    horizontal depthwise convolution in full f32."""
    dev = resolve_device(device)
    k = torch.from_numpy(gaussian_kernel(ksize, sigma)).to(dev)
    x, single = _nchw_on(img, dev)
    c = x.shape[1]
    pad = (ksize - 1) // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    with exact_f32(dev):
        x = F.conv2d(x, k.reshape(1, 1, ksize, 1).repeat(c, 1, 1, 1),
                     groups=c)
        x = F.conv2d(x, k.reshape(1, 1, 1, ksize).repeat(c, 1, 1, 1),
                     groups=c)
    return _nhwc_host(x, single)


def threshold_image(img: np.ndarray, threshold: float, max_val: float = 255.0,
                    method: str = "binary") -> np.ndarray:
    """cv::threshold subset: binary / binary_inv / trunc / tozero."""
    f = _as_float(img)
    if method == "binary":
        return np.where(f > threshold, max_val, 0.0).astype(np.float32)
    if method == "binary_inv":
        return np.where(f > threshold, 0.0, max_val).astype(np.float32)
    if method == "trunc":
        return np.minimum(f, threshold).astype(np.float32)
    if method == "tozero":
        return np.where(f > threshold, f, 0.0).astype(np.float32)
    raise ValueError(f"unknown threshold method {method!r}")


def normalize_image(img: np.ndarray, mean: Sequence[float],
                    std: Sequence[float], scale: float = 1.0) -> np.ndarray:
    """``(img * scale - mean) / std`` in f32, the JAX package's operations
    in its order, into one new array (a scale of 1 is exact, so it is
    skipped)."""
    f = _as_float(img)
    out = f * np.float32(scale) if scale != 1.0 else f.copy()
    out -= np.asarray(mean, np.float32)
    out /= np.asarray(std, np.float32)
    return out


# ---------------------------------------------------------------------------
# ImageTransformer: composable stage list (opencv/ImageTransformer.scala:26-395)
# ---------------------------------------------------------------------------

_STAGE_FNS: Dict[str, Callable] = {
    "resize": lambda img, p, dev: resize_image(img, p["height"], p["width"],
                                               device=dev),
    "centerCrop": lambda img, p, dev: center_crop(img, p["height"],
                                                  p["width"]),
    "crop": lambda img, p, dev: crop_image(img, p["x"], p["y"], p["height"],
                                           p["width"]),
    "colorFormat": lambda img, p, dev: (to_grayscale(img)
                                        if p.get("format") == "gray"
                                        else _as_float(img)),
    "flip": lambda img, p, dev: flip_image(img, p.get("flipCode", 1)),
    "blur": lambda img, p, dev: blur_image(img, int(p.get("ksize", 3)),
                                           float(p.get("sigma", 0.0)),
                                           device=dev),
    "threshold": lambda img, p, dev: threshold_image(
        img, p["threshold"], p.get("maxVal", 255.0),
        p.get("method", "binary")),
    "normalize": lambda img, p, dev: normalize_image(
        img, p.get("mean", (0, 0, 0)), p.get("std", (1, 1, 1)),
        p.get("scale", 1.0)),
}

# stages whose output pixel depends on its own image alone, computed the
# same way whatever else is in the call: a chain of these may run on a
# stack of same-shape images bit-equal to one call per image (a blur's
# convolution may pick another algorithm for another batch size)
_PER_IMAGE_EXACT = frozenset({"resize", "colorFormat", "threshold",
                              "normalize"})


class ImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Chain of image ops declared as (name, params) stages; fluent builders
    mirror the reference's ImageTransformer.resize(...).crop(...) API."""

    stages = Param("stages", "list of (op, params) stages", None)

    def _stages(self) -> List[Tuple[str, dict]]:
        return list(self.get_or_default("stages") or [])

    def _add(self, op: str, **params) -> "ImageTransformer":
        return self.set(stages=self._stages() + [(op, params)])

    def resize(self, height: int, width: int):
        return self._add("resize", height=height, width=width)

    def center_crop(self, height: int, width: int):
        return self._add("centerCrop", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add("crop", x=x, y=y, height=height, width=width)

    def color_format(self, fmt: str):
        return self._add("colorFormat", format=fmt)

    def flip(self, flip_code: int = 1):
        return self._add("flip", flipCode=flip_code)

    def gaussian_blur(self, ksize: int = 3, sigma: float = 0.0):
        return self._add("blur", ksize=ksize, sigma=sigma)

    def threshold(self, threshold: float, max_val: float = 255.0,
                  method: str = "binary"):
        return self._add("threshold", threshold=threshold, maxVal=max_val,
                         method=method)

    def normalize(self, mean, std, scale: float = 1.0):
        return self._add("normalize", mean=list(mean), std=list(std),
                         scale=scale)

    def transform(self, dataset: Dataset) -> Dataset:
        dev = self._device()
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or in_col
        stages = self._stages()

        def apply(img):
            if img is None:
                return None
            for op, params in stages:
                img = _STAGE_FNS[op](img, params, dev)
            return img

        col = dataset[in_col]
        if isinstance(col, np.ndarray) and col.ndim == 4:
            # stacked batch: run every stage vectorised over N at once
            out = apply(col)
        else:
            if all(op in _PER_IMAGE_EXACT for op, _ in stages):
                out = _apply_grouped(col, apply)
            else:
                out = [apply(img) for img in col]
            if out and all(o is not None for o in out):
                shapes = {o.shape for o in out}
                if len(shapes) == 1:
                    out = np.stack(out)
        return dataset.with_column(out_col, out)


def _apply_grouped(col, apply) -> list:
    """``[apply(img) for img in col]``, with the HxWxC images of one shape
    and dtype stacked and sent through ``apply`` together, at most
    :data:`RESIZE_CHUNK` at a time (only for chains of
    ``_PER_IMAGE_EXACT`` stages, so each output equals its own call's)."""
    out: list = [None] * len(col)
    groups: Dict[tuple, List[int]] = {}
    for i, img in enumerate(col):
        if img is None:
            continue
        a = np.asarray(img)
        if a.ndim == 3:
            groups.setdefault((a.shape, a.dtype.str), []).append(i)
        else:
            out[i] = apply(a)
    for idx in groups.values():
        for lo in range(0, len(idx), RESIZE_CHUNK):
            part = idx[lo:lo + RESIZE_CHUNK]
            res = apply(np.stack([np.asarray(col[i]) for i in part]))
            for j, i in enumerate(part):
                out[i] = res[j]
    return out


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol,
                             HasDevice):
    """Standalone resize (image/ResizeImageTransformer.scala:21-58)."""

    height = Param("height", "target height", None, TypeConverters.to_int)
    width = Param("width", "target width", None, TypeConverters.to_int)
    nChannels = Param("nChannels", "expected channel count; mismatching "
                      "images raise (reference: ResizeImageTransformer "
                      "nChannels)", None, TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        nc = self.get_or_default("nChannels")
        if nc is not None:
            for img in dataset[self.get_or_default("inputCol")]:
                _check_channels(img, nc)
        return (ImageTransformer()
                .set(inputCol=self.get_or_default("inputCol"),
                     outputCol=self.get_or_default("outputCol"),
                     device=self.get_or_default("device"))
                .resize(self.get_or_default("height"),
                        self.get_or_default("width"))
                .transform(dataset))


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Image -> flat float vector (image/UnrollImage.scala:24-223). The
    reference unrolls to CNTK's CHW plane order; we keep that convention so
    featurizer vectors are comparable."""

    nChannels = Param("nChannels", "expected channel count; mismatching "
                      "images raise (reference: UnrollImage nChannels)",
                      None, TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "unrolled"
        col = dataset[in_col]
        nc = self.get_or_default("nChannels")

        def unroll(img):
            if img is None:
                return None
            _check_channels(img, nc)
            f = _as_float(img)
            return np.moveaxis(f, -1, 0).reshape(-1)  # HWC -> CHW -> flat

        if isinstance(col, np.ndarray) and col.ndim == 4:
            _check_channels(col, nc)
            out = np.moveaxis(_as_float(col), -1, 1).reshape(col.shape[0], -1)
        else:
            out = [unroll(img) for img in col]
            if out and all(o is not None for o in out):
                lens = {len(o) for o in out}
                if len(lens) == 1:
                    out = np.stack(out)
        return dataset.with_column(out_col, out)


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Dataset augmentation by flips (image/ImageSetAugmenter.scala:15-17):
    emits the original rows plus flipped copies."""

    flipLeftRight = Param("flipLeftRight", "add horizontal flips", True,
                          TypeConverters.to_bool)
    flipUpDown = Param("flipUpDown", "add vertical flips", False,
                       TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or in_col
        base = dataset.with_column(out_col, dataset[in_col])
        out = base
        if self.get_or_default("flipLeftRight"):
            flipped = base.with_column(
                out_col, _flip_col(base[out_col], 1))
            out = out.union(flipped)
        if self.get_or_default("flipUpDown"):
            flipped = base.with_column(
                out_col, _flip_col(base[out_col], 0))
            out = out.union(flipped)
        return out


def _flip_col(col, code):
    if isinstance(col, np.ndarray) and col.ndim == 4:  # (N, H, W, C) batch
        return col[:, :, ::-1] if code == 1 else col[:, ::-1]
    return [None if img is None else flip_image(img, code) for img in col]
