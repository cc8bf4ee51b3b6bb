"""Image ops layer (counterpart of ``mmlspark_tpu/image``; reference:
opencv/ + image/ — SURVEY.md §2c)."""

from .ops import (DecodeImage, ImageSetAugmenter, ImageTransformer,
                  ResizeImageTransformer, UnrollImage, blur_image,
                  center_crop, crop_image, decode_image, flip_image,
                  gaussian_kernel, normalize_image, resize_image,
                  threshold_image, to_grayscale)

__all__ = [
    "DecodeImage", "ImageSetAugmenter", "ImageTransformer",
    "ResizeImageTransformer", "UnrollImage", "blur_image", "center_crop",
    "crop_image", "decode_image", "flip_image", "gaussian_kernel",
    "normalize_image", "resize_image", "threshold_image", "to_grayscale",
]
