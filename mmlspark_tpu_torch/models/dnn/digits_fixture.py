"""Shared preprocessing for the DigitsConvNet trained fixture.

The port's copy of ``mmlspark_tpu/models/dnn/digits_fixture.py`` (host
code, unchanged; ``sklearn`` is imported only by :func:`heldout_split`).

Single source of truth for how sklearn digits become DigitsConvNet inputs —
used by the trainer (tools/train_digits_fixture.py), the transfer-learning
example (examples/21), and the fixture tests, so the three can never drift
from the preprocessing the checkpoint was trained with.
"""

from __future__ import annotations

import numpy as np


def upsample_digits(flat: np.ndarray) -> np.ndarray:
    """8x8 [0,16] digit rows -> [n, 32, 32] float arrays in 0..255."""
    imgs = flat.reshape(-1, 8, 8) / 16.0 * 255.0
    return np.kron(imgs, np.ones((1, 4, 4)))


def prep_digits(flat: np.ndarray) -> np.ndarray:
    """Model-input tensors: 32x32x3, normalized to [-1, 1] (the
    mean=std=127.5 convention ImageFeaturizer defaults to)."""
    imgs = np.stack([upsample_digits(flat)] * 3, axis=-1).astype(np.float32)
    return (imgs - 127.5) / 127.5


def digits_images(flat: np.ndarray) -> list:
    """uint8 HWC images for the ImageFeaturizer input column."""
    return [np.stack([im] * 3, axis=-1).astype(np.uint8)
            for im in upsample_digits(flat)]


def heldout_split(X, y):
    """The trainer's exact split; the returned test quarter was never seen
    in pretraining."""
    from sklearn.model_selection import train_test_split

    return train_test_split(X, y, test_size=0.25, random_state=0,
                            stratify=y)
