"""The port's one device resolver.

Every entry point of the port takes ``device``; ``None`` means the default,
``cuda``. A request for ``cuda`` on a machine without a usable GPU raises:
the port never moves work to the CPU on its own. The CPU is used only when
the caller passes ``device="cpu"`` (as the CPU tests do). :func:`exact_f32`
scopes f32 work on the card to full f32 (no TF32).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``cuda``/``cuda:N`` must exist or this raises;
    ``cpu`` is honoured as given. Any other device type is refused."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU explicitly")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")


# exact_f32's nesting count across threads, and the flags it restores
_EXACT_LOCK = threading.Lock()
_EXACT_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def exact_f32(device: torch.device):
    """Run f32 convolutions and matmuls on ``device`` without TF32.

    PyTorch lets cuDNN round f32 convolution inputs to TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which moved ResNet-50's logits
    on an H100 by about a thousand times the spread one ulp of input makes
    (PERF.md §6). Inside this scope both TF32 flags are off; the caller's
    values come back when the last scope open in the process closes
    (scopes of several threads nest). On the CPU it does nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _EXACT_LOCK:
        if _EXACT_STATE["depth"] == 0:
            _EXACT_STATE["saved"] = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
        _EXACT_STATE["depth"] += 1
    try:
        yield
    finally:
        with _EXACT_LOCK:
            _EXACT_STATE["depth"] -= 1
            if _EXACT_STATE["depth"] == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _EXACT_STATE["saved"]
