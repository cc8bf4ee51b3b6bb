"""The JAX package's random streams, as torch integer ops.

The JAX package draws all its randomness from ``jax.random`` with the
threefry2x32 generator in its partitionable form
(``jax_threefry_partitionable``, the default since jax 0.5). That stream
is integer arithmetic, so the same key gives the same bits on any device.
This module reproduces the subset the JAX package calls:

  * ``prng_key(seed)`` is the key pair ``(0, seed mod 2^32)``;
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
  * ``split(key, shape)`` is ``threefry2x32(key, (hi(i), lo(i)))`` over the
    row-major flat counters ``i`` of ``shape``;
  * element ``i`` of ``bits(key, shape)`` is ``x0 ^ x1`` of
    ``threefry2x32(key, (hi(i), lo(i)))``, so any slice of a draw can be
    computed alone from its counters (``start``, ``stride``);
  * ``uniform`` reads the top 23 bits as the mantissa of a float in [1, 2),
    minus 1; ``normal`` is ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0),
    1))`` with XLA's f32 ``erf_inv`` polynomial.

``prng_key``, ``fold_in``, ``split``, ``bits`` and ``uniform`` are bit-equal
to ``jax.random``; ``normal`` is within a few f32 ulps (its ``log1p`` is
taken in f64 and rounded once, where XLA has its own f32 approximation).
Every draw is built from integer and IEEE basic float operations, so it is
the same bits on the CPU and on the card.

Keys are two Python ints (uint32 values) or an int64 tensor whose last axis
holds the two words. uint32 arithmetic runs in int64 holding values below
2^32, reduced mod 2^32 after each sum. Draws default to the resolved device
(``device.py``), as every entry point of the port does; callers pass the
device they draw for.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["prng_key", "fold_in", "split", "key_words", "bits", "uniform",
           "normal"]

_M32 = 0xFFFFFFFF
# threefry2x32's rotations (Salmon et al., "Parallel random numbers: as easy
# as 1, 2, 3", SC 2011), taken four rounds at a time, and its key parity
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# host draws are taken in chunks of this many counters, so the int64
# temporaries stay in cache
_HOST_CHUNK = 1 << 18

Key = Union[Tuple[int, int], Sequence[int], torch.Tensor]
Shape = Union[int, Sequence[int]]


def key_words(key: Key) -> Tuple[int, int]:
    """The two uint32 words of one key."""
    if isinstance(key, torch.Tensor):
        if key.numel() != 2:
            raise ValueError(f"one key has 2 words, got shape "
                             f"{tuple(key.shape)}")
        key = key.reshape(2).tolist()
    k0, k1 = key
    return int(k0) & _M32, int(k1) & _M32


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 (20 rounds) of one counter pair, on Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _threefry_(k0: int, k1: int, x0: torch.Tensor,
               x1: torch.Tensor) -> None:
    """threefry2x32 (20 rounds) of the counter pairs ``(x0, x1)``, int64
    tensors holding uint32 values, updated in place."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    tmp = torch.empty_like(x1)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            # rotate left by r: the low word of x1 << r, or its high word
            torch.bitwise_left_shift(x1, r, out=tmp)
            torch.bitwise_right_shift(tmp, 32, out=x1)
            x1.bitwise_or_(tmp.bitwise_and_(_M32))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it (64-bit
    types off): the words ``(0, seed mod 2^32)``."""
    return 0, int(seed) & _M32


def fold_in(key: Key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the key ``threefry2x32(key, (0,
    data mod 2^32))``."""
    k0, k1 = key_words(key)
    return _threefry_int(k0, k1, 0, int(data) & _M32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(d) for d in shape)


def _counters(shape: Tuple[int, ...], start: int, stride, device
              ) -> torch.Tensor:
    """The flat int64 counters of a ``shape`` draw: along the last axis
    ``start + j``, and ``stride`` apart from one index of the leading axes
    to the next (default: the last axis' length, i.e. row-major)."""
    last = shape[-1] if shape else 1
    lead = math.prod(shape[:-1]) if shape else 1
    stride = last if stride is None else int(stride)
    if stride == last:
        return torch.arange(int(start), int(start) + lead * last,
                            dtype=torch.int64, device=device)
    rows = torch.arange(lead, dtype=torch.int64, device=device) * stride
    cols = torch.arange(last, dtype=torch.int64, device=device) + int(start)
    return (rows[:, None] + cols[None, :]).reshape(-1)


def _hash(key: Key, counters: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``threefry2x32(key, (hi, lo))`` of each flat counter: two int64
    tensors of uint32 words."""
    k0, k1 = key_words(key)
    x0 = torch.bitwise_right_shift(counters, 32)
    x1 = counters.bitwise_and(_M32)
    if counters.device.type == "cpu" and counters.numel() > _HOST_CHUNK:
        for a, b in zip(x0.split(_HOST_CHUNK), x1.split(_HOST_CHUNK)):
            _threefry_(k0, k1, a, b)
    else:
        _threefry_(k0, k1, x0, x1)
    return x0, x1


def split(key: Key, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: an int64 ``[*shape, 2]`` tensor of
    keys on the CPU (``num`` an int or a shape)."""
    shape = _shape(num)
    x0, x1 = _hash(key, _counters(shape, 0, None, "cpu"))
    return torch.stack([x0, x1], dim=1).reshape(*shape, 2)


def bits(key: Key, shape: Shape, start: int = 0, device: DeviceLike = None,
         stride=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor of the
    same values. ``start`` offsets the counters along the last axis and
    ``stride`` is the counter distance between consecutive indices of the
    leading axes: a rank holding columns ``[start, start + shape[-1])`` of
    a ``[C, N]`` draw passes ``start`` and ``stride=N`` and gets its slice
    of that one draw."""
    shape = _shape(shape)
    x0, x1 = _hash(key, _counters(shape, start, stride,
                                  resolve_device(device)))
    return x0.bitwise_xor_(x1).reshape(shape)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from uint32 values: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1 (exact)."""
    f = b.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def uniform(key: Key, shape: Shape, start: int = 0,
            device: DeviceLike = None, minval: float = 0.0,
            maxval: float = 1.0, stride=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, or the
    slice of it that ``start`` and ``stride`` name (:func:`bits`)."""
    f = _unit_floats(bits(key, shape, start, device, stride))
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0.0 and hi == 1.0:
        return f
    # XLA fuses jax.random.uniform's ``f * (hi - lo) + lo`` into one
    # multiply-add: the f32 product is exact in f64, so one rounding of
    # the f64 sum gives the fused result
    f = (f.double() * float(np.float32(hi - lo)) + float(lo)).float()
    return torch.clamp_min(f, float(lo))


# XLA's ErfInv32 (xla/client/lib/math.cc; the same constants in
# StableHLO's chlo erf_inv decomposition): M. Giles, "Approximating the
# erfinv function", GPU Computing Gems Jade Edition (2011), single
# precision branch. Highest power first; the first set for w < 5.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
_LN2 = math.log(2.0)
# 1 / (2k + 1), k = 1..8: 2 atanh(s) = 2 s (1 + s^2 / 3 + s^4 / 5 + ...),
# past 1e-13 relative for |s| <= 3 - 2 sqrt(2)
_ATANH = tuple(1.0 / (2 * k + 1) for k in range(8, 0, -1))


def _log1p_f64(y: torch.Tensor) -> torch.Tensor:
    """``log1p(y)`` of f64 ``y`` in (-1, 0] from IEEE basic operations
    only (+, -, *, /, frexp, compares), so it is the same bits on every
    device (a library ``log1p`` differs between the CPU and the card in
    its last bits). ``1 + y = m 2^e`` with ``m`` in [sqrt(1/2),
    sqrt(2)), then ``log1p(y) = e ln 2 + 2 atanh((m - 1) / (m + 1))``;
    where ``e`` is 0, ``m - 1`` is ``y`` itself, so a tiny ``y`` keeps
    its precision."""
    m, e = torch.frexp(1.0 + y)
    low = m < math.sqrt(0.5)
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(torch.float64)
    f = torch.where(e == 0.0, y, m - 1.0)
    s = f / (f + 2.0)
    z = s * s
    p = torch.full_like(z, _ATANH[0])
    for c in _ATANH[1:]:
        p = p * z + c
    return (s * 2.0 + (s * 2.0) * (z * p)) + e * _LN2


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` polynomial. ``w = -log1p(-x^2)`` and its
    square root are taken in f64 and rounded once to f32 (a square root so
    rounded is the correctly rounded f32 one), from IEEE basic operations
    only, so the draw is the same bits on the CPU and the card."""
    xx = x * x
    w = _log1p_f64(-xx.double()).neg_().to(torch.float32)
    lt = w < 5.0
    root = torch.sqrt(w.double()).to(torch.float32)
    w = torch.where(lt, w - 2.5, root - 3.0)
    # both branches' polynomials over every element, then the selection:
    # the f32 multiply-adds of XLA's select-per-coefficient, element for
    # element
    p_lt, p_ge = (torch.full_like(w, float(np.float32(c[0])))
                  for c in (_ERFINV_W_LT_5, _ERFINV_W_GE_5))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p_lt.mul_(w).add_(float(np.float32(a)))
        p_ge.mul_(w).add_(float(np.float32(b)))
    out = torch.where(lt, p_lt, p_ge).mul_(x)
    edge = x.abs() == 1.0
    return torch.where(edge, x * float(np.finfo(np.float32).max), out)


def _normal_flat(key: Key, start: int, n: int, dev) -> torch.Tensor:
    """Counters ``[start, start + n)`` of a normal draw, flat."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, n, start=start, device=dev, minval=float(lo),
                maxval=1.0)
    return _erfinv32(u).mul_(float(np.float32(np.sqrt(2.0))))


def normal(key: Key, shape: Shape, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``(nextafter(-1, 0), 1)``; within a
    few f32 ulps of JAX's draws (:func:`_erfinv32`). Each element depends
    on its counter alone, so the host draws in chunks that stay in
    cache."""
    shape = _shape(shape)
    dev = resolve_device(device)
    n = math.prod(shape)
    if dev.type != "cpu" or n <= _HOST_CHUNK:
        return _normal_flat(key, 0, n, dev).reshape(shape)
    out = torch.empty(n, dtype=torch.float32)
    for a in range(0, n, _HOST_CHUNK):
        b = min(a + _HOST_CHUNK, n)
        out[a:b] = _normal_flat(key, a, b - a, dev)
    return out.reshape(shape)
