"""The fused int8 statistics kernel's contract, on the CPU.

``csrc/quant_stats.cu`` runs only on the card; these tests pin what it must
compute and how it is reached:

  * a NumPy model of its per-element formula (the counter, threefry2x32,
    the uniform, the divide-add-floor-clamp; the blocked mode's murmur
    mix; round to nearest) is bit-equal to the eager chain
    (``growth._quantize_for``) on the CPU, in all three modes, on a rank's
    slice of a data group's draw and past 2^32 counters;
  * a quantized tree's statistics on a CUDA tensor reach the kernel's two
    entry points with the key words, ``start``, ``stride``, ``q_max``, the
    scales and the mode the eager chain uses: ``histogram._launch`` is
    replaced by the model run on the wrapper's own buffers, and the result
    is the eager chain's bits. A CPU tensor keeps the eager chain;
  * each ``gbdt.round`` span records the launches of the kernel and of its
    amax (``stats_launches``, ``stats_amax_launches``).
"""

import ctypes

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import booster as TB
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.observability import metrics, spans
from mmlspark_tpu_torch.ops import histogram as TH

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# --- the kernel's per-element formula, in NumPy uint32 and float32 -------

def _threefry_bits(k0, k1, hi, lo):
    """threefry2x32 (20 rounds) of the counter words ``(hi, lo)``, x0 ^ x1:
    the kernel's ``threefry_bits``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (hi + np.uint32(ks[0])).astype(np.uint32)
    x1 = (lo + np.uint32(ks[1])).astype(np.uint32)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + np.uint32(ks[(i + 1) % 3])
        x1 = x1 + np.uint32((ks[(i + 2) % 3] + i + 1) & M32)
    return x0 ^ x1


def _mix32(v):
    v = (v ^ (v >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    v = (v ^ (v >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return v ^ (v >> np.uint32(16))


def _draws(mode, k0, k1, start, stride, n):
    """[3, n] f32 uniforms of mode 1 (threefry) or 2 (positional)."""
    i = np.arange(n, dtype=np.int64)[None, :]
    c = np.arange(3, dtype=np.int64)[:, None]
    if mode == 1:
        ctr = c * stride + start + i
        b = _threefry_bits(k0, k1, (ctr >> 32).astype(np.uint32),
                           (ctr & M32).astype(np.uint32))
        return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
    idx = ((start + i) & M32).astype(np.uint32)
    x = (idx ^ np.uint32(k0)) + (c.astype(np.uint32) * np.uint32(0x9E3779B9))
    x = _mix32(x ^ np.uint32(k1))
    x = _mix32(x + np.uint32(0x27D4EB2F))
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def model_amax(grad, hess, vm):
    return np.abs(np.stack([grad * vm, hess * vm, vm])).max(axis=1)


def model_scales(amax, q_max):
    return np.where(amax > 0, amax / np.float32(q_max),
                    np.float32(1.0)).astype(np.float32)


def model_quant(grad, hess, vm, scales, k0, k1, start, stride, mode, q_max):
    """``mm_quant_stats``: [3, n] int8 of ``(grad * vm, hess * vm, vm)``."""
    s = np.stack([grad * vm, hess * vm, vm])
    x = s / scales[:, None]
    if mode == 0:
        q = np.rint(x)
    else:
        q = np.floor(x + _draws(mode, k0, k1, start, stride, grad.shape[0]))
    return np.clip(q, -np.float32(q_max), np.float32(q_max)).astype(np.int8)


# --- inputs ----------------------------------------------------------------

class _Rank:
    """A stand-in data group: a rank, a size, and the max over one rank."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce(self, t, op="sum"):
        assert op == "max"
        return t


def _rows(n, seed=0, zero_grad=False):
    rng = np.random.default_rng(seed)
    grad = (np.zeros(n) if zero_grad else rng.normal(size=n)).astype(
        np.float32)
    hess = (np.abs(rng.normal(size=n)) * 0.25).astype(np.float32)
    vm = np.where(rng.uniform(size=n) < 0.85,
                  np.where(rng.uniform(size=n) < 0.2, 2.5, 1.0), 0.0
                  ).astype(np.float32)
    return grad, hess, vm


KEY = TH.quant_key(7, 3, 1)
# (rows, key, group, blocks_local, rows_per_block, n_rows)
CASES = {
    "threefry": (1000, KEY, None, 0, 0, None),
    "threefry_one_row": (1, KEY, None, 0, 0, None),
    "rank_slice": (500, KEY, _Rank(1, 2), 0, 0, 999),
    "past_2_32": (600, KEY, _Rank(3, 4), 0, 0, 3_000_000_000),
    "nearest": (1000, None, None, 0, 0, None),
    "positional": (1000, KEY, None, 4, 250, None),
    "positional_rank": (500, KEY, _Rank(1, 2), 2, 250, None),
    "positional_small_q_max": (800, KEY, None, 4, 20_000_000, None),
    "zero_channel": (700, KEY, None, 0, 0, None),
}


def _mode(case):
    _, key, _, blocks, _, _ = case
    return 0 if key is None else (2 if blocks else 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_is_bit_equal_to_the_eager_chain(name):
    n, key, group, blocks, rpb, n_rows = case = CASES[name]
    grad, hess, vm = _rows(n, seed=len(name), zero_grad=name ==
                           "zero_channel")
    base = torch.from_numpy(np.stack([grad * vm, hess * vm, vm]))
    q, scales = TG._quantize_for(base, key, group, blocks, rpb, n_rows)
    start, stride, q_max = TG._rounding(n, group, blocks, rpb, n_rows)
    assert q_max == TH.quant_q_max(rpb if blocks else n)
    want_scales = model_scales(model_amax(grad, hess, vm), q_max)
    np.testing.assert_array_equal(scales.numpy(), want_scales)
    k0, k1 = key or (0, 0)
    want = model_quant(grad, hess, vm, want_scales, k0, k1, start, stride,
                       _mode(case), q_max)
    np.testing.assert_array_equal(q.numpy(), want)
    if name == "zero_channel":
        assert scales[0] == 1.0 and not q[0].any()
    if name == "positional_small_q_max":
        assert q_max == 107.0 and int(q.abs().max()) == 107


# --- the route a CUDA tensor takes ----------------------------------------

class _CudaTyped(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's tensor does, so the
    route a CUDA tensor takes runs here."""

    @property
    def is_cuda(self):
        return True


def _view(ptr, count, ctype):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _model_launch(calls):
    """``histogram._launch`` run by the model on the wrapper's buffers."""
    def launch(kernel, entry, args, dev):
        vals = [v for _, v in args]
        calls.append((kernel, entry, vals, [t for t, _ in args]))
        if entry == "mm_stats_amax":
            g, h, v, amax, n = vals
            rows = (_view(p, n, ctypes.c_float) for p in (g, h, v))
            _view(amax, 3, ctypes.c_float)[:] = model_amax(*rows)
            return
        assert entry == "mm_quant_stats"
        g, h, v, sc, out, n, k0, k1, start, stride, mode, q_max = vals
        rows = [_view(p, n, ctypes.c_float) for p in (g, h, v)]
        _view(out, 3 * n, ctypes.c_int8)[:] = model_quant(
            *rows, _view(sc, 3, ctypes.c_float), k0, k1, start, stride,
            mode, q_max).reshape(-1)
    return launch


DISPATCH = ["threefry", "rank_slice", "past_2_32", "nearest", "positional",
            "positional_rank"]


@pytest.mark.parametrize("name", DISPATCH)
def test_a_cuda_tensor_reaches_the_kernel_with_the_eager_arguments(
        monkeypatch, name):
    n, key, group, blocks, rpb, n_rows = case = CASES[name]
    cfg = TG.GrowConfig(quantized_grad=True,
                        hist_blocks=blocks * (group.size if group else 1)
                        if blocks else None)
    grad, hess, vm = (torch.from_numpy(a) for a in _rows(n, seed=3))
    want = TG._prepare_stats(grad, hess, vm, cfg, key, group, n_rows)
    calls = []
    monkeypatch.setattr(TH, "_launch", _model_launch(calls))
    launches = TH.quantize_stats.launches
    amax_launches = TH.stats_amax_cuda.launches
    got = TG._prepare_stats(*(t.as_subclass(_CudaTyped)
                              for t in (grad, hess, vm)), cfg, key, group,
                            n_rows)
    assert [(k, e) for k, e, _, _ in calls] == [
        ("quant_stats", "mm_stats_amax"), ("quant_stats", "mm_quant_stats")]
    assert TH.quantize_stats.launches == launches + 1
    assert TH.stats_amax_cuda.launches == amax_launches + 1
    amax_args, quant_args = calls[0][2], calls[1][2]
    assert amax_args[4] == n
    start, stride, q_max = TG._rounding(n, group, blocks, rpb, n_rows)
    k0, k1 = key or (0, 0)
    assert quant_args[5:] == [n, k0, k1, start, stride, _mode(case), q_max]
    types = calls[1][3]
    assert types[5:] == [ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float]
    assert got.base_t.dtype == torch.int8 and got.base_t.shape == (3, n)
    assert torch.equal(got.base_t, want.base_t)
    assert torch.equal(got.qscales, want.qscales)
    assert torch.equal(got.vm, want.vm)
    assert (got.blocks, got.rpb) == (want.blocks, want.rpb)


def test_a_cpu_tensor_keeps_the_eager_chain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route launched a kernel")
    monkeypatch.setattr(TH, "_launch", refuse)
    launches = (TH.quantize_stats.launches, TH.stats_amax_cuda.launches)
    grad, hess, vm = (torch.from_numpy(a) for a in _rows(900, seed=4))
    st = TG._prepare_stats(grad, hess, vm, TG.GrowConfig(quantized_grad=True),
                           KEY)
    q, scales = TG._quantize_for(torch.stack([grad * vm, hess * vm, vm]),
                                 KEY)
    assert torch.equal(st.base_t, q) and torch.equal(st.qscales, scales)
    assert (TH.quantize_stats.launches,
            TH.stats_amax_cuda.launches) == launches


@pytest.mark.parametrize("bad", ["dtype", "strided", "length"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad):
    monkeypatch.setattr(TH, "_launch", _model_launch([]))
    grad, hess, vm = (torch.from_numpy(a) for a in _rows(64))
    if bad == "dtype":
        grad = grad.double()
    elif bad == "strided":
        grad = torch.stack([grad, grad], dim=1)[:, 0]
    else:
        vm = vm[:-1]
    with pytest.raises(ValueError):
        TH.stats_amax_cuda(grad, hess, vm)


def test_a_round_span_records_the_kernel_launches(monkeypatch):
    monkeypatch.setattr(TH, "_launch", _model_launch([]))
    grad, hess, vm = (torch.from_numpy(a).as_subclass(_CudaTyped)
                      for a in _rows(256))
    prev = metrics.set_enabled(True)
    spans.clear_trace()
    try:
        with spans.span("gbdt.round", counters=TB._ROUND_COUNTERS,
                        publish=False):
            TG._prepare_stats(grad, hess, vm,
                              TG.GrowConfig(quantized_grad=True), KEY)
        with spans.span("gbdt.round", counters=TB._ROUND_COUNTERS,
                        publish=False):
            TG._prepare_stats(grad, hess, vm, TG.GrowConfig(), KEY)
        rounds = [e for e in spans.get_trace_events()
                  if e["name"] == "gbdt.round"]
    finally:
        spans.clear_trace()
        metrics.set_enabled(prev)
    assert [r["args"]["stats_launches"] for r in rounds] == [1, 0]
    assert [r["args"]["stats_amax_launches"] for r in rounds] == [1, 0]
