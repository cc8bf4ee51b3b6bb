"""Drive the PyTorch port on one NVIDIA GPU: build, check, train, score.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA GPU must be present; prints its name and power limit.
2. Build: compiles every histogram kernel from ``mmlspark_tpu_torch/csrc``
   with ``nvcc -Xptxas -v`` (one process per source, all started
   together; the compiler's registers, shared memory and spills are
   printed): ``node_hist``, ``node_hist_int8`` and ``hist_bf16``. Then the
   geometry of kernels 1 and 2 at the main path's two passes, and how many
   of its clusters the card holds at once.
3. Kernel 1, ``node_hist`` (bf16 stats), against its plain version on the
   card, at the main path's shapes: F=28, n=1,000,000 (full-width root
   pass) and n=500,000 (the half-width smaller-child buffer), W in
   {1, 8, 16}, B in {255, 63}, and n=499,999 at W=8, B=255 (rows not a
   multiple of the 16-byte vector: misaligned feature rows and a ragged
   tail); bins int32/int16/uint8, some rows at pos -1. The count channel
   must be bit-equal; grad and hess within rtol 1e-4 / atol 1e-4 of the
   channel's largest magnitude (float atomics sum in another order).
   Times, on the device alone (the card spins while the host enqueues the
   timed calls): the kernel's wrapper (its zero-fill and launch), the
   plain version, and one ``index_add_`` over the flattened segment id as
   a library yardstick (timed here only; the port never calls it). At the
   two main-path rows (int32 bins, B=255: n=1,000,000 W=1 and n=500,000
   W=8) the wrapper is also timed with L2 cold: a 256 MB buffer is written
   before each launch, and each launch is timed alone with events.
3b. Kernel 2, ``node_hist_int8`` (int8 stats, int32 sums), against
   ``node_hist_plain(acc_dtype=int32)``: F=28, n=1,000,000 at W=1,
   n=500,000 at W in {8, 15} and n=499,999 at W=8, B in {255, 63} (255
   only at n=499,999), bins int32/uint8, some rows at pos -1.
   ``torch.equal`` is required (integer sums do not depend on order).
   Same times as phase 3, cold at the same two rows; the yardstick on
   int32 values.
3c. Kernel 3, ``hist_bf16``, through ``histogram_cols`` against
   ``hist_plain``, F=28, at the rows of ``COLS_ROWS``: n=1,000,000 with S
   in {1, 2, 3, 5, 48}, B in {63, 255, 4096}, int32, int16 and uint8 bins,
   ``stats_dtype`` bf16 and f32, and misaligned inputs (every array row
   one element past a 16-byte boundary); n=499,999 (a ragged tail) with
   int32, int16 and uint8 bins. Some ids lie at B, outside [0, B). The
   last channel is a count channel and must be bit-equal; every channel
   within 1e-4 of its largest magnitude plus 1e-4. Each row prints its
   geometry, times and % of bound; the main row (S=2, B=255, int32, bf16)
   is also timed cold. Two grids of more (feature group, channel) items
   than 65,535 (``COLS_WIDE``: F=28 x S=10,000, and F=300,000 x S=1 held
   against one ``index_add_``, since ``hist_plain`` loops over features)
   are checked the same way, untimed. Then the path of kernel 3, with its
   count reset just before and read just after: one call of the
   row-major ``histogram`` entry point at the tuner's calibration shape
   (16,384 x 28, S=2).
4. End to end at full width: ``LightGBMClassifier(...).fit`` on 1,000,000 x
   28 synthetic rows (HIGGS's shape, made from a seed with numpy), maxBin
   255, numLeaves 31, 10 boosting rounds, then ``transform`` on a
   200,000-row holdout, in three configurations: 4 the defaults (leafwise,
   bf16 histograms: kernel 1), 4b ``useQuantizedGrad=True`` (kernel 2) and
   4c the same with ``growthPolicy="depthwise"``. 4b and 4c set
   ``quantWarmupIters=0``: with the default two bf16 warmup trees, this
   data hits a defect of the reference (ROADMAP Queue 3): the warmup
   trees' drifted leaves saturate rows to a hessian of 0, a later
   quantized split passes ``minSumHessianInLeaf`` on an f32 cancellation
   residual, and its renewed leaf divides by 0 — infinite leaves and NaN
   margins on some runs. 4d is that default configuration,
   ``useQuantizedGrad=True`` alone (two warmup trees on kernel 1, then
   kernel 2), driven for its kernels and its cuda-vs-cpu agreement, with
   its holdout AUC and per-tree leaves printed but not held to the floor.
   The kernel counts are reset just before each fit and read just after:
   the fit's kernels must have launched and no plain version may have
   run; holdout probabilities must be finite and their AUC clear
   ``AUC_FLOOR`` (4, 4b, 4c); the booster's ``predict_raw`` on cuda and
   on cpu must agree to 1e-5, non-finite margins (4d) exactly.
5. The card against the CPU on a small input: a 20,000-row fit on cuda and
   on cpu must grow identical trees and margins within 1e-5. 5b: the same
   for quantized fits, leafwise and depthwise (the positional rounding
   uniforms and the exact int32 histograms make the int8 trees agree).

The last lines are the kernels' JSON record (each kernel's main-path
row: launches, warm and cold ms, bound, % of bound, plain and
``index_add_`` ms), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.ops import _build
from mmlspark_tpu_torch.ops import histogram as hist_ops
from mmlspark_tpu_torch.ops.histogram_scatter import (hist_plain,
                                                      node_hist_plain)

# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, f32 rate outside the tensor cores, int8 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12
AUC_FLOOR = 0.75
KERNELS = hist_ops.KERNELS


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


_L2_FLUSH = None
# device cycles the card spins per call it is to run before the timed
# calls: longer than the host takes to enqueue one call (a wrapper call is
# tens of microseconds of Python), so the events time the device alone
_SPIN_CYCLES_PER_CALL = 1_000_000


def _queue_ahead(calls: int) -> None:
    """Keep the card busy while the host enqueues ``calls`` calls: without
    it a call shorter than its own host overhead leaves the card idle
    between launches, and the events would time the host."""
    torch.cuda._sleep(calls * _SPIN_CYCLES_PER_CALL)


def time_cold_ms(fn, reps: int = 10) -> float:
    """Mean device ms of ``fn`` with L2 cold: a 256 MB buffer (five times
    the 50 MB L2) is written before each call, and each call is timed alone
    between two events."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for i in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        _queue_ahead(1)
        _L2_FLUSH.fill_(float(i))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, enqueued
    while the card is busy (``_queue_ahead``)."""
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _queue_ahead(reps)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def hist_inputs(gen, n, F, W, B):
    binned = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    pos = torch.randint(-1, W, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    grad = torch.randn(n, generator=gen, device="cuda")
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.95).float()
    base = torch.stack([grad * mask, grad.abs() * 0.25 * mask, mask])
    return binned, pos, base.contiguous()


def bound_ms(nbytes: int, ops: float, peak_ops: float) -> tuple:
    """Least time for the work: ``nbytes`` (each input read once, each
    output written once) at the memory rate against ``ops`` at
    ``peak_ops``; the larger one, and which it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def node_bound_ms(binned, pos, base, W, B) -> tuple:
    """Kernels 1 and 2: bins, pos and the stats (f32 or int8) read, the
    4-byte output cells written, against 3 adds per (valid row, feature)
    at the f32 or the int8 rate."""
    F, n = binned.shape
    nbytes = (binned.numel() * binned.element_size() + pos.numel() * 4
              + base.numel() * base.element_size() + F * 3 * W * B * 4)
    valid_rows = int((pos >= 0).sum())
    peak = (PEAK_INT8_OPS_PER_S if base.dtype == torch.int8
            else PEAK_F32_OPS_PER_S)
    return bound_ms(nbytes, 3.0 * F * valid_rows, peak)


def cols_bound_ms(binned, stats, B) -> tuple:
    """Kernel 3: bins and f32 stats read, the f32 output written, against
    S f32 adds per (row, feature)."""
    F, n = binned.shape
    S = stats.shape[0]
    nbytes = (binned.numel() * binned.element_size() + 4 * S * n
              + F * S * B * 4)
    return bound_ms(nbytes, float(S) * F * n, PEAK_F32_OPS_PER_S)


def library_index_add(binned, pos, base, W, B):
    """The yardstick: one ``index_add_`` over the flattened segment id
    ``f*(W*B+1) + pos*B + bin`` (overflow segment for pos -1), inputs
    prepared outside the timed call. f32 stats are rounded to bf16 first;
    int8 stats are summed as int32."""
    F, n = binned.shape
    seg_len = W * B + 1
    valid = pos >= 0
    node_off = torch.where(valid, pos.long() * B,
                           torch.full_like(pos, W * B, dtype=torch.long))
    seg = torch.where(valid[None, :], node_off[None, :] + binned.long(),
                      node_off[None, :])
    seg = (seg + torch.arange(F, device="cuda")[:, None] * seg_len).reshape(-1)
    if base.dtype == torch.int8:
        data = base.to(torch.int32).t().contiguous()             # [n, 3]
    else:
        data = base.to(torch.bfloat16).float().t().contiguous()
    data = data[None].expand(F, n, 3).reshape(F * n, 3).contiguous()
    out = torch.zeros(F * seg_len, 3, device="cuda", dtype=data.dtype)

    def call():
        out.zero_()
        out.index_add_(0, seg, data)
    return call


def cols_segments(binned, stats, B, stats_dtype):
    """The flattened segment id ``f*(B+1) + bin`` of every (feature, row)
    (overflow segment for ids outside [0, B)) and each one's rounded
    stats, ``[F*n, S]``."""
    F, n = binned.shape
    b = binned.long()
    seg = torch.where((b >= 0) & (b < B), b, B)
    seg = (seg + torch.arange(F, device="cuda")[:, None] * (B + 1)
           ).reshape(-1)
    data = stats.to(stats_dtype).float().t().contiguous()        # [n, S]
    data = data[None].expand(F, n, data.shape[1]).reshape(F * n, -1)
    return seg, data.contiguous()


def library_cols_index_add(binned, stats, B, stats_dtype=torch.bfloat16):
    """The yardstick of kernel 3: one ``index_add_`` of the rounded stats
    over :func:`cols_segments`'s segment ids."""
    seg, data = cols_segments(binned, stats, B, stats_dtype)
    out = torch.zeros(binned.shape[0] * (B + 1), data.shape[1],
                      device="cuda")

    def call():
        out.zero_()
        out.index_add_(0, seg, data)
    return call


def margin_diff(a, b) -> float:
    """Largest |a - b| over the finite margins; a non-finite margin (an
    infinite leaf reached) must be the same value, or NaN, on both sides,
    else the difference is infinite."""
    fin = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(a[~fin], b[~fin], equal_nan=True):
        return float("inf")
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def check_within(got, want, what) -> None:
    """``got`` within 1e-4 of ``want``'s largest magnitude, plus 1e-4."""
    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max()) + 1e-4
    if err > lim:
        raise AssertionError(f"{what}: max error {err} > {lim}")


def check_hist(got, want) -> float:
    """Count channel bit-equal; grad/hess within 1e-4 relative to the
    channel's largest magnitude (plus 1e-4). Returns the max abs error."""
    if not torch.equal(got[:, 2::3], want[:, 2::3]):
        raise AssertionError("count channel differs from the plain version")
    for s in (0, 1):
        check_within(got[:, s::3], want[:, s::3], f"stat {s}")
    return float((got - want).abs().max())


# the two main-path rows of kernels 1 and 2: the root pass and the
# half-width smaller-child pass, int32 bins, 255 bins
MAIN_ROWS = ((1_000_000, 1, 255, "int32"), (500_000, 8, 255, "int32"))


def log_geometry():
    """The geometry of kernels 1 and 2 at the main-path rows, beside the
    clusters the card holds at once."""
    dev = torch.cuda.current_device()
    for kernel in ("node_hist", "node_hist_int8"):
        for n, W, B, _ in MAIN_ROWS:
            geo = hist_ops._geometry_on(kernel, dev, n, 28, W, B, 4)
            held = hist_ops._clusters_held(kernel, dev, 4, geo.smem,
                                           geo.cluster)
            blocks = geo.row_blocks * geo.groups * geo.tiles
            log(f"{kernel} n={n} W={W} B={B}: {geo}; grid {blocks} blocks "
                f"in clusters of {geo.cluster}; the card holds {held} such "
                f"clusters ({held * geo.cluster} blocks) at once, "
                f"{hist_ops._num_sms_of(dev)} SMs")


def node_row(call, plain, binned, pos, base, W, B, cold: bool) -> dict:
    """Times of one kernel shape: the wrapper (warm; cold too where
    asked), the plain version, the ``index_add_`` yardstick, the bound."""
    ms = time_ms(call, reps=20)
    ms_cold = time_cold_ms(call) if cold else None
    plain_ms = time_ms(plain, reps=3, warm=1)
    lib = time_ms(library_index_add(binned, pos, base, W, B), reps=5, warm=1)
    bound, by = node_bound_ms(binned, pos, base, W, B)
    return dict(ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bound, bound_by=by)


def log_row(name, key, r, check):
    cold = "" if r["ms_cold"] is None else f" (L2 cold {r['ms_cold']:.4f})"
    log(f"{name} n={key[0]} W={key[1]} B={key[2]} {key[3]}: kernel "
        f"{r['ms']:.4f} ms{cold}  bound {r['bound_ms'] * 1e3:.1f} us "
        f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%)  plain "
        f"{r['plain_ms']:.3f} ms  index_add_ {r['library_ms']:.3f} ms  "
        f"{check}")


def phase_kernels():
    log("== phase 3: node_hist kernel vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    F = 28
    shapes = [(n, W, B) for n in (1_000_000, 500_000) for B in (255, 63)
              for W in (1, 8, 16)] + [(499_999, 8, 255)]
    rows, max_err = {}, 0.0
    for n, W, B in shapes:
        binned32, pos, base = hist_inputs(gen, n, F, W, B)
        for dt in (torch.int32, torch.int16, torch.uint8):
            binned = binned32.to(dt)
            want = node_hist_plain(binned, pos, base, W, B)
            got = hist_ops.node_histogram(binned, pos, base, W, B)
            torch.cuda.synchronize()
            err = check_hist(got, want)
            max_err = max(max_err, err)
            key = (n, W, B, str(dt).replace("torch.", ""))
            r = node_row(
                lambda: hist_ops.node_histogram(binned, pos, base, W, B),
                lambda: node_hist_plain(binned, pos, base, W, B),
                binned, pos, base, W, B, cold=key in MAIN_ROWS)
            rows[key] = dict(r, max_abs_err=err)
            log_row("node_hist", key, r, f"max_abs_err {err:.3g}")
            del binned, want, got
        del binned32, pos, base
    return rows, max_err


def phase_int8_kernel():
    log("== phase 3b: node_hist_int8 kernel vs plain version (int32 sums)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    F = 28
    shapes = [(n, W, B) for B in (255, 63)
              for n, W in ((1_000_000, 1), (500_000, 8), (500_000, 15))
              ] + [(499_999, 8, 255)]
    rows, max_err = {}, 0.0
    for n, W, B in shapes:
        binned32, pos, base_f = hist_inputs(gen, n, F, W, B)
        base, _ = hist_ops.quantize_stats(base_f)
        for dt in (torch.int32, torch.uint8):
            binned = binned32.to(dt)
            want = node_hist_plain(binned, pos, base, W, B,
                                   acc_dtype=torch.int32)
            got = hist_ops._node_hist_int8_cuda(binned, pos, base, W, B)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"node_hist_int8 n={n} W={W} B={B} {dt}: not bit-equal "
                    "to the plain version")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            key = (n, W, B, str(dt).replace("torch.", ""))
            r = node_row(
                lambda: hist_ops._node_hist_int8_cuda(binned, pos, base, W,
                                                      B),
                lambda: node_hist_plain(binned, pos, base, W, B,
                                        acc_dtype=torch.int32),
                binned, pos, base, W, B, cold=key in MAIN_ROWS)
            rows[key] = dict(r, max_abs_err=err)
            log_row("node_hist_int8", key, r, "bit-equal")
            del binned, want, got
        del binned32, pos, base, base_f
    return rows, max_err


# phase 3c rows of kernel 3, F=28: (n, S, B, bins, stats_dtype, layout).
# The first is the main row: the tuner's S=2 at full width, 255 bins.
COLS_MAIN = (1_000_000, 2, 255, "int32", "bf16", "aligned")
COLS_ROWS = (
    COLS_MAIN,
    (1_000_000, 3, 255, "int32", "bf16", "aligned"),
    (1_000_000, 2, 63, "int32", "bf16", "aligned"),
    (1_000_000, 3, 63, "int32", "bf16", "aligned"),
    (1_000_000, 1, 255, "int32", "bf16", "aligned"),
    (1_000_000, 5, 255, "int32", "bf16", "aligned"),
    (1_000_000, 48, 255, "int32", "bf16", "aligned"),
    (1_000_000, 2, 255, "int16", "bf16", "aligned"),
    (1_000_000, 2, 255, "uint8", "bf16", "aligned"),
    (1_000_000, 2, 4096, "int32", "bf16", "aligned"),
    (1_000_000, 3, 4096, "int16", "bf16", "aligned"),
    (1_000_000, 2, 255, "int32", "f32", "aligned"),
    (1_000_000, 2, 255, "int32", "bf16", "misaligned"),
    (499_999, 2, 255, "int32", "bf16", "aligned"),
    (499_999, 3, 63, "int16", "bf16", "aligned"),
    (499_999, 5, 255, "uint8", "f32", "misaligned"),
)
COLS_F = 28
# grids of more (feature group, channel) items than a grid's y extent
# (65,535) holds: (n, F, S, B, bins). F=28 x S=10,000 (7 groups of 4 x
# 10,000 channels), and F=300,000 x S=1 (75,000 groups of 4)
COLS_WIDE = ((20_000, 28, 10_000, 255, "int32"),
             (256, 300_000, 1, 63, "uint8"))
STATS_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary, so every array row takes scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def cols_inputs(gen, row):
    """Bins (some ids at B, outside [0, B)) and [S, n] f32 stats for a
    phase-3c row; the last channel is a count channel of 0s and 1s."""
    n, S, B, bins, _, layout = row
    binned = torch.randint(0, B, (COLS_F, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    binned[0, ::97] = B
    binned = binned.to(getattr(torch, bins))
    stats = torch.randn(S, n, generator=gen, device="cuda")
    stats[-1] = (stats[-1] > -1.5).float()
    if layout == "misaligned":
        binned, stats = misaligned(binned), misaligned(stats)
    return binned, stats


def check_cols(got, want, what) -> float:
    """The count channel (the last) bit-equal, every channel within
    ``check_within``. Returns the max abs error."""
    if not torch.equal(got[:, -1], want[:, -1]):
        raise AssertionError(f"{what}: count channel differs from the plain "
                             "version")
    for s in range(got.shape[1]):
        check_within(got[:, s], want[:, s], f"{what} channel {s}")
    return float((got - want).abs().max())


def cols_key(row) -> str:
    n, S, B, bins, sd, layout = row
    return f"n={n} S={S} B={B} {bins} {sd} {layout}"


def phase_cols_kernel():
    log("== phase 3c: hist_bf16 kernel (histogram_cols) vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(2468)
    dev = torch.cuda.current_device()
    rows, max_err = {}, 0.0
    for row in COLS_ROWS:
        n, S, B, bins, sd, _ = row
        binned, stats = cols_inputs(gen, row)
        stats_dtype = STATS_DTYPES[sd]
        want = hist_plain(binned, stats, B, stats_dtype)
        got = hist_ops.histogram_cols(binned, stats, B, stats_dtype)
        torch.cuda.synchronize()
        err = check_cols(got, want, f"hist_bf16 {cols_key(row)}")
        max_err = max(max_err, err)
        geo = hist_ops._cols_geometry_on(dev, n, COLS_F, S, B,
                                         binned.element_size(),
                                         stats_dtype == torch.bfloat16)
        ms = time_ms(lambda: hist_ops.histogram_cols(binned, stats, B,
                                                     stats_dtype), reps=20)
        plain = time_ms(lambda: hist_plain(binned, stats, B, stats_dtype),
                        reps=3, warm=1)
        lib = (time_ms(library_cols_index_add(binned, stats, B, stats_dtype),
                       reps=5, warm=1) if S <= 5 else None)
        ms_cold = (time_cold_ms(lambda: hist_ops.histogram_cols(
            binned, stats, B, stats_dtype)) if row == COLS_MAIN else None)
        bound, by = cols_bound_ms(binned, stats, B)
        rows[row] = dict(ms=ms, ms_cold=ms_cold, plain_ms=plain,
                         library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err)
        cold = "" if ms_cold is None else f" (L2 cold {ms_cold:.4f})"
        libs = "not run" if lib is None else f"{lib:.3f} ms"
        log(f"hist_bf16 {cols_key(row)}: kernel {ms:.4f} ms{cold}  bound "
            f"{bound * 1e3:.1f} us ({by}, {100 * bound / ms:.1f}%)  plain "
            f"{plain:.3f} ms  index_add_ {libs}  max_abs_err {err:.3g}  "
            f"[group {geo.group} x {geo.groups}, {geo.tiles} channels, "
            f"{geo.reps} copies of each cell, {geo.row_blocks} row blocks of "
            f"{geo.threads} threads in clusters of {geo.cluster}]")
        del binned, stats, want, got

    for n, F, S, B, bins in COLS_WIDE:
        binned = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                               dtype=torch.int32).to(getattr(torch, bins))
        stats = torch.randn(S, n, generator=gen, device="cuda")
        stats[-1] = (stats[-1] > -1.5).float()
        got = hist_ops.histogram_cols(binned, stats, B)
        if F <= COLS_F:
            want = hist_plain(binned, stats, B)
        else:   # hist_plain's loop over 300,000 features: one index_add_
            seg, data = cols_segments(binned, stats, B, torch.bfloat16)
            want = torch.zeros(F * (B + 1), S, device="cuda").index_add_(
                0, seg, data).view(F, B + 1, S)[:, :B].permute(0, 2, 1)
        torch.cuda.synchronize()
        what = f"hist_bf16 wide grid n={n} F={F} S={S} B={B} {bins}"
        max_err = max(max_err, check_cols(got, want, what))
        geo = hist_ops._cols_geometry_on(dev, n, F, S, B,
                                         binned.element_size(), True)
        log(f"{what}: matches ({geo.row_blocks * geo.groups * geo.tiles} "
            f"blocks: {geo.row_blocks} row blocks x {geo.groups} groups x "
            f"{geo.tiles} channels)")
        del binned, stats, got, want

    # the path of kernel 3: the row-major entry point at the tuner's
    # calibration shape, counted on its own
    rng = np.random.default_rng(11)
    Xb = torch.from_numpy(rng.integers(0, 255, size=(16_384, 28)).astype(
        np.int32)).cuda()
    st = torch.from_numpy(rng.normal(size=(16_384, 2)).astype(
        np.float32)).cuda()
    torch.cuda.synchronize()
    reset_counts()
    got = hist_ops.histogram(Xb, st, 255)
    torch.cuda.synchronize()
    launches = hist_ops.histogram_cols.launches
    plain_calls = node_hist_plain.calls + hist_plain.calls
    want = hist_plain(Xb.t().contiguous(), st.t().contiguous(), 255)
    for s in range(2):
        check_within(got[:, s], want[:, s], f"histogram (row-major) stat {s}")
    log(f"histogram 16384 x 28, S=2: hist_bf16 launches {launches}, plain "
        f"calls {plain_calls}; geometry "
        f"{hist_ops._cols_geometry_on(dev, 16_384, 28, 2, 255, 4, True)}")
    if launches <= 0 or plain_calls != 0:
        raise AssertionError("the row-major histogram did not go through "
                             "hist_bf16 alone")
    return rows, max_err, launches


def reset_counts():
    """Zero every kernel's launch count and every plain version's call
    count."""
    hist_ops.node_histogram.launches = 0
    hist_ops.node_histogram.int8_launches = 0
    hist_ops.histogram_cols.launches = 0
    node_hist_plain.calls = 0
    hist_plain.calls = 0


def read_counts() -> dict:
    return dict(node_hist_bf16=hist_ops.node_histogram.launches,
                node_hist_int8=hist_ops.node_histogram.int8_launches,
                hist_bf16=hist_ops.histogram_cols.launches,
                plain=node_hist_plain.calls + hist_plain.calls)


def auc(y, s) -> float:
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ranks over ties
    _, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    ranks = (np.bincount(inv, ranks) / cnt)[inv]
    pos = y > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def higgs_shaped(n, seed):
    """Synthetic rows of HIGGS's shape (28 float features, binary label):
    a fixed random signal with interactions, labels drawn through a
    sigmoid — learnable, not separable."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=10).astype(np.float32)
    z = (X[:, :10] @ w * 0.4 + np.sin(2 * X[:, 10]) + X[:, 11] * X[:, 12]
         - 0.5 * np.abs(X[:, 13]))
    p = 1.0 / (1.0 + np.exp(-1.5 * z))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def phase_end_to_end(label, needs, data, check_quality=True, **params):
    """One fit -> transform at full width; ``needs`` lists the kernels the
    fit must launch. ``check_quality=False`` (phase 4d) reports the
    holdout's non-finite rows and AUC without holding them to the floor.
    Returns the counts, times, AUC and largest |leaf|."""
    log(f"== phase {label}: LightGBMClassifier({params}) fit -> transform, "
        "1M x 28 x 255")
    X, y, Xh, yh = data
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device="cuda", **params)
    train = Dataset({"features": X, "label": y})
    hold = Dataset({"features": Xh, "label": yh})
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(hold)
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"fit {fit_s:.3f} s ({10 / fit_s:.3f} trees/s), transform "
        f"{pred_s:.3f} s ({len(yh) / pred_s:.0f} rows/s); launches "
        f"{counts}")
    for k in needs:
        if counts[k] <= 0:
            raise AssertionError(f"the main path never launched {k}")
    if counts["plain"] != 0:
        raise AssertionError(f"a plain histogram ran {counts['plain']} times "
                             "on the main path")
    probs = out.array("probability")
    if probs.shape != (len(yh), 2):
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    finite = np.isfinite(probs).all(axis=1)
    a = auc(yh[finite], probs[finite, 1])
    log(f"holdout AUC {a:.5f} over {int(finite.sum())} rows with finite "
        f"probabilities of {len(yh)} (floor {AUC_FLOOR})")
    if check_quality and not finite.all():
        raise AssertionError(f"{int((~finite).sum())} rows have non-finite "
                             "probabilities")
    if check_quality and a <= AUC_FLOOR:
        raise AssertionError(f"holdout AUC {a} <= {AUC_FLOOR}")
    booster = model.booster
    diff = margin_diff(booster.predict_raw(Xh, device="cuda"),
                       booster.predict_raw(Xh, device="cpu"))
    log(f"predict_raw cuda vs cpu: max abs diff {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"predict_raw cuda vs cpu differ by {diff}")
    t = booster.trees
    lv = np.where(t["is_leaf"], t["leaf_value"], 0.0)
    leaf = float(np.abs(lv).max())
    log(f"largest |leaf value| {leaf:.4g}")
    live = t["is_leaf"] & (t["node_cnt"] > 0)
    log("per tree: max |leaf| " + " ".join(
        f"{v:.4g}" for v in np.abs(lv).max(axis=1)) + "; non-finite leaves "
        + " ".join(str(int(v)) for v in (~np.isfinite(lv)).sum(axis=1))
        + "; least leaf hessian " + " ".join(
            f"{v:.4g}" for v in np.where(live, t["node_hess"],
                                         np.inf).min(axis=1)))
    return dict(counts=counts, fit_s=fit_s, trees_per_s=10 / fit_s,
                predict_rows_per_s=len(yh) / pred_s, auc=a, max_leaf=leaf)


def phase_small_agreement(label, **params):
    """The card against the CPU on a small input: the same fit on cuda
    (the kernels) and on cpu (the plain versions) grows the same trees and
    predicts the same margins. Leaves are kept at 500+ rows so the f32
    parent-minus-left totals, summed in another order on each device, move
    no leaf value past the 1e-5 tolerance."""
    log(f"== phase {label}: small fit on cuda vs cpu {params}")
    X, y = higgs_shaped(20_000, seed=2)
    kw = dict(numIterations=3, numLeaves=7, minDataInLeaf=500, maxBin=255)
    kw.update(params)
    boosters = {}
    for dev in ("cuda", "cpu"):
        boosters[dev] = LightGBMClassifier(device=dev, **kw).fit(
            Dataset({"features": X, "label": y})).booster
    g, c = boosters["cuda"], boosters["cpu"]
    for f in ("feat", "thr_bin", "left", "right", "is_leaf"):
        if not np.array_equal(g.trees[f], c.trees[f]):
            raise AssertionError(f"tree field {f} differs between cuda and "
                                 "cpu fits")
    diff = margin_diff(g.predict_raw(X, device="cpu"),
                       c.predict_raw(X, device="cpu"))
    log(f"same structure; margins differ by {diff:.3g} at most")
    if not diff <= 1e-5:
        raise AssertionError(f"cuda and cpu fits differ by {diff}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is available")
    card = card_line()
    log(f"== phase 1: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 2: build " + ", ".join(KERNELS))
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS, verbose=True)
    for name in KERNELS:
        _build.load(name)
    log(f"built {libs} in {time.perf_counter() - t0:.2f} s")
    log_geometry()

    rows, max_err = phase_kernels()
    rows8, max_err8 = phase_int8_kernel()
    rows3, max_err3, launches3 = phase_cols_kernel()
    X, y = higgs_shaped(1_000_000, seed=0)
    Xh, yh = higgs_shaped(200_000, seed=1)
    data = (X, y, Xh, yh)
    fits = {
        "4": phase_end_to_end("4", ["node_hist_bf16"], data),
        "4b": phase_end_to_end("4b", ["node_hist_int8"], data,
                               useQuantizedGrad=True, quantWarmupIters=0),
        "4c": phase_end_to_end("4c", ["node_hist_int8"], data,
                               useQuantizedGrad=True, quantWarmupIters=0,
                               growthPolicy="depthwise"),
        "4d": phase_end_to_end("4d", ["node_hist_bf16", "node_hist_int8"],
                               data, check_quality=False,
                               useQuantizedGrad=True),
    }
    phase_small_agreement("5")
    for policy in ("leafwise", "depthwise"):
        phase_small_agreement("5b", numIterations=4, quantWarmupIters=1,
                              useQuantizedGrad=True, growthPolicy=policy)
    log("fits: " + json.dumps(fits))

    def launches(kernel):
        return sum(f["counts"][kernel] for f in fits.values())

    def entry(name, source, replaces, n_launch, err, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": r["ms"], "ms_cold": r["ms_cold"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "pct_of_bound": 100.0 * r["bound_ms"] / r["ms"],
                "library_ms": r["library_ms"]}

    # each kernel's record carries its most frequent main-path shape: the
    # half-width smaller-child pass (W = leafBatch = 8) over int32 bins at
    # 255 bins for the node kernels, the full-width S=2 pass for kernel 3
    record = {"kernels": [
        entry("node_hist_bf16", "mmlspark_tpu_torch/csrc/node_hist.cu",
              "mmlspark_tpu/ops/histogram.py:679", launches("node_hist_bf16"),
              max_err, rows[(500_000, 8, 255, "int32")]),
        entry("node_hist_int8", "mmlspark_tpu_torch/csrc/node_hist_int8.cu",
              "mmlspark_tpu/ops/histogram.py:679",
              launches("node_hist_int8"), max_err8,
              rows8[(500_000, 8, 255, "int32")]),
        entry("hist_bf16", "mmlspark_tpu_torch/csrc/hist_bf16.cu",
              "mmlspark_tpu/ops/histogram.py:647", launches3, max_err3,
              rows3[COLS_MAIN]),
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
