"""GBDT gradient histograms: the wrappers of the port's histogram kernels,
and the int8 quantization of gradient stats.

Counterpart of ``mmlspark_tpu/ops/histogram.py``. The JAX package picks
between three engines (a Pallas TPU kernel, a one-hot matmul and a scatter);
the port has one rule, decided by where the tensors live:

  * a CPU tensor goes to the plain version in :mod:`.histogram_scatter`;
  * a CUDA tensor goes to a hand-written Hopper kernel — or the call
    raises. There is no fallback from a kernel to the plain version.

The kernels (``KERNELS``, sources in ``csrc/``):

  * ``node_hist`` — :func:`node_histogram` over f32 stats (rounded to bf16,
    summed in f32); launches counted in ``node_histogram.launches``;
  * ``node_hist_int8`` — :func:`node_histogram` with ``scales=`` over int8
    stats (exact int32 sums, dequantized here); launches counted in
    ``node_histogram.int8_launches``;
  * ``hist_bf16`` — :func:`histogram_cols` / :func:`histogram`, the unfused
    ``[F, S, B]`` histogram; launches counted in ``histogram_cols.launches``.

Layout matches the JAX package: ``binned_t`` is column-major ``[F, n]``,
node stats are ``[3, n]`` and a node histogram is ``out[f, w*3 + s, b]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _build
from .histogram_scatter import hist_plain, node_hist_plain

KERNELS = ("node_hist", "node_hist_int8", "hist_bf16")
_ENTRIES = {"node_hist": "mm_node_hist_bf16",
            "node_hist_int8": "mm_node_hist_int8",
            "hist_bf16": "mm_hist_bf16"}
_BIN_BYTES = {torch.int32: 4, torch.int16: 2, torch.uint8: 1}
_SMEM_MAX = 232448          # the kernels' per-block shared-memory ceiling
_SM_SMEM = 233472           # shared memory of one Hopper SM (228 KB)
_BLOCK_RESERVE = 1024       # shared memory the runtime reserves per block
_NODE_THREADS = 512         # node_hist_common.cuh: kThreads
_NODE_BLOCKS_PER_SM = 2     # node_hist_common.cuh: kMinBlocks
# kernel 3's bytes of cell copies per (feature, channel): see _cols_reps
_COLS_REP_BYTES = 16 * 1024
# kernel 3's feature groups: at most the unroll of the body's feature loop
# (4), whose bin loads a block then issues together; in the feature-group
# sweeps of tools/ab_node_hist.py on an H100 (F=28) groups of 4 beat 2, 7,
# 14 and 28 at every row measured. Below the cap, _ROW_COST weighs cells
# against row loads as for kernels 1 and 2
_COLS_MAX_GROUP = 4
# a row's pos and stats load against one histogram cell's clear, cluster
# sum and flush: fitted to the feature-group sweeps of tools/ab_node_hist.py
# on an H100 (F=28, B=255), whose fastest groups were 7 features at the
# root pass (n=1,000,000, W=1), 2 at n=500,000 W=8 and 2 (not 1) at W=15
# and 16; every cost in (0.46, 0.71) picks those
_ROW_COST = 0.6
_MAX_BLOCKS = 2 ** 31 - 1   # the most blocks of a one-dimensional grid
_M32 = 0xFFFFFFFF
_STATS_DTYPES = (torch.bfloat16, torch.float32)


def quant_q_max(rows: int) -> float:
    """The int8 quantization target for ``rows`` accumulated stats: shrinks
    below 127 once a histogram cell could overflow the int32 accumulator
    (``q_max * rows`` must stay under 2^31). Mirrors
    ``mmlspark_tpu/ops/histogram.py:quant_q_max``."""
    return float(max(1, min(127, (2 ** 31 - 1) // max(int(rows), 1))))


def quantize_stats(base_t: torch.Tensor, *,
                   amax: Optional[torch.Tensor] = None,
                   q_max: Optional[float] = None,
                   u: Optional[torch.Tensor] = None):
    """Per-channel symmetric int8 quantization of ``[S, n]`` stats
    (LightGBM use_quantized_grad): stochastic rounding ``floor(x + u)``
    with uniforms ``u`` in [0, 1) (from :func:`positional_uniform`),
    round-to-nearest without. Returns (int8 stats [S, n], f32 scales [S]).
    Mirrors ``mmlspark_tpu/ops/histogram.py:quantize_stats``."""
    n = base_t.shape[1]
    if q_max is None:
        q_max = quant_q_max(n)
    if amax is None:
        amax = base_t.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / q_max, torch.ones_like(amax))
    x = base_t / scales[:, None]
    q = torch.floor(x + u) if u is not None else torch.round(x)
    return q.clamp(-q_max, q_max).to(torch.int8), scales


def _mul32(v, c: int):
    """``v * c mod 2^32`` for ``v`` below 2^32, on Python ints or int64
    tensors, in 16-bit halves of ``c`` so no int64 product overflows."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(v):
    """murmur3's 32-bit finalizer, on Python ints or int64 tensors holding
    values below 2^32."""
    v = _mul32(v ^ (v >> 16), 0x85EBCA6B)
    v = _mul32(v ^ (v >> 13), 0xC2B2AE35)
    return v ^ (v >> 16)


def quant_key(seed: int, iteration: int, klass: int = 0) -> Tuple[int, int]:
    """The two uint32 key words of one tree's stochastic rounding, derived
    from (seed, boosting iteration, class). The port's stand-in for the JAX
    package's ``jax.random.fold_in(fold_in(key, it), 13 + k)``: its words
    differ, and plain ints need no device and no host round-trip."""
    k0 = _mix32((int(seed) & _M32) ^ 0x9E3779B9)
    k0 = _mix32((k0 + _mul32(int(iteration) & _M32, 0x85EBCA6B)) & _M32)
    k1 = _mix32(k0 ^ _mul32(13 + int(klass), 0xC2B2AE35))
    return k0, k1


def positional_uniform(qkey: Tuple[int, int], channels: int, n: int,
                       device=None) -> torch.Tensor:
    """``[channels, n]`` f32 uniforms in [0, 1) that depend only on the key
    and each row's index: the port's one source of stochastic-rounding
    draws. A port of ``mmlspark_tpu/models/gbdt/growth.py:
    _positional_uniform`` (one device, so the global row index is the local
    one) with uint32 arithmetic done in int64 and reduced mod 2^32: for
    the key words ``(k0, k1)`` it reproduces the JAX function's draws bit
    for bit, and the same key gives the same draws on every device."""
    k0, k1 = (int(k) & _M32 for k in qkey)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ch = torch.arange(channels, dtype=torch.int64, device=device)[:, None]
    x = ((idx[None, :] ^ k0) + _mul32(ch, 0x9E3779B9)) & _M32
    x = _mix32(x ^ k1)
    x = _mix32((x + 0x27D4EB2F) & _M32)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _check_inputs(binned_t: torch.Tensor, **tensors: torch.Tensor) -> None:
    """The checks every kernel wrapper makes: narrow-or-int32 bins, and all
    tensors contiguous on one device."""
    if binned_t.dtype not in _BIN_BYTES:
        raise TypeError(f"binned_t must be int32, int16 or uint8, got "
                        f"{binned_t.dtype}")
    for name, t in dict(binned_t=binned_t, **tensors).items():
        if t.device != binned_t.device:
            raise ValueError(f"{name} is on {t.device}, binned_t on "
                             f"{binned_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, entry: str, args: list, dev: torch.device) -> None:
    """Call ``entry`` of ``csrc/<kernel>.cu`` on ``dev``'s current stream;
    ``args`` are (ctypes type, value) pairs before the stream. Raises if
    the library reports a CUDA error."""
    lib = _build.load(kernel)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [t for t, _ in args] + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*(v for _, v in args), stream)
    _build.check(lib, code, f"{entry} launch")


def node_histogram(binned_t: torch.Tensor, row_pos: torch.Tensor,
                   base_t: torch.Tensor, num_nodes: int, num_bins: int,
                   scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frontier-node histograms in one pass: ``[F, 3W, B]`` f32.

    binned_t: [F, n] int32/int16/uint8; row_pos: [n] int32 in [-1, W) (-1:
    the row is at a finished leaf and contributes nothing); base_t: [3, n]
    f32 (grad*mask, hess*mask, mask), rounded to bf16 and summed in f32.
    ``out[f, w*3 + s, b]`` is stat ``s`` of frontier node ``w``.

    ``scales`` ([3] f32, with int8 ``base_t`` from :func:`quantize_stats`)
    selects the quantized-gradient histogram: the int8 stats are summed
    exactly in int32 and dequantized on return, ``out * scales[s]``.
    """
    dev = binned_t.device
    W, B = int(num_nodes), int(num_bins)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"node_histogram: unsupported device {dev}")
    if scales is None:
        if dev.type == "cpu":
            return node_hist_plain(binned_t, row_pos, base_t, W, B)
        return _node_hist_cuda(binned_t, row_pos, base_t, W, B)
    if dev.type == "cpu":
        out = node_hist_plain(binned_t, row_pos, base_t, W, B,
                              acc_dtype=torch.int32)
    else:
        out = _node_hist_int8_cuda(binned_t, row_pos, base_t, W, B)
    chan_scale = scales[torch.arange(3 * W, device=scales.device) % 3]
    return out.to(torch.float32) * chan_scale[None, :, None]


node_histogram.launches = 0
node_histogram.int8_launches = 0


class NodeGeometry(NamedTuple):
    """How one pass of the histogram body (``csrc/node_hist_common.cuh``)
    is cut: kernels 1 and 2 (node mode), and kernel 3 (channel mode, where
    the "nodes" are stat channels, one to a block: ``node_tile`` is 1).

    The grid is one-dimensional, ``row_blocks * groups * tiles`` blocks
    (at most 2^31-1), row blocks fastest: block ``x`` is row block ``x %
    row_blocks`` of item ``y = x // row_blocks``, which owns features
    ``[g*group, (g+1)*group)`` and frontier nodes (or the stat channel)
    ``[t*node_tile, (t+1)*node_tile)`` (``g, t = divmod(y, tiles)``, the
    last of each cut short), in a ``[group, node_tile, 3, B]`` (node mode)
    or ``[group, B, reps]`` (channel mode: ``reps`` copies of each cell)
    shared-memory histogram of ``smem`` bytes. Clusters of ``cluster``
    consecutive row blocks of one item sum their histograms before the
    flush into the output."""
    group: int
    node_tile: int
    cluster: int
    row_blocks: int
    threads: int
    smem: int
    groups: int
    tiles: int
    reps: int = 1


def _node_rows(bin_bytes: int) -> int:
    """Rows a kernel thread takes at a time (node_hist_common.cuh: kVec):
    one 16-byte load of int32 or int16 bins, 8 bytes of uint8 bins."""
    return 8 if bin_bytes == 1 else 16 // bin_bytes


def _tiling(items: int, item_bytes: int, most_tile: int):
    """The tile of ``items`` nodes or stat channels one block holds at
    ``item_bytes`` bytes of shared memory each, at most ``most_tile``, the
    tiles balanced: ``(tile, tiles, budget)``. Two blocks of
    ``_NODE_THREADS`` fit on an SM when a block stays within half the SM's
    shared memory (``budget``); an item too wide for that takes a whole
    block's 227 KB, one block per SM."""
    half_sm = _SM_SMEM // _NODE_BLOCKS_PER_SM - _BLOCK_RESERVE
    budget = half_sm if item_bytes <= half_sm else _SMEM_MAX
    tiles = -(-items // min(items, most_tile, budget // item_bytes))
    return -(-items // tiles), tiles, budget


def _node_geometry(n: int, F: int, W: int, B: int, bin_bytes: int,
                   num_sms: int,
                   clusters_held: Optional[Callable[[int, int], int]] = None,
                   cluster: Optional[int] = None) -> NodeGeometry:
    """The geometry of one node-histogram pass (kernels 1 and 2) over
    ``[F, n]`` bins of ``bin_bytes`` bytes, ``W`` frontier nodes and ``B``
    bins, on a card of ``num_sms`` SMs: :func:`_hist_geometry` with
    ``12 B`` bytes per node (three stats), the node tile all ``W`` nodes
    if one feature's nodes fit (else as many as fit), so the bins are read
    once per node tile."""
    _check_node_bins(B)
    _check_shape(n, F, W, B, bin_bytes)
    return _hist_geometry(n, F, W, B, bin_bytes, num_sms, 12 * B, W, F,
                          clusters_held, cluster)


def _cols_geometry(n: int, F: int, S: int, B: int, bin_bytes: int,
                   num_sms: int,
                   clusters_held: Optional[Callable[[int, int], int]] = None,
                   cluster: Optional[int] = None) -> NodeGeometry:
    """The geometry of one ``histogram_cols`` pass (kernel 3) over ``[F,
    n]`` bins and ``S`` stat channels: :func:`_hist_geometry` with one
    channel per block and ``4 B reps`` bytes per channel (:func:`_cols_reps`
    copies of each cell). The bins are read once per channel, each
    channel's stats once per feature group. In the ablation of
    ``tools/ab_node_hist.py`` (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6),
    tiles of 2 and 3 channels per block lost to one at S=2 and S=3; at
    S=48 each channel costs about what S=1 costs: the shared atomics, which
    a tile does not cut."""
    _check_cols_bins(B)
    _check_shape(n, F, S, B, bin_bytes)
    R = _cols_reps(B)
    return _hist_geometry(n, F, S, B, bin_bytes, num_sms, 4 * B * R, 1,
                          min(F, _COLS_MAX_GROUP), clusters_held,
                          cluster)._replace(reps=R)


def _cols_reps(B: int) -> int:
    """Copies of each kernel-3 cell: as many as fill ``_COLS_REP_BYTES``
    per (feature, channel), at most 32 (one per lane of a warp), or 1 when
    that leaves fewer than 4. A warp's 32 lanes add into copy ``lane %
    reps`` of their cells, so the same-cell collisions that send an f32
    shared atomic round its compare-and-swap loop again, and the bank
    conflicts, fall as ``reps`` grows; the copies cost shared memory (fewer
    features per block) and a sum before the flush. In the copy sweeps of
    tools/ab_node_hist.py on an H100 this picks the fastest count measured
    at B=63 (32) and B=255 (16) and none at B=4096, where fewer lanes share
    a bin and copies only cost."""
    R = 32
    while R > 1 and 4 * B * R > _COLS_REP_BYTES:
        R //= 2
    return R if R >= 4 else 1


def _check_shape(n: int, F: int, W: int, B: int, bin_bytes: int) -> None:
    if n < 0 or F < 1 or W < 1 or B < 1 or bin_bytes not in (1, 2, 4):
        raise ValueError(f"bad histogram shape n={n} F={F} W={W} B={B} "
                         f"bin_bytes={bin_bytes}")


def _hist_geometry(n: int, F: int, items: int, B: int, bin_bytes: int,
                   num_sms: int, item_bytes: int, most_tile: int,
                   most_group: int,
                   clusters_held: Optional[Callable[[int, int], int]],
                   cluster: Optional[int]) -> NodeGeometry:
    """The geometry of one pass of the histogram body over ``items`` nodes
    or stat channels of ``item_bytes`` bytes of histogram per feature,
    tiled by :func:`_tiling`.

    The feature group (groups balanced, at most ``most_group`` features
    and as many as fit beside the tile) weighs a block's fixed work, its
    histogram cells (cleared, summed across the cluster, flushed), against
    the work that grows with the number of groups, each block loading its
    rows' pos and stats once per group: it minimizes ``cells + _ROW_COST * rows per
    block``, with ``rows per block = n * groups * tiles / blocks in a
    wave`` (the scatter's own work per block does not depend on the
    group). More features per block pay off at large ``n`` and narrow
    tiles.

    The grid is one wave: ``clusters_held(smem, c)`` says how many
    clusters of ``c`` such blocks the card holds at once (the kernel
    library's ``cudaOccupancyMaxActiveClusters``; by default every SM's
    blocks, perfectly packed), and the row blocks of each (group, tile)
    are as many as those clusters give, in whole clusters, but no more
    than the sweeps of a block's threads over the row vectors, rounded up
    to whole clusters (an idle block costs nothing; a block left one
    extra, partial sweep costs a whole sweep's latency), and none walks
    fewer rows than twice its tile's bins. A block's threads are then
    the fewest multiple of 32 that gives every block the same number of
    sweeps. Clusters are pairs of row blocks (or ``cluster``, forced),
    single blocks where a wave of pairs would keep less than 95% of the
    blocks: in the cluster sweeps of ``tools/ab_node_hist.py`` on an H100,
    pairs beat single blocks by 1-9% and clusters of 4 or 8 by 3-21% at
    every node-kernel shape measured."""
    tile, tiles, budget = _tiling(items, item_bytes, most_tile)

    def blocks_in_wave(group: int) -> int:
        smem = group * tile * item_bytes
        return num_sms * min(_NODE_BLOCKS_PER_SM,
                             _SM_SMEM // (smem + _BLOCK_RESERVE))

    def cost(groups: int) -> float:
        group = -(-F // groups)
        return (group * tile * item_bytes // 4
                + _ROW_COST * n * groups * tiles / blocks_in_wave(group))

    most_group = min(most_group, budget // (tile * item_bytes))
    groups = min(sorted({-(-F // g) for g in range(1, most_group + 1)}),
                 key=cost)
    group = -(-F // groups)
    smem = group * tile * item_bytes
    slots = blocks_in_wave(group)
    nv = n // _node_rows(bin_bytes)
    most = max(1, min(-(-nv // _NODE_THREADS), n // (2 * tile * B)))

    def row_blocks(c: int) -> int:
        held = slots // c if clusters_held is None else clusters_held(smem, c)
        wave = min(slots, held * c) // (groups * tiles) // c * c
        return min(wave, -(-most // c) * c)

    sizes = (cluster,) if cluster else (2, 1)
    fills = {c: row_blocks(c) for c in sizes}
    if cluster and fills[cluster] < cluster:
        raise ValueError(f"clusters of {cluster} leave no whole cluster of "
                         f"row blocks")
    fullest = max(fills.values())
    chosen = next((c for c in sizes if fills[c] >= c and
                   fills[c] * 20 >= fullest * 19), 1)
    blocks = max(fills[chosen], chosen)
    if blocks * groups * tiles > _MAX_BLOCKS:
        raise ValueError(f"{blocks} row blocks x {groups} feature groups x "
                         f"{tiles} tiles exceed a grid's {_MAX_BLOCKS} blocks")
    return NodeGeometry(group, tile, chosen, blocks,
                        _balanced_threads(nv, blocks), smem, groups, tiles)


def _balanced_threads(vectors: int, row_blocks: int) -> int:
    """The fewest threads per block (a multiple of 32, at most
    ``_NODE_THREADS``) that give each of ``row_blocks`` blocks the same
    number of sweeps over ``vectors`` row vectors, one vector per thread
    per sweep: the fewest sweeps the busiest block can take."""
    sweeps = max(1, -(-vectors // (row_blocks * _NODE_THREADS)))
    return max(32, -(-vectors // (row_blocks * sweeps * 32)) * 32)


@functools.lru_cache(maxsize=None)
def _num_sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.lru_cache(maxsize=None)
def _clusters_held(kernel: str, index: int, bin_bytes: int, smem: int,
                   cluster: int, *mode: int) -> int:
    """Clusters of ``cluster`` blocks of ``kernel`` with ``smem`` bytes of
    shared memory that device ``index`` holds at once; ``mode`` is
    ``(to_bf16,)`` for ``hist_bf16``, whose kernel it selects."""
    lib = _build.load(kernel)
    fn = getattr(lib, _ENTRIES[kernel] + "_max_clusters")
    fn.restype = ctypes.c_int
    args = [bin_bytes, *mode, smem, cluster, _NODE_THREADS]
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    held = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = fn(*args, ctypes.byref(held))
    _build.check(lib, code, f"{kernel} cluster occupancy")
    return held.value


@functools.lru_cache(maxsize=1024)
def _geometry_on(kernel: str, index: int, n: int, F: int, W: int, B: int,
                 bin_bytes: int) -> NodeGeometry:
    """:func:`_node_geometry` on device ``index``, with the clusters its
    card holds."""
    return _node_geometry(
        n, F, W, B, bin_bytes, _num_sms_of(index),
        lambda smem, c: _clusters_held(kernel, index, bin_bytes, smem, c))


@functools.lru_cache(maxsize=1024)
def _cols_geometry_on(index: int, n: int, F: int, S: int, B: int,
                      bin_bytes: int, to_bf16: bool) -> NodeGeometry:
    """:func:`_cols_geometry` on device ``index``, with the clusters its
    card holds of the kernel of this rounding."""
    return _cols_geometry(
        n, F, S, B, bin_bytes, _num_sms_of(index),
        lambda smem, c: _clusters_held("hist_bf16", index, bin_bytes, smem,
                                       c, int(to_bf16)))


def _check_node_args(binned_t, row_pos, base_t, W: int, B: int,
                     base_dtype: torch.dtype) -> None:
    F, n = binned_t.shape
    _check_inputs(binned_t, row_pos=row_pos, base_t=base_t)
    if row_pos.dtype != torch.int32 or tuple(row_pos.shape) != (n,):
        raise TypeError(f"row_pos must be int32 [{n}], got {row_pos.dtype} "
                        f"{tuple(row_pos.shape)}")
    if base_t.dtype != base_dtype or tuple(base_t.shape) != (3, n):
        raise TypeError(f"base_t must be {base_dtype} [3, {n}], got "
                        f"{base_t.dtype} {tuple(base_t.shape)}")
    if F < 1 or W < 1 or B < 1:
        raise ValueError(f"node_histogram needs F, W, B >= 1 (got {F}, {W}, "
                         f"{B})")
    _check_node_bins(B)


def _check_node_bins(B: int) -> None:
    if 12 * B > _SMEM_MAX:
        raise ValueError(f"num_bins={B} needs {12 * B} bytes of shared "
                         f"memory per node; the kernel takes at most "
                         f"{_SMEM_MAX}")


def _node_hist_cuda(binned_t, row_pos, base_t, W: int, B: int,
                    geometry: Optional[NodeGeometry] = None):
    """Kernel 1: validate, allocate the zeroed output, launch
    ``node_hist`` on the current stream with ``geometry`` (by default
    :func:`_node_geometry`'s)."""
    _check_node_args(binned_t, row_pos, base_t, W, B, torch.float32)
    F, n = binned_t.shape
    out = torch.zeros((F, 3 * W, B), dtype=torch.float32,
                      device=binned_t.device)
    _launch_node("node_hist", binned_t, row_pos, base_t, out, W, B,
                 geometry)
    node_histogram.launches += 1
    return out


def _node_hist_int8_cuda(binned_t, row_pos, base_t, W: int, B: int,
                         geometry: Optional[NodeGeometry] = None):
    """Kernel 2: validate, allocate the zeroed int32 output, launch
    ``node_hist_int8`` on the current stream with ``geometry`` (by default
    :func:`_node_geometry`'s). A cell sums at most ``n`` stats of magnitude
    at most ``quant_q_max(n)`` (``quantize_stats`` clips to it), which
    keeps it below 2^31; at row counts where a full int8 range could
    overflow, the stats are checked against that bound."""
    _check_node_args(binned_t, row_pos, base_t, W, B, torch.int8)
    F, n = binned_t.shape
    if 128 * n > 2 ** 31 - 1:
        q = int(base_t.to(torch.int16).abs().amax()) if n else 0
        if q > quant_q_max(n):
            raise ValueError(
                f"int8 stats reach |{q}| over {n} rows: an int32 cell could "
                f"overflow (quant_q_max({n}) = {quant_q_max(n):g})")
    out = torch.zeros((F, 3 * W, B), dtype=torch.int32,
                      device=binned_t.device)
    _launch_node("node_hist_int8", binned_t, row_pos, base_t, out, W, B,
                 geometry)
    node_histogram.int8_launches += 1
    return out


def _launch_node(kernel: str, binned_t, row_pos, base_t, out, W: int,
                 B: int, geometry: Optional[NodeGeometry]) -> None:
    _launch(kernel, _ENTRIES[kernel], _node_args(
        kernel, binned_t, row_pos, base_t, out, W, B, geometry),
        binned_t.device)


def _node_args(kernel: str, binned_t, row_pos, base_t, out, W: int, B: int,
               geometry: Optional[NodeGeometry]) -> list:
    F, n = binned_t.shape
    bin_bytes = _BIN_BYTES[binned_t.dtype]
    g = geometry or _geometry_on(kernel, _device_index(binned_t.device), n,
                                 F, W, B, bin_bytes)
    c = ctypes
    return [(c.c_void_p, binned_t.data_ptr()), (c.c_int, bin_bytes),
            (c.c_void_p, row_pos.data_ptr()), (c.c_void_p, base_t.data_ptr()),
            (c.c_void_p, out.data_ptr()), (c.c_longlong, n), (c.c_int, F),
            (c.c_int, W), (c.c_int, B), (c.c_int, g.group),
            (c.c_int, g.node_tile), (c.c_int, g.cluster),
            (c.c_int, g.row_blocks), (c.c_int, g.threads)]


def histogram(binned: torch.Tensor, stats: torch.Tensor, num_bins: int,
              stats_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Row-major convenience wrapper: ``[n, F]`` bins + ``[n, S]`` stats.
    Transposes and delegates to :func:`histogram_cols`."""
    return histogram_cols(binned.t().contiguous(), stats.t().contiguous(),
                          num_bins, stats_dtype)


def histogram_cols(binned_t: torch.Tensor, stats_t: torch.Tensor,
                   num_bins: int,
                   stats_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``[F, S, B]`` f32 histogram of per-row stats over feature bins.

    binned_t: [F, n] bin ids in [0, num_bins) (int32, int16 or uint8);
    stats_t: [S, n] float stats. Each stat is rounded to ``stats_dtype``
    before it is summed (bf16 by default; f32 means no rounding), as every
    engine of the JAX package does; sums are f32. A CPU tensor takes
    :func:`.histogram_scatter.hist_plain`, a CUDA tensor the ``hist_bf16``
    kernel.
    """
    if stats_dtype not in _STATS_DTYPES:
        raise ValueError(f"stats_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {stats_dtype}")
    dev = binned_t.device
    B = int(num_bins)
    if dev.type == "cpu":
        return hist_plain(binned_t, stats_t, B, stats_dtype)
    if dev.type != "cuda":
        raise ValueError(f"histogram_cols: unsupported device {dev}")
    return _hist_cuda(binned_t, stats_t, B, stats_dtype)


histogram_cols.launches = 0


def _hist_cuda(binned_t, stats_t, B: int, stats_dtype: torch.dtype,
               geometry: Optional[NodeGeometry] = None):
    """Kernel 3: validate, allocate the zeroed output, launch ``hist_bf16``
    on the current stream with ``geometry`` (by default
    :func:`_cols_geometry`'s). The kernel reads f32 stats and rounds them
    in registers; bf16 stats are widened (exactly) first."""
    if stats_t.dtype not in _STATS_DTYPES:
        raise TypeError(f"stats_t must be float32 or bfloat16, got "
                        f"{stats_t.dtype}")
    stats_t = stats_t.to(torch.float32)
    _check_inputs(binned_t, stats_t=stats_t)
    F, n = binned_t.shape
    if stats_t.dim() != 2 or stats_t.shape[1] != n:
        raise TypeError(f"stats_t must be [S, {n}], got "
                        f"{tuple(stats_t.shape)}")
    S = stats_t.shape[0]
    if F < 1 or S < 1 or B < 1:
        raise ValueError(f"histogram_cols needs F, S, B >= 1 (got {F}, {S}, "
                         f"{B})")
    _check_cols_bins(B)
    out = torch.zeros((F, S, B), dtype=torch.float32, device=binned_t.device)
    _launch("hist_bf16", _ENTRIES["hist_bf16"], _cols_args(
        binned_t, stats_t, out, B, stats_dtype == torch.bfloat16, geometry),
        binned_t.device)
    histogram_cols.launches += 1
    return out


def _check_cols_bins(B: int) -> None:
    if B * 4 > _SMEM_MAX:
        raise ValueError(f"num_bins={B} needs {4 * B} bytes of shared memory "
                         f"per stat; the kernel takes at most {_SMEM_MAX}")


def _cols_args(binned_t, stats_t, out, B: int, to_bf16: bool,
               geometry: Optional[NodeGeometry]) -> list:
    F, n = binned_t.shape
    S = stats_t.shape[0]
    bin_bytes = _BIN_BYTES[binned_t.dtype]
    g = geometry or _cols_geometry_on(_device_index(binned_t.device), n, F,
                                      S, B, bin_bytes, bool(to_bf16))
    c = ctypes
    return [(c.c_void_p, binned_t.data_ptr()), (c.c_int, bin_bytes),
            (c.c_void_p, stats_t.data_ptr()), (c.c_void_p, out.data_ptr()),
            (c.c_longlong, n), (c.c_int, F), (c.c_int, S), (c.c_int, B),
            (c.c_int, int(to_bf16)), (c.c_int, g.group), (c.c_int, g.reps),
            (c.c_int, g.cluster), (c.c_int, g.row_blocks),
            (c.c_int, g.threads)]
