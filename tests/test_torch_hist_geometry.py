"""The tiling of the histogram kernels, on the CPU.

``ops/histogram.py:_node_geometry`` (kernels 1 and 2) and
``_cols_geometry`` (kernel 3) choose how one pass is cut: feature groups x
node tiles (or one stat channel) in a shared-memory histogram, row
blocks, clusters of row blocks whose histograms are summed before the
flush. The CUDA body (``csrc/node_hist_common.cuh``) runs on the card only;
these tests hold the geometry to what that body accepts, and numpy
emulations of the blocked algorithm — per (group, tile, row block) partial
histograms over the same row ranges the kernel walks, summed per cluster,
then across clusters — to the plain versions bit for bit on integer sums.
The kernels themselves are held to the plain versions on the card by
``chip_smoke.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import histogram as TH
from mmlspark_tpu_torch.ops.histogram_scatter import (hist_plain,
                                                      node_hist_plain)

torch.set_num_threads(1)

SMEM_MAX = 232_448
BIN_NP = {4: np.int32, 2: np.int16, 1: np.uint8}


def _cover(F, W, geo):
    """How many (group, tile) items own each (feature, node), read the way
    the kernel reads the item ``blockIdx.x // row_blocks``."""
    seen = np.zeros((F, W), np.int64)
    for y in range(geo.groups * geo.tiles):
        f0 = (y // geo.tiles) * geo.group
        w0 = (y % geo.tiles) * geo.node_tile
        assert f0 < F and w0 < W, "an empty feature group or node tile"
        seen[f0:f0 + geo.group, w0:w0 + geo.node_tile] += 1
    return seen


@pytest.mark.parametrize("B", [2, 63, 255, 4096, 19_370])
@pytest.mark.parametrize("F", [1, 5, 28, 100])
def test_geometry_fits_and_covers_every_feature_and_node(F, B):
    for W in range(1, 32):
        for n, bin_bytes in ((0, 4), (1_000, 1), (500_000, 4),
                             (1_000_000, 2)):
            geo = TH._node_geometry(n, F, W, B, bin_bytes, 132)
            assert geo.smem == geo.group * geo.node_tile * 12 * B
            assert 0 < geo.smem <= SMEM_MAX
            assert geo.groups == -(-F // geo.group)
            assert geo.tiles == -(-W // geo.node_tile)
            assert geo.row_blocks * geo.groups * geo.tiles <= 2 ** 31 - 1
            assert (_cover(F, W, geo) == 1).all()
            assert geo.cluster in (1, 2, 4, 8)
            assert geo.row_blocks >= geo.cluster
            assert geo.row_blocks % geo.cluster == 0
            assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
            # every block takes the fewest sweeps it can: one vector per
            # thread per sweep, no block a sweep more than another
            nv = n // TH._node_rows(bin_bytes)
            sweeps = -(-nv // geo.threads)
            assert -(-sweeps // geo.row_blocks) == -(-nv // (
                geo.row_blocks * 512))


def test_geometry_at_the_main_path_shapes():
    """Root pass: groups of 7 features (the row loads of 4 groups against
    21,420-byte histograms), the grid one wave of 264 blocks in clusters of
    2 (perfectly packed). The n=500,000 pass at W=1: groups of 7; at W=8:
    groups of 2 (48,960 bytes), 18 row blocks each in clusters of 2; at
    W=16, groups of 2 as well (97,920 bytes, still two blocks per SM)."""
    root = TH._node_geometry(1_000_000, 28, 1, 255, 4, 132)
    assert (root.group, root.groups, root.node_tile, root.cluster,
            root.row_blocks, root.smem) == (7, 4, 1, 2, 66, 21_420)
    # 250,000 row vectors over 66 blocks: 8 sweeps of 480 threads each
    assert root.threads == 480
    narrow = TH._node_geometry(500_000, 28, 1, 255, 4, 132)
    assert (narrow.group, narrow.groups) == (7, 4)
    half = TH._node_geometry(500_000, 28, 8, 255, 4, 132)
    assert (half.group, half.groups, half.node_tile, half.cluster,
            half.row_blocks, half.smem) == (2, 14, 8, 2, 18, 48_960)
    wide_front = TH._node_geometry(500_000, 28, 16, 255, 4, 132)
    assert (wide_front.group, wide_front.node_tile,
            wide_front.smem) == (2, 16, 97_920)
    # the group weighs histogram cells against row loads: more rows, more
    # features per block; wider frontiers, fewer
    groups = [TH._node_geometry(n, 28, 1, 255, 4, 132).group
              for n in (10_000, 100_000, 1_000_000, 10_000_000)]
    assert groups == sorted(groups) and groups[0] < groups[-1]
    groups = [TH._node_geometry(1_000_000, 28, W, 255, 4, 132).group
              for W in (1, 2, 4, 8, 16)]
    assert groups == sorted(groups, reverse=True)
    # a node too wide for half an SM takes a whole block
    wide = TH._node_geometry(10_000, 3, 2, 19_370, 4, 132)
    assert (wide.group, wide.node_tile, wide.smem) == (1, 1, 232_440)
    # few rows: one block per sweep (750 vectors, two blocks of 384
    # threads), not one per slot of the card
    small = TH._node_geometry(3_000, 28, 1, 255, 4, 132)
    assert (small.row_blocks, small.cluster, small.threads) == (2, 2, 384)
    # a partial extra sweep costs a whole one: int16 bins at n=500,000 make
    # 122.07 sweeps, so the row blocks round up to 124, not down to 122
    narrow16 = TH._node_geometry(500_000, 28, 1, 63, 2, 132)
    assert (narrow16.group, narrow16.row_blocks, narrow16.threads) == (
        14, 124, 512)


def test_geometry_refuses_what_the_wrapper_refuses():
    with pytest.raises(ValueError, match="shared memory"):
        TH._node_geometry(100, 28, 1, 19_371, 4, 132)
    n = 16
    with pytest.raises(ValueError, match="shared memory"):
        TH._node_hist_cuda(torch.zeros(2, n, dtype=torch.int32),
                           torch.zeros(n, dtype=torch.int32),
                           torch.zeros(3, n), 1, 19_371)
    with pytest.raises(ValueError, match="bin_bytes"):
        TH._node_geometry(100, 28, 1, 255, 8, 132)


def test_node_args_carry_the_geometry_in_the_c_order():
    """mm_node_hist_{bf16,int8}(binned, bin_bytes, pos, base, out, n, F, W,
    B, group, node_tile, cluster, row_blocks, threads, stream)."""
    n, F, W, B = 40, 3, 2, 7
    binned = torch.zeros(F, n, dtype=torch.uint8)
    pos = torch.zeros(n, dtype=torch.int32)
    base = torch.zeros(3, n)
    out = torch.zeros(F, 3 * W, B)
    geo = TH.NodeGeometry(2, 1, 2, 4, 256, 2 * 12 * B, 2, 2)
    args = TH._node_args("node_hist", binned, pos, base, out, W, B, geo)
    assert [v for _, v in args[1:2] + args[5:]] == [1, n, F, W, B, 2, 1, 2,
                                                    4, 256]


def _clusters(geo):
    """The one-dimensional grid of the body, cluster by cluster: (item,
    row blocks of the cluster), from block x = item * row_blocks + row
    block. A cluster's blocks must belong to one item."""
    for x0 in range(0, geo.row_blocks * geo.groups * geo.tiles, geo.cluster):
        item = x0 // geo.row_blocks
        assert (x0 + geo.cluster - 1) // geo.row_blocks == item, \
            "a cluster straddles two items"
        yield item, [x % geo.row_blocks for x in range(x0, x0 + geo.cluster)]


def _rows_of(row_block, n, V, geo):
    """The rows one row block walks: whole row vectors of V rows in sweeps
    of ``threads`` vectors, sweep k to row block k % row_blocks, and, for
    the last row block, the n % V rows after them."""
    nv = n // V
    sweep_of_row = np.arange(nv * V) // (V * geo.threads)
    rows = np.flatnonzero(sweep_of_row % geo.row_blocks == row_block)
    if row_block == geo.row_blocks - 1:
        rows = np.concatenate([rows, np.arange(nv * V, n)])
    return rows


def _emulate(binned, pos, base, W, B, geo):
    """The blocked algorithm of node_hist_common.cuh in numpy, on integer
    stats: whole row vectors of V rows (4 of int32, 8 of int16 or uint8
    bins) go in sweeps of ``threads`` vectors, sweep k to row block k %
    row_blocks of each (group, tile) item, and the last row block also
    takes the n % V rows after them; partial histograms are summed per
    cluster of row blocks, then added into the output cluster by cluster.
    Returns (out, per-row visit counts)."""
    F, n = binned.shape
    V = TH._node_rows(binned.dtype.itemsize)
    out = np.zeros((F, 3 * W, B), np.int64)
    visits = np.zeros((geo.groups * geo.tiles, n), np.int64)
    for y, row_blocks in _clusters(geo):
        f0 = (y // geo.tiles) * geo.group
        w0 = (y % geo.tiles) * geo.node_tile
        g_n, wt = min(geo.group, F - f0), min(geo.node_tile, W - w0)
        summed = np.zeros((g_n, wt, 3, B), np.int64)
        for x in row_blocks:
            rows = _rows_of(x, n, V, geo)
            visits[y, rows] += 1
            q = pos[rows] - w0
            for g in range(g_n):
                b = binned[f0 + g, rows].astype(np.int64)
                keep = (q >= 0) & (q < wt) & (b >= 0) & (b < B)
                for s in range(3):
                    np.add.at(summed[g], (q[keep], s, b[keep]),
                              base[s, rows[keep]])
        out[f0:f0 + g_n, w0 * 3:(w0 + wt) * 3] += summed.reshape(
            g_n, wt * 3, B)
    return out, visits


def _int8_inputs(seed, n, F, W, B, bin_bytes):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(BIN_NP[bin_bytes])
    if n and bin_bytes != 1:
        binned[0, ::7] = B + 3                   # ids outside [0, B) skip
    pos = rng.integers(-1, W, size=n).astype(np.int32)   # some rows -1
    base = rng.integers(-127, 128, size=(3, n)).astype(np.int8)
    return binned, pos, base


EXPLICIT = [
    # n, F, W, B, bin_bytes, (group, node_tile, cluster, row_blocks)
    (1001, 5, 3, 63, 4, (2, 2, 2, 6)),
    (2999, 7, 8, 255, 1, (3, 8, 4, 8)),
    (777, 4, 5, 31, 2, (4, 2, 8, 8)),
    (37, 3, 2, 17, 4, (1, 1, 1, 3)),
    (5, 2, 1, 9, 1, (2, 1, 2, 2)),              # n below one vector
    (0, 2, 3, 9, 4, (1, 3, 1, 1)),
]


@pytest.mark.parametrize("n,F,W,B,bin_bytes,cut", EXPLICIT)
def test_blocked_algorithm_matches_plain_bit_for_bit(n, F, W, B, bin_bytes,
                                                     cut):
    group, node_tile, cluster, row_blocks = cut
    geo = TH.NodeGeometry(group, node_tile, cluster, row_blocks, 32,
                          group * node_tile * 12 * B, -(-F // group),
                          -(-W // node_tile))
    binned, pos, base = _int8_inputs(n + F * W, n, F, W, B, bin_bytes)
    got, visits = _emulate(binned, pos, base.astype(np.int64), W, B, geo)
    assert (visits == 1).all(), "a row is walked twice or never"
    want = node_hist_plain(torch.from_numpy(binned), torch.from_numpy(pos),
                           torch.from_numpy(base), W, B,
                           acc_dtype=torch.int32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,F,W,B,bin_bytes,sms", [
    (50_001, 5, 3, 63, 4, 16), (200_003, 6, 8, 255, 1, 16),
    (150_002, 4, 16, 63, 2, 16)])
def test_blocked_algorithm_with_the_chosen_geometry(n, F, W, B, bin_bytes,
                                                    sms):
    """The geometry _node_geometry picks on a small card, where the row
    axis splits into several clusters and the features into several
    groups at these row counts."""
    geo = TH._node_geometry(n, F, W, B, bin_bytes, sms)
    assert geo.row_blocks > geo.cluster > 1 and geo.groups > 1
    binned, pos, base = _int8_inputs(n, n, F, W, B, bin_bytes)
    got, visits = _emulate(binned, pos, base.astype(np.int64), W, B, geo)
    assert (visits == 1).all()
    want = node_hist_plain(torch.from_numpy(binned), torch.from_numpy(pos),
                           torch.from_numpy(base), W, B,
                           acc_dtype=torch.int32).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_is_one_wave_of_the_clusters_the_card_holds():
    """With the cluster occupancy an H100 reported for 85,680-byte blocks
    (30 clusters of 8, 62 of 4, 132 of 2), the grid never asks for more
    blocks than the card holds at once, and the cluster size keeps 95% of
    the fullest wave."""
    held = {8: 30, 4: 62, 2: 132, 1: 264}
    calls = []

    def clusters_held(smem, c):
        calls.append((smem, c))
        return held[c]
    root = TH._node_geometry(1_000_000, 28, 1, 255, 4, 132, clusters_held)
    assert root.row_blocks * root.groups <= held[root.cluster] * root.cluster
    assert (root.cluster, root.row_blocks) == (2, 66)
    assert all(smem == root.smem for smem, _ in calls)
    half = TH._node_geometry(500_000, 28, 8, 255, 4, 132, clusters_held)
    assert half.row_blocks * half.groups <= held[half.cluster] * half.cluster
    assert (half.cluster, half.row_blocks) == (2, 18)
    forced = TH._node_geometry(1_000_000, 28, 1, 255, 4, 132, clusters_held,
                               cluster=8)
    assert (forced.cluster, forced.row_blocks) == (8, 56)
    with pytest.raises(ValueError, match="no whole cluster"):
        TH._node_geometry(3_000, 100, 1, 255, 4, 132, clusters_held,
                          cluster=8)


def test_row_sweeps_spread_a_half_pass_front_evenly():
    """A half pass's selected rows sit at the front of its buffer (the
    rest at pos -1). Sweeps dealt round-robin to the row blocks give every
    block the same share of them, to within one sweep."""
    n, F, W, B = 500_000, 28, 8, 255
    geo = TH._node_geometry(n, F, W, B, 4, 132)
    sweep = geo.threads * TH._node_rows(4)
    for selected in (n // 10, n // 3, n // 2):
        per_block = np.bincount(
            (np.arange(selected) // sweep) % geo.row_blocks,
            minlength=geo.row_blocks)
        assert per_block.max() - per_block.min() <= sweep
        assert per_block.max() <= -(-selected // geo.row_blocks) + sweep


# -- kernel 3 (histogram_cols): the channel mode of the same body ----------

@pytest.mark.parametrize("B", [2, 63, 255, 4096, 58_112])
@pytest.mark.parametrize("S", [1, 2, 3, 5, 48])
@pytest.mark.parametrize("F", [1, 5, 28, 100])
def test_cols_geometry_fits_and_covers_every_feature_and_channel(F, S, B):
    for n, bin_bytes in ((0, 4), (1_000, 1), (499_999, 2), (1_000_000, 4)):
        geo = TH._cols_geometry(n, F, S, B, bin_bytes, 132)
        assert geo.reps in (1, 4, 8, 16, 32)
        assert geo.smem == geo.group * 4 * B * geo.reps
        assert 0 < geo.smem <= SMEM_MAX
        assert (geo.node_tile, geo.tiles) == (1, S)   # a channel per block
        assert geo.group <= 4                    # the feature loop's unroll
        assert geo.groups == -(-F // geo.group)
        assert geo.row_blocks * geo.groups * geo.tiles <= 2 ** 31 - 1
        assert (_cover(F, S, geo) == 1).all()
        assert geo.cluster in (1, 2, 4, 8)
        assert geo.row_blocks >= geo.cluster
        assert geo.row_blocks % geo.cluster == 0
        assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
        nv = n // TH._node_rows(bin_bytes)
        sweeps = -(-nv // geo.threads)
        assert -(-sweeps // geo.row_blocks) == -(-nv // (
            geo.row_blocks * 512))


def test_cols_geometry_tiles_and_main_shape():
    """One stat channel per block at every S. At 1M x 28 int32 bins, S=2,
    B=255: 16 copies of each cell, groups of 4 features (65,280 bytes), 18
    row blocks each in pairs, one wave of 252 blocks."""
    def tiling(S):
        g = TH._cols_geometry(100_000, 28, S, 255, 4, 132)
        return g.node_tile, g.tiles
    assert {S: tiling(S) for S in (1, 2, 3, 5, 7, 48)} == {
        1: (1, 1), 2: (1, 2), 3: (1, 3), 5: (1, 5), 7: (1, 7), 48: (1, 48)}
    main = TH._cols_geometry(1_000_000, 28, 2, 255, 4, 132)
    assert (main.group, main.groups, main.node_tile, main.tiles, main.reps,
            main.cluster, main.row_blocks, main.smem) == (
                4, 7, 1, 2, 16, 2, 18, 65_280)
    assert main.row_blocks * main.groups * main.tiles == 252
    # a channel too wide for half an SM takes a whole block, one copy
    wide = TH._cols_geometry(10_000, 3, 2, 58_112, 4, 132)
    assert (wide.group, wide.node_tile, wide.reps, wide.smem) == (
        1, 1, 1, 232_448)


@pytest.mark.parametrize("B,reps", [(2, 32), (63, 32), (128, 32), (255, 16),
                                    (511, 8), (1023, 4), (1024, 4),
                                    (1025, 1), (4096, 1), (58_112, 1)])
def test_cols_copies_fill_16_kib_per_channel(B, reps):
    assert TH._cols_reps(B) == reps
    geo = TH._cols_geometry(500_000, 28, 3, B, 2, 132)
    assert geo.reps == reps
    assert geo.smem == geo.group * 4 * B * reps


@pytest.mark.parametrize("n,F,S,B,bin_bytes", [
    (20_000, 28, 10_000, 255, 4),    # 7 groups x 10,000 channels
    (256, 300_000, 1, 63, 1),        # 75,000 groups of 4 features
    (1_000, 70_000, 1, 30_000, 2)])  # one feature per block
def test_cols_geometry_takes_wide_grids(n, F, S, B, bin_bytes):
    """More (feature group, channel) items than a grid's y extent (65,535)
    holds: the grid is one-dimensional, and every item still gets its row
    blocks, in whole clusters."""
    geo = TH._cols_geometry(n, F, S, B, bin_bytes, 132)
    assert geo.groups * geo.tiles > 65_535
    assert geo.row_blocks * geo.groups * geo.tiles <= 2 ** 31 - 1
    assert geo.row_blocks >= geo.cluster and geo.row_blocks % geo.cluster == 0
    assert (_cover(F, S, geo) == 1).all()
    assert 0 < geo.smem <= SMEM_MAX


def test_cols_geometry_refuses_what_the_wrapper_refuses():
    with pytest.raises(ValueError, match="shared memory"):
        TH._cols_geometry(100, 28, 2, 58_113, 4, 132)
    with pytest.raises(ValueError, match="shared memory"):
        TH._hist_cuda(torch.zeros(2, 16, dtype=torch.int32),
                      torch.zeros(2, 16), 58_113, torch.bfloat16)
    with pytest.raises(ValueError, match="bin_bytes"):
        TH._cols_geometry(100, 28, 2, 255, 3, 132)
    # 2^28 groups of 4 features x 8 channels: 2^31 blocks at one row block
    with pytest.raises(ValueError, match="exceed a grid"):
        TH._cols_geometry(0, 2 ** 30, 8, 255, 4, 132)


def test_cols_args_carry_the_geometry_in_the_c_order():
    """mm_hist_bf16(binned, bin_bytes, stats, out, n, F, S, B, to_bf16,
    group, reps, cluster, row_blocks, threads, stream)."""
    n, F, S, B = 40, 3, 5, 7
    binned = torch.zeros(F, n, dtype=torch.int16)
    stats = torch.zeros(S, n)
    out = torch.zeros(F, S, B)
    geo = TH.NodeGeometry(2, 1, 2, 4, 256, 2 * 4 * B * 8, 2, 5, 8)
    for to_bf16 in (True, False):
        args = TH._cols_args(binned, stats, out, B, to_bf16, geo)
        c = ctypes
        assert [t for t, _ in args] == ([c.c_void_p, c.c_int, c.c_void_p,
                                         c.c_void_p, c.c_longlong]
                                        + [c.c_int] * 9)
        assert [v for _, v in args[:4:2]] == [binned.data_ptr(),
                                              stats.data_ptr()]
        assert args[3][1] == out.data_ptr()
        assert [v for _, v in args[1:2] + args[4:]] == [
            2, n, F, S, B, int(to_bf16), 2, 8, 2, 4, 256]


def test_cols_occupancy_query_asks_for_the_launched_kernel(monkeypatch):
    """The cluster occupancy of kernel 3 is asked of the kernel the launch
    will run: mm_hist_bf16_max_clusters(bin_bytes, to_bf16, smem, cluster,
    threads, *result)."""
    calls = []

    class Query:
        def __call__(self, *args):
            calls.append(args[:-1])
            args[-1]._obj.value = 33
            return 0

    class Lib:
        mm_hist_bf16_max_clusters = Query()

    monkeypatch.setattr(TH._build, "load", lambda name: Lib())
    monkeypatch.setattr(TH.torch.cuda, "device", lambda index: _Null())
    monkeypatch.setattr(TH, "_num_sms_of", lambda index: 132)
    TH._cols_geometry_on.cache_clear()
    TH._clusters_held.cache_clear()
    try:
        geo = TH._cols_geometry_on(7, 1_000_000, 28, 5, 255, 2, False)
    finally:
        TH._cols_geometry_on.cache_clear()
        TH._clusters_held.cache_clear()
    assert (geo.node_tile, geo.tiles, geo.reps) == (1, 5, 16)
    assert calls and all(a[:2] == (2, 0) and a[2] == geo.smem
                         and a[4] == 512 for a in calls)
    # 33 clusters of two are the wave, shared by 5 tiles x the groups
    assert geo.row_blocks * geo.groups * geo.tiles <= 66


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _emulate_cols(binned, stats, B, geo):
    """The blocked algorithm of the body's channel mode in numpy, summing
    in the stats' dtype: the grid and row sweeps of ``_emulate``, each
    (group, channel) item summing ``[group, B]`` partial histograms per
    cluster of row blocks, then adding them into the output cluster by
    cluster. Returns (out, per-row visit counts)."""
    F, n = binned.shape
    V = TH._node_rows(binned.dtype.itemsize)
    out = np.zeros((F, stats.shape[0], B), stats.dtype)
    visits = np.zeros((geo.groups * geo.tiles, n), np.int64)
    assert geo.node_tile == 1
    for y, row_blocks in _clusters(geo):
        f0, s = (y // geo.tiles) * geo.group, y % geo.tiles
        g_n = min(geo.group, F - f0)
        summed = np.zeros((g_n, B), stats.dtype)
        for x in row_blocks:
            rows = _rows_of(x, n, V, geo)
            visits[y, rows] += 1
            for g in range(g_n):
                b = binned[f0 + g, rows].astype(np.int64)
                keep = (b >= 0) & (b < B)
                np.add.at(summed[g], b[keep], stats[s, rows[keep]])
        out[f0:f0 + g_n, s] += summed
    return out, visits


def _cols_int_inputs(seed, n, F, S, B, bin_bytes):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(BIN_NP[bin_bytes])
    if n:
        binned[0, ::7] = min(B + 3, 255) if bin_bytes == 1 else B + 3
        if bin_bytes != 1:
            binned[-1, ::5] = -1                 # ids outside [0, B) skip
    stats = rng.integers(-100, 101, size=(S, n)).astype(np.int64)
    stats[:, ::3] = 0                            # zero stats add nothing
    return binned, stats


def _plain_cols(binned, stats, B, stats_dtype):
    return hist_plain(torch.from_numpy(binned),
                      torch.from_numpy(stats.astype(np.float32)), B,
                      stats_dtype).numpy()


COLS_EXPLICIT = [
    # n, F, S, B, bin_bytes, (group, cluster, row_blocks)
    (1001, 5, 3, 63, 4, (2, 2, 6)),
    (2999, 7, 5, 200, 1, (3, 4, 8)),
    (777, 4, 2, 31, 2, (4, 8, 8)),
    (37, 3, 1, 17, 4, (1, 1, 3)),
    (5, 2, 4, 9, 1, (2, 2, 2)),                 # n below one vector
    (0, 2, 3, 9, 4, (1, 1, 1)),
    (611, 3, 7, 13, 2, (2, 2, 4)),              # a group cut short
]


@pytest.mark.parametrize("stats_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,F,S,B,bin_bytes,cut", COLS_EXPLICIT)
def test_cols_blocked_algorithm_matches_plain_bit_for_bit(
        n, F, S, B, bin_bytes, cut, stats_dtype):
    group, cluster, row_blocks = cut
    geo = TH.NodeGeometry(group, 1, cluster, row_blocks, 32, group * 4 * B,
                          -(-F // group), S)
    binned, stats = _cols_int_inputs(n + F * S, n, F, S, B, bin_bytes)
    got, visits = _emulate_cols(binned, stats, B, geo)
    assert (visits == 1).all(), "a row is walked twice or never"
    np.testing.assert_array_equal(got, _plain_cols(binned, stats, B,
                                                   stats_dtype))


@pytest.mark.parametrize("n,F,S,B,bin_bytes,sms", [
    (100_001, 5, 5, 63, 4, 32), (200_003, 9, 2, 255, 1, 32),
    (150_002, 14, 3, 63, 2, 48), (60_001, 1, 6, 15, 4, 32)])
def test_cols_blocked_algorithm_with_the_chosen_geometry(n, F, S, B,
                                                         bin_bytes, sms):
    """The geometry _cols_geometry picks on a small card, where the row
    axis splits into several clusters and the features into several
    groups, or S into several channels, at these row counts."""
    geo = TH._cols_geometry(n, F, S, B, bin_bytes, sms)
    assert geo.row_blocks > geo.cluster > 1
    assert geo.groups > 1 or geo.tiles > 1
    binned, stats = _cols_int_inputs(n, n, F, S, B, bin_bytes)
    got, visits = _emulate_cols(binned, stats, B, geo)
    assert (visits == 1).all()
    np.testing.assert_array_equal(got, _plain_cols(binned, stats, B,
                                                   torch.bfloat16))
