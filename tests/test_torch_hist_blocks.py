"""The deterministic blocked reduction (``GrowConfig.hist_blocks``): the
PyTorch port against itself across world sizes and against the JAX package.

  * The JAX package's four identity configurations
    (``tests/test_placement.py``: depthwise, leafwise, categorical,
    quantized; 960 rows, ``hist_blocks=8``, 2 rounds) fit in the port at
    world sizes 1, 2 and 4 (gloo processes on the CPU, ``file://``
    rendezvous): every rank's ``model_string()`` is byte-equal to the
    one-process fit's.
  * The same configurations against the JAX package on a one-device mesh:
    identical trees, margins within 1e-5 (quantized: both packages round
    stochastically under the same key words, nothing patched).
  * The blocked histogram entry (``node_histogram(..., blocks=)``) on the
    CPU against per-block plain histograms (bit-equal) and the JAX
    package's blocked partials (bf16: 1e-5 relative; int8: bit-equal).
  * The fixed-point arithmetic of kernel 1's deterministic mode, emulated
    in numpy from ``_det_shifts``: every block sum stays below 2^63 and the
    result is within the kernel-vs-plain contract of ``chip_smoke.py``
    (grad/hess within 1e-4 of the channel's largest magnitude plus 1e-4,
    counts bit-equal); its bit-exact plain version ``node_hist_det_plain``
    against that emulation, at the shift rule's edges too; the histogram
    body's cut of the mode (``_det_geometry``'s items, row blocks and
    clusters, (lo, hi) cells with adds in a shuffled order, cluster folds,
    int64 partials) against it bit for bit; the geometry at the path's
    shapes and the wrapper's C arguments.
  * The exact block sums behind the blocked totals and leaf renewal.
  * Bagging (each rank draws its slice of the global stream) and DART are
    byte-equal across world sizes too; validation metrics, summed over
    the group, agree within 1e-6 relative (the JAX package's scope note:
    their last ulp may follow the world size), on the same trees.
  * Reference behaviour the port does not copy (ROADMAP Queue 3): the JAX
    package's bagged fit on two devices draws ``fold_in(bag_key,
    axis_index)`` over each shard's rows and grows other trees than its
    one-device fit, which the port's fit at every world size equals; its
    plain quantized path draws the same local uniforms on every shard,
    where a port rank draws its rows of the one-device draw.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import run_ranks
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.ops import histogram as TH
from mmlspark_tpu_torch.ops import histogram_scatter as HS
from mmlspark_tpu_torch.ops.histogram_scatter import (node_hist_blocked_plain,
                                                      node_hist_det_plain,
                                                      node_hist_plain)

torch.set_num_threads(1)

STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf", "cat_bitset")
CONFIGS = {"depthwise": ("depthwise", False, ()),
           "leafwise": ("leafwise", False, ()),
           "categorical": ("depthwise", False, (3,)),
           "quantized": ("depthwise", True, ())}

_FITS = """
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
rng = np.random.default_rng(7)
n = 960
X = rng.normal(size=(n, 6)).astype(np.float32)
X[:, 3] = rng.integers(0, 8, size=n)
y = (X[:, 0] * X[:, 1] + 0.4 * X[:, 2] > 0).astype(np.float32)
CONFIGS = __CONFIGS__
result = {}
for tag, (policy, quant, cats) in CONFIGS.items():
    cfg = GrowConfig(num_leaves=7, min_data_in_leaf=5, growth_policy=policy,
                     quantized_grad=quant, hist_blocks=8)
    b = train_booster(X, y, objective="binary", num_iterations=2, cfg=cfg,
                      max_bin=63, bin_sample_count=n, seed=0,
                      categorical_features=cats, device="cpu")
    result[tag] = b.model_string()
# bagging draws each rank's slice of the global stream; DART's
# contributions stay per rank: both grow the same bytes at every size
common = dict(objective="binary", num_iterations=3, max_bin=63,
              bin_sample_count=n, seed=0, device="cpu")
cfg = GrowConfig(num_leaves=7, min_data_in_leaf=5, hist_blocks=8)
result["bagging"] = train_booster(X, y, cfg=cfg, bagging_fraction=0.7,
                                  bagging_freq=1, **common).model_string()
result["dart"] = train_booster(X, y, cfg=cfg, boosting_type="dart",
                               **common).model_string()
# validation rows are sharded too; their metrics are summed over the
# group (the JAX scope note: the last ulp may follow the world size)
for metric in ("binary_logloss", "auc"):
    b = train_booster(X[:720], y[:720], cfg=cfg,
                      valid_set=(X[720:], y[720:], None),
                      eval_metric_name=metric, **common)
    result["valid_" + metric] = {
        "history": b.eval_history[metric],
        "feat": b.trees["feat"].tolist()}
"""


def _data():
    rng = np.random.default_rng(7)
    n = 960
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[:, 3] = rng.integers(0, 8, size=n)
    y = (X[:, 0] * X[:, 1] + 0.4 * X[:, 2] > 0).astype(np.float32)
    return X, y


def _cfg(pkg, tag):
    policy, quant, _ = CONFIGS[tag]
    return pkg.GrowConfig(num_leaves=7, min_data_in_leaf=5,
                          growth_policy=policy, quantized_grad=quant,
                          hist_blocks=8)


@pytest.fixture(scope="module")
def world_fits(tmp_path_factory):
    """{world size: [each rank's {config: model_string}]}; the world sizes
    2 and 4 run at the same time."""
    import threading
    tmp = tmp_path_factory.mktemp("hist_blocks")
    body = _FITS.replace("__CONFIGS__", repr(CONFIGS))
    runs, errors = {}, []

    def run(world):
        try:
            runs[world] = run_ranks(tmp, world, body, timeout=300)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(w,)) for w in (1, 2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return runs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", sorted(CONFIGS))
def test_world_sizes_grow_byte_equal_models(world_fits, world, tag):
    want = world_fits[1][0][tag]
    assert len(want) > 1000
    for rank, got in enumerate(world_fits[world]):
        assert got[tag] == want, f"rank {rank} of {world}: {tag} differs"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", ["bagging", "dart"])
def test_sampled_and_dart_fits_are_byte_equal_too(world_fits, world, tag):
    want = world_fits[1][0][tag]
    for got in world_fits[world]:
        assert got[tag] == want


@pytest.mark.parametrize("metric", ["binary_logloss", "auc"])
def test_validation_metrics_combine_over_the_group(world_fits, metric):
    want = world_fits[1][0]["valid_" + metric]
    assert len(want["history"]) == 3
    for world in (2, 4):
        for got in world_fits[world]:
            got = got["valid_" + metric]
            assert got["feat"] == want["feat"]
            np.testing.assert_allclose(got["history"], want["history"],
                                       rtol=1e-6)


def test_in_process_fit_equals_the_one_rank_process(world_fits):
    X, y = _data()
    policy, quant, cats = CONFIGS["depthwise"]
    b = ttrain(X, y, objective="binary", num_iterations=2,
               cfg=_cfg(TG, "depthwise"), max_bin=63, bin_sample_count=960,
               seed=0, categorical_features=cats, device="cpu")
    assert b.model_string() == world_fits[1][0]["depthwise"]


@pytest.mark.parametrize("tag", sorted(CONFIGS))
def test_blocked_fits_match_jax_one_device(tag):
    X, y = _data()
    cats = CONFIGS[tag][2]
    common = dict(objective="binary", num_iterations=2, max_bin=63,
                  bin_sample_count=960, seed=0, categorical_features=cats)
    jb = jtrain(X, y, cfg=_cfg(JG, tag),
                mesh=make_mesh(devices=jax.devices()[:1]), **common)
    tb = ttrain(X, y, cfg=_cfg(TG, tag), device="cpu", **common)
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)


def _bagged_jax(devices):
    """The JAX package's blocked bagged fit of ``_FITS`` on ``devices``
    CPU devices."""
    X, y = _data()
    cfg = JG.GrowConfig(num_leaves=7, min_data_in_leaf=5, hist_blocks=8)
    return jtrain(X, y, cfg=cfg, objective="binary", num_iterations=3,
                  max_bin=63, bin_sample_count=960, seed=0,
                  bagging_fraction=0.7, bagging_freq=1,
                  mesh=make_mesh(devices=jax.devices()[:devices]))


def test_bagged_fit_at_any_world_size_is_the_jax_one_device_fit(
        world_fits):
    """Queue 3's "not copied" entry: the JAX package's two-device bagged
    fit differs from its one-device fit (each shard draws ``fold_in(bag_key,
    shard)`` over its own rows); the port's fits at world sizes 1, 2 and 4
    are byte-equal (above) and grow the one-device fit's trees."""
    X, y = _data()
    one, two = _bagged_jax(1), _bagged_jax(2)
    assert any(not np.array_equal(np.asarray(getattr(one.trees, f)),
                                  np.asarray(getattr(two.trees, f)))
               for f in STRUCTURE)
    cfg = TG.GrowConfig(num_leaves=7, min_data_in_leaf=5, hist_blocks=8)
    tb = ttrain(X, y, cfg=cfg, objective="binary", num_iterations=3,
                max_bin=63, bin_sample_count=960, seed=0,
                bagging_fraction=0.7, bagging_freq=1, device="cpu")
    assert tb.model_string() == world_fits[2][0]["bagging"]
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(one.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               one.predict_raw(X), rtol=0, atol=1e-5)


class _Rank:
    """A stand-in data group for ``_quantize_for``'s plain path, which reads
    only the rank and the size."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("n", [1000, 999], ids=["even", "padded"])
def test_plain_rounding_draws_each_ranks_slice_of_one_device(n):
    """Queue 3's "not copied" entry, quantized: on the plain path a JAX
    shard rounds with ``uniform(qkey, [3, n_local])``, the same local draws
    on every shard; a port rank rounds its rows with their columns of the
    one-device ``uniform(qkey, [3, n])``, so the ranks' int8 stats put
    together are the one-device stats (scales from the same amax). With
    ``n`` odd the group pads a zero row, and ``n_rows`` keeps the draw's
    row stride at the data's ``n``."""
    rng = np.random.default_rng(11)
    base = np.zeros((3, 1000), np.float32)
    base[:, :n] = rng.normal(size=(3, n))
    base[:, 0] = 4.0                # every half shares the channel's amax
    base[:, 500] = 4.0
    key = TH.quant_key(5, 2, 0)
    jkey = jnp.asarray(np.array(key, np.uint32))
    whole, _ = JH.quantize_stats(jnp.asarray(base[:, :n]), jkey)
    halves = [TG._quantize_for(torch.from_numpy(base[:, r * 500:
                                                     (r + 1) * 500].copy()),
                               key, _Rank(r, 2), n_rows=n)[0].numpy()
              for r in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves, axis=1)[:, :n],
                                  np.asarray(whole))
    shard1, _ = JH.quantize_stats(jnp.asarray(base[:, 500:]), jkey)
    assert not np.array_equal(np.asarray(shard1), halves[1])


def _node_inputs(seed, n, F, W, B):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(F, n)).astype(np.int32)
    pos = rng.integers(-1, W, size=n).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.9).astype(np.float32)
    base = np.stack([grad * mask, np.abs(grad) * 0.25 * mask, mask])
    return binned, pos, base.astype(np.float32)


@pytest.mark.parametrize("W,B", [(1, 63), (4, 31), (7, 255)])
def test_blocked_entry_equals_per_block_plain(W, B):
    binned, pos, base = _node_inputs(3, 960, 5, W, B)
    got = TH.node_histogram(torch.from_numpy(binned), torch.from_numpy(pos),
                            torch.from_numpy(base), W, B, blocks=8)
    assert got.shape == (8, 5, 3 * W, B)
    for j in range(8):
        rows = slice(j * 120, (j + 1) * 120)
        want = node_hist_plain(torch.from_numpy(binned[:, rows].copy()),
                               torch.from_numpy(pos[rows].copy()),
                               torch.from_numpy(base[:, rows].copy()), W, B)
        assert torch.equal(got[j], want), j
    jparts = np.stack([np.asarray(JH.node_histogram(
        jnp.asarray(binned[:, j * 120:(j + 1) * 120]),
        jnp.asarray(pos[j * 120:(j + 1) * 120]),
        jnp.asarray(base[:, j * 120:(j + 1) * 120]), W, B))
        for j in range(8)])
    np.testing.assert_allclose(got.numpy(), jparts, rtol=1e-5, atol=1e-6)


def test_blocked_quantized_entry_is_bit_equal_to_jax():
    binned, pos, base = _node_inputs(4, 960, 5, 3, 63)
    q, scales = JH.quantize_stats(jnp.asarray(base))
    q, scales = np.array(q), np.array(scales)
    got = TH.node_histogram(torch.from_numpy(binned), torch.from_numpy(pos),
                            torch.from_numpy(q), 3, 63,
                            scales=torch.from_numpy(scales), blocks=8)
    want = np.stack([np.asarray(JH.node_histogram(
        jnp.asarray(binned[:, j * 120:(j + 1) * 120]),
        jnp.asarray(pos[j * 120:(j + 1) * 120]),
        jnp.asarray(q[:, j * 120:(j + 1) * 120]), 3, 63,
        scales=jnp.asarray(scales))) for j in range(8)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocked_int8_guard_bounds_one_block(monkeypatch):
    """The int8 overflow guard bounds what one cell sums: a block's rows in
    the blocked route, all rows in the plain one. With a small int32 limit,
    stats at ``quant_q_max(rows per block)`` pass blocked and raise
    unblocked; one step past it raises blocked too."""
    monkeypatch.setattr(TH, "_INT32_CELL", 1200)
    binned, pos, base = _node_inputs(6, 960, 5, 3, 31)
    q_max = TH.quant_q_max(120)
    assert q_max == 10.0 and TH.quant_q_max(960) == 1.0
    q, scales = TH.quantize_stats(torch.from_numpy(base), q_max=q_max)
    assert int(q.abs().max()) == 10
    args = (torch.from_numpy(binned), torch.from_numpy(pos))
    got = TH.node_histogram(*args, q, 3, 31, scales=scales, blocks=8)
    want = node_hist_blocked_plain(*args, q, 3, 31, 8,
                                   acc_dtype=torch.int32)
    chan = scales[torch.arange(9) % 3]
    assert torch.equal(got, want.to(torch.float32) * chan[None, None, :,
                                                           None])
    with pytest.raises(ValueError, match="over 960 rows"):
        TH.node_histogram(*args, q, 3, 31, scales=scales)
    q[0, 0] = 11
    with pytest.raises(ValueError, match="over 120 rows"):
        TH.node_histogram(*args, q, 3, 31, scales=scales, blocks=8)
    # kernel 2's wrapper holds the stats to the cell it is given
    with pytest.raises(ValueError, match="over 120 rows"):
        TH._node_hist_int8_cuda(args[0], TH.blocks_as_nodes(args[1], 3, 8),
                                q, 24, 31, cell_rows=120)


def _fixed_point(base, blocks):
    """The deterministic mode's per-row values: ``[3, n]`` int64
    ``round(bf16(x) * 2^shift)`` of each row's block (0 where its (block,
    stat) is not finite), and the ``[blocks, 3]`` shifts."""
    shift = HS._det_shifts(torch.from_numpy(base), blocks).numpy()
    rows = base.shape[1] // blocks
    bf = torch.from_numpy(base).to(torch.bfloat16).to(torch.float64).numpy()
    row_shift = np.repeat(shift.T, rows, axis=1)
    ok = row_shift != HS.NONFINITE_SHIFT
    q = np.rint(np.ldexp(np.where(ok, bf, 0.0), np.where(ok, row_shift, 0)))
    return q.astype(np.int64), shift


def _to_f32(acc, shift):
    """An exact sum of one stat converted as the mode converts it: to f64,
    times 2^-shift, to f32; NaN where the stat has no shift."""
    if shift == HS.NONFINITE_SHIFT:
        return np.full(np.shape(acc), np.nan, np.float32)
    return np.ldexp(np.asarray(acc, np.int64).astype(np.float64),
                    -int(shift)).astype(np.float32)


def _emulate_det(binned, pos, base, W, B, blocks):
    """What ``csrc/node_hist_det.cu`` computes, in numpy: bf16-rounded
    stats scaled by 2^shift, rounded to int64, summed exactly, converted
    back with one rounding (NaN for a (block, stat) with a non-finite
    value)."""
    q_all, shift = _fixed_point(base, blocks)
    F, n = binned.shape
    rows = n // blocks
    out = np.zeros((blocks, F, 3 * W, B), np.float32)
    for j in range(blocks):
        sl = slice(j * rows, (j + 1) * rows)
        q = q_all[:, sl]
        acc = np.zeros((F, 3 * W, B), np.int64)
        for r in np.nonzero(pos[sl] >= 0)[0]:
            w = pos[sl][r]
            b = binned[:, sl][:, r].astype(np.int64)
            f = np.flatnonzero((b >= 0) & (b < B))   # bad ids add nothing
            for s in range(3):
                acc[f, 3 * w + s, b[f]] += q[s, r]
        assert np.abs(acc).max() < 2 ** 62 + rows
        for s in range(3):
            out[j, :, s::3] = _to_f32(acc[:, s::3], shift[j][s])
    return out


@pytest.mark.parametrize("scale", [1.0, 3e-12, 7e9])
def test_det_mode_fixed_point_is_within_the_plain_contract(scale):
    binned, pos, base = _node_inputs(5, 480, 3, 2, 31)
    base[0] *= scale
    got = _emulate_det(binned, pos, base, 2, 31, 4)
    want = node_hist_blocked_plain(torch.from_numpy(binned),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(base), 2, 31, 4).numpy()
    np.testing.assert_array_equal(got[:, :, 2::3], want[:, :, 2::3])
    for s in (0, 1):
        lim = 1e-4 * np.abs(want[:, :, s::3]).max() + 1e-4
        assert np.abs(got[:, :, s::3] - want[:, :, s::3]).max() <= lim


def _det_inputs(scale, n=480, F=3, W=2, B=31, blocks=4):
    """Node inputs with grad scaled by ``scale``; ``"non-finite"`` puts an
    inf into block 1's hess."""
    binned, pos, base = _node_inputs(5, n, F, W, B)
    if scale == "non-finite":
        base[1, n // blocks + 10] = np.inf
    else:
        base[0] *= scale
    return binned, pos, base


@pytest.mark.parametrize("scale", [1.0, 3e-12, 7e9, "non-finite"])
def test_det_plain_is_bit_equal_to_the_fixed_point_emulation(scale):
    """``node_hist_det_plain`` (int64 ``index_add_`` at ``_det_shifts``'s
    shifts), the kernel's plain version on the card, against the numpy
    emulation bit for bit; a non-finite block's stat comes out NaN."""
    binned, pos, base = _det_inputs(scale)
    got = node_hist_det_plain(torch.from_numpy(binned),
                              torch.from_numpy(pos),
                              torch.from_numpy(base), 2, 31, 4)
    assert got.dtype == torch.float32 and got.shape == (4, 3, 6, 31)
    want = _emulate_det(binned, pos, base, 2, 31, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    if scale == "non-finite":
        assert np.isnan(want[1, :, 1::3]).all()
        assert not np.isnan(np.delete(want[1], np.s_[1::3], axis=1)).any()
        assert not np.isnan(want[[0, 2, 3]]).any()


_M32 = (1 << 32) - 1


def _pair_add(cell, v):
    """One add of the (lo u32, hi i32) cell ``cell`` (a two-item list) as
    ``node_hist_common.cuh:add_fixed`` does it: the low word's add returns
    the old value, and the add wrapped where the new low word is below
    the added one; the high word and the carry go in only if not zero,
    with int32 wrap-around."""
    lo_v, hi_v = v & _M32, v >> 32
    if lo_v:
        cell[0] = (cell[0] + lo_v) & _M32
        hi_v += cell[0] < lo_v
    if hi_v:
        cell[1] = ((cell[1] + hi_v + 2 ** 31) & _M32) - 2 ** 31


def _segment_rows(row_block, rows, threads, row_blocks):
    """The rows of a segment one row block walks: vectors of
    ``_DET_ROWS`` rows in sweeps of ``threads``, sweep k to row block
    k % row_blocks; the last row block also takes the segment's rows
    after its last whole vector."""
    V = TH._DET_ROWS
    nv = rows // V
    sweep = np.arange(nv * V) // (V * threads)
    got = np.flatnonzero(sweep % row_blocks == row_block)
    if row_block == row_blocks - 1:
        got = np.concatenate([got, np.arange(nv * V, rows)])
    return got


def _emulate_det_cut(binned, pos, base, W, B, blocks, geo, seed):
    """The fixed-point mode of the histogram body in numpy, as
    ``_det_geometry``'s cut runs it: per (segment, feature group, node
    tile) item, per row block, a partial histogram of (lo, hi) cells whose
    adds come in a shuffled order; a cluster's partials folded in rank
    order; where the cluster owns the item, converted once and stored,
    else added into int64 partials converted at the end. Returns (the
    ``[blocks, F, 3W, B]`` f32 result, per-(item, row) visit counts)."""
    rng = np.random.default_rng(seed)
    q, shift = _fixed_point(base, blocks)
    F, n = binned.shape
    rows = n // blocks
    staged = TH._det_staged(geo)
    out = np.full((blocks, F, 3 * W, B), -1.0, np.float32)   # unwritten
    acc = np.zeros((blocks, F, 3 * W, B), np.int64)
    visits = np.zeros((geo.groups * geo.tiles, n), np.int64)
    for j in range(blocks):
        for y in range(geo.groups * geo.tiles):
            f0 = (y // geo.tiles) * geo.group
            w0 = (y % geo.tiles) * geo.node_tile
            g_n = min(geo.group, F - f0)
            tn = min(geo.node_tile, W - w0)
            for c0 in range(0, geo.row_blocks, geo.cluster):
                folded = np.zeros((g_n, 3 * tn, B), np.int64)
                for rb in range(c0, c0 + geo.cluster):
                    mine = j * rows + _segment_rows(rb, rows, geo.threads,
                                                    geo.row_blocks)
                    visits[y, mine] += 1
                    adds = [((g, 3 * (pos[r] - w0) + s, binned[f0 + g, r]),
                             int(q[s, r]))
                            for r in mine if 0 <= pos[r] - w0 < tn
                            for g in range(g_n) if 0 <= binned[f0 + g, r] < B
                            for s in range(3) if q[s, r]]
                    cells = {}
                    for k in rng.permutation(len(adds)):
                        at, v = adds[k]
                        _pair_add(cells.setdefault(at, [0, 0]), v)
                    for at, (lo, hi) in cells.items():   # rank order
                        folded[at] += (hi << 32) + lo
                f_sl = slice(f0, f0 + g_n)
                w_sl = slice(3 * w0, 3 * (w0 + tn))
                if staged:
                    acc[j, f_sl, w_sl] += folded
                else:
                    assert c0 == 0, "a cluster that owns its item is alone"
                    for s in range(3):
                        out[j, f_sl, w_sl][:, s::3] = _to_f32(
                            folded[:, s::3], shift[j][s])
    if staged:
        for j in range(blocks):
            for s in range(3):
                out[j, :, s::3] = _to_f32(acc[j, :, s::3], shift[j][s])
    return out, visits


def _mixed_inputs(seed, n, F, W, B):
    """Stats whose magnitudes within a block span six decades, signs
    mixed: many values with a non-zero low word, so the (lo, hi) cells
    carry."""
    binned, pos, base = _node_inputs(seed, n, F, W, B)
    rng = np.random.default_rng(seed + 1)
    base[0] *= 10.0 ** rng.uniform(-6, 0, size=n)
    base[1] *= 10.0 ** rng.uniform(-3, 0, size=n)
    base[0, ::97] = 0.0
    binned[0, ::13] = B + 2                      # ids outside [0, B) skip
    return binned, pos, base.astype(np.float32)


DET_CUTS = [
    # n, F, W, B, blocks, (group, node_tile, cluster, row_blocks, threads)
    (492, 5, 3, 31, 4, (2, 2, 2, 4, 32)),      # clusters of 2, partials
    (492, 5, 3, 31, 4, (3, 3, 4, 4, 32)),      # a cluster owns its item
    (486, 4, 2, 17, 2, (4, 1, 1, 3, 64)),      # single blocks, partials
    (396, 3, 4, 9, 3, (1, 4, 3, 3, 32)),       # a cluster of 3 owns it
    (240, 2, 1, 7, 8, (2, 1, 8, 8, 32)),       # rows below a sweep
]


@pytest.mark.parametrize("n,F,W,B,blocks,cut", DET_CUTS)
def test_det_cut_with_pair_cells_is_bit_equal(n, F, W, B, blocks, cut):
    """Whatever the cut and the order of adds, the fixed-point mode's (lo,
    hi) cells, cluster folds and int64 partials give ``_emulate_det``'s
    bits: every row is walked once per item."""
    group, tile, cluster, row_blocks, threads = cut
    geo = TH.NodeGeometry(group, tile, cluster, row_blocks, threads,
                          group * tile * 24 * B, -(-F // group),
                          -(-W // tile))
    binned, pos, base = _mixed_inputs(n + F, n, F, W, B)
    got, visits = _emulate_det_cut(binned, pos, base, W, B, blocks, geo,
                                   seed=n)
    assert (visits == 1).all(), "a row is walked twice or never"
    np.testing.assert_array_equal(got, _emulate_det(binned, pos, base, W, B,
                                                    blocks))


def test_det_cut_carries_and_wraps():
    """The (lo, hi) pair in isolation: sums whose low words wrap many times
    and high words that cross zero, in every order, equal the int64 sum."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        vals = [int(v) for v in rng.integers(-2 ** 45, 2 ** 45, size=40)]
        vals += [int(v) for v in rng.integers(-2 ** 33, 2 ** 33, size=40)]
        for order in (vals, vals[::-1], list(rng.permutation(vals))):
            cell = [0, 0]
            for v in order:
                _pair_add(cell, int(v))
            assert (cell[1] << 32) + cell[0] == sum(vals)


@pytest.mark.parametrize("W", [1, 16])
def test_det_chosen_cut_is_bit_equal(W):
    """``_det_geometry``'s own cut at a small shape (several items, row
    blocks and, at W=1, int64 partials across clusters)."""
    n, F, B, blocks = 8 * 3000, 6, 15, 8
    geo = TH._det_geometry(n // blocks, F, W, B, blocks)
    assert geo.row_blocks > 1 or W == 16
    binned, pos, base = _mixed_inputs(W, n, F, W, B)
    got, visits = _emulate_det_cut(binned, pos, base, W, B, blocks, geo,
                                   seed=W)
    assert (visits == 1).all()
    np.testing.assert_array_equal(got, _emulate_det(binned, pos, base, W, B,
                                                    blocks))


def _edge_stats(rows=16, blocks=6):
    """``[3, rows * blocks]`` stats whose blocks reach the shift rule's
    edges: all zero; a subnormal largest value; a finite value that rounds
    to inf in bf16; an inf; a NaN; ordinary values (the edges in stat 1,
    stats 0 and 2 ordinary)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(3, rows * blocks)).astype(np.float32)
    b = base[1].reshape(blocks, rows)
    b[0] = 0.0
    b[1] = np.float32(3e-39) * rng.uniform(-1, 1, size=rows)
    b[2, 3] = np.float32(3.4e38)
    b[3, 5] = -np.inf
    b[4, 7] = np.nan
    return base


def test_det_shifts_from_the_largest_bits():
    """The library derives each shift from the bits of the block's largest
    |f32 stat| (``node_hist_det.cu:amax_bits``, an atomicMax over the
    bits; ``node_hist_common.cuh:FixedStats::shift_of``): round that value
    to bf16, NaN-or-inf gets no shift, else 62 - ceil(log2(rows)) - its
    frexp exponent. The same shifts as ``_det_shifts`` at every edge."""
    base = _edge_stats()
    rows, blocks = 16, 6
    bits = np.abs(base).view(np.uint32).reshape(3, blocks, rows).max(axis=2).T
    a = torch.from_numpy(bits.copy().view(np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()
    with np.errstate(invalid="ignore"):
        e = np.frexp(a)[1]
    want = np.where(np.isfinite(a), 62 - 4 - e, HS.NONFINITE_SHIFT)
    got = HS._det_shifts(torch.from_numpy(base), blocks).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[[2, 3, 4], 1] == HS.NONFINITE_SHIFT).all()
    assert got[0, 1] == 62 - 4 and got[1, 1] > 62 + 120


def test_det_plain_at_the_shift_edges():
    """``node_hist_det_plain`` at those edges against the emulation."""
    base = _edge_stats()
    n = base.shape[1]
    rng = np.random.default_rng(12)
    binned = rng.integers(0, 9, size=(2, n)).astype(np.int32)
    pos = rng.integers(-1, 3, size=n).astype(np.int32)
    got = node_hist_det_plain(torch.from_numpy(binned),
                              torch.from_numpy(pos), torch.from_numpy(base),
                              3, 9, 6).numpy()
    np.testing.assert_array_equal(got, _emulate_det(binned, pos, base, 3, 9,
                                                    6))
    assert np.isnan(got[[2, 3, 4]][:, :, 1::3]).all()
    assert not np.isnan(got[[0, 1, 5]]).any()


def test_det_shifts_flag_non_finite_blocks():
    base = np.ones((3, 64), np.float32)
    base[1, 40] = np.inf
    shift = HS._det_shifts(torch.from_numpy(base), 4)
    # 16 rows a block, largest |stat| 1 < 2^1: shift 62 - 4 - 1
    assert shift[2, 1] == -2 ** 31 and (shift[[0, 1, 3]] == 57).all()
    assert (shift[:, [0, 2]] == 57).all()


def _det_wave(geo, blocks):
    """Clusters of ``geo``'s size an H100 holds at once at its shared
    memory (``_DET_CLUSTERS_HELD``), and the clusters its grid asks for."""
    per_sm = min(2, TH._SM_SMEM // (geo.smem + TH._BLOCK_RESERVE))
    held = TH._DET_CLUSTERS_HELD[per_sm][geo.cluster]
    return held, blocks * geo.groups * geo.tiles * geo.row_blocks // \
        geo.cluster


def test_det_geometry_depends_on_the_shape_alone(monkeypatch):
    """8-byte cells (``smem == group * tile * 24 * B``); the grid one wave
    of the clusters an H100 holds (``_DET_CLUSTERS_HELD``) where the items
    allow it; nothing asked of a card."""
    def no_card(*a):
        raise AssertionError("the deterministic geometry asked the card")
    monkeypatch.setattr(TH, "_num_sms_of", no_card)
    monkeypatch.setattr(TH, "_clusters_held", no_card)
    a = TH._det_geometry(125_000, 28, 16, 255, 8)
    assert a == TH._det_geometry(125_000, 28, 16, 255, 8)
    assert a.smem == a.group * a.node_tile * 24 * 255 <= TH._SMEM_MAX
    held, asked = _det_wave(a, 8)
    assert asked <= held
    root = TH._det_geometry(125_000, 28, 1, 255, 8)
    assert root.groups * root.group >= 28 and root.row_blocks > 1
    held, asked = _det_wave(root, 8)
    assert asked <= held
    # leafwise's 16 children: one feature of 16 nodes a block (97,920
    # bytes, two blocks an SM), 224 items, one row block each, which owns
    # its item; the root: groups of 7 features (42,840 bytes), 8 row blocks
    # an item in pairs (32 items need 128 pairs of the 132 held; clusters
    # of 8 would need 32 of the 30 held), so int64 partials
    assert (a.group, a.node_tile, a.cluster, a.row_blocks, a.threads) == (
        1, 16, 1, 1, 512) and not TH._det_staged(a)
    assert (root.group, root.groups, root.cluster, root.row_blocks,
            root.smem) == (7, 4, 2, 8, 42_840) and TH._det_staged(root)


@pytest.mark.parametrize("F,n", [(28, 1_000_000), (54, 581_016),
                                 (136, 1_280_000)])
def test_det_geometry_at_the_path_shapes(F, n):
    """Phases 14's (F=28), 6's (F=54, rows padded to 8 blocks) and 7's
    (F=136) shapes in 8 blocks, W from 1 to 16, B=255: every geometry fits
    the shared memory, covers each (feature, node) once, has a cluster of
    at most 8 that divides its row blocks (and owns its item exactly when
    it spans them), stays within a grid's 2^31-1 blocks and one wave of
    whole clusters where the items allow, and gives every row block the
    same sweeps."""
    blocks, B = 8, 255
    rows = n // blocks
    for W in range(1, 17):
        geo = TH._det_geometry(rows, F, W, B, blocks)
        assert geo.smem == geo.group * geo.node_tile * 24 * B
        assert 0 < geo.smem <= TH._SMEM_MAX
        assert geo.groups == -(-F // geo.group)
        assert geo.tiles == -(-W // geo.node_tile)
        seen = np.zeros((F, W), np.int64)
        for y in range(geo.groups * geo.tiles):
            f0 = (y // geo.tiles) * geo.group
            w0 = (y % geo.tiles) * geo.node_tile
            assert f0 < F and w0 < W
            seen[f0:f0 + geo.group, w0:w0 + geo.node_tile] += 1
        assert (seen == 1).all()
        assert 1 <= geo.cluster <= 8
        assert geo.row_blocks % geo.cluster == 0
        assert TH._det_staged(geo) == (geo.row_blocks > geo.cluster)
        grid = blocks * geo.groups * geo.tiles * geo.row_blocks
        assert grid <= 2 ** 31 - 1
        held, asked = _det_wave(geo, blocks)
        assert asked <= held or geo.row_blocks == 1
        assert 32 <= geo.threads <= 512 and geo.threads % 32 == 0
        nv = rows // TH._DET_ROWS
        sweeps = -(-nv // geo.threads)
        assert -(-sweeps // geo.row_blocks) == -(-nv // (
            geo.row_blocks * 512))
        assert geo == TH._det_geometry(rows, F, W, B, blocks)


def test_det_geometry_refuses_what_the_body_refuses():
    with pytest.raises(ValueError, match="shared memory"):
        TH._det_geometry(1000, 4, 1, 9_686, 2)
    assert TH._det_geometry(1000, 4, 1, 9_685, 2).smem <= TH._SMEM_MAX


def test_det_wrapper_passes_the_c_arguments_in_order(monkeypatch):
    """mm_node_hist_det(binned, bin_bytes, pos, base, amax, acc, out, n,
    blocks, F, W, B, group, tile, cluster, row_blocks, threads, stream): no
    int64 partials where each cluster owns its item, a buffer where it does
    not."""
    calls = []
    monkeypatch.setattr(TH, "_launch", lambda kernel, entry, args, dev:
                        calls.append((kernel, entry, args)))
    n, F, W, B = 64, 3, 2, 7
    binned = torch.zeros(F, n, dtype=torch.int16)
    pos = torch.zeros(n, dtype=torch.int32)
    base = torch.ones(3, n)
    owned = TH.NodeGeometry(2, 2, 4, 4, 32, 2 * 2 * 24 * B, 2, 1)
    staged = owned._replace(cluster=2)
    out = TH._node_hist_det_cuda(binned, pos, base, W, B, 4,
                                 geometry=owned)
    assert out.shape == (4, F, 3 * W, B) and out.dtype == torch.float32
    TH._node_hist_det_cuda(binned, pos, base, W, B, 4, geometry=staged)
    (k0, e0, a0), (_, _, a1) = calls
    assert (k0, e0) == ("node_hist_det", "mm_node_hist_det")
    values = [v for _, v in a0]
    assert values[1] == 2 and values[5] is None
    assert values[7:] == [n, 4, F, W, B, 2, 2, 4, 4, 32]
    assert a1[5][1] is not None and [v for _, v in a1][-4:] == [2, 2, 4, 32]
    assert TH.node_histogram.det_launches >= 2


def test_exact_block_sums_round_the_exact_sum_once():
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(3, 800)) * np.array([[1.0], [1e-3], [1e4]])
         ).astype(np.float32)
    seg = rng.integers(0, 5, size=800)
    got = TG._exact_block_sums(torch.from_numpy(x), 4,
                               torch.from_numpy(seg), 5).numpy()
    for j in range(4):
        for c in range(3):
            for k in range(5):
                sl = slice(j * 200, (j + 1) * 200)
                v = x[c, sl][seg[sl] == k].astype(np.float64)
                np.testing.assert_allclose(got[j, c, k], np.float32(
                    np.sum(v)), rtol=1e-7, atol=1e-9)
    plain = TG._exact_block_sums(torch.from_numpy(x), 4).numpy()[:, :, 0]
    np.testing.assert_allclose(plain, x.reshape(3, 4, 200).astype(
        np.float64).sum(axis=2).T.astype(np.float32), rtol=1e-7)


def test_exact_block_sums_flag_non_finite_blocks():
    """A block holding a non-finite value sums to NaN in that channel
    alone; the shifts are the deterministic mode's."""
    x = np.ones((2, 64), np.float32)
    x[1, 20] = np.inf
    got = TG._exact_block_sums(torch.from_numpy(x), 4).numpy()[:, :, 0]
    assert np.isnan(got[1, 1])
    got[1, 1] = 16.0
    np.testing.assert_array_equal(got, np.full((4, 2), 16.0, np.float32))
    shift = HS.fixed_point_shifts(torch.tensor([1.0, 0.75, np.inf]), 16)
    assert shift.tolist() == [57, 58, HS.NONFINITE_SHIFT]


def test_blocked_quantized_totals_widen_before_the_fold():
    """Per-block quantized sums accumulate in int32 and widen to f32 before
    the cross-block fold (the JAX package's test of the same name)."""
    base = torch.ones((3, 64), dtype=torch.int8) * 3
    qs = torch.tensor([0.5, 0.5, 0.5])
    tot = TG._stat_totals(base, qs, None, 8, 8)
    want = np.asarray(JG._stat_totals(jnp.ones((3, 64), jnp.int8) * 3,
                                      jnp.asarray([0.5, 0.5, 0.5]), None, 8,
                                      8))
    assert tot.dtype == torch.float32
    np.testing.assert_array_equal(tot.numpy(), want)


def test_block_geometry_mirrors_jax():
    for hb in ("auto", 0, 8):
        assert TG._hist_block_geometry(TG.GrowConfig(hist_blocks=hb), None,
                                       960) == JG._hist_block_geometry(
            JG.GrowConfig(hist_blocks=hb), None, 960)
    with pytest.raises(ValueError, match="tile"):
        TG._hist_block_geometry(TG.GrowConfig(hist_blocks=7), None, 960)
    with pytest.raises(ValueError, match="voting"):
        TG._hist_block_geometry(TG.GrowConfig(hist_blocks=8, voting=True),
                                None, 960)


def test_blocked_reduction_turns_subtraction_off():
    cfg = TG.resolve_growth_backend(TG.GrowConfig())
    assert TG._use_subtraction(cfg, 20_000)
    assert not TG._use_subtraction(cfg._replace(hist_blocks=8), 20_000)
    assert not TG._use_subtraction(cfg._replace(voting=True), 20_000)
    assert not TG._use_subtraction(cfg, 20_000, group=object())
