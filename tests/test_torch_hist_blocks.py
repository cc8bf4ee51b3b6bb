"""The deterministic blocked reduction (``GrowConfig.hist_blocks``): the
PyTorch port against itself across world sizes and against the JAX package.

  * The JAX package's four identity configurations
    (``tests/test_placement.py``: depthwise, leafwise, categorical,
    quantized; 960 rows, ``hist_blocks=8``, 2 rounds) fit in the port at
    world sizes 1, 2 and 4 (gloo processes on the CPU, ``file://``
    rendezvous): every rank's ``model_string()`` is byte-equal to the
    one-process fit's.
  * The same configurations against the JAX package on a one-device mesh:
    identical trees, margins within 1e-5 (quantized: both sides round to
    nearest, as the other quantized parity tests patch them, since the two
    packages' rounding keys differ).
  * The blocked histogram entry (``node_histogram(..., blocks=)``) on the
    CPU against per-block plain histograms (bit-equal) and the JAX
    package's blocked partials (bf16: 1e-5 relative; int8: bit-equal).
  * The fixed-point arithmetic of kernel 1's deterministic mode, emulated
    in numpy from ``_det_shifts``: every block sum stays below 2^63 and the
    result is within the kernel-vs-plain contract of ``chip_smoke.py``
    (grad/hess within 1e-4 of the channel's largest magnitude plus 1e-4,
    counts bit-equal).
  * The exact block sums behind the blocked totals and leaf renewal.
  * Bagging (each rank draws its slice of the global stream) and DART are
    byte-equal across world sizes too; validation metrics, summed over
    the group, agree within 1e-6 relative (the JAX package's scope note:
    their last ulp may follow the world size), on the same trees.
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
from mmlspark_tpu_torch.ops.histogram_scatter import (node_hist_blocked_plain,
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
def test_blocked_fits_match_jax_one_device(monkeypatch, tag):
    jq, tq = JG._quantize_for, TG._quantize_for
    monkeypatch.setattr(JG, "_quantize_for", lambda cfg, base_t, qkey, *a:
                        jq(cfg, base_t, None, *a))
    monkeypatch.setattr(TG, "_quantize_for", lambda base_t, qkey, *a:
                        tq(base_t, None, *a))
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


def _emulate_det(binned, pos, base, W, B, blocks):
    """What ``csrc/node_hist_det.cu`` computes, in numpy: bf16-rounded
    stats scaled by 2^shift, rounded to int64, summed exactly, converted
    back with one rounding."""
    shift = TH._det_shifts(torch.from_numpy(base), blocks).numpy()
    F, n = binned.shape
    rows = n // blocks
    bf = torch.from_numpy(base).to(torch.bfloat16).to(torch.float64).numpy()
    out = np.zeros((blocks, F, 3 * W, B), np.float32)
    for j in range(blocks):
        sl = slice(j * rows, (j + 1) * rows)
        q = np.rint(np.ldexp(bf[:, sl], shift[j][:, None])).astype(np.int64)
        acc = np.zeros((F, 3 * W, B), np.int64)
        for r in np.nonzero(pos[sl] >= 0)[0]:
            w = pos[sl][r]
            for s in range(3):
                acc[np.arange(F), 3 * w + s, binned[:, sl][:, r]] += q[s, r]
        assert np.abs(acc).max() < 2 ** 62 + rows
        for s in range(3):
            out[j, :, s::3] = np.ldexp(acc[:, s::3].astype(np.float64),
                                       -shift[j][s]).astype(np.float32)
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


def test_det_shifts_flag_non_finite_blocks():
    base = np.ones((3, 64), np.float32)
    base[1, 40] = np.inf
    shift = TH._det_shifts(torch.from_numpy(base), 4)
    # 16 rows a block, largest |stat| 1 < 2^1: shift 62 - 4 - 1
    assert shift[2, 1] == -2 ** 31 and (shift[[0, 1, 3]] == 57).all()
    assert (shift[:, [0, 2]] == 57).all()


def test_det_geometry_depends_on_the_shape_alone():
    a = TH._det_geometry(125_000, 28, 16, 255, 8)
    assert a == TH._det_geometry(125_000, 28, 16, 255, 8)
    assert a.smem == a.group * a.node_tile * 24 * 255 <= TH._SMEM_MAX
    assert a.row_blocks * a.groups * a.tiles * 8 <= 2 * TH._DET_SMS
    root = TH._det_geometry(125_000, 28, 1, 255, 8)
    assert root.groups * root.group >= 28 and root.row_blocks > 1


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
    shift = TH.fixed_point_shifts(torch.tensor([1.0, 0.75, np.inf]), 16)
    assert shift.tolist() == [57, 58, TH.NONFINITE_SHIFT]


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
