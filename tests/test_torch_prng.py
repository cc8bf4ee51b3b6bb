"""The port's random streams (``mmlspark_tpu_torch/utils/prng.py``) against
``jax.random`` on the CPU.

* ``prng_key``, ``fold_in`` and ``split`` give JAX's key words, bit for
  bit; ``bits`` and ``uniform`` JAX's draws at the shapes the port draws
  (rows, ``[3, n]`` rounding stats, ``[F]`` feature subsets, ALS factors),
  and a slice from ``start`` (and ``stride``) is JAX's draw sliced.
* ``normal`` is within 4 f32 ulps of ``jax.random.normal`` at the CNN's
  and the transformer's shapes (its ``log1p`` is taken in f64, where XLA
  has its own f32 approximation), and its bytes do not depend on how the
  draw is chunked.
* The stream reproduced is JAX's partitionable threefry
  (``jax_threefry_partitionable``): a JAX upgrade that changes it fails
  here first.
* ``chip_smoke.PRNG_GOLDEN``, the hashes phase 21 holds the card's draws
  to, are the sha256 of JAX's own draws for phase 21's keys, and the
  port's CPU draws hash to them too.
* Fresh initialisers: the CNNs of the ``builtin://`` catalog and
  ``transformer.init_params`` against the JAX package's, within 4 ulps
  (the transformer's in ``tests/test_torch_transformer.py``).
"""

import ast
import hashlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import f32_ulps
from mmlspark_tpu.models.dnn import cnn as JC
from mmlspark_tpu.models.dnn import downloader as jdl
from mmlspark_tpu_torch.models.dnn import cnn as TC
from mmlspark_tpu_torch.models.dnn import downloader as tdl
from mmlspark_tpu_torch.models.dnn.convert import params_to_jax
from mmlspark_tpu_torch.utils import prng

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 42, -3, 2 ** 31 + 5, 0xDEADBEEF]
NORMAL_ULPS = 4


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


def test_the_reproduced_stream_is_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    key = prng.prng_key(seed)
    assert key == _words(jax.random.PRNGKey(seed))
    for data in (0, 7, 13, 1_000_003, 2 ** 32 - 1):
        assert prng.fold_in(key, data) == _words(
            jax.random.fold_in(jax.random.PRNGKey(seed), data))


@pytest.mark.parametrize("num", [2, 4, (3, 6), (1, 6)])
def test_split_equals_jax(num):
    jkey = jax.random.fold_in(jax.random.PRNGKey(8), 3)
    want = np.asarray(jax.random.split(jkey, num)).astype(np.int64)
    got = prng.split(_words(jkey), num)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # a key held as a tensor row splits the same
    first = prng.split(got.reshape(-1, 2)[0], 2)
    np.testing.assert_array_equal(first.numpy(), np.asarray(
        jax.random.split(jnp.asarray(want.reshape(-1, 2)[0], jnp.uint32),
                         2)).astype(np.int64))


SHAPES = {"rows": (1999,), "stats": (3, 1001), "features": (28,),
          "factors": (37, 10), "scalar_row": (1,)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 5, -1])
def test_bits_and_uniform_bit_equal_to_jax(shape, seed):
    shape = SHAPES[shape]
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    key = _words(jkey)
    np.testing.assert_array_equal(
        prng.bits(key, shape, device="cpu").numpy(),
        np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    u = prng.uniform(key, shape, device="cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jax.random.uniform(jkey, shape)))


def test_uniform_bounds_equal_jax():
    jkey = jax.random.PRNGKey(3)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    for a, b in ((lo, 1.0), (-2.5, 4.0), (0.25, 0.5)):
        np.testing.assert_array_equal(
            prng.uniform(_words(jkey), (4001,), device="cpu", minval=a,
                         maxval=b).numpy(),
            np.asarray(jax.random.uniform(jkey, (4001,), minval=a,
                                          maxval=b)))


def test_a_slice_from_start_is_the_jax_draw_sliced():
    jkey = jax.random.PRNGKey(11)
    key = _words(jkey)
    n = 300_001
    rows = np.asarray(jax.random.uniform(jkey, (n,)))
    np.testing.assert_array_equal(
        prng.uniform(key, (1000,), start=150_000, device="cpu").numpy(),
        rows[150_000:151_000])
    stats = np.asarray(jax.random.uniform(jkey, (3, n)))
    got = prng.uniform(key, (3, 777), start=299_224, stride=n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), stats[:, 299_224:])
    # the host draws chunks of 2^18 counters: the whole draw is unchanged
    np.testing.assert_array_equal(
        prng.uniform(key, (3, n), device="cpu").numpy(), stats)


NORMAL_SHAPES = {"stem": (7, 7, 3, 16), "conv": (3, 3, 32, 32),
                 "head": (256, 10), "wqkv": (64, 4, 48),
                 "embed": (512, 64), "long": (300_000,)}


@pytest.mark.parametrize("shape", sorted(NORMAL_SHAPES))
def test_normal_within_four_ulps_of_jax(shape):
    shape = NORMAL_SHAPES[shape]
    jkey = jax.random.fold_in(jax.random.PRNGKey(19), len(shape))
    got = prng.normal(_words(jkey), shape, device="cpu")
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.isfinite(got.numpy()).all()
    assert f32_ulps(got.numpy(), want) <= NORMAL_ULPS


def _chip_constants() -> dict:
    """The literal constants of ``chip_smoke.py`` that phase 21 draws
    with, read without running the script."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", "")
            if name in ("PRNG_GOLDEN", "P21_SEED", "P21_ROWS",
                        "P21_BAG_STEP", "P21_ROUND", "P21_RANK_START"):
                out[name] = ast.literal_eval(node.value)
    return out


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        a, dtype="<f4").tobytes()).hexdigest()


def test_chip_smoke_golden_hashes_are_jax_draws():
    """Phase 21a holds the card's draws to ``PRNG_GOLDEN``: these are
    JAX's own draws for its keys, and the port's CPU draws equal them."""
    c = _chip_constants()
    seed, n = c["P21_SEED"], c["P21_ROWS"]
    it, klass = c["P21_ROUND"]
    start = c["P21_RANK_START"]
    base = jax.random.PRNGKey(seed)
    rkey = jax.random.fold_in(jax.random.fold_in(
        base, 1_000_003 + c["P21_BAG_STEP"]), 0)
    qkey = jax.random.fold_in(jax.random.fold_in(base, it), 13 + klass)
    rows = np.asarray(jax.random.uniform(rkey, (n,)))
    stats = np.asarray(jax.random.uniform(qkey, (3, n)))
    want = {"row_uniforms": _sha(rows), "round_uniforms": _sha(stats),
            "rank_slice": _sha(stats[:, start:])}
    assert c["PRNG_GOLDEN"] == want
    from mmlspark_tpu_torch.models.gbdt.booster import _row_uniforms
    from mmlspark_tpu_torch.ops.histogram import quant_key
    key = quant_key(seed, it, klass)
    got = {"row_uniforms": _row_uniforms(seed, c["P21_BAG_STEP"], n,
                                         device="cpu"),
           "round_uniforms": prng.uniform(key, (3, n), device="cpu"),
           "rank_slice": prng.uniform(key, (3, n - start), start=start,
                                      stride=n, device="cpu")}
    assert {k: _sha(v.numpy()) for k, v in got.items()} == want


def _payload(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["ResNet10Micro", "ResNet50Tiny",
                                  "AlexNetTiny", "ConvNetMNIST"])
def test_fresh_builtin_is_the_jax_builtin(name, tmp_path):
    """A fresh ``builtin://`` model: every weight within 4 ulps of the JAX
    package's fresh builtin (the same payload keys), and its logits within
    the converted-weights tolerance of ``tests/test_torch_dnn.py`` (1e-5 of
    the largest magnitude)."""
    mine = _payload(tdl.ModelDownloader(str(tmp_path / "t"))
                    ._materialize_builtin(name))
    theirs = _payload(jdl.ModelDownloader(str(tmp_path / "j"))
                      ._materialize_builtin(name))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
        if v.dtype == np.float32:
            assert f32_ulps(mine[k], v) <= NORMAL_ULPS, k
        else:
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    spec = jdl._BUILTIN[name]
    hw = spec["input_hw"]
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    jtree = jdl.ModelDownloader(str(tmp_path / "j"))
    jtree.download_model(name)
    jparams, jcfg, japply = jtree.load_model(name)
    ttree = tdl.ModelDownloader(str(tmp_path / "t"))
    ttree.download_model(name)
    tparams, tcfg, tapply = ttree.load_model(name)
    jl, _ = japply(jparams, jnp.asarray(x))
    tl, _ = tapply(tparams, torch.from_numpy(x))
    want = np.asarray(jl, np.float32)
    err = float(np.abs(tl.numpy() - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1e-6), err


def test_init_cnn_params_is_the_jax_init():
    jc = JC.CNNConfig(num_classes=5, stage_sizes=(1, 2), width=4,
                      block="bottleneck")
    tc = TC.CNNConfig(num_classes=5, stage_sizes=(1, 2), width=4,
                      block="bottleneck")
    flat_w = tdl._flatten(jax.tree_util.tree_map(
        np.asarray, JC.init_cnn_params(jc, jax.random.PRNGKey(9))))
    flat_g = tdl._flatten(params_to_jax(TC.init_cnn_params(
        tc, prng.prng_key(9))))
    assert sorted(flat_w) == sorted(flat_g)
    for k, v in flat_w.items():
        assert flat_g[k].shape == v.shape, k
        assert f32_ulps(flat_g[k], v) <= NORMAL_ULPS, k
