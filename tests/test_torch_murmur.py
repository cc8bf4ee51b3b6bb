"""The port's MurmurHash3 is the JAX package's, bit for bit.

Hashing defines feature identity (the VW featurizer, ``Featurize``'s hashed
columns, ``HashingTF``), so the port's native ``murmur3_32`` and
``murmur3_batch`` must equal its plain Python body (``murmur3_32_plain``)
and the JAX package's ``murmur3_32`` on the public reference vectors,
UTF-8 strings and 1,000 random byte strings from a seed.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import murmur as jmurmur
from mmlspark_tpu_torch.ops import murmur as tmurmur

torch.set_num_threads(1)

VECTORS = [(b"", 0, 0), (b"", 1, 0x514E28B7), (b"", 0xFFFFFFFF, 0x81F16F39),
           (b"\xff\xff\xff\xff", 0, 0x76293B50), (b"!Ce\x87", 0, 0xF55B516B),
           (b"Hello, world!", 0x9747B28C, 0x24884CBA)]

UTF8 = ["abc", "", "héllo wörld", "日本語のテキスト", "emoji 🙂🙃", "a" * 37,
        "paris", "features_city_rome", "0", "12345", "x y\tz\n"]


def _random_bytes(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 70, size=n)
    seeds = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
    return ([rng.integers(0, 256, size=k, dtype=np.uint8).tobytes()
             for k in lens], [int(s) for s in seeds])


@pytest.mark.parametrize("data,seed,want", VECTORS)
def test_reference_vectors(data, seed, want):
    assert tmurmur.murmur3_32(data, seed) == want
    assert tmurmur.murmur3_32_plain(data, seed) == want
    assert jmurmur.murmur3_32(data, seed) == want


@pytest.mark.parametrize("s", UTF8)
def test_utf8_strings_equal_plain_and_jax(s):
    for seed in (0, 1, 0x9747B28C):
        got = tmurmur.murmur3_32(s, seed)
        assert got == tmurmur.murmur3_32(s.encode("utf-8"), seed)
        assert got == tmurmur.murmur3_32_plain(s, seed)
        assert got == jmurmur.murmur3_32(s, seed)


def test_random_bytes_scalar_and_batch():
    datas, seeds = _random_bytes()
    plain = np.asarray([tmurmur.murmur3_32_plain(d, s)
                        for d, s in zip(datas, seeds)], np.uint32)
    scalar = np.asarray([tmurmur.murmur3_32(d, s)
                         for d, s in zip(datas, seeds)], np.uint32)
    jax_side = np.asarray([jmurmur.murmur3_32(d, s)
                           for d, s in zip(datas, seeds)], np.uint32)
    batch = tmurmur.murmur3_batch(datas, seeds)
    assert batch.dtype == np.uint32
    np.testing.assert_array_equal(scalar, plain)
    np.testing.assert_array_equal(batch, plain)
    np.testing.assert_array_equal(jax_side, plain)


def test_batch_past_the_pool_threshold_equals_the_jax_batch():
    """65,536 strings and more fan out over the worker pool."""
    from mmlspark_tpu.native import murmur3_batch as jbatch
    strings = [f"w{i}_{i * 7919 % 1000}" for i in range(70_000)]
    seeds = [(i * 2654435761) & 0xFFFFFFFF for i in range(70_000)]
    got = tmurmur.murmur3_batch(strings, seeds)
    np.testing.assert_array_equal(got, jbatch(strings, seeds))
    for i in (0, 1, 65_535, 65_536, 69_999):
        assert got[i] == tmurmur.murmur3_32_plain(strings[i], seeds[i])


def test_hash_feature_namespace_and_mask_equal_jax():
    ns = tmurmur.hash_namespace("", 7)
    assert ns == jmurmur.hash_namespace("", 7)
    for name in ("42", "city_paris", "0", "héllo", "007"):
        assert tmurmur.hash_feature(name, ns) == jmurmur.hash_feature(name, ns)
    assert tmurmur.hash_feature("42", 100) == 142
    assert tmurmur.mask_bits(0xFFFFFFFF, 18) == (1 << 18) - 1
    h = np.asarray([0xFFFFFFFF, 12345678], np.int64)
    np.testing.assert_array_equal(tmurmur.mask_bits(h, 10),
                                  jmurmur.mask_bits(h, 10))


def test_batch_refuses_mismatched_seeds():
    with pytest.raises(ValueError, match="seeds"):
        tmurmur.murmur3_batch(["a", "b"], [0])
