"""Out-of-core ingest: ``.npy`` shards -> the binned matrix, against the
in-memory construct and the JAX package.

The binner of ``construct(path=...)`` is fit on the rows the in-memory
construct samples (the JAX package gathers them from the files in sorted
order, the port's in-memory binner takes them in draw order; the quantiles
do not depend on the order), so bin bounds and bins are bit-equal to the
in-memory ones and to the JAX package's ``construct_from_files`` on its
valid columns ``[:, :n]`` (one-device mesh), and a fit on either dataset
grows the same trees. Over 2 gloo ranks each rank reads only its padded
row range (rank 0 also the binner's sample) and holds its slice of the
in-memory 2-rank construct bit for bit, bounds and valid columns equal to
the JAX package's on a two-device mesh. Also: ``csv_to_shards`` through
the C++ CSV reader, the argument checks of ``construct``, host-side
quantization (``MMLSPARK_TPU_INGEST_HOST_QUANT=1``) and the shard reader.
"""

import os

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.models.gbdt.ingest import \
    construct_from_files as jconstruct_from_files
from mmlspark_tpu.models.gbdt.ingest import csv_to_shards as jcsv_to_shards
from _torch_ranks import run_ranks
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models.gbdt.booster import (LightGBMDataset,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.models.gbdt.ingest import (INGEST_HOST_QUANT_ENV,
                                                   ShardedMatrixSource,
                                                   csv_to_shards,
                                                   host_quant_enabled,
                                                   write_shards)
from mmlspark_tpu_torch.native import csv_read_floats

torch.set_num_threads(1)

def _data(n=5000, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.02] = np.nan
    X[:, 3] = rng.integers(0, 7, size=n)
    y = ((np.nan_to_num(X[:, 0]) + 0.5 * (X[:, 3] % 2)) > 0.3).astype(
        np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, w


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    X, y, w = _data()
    write_shards([X[:1700], X[1700:3100], X[3100:]], d / "x")
    write_shards([y[:2500], y[2500:]], d / "y")
    write_shards([w], d / "w")
    return d, X, y, w


KW = dict(max_bin=63, bin_sample_count=3000, seed=3,
          categorical_features=(3,))


@pytest.mark.parametrize("chunk_rows", [999, 4096, 100_000])
def test_out_of_core_equals_in_memory(shards, chunk_rows):
    d, X, y, w = shards
    ds = LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                   weight_path=str(d / "w"),
                                   chunk_rows=chunk_rows, device="cpu", **KW)
    dm = LightGBMDataset.construct(X, y, w, bin_dtype="uint8", device="cpu",
                                   **KW)
    assert ds.Xbt.dtype == torch.uint8 and ds.n == ds.n_pad == len(y)
    np.testing.assert_array_equal(ds.binner.upper_bounds,
                                  dm.binner.upper_bounds)
    assert torch.equal(ds.Xbt, dm.Xbt)
    for a, b in ((ds.y, dm.y), (ds.w, dm.w), (ds.vmask, dm.vmask)):
        assert torch.equal(a, b)
    assert ds.categorical_features == (3,)


def test_binner_sample_order_does_not_matter(shards):
    # the sorted gather of the files against the draw order in memory
    d, X, _, _ = shards
    from mmlspark_tpu_torch.models.gbdt.ingest import fit_binner_from_source
    from mmlspark_tpu_torch.ops.binning import QuantileBinner
    src = ShardedMatrixSource(str(d / "x"))
    a = fit_binner_from_source(src, max_bin=63, bin_sample_count=3000,
                               seed=11)
    b = QuantileBinner(63, 3000, 11).fit(X)
    np.testing.assert_array_equal(a.upper_bounds, b.upper_bounds)


def test_matches_jax_construct_from_files(shards):
    d, X, y, w = shards
    ds = LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                   weight_path=str(d / "w"), chunk_rows=1234,
                                   device="cpu", **KW)
    jd = jconstruct_from_files(str(d / "x"), str(d / "y"), str(d / "w"),
                               chunk_rows=1234,
                               mesh=make_mesh(devices=jax.devices()[:1]),
                               **KW)
    n = len(y)
    np.testing.assert_array_equal(ds.binner.upper_bounds,
                                  jd.binner.upper_bounds)
    np.testing.assert_array_equal(ds.Xbt.numpy(),
                                  np.asarray(jd.Xbt_d)[:, :n])
    np.testing.assert_array_equal(ds.w.numpy(), np.asarray(jd.w_d)[:n])


@pytest.mark.parametrize("quantized", [False, True])
def test_fit_from_shards_grows_the_in_memory_trees(shards, quantized):
    d, X, y, _ = shards
    ds = LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                   chunk_rows=2048, device="cpu", **KW)
    dm = LightGBMDataset.construct(X, y, device="cpu", **KW)
    assert dm.Xbt.dtype == torch.int32
    cfg = GrowConfig(num_leaves=15, min_data_in_leaf=40,
                     quantized_grad=quantized, quant_warmup_iters=0)
    b1 = train_booster(dataset=ds, objective="binary", num_iterations=4,
                       cfg=cfg, seed=3)
    b2 = train_booster(dataset=dm, objective="binary", num_iterations=4,
                       cfg=cfg, seed=3)
    for f in b1.trees:
        np.testing.assert_array_equal(b1.trees[f], b2.trees[f], err_msg=f)
    np.testing.assert_array_equal(b1.predict_raw(X, device="cpu"),
                                  b2.predict_raw(X, device="cpu"))


# a rank of the 2-rank out-of-core construct: bins, labels, weights and
# mask against the in-memory 2-rank construct, the rows it read from the
# files, and quantized and bf16 fits on both datasets
_RANK_OOC = """
import os
import torch
from mmlspark_tpu_torch.models.gbdt import ingest
from mmlspark_tpu_torch.models.gbdt.booster import (LightGBMDataset,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
T = __TMP__
KW = __KW__
d = np.load(T + "/data.npz")
reads = []
real_read_into = ingest.ShardedMatrixSource.read_into
real_gather = ingest.ShardedMatrixSource.gather


def read_into(self, out, start, stop):
    reads.append([os.path.basename(os.path.dirname(self.paths[0])),
                  int(start), int(min(stop, self.n))])
    return real_read_into(self, out, start, stop)


def gather(self, idx):
    reads.append(["gather", len(idx)])
    return real_gather(self, idx)


ingest.ShardedMatrixSource.read_into = read_into
ingest.ShardedMatrixSource.gather = gather
ds = LightGBMDataset.construct(path=T + "/x", label_path=T + "/y",
                               weight_path=T + "/w", chunk_rows=999,
                               device="cpu", **KW)
ingest.ShardedMatrixSource.read_into = real_read_into
ingest.ShardedMatrixSource.gather = real_gather
dm = LightGBMDataset.construct(d["X"], d["y"], d["w"], bin_dtype="uint8",
                               device="cpu", **KW)
out = {"equal": {k: bool(torch.equal(getattr(ds, k), getattr(dm, k)))
                 for k in ("Xbt", "y", "w", "vmask")},
       "shape": [ds.n, ds.n_pad, ds.n_local, dm.n_pad],
       "dtype": str(ds.Xbt.dtype), "reads": reads,
       "bounds": ds.binner.upper_bounds.tolist(), "Xbt": ds.Xbt.tolist()}
for quant in (False, True):
    cfg = GrowConfig(num_leaves=15, min_data_in_leaf=40,
                     quantized_grad=quant, quant_warmup_iters=0)
    out[f"fits_{quant}"] = [train_booster(
        dataset=x, objective="binary", num_iterations=4, cfg=cfg,
        seed=3).model_string() for x in (ds, dm)]
result = out
"""


@pytest.fixture(scope="module")
def two_rank_ooc(tmp_path_factory):
    """4,999 rows (rank 1 holds a padding row) in three uneven shards,
    built out of core and in memory on each of 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("ooc_ranks")
    X, y, w = _data(n=4999)
    np.savez(tmp / "data.npz", X=X, y=y, w=w)
    write_shards([X[:1700], X[1700:3100], X[3100:]], tmp / "x")
    write_shards([y[:2600], y[2600:]], tmp / "y")
    write_shards([w], tmp / "w")
    body = (_RANK_OOC.replace("__TMP__", repr(str(tmp)))
            .replace("__KW__", repr(KW)))
    return run_ranks(tmp, 2, body, timeout=180), tmp


def test_two_rank_out_of_core_equals_the_in_memory_slices(two_rank_ooc):
    ranks, _ = two_rank_ooc
    for r in ranks:
        assert r["equal"] == {"Xbt": True, "y": True, "w": True,
                              "vmask": True}
        assert r["shape"] == [4999, 5000, 2500, 5000]
        assert r["dtype"] == "torch.uint8"
    assert ranks[0]["bounds"] == ranks[1]["bounds"]


def test_two_rank_out_of_core_matches_jax_on_two_devices(two_rank_ooc):
    ranks, tmp = two_rank_ooc
    jd = jconstruct_from_files(str(tmp / "x"), str(tmp / "y"),
                               str(tmp / "w"), chunk_rows=999,
                               mesh=make_mesh({"data": 2},
                                              devices=jax.devices()[:2]),
                               **KW)
    np.testing.assert_array_equal(
        np.asarray(ranks[0]["bounds"], np.float32), jd.binner.upper_bounds)
    jbins = np.asarray(jd.Xbt_d)
    for r, rec in enumerate(ranks):
        # the valid columns: JAX leaves its padding's bins unspecified
        valid = min(2500, 4999 - r * 2500)
        np.testing.assert_array_equal(
            np.asarray(rec["Xbt"])[:, :valid],
            jbins[:, r * 2500:r * 2500 + valid])


@pytest.mark.parametrize("quantized", [False, True])
def test_two_rank_fit_from_shards_grows_the_in_memory_trees(two_rank_ooc,
                                                             quantized):
    ranks, _ = two_rank_ooc
    for r in ranks:
        ooc, mem = r[f"fits_{quantized}"]
        assert len(ooc) > 1000 and ooc == mem
    assert ranks[0][f"fits_{quantized}"] == ranks[1][f"fits_{quantized}"]


def test_each_rank_reads_only_its_rows(two_rank_ooc):
    """Every file read of a rank lies in its padded row range cut at n and
    together they cover it once per source; rank 0 alone gathers the
    binner's 3,000-row sample."""
    ranks, _ = two_rank_ooc
    for r, rec in enumerate(ranks):
        lo, hi = r * 2500, min((r + 1) * 2500, 4999)
        gathers = [g for g in rec["reads"] if g[0] == "gather"]
        assert gathers == ([["gather", 3000]] if r == 0 else [])
        for src in ("x", "y", "w"):
            spans = sorted((g[1], g[2]) for g in rec["reads"]
                           if g[0] == src)
            assert spans and all(lo <= a < b <= hi for a, b in spans), src
            assert sum(b - a for a, b in spans) == hi - lo, src
            assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans,
                                                              spans[1:]))


def test_host_quant_bins_equal_device_bins(shards, monkeypatch):
    d, X, y, _ = shards
    base = LightGBMDataset.construct(path=str(d / "x"),
                                     label_path=str(d / "y"),
                                     chunk_rows=1000, device="cpu", **KW)
    monkeypatch.setenv(INGEST_HOST_QUANT_ENV, "1")
    assert host_quant_enabled(63) and not host_quant_enabled(1000)
    hq = LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                   chunk_rows=1000, device="cpu", **KW)
    assert torch.equal(hq.Xbt, base.Xbt)
    hq32 = LightGBMDataset.construct(path=str(d / "x"),
                                     label_path=str(d / "y"),
                                     bin_dtype="int32", device="cpu", **KW)
    assert hq32.Xbt.dtype == torch.int32
    assert torch.equal(hq32.Xbt, base.Xbt.to(torch.int32))


@pytest.mark.parametrize("kwargs,match", [
    (dict(label_path="y"), "only apply with path"),
    (dict(chunk_rows=10), "only apply with path"),
    (dict(path="x"), "requires label_path"),
    (dict(path="x", label_path="y", X=np.zeros((2, 2))), "not both"),
    (dict(path="x", label_path="y", row_valid=np.ones(2)), "row_valid"),
    (dict(), "construct needs"),
])
def test_construct_argument_checks(shards, kwargs, match):
    d = shards[0]
    kwargs = {k: (str(d / v) if k in ("path", "label_path") else v)
              for k, v in kwargs.items()}
    with pytest.raises(ValueError, match=match):
        LightGBMDataset.construct(device="cpu", **kwargs)


def test_construct_from_files_checks_shapes(shards, tmp_path):
    d, X, y, _ = shards
    write_shards([y[:100]], tmp_path / "short")
    with pytest.raises(ValueError, match="label/weight length"):
        LightGBMDataset.construct(path=str(d / "x"),
                                  label_path=str(tmp_path / "short"),
                                  device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                  categorical_features=(6,), device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        LightGBMDataset.construct(path=str(d / "y"), label_path=str(d / "y"),
                                  device="cpu")
    with pytest.raises(ValueError, match="bin_dtype=uint8"):
        LightGBMDataset.construct(path=str(d / "x"), label_path=str(d / "y"),
                                  bin_dtype="uint8", max_bin=1000,
                                  device="cpu")


def test_sharded_source_reads_across_shards(shards):
    d, X, y, _ = shards
    src = ShardedMatrixSource(str(d / "x"))
    assert (src.n, src.num_features, src.ndim) == X.shape + (2,)
    np.testing.assert_array_equal(src.read(1650, 3200), X[1650:3200])
    idx = np.array([4999, 0, 1700, 3099, 3100, 1699])
    np.testing.assert_array_equal(src.gather(idx), X[idx])
    assert src.read(10, 10).shape == (0, 6)
    ysrc = ShardedMatrixSource([str(d / "y" / "part-00001.npy"),
                                str(d / "y" / "part-00000.npy")])
    np.testing.assert_array_equal(ysrc.read(0, 5000),
                                  np.concatenate([y[2500:], y[:2500]]))


def _write_csv(path, rows, header=None, bom=False):
    text = "" if header is None else header + "\n"
    text += "\n".join(",".join("" if np.isnan(v) else repr(float(v))
                               for v in r) for r in rows) + "\n"
    data = text.encode()
    with open(path, "wb") as f:
        f.write((b"\xef\xbb\xbf" if bom else b"") + data)


@pytest.mark.parametrize("header,bom", [("a,b,c,d,w,label", False),
                                        (None, False),
                                        ("a,b,c,d,w,label", True)])
def test_csv_to_shards_round_trip(tmp_path, header, bom):
    X, y, w = _data(n=2500, F=4, seed=4)
    rows = np.column_stack([X, w, y])
    _write_csv(tmp_path / "d.csv", rows, header, bom)
    xd, yd, wd = csv_to_shards(str(tmp_path / "d.csv"), str(tmp_path / "o"),
                               label_col=5, weight_col=4, shard_rows=1000,
                               read_bytes=4096)
    names = sorted(os.listdir(xd))
    assert names == ["part-00000.npy", "part-00001.npy", "part-00002.npy"]
    got = ShardedMatrixSource(xd).read(0, 2500)
    np.testing.assert_array_equal(got, X)
    np.testing.assert_array_equal(ShardedMatrixSource(yd).read(0, 2500), y)
    np.testing.assert_array_equal(ShardedMatrixSource(wd).read(0, 2500), w)
    # the JAX package writes the same shards
    jx, jy, jw = jcsv_to_shards(str(tmp_path / "d.csv"), str(tmp_path / "j"),
                                label_col=5, weight_col=4, shard_rows=1000)
    for a, b in ((xd, jx), (yd, jy), (wd, jw)):
        for name in names:
            np.testing.assert_array_equal(np.load(os.path.join(a, name)),
                                          np.load(os.path.join(b, name)))
    # a rerun without weights clears the stale weight shards
    csv_to_shards(str(tmp_path / "d.csv"), str(tmp_path / "o"), label_col=5,
                  shard_rows=5000)
    assert os.listdir(xd) == ["part-00000.npy"]
    assert os.listdir(os.path.join(str(tmp_path / "o"), "w")) == []


def test_csv_to_shards_checks(tmp_path):
    _write_csv(tmp_path / "d.csv", np.ones((3, 4), np.float32))
    with pytest.raises(ValueError, match="must differ"):
        csv_to_shards(str(tmp_path / "d.csv"), str(tmp_path / "o"),
                      label_col=1, weight_col=1)
    with pytest.raises(ValueError, match="out of range"):
        csv_to_shards(str(tmp_path / "d.csv"), str(tmp_path / "o"),
                      label_col=7)
    (tmp_path / "empty.csv").write_text("a,b\n")
    with pytest.raises(ValueError, match="no data rows"):
        csv_to_shards(str(tmp_path / "empty.csv"), str(tmp_path / "e"),
                      label_col=0)


def test_csv_reader_parses_like_python():
    text = "1.5, 2 ,+3\n\n-4,,nan\n1e3,bad,inf\n"
    got = csv_read_floats(text, 3)
    want = np.array([[1.5, 2, 3], [-4, np.nan, np.nan],
                     [1000, np.nan, np.inf]], np.float32)
    np.testing.assert_array_equal(got, want)
    assert csv_read_floats(b"", 2).shape == (0, 2)
    with pytest.raises(ValueError, match="expected 3 columns"):
        csv_read_floats("1,2\n", 3)
    # a buffer past the reader's threaded-parse threshold
    big = np.random.default_rng(0).normal(size=(150_000, 4)).astype(
        np.float32)
    text = "\n".join(",".join(repr(float(v)) for v in r) for r in big)
    np.testing.assert_array_equal(csv_read_floats(text, 4), big)
