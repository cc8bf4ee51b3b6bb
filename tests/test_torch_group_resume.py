"""Checkpoint and resume over a data group of several ranks: the PyTorch
port against itself across rank counts and against the JAX package on a
two-device mesh.

  * GBDT, ``hist_blocks=8``, 480 rows: a 2-rank fit of 6 rounds
    (``checkpoint_period=3``) resumed to 12 on 2 ranks is byte-equal to the
    uninterrupted 2-rank fit; its checkpoint resumed in this process on 1
    rank too, and a 1-rank checkpoint resumed on 2 ranks. The resumed runs
    start at the checkpoint's round (counted by ``iteration_callback``).
    Early stopping with a validation set and 477 rows without
    ``hist_blocks`` (a padding row on rank 1) resume byte-equal on 2
    ranks. ``numBatches=2`` with ``checkpointDir``: a rerun with more
    rounds resumes batch 0 and equals the fit without checkpoints.
  * Against ``jax`` on ``make_mesh({"data": 2})`` with the same schedule:
    identical trees and margins within 1e-5
    (``test_torch_hist_blocks.py``'s tolerance); the step-2 payload's
    ``scores`` have shape ``(n, 1)`` and lie within 1e-5 of the JAX
    payload's.
  * Both ranks killed at the top of round 8 by the ``gbdt.round``
    failpoint resume on 1 rank from the checkpoint of rounds 0-5 to the
    uninterrupted fit's bytes.
  * Rank 1 passes a directory of its own, which must never be created:
    rank 0 alone reads, purges and writes. Ranks fed other labels raise
    ``ValueError`` together before any file is read; under strict resume
    rank 0's ``CheckpointMismatchError`` is raised on both ranks, and an
    error of rank 0 that does not pickle reaches rank 1 as a
    ``RuntimeError``.
  * VW: 2 ranks run 2 passes, then resume to 3, bit-equal to an
    uninterrupted 3-pass 2-rank run (adagrad; ``l1=0.01``), resuming at
    pass 1, and within ``SGD_ATOL`` of JAX ``train_sgd_checkpointed`` on a
    2-device mesh; the 2-rank checkpoint resumed on 1 rank within
    ``SGD_ATOL`` of the JAX package's 2-device checkpoint resumed on 1
    device.
"""

import glob
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from _torch_ranks import run_ranks
from mmlspark_tpu.models.gbdt import growth as JG
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.vw import sgd as jsgd
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models.gbdt import growth as TG
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.booster import train_booster as ttrain
from mmlspark_tpu_torch.models.vw import sgd as tsgd

torch.set_num_threads(1)

N = 480
STRUCTURE = ("feat", "thr_bin", "left", "right", "is_leaf", "cat_bitset")
SGD_ATOL = 2e-5
VW_OPTIONS = {"ada": {}, "l1": {"l1": 0.01}}


def _data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N + 160, 6)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.4 * X[:, 2] > 0).astype(np.float32)
    return X[:N], y[:N], X[N:], y[N:]


def _vw_data(n=600, nnz=6, bits=10):
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 1 << bits, size=(n, nnz)).astype(np.int32)
    idx[:, -1] = 5
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    val[:, -1] = 1.0
    y = (val[:, 0] + 0.4 * rng.normal(size=n) > 0).astype(np.float32)
    return idx, val, y


def _common(pkg, **cfg):
    return dict(objective="binary", max_bin=63, bin_sample_count=N, seed=0,
                cfg=pkg.GrowConfig(num_leaves=7, min_data_in_leaf=5, **cfg))


_BODY = """
import shutil
import threading
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.models.vw import sgd
from mmlspark_tpu_torch.parallel.mesh import get_default_mesh
from mmlspark_tpu_torch.utils.checkpoint import CheckpointMismatchError
T = __TMP__
d = np.load(T + "/data.npz")
X, y, Xv, yv = d["X"], d["y"], d["Xv"], d["yv"]
n = len(y)


def own(name):
    # rank 1 names a directory of its own: rank 0 alone may touch one
    return f"{T}/{name}" + ("" if rank == 0 else "_rank1")


def fit(X, y, rounds, ckpt=None, cfg=None, **kw):
    seen = []
    b = train_booster(
        X, y, objective="binary", num_iterations=rounds, max_bin=63,
        bin_sample_count=n, seed=0, device="cpu",
        cfg=cfg or GrowConfig(num_leaves=7, min_data_in_leaf=5,
                              hist_blocks=8),
        checkpoint_dir=None if ckpt is None else own(ckpt),
        checkpoint_period=3, iteration_callback=lambda it, m: seen.append(it),
        **kw)
    return b, seen


out = {}
out["full"] = fit(X, y, 12)[0].model_string()
fit(X, y, 6, "ck")
if rank == 0:
    shutil.copytree(T + "/ck", T + "/ck_for_one")
b, seen = fit(X, y, 12, "ck")
out["resumed"], out["resumed_from"] = b.model_string(), seen[0]
b, seen = fit(X, y, 12, "ck_one")
out["from_one"], out["from_one_from"] = b.model_string(), seen[0]

# early stopping on a validation set
es = dict(valid_set=(Xv, yv, None), early_stopping_rounds=2,
          eval_metric_name="binary_logloss")
b = fit(X, y, 12, **es)[0]
out["es_full"] = [b.model_string(), b.eval_history, b.best_iteration]
fit(X, y, 6, "ck_es", **es)
b, seen = fit(X, y, 12, "ck_es", **es)
out["es_resumed"] = [b.model_string(), b.eval_history, b.best_iteration]
out["es_from"] = seen[0]

# 477 rows without hist_blocks: rank 1 holds a padding row
plain = GrowConfig(num_leaves=7, min_data_in_leaf=5)
out["pad_full"] = fit(X[:477], y[:477], 8, cfg=plain)[0].model_string()
fit(X[:477], y[:477], 4, "ck_pad", cfg=plain)
b, seen = fit(X[:477], y[:477], 8, "ck_pad", cfg=plain)
out["pad_resumed"], out["pad_from"] = b.model_string(), seen[0]

# numBatches=2 with checkpointDir: a rerun with more rounds resumes batch 0
def batches(rounds, ckpt):
    est = LightGBMClassifier(
        numIterations=rounds, numBatches=2, numLeaves=7, minDataInLeaf=5,
        maxBin=63, binSampleCount=n, checkpointInterval=2, device="cpu",
        checkpointDir=None if ckpt is None else own(ckpt))
    return est.fit(Dataset({"features": X, "label": y})).booster
batches(4, "ck_nb")
out["nb_resumed"] = batches(8, "ck_nb").model_string()
out["nb_plain"] = batches(8, None).model_string()

# ranks fed other labels must not resume each other's state
yy = y.copy()
if rank == 1:
    yy[0] = 1.0 - yy[0]
try:
    fit(X, yy, 2, "ck_fp")
    out["mismatch"] = None
except ValueError as e:
    out["mismatch"] = str(e)

# strict resume: rank 0 finds only another run's checkpoints, and its
# CheckpointMismatchError is raised on both ranks
if rank == 0:
    shutil.copytree(T + "/ck", T + "/ck_strict")
os.environ["MMLSPARK_TPU_STRICT_RESUME"] = "1"
try:
    fit(X, 1.0 - y, 2, "ck_strict")
    out["strict"] = None
except CheckpointMismatchError as e:
    out["strict"] = type(e).__name__
del os.environ["MMLSPARK_TPU_STRICT_RESUME"]


# an error on rank 0 that does not pickle still reaches rank 1
def unreadable():
    e = OSError("unreadable directory")
    e.lock = threading.Lock()
    raise e


try:
    get_default_mesh().from_first(unreadable)
    out["from_first"] = None
except Exception as e:  # noqa: BLE001
    out["from_first"] = [type(e).__name__, "unreadable" in str(e)]

# VW: 2 passes, then resumed to 3, against 3 uninterrupted passes
v = np.load(T + "/vw.npz")
calls = []
real = sgd.train_sgd


def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)


for name, over in __VW__.items():
    cfg = sgd.SGDConfig(num_bits=10, loss="logistic", num_passes=3,
                        batch_size=32, **over)
    args = (v["idx"], v["val"], v["y"], None)
    out["vw_full_" + name] = real(*args, cfg, device="cpu").tolist()
    sgd.train_sgd_checkpointed(*args, cfg._replace(num_passes=2),
                               own("vw_" + name), device="cpu")
    if rank == 0:
        shutil.copytree(f"{T}/vw_{name}", f"{T}/vw_{name}_for_one")
    sgd.train_sgd = counted
    calls.clear()
    out["vw_resumed_" + name] = sgd.train_sgd_checkpointed(
        *args, cfg, own("vw_" + name), device="cpu").tolist()
    sgd.train_sgd = real
    out["vw_calls_" + name] = len(calls)
result = out
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 1-rank checkpoint first, then each rank's results and the
    directory they used."""
    tmp = tmp_path_factory.mktemp("group_resume")
    X, y, Xv, yv = _data()
    np.savez(tmp / "data.npz", X=X, y=y, Xv=Xv, yv=yv)
    idx, val, vy = _vw_data()
    np.savez(tmp / "vw.npz", idx=idx, val=val, y=vy)
    ttrain(X, y, num_iterations=6, checkpoint_dir=str(tmp / "ck_one"),
           checkpoint_period=3, device="cpu",
           **_common(TG, hist_blocks=8))
    body = (_BODY.replace("__TMP__", repr(str(tmp)))
            .replace("__VW__", repr(VW_OPTIONS)))
    return run_ranks(tmp, 2, body, timeout=240), tmp


# results that differ by rank on purpose
PER_RANK = ("from_first",)


def test_ranks_agree(ranks):
    res, _ = ranks
    assert ({k: v for k, v in res[0].items() if k not in PER_RANK}
            == {k: v for k, v in res[1].items() if k not in PER_RANK})


# resumed fit: (its uninterrupted fit, the key of its first round)
RESUMED = {"resumed": ("full", "resumed_from"),
           "from_one": ("full", "from_one_from"),
           "es_resumed": ("es_full", "es_from"),
           "pad_resumed": ("pad_full", "pad_from"),
           "nb_resumed": ("nb_plain", None)}


@pytest.mark.parametrize("tag", sorted(RESUMED))
def test_two_rank_resume_equals_the_uninterrupted_fit(ranks, tag):
    """Each resumed 2-rank fit is byte-equal to its uninterrupted one and
    (but numBatches, whose fits are estimator calls) starts at round 3,
    after the checkpoint of rounds 0-2."""
    res = ranks[0][0]
    want, first = RESUMED[tag]
    assert len(str(res[want])) > 1000
    assert res[tag] == res[want]
    if first is not None:
        assert res[first] == 3


def test_early_stopping_history_survives_the_resume(ranks):
    res = ranks[0][0]
    history = res["es_full"][1]["binary_logloss"]
    assert len(history) >= 4 and res["es_full"][2] >= 0


def test_two_rank_checkpoint_resumes_on_one_rank(ranks):
    res, tmp = ranks
    X, y, _, _ = _data()
    seen = []
    b = ttrain(X, y, num_iterations=12,
               checkpoint_dir=str(tmp / "ck_for_one"), checkpoint_period=3,
               device="cpu", iteration_callback=lambda it, m: seen.append(it),
               **_common(TG, hist_blocks=8))
    assert seen[0] == 3
    assert b.model_string() == res[0]["full"]


def test_only_rank_0_touches_the_directory(ranks):
    _, tmp = ranks
    for name in ("ck", "ck_one", "ck_es", "ck_pad", "ck_nb", "ck_fp",
                 "ck_strict", "vw_ada", "vw_l1"):
        assert not os.path.exists(tmp / f"{name}_rank1"), name
    assert glob.glob(str(tmp / "ck" / "ckpt_*.pkl"))
    assert sorted(os.listdir(tmp / "ck_nb")) == ["batch_0000", "batch_0001"]


def test_fingerprint_mismatch_raises_on_every_rank(ranks):
    for r in ranks[0]:
        assert r["mismatch"] and "fingerprint" in r["mismatch"]


def test_strict_mismatch_raises_on_every_rank(ranks):
    """Under ``MMLSPARK_TPU_STRICT_RESUME=1`` rank 0's probe finds only
    another run's checkpoints; its ``CheckpointMismatchError`` is raised
    on both ranks, and rank 0 purged nothing."""
    res, tmp = ranks
    for r in res:
        assert r["strict"] == "CheckpointMismatchError"
    assert (sorted(os.listdir(tmp / "ck_strict"))
            == sorted(os.listdir(tmp / "ck")))


def test_unpicklable_rank_0_error_reaches_every_rank(ranks):
    """``Mesh.from_first``: rank 0 raises its own error; rank 1, which
    cannot be sent it, gets a ``RuntimeError`` that names it."""
    res = ranks[0]
    assert res[0]["from_first"] == ["OSError", True]
    assert res[1]["from_first"] == ["RuntimeError", True]


def _payload(directory, step):
    [path] = glob.glob(os.path.join(directory, f"ckpt_*_{step:010d}.pkl"))
    with open(path, "rb") as f:
        return pickle.load(f)


def test_resume_matches_jax_on_a_two_device_mesh(ranks, tmp_path):
    res, tmp = ranks
    X, y, _, _ = _data()
    mesh2 = make_mesh({"data": 2}, devices=jax.devices()[:2])
    jdir = str(tmp_path / "jck")
    common = _common(JG, hist_blocks=8)
    jtrain(X, y, num_iterations=6, checkpoint_dir=jdir, checkpoint_period=3,
           mesh=mesh2, **common)
    jb = jtrain(X, y, num_iterations=12, checkpoint_dir=jdir,
                checkpoint_period=3, mesh=mesh2, **common)
    tb = Booster.from_string(res[0]["resumed"])
    for f in STRUCTURE:
        np.testing.assert_array_equal(tb.trees[f],
                                      np.asarray(getattr(jb.trees, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tb.predict_raw(X, device="cpu"),
                               jb.predict_raw(X), rtol=0, atol=1e-5)
    got, want = _payload(str(tmp / "ck"), 2), _payload(jdir, 2)
    assert got["scores"].shape == (N, 1) == np.shape(want["scores"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(VW_OPTIONS))
def test_vw_resume_is_bitwise_over_two_ranks(ranks, name):
    for r in ranks[0]:
        assert r["vw_resumed_" + name] == r["vw_full_" + name]
        assert r["vw_calls_" + name] == 2     # passes 1 and 2 only


def _jax_vw(name, directory, passes, mesh):
    idx, val, y = _vw_data()
    cfg = jsgd.SGDConfig(num_bits=10, loss="logistic", num_passes=passes,
                         batch_size=32, **VW_OPTIONS[name])
    return jsgd.train_sgd_checkpointed(idx, val, y, None, cfg, directory,
                                       mesh=mesh)


@pytest.mark.parametrize("name", sorted(VW_OPTIONS))
def test_vw_resume_matches_jax_on_a_two_device_mesh(ranks, name, tmp_path):
    mesh2 = make_mesh({"data": 2}, devices=jax.devices()[:2])
    d = str(tmp_path / "jvw")
    _jax_vw(name, d, 2, mesh2)
    wj = _jax_vw(name, d, 3, mesh2)
    np.testing.assert_allclose(
        np.asarray(ranks[0][0]["vw_resumed_" + name], np.float32), wj,
        rtol=0, atol=SGD_ATOL)


@pytest.mark.parametrize("name", sorted(VW_OPTIONS))
def test_vw_two_rank_checkpoint_resumes_on_one_rank(ranks, name, tmp_path):
    """The VW state is a replica, so another rank count loads it, as the
    JAX package's 2-device checkpoint loads on 1 device."""
    _, tmp = ranks
    idx, val, y = _vw_data()
    cfg = tsgd.SGDConfig(num_bits=10, loss="logistic", num_passes=3,
                         batch_size=32, **VW_OPTIONS[name])
    d = str(tmp_path / "tvw")
    shutil.copytree(tmp / f"vw_{name}_for_one", d)
    wt = tsgd.train_sgd_checkpointed(idx, val, y, None, cfg, d,
                                     device="cpu")
    jd = str(tmp_path / "jvw")
    _jax_vw(name, jd, 2, make_mesh({"data": 2}, devices=jax.devices()[:2]))
    wj = _jax_vw(name, jd, 3, make_mesh({"data": 1},
                                        devices=jax.devices()[:1]))
    np.testing.assert_allclose(wt, wj, rtol=0, atol=SGD_ATOL)


_KILLED = """
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
d = np.load(__TMP__ + "/data.npz")
train_booster(d["X"], d["y"], objective="binary", num_iterations=12,
              max_bin=63, bin_sample_count=len(d["y"]), seed=0,
              device="cpu", checkpoint_dir=__TMP__ + "/ck_kill",
              checkpoint_period=3,
              cfg=GrowConfig(num_leaves=7, min_data_in_leaf=5,
                             hist_blocks=8))
"""


def test_ranks_killed_mid_fit_resume_on_one_rank(ranks):
    """Both ranks die at the top of round 8 (``gbdt.round:exit@8``, a
    preempted job); the checkpoint of rounds 0-5 resumes on 1 rank to the
    uninterrupted 2-rank fit's bytes."""
    res, tmp = ranks
    with pytest.raises(AssertionError) as killed:
        run_ranks(tmp, 2, _KILLED.replace("__TMP__", repr(str(tmp))),
                  env={"MMLSPARK_TPU_FAILPOINTS": "gbdt.round:exit@8"})
    assert str(killed.value).count(" rc 17:") == 2
    X, y, _, _ = _data()
    seen = []
    b = ttrain(X, y, num_iterations=12, checkpoint_dir=str(tmp / "ck_kill"),
               checkpoint_period=3, device="cpu",
               iteration_callback=lambda it, m: seen.append(it),
               **_common(TG, hist_blocks=8))
    assert seen[0] == 6
    assert b.model_string() == res[0]["full"]
