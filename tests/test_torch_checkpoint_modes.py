"""The trainer's watchdog wiring and its two checkpoint modes: the port
against the JAX package.

  * ``MMLSPARK_TPU_STRICT_RESUME=1``: a checkpoint directory that holds
    only a mismatched run's checkpoints makes both packages raise
    ``CheckpointMismatchError`` instead of training from scratch;
  * ``MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY=1``: the same injected
    training-health event (a NaN validation loss reported at round 3)
    makes both write one emergency checkpoint with the same iteration and
    reason, whose model the port resumes to tree for tree;
  * the port's trainer beats its round-loop heartbeat once per round
    (``gbdt_round_loop``; DART ``gbdt_dart_round_loop``) and resets the
    training-health sentinels per fit.
"""

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.observability import watchdog as jwatchdog
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.utils.checkpoint import (
    CheckpointManager as JCheckpointManager)
from mmlspark_tpu.utils.checkpoint import (
    CheckpointMismatchError as JMismatch)
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.observability import watchdog as twatchdog
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager
from mmlspark_tpu_torch.utils.checkpoint import CheckpointMismatchError

torch.set_num_threads(1)


def _data(seed=0, n=600):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _jfit(X, y, ckpt, leaves=7, **kw):
    return jtrain(X, y, objective="binary", max_bin=63,
                  cfg=JGrowConfig(num_leaves=leaves, min_data_in_leaf=20),
                  checkpoint_dir=str(ckpt), mesh=make_mesh(
                      devices=jax.devices()[:1]), **kw)


def _tfit(X, y, ckpt, leaves=7, **kw):
    return train_booster(X, y, objective="binary", max_bin=63,
                         cfg=GrowConfig(num_leaves=leaves,
                                        min_data_in_leaf=20),
                         checkpoint_dir=str(ckpt), device="cpu", **kw)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_strict_resume_raises_on_a_mismatched_checkpoint(pkg, tmp_path,
                                                         monkeypatch):
    fit, err = ((_jfit, JMismatch) if pkg == "jax"
                else (_tfit, CheckpointMismatchError))
    X, y = _data()
    fit(X, y, tmp_path, num_iterations=5, checkpoint_period=2)
    # another config: its namespace holds nothing, the directory does
    monkeypatch.setenv("MMLSPARK_TPU_STRICT_RESUME", "1")
    with pytest.raises(err, match="matches fingerprint"):
        fit(X, y, tmp_path, leaves=5, num_iterations=5,
            checkpoint_period=2)
    # the evidence stays on disk
    assert CheckpointManager(str(tmp_path)).steps() == [1, 3]
    # without strict mode the same run trains afresh
    monkeypatch.delenv("MMLSPARK_TPU_STRICT_RESUME")
    assert fit(X, y, tmp_path, leaves=5, num_iterations=2,
               checkpoint_period=2).num_trees == 2


def _inject_nan_at(monkeypatch, module, at=3):
    real = module.report_training_metric

    def report(model, iteration, loss=None, **kw):
        if loss is not None and iteration == at:
            loss = float("nan")
        return real(model, iteration, loss=loss, **kw)

    monkeypatch.setattr(module, "report_training_metric", report)


def test_emergency_dump_matches_jax_and_resumes(tmp_path, monkeypatch):
    X, y = _data()
    Xv, yv = _data(seed=1, n=300)
    monkeypatch.setenv("MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY", "1")
    _inject_nan_at(monkeypatch, jwatchdog)
    _inject_nan_at(monkeypatch, twatchdog)
    kw = dict(num_iterations=6, checkpoint_period=100,
              valid_set=(Xv, yv, None))
    _jfit(X, y, tmp_path / "jax", **kw)
    whole = _tfit(X, y, tmp_path / "port", **kw)
    jstep, jpay = JCheckpointManager(str(tmp_path / "jax")).latest()
    tstep, tpay = CheckpointManager(str(tmp_path / "port")).latest()
    # the flagged round (3) is dropped: the last good state is round 2
    assert (tstep, tpay["iteration"], tpay["reason"]) == \
        (jstep, jpay["iteration"], jpay["reason"]) == (2, 2, "nan_loss")
    assert tpay["emergency"] is True and jpay["emergency"] is True
    assert len(CheckpointManager(str(tmp_path / "port")).steps()) == 1
    # the usual resume picks the dump up: cut to its rounds, it is the
    # dumped model, and those rounds are the uninterrupted fit's trees
    monkeypatch.delenv("MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY")
    resumed = _tfit(X, y, tmp_path / "port", **dict(kw, num_iterations=3))
    assert resumed.num_trees == 3
    from mmlspark_tpu_torch.models.gbdt.booster import Booster
    dumped = Booster.from_string(tpay["model"])
    for f in ("feat", "thr_bin", "left", "right", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(resumed.trees[f], dumped.trees[f])
        np.testing.assert_array_equal(dumped.trees[f], whole.trees[f][:3])


class _CountingHeart:
    def __init__(self):
        self.beats = 0
        self.closed = False

    def beat(self):
        self.beats += 1

    def close(self):
        self.closed = True


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_port_trainer_beats_once_per_round(boosting, monkeypatch):
    hearts = {}

    def register(site, stall_seconds=None):
        hearts[site] = _CountingHeart()
        return hearts[site]

    resets = []
    real_reset = twatchdog.reset_training_health
    monkeypatch.setattr(twatchdog, "register", register)
    monkeypatch.setattr(twatchdog, "reset_training_health",
                        lambda model=None: resets.append(model)
                        or real_reset(model))
    X, y = _data()
    train_booster(X, y, objective="binary", num_iterations=5, max_bin=63,
                  cfg=GrowConfig(num_leaves=7, min_data_in_leaf=20),
                  boosting_type=boosting, device="cpu")
    site = "gbdt_round_loop" if boosting == "gbdt" else "gbdt_dart_round_loop"
    assert list(hearts) == [site]
    assert hearts[site].beats == 5 and hearts[site].closed
    assert resets == ["gbdt"]
