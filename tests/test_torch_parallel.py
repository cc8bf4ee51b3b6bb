"""``mmlspark_tpu_torch.parallel`` against ``mmlspark_tpu.parallel``.

  * ``resolve_hist_blocks`` (the JAX package's ``TestHistBlocksResolution``
    cases): ``auto`` is the plain path, the environment knob engages and
    degrades with a ``placement`` flight event, an explicit invalid count
    raises with the JAX messages.
  * The mesh helpers (``pad_rows``, ``validity_mask``, ``num_shards``) equal
    the JAX ones; ``make_mesh`` takes the named axes (``model``, ``seq``:
    size 1 on one process, and a grid larger than the world refused);
    ``shard_rows`` keeps each rank's padded slice;
    ``plan_for`` decides and records as the JAX one does.
  * ``initialize`` with no argument and no environment is a no-op; an
    explicit request that fails raises.
  * In two gloo processes (``file://`` rendezvous): ``initialize``,
    ``process_index``/``process_count``/``is_coordinator``, ``barrier``
    (its ``barrier.wait`` failpoint and span), the mesh's ``all_reduce``
    (sum, max) and ``all_gather`` in rank order, and the
    ``MMLSPARK_TPU_MESH_DEVICES`` cap of the default group.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu_torch.observability import flight
from mmlspark_tpu_torch.parallel import distributed, placement
from mmlspark_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


@pytest.fixture
def mesh8():
    """A stand-in data group of 8 ranks (this process is rank 0): the
    resolution and planning helpers read only its size."""
    return tmesh.Mesh(range(8))


def test_auto_default_is_plain(mesh8, monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_HIST_BLOCKS", raising=False)
    assert placement.resolve_hist_blocks("auto", mesh8, 960) == 0


def test_env_knob_engages_and_degrades(mesh8, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_BLOCKS", "8")
    assert placement.resolve_hist_blocks("auto", mesh8, 960) == 8
    before = len([e for e in flight.events()
                  if e.get("site") == "gbdt.hist_blocks"])
    assert placement.resolve_hist_blocks("auto", mesh8, 8 * 123 + 4) == 0
    after = [e for e in flight.events() if e.get("site") == "gbdt.hist_blocks"]
    assert len(after) == before + 1
    assert after[-1]["decision"] == "fallback_plain"


def test_explicit_invalid_raises(mesh8):
    with pytest.raises(ValueError, match="multiple"):
        placement.resolve_hist_blocks(6, mesh8, 960)
    with pytest.raises(ValueError, match="row count"):
        placement.resolve_hist_blocks(8, mesh8, 8 * 100 + 4)
    with pytest.raises(ValueError, match="voting"):
        placement.resolve_hist_blocks(8, mesh8, 960, voting=True)
    with pytest.raises(ValueError, match="int or 'auto'"):
        placement.resolve_hist_blocks("8", mesh8, 960)
    assert placement.resolve_hist_blocks(1, mesh8, 960) == 0


@pytest.mark.parametrize("n,k", [(10, 1), (10, 4), (12, 4), (0, 3)])
def test_mesh_helpers_match_jax(n, k):
    a = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    for fill in (0, -1):
        tp, tn = tmesh.pad_rows(a, k, fill=fill)
        jp, jn = jmesh.pad_rows(a, k, fill=fill)
        np.testing.assert_array_equal(tp, jp)
        assert tn == jn
    np.testing.assert_array_equal(tmesh.validity_mask(n, n + 3),
                                  jmesh.validity_mask(n, n + 3))


def test_one_process_mesh_and_num_shards():
    m = tmesh.get_default_mesh()
    assert (m.size, m.rank, m.shape) == (1, 0, {"data": 1})
    assert tmesh.num_shards() == 1 and tmesh.num_shards(m, "model") == 1
    t = torch.arange(6.0)
    assert m.all_reduce(t) is t and m.all_gather(t) is t
    with tmesh.default_mesh(tmesh.Mesh(range(4))) as m4:
        assert tmesh.get_default_mesh() is m4 and tmesh.num_shards() == 4
    assert tmesh.get_default_mesh().size == 1
    named = tmesh.make_mesh({"data": 1, "model": 1})
    assert named.shape == {"data": 1, "model": 1}
    assert (named.size, named.rank, named.axis_size("model"),
            named.axis_index("model"), named.axis_size("seq")) == (1, 0, 1,
                                                                   0, 1)
    assert named.all_reduce(t) is t and tmesh.num_shards(named, "model") == 1
    with pytest.raises(ValueError, match="world of 1"):
        tmesh.make_mesh({"seq": 2})
    with pytest.raises(ValueError, match="world of 1"):
        tmesh.make_mesh(ranks=[0, 1])


def test_shard_rows_keeps_each_ranks_padded_slice():
    a = np.arange(10, dtype=np.float32)
    parts = []
    for r in range(4):
        m = tmesh.Mesh(range(4))
        m.rank = r
        part, n = placement.shard_rows(a, m, fill=-1, device="cpu")
        assert n == 10 and part.shape == (3,)
        parts.append(part)
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  np.r_[a, -1, -1])


def test_plan_for_decides_and_records_once(mesh8):
    placement.reset_decision_log()
    p = placement.plan_for("unit.test", mesh=mesh8, rows=64, device="cpu")
    assert (p.decision, p.nshards, p.backend) == ("shard_rows", 8, "cpu")
    p1 = placement.plan_for("unit.one", mesh=tmesh.Mesh(), rows=3)
    assert (p1.decision, p1.backend) == ("replicate", "cuda")
    ev = [e for e in flight.events() if e.get("kind") == "placement"]
    assert any(e["site"] == "unit.test" and e["rows"] == 64 for e in ev)
    n = len(flight.events())
    placement.plan_for("unit.test", mesh=mesh8, rows=64, device="cpu")
    assert len(flight.events()) == n
    placement.reset_decision_log()


def test_fit_records_ingest_and_fit_decisions():
    from mmlspark_tpu_torch.models.gbdt.booster import train_booster
    placement.reset_decision_log()
    rng = np.random.default_rng(3)
    X = rng.normal(size=(480, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    train_booster(X, y, objective="binary", num_iterations=1, device="cpu")
    ev = {e["site"]: e for e in flight.events()
          if e.get("kind") == "placement"}
    assert ev["gbdt.ingest"]["decision"] == "replicate"
    assert ev["gbdt.fit"]["backend"] == "cpu"
    placement.reset_decision_log()


def test_initialize_without_arguments_is_a_noop(monkeypatch):
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_coordinator()) == (0, 1, True)
    distributed.barrier("unit")          # one process: returns at once


def test_an_explicit_request_that_fails_raises(tmp_path):
    with pytest.raises(Exception):
        distributed.initialize(f"file://{tmp_path}/rdv", 1, 0,
                               backend="no-such-backend")
    assert not torch.distributed.is_initialized()


def test_two_processes_join_meet_and_reduce(tmp_path):
    body = """
from mmlspark_tpu_torch.observability import flight, metrics
from mmlspark_tpu_torch.parallel import mesh as meshlib
distributed.barrier("start")
m = meshlib.get_default_mesh()
t = torch.tensor([float(rank + 1), 10.0 * rank])
g = m.all_gather(torch.full((2, 3), float(rank)))
os.environ["MMLSPARK_TPU_MESH_DEVICES"] = "1"
capped = meshlib.make_mesh()
result = {"index": distributed.process_index(),
          "count": distributed.process_count(),
          "coordinator": distributed.is_coordinator(),
          "mesh": [m.size, m.rank],
          "sum": m.all_reduce(t).tolist(),
          "max": m.all_reduce(t, op="max").tolist(),
          "gather": g[:, 0].tolist(),
          "capped": [capped.size, capped.rank],
          "init_events": len([e for e in flight.events()
                              if e.get("kind") == "distributed_init"]),
          "barrier_spans": "barrier" in str(
              metrics.get_registry().snapshot().get(
                  "span_duration_seconds", ""))}
"""
    out = run_ranks(tmp_path, 2, body)
    for r, res in enumerate(out):
        assert res["index"] == r and res["count"] == 2
        assert res["coordinator"] == (r == 0)
        assert res["mesh"] == [2, r] and res["capped"][0] == 1
        assert res["sum"] == [3.0, 10.0] and res["max"] == [2.0, 10.0]
        assert res["gather"] == [0.0, 0.0, 1.0, 1.0]
        assert res["init_events"] == 1 and res["barrier_spans"]
    assert [res["capped"][1] for res in out] == [0, -1]


_RANKER = """
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt.api import LightGBMRanker
rng = np.random.default_rng(5)
sizes = rng.integers(4, 12, size=31)
group = np.repeat(np.arange(31), sizes)
n = len(group)
X = rng.normal(size=(n, 5)).astype(np.float32)
y = np.clip(np.round(X[:, 0] + 0.5 * rng.normal(size=n) + 1), 0, 3
            ).astype(np.float32)
m = LightGBMRanker(device="cpu", groupCol="q", numIterations=3,
                   numLeaves=7, minDataInLeaf=5, maxGroupSize=16).fit(
    Dataset({"features": X, "label": y, "q": group}))
result = {"model": m.booster.model_string(),
          "score": m.transform(Dataset({"features": X})).array(
              "prediction").tolist()}
"""


def test_ranker_pads_whole_groups_to_each_rank(tmp_path):
    """31 query groups padded to 32 over two ranks (the JAX
    ``_pad_groups(..., nshards)``): each rank holds 16 whole groups and
    both return one model, scoring as the one-process fit does (the sums
    cross the group in another order, so within 1e-5)."""
    two = run_ranks(tmp_path, 2, _RANKER)
    one = run_ranks(tmp_path, 1, _RANKER)
    assert two[0]["model"] == two[1]["model"]
    np.testing.assert_allclose(two[0]["score"], one[0]["score"], rtol=0,
                               atol=1e-5)
