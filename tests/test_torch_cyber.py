"""The port's CyberML package (``cyber/``) against the JAX package's.

* Host stages, copied: ``IdIndexer`` / ``MultiIndexer`` (with
  ``undo_transform``), ``StandardScalarScaler``, ``LinearScalarScaler``,
  ``ComplementAccessTransformer`` and ``DataFactory`` give equal outputs
  (the same ``default_rng`` draws).
* ``als_fit``'s initial factors (``anomaly._als_init``) are the JAX
  package's draws bit for bit (``jax.random.uniform`` under
  ``split(PRNGKey(seed))``, drawn by ``mmlspark_tpu_torch/utils/prng.py``;
  nothing is patched). Implicit and explicit fits, duplicates included:
  factors within 4x the spread that one ulp of input
  makes on the CPU (the port alone, ratings moved up one f32 ulp). The
  batched solves and the YtY product round in another order than XLA's,
  and ALS carries that through its sweeps as it carries an ulp of input.
* ``AccessAnomaly`` end to end (implicit; explicit with complement
  negatives): anomaly scores within 4x the spread that moving every
  other likelihood up two f32 ulps makes; the history's 0s, the
  components' ``inf`` and the cold rows' NaN equal.
* Two gloo ranks (``tests/_torch_ranks.py``) fit the same factors as one
  rank, within the same kind of bound (the partials are summed in two
  halves).
* Directories saved by the JAX package — ``AccessAnomalyModel`` (dicts
  keyed by tuples, a set of triples) and ``MultiIndexerModel`` (nested
  stages) — load in the port and transform equal; in a process that
  cannot import JAX, every model type of this slice loads and scores as
  the JAX package scored it.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.cyber import anomaly as janom
from mmlspark_tpu.cyber import complement as jcomp
from mmlspark_tpu.cyber import dataset as jdata
from mmlspark_tpu.cyber import feature as jfeat
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.cyber import anomaly as tanom
from mmlspark_tpu_torch.cyber import complement as tcomp
from mmlspark_tpu_torch.cyber import dataset as tdata
from mmlspark_tpu_torch.cyber import feature as tfeat

from _torch_ranks import run_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPREAD_FACTOR = 4.0


def _one_device():
    return jmesh.make_mesh({"data": 1}, devices=jax.devices()[:1])


def _jax_init(seed, n_users, n_items, rank):
    """The JAX package's initial factors (``als_fit``, its first lines)."""
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(ku, (n_users, rank),
                                          dtype=jnp.float32) * 0.1),
            np.asarray(jax.random.uniform(ki, (n_items, rank),
                                          dtype=jnp.float32) * 0.1))


def test_als_init_is_the_jax_draw():
    for seed, (u, i, r) in ((0, (7, 5, 3)), (11, (40, 23, 10)),
                            (-4, (1, 300, 2))):
        x0, y0 = tanom._als_init(seed, u, i, r, device="cpu")
        jx, jy = _jax_init(seed, u, i, r)
        assert x0.dtype == torch.float32 and x0.shape == (u, r)
        np.testing.assert_array_equal(x0.numpy(), jx)
        np.testing.assert_array_equal(y0.numpy(), jy)


def _same(a, b):
    assert len(a) == len(b)
    for c in b.columns:
        x, y = list(a[c]), list(b[c])
        assert x == y, c


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------


def _tenant_rows(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return {"tenant": list(rng.choice(["t1", "t2", "t3"], n)),
            "user": list(rng.choice([f"u{i}" for i in range(15)], n)),
            "res": list(rng.choice([f"r{i}" for i in range(12)], n)),
            "likelihood": rng.uniform(0, 50, n)}


@pytest.mark.parametrize("reset", [False, True])
def test_indexers_equal(reset):
    cols = _tenant_rows()
    j = jfeat.MultiIndexer(indexers=[
        jfeat.IdIndexer("user", "tenant", "u_idx", reset),
        jfeat.IdIndexer("res", "tenant", "r_idx", reset)]).fit(
        JDataset(dict(cols)))
    t = tfeat.MultiIndexer(indexers=[
        tfeat.IdIndexer("user", "tenant", "u_idx", reset),
        tfeat.IdIndexer("res", "tenant", "r_idx", reset)]).fit(
        Dataset(dict(cols)))
    probe = dict(cols, user=cols["user"][:-1] + ["unseen"])
    jo, to = j.transform(JDataset(dict(probe))), t.transform(
        Dataset(dict(probe)))
    _same(to, jo)
    _same(t.undo_transform(to), j.undo_transform(jo))
    assert (t.get_model_by_input_col("user").get_or_default("vocabulary")
            == j.get_model_by_input_col("user").get_or_default("vocabulary"))
    assert t.get_model_by_output_col("r_idx") is t.models[1]


@pytest.mark.parametrize("part", [None, "tenant"])
def test_scalers_equal(part):
    cols = _tenant_rows(seed=1)
    cols["likelihood"][cols["tenant"].index("t2")] = np.nan
    cols_c = dict(cols, likelihood=np.full(200, 3.0))
    for jcls, tcls, kw in (
            (jfeat.StandardScalarScaler, tfeat.StandardScalarScaler,
             dict(coefficientFactor=2.0)),
            (jfeat.LinearScalarScaler, tfeat.LinearScalarScaler,
             dict(minRequiredValue=5.0, maxRequiredValue=10.0))):
        for c in (cols, cols_c):
            j = jcls("likelihood", part, "out", **kw).fit(JDataset(dict(c)))
            t = tcls("likelihood", part, "out", **kw).fit(Dataset(dict(c)))
            np.testing.assert_array_equal(
                t.transform(Dataset(dict(c))).array("out"),
                j.transform(JDataset(dict(c))).array("out"))


@pytest.mark.parametrize("factor,part", [(2, "tenant"), (3, None), (0, None)])
def test_complement_access_equal(factor, part):
    rng = np.random.default_rng(2)
    cols = {"tenant": list(rng.choice([0, 1], 80)),
            "u": rng.integers(1, 9, 80), "r": rng.integers(1, 7, 80)}
    j = jcomp.ComplementAccessTransformer(part, ["u", "r"], factor,
                                          seed=5).transform(
        JDataset(dict(cols)))
    t = tcomp.ComplementAccessTransformer(part, ["u", "r"], factor,
                                          seed=5).transform(
        Dataset(dict(cols)))
    _same(t, j)


def test_data_factory_equal():
    sizes = dict(num_users={"hr": 9, "fin": 6, "eng": 12},
                 num_resources={"hr": 20, "fin": 15, "eng": 30})
    j, t = jdata.DataFactory(seed=3, **sizes), tdata.DataFactory(seed=3,
                                                                 **sizes)
    jt = j.create_clustered_training_data(0.3)
    tt = t.create_clustered_training_data(0.3)
    _same(tt, jt)
    _same(t.create_clustered_intra_test_data(tt),
          j.create_clustered_intra_test_data(jt))
    _same(t.create_clustered_inter_test_data(),
          j.create_clustered_inter_test_data())


# ---------------------------------------------------------------------------
# ALS
# ---------------------------------------------------------------------------


def _coo(seed=0, nu=50, ni=30, nnz=600):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu, nnz)
    i = rng.integers(0, ni, nnz)
    u[:40], i[:40] = u[40:80], i[40:80]          # duplicate observations
    return u, i, rng.uniform(5.0, 10.0, nnz), nu, ni


def _one_ulp_up(x):
    return np.nextafter(np.asarray(x, np.float32),
                        np.float32(np.inf)).astype(np.float64)


def _spread(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("implicit", [True, False])
def test_als_fit_within_the_one_ulp_spread(implicit):
    u, i, r, nu, ni = _coo()
    args = (nu, ni, 10, 25, 1.0, implicit, 1.0, 0)
    with jmesh.default_mesh(_one_device()):
        want = janom.als_fit(u, i, r, *args)
    got = tanom.als_fit(u, i, r, *args, device="cpu")
    moved = tanom.als_fit(u, i, _one_ulp_up(r), *args, device="cpu")
    spread = _spread(got, moved)
    assert 0 < spread < 0.05
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert (g >= 0).all()
    assert _spread(got, want) <= SPREAD_FACTOR * spread


def test_als_two_gloo_ranks_equal_one(tmp_path):
    u, i, r, nu, ni = _coo(seed=1, nnz=501)       # padded to 2 x 251
    one = tanom.als_fit(u, i, r, nu, ni, 6, 10, 1.0, True, 1.0, 3,
                        device="cpu")
    moved = tanom.als_fit(u, i, _one_ulp_up(r), nu, ni, 6, 10, 1.0, True,
                          1.0, 3, device="cpu")
    np.savez(tmp_path / "coo.npz", u=u, i=i, r=r)
    body = f"""
    from mmlspark_tpu_torch.cyber.anomaly import als_fit
    z = np.load({str(tmp_path / 'coo.npz')!r})
    x, y = als_fit(z["u"], z["i"], z["r"], {nu}, {ni}, 6, 10, 1.0, True,
                   1.0, 3, device="cpu")
    result = [x.tolist(), y.tolist()]
    """
    outs = run_ranks(tmp_path, 2, body)
    assert outs[0] == outs[1]
    two = [np.asarray(a, np.float32) for a in outs[0]]
    assert _spread(two, one) <= SPREAD_FACTOR * _spread(one, moved)


def _scores(model_j, model_t, ds_cols):
    return (model_t.transform(Dataset(dict(ds_cols))).array("anomaly_score"),
            model_j.transform(JDataset(dict(ds_cols))).array("anomaly_score"))


def _factory_data(seed=4):
    f = jdata.DataFactory(num_users={"hr": 8, "fin": 6, "eng": 10},
                          num_resources={"hr": 14, "fin": 10, "eng": 18},
                          seed=seed)
    train = f.create_clustered_training_data(0.4)
    cols = {c: list(train[c]) for c in train.columns}
    cols["likelihood"] = train.array("likelihood")
    tests = [f.create_clustered_intra_test_data(train),
             f.create_clustered_inter_test_data()]
    probe = {c: sum((list(t[c]) for t in tests), list(cols[c][:20]))
             for c in ("tenant", "user", "res")}
    probe["user"][-1] = "cold_user"
    return cols, probe


@pytest.mark.parametrize("kw", [dict(maxIter=10),
                                dict(maxIter=8, applyImplicitCf=False,
                                     complementsetFactor=2)],
                         ids=["implicit", "explicit"])
def test_access_anomaly_scores_within_the_spread(kw):
    cols, probe = _factory_data()
    with jmesh.default_mesh(_one_device()):
        jm = janom.AccessAnomaly(**kw).fit(JDataset(dict(cols)))
    tm = tanom.AccessAnomaly(device="cpu", **kw).fit(Dataset(dict(cols)))
    # every other likelihood a couple of f32 ulps up (moving all of them by
    # one factor would scale out in the per-tenant rescaling)
    lik = cols["likelihood"].copy()
    lik[::2] *= 1 + 2.0 ** -22
    moved = dict(cols, likelihood=lik)
    tmm = tanom.AccessAnomaly(device="cpu", **kw).fit(Dataset(moved))
    got, want = _scores(jm, tm, probe)
    shifted = tmm.transform(Dataset(dict(probe))).array("anomaly_score")
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)],
                                  want[~finite & ~np.isnan(want)])
    assert np.isnan(got[-1]) and (got == 0).sum() >= 20
    spread = float(np.abs(shifted - got)[finite].max())
    assert 0 < spread
    assert float(np.abs(got - want)[finite].max()) <= SPREAD_FACTOR * spread
    assert (set(tm.user_mapping) == set(jm.user_mapping)
            and set(tm.res_mapping) == set(jm.res_mapping))
    assert (tm.get_or_default("historyAccess")
            == jm.get_or_default("historyAccess"))


def test_access_anomaly_refusals_equal():
    ds = Dataset(_tenant_rows())
    for kw in (dict(applyImplicitCf=True, negScore=1.0),
               dict(applyImplicitCf=False, alphaParam=1.0),
               dict(lowValue=5.0, highValue=None),
               dict(lowValue=0.5, highValue=10.0),
               dict(lowValue=5.0, highValue=5.0),
               dict(applyImplicitCf=False, lowValue=5.0, highValue=10.0,
                    negScore=6.0)):
        with pytest.raises(ValueError) as t_err:
            tanom.AccessAnomaly(device="cpu", **kw).fit(ds)
        with pytest.raises(ValueError) as j_err:
            janom.AccessAnomaly(**kw).fit(JDataset(_tenant_rows()))
        assert str(t_err.value) == str(j_err.value)


def test_jax_saved_anomaly_and_indexer_load_equal(tmp_path):
    cols, probe = _factory_data(seed=6)
    with jmesh.default_mesh(_one_device()):
        jm = janom.AccessAnomaly(maxIter=5).fit(JDataset(dict(cols)))
    jm.save(str(tmp_path / "aa"))
    tm = PipelineStage.load(str(tmp_path / "aa"))
    assert type(tm) is tanom.AccessAnomalyModel
    got, want = _scores(jm, tm, probe)
    np.testing.assert_array_equal(got, want)
    conv = tanom.access_anomaly_from_jax(jm.extract_param_map())
    np.testing.assert_array_equal(_scores(jm, conv, probe)[0], want)
    ji = jfeat.MultiIndexer(indexers=[
        jfeat.IdIndexer("user", "tenant", "u_idx"),
        jfeat.IdIndexer("res", "tenant", "r_idx", True)]).fit(
        JDataset(dict(cols)))
    ji.save(str(tmp_path / "mi"))
    ti = PipelineStage.load(str(tmp_path / "mi"))
    assert type(ti) is tfeat.MultiIndexerModel
    assert all(type(m) is tfeat.IdIndexerModel for m in ti.models)
    _same(ti.transform(Dataset(dict(probe))),
          ji.transform(JDataset(dict(probe))))


BLOCK_JAX = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mmlspark_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def test_jax_saved_models_load_without_jax(tmp_path, monkeypatch):
    """IsolationForestModel, KNNModel, ConditionalKNNModel, SARModel (both
    formats), MultiIndexerModel and AccessAnomalyModel saved by the JAX
    package load in a port process where importing jax or the JAX package
    raises, and score as the JAX package scored them."""
    from mmlspark_tpu.models.isolation_forest import IsolationForest
    from mmlspark_tpu.nn.knn import KNN, ConditionalKNN
    from mmlspark_tpu.recommendation import sar as jsar
    rng = np.random.default_rng(8)
    X = rng.integers(0, 4, size=(200, 4)).astype(np.float32)
    lab = rng.integers(0, 3, 200)
    u = rng.integers(0, 20, 300).astype(np.int32)
    it = rng.integers(0, 15, 300).astype(np.int32)
    sar_cols = {"user_idx": u, "item_idx": it}
    cols, probe = _factory_data(seed=7)
    with jmesh.default_mesh(_one_device()):
        models = {
            "if": IsolationForest(numEstimators=20,
                                  contamination=0.1).fit(
                JDataset({"features": X})),
            "knn": KNN(k=5).fit(JDataset({"features": X})),
            "cknn": ConditionalKNN(k=5).fit(JDataset({"features": X,
                                                      "label": lab})),
            "sar": jsar.SAR(supportThreshold=1).fit(JDataset(sar_cols)),
            "aa": janom.AccessAnomaly(maxIter=4).fit(JDataset(dict(cols))),
        }
        monkeypatch.setattr(jsar, "DENSE_CELLS_MAX", 0)
        models["sar_sparse"] = jsar.SAR(supportThreshold=1).fit(
            JDataset(sar_cols))
    models["mi"] = jfeat.MultiIndexer(indexers=[
        jfeat.IdIndexer("user", "tenant", "u_idx")]).fit(JDataset(dict(cols)))
    for name, m in models.items():
        m.save(str(tmp_path / name))
    conds = [[0, 1]] * 200
    want = {
        "if": models["if"].transform(JDataset({"features": X})).array(
            "prediction"),
        "knn": [[d["value"] for d in r] for r in models["knn"].transform(
            JDataset({"features": X}))["matches"]],
        "cknn": [[d["value"] for d in r] for r in models["cknn"].transform(
            JDataset({"features": X, "conditioner": conds}))["matches"]],
        "sar": np.stack(models["sar"].recommend_for_all_users(5)[
            "recommendations"]),
        "sar_sparse": np.stack(models["sar_sparse"].recommend_for_all_users(
            5)["recommendations"]),
        "aa": models["aa"].transform(JDataset(dict(probe))).array(
            "anomaly_score"),
        "mi": models["mi"].transform(JDataset(dict(probe))).array("u_idx"),
    }
    import pickle
    with open(tmp_path / "want.pkl", "wb") as f:
        pickle.dump({"want": want, "X": X, "probe": probe, "conds": conds}, f)
    code = BLOCK_JAX + textwrap.dedent(f"""
    import pickle, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.core.dataset import Dataset
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    d = pickle.load(open({str(tmp_path / 'want.pkl')!r}, "rb"))
    w, X = d["want"], d["X"]
    m = {{n: PipelineStage.load({str(tmp_path)!r} + "/" + n)
         for n in w}}
    for n in ("if", "knn", "cknn", "sar", "sar_sparse"):
        m[n].set(device="cpu")
    assert all(type(s).__module__.startswith("mmlspark_tpu_torch.")
               for s in m.values())
    assert np.array_equal(m["if"].transform(Dataset({{"features": X}})).array(
        "prediction"), w["if"])
    assert [[r["value"] for r in row] for row in m["knn"].transform(
        Dataset({{"features": X}}))["matches"]] == w["knn"]
    assert [[r["value"] for r in row] for row in m["cknn"].transform(
        Dataset({{"features": X, "conditioner": d["conds"]}}))["matches"]
        ] == w["cknn"]
    for n in ("sar", "sar_sparse"):
        assert np.array_equal(np.stack(m[n].recommend_for_all_users(5)[
            "recommendations"]), w[n])
    assert np.array_equal(m["aa"].transform(Dataset(dict(d["probe"]))).array(
        "anomaly_score"), w["aa"], equal_nan=True)
    assert np.array_equal(m["mi"].transform(Dataset(dict(d["probe"]))).array(
        "u_idx"), w["mi"])
    bad = [n for n in sys.modules if n.split(".")[0] in
           ("jax", "jaxlib", "mmlspark_tpu")]
    assert not bad, bad
    print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
