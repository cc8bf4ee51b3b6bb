"""The predict plan and the process-wide predictor cache: the port against
the JAX package.

Boosters trained by the JAX package (binary, 3-class, categorical) are
carried over with ``booster_from_jax_arrays``, and one golden LightGBM
model with zero-as-missing routing (``missing_dec``) is read by both, so
both packages plan and score the same forests:

  * ``plan.key``, ``n_pad``, ``T_pad``, ``t_end`` and
    ``predict_key_hash(plan.key)`` equal the JAX package's for every
    batch size, iteration count, lane and transform; so do the key
    manifest and the ``iter_predict_plans`` dedupe;
  * predictions through the plan equal the port's eager body
    (``predict_raw_tensor``) bit for bit, and the JAX package's within
    1e-5 (``test_torch_gbdt.py``'s tolerance);
  * each call makes one upload and one read-back (the two funnels
    shimmed, as the JAX package's tests shim its own);
  * the cache counts hits, misses and preloads, never clobbers a live
    entry, evicts the oldest past its bound, and serves four threads on
    one key (two boosters).

The CUDA-graph route (capture, static buffers, forest copy-in) runs only
on a GPU; ``chip_smoke.py`` phase 13 holds it against the eager body.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from mmlspark_tpu.models.gbdt import booster as jbm
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.booster import train_booster as jtrain
from mmlspark_tpu.models.gbdt.growth import GrowConfig as JGrowConfig
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models.gbdt import booster as tbm
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_arrays
from mmlspark_tpu_torch.models.gbdt.objectives import score_transform
from mmlspark_tpu_torch.observability import flight, metrics, roofline

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "resources", "lgbm_golden")
KINDS = ("binary", "multiclass", "categorical", "missing_dec")
LANES = ("f32", "bf16", "int8")
SIZES = (1, 3, 7, 32, 100, 8192, 9000)


def _port(jb) -> Booster:
    return booster_from_jax_arrays(
        {k: np.asarray(v) for k, v in jb.trees._asdict().items()},
        jb.thr_raw, jb.num_class, jb.base_score, jb.objective,
        depth_cap=jb.depth_cap, binner_state=jb.binner_state,
        objective_kwargs=jb.objective_kwargs, missing_dec=jb.missing_dec)


def _fit(kind, seed=3):
    rng = np.random.default_rng(seed)
    mesh = make_mesh(devices=jax.devices()[:1])
    if kind == "missing_dec":
        with open(os.path.join(CORPUS, "missing_zero", "model.txt")) as f:
            text = f.read()
        with open(os.path.join(CORPUS, "missing_zero",
                               "expected.json")) as f:
            X = np.asarray(json.load(f)["X"], np.float32)
        jb = JBooster.from_lightgbm_string(text)
        return jb, Booster.from_lightgbm_string(text), X
    X = rng.normal(size=(800, 5)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.03] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    kw = dict(num_iterations=6, max_bin=63, mesh=mesh,
              cfg=JGrowConfig(num_leaves=7, min_data_in_leaf=20))
    if kind == "binary":
        jb = jtrain(X, (x0 + x1 > 0).astype(np.float32), objective="binary",
                    **kw)
    elif kind == "multiclass":
        jb = jtrain(X, np.digitize(x0, [-0.5, 0.5]).astype(np.float32),
                    objective="multiclass", num_class=3, **kw)
    else:
        X[:, 1] = rng.integers(0, 6, size=len(X))
        y = (np.isin(X[:, 1], [1, 4]) ^ (x0 > 0)).astype(np.float32)
        jb = jtrain(X, y, objective="binary", categorical_features=(1,),
                    **kw)
    return jb, _port(jb), X


@pytest.fixture(scope="module")
def models():
    return {k: _fit(k) for k in KINDS}


def _plain(v) -> bool:
    """Every element of a key is a plain Python value or a tuple of them."""
    if isinstance(v, tuple):
        return all(_plain(x) for x in v)
    return v is None or type(v) in (int, float, bool, str)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_keys_equal_jax(models, kind):
    jb, tb, _ = models[kind]
    for lane in LANES:
        for tr in (True, False):
            for it in (-1, 0, 1, 2, 5):
                for n in SIZES:
                    jp = jb.predict_plan(n, it, transformed=tr,
                                         predict_dtype=lane)
                    tp = tb.predict_plan(n, it, transformed=tr,
                                         predict_dtype=lane)
                    assert tp.key == jp.key and _plain(tp.key)
                    assert repr(tp.key) == repr(jp.key)
                    assert (tp.n_pad, tp.T_pad, tp.t_end, tp.num_features,
                            tp.predict_dtype) == (
                        jp.n_pad, jp.T_pad, jp.t_end, jp.num_features,
                        jp.predict_dtype)
                    assert (tbm.predict_key_hash(tp.key)
                            == jbm.predict_key_hash(jp.key))
    if kind == "missing_dec":
        # imported missing-value routing degrades the narrow lanes to f32
        assert tb.predict_plan(4, predict_dtype="int8").predict_dtype == \
            "f32"


@pytest.mark.parametrize("kind", KINDS)
def test_manifest_and_dedupe_equal_jax(models, kind):
    jb, tb, _ = models[kind]
    sizes = [1, 2, 3, 4, 5, 8, 17, 32, 100]
    assert tbm.predict_key_manifest(tb, sizes, (-1, 2)) == \
        jbm.predict_key_manifest(jb, sizes, (-1, 2))
    got = [(m, tbm.predict_key_hash(p.key)) for m, p in
           tbm.iter_predict_plans(tb, sizes, (-1, 1), (True, False), LANES)]
    want = [(m, jbm.predict_key_hash(p.key)) for m, p in
            jbm.iter_predict_plans(jb, sizes, (-1, 1), (True, False), LANES)]
    assert got == want
    assert len({h for _, h in got}) == len(got)


def _eager(tb, X, it, lane, transformed):
    raw = tb.predict_raw_tensor(torch.from_numpy(X), it, predict_dtype=lane)
    if not transformed:
        return raw.numpy()
    return score_transform(tb.objective, tb.num_class,
                           **tb.objective_kwargs)(raw).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lane", LANES)
def test_plan_route_equals_eager_and_jax(models, kind, lane):
    jb, tb, X = models[kind]
    for n in (1, 7, 100):
        Xn = X[:n]
        for it in (-1, 2):
            raw = tb.predict_raw(Xn, it, device="cpu", predict_dtype=lane)
            pred = tb.predict(Xn, it, device="cpu", predict_dtype=lane)
            assert raw.tobytes() == _eager(tb, Xn, it, lane, False).tobytes()
            assert pred.tobytes() == _eager(tb, Xn, it, lane, True).tobytes()
            np.testing.assert_allclose(
                raw, jb.predict_raw(Xn, it, predict_dtype=lane), rtol=0,
                atol=1e-5)
            np.testing.assert_allclose(
                pred, jb.predict(Xn, it, predict_dtype=lane), rtol=0,
                atol=1e-5)


def test_rows_of_the_wrong_width_are_refused(models):
    _, tb, X = models["binary"]
    with pytest.raises(ValueError, match="rows must be"):
        tb.predict(X[:4, :3], device="cpu")


@pytest.mark.parametrize("lane,rows", [("f32", "f32"), ("bf16", "f32"),
                                       ("int8", "f32"), ("int8", "uint8")])
def test_one_upload_and_one_read_back_per_call(models, monkeypatch, lane,
                                               rows):
    from mmlspark_tpu_torch.models.gbdt import quantize as tq
    _, tb, X = models["binary"]
    Xn = X[:9]
    if rows == "uint8":
        Xn = tq.quantize_features(Xn, tq.feature_bounds(tb.binner_state))
    tb.predict(Xn, device="cpu", predict_dtype=lane)        # warm
    ups, downs = [], []
    to_dev, from_dev = tbm._to_device, tbm._from_device
    monkeypatch.setattr(tbm, "_to_device",
                        lambda *a, **k: ups.append(1) or to_dev(*a, **k))
    monkeypatch.setattr(tbm, "_from_device",
                        lambda x: downs.append(1) or from_dev(x))
    for _ in range(3):
        tb.predict(Xn, device="cpu", predict_dtype=lane)
    assert (len(ups), len(downs)) == (3, 3)


def _counter(name):
    return metrics.counter(name).value


def test_cache_hits_misses_preload_and_never_clobbers(models):
    _, tb, X = models["binary"]
    tbm._PREDICT_CACHE.clear()
    flight.clear()
    m0 = _counter("gbdt_predict_cache_misses_total")
    h0 = _counter("gbdt_predict_cache_hits_total")
    tb.predict(X[:5], device="cpu")
    assert _counter("gbdt_predict_cache_misses_total") == m0 + 1
    # one compile event, no persistent cache, a roofline entry with the
    # plan's bytes and no FLOPs
    ev = [e for e in flight.events() if e.get("kind") == "compile"]
    assert len(ev) == 1 and ev[0]["persistent_cache"] == ""
    key = tb.predict_plan(5).key
    entry, = [e for e in roofline.snapshot_payload()["executables"]
              if e["key"] == tbm.predict_key_hash(key)]
    assert entry["flops"] is None and entry["bytes_accessed"] > 0
    # 6 rows share the 8-row bucket; an equal booster shares the key
    tb.predict(X[:6], device="cpu")
    twin = _port(models["binary"][0])
    twin.predict(X[:8], device="cpu")
    assert _counter("gbdt_predict_cache_hits_total") == h0 + 2
    assert _counter("gbdt_predict_cache_misses_total") == m0 + 1
    live = tbm._PREDICT_CACHE[("cpu", key)]
    assert tbm.preload_predict_program(key, lambda *a: None,
                                       device="cpu") is False
    assert tbm._PREDICT_CACHE[("cpu", key)] is live
    # a preload of a new key installs and is counted apart
    plan = tb.predict_plan(16)
    prog = tbm._ObservedProgram(plan.make_program(torch.device("cpu")),
                                plan.key)
    prog.prepare(*tb.predict_plan_args(plan, "cpu"), plan.t_end,
                 observed=False)
    p0 = _counter("gbdt_predict_cache_preloads_total")
    assert tbm.preload_predict_program(plan.key, prog, device="cpu")
    assert _counter("gbdt_predict_cache_preloads_total") == p0 + 1
    flight.clear()
    m1 = _counter("gbdt_predict_cache_misses_total")
    out = tb.predict(X[:16], device="cpu")
    assert _counter("gbdt_predict_cache_misses_total") == m1
    assert [e for e in flight.events() if e.get("kind") == "compile"] == []
    np.testing.assert_array_equal(out, _eager(tb, X[:16], -1, "f32", True))
    # the device is part of the cache key, not of the plan key
    assert ("cuda", plan.key) not in tbm._PREDICT_CACHE


def test_lru_evicts_the_oldest_program(models, monkeypatch):
    _, tb, X = models["binary"]
    tbm._PREDICT_CACHE.clear()
    monkeypatch.setattr(tbm, "_PREDICT_CACHE_MAX", 3)
    for n in (1, 2, 4, 8):
        tb.predict(X[:n], device="cpu")
    keys = [k[1][3] for k in tbm._PREDICT_CACHE]       # n_pad of each key
    assert keys == [2, 4, 8]
    tb.predict(X[:2], device="cpu")                   # a hit refreshes it
    tb.predict(X[:16], device="cpu")
    assert [k[1][3] for k in tbm._PREDICT_CACHE] == [8, 2, 16]


def test_forest_arguments_are_a_bounded_lru(models):
    from mmlspark_tpu_torch.observability import hbm
    _, tb, X = models["binary"]
    tb.__dict__.pop("_plan_forest", None)
    before = hbm.claims().get("packed_trees", 0.0)
    for it, lane in ((1, "f32"), (2, "f32"), (3, "f32"), (-1, "bf16"),
                     (-1, "int8")):
        tb.predict(X[:3], it, device="cpu", predict_dtype=lane)
    assert list(tb._plan_forest) == [("cpu", 2, "f32"), ("cpu", 4, "f32"),
                                     ("cpu", 6, "bf16"), ("cpu", 6, "int8")]
    held = sum(tbm._forest_nbytes(f) for f in tb._plan_forest.values())
    assert hbm.claims()["packed_trees"] - before == pytest.approx(held)


def test_threads_on_one_key(models):
    jb, tb, X = models["multiclass"]
    twin = _port(jb)
    twin.trees["leaf_value"] = twin.trees["leaf_value"] * np.float32(0.5)
    want = {id(tb): _eager(tb, X[:20], -1, "f32", True),
            id(twin): _eager(twin, X[:20], -1, "f32", True)}
    assert tb.predict_plan(20).key == twin.predict_plan(20).key
    errors = []

    def run(b):
        try:
            for _ in range(15):
                got = b.predict(X[:20], device="cpu")
                if got.tobytes() != want[id(b)].tobytes():
                    errors.append("mismatch")
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(b,))
              for b in (tb, twin, tb, twin)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert errors == []


@pytest.mark.parametrize("kind", ("binary", "multiclass", "categorical"))
def test_pickled_booster_scores_equal_and_hits_the_cache(models, kind):
    """The JAX package's pickle contract: a round trip drops the device
    state (uploaded forests with their serials, active masks, bounds) and
    scores equal, through the program already cached for its key."""
    import pickle
    _, tb, X = models[kind]
    want = tb.predict(X[:33], device="cpu")
    for lane in ("bf16", "int8"):
        tb.predict(X[:33], device="cpu", predict_dtype=lane)
    tb.predict_raw_tensor(torch.from_numpy(np.ascontiguousarray(X[:8])))
    for name in Booster._DEVICE_STATE:
        assert getattr(tb, name, None), name
    cache_len = len(tbm._PREDICT_CACHE)
    h0 = _counter("gbdt_predict_cache_hits_total")
    state = tb.__getstate__()
    assert not set(Booster._DEVICE_STATE) & set(state)
    back = pickle.loads(pickle.dumps(tb))
    assert back._dev_forest == {}
    assert not hasattr(back, "_plan_forest")
    np.testing.assert_array_equal(back.predict(X[:33], device="cpu"), want)
    assert _counter("gbdt_predict_cache_hits_total") == h0 + 1
    assert len(tbm._PREDICT_CACHE) == cache_len
    assert back.model_string() == tb.model_string()


_SERIALS = """
import pickle, sys
import numpy as np
from mmlspark_tpu_torch.models.gbdt.booster import train_booster
rng = np.random.default_rng(rank)
X = rng.normal(size=(500, 4)).astype(np.float32)
b = train_booster(X, (X[:, rank] > 0).astype(np.float32), objective="binary",
                  num_iterations=3, device="cpu")
b.predict(X[:8], device="cpu")
ent = next(iter(b._plan_forest.values()))
result = {"serial": list(ent["serial"]),
          "dropped": "_plan_forest" not in pickle.loads(
              pickle.dumps(b)).__dict__}
"""


def test_forest_serials_do_not_collide_across_processes(tmp_path):
    """Two processes each upload one forest: their serials (a random
    per-process prefix and a counter) differ, where per-process counters
    alone both read 1."""
    from _torch_ranks import run_ranks
    out = [run_ranks(tmp_path, 1, _SERIALS.replace(
        "rank)", f"{r})").replace("rank]", f"{r}]"))[0] for r in (0, 1)]
    assert out[0]["serial"][1] == out[1]["serial"][1]
    assert out[0]["serial"] != out[1]["serial"]
    assert all(o["dropped"] for o in out)
