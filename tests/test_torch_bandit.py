"""The port's contextual bandit (``models/vw/bandit.py``) against the JAX
package's.

* Each policy function (epsilon-greedy, softmax, greedy, uniform, the
  bag/cover vote) equals the JAX one on the same scores and masks,
  within 2e-7 (``exp`` may round one ulp of 1.0 apart); a zero-action row
  scores all zeros.
* A fit of each exploration policy, with and without the interaction
  block, equals the JAX fit: weights within 1e-6, the IPS/SNIPS counters
  within 1e-4 relative (f32 sums over hundreds of events), probabilities
  within 2e-6 (softmax's ``exp`` of scores that differ by ulps). Ragged
  action lists, the bag's bootstrap draws and ``additionalSharedFeatures``
  are covered.
* ``fit_multiple`` on a thread pool equals the same fits in turn, bit for
  bit; ``VectorZipper`` and ``VowpalWabbitInteractions`` equal the JAX
  stages; a fitted model round-trips through save/load and ``convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.models.vw import bandit as jb
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.vw import bandit as tb
from mmlspark_tpu_torch.models.vw.convert import bandit_model_from_jax

from _torch_parity import assert_same

torch.set_num_threads(1)


def _scores_masks(seed=0, n=64, K=5):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, K)).astype(np.float32)
    scores[3, :] = 0.25                       # all tied
    mask = (rng.random((n, K)) > 0.3).astype(np.float32)
    mask[0] = 0.0                             # zero actions
    mask[1] = 0.0
    mask[1, 2] = 1.0                          # one action
    return scores, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name,args", [
    ("_epsilon_greedy", (0.1,)), ("_epsilon_greedy", (0.0,)),
    ("_softmax_policy", (1.5,)), ("_softmax_policy", (0.0,)),
    ("_greedy_policy", ()),
])
def test_policy_functions_equal_jax(name, args):
    scores, mask = _scores_masks()
    got = getattr(tb, name)(_t(scores), _t(mask), *args).numpy()
    want = np.asarray(getattr(jb, name)(jnp.asarray(scores),
                                        jnp.asarray(mask), *args))
    live = mask.sum(1) > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-7)
    # a zero-action row scores all zeros (the JAX softmax divides by its
    # 1e-38 floor, which XLA's CPU flushes to zero: NaN there)
    assert not got[~live].any()
    row = getattr(tb, name)(_t(scores[5]), _t(mask[5]), *args).numpy()
    np.testing.assert_allclose(row, want[5], rtol=0, atol=2e-7)


def test_uniform_and_vote_policies_equal_jax():
    scores, mask = _scores_masks(seed=1)
    np.testing.assert_array_equal(
        tb._uniform_policy(_t(mask)).numpy(),
        np.asarray(jb._uniform_policy(jnp.asarray(mask))))
    rng = np.random.default_rng(2)
    valid = [np.flatnonzero(m) if m.any() else np.arange(len(m))
             for m in mask]
    for N, smooth in ((4, 0.0), (3, 0.3), (1, 1.0)):
        # each member's greedy choice is a valid action (an argmin over
        # the masked scores)
        greedy = np.stack([rng.choice(v, size=N) for v in valid])
        got = tb._vote_policy(_t(greedy), _t(mask), N, smooth).numpy()
        for i in range(len(mask)):
            want = np.asarray(jb._vote_policy(jnp.asarray(greedy[i]),
                                              jnp.asarray(mask[i]), N,
                                              smooth))
            np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-7)


def _bandit_cols(n=240, k=4, ds=5, da=3, seed=0, ragged=True):
    """Shared contexts and per-row action lists (a short row every seventh
    when ``ragged``), a logged uniform policy and costs that favour the
    action closest to a hidden map of the context."""
    rng = np.random.default_rng(seed)
    shared = rng.normal(size=(n, ds)).astype(np.float32)
    proj = rng.normal(size=(ds, da)).astype(np.float32)
    acts, chosen, cost, prob = [], [], [], []
    for i in range(n):
        kk = k - 1 if ragged and i % 7 == 0 else k
        a = [rng.normal(size=da).astype(np.float32) for _ in range(kk)]
        c = int(rng.integers(0, kk))
        acts.append(a)
        chosen.append(c + 1)
        cost.append(float(-np.dot(shared[i] @ proj, a[c])
                          + 0.1 * rng.normal()))
        prob.append(1.0 / kk)
    return {"shared": shared, "extra": rng.normal(size=(n, 2)),
            "features": acts, "chosenAction": np.asarray(chosen),
            "label": np.asarray(cost), "probability": np.asarray(prob)}


POLICIES = [("epsilon", {}), ("softmax", {"softmaxLambda": 2.0}),
            ("first", {"tau": 60}), ("bag", {"bagSize": 4}),
            ("cover", {"coverSize": 3, "psi": 0.5})]


def _metrics_close(t, j):
    for k, v in vars(j).items():
        assert abs(getattr(t, k) - v) <= 1e-4 * max(1.0, abs(v)), k


@pytest.mark.parametrize("interact", [True, False])
@pytest.mark.parametrize("policy,extra", POLICIES,
                         ids=[p[0] for p in POLICIES])
def test_fit_equals_jax(policy, extra, interact):
    cols = _bandit_cols()
    kw = dict(explorationPolicy=policy, useInteractions=interact,
              numPasses=2, learningRate=0.3, **extra)
    tm = tb.VowpalWabbitContextualBandit(device="cpu", **kw).fit(
        Dataset(dict(cols)))
    jm = jb.VowpalWabbitContextualBandit(**kw).fit(JDataset(dict(cols)))
    for p in ("sharedWeights", "actionWeights", "interactionWeights"):
        a, b = tm.get_or_default(p), jm.get_or_default(p)
        assert (a is None) == (b is None), p
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=p)
    _metrics_close(tm.metrics, jm.metrics)
    got = tm.transform(Dataset(dict(cols)))["prediction"]
    want = jm.transform(JDataset(dict(cols)))["prediction"]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    assert_same(tm.get_performance_statistics(),
                jm.get_performance_statistics(), atol=1e-4)


def test_additional_shared_features_equal_jax():
    cols = _bandit_cols(seed=3, ragged=False)
    kw = dict(additionalSharedFeatures=["extra"], numPasses=1)
    tm = tb.VowpalWabbitContextualBandit(device="cpu", **kw).fit(
        Dataset(dict(cols)))
    jm = jb.VowpalWabbitContextualBandit(**kw).fit(JDataset(dict(cols)))
    assert tm.get_or_default("sharedWeights").shape == (1, 7)
    np.testing.assert_allclose(tm.get_or_default("sharedWeights"),
                               jm.get_or_default("sharedWeights"), atol=1e-6)


def test_fit_multiple_threads_equal_fits_in_turn():
    cols = _bandit_cols(n=120, seed=4)
    maps = [{"epsilon": 0.05}, {"explorationPolicy": "bag", "bagSize": 3},
            {"learningRate": 0.1, "useInteractions": False}]
    est = tb.VowpalWabbitContextualBandit(device="cpu", parallelism=2)
    threaded = est.fit_multiple(Dataset(dict(cols)), maps)
    serial = tb.VowpalWabbitContextualBandit(
        device="cpu", parallelism=1).fit_multiple(Dataset(dict(cols)), maps)
    assert len(threaded) == 3
    for a, b in zip(threaded, serial):
        for p in ("sharedWeights", "actionWeights"):
            np.testing.assert_array_equal(a.get_or_default(p),
                                          b.get_or_default(p))
        assert vars(a.metrics) == vars(b.metrics)
    assert threaded[0].get_or_default("epsilon") == 0.05


def test_validation_equals_jax():
    cols = _bandit_cols(n=30, seed=5)
    for mod, D in ((tb, Dataset), (jb, JDataset)):
        kw = {"device": "cpu"} if mod is tb else {}
        bad = dict(cols, chosenAction=np.zeros(30, np.int64))
        with pytest.raises(ValueError, match="1-based"):
            mod.VowpalWabbitContextualBandit(**kw).fit(D(bad))
        bad = dict(cols, chosenAction=np.full(30, 9))
        with pytest.raises(ValueError, match="exceeds"):
            mod.VowpalWabbitContextualBandit(**kw).fit(D(bad))
        bad = dict(cols, probability=np.zeros(30))
        with pytest.raises(ValueError, match="logged probability"):
            mod.VowpalWabbitContextualBandit(**kw).fit(D(bad))
        with pytest.raises(ValueError, match="explorationPolicy"):
            mod.VowpalWabbitContextualBandit(
                explorationPolicy="ucb", **kw).fit(D(dict(cols)))


def test_empty_action_row_transform_equals_jax():
    cols = _bandit_cols(n=40, seed=6)
    tm = tb.VowpalWabbitContextualBandit(device="cpu").fit(
        Dataset(dict(cols)))
    jm = jb.VowpalWabbitContextualBandit().fit(JDataset(dict(cols)))
    score = dict(cols, features=[[] if i == 2 else r
                                 for i, r in enumerate(cols["features"])])
    got = tm.transform(Dataset(dict(score)))["prediction"]
    want = jm.transform(JDataset(dict(score)))["prediction"]
    assert got[2] == want[2] == []
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_save_load_and_convert(tmp_path):
    cols = _bandit_cols(n=80, seed=7)
    tm = tb.VowpalWabbitContextualBandit(
        device="cpu", explorationPolicy="cover", coverSize=2).fit(
        Dataset(dict(cols)))
    tm.save(str(tmp_path / "m"))
    back = PipelineStage.load(str(tmp_path / "m"))
    assert vars(back.metrics) == vars(tm.metrics)
    assert_same(back.transform(Dataset(dict(cols))),
                tm.transform(Dataset(dict(cols))))
    jm = jb.VowpalWabbitContextualBandit(
        explorationPolicy="cover", coverSize=2).fit(JDataset(dict(cols)))
    conv = bandit_model_from_jax(
        jm.get_or_default("sharedWeights"), jm.get_or_default("actionWeights"),
        jm.get_or_default("interactionWeights"),
        params=jm.extract_param_map(), metrics=vars(jm.metrics),
        device="cpu")
    got = conv.transform(Dataset(dict(cols)))["prediction"]
    want = jm.transform(JDataset(dict(cols)))["prediction"]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-7)


def test_vector_zipper_and_interactions_equal_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(6, 3)) * (rng.random((6, 3)) > 0.3)
    b = rng.normal(size=(6, 4)) * (rng.random((6, 4)) > 0.4)
    cols = {"a": a, "b": b}
    assert_same(tb.VectorZipper(inputCols=["a", "b"], outputCol="z")
                .transform(Dataset(dict(cols))),
                jb.VectorZipper(inputCols=["a", "b"], outputCol="z")
                .transform(JDataset(dict(cols))))
    for kw in (dict(numBits=10), dict(numBits=3, sumCollisions=False)):
        assert_same(tb.VowpalWabbitInteractions(inputCols=["a", "b"],
                                                outputCol="q", **kw)
                    .transform(Dataset(dict(cols))),
                    jb.VowpalWabbitInteractions(inputCols=["a", "b"],
                                                outputCol="q", **kw)
                    .transform(JDataset(dict(cols))))


def test_metrics_semantics_equal_jax():
    for mod in (tb, jb):
        m = mod.ContextualBanditMetrics()
        m.add_example(0.5, 1.0, 0.25)
        m.add_example(0.5, 0.0, 0.5)
        m.add_example(0.5, 2.0, 0.0)
        assert m.total_events == 3 and m.offline_policy_events == 2
        assert m.get_ips_estimate() == pytest.approx(0.5 / 3)
        assert m.get_snips_estimate() == pytest.approx(0.5 / 1.5)
