"""The port's host stages (``stages/basic``, ``stages/batching``,
``stages/udfs``) against the JAX package's.

Each stage runs in both packages on the same columns (numpy from a seed)
and the outputs are equal value for value (``_torch_parity.assert_same``).
Save/load round trips of the port's stages reproduce their outputs. The
iterator batchers keep the JAX package's lifecycle: a producer's exception
reaches the consumer, an abandoned consumer releases the producer thread,
and the queue stays bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.stages import basic as jbasic
from mmlspark_tpu.stages import batching as jbatching
from mmlspark_tpu.stages import udfs as judfs
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.stages import basic, batching, udfs

from _torch_parity import assert_same

torch.set_num_threads(1)


def _columns(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return {
        "x": x,
        "k": rng.integers(0, 4, size=n).astype(np.int64),
        "y": rng.integers(0, 3, size=n).astype(np.float64),
        "v": rng.normal(size=(n, 3)).astype(np.float32),
        "s": np.asarray([f"Héllo wörld {i % 5} ﬁ" for i in range(n)],
                        dtype=object),
        "lists": [list(range(i % 4)) for i in range(n)],
    }


def _both(name, module_pair, **kw):
    jmod, tmod = module_pair
    return getattr(tmod, name)(**kw), getattr(jmod, name)(**kw)


BASIC = (jbasic, basic)
BATCHING = (jbatching, batching)

# (stage, kwargs, columns kept for the stage)
TRANSFORMERS = [
    ("DropColumns", dict(cols=["x", "lists"]), None),
    ("SelectColumns", dict(cols=["y", "s"]), None),
    ("RenameColumn", dict(inputCol="x", outputCol="xx"), None),
    ("Explode", dict(inputCol="lists", outputCol="item"), None),
    ("Cacher", {}, None),
    ("Repartition", dict(n=3), None),
    ("StratifiedRepartition", dict(labelCol="y", seed=3), None),
    ("EnsembleByKey", dict(keys=["k"], cols=["x", "v"]), ["k", "x", "v"]),
    ("EnsembleByKey", dict(keys=["k"], cols=["y"], collapseGroup=False,
                           colNames=["ym"]), ["k", "y"]),
    ("SummarizeData", {}, ["x", "k", "y", "s"]),
    ("TextPreprocessor", dict(inputCol="s", outputCol="t", normFunc="lowerCase",
                              map={"héllo": "hi", "wörld": "w", "1": "one"}),
     None),
    ("UnicodeNormalize", dict(inputCol="s", outputCol="u", form="NFKC"), None),
    ("UnicodeNormalize", dict(inputCol="s", outputCol="u", lower=False), None),
]


@pytest.mark.parametrize("name,kw,keep", TRANSFORMERS,
                         ids=[f"{t[0]}-{i}" for i, t in
                              enumerate(TRANSFORMERS)])
def test_transformer_equals_jax(name, kw, keep):
    cols = _columns()
    if keep:
        cols = {k: cols[k] for k in keep}
    t, j = _both(name, BASIC, **kw)
    assert_same(t.transform(Dataset(dict(cols))),
                j.transform(JDataset(dict(cols))))


def test_class_balancer_equals_jax():
    cols = _columns()
    t, j = _both("ClassBalancer", BASIC, inputCol="k")
    assert_same(t.fit(Dataset(dict(cols))).transform(Dataset(dict(cols))),
                j.fit(JDataset(dict(cols))).transform(JDataset(dict(cols))))


def test_udf_multicolumn_adapter_and_timer_equal_jax():
    cols = _columns()

    def double(col):
        return np.asarray(col) * 2.0

    for kw in (dict(inputCol="x", outputCol="x2"),
               dict(inputCols=["x", "y"], outputCol="xy")):
        fn = double if "inputCol" in kw else (lambda a, b: a + b)
        t = basic.UDFTransformer(udf=fn, **kw)
        j = jbasic.UDFTransformer(udf=fn, **kw)
        assert_same(t.transform(Dataset(dict(cols))),
                    j.transform(JDataset(dict(cols))))
    t = basic.MultiColumnAdapter(
        baseStage=basic.UnicodeNormalize(), inputCols=["s"],
        outputCols=["sn"])
    j = jbasic.MultiColumnAdapter(
        baseStage=jbasic.UnicodeNormalize(), inputCols=["s"],
        outputCols=["sn"])
    assert_same(t.transform(Dataset(dict(cols))),
                j.transform(JDataset(dict(cols))))
    tm = basic.Timer(stage=basic.ClassBalancer(inputCol="k")).fit(
        Dataset(dict(cols)))
    jm = jbasic.Timer(stage=jbasic.ClassBalancer(inputCol="k")).fit(
        JDataset(dict(cols)))
    assert_same(tm.transform(Dataset(dict(cols))),
                jm.transform(JDataset(dict(cols))))


def test_timer_trace_dir_writes_a_torch_trace(tmp_path):
    cols = _columns()
    tm = basic.Timer(stage=basic.Cacher(), traceDir=str(tmp_path)).fit(
        Dataset(dict(cols)))
    tm.transform(Dataset(dict(cols)))
    assert any(p.name.startswith("trace-") for p in tmp_path.iterdir())


def test_udfs_equal_jax():
    cols = _columns()
    for fn in ("get_value_at",):
        assert_same(getattr(udfs, fn)(Dataset(dict(cols)), "v", 1, "v1"),
                    getattr(judfs, fn)(JDataset(dict(cols)), "v", 1, "v1"))
    assert_same(udfs.to_vector(Dataset(dict(cols)), "lists", "vec"),
                judfs.to_vector(JDataset(dict(cols)), "lists", "vec"))


BATCHERS = [
    ("FixedMiniBatchTransformer", dict(batchSize=7)),
    ("DynamicMiniBatchTransformer", dict(maxBatchSize=16)),
    ("TimeIntervalMiniBatchTransformer", dict(maxBatchSize=9)),
]


@pytest.mark.parametrize("name,kw", BATCHERS, ids=[b[0] for b in BATCHERS])
def test_batching_round_trip_equals_jax(name, kw):
    cols = {k: v for k, v in _columns().items() if k != "lists"}
    t, j = _both(name, BATCHING, **kw)
    tb, jb = t.transform(Dataset(dict(cols))), j.transform(
        JDataset(dict(cols)))
    assert_same(tb, jb)
    assert_same(batching.FlattenBatch().transform(tb),
                jbatching.FlattenBatch().transform(jb))
    assert_same(batching.PadBatch(padToSize=16).transform(tb),
                jbatching.PadBatch(padToSize=16).transform(jb))


def test_iterator_batchers_equal_jax():
    data = list(range(103))
    assert (list(batching.fixed_batches(iter(data), 10))
            == list(jbatching.fixed_batches(iter(data), 10)))
    assert (list(batching.fixed_buffered_batches(iter(data), 10, 2))
            == list(jbatching.fixed_buffered_batches(iter(data), 10, 2)))
    dyn = list(batching.dynamic_buffered_batches(iter(data), 8))
    assert [x for b in dyn for x in b] == data and all(dyn)
    tib = list(batching.time_interval_batches(iter(data), 50.0, 16))
    assert [x for b in tib for x in b] == data
    assert max(len(b) for b in tib) <= 16


def _boom():
    yield 1
    yield 2
    raise KeyError("producer failed")


@pytest.mark.parametrize("make", [
    lambda it: batching.fixed_buffered_batches(it, 1, 1),
    lambda it: batching.dynamic_buffered_batches(it, 1),
    lambda it: batching.time_interval_batches(it, 5.0, 1, 1),
])
def test_producer_error_reaches_the_consumer(make):
    with pytest.raises(KeyError, match="producer failed"):
        for _ in make(_boom()):
            pass


def test_abandoned_consumer_releases_the_producer():
    """A consumer that stops early closes the generator: the feeder thread
    blocked on the full queue exits instead of staying pinned."""
    before = threading.active_count()
    gen = batching.fixed_buffered_batches(iter(range(10_000)), 1, 2)
    assert next(gen) == [0]
    gen.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() == before


def test_queue_stays_bounded():
    produced = []

    def slow_source():
        for i in range(50):
            produced.append(i)
            yield i

    gen = batching.fixed_buffered_batches(slow_source(), 1, 3)
    assert next(gen) == [0]
    time.sleep(0.2)
    # the one consumed, the queue's 3 and at most one held by the producer
    assert len(produced) <= 5
    gen.close()


SAVED = [
    basic.DropColumns(cols=["x"]),
    basic.RenameColumn(inputCol="x", outputCol="z"),
    basic.StratifiedRepartition(labelCol="y", seed=1),
    basic.TextPreprocessor(inputCol="s", outputCol="t", map={"H": "h"}),
    basic.EnsembleByKey(keys=["k"], cols=["x"]),
    batching.FixedMiniBatchTransformer(batchSize=5),
]


@pytest.mark.parametrize("stage", SAVED, ids=lambda s: type(s).__name__)
def test_save_load_round_trip(stage, tmp_path):
    cols = {k: v for k, v in _columns().items() if k != "lists"}
    stage.save(str(tmp_path / "s"))
    back = PipelineStage.load(str(tmp_path / "s"))
    assert type(back) is type(stage)
    assert_same(back.transform(Dataset(dict(cols))),
                stage.transform(Dataset(dict(cols))))


def test_class_balancer_model_round_trip(tmp_path):
    cols = _columns()
    m = basic.ClassBalancer(inputCol="k").fit(Dataset(dict(cols)))
    m.save(str(tmp_path / "m"))
    back = PipelineStage.load(str(tmp_path / "m"))
    assert_same(back.transform(Dataset(dict(cols))),
                m.transform(Dataset(dict(cols))))
