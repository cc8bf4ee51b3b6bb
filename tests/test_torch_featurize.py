"""The port's featurizers (``featurize/core``, ``featurize/text``) against
the JAX package's.

The same columns (numpy from a seed: numerics with NaN, vectors, low- and
high-cardinality strings, documents) go through each estimator or
transformer of both packages. Outputs are bit-equal: ``Featurize``'s
hashed columns and ``HashingTF`` hash with the port's native murmur, which
equals the JAX package's. The port's fitted models survive save/load.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.featurize import core as jcore
from mmlspark_tpu.featurize import text as jtext
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.featurize import core, text

from _torch_parity import assert_same

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "the", "and", "Epsilon", "zeta",
         "ÉTÉ", "naïve", "a", "of"]


def _columns(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.15] = np.nan
    docs = [" ".join(rng.choice(WORDS, size=rng.integers(0, 9)))
            + ("!  " if i % 3 else ", x") for i in range(n)]
    return {
        "num": x,
        "cnt": rng.integers(0, 9, size=n).astype(np.int64),
        "vec": rng.normal(size=(n, 3)).astype(np.float32),
        "low": np.asarray([f"c{v}" for v in rng.integers(0, 4, size=n)],
                          dtype=object),
        "high": np.asarray([f"id{v}" for v in rng.integers(0, 500, size=n)],
                           dtype=object),
        "doc": np.asarray(docs, dtype=object),
        "label": rng.integers(0, 2, size=n).astype(np.float64),
    }


def _pair(name, mod_pair, **kw):
    jmod, tmod = mod_pair
    return getattr(tmod, name)(**kw), getattr(jmod, name)(**kw)


CORE, TEXT = (jcore, core), (jtext, text)


def _run(stage, ds):
    return stage.fit(ds).transform(ds) if hasattr(stage, "fit") \
        else stage.transform(ds)


CASES = [
    ("ValueIndexer", CORE, dict(inputCol="low", outputCol="li")),
    ("ValueIndexer", CORE, dict(inputCol="num", outputCol="ni")),
    ("CleanMissingData", CORE, dict(inputCols=["num"])),
    ("CleanMissingData", CORE, dict(inputCols=["num"], cleaningMode="Median",
                                    outputCols=["nm"])),
    ("CleanMissingData", CORE, dict(inputCols=["num"], cleaningMode="Custom",
                                    customValue=-1.5)),
    ("DataConversion", CORE, dict(cols=["cnt"], convertTo="float")),
    ("DataConversion", CORE, dict(cols=["cnt", "num"], convertTo="string")),
    ("DataConversion", CORE, dict(cols=["cnt"], convertTo="boolean")),
    ("Featurize", CORE, dict(inputCols=["num", "cnt", "vec", "low", "high"],
                             numberOfFeatures=64)),
    ("Featurize", CORE, dict(numberOfFeatures=32, maxOneHotCardinality=3)),
    ("Featurize", CORE, dict(featureColumns={"f": ["num", "low"]},
                             oneHotEncodeCategoricals=False,
                             numberOfFeatures=16)),
    ("Tokenizer", TEXT, dict(inputCol="doc", outputCol="tok")),
    ("Tokenizer", TEXT, dict(inputCol="doc", outputCol="tok", gaps=False,
                             pattern=r"\w+", toLowercase=False,
                             minTokenLength=2)),
    ("PageSplitter", TEXT, dict(inputCol="doc", outputCol="pages",
                                maximumPageLength=12, minimumPageLength=6)),
    ("TextFeaturizer", TEXT, dict(inputCol="doc", outputCol="tf")),
    ("TextFeaturizer", TEXT, dict(inputCol="doc", outputCol="tf",
                                  useStopWordsRemover=True, useNGram=True,
                                  nGramLength=2, numFeatures=128,
                                  binary=True, minDocFreq=2)),
    ("TextFeaturizer", TEXT, dict(inputCol="doc", outputCol="tf",
                                  useIDF=False, numFeatures=64,
                                  tokenizerGaps=False,
                                  tokenizerPattern=r"[a-zé]+",
                                  toLowercase=False,
                                  caseSensitiveStopWords=True,
                                  useStopWordsRemover=True)),
]


@pytest.mark.parametrize("name,mods,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_stage_equals_jax(name, mods, kw):
    cols = _columns()
    t, j = _pair(name, mods, **kw)
    assert_same(_run(t, Dataset(dict(cols))), _run(j, JDataset(dict(cols))))


def test_token_stages_equal_jax():
    cols = _columns()
    tok = text.Tokenizer(inputCol="doc", outputCol="tok")
    jtok = jtext.Tokenizer(inputCol="doc", outputCol="tok")
    tds, jds = (tok.transform(Dataset(dict(cols))),
                jtok.transform(JDataset(dict(cols))))
    chain = [("StopWordsRemover", dict(inputCol="tok", outputCol="ns")),
             ("StopWordsRemover", dict(inputCol="tok", outputCol="ns2",
                                       stopWords=["alpha", "Beta"],
                                       caseSensitive=True)),
             ("NGram", dict(inputCol="tok", outputCol="ng", n=3)),
             ("MultiNGram", dict(inputCol="tok", outputCol="mng",
                                 lengths=[1, 3])),
             ("HashingTF", dict(inputCol="mng", outputCol="h",
                                numFeatures=97)),
             ("HashingTF", dict(inputCol="tok", outputCol="hb",
                                numFeatures=50, binary=True)),
             ("IDF", dict(inputCol="h", outputCol="idf", minDocFreq=2))]
    for name, kw in chain:
        t, j = _pair(name, TEXT, **kw)
        tds, jds = _run(t, tds), _run(j, jds)
        assert_same(tds, jds)


def test_index_to_value_equals_jax():
    cols = _columns()
    tm = core.ValueIndexer(inputCol="low", outputCol="li").fit(
        Dataset(dict(cols)))
    jm = jcore.ValueIndexer(inputCol="low", outputCol="li").fit(
        JDataset(dict(cols)))
    levels = tm.get_or_default("levels")
    assert levels == jm.get_or_default("levels")
    td = tm.transform(Dataset(dict(cols)))
    jd = jm.transform(JDataset(dict(cols)))
    assert_same(core.IndexToValue(inputCol="li", outputCol="back",
                                  levels=levels).transform(td),
                jcore.IndexToValue(inputCol="li", outputCol="back",
                                   levels=levels).transform(jd))


def test_featurize_hash_column_is_the_jax_hash():
    """String cells land in bucket ``murmur3_32(str(v), 0) % D``."""
    from mmlspark_tpu_torch.ops.murmur import murmur3_32_plain
    cols = _columns()
    D = 64
    out = core.Featurize(inputCols=["high"], numberOfFeatures=D,
                         maxOneHotCardinality=1).fit(
        Dataset(dict(cols))).transform(Dataset(dict(cols)))["features"]
    for i, v in enumerate(cols["high"]):
        assert out[i, murmur3_32_plain(str(v), 0) % D] == 1.0


@pytest.mark.parametrize("est", [
    core.Featurize(numberOfFeatures=32),
    core.ValueIndexer(inputCol="high", outputCol="hi"),
    core.CleanMissingData(inputCols=["num"], cleaningMode="Median"),
    text.TextFeaturizer(inputCol="doc", outputCol="tf", numFeatures=64,
                        useNGram=True),
    text.IDF(inputCol="vec", outputCol="vi"),
], ids=lambda e: type(e).__name__)
def test_fitted_model_round_trip(est, tmp_path):
    ds = Dataset(dict(_columns()))
    m = est.fit(ds)
    m.save(str(tmp_path / "m"))
    back = PipelineStage.load(str(tmp_path / "m"))
    assert type(back) is type(m)
    assert_same(back.transform(ds), m.transform(ds))
