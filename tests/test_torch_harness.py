"""The port's test harnesses (``core/datagen``, ``core/benchmarks``,
``core/fuzzing``) against the JAX package's, and the fuzzing gate over
the port's own stages.

* ``generate_dataset`` gives the JAX package's arrays for the same specs
  and seed (bit-equal, object columns element by element).
* A ``Benchmarks`` suite writes the JAX package's CSV byte for byte; each
  package verifies against the other's baseline, and both refuse a drift.
* ``discover_stages()`` defaults to the port and finds every concrete stage
  of it; every one is fuzzed (fit/transform smoke plus save/load round
  trip) through a ``TestObject`` here, is a model an estimator here
  produces, or is exempt with a reason.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import benchmarks as jbench
from mmlspark_tpu.core import datagen as jgen
from mmlspark_tpu_torch.core import benchmarks as tbench
from mmlspark_tpu_torch.core import datagen as tgen
from mmlspark_tpu_torch.automl import core as automl
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.fuzzing import (TestObject, discover_stages,
                                             experiment_fuzz,
                                             serialization_fuzz)
from mmlspark_tpu_torch.core.pipeline import (Lambda, Pipeline,
                                              PipelineStage, Transformer)
from mmlspark_tpu_torch.cyber import anomaly, complement
from mmlspark_tpu_torch.cyber import feature as cfeat
from mmlspark_tpu_torch.explain import lime
from mmlspark_tpu_torch.featurize import core as fcore
from mmlspark_tpu_torch.featurize import text as ftext
from mmlspark_tpu_torch.image import ops as image
from mmlspark_tpu_torch.models import isolation_forest as iforest
from mmlspark_tpu_torch.models.dnn import cnn, scoring
from mmlspark_tpu_torch.models.gbdt import api as gbdt
from mmlspark_tpu_torch.models.vw import api as vw
from mmlspark_tpu_torch.models.vw import bandit, featurizer
from mmlspark_tpu_torch.nn import knn
from mmlspark_tpu_torch.recommendation import ranking, sar
from mmlspark_tpu_torch.stages import basic, batching
from mmlspark_tpu_torch.train import core as train
from mmlspark_tpu_torch.utils import prng

from _torch_parity import assert_same

torch.set_num_threads(1)


def _specs(mod):
    return [mod.numeric("x", -2.0, 3.0, missing_fraction=0.2),
            mod.numeric("i", -3.5, 9.2, dtype="int32"),
            mod.numeric("d", dtype="float64"),
            mod.categorical("c", ["a", "b", 7, None]),
            mod.text("t", ["alpha", "beta", "gamma"], words_per_row=4),
            mod.boolean("b"),
            mod.labels("y", num_classes=3)]


@pytest.mark.parametrize("seed,n", [(0, 50), (11, 1), (3, 0)])
def test_generate_dataset_equals_jax(seed, n):
    t = tgen.generate_dataset(_specs(tgen), n, seed=seed)
    j = jgen.generate_dataset(_specs(jgen), n, seed=seed)
    assert_same(t, j)


def test_generate_dataset_validation_equals_jax():
    for mod in (tgen, jgen):
        with pytest.raises(ValueError, match="duplicate"):
            mod.generate_dataset([mod.boolean("a"), mod.boolean("a")], 3)
        with pytest.raises(ValueError, match="missing_fraction"):
            mod.numeric("x", missing_fraction=2.0)
        with pytest.raises(ValueError, match="NaN"):
            mod.generate_dataset([mod.numeric("x", missing_fraction=0.5,
                                              dtype="int64")], 4)


def _suite(mod, bump=0.0):
    b = mod.Benchmarks("port_parity")
    b.record("auc", 0.8123456789 + bump, 1e-4)
    b.record("rmse", 1.25, 1e-3)
    b.record("rows", 1000)
    return b


def test_benchmarks_csv_equals_jax_and_verifies_across(tmp_path):
    tp = _suite(tbench).write(str(tmp_path / "t"))
    jp = _suite(jbench).write(str(tmp_path / "j"))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    _suite(tbench).verify(str(tmp_path / "j"))
    _suite(jbench).verify(str(tmp_path / "t"))
    assert tbench.Benchmarks.read(jp).keys() == jbench.Benchmarks.read(
        tp).keys()
    for mod, base in ((tbench, "j"), (jbench, "t")):
        with pytest.raises(AssertionError, match="auc"):
            _suite(mod, bump=1e-3).verify(str(tmp_path / base))
    with pytest.raises(AssertionError, match="no baseline"):
        _suite(tbench).verify(str(tmp_path / "empty"))
    assert (tmp_path / "empty" / "new_benchmarks"
            / "benchmarks_port_parity.csv").exists()


# ---------------------------------------------------------------------------
# The fuzzing gate over the port's stages
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(7)
_N = 24
_X = _rng.normal(size=(_N, 4)).astype(np.float32)
_Y = (_X[:, 0] + 0.3 * _rng.normal(size=_N) > 0).astype(np.float64)

TAB = Dataset({
    "features": _X, "label": _Y, "num": np.linspace(0.0, 1.0, _N),
    "cat": np.asarray([("a" if i % 3 else "b") for i in range(_N)], object),
    "text": np.asarray([f"row {i} some words here" for i in range(_N)],
                       object),
    "lists": [list(range(i % 3)) for i in range(_N)],
})
HASHED = featurizer.VowpalWabbitFeaturizer(
    inputCols=["features", "cat"], numBits=12).transform(TAB)
BANDIT = Dataset({
    "shared": np.eye(3, dtype=np.float32)[np.arange(24) % 3],
    "features": [[np.eye(3, dtype=np.float32)[a] for a in range(3)]
                 for _ in range(24)],
    "chosenAction": (np.arange(24) % 3) + 1,
    "label": (_rng.random(24) > 0.5).astype(np.float64),
    "probability": np.full(24, 1.0 / 3),
})
GROUPED = Dataset({"features": _X, "label": _Y,
                   "group": np.repeat(np.arange(4), _N // 4)})
SCORED = Dataset({"label": _Y, "prediction": (_X[:, 0] > 0).astype(float),
                  "probability": np.stack([1 - _Y * 0.8 - 0.1,
                                           _Y * 0.8 + 0.1], 1)})


KNN_DS = Dataset({"features": _X, "values": list(range(_N)),
                  "label": ["p" if v > 0 else "n" for v in _Y]})
REC = Dataset({"user_idx": np.repeat(np.arange(6), 4),
               "item_idx": np.tile(np.arange(4), 6),
               "rating": np.ones(24),
               "user": [f"u{i}" for i in np.repeat(np.arange(6), 4)],
               "item": [f"i{i}" for i in np.tile(np.arange(4), 6)]})
CYBER = Dataset({"tenant": ["t0"] * 12 + ["t1"] * 12,
                 "user": [f"u{i % 4}" for i in range(24)],
                 "res": [f"r{i % 3}" for i in range(24)],
                 "likelihood": np.abs(_rng.normal(size=24)) + 1.0})


IMG = Dataset({"img": [_rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
                       for _ in range(4)],
               "label": np.arange(4.0)})
TEXT = Dataset({"text": ["a good movie", "a bad movie", "the plot was thin"]})


def _png(arr):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class _ProbeModel(Transformer):
    """An inner model for the LIME stages (module level, so picklable)."""

    def transform(self, ds: Dataset) -> Dataset:
        if "features" in ds:
            score = np.asarray([float(np.sum(v)) for v in ds["features"]])
        else:
            score = np.asarray([float(len(str(t))) for t in ds["text"]])
        return ds.with_column("probability", score)


class _ImgProbeModel(Transformer):
    def transform(self, ds: Dataset) -> Dataset:
        return ds.with_column("probability", np.asarray(
            [float(np.mean(np.asarray(v, np.float32))) for v in ds["img"]]))


_CNN = cnn.CNNConfig(num_classes=3, stage_sizes=(1,), width=4,
                     input_hw=(16, 16))
_SPEC = {"kind": "cnn", "config": {"num_classes": 3, "stage_sizes": (1,),
                                   "width": 4, "input_hw": (16, 16)}}
DNN = scoring.DNNModel(cnn.init_cnn_params(_CNN, prng.prng_key(0)),
                       apply_spec=_SPEC, device="cpu")


def _double(v):
    return np.asarray(v) * 2


def _add_sum(ds: Dataset) -> Dataset:
    return ds.with_column("sum", np.asarray(ds["features"]).sum(1))


GB = dict(numIterations=2, numLeaves=4, minDataInLeaf=3, device="cpu")

REGISTRY = [
    TestObject(Pipeline([basic.Cacher(), basic.DropColumns(cols=["num"])]),
               TAB),
    TestObject(Lambda(fn=_add_sum), TAB),
    TestObject(fcore.CleanMissingData(inputCols=["num"]), TAB,
               produces=[fcore.CleanMissingDataModel]),
    TestObject(fcore.DataConversion(cols=["num"], convertTo="float"), TAB),
    TestObject(fcore.Featurize(numberOfFeatures=8), TAB,
               produces=[fcore.FeaturizeModel]),
    TestObject(fcore.ValueIndexer(inputCol="cat", outputCol="ci"), TAB,
               produces=[fcore.ValueIndexerModel]),
    TestObject(fcore.IndexToValue(inputCol="ci", outputCol="back",
                                  levels=["a", "b"]),
               TAB.with_column("ci", np.arange(_N) % 3)),
    TestObject(ftext.HashingTF(inputCol="lists", outputCol="h",
                               numFeatures=16),
               TAB.with_column("lists", [[f"w{j}" for j in range(i % 4)]
                                         for i in range(_N)])),
    TestObject(ftext.IDF(inputCol="features", outputCol="idf"), TAB,
               produces=[ftext.IDFModel]),
    TestObject(ftext.MultiNGram(inputCol="toks", outputCol="g"),
               TAB.with_column("toks", [["a", "b", "c"][:i % 4]
                                        for i in range(_N)])),
    TestObject(ftext.NGram(inputCol="toks", outputCol="g"),
               TAB.with_column("toks", [["a", "b", "c"][:i % 4]
                                        for i in range(_N)])),
    TestObject(ftext.PageSplitter(inputCol="text", outputCol="p",
                                  maximumPageLength=8, minimumPageLength=4),
               TAB),
    TestObject(ftext.StopWordsRemover(inputCol="toks", outputCol="s"),
               TAB.with_column("toks", [["the", "plot", "a"]] * _N)),
    TestObject(ftext.TextFeaturizer(inputCol="text", outputCol="tf",
                                    numFeatures=16), TAB,
               produces=[ftext.TextFeaturizerModel]),
    TestObject(ftext.Tokenizer(inputCol="text", outputCol="tok"), TAB),
    TestObject(gbdt.LightGBMClassifier(**GB), TAB,
               produces=[gbdt.LightGBMClassificationModel]),
    TestObject(gbdt.LightGBMRegressor(**GB), TAB,
               produces=[gbdt.LightGBMRegressionModel]),
    TestObject(gbdt.LightGBMRanker(groupCol="group", **GB), GROUPED,
               produces=[gbdt.LightGBMRankerModel]),
    TestObject(vw.VowpalWabbitClassifier(numBits=12, device="cpu"), HASHED,
               produces=[vw.VowpalWabbitClassificationModel]),
    TestObject(vw.VowpalWabbitRegressor(numBits=12, device="cpu"), HASHED,
               produces=[vw.VowpalWabbitRegressionModel]),
    TestObject(bandit.VowpalWabbitContextualBandit(device="cpu"), BANDIT,
               produces=[bandit.VowpalWabbitContextualBanditModel]),
    TestObject(bandit.VectorZipper(inputCols=["num", "label"],
                                   outputCol="z"), TAB),
    TestObject(bandit.VowpalWabbitInteractions(inputCols=["features",
                                                          "features"],
                                               outputCol="q", numBits=10),
               TAB),
    TestObject(featurizer.VowpalWabbitFeaturizer(inputCols=["num", "text"],
                                                 stringSplitInputCols=[
                                                     "text"]), TAB),
    TestObject(basic.Cacher(), TAB),
    TestObject(basic.ClassBalancer(inputCol="label"), TAB,
               produces=[basic.ClassBalancerModel]),
    TestObject(basic.DropColumns(cols=["num"]), TAB),
    TestObject(basic.EnsembleByKey(keys=["cat"], cols=["num"]), TAB),
    TestObject(basic.Explode(inputCol="lists", outputCol="item"), TAB),
    TestObject(basic.MultiColumnAdapter(
        baseStage=basic.UnicodeNormalize(), inputCols=["text"],
        outputCols=["tn"]), TAB),
    TestObject(basic.RenameColumn(inputCol="num", outputCol="n2"), TAB),
    TestObject(basic.Repartition(n=3), TAB),
    TestObject(basic.SelectColumns(cols=["num", "cat"]), TAB),
    TestObject(basic.StratifiedRepartition(labelCol="label"), TAB),
    TestObject(basic.SummarizeData(), TAB.select("num", "label")),
    TestObject(basic.TextPreprocessor(inputCol="text", outputCol="t2",
                                      map={"row": "ROW"}), TAB),
    TestObject(basic.Timer(stage=basic.Cacher()), TAB,
               produces=[basic.TimerModel]),
    TestObject(basic.UDFTransformer(udf=_double, inputCol="num",
                                    outputCol="d"), TAB),
    TestObject(basic.UnicodeNormalize(inputCol="text", outputCol="u"), TAB),
    TestObject(batching.DynamicMiniBatchTransformer(maxBatchSize=5),
               TAB.select("num", "label")),
    TestObject(batching.FixedMiniBatchTransformer(batchSize=5),
               TAB.select("num", "label")),
    TestObject(batching.TimeIntervalMiniBatchTransformer(maxBatchSize=7),
               TAB.select("num", "label")),
    TestObject(batching.FlattenBatch(),
               batching.FixedMiniBatchTransformer(batchSize=5).transform(
                   TAB.select("num", "label"))),
    TestObject(batching.PadBatch(padToSize=5),
               batching.FixedMiniBatchTransformer(batchSize=5).transform(
                   TAB.select("num", "label"))),
    TestObject(iforest.IsolationForest(numEstimators=10, device="cpu"),
               TAB.select("features"),
               produces=[iforest.IsolationForestModel]),
    TestObject(knn.KNN(k=3, outputCol="matches", device="cpu"), KNN_DS,
               trans_ds=KNN_DS.select("features"), produces=[knn.KNNModel]),
    TestObject(knn.ConditionalKNN(k=3, device="cpu"), KNN_DS,
               trans_ds=Dataset({"features": _X[:4],
                                 "conditioner": [["p"]] * 4}),
               produces=[knn.ConditionalKNNModel]),
    TestObject(sar.SAR(supportThreshold=1, device="cpu"), REC,
               produces=[sar.SARModel]),
    TestObject(sar.RecommendationIndexer(), REC,
               produces=[sar.RecommendationIndexerModel]),
    TestObject(ranking.RankingAdapter(
        recommender=sar.SAR(supportThreshold=1, device="cpu"), k=3), REC,
        produces=[ranking.RankingAdapterModel]),
    TestObject(ranking.RankingTrainValidationSplit(
        estimator=sar.SAR(supportThreshold=1, device="cpu"), trainRatio=0.5,
        seed=0), REC),
    TestObject(ranking.RankingEvaluator(metricName="ndcgAt", k=3),
               ranking.RankingAdapter(recommender=sar.SAR(
                   supportThreshold=1, device="cpu"), k=3)
               .fit(REC).transform(REC)),
    TestObject(anomaly.AccessAnomaly(maxIter=3, rankParam=3, device="cpu"),
               CYBER, produces=[anomaly.AccessAnomalyModel]),
    TestObject(complement.ComplementAccessTransformer("tenant", ["u", "r"],
                                                      1),
               Dataset({"tenant": ["a"] * 6,
                        "u": np.asarray([1, 1, 2, 2, 3, 3]),
                        "r": np.asarray([1, 2, 1, 2, 1, 2])})),
    TestObject(cfeat.IdIndexer("user", "tenant", "user_idx", False), CYBER,
               produces=[cfeat.IdIndexerModel]),
    TestObject(cfeat.MultiIndexer(indexers=[
        cfeat.IdIndexer("user", "tenant", "user_idx", False)]), CYBER,
        produces=[cfeat.MultiIndexerModel]),
    TestObject(cfeat.StandardScalarScaler("likelihood", "tenant", "out"),
               CYBER, produces=[cfeat.StandardScalarScalerModel]),
    TestObject(cfeat.LinearScalarScaler("likelihood", "tenant", "out", 1.0,
                                        2.0),
               CYBER, produces=[cfeat.LinearScalarScalerModel]),
    TestObject(lime.TabularLIME(model=_ProbeModel(), inputCol="features",
                                outputCol="weights", nSamples=40), TAB,
               trans_ds=TAB.head(2), produces=[lime.TabularLIMEModel]),
    TestObject(lime.TextLIME(model=_ProbeModel(), inputCol="text",
                             outputCol="weights", nSamples=30), TEXT.head(1)),
    TestObject(lime.ImageLIME(model=_ImgProbeModel(), inputCol="img",
                              outputCol="weights", nSamples=8, cellSize=8.0),
               IMG.head(1)),
    TestObject(lime.SuperpixelTransformer(inputCol="img", outputCol="sp",
                                          cellSize=8.0), IMG),
    TestObject(image.ImageTransformer(inputCol="img", outputCol="out",
                                      device="cpu").resize(8, 8), IMG),
    TestObject(image.ResizeImageTransformer(inputCol="img", outputCol="out",
                                            height=8, width=8, device="cpu"),
               IMG),
    TestObject(image.UnrollImage(inputCol="img", outputCol="u"), IMG),
    TestObject(image.ImageSetAugmenter(inputCol="img", outputCol="img"), IMG),
    TestObject(image.DecodeImage(inputCol="bytes", outputCol="img"),
               Dataset({"bytes": [_png(v) for v in IMG["img"]] + [b"bad"]})),
    TestObject(DNN.copy({}).set(inputCol="x", outputCol="f",
                                outputNode="pool", miniBatchSize=3),
               Dataset({"x": _rng.normal(size=(5, 16, 16, 3)).astype(
                   np.float32)})),
    TestObject(scoring.ImageFeaturizer(DNN, input_hw=(16, 16), device="cpu")
               .set(inputCol="img", outputCol="f", miniBatchSize=3), IMG),
    TestObject(train.ComputeModelStatistics(), SCORED),
    TestObject(train.ComputePerInstanceStatistics(), SCORED),
    TestObject(train.TrainClassifier(model=gbdt.LightGBMClassifier(**GB),
                                     numFeatures=8), TAB.drop("lists"),
               produces=[train.TrainedClassifierModel]),
    TestObject(train.TrainRegressor(model=gbdt.LightGBMRegressor(**GB),
                                    numFeatures=8), TAB.drop("lists"),
               produces=[train.TrainedRegressorModel]),
    # the JAX package's automl entries (tests/test_fuzzing.py)
    TestObject(automl.TuneHyperparameters(
        models=[gbdt.LightGBMClassifier(minDataInLeaf=2, device="cpu")],
        evaluationMetric="accuracy", numFolds=2, numRuns=1,
        paramSpace=automl.RandomSpace(
            automl.HyperparamBuilder().add_hyperparam(
                "numIterations", automl.DiscreteHyperParam([2])).build(),
            seed=0)), TAB, produces=[automl.TuneHyperparametersModel]),
    TestObject(automl.FindBestModel(models=[
        gbdt.LightGBMClassifier(numIterations=2, minDataInLeaf=2,
                                device="cpu"),
        gbdt.LightGBMClassifier(numIterations=3, minDataInLeaf=2,
                                device="cpu")],
        evaluationMetric="accuracy"), TAB, produces=[automl.BestModel]),
]

# Stages that need a live external service: a save/load round trip of
# their params only (the JAX package's PARAM_ONLY set; their behaviour is
# held against the JAX stages on local mock servers in
# test_torch_cognitive.py)
PARAM_ONLY = {
    f"mmlspark_tpu_torch.cognitive.services.{n}" for n in (
        "AddDocuments", "AnalyzeImage", "BingImageSearch", "DescribeImage",
        "DetectAnomalies", "DetectFace", "DetectLastAnomaly",
        "EntityDetector", "EntityDetectorV2", "FindSimilarFace",
        "GenerateThumbnails", "GroupFaces", "IdentifyFaces",
        "KeyPhraseExtractor", "KeyPhraseExtractorV2", "LanguageDetector",
        "LanguageDetectorV2", "NER", "NERV2", "OCR",
        "RecognizeDomainSpecificContent", "RecognizeText",
        "SimpleDetectAnomalies", "SpeechToText", "TagImage",
        "TextSentiment", "TextSentimentV2", "VerifyFaces")} | {
    # streaming SDK stage: transform needs a speech endpoint
    "mmlspark_tpu_torch.cognitive.speech_sdk.SpeechToTextSDK"}

_HTTP = "mmlspark_tpu_torch.io.http."
EXEMPT = {
    "mmlspark_tpu_torch.core.pipeline.PipelineModel":
        "produced by the Pipeline entry",
    "mmlspark_tpu_torch.core.pipeline.UnaryTransformer":
        "abstract base of single-column transformers",
    "mmlspark_tpu_torch.cognitive.base.CognitiveServicesBase":
        "abstract base for cognitive transformers",
    "mmlspark_tpu_torch.cognitive.base.PollingCognitiveService":
        "abstract base (async polling services)",
    _HTTP + "HTTPTransformer": "needs a live endpoint; covered in "
                               "test_torch_http with a local server",
    _HTTP + "SimpleHTTPTransformer": "needs a live endpoint; covered in "
                                     "test_torch_http",
    _HTTP + "JSONInputParser": "http plumbing; covered in test_torch_http",
    _HTTP + "JSONOutputParser": "http plumbing; covered in test_torch_http",
    _HTTP + "StringOutputParser": "http plumbing; covered in "
                                  "test_torch_http",
    _HTTP + "CustomInputParser": "http plumbing (closure params); covered "
                                 "in test_torch_http",
    _HTTP + "CustomOutputParser": "http plumbing (closure params); covered "
                                  "in test_torch_http",
    _HTTP + "PartitionConsolidator": "host-service holder; covered in "
                                     "test_torch_http",
}


def _name(cls):
    return f"{cls.__module__}.{cls.__name__}"


def test_discover_stages_defaults_to_the_port():
    found = discover_stages()
    assert found and all(k.startswith("mmlspark_tpu_torch.") for k in found)
    assert "mmlspark_tpu_torch.models.vw.api.VowpalWabbitClassifier" in found


def test_every_port_stage_is_covered():
    covered = set(EXEMPT) | PARAM_ONLY
    for obj in REGISTRY:
        covered.add(_name(type(obj.stage)))
        covered.update(_name(c) for c in obj.produces)
    missing = sorted(set(discover_stages()) - covered)
    assert missing == []


@pytest.mark.parametrize("obj", REGISTRY,
                         ids=[type(o.stage).__name__ for o in REGISTRY])
def test_experiment_fuzz(obj):
    assert isinstance(experiment_fuzz(obj), Dataset)


@pytest.mark.parametrize("obj", REGISTRY,
                         ids=[type(o.stage).__name__ for o in REGISTRY])
def test_serialization_fuzz(obj, tmp_path):
    serialization_fuzz(obj, str(tmp_path))


def _probe_instance(cls):
    """A stage of ``cls`` with every param set (to its default, else a
    probe string), so the round trip carries a full param map."""
    stage = cls.__new__(cls)
    PipelineStage.__init__(stage)
    for param in stage.params():
        value = param.default
        if value is None:
            value = f"{param.name}_probe"
        try:
            stage.set(**{param.name: value})
        except Exception:
            pass
    return stage


@pytest.mark.parametrize("name", sorted(PARAM_ONLY))
def test_param_roundtrip_fuzz(name, tmp_path):
    stage = _probe_instance(discover_stages()[name])
    assert stage._paramMap, f"{name}: no params were set"
    stage.save(str(tmp_path / "s"))
    loaded = PipelineStage.load(str(tmp_path / "s"))
    assert type(loaded) is type(stage)
    assert loaded._paramMap == stage._paramMap
