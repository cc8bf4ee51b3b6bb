"""Text featurization: tokenize -> stopwords -> n-grams -> hashing TF / IDF.

Counterpart of ``mmlspark_tpu/featurize/text.py``: the reference's text
pipeline builder (reference:
featurize/TextFeaturizer.scala:20-408 — the tokenizer/stopword/ngram/hashingTF/
IDF stage chain; MultiNGram.scala:18-24; PageSplitter.scala:14-20). Output is a
dense hashed TF(-IDF) matrix, float32, on the host.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (HasInputCol, HasOutputCol, Param, TypeConverters)
from ..core.pipeline import Estimator, Model, Transformer
from ..ops.murmur import murmur3_32

# the standard english stop list used by Spark ML's StopWordsRemover
_DEFAULT_STOPWORDS = {
    "a", "about", "above", "after", "again", "against", "all", "am", "an", "and",
    "any", "are", "as", "at", "be", "because", "been", "before", "being", "below",
    "between", "both", "but", "by", "could", "did", "do", "does", "doing", "down",
    "during", "each", "few", "for", "from", "further", "had", "has", "have",
    "having", "he", "her", "here", "hers", "herself", "him", "himself", "his",
    "how", "i", "if", "in", "into", "is", "it", "its", "itself", "me", "more",
    "most", "my", "myself", "no", "nor", "not", "of", "off", "on", "once", "only",
    "or", "other", "ought", "our", "ours", "ourselves", "out", "over", "own",
    "same", "she", "should", "so", "some", "such", "than", "that", "the", "their",
    "theirs", "them", "themselves", "then", "there", "these", "they", "this",
    "those", "through", "to", "too", "under", "until", "up", "very", "was", "we",
    "were", "what", "when", "where", "which", "while", "who", "whom", "why",
    "with", "would", "you", "your", "yours", "yourself", "yourselves",
}


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    pattern = Param("pattern", "token split regex", r"\W+", TypeConverters.to_string)
    toLowercase = Param("toLowercase", "lowercase first", True, TypeConverters.to_bool)
    minTokenLength = Param("minTokenLength", "drop shorter tokens", 1,
                           TypeConverters.to_int)
    gaps = Param("gaps", "True (default): the regex matches the GAPS "
                 "between tokens (split); False: it matches the tokens "
                 "themselves (findall) — Spark RegexTokenizer semantics "
                 "(reference: TextFeaturizer tokenizerGaps)", True,
                 TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        pat = re.compile(self.get_or_default("pattern"))
        lower = self.get_or_default("toLowercase")
        mtl = self.get_or_default("minTokenLength")
        gaps = self.get_or_default("gaps")
        col = dataset[self.get_or_default("inputCol")]
        out = []
        for s in col:
            s = str(s).lower() if lower else str(s)
            toks = (pat.split(s) if gaps
                    else [m.group(0) for m in pat.finditer(s)])
            out.append([t for t in toks if len(t) >= mtl])
        return dataset.with_column(self.get_or_default("outputCol"), out)


class StopWordsRemover(Transformer, HasInputCol, HasOutputCol):
    stopWords = Param("stopWords", "words to remove (default english)", None)
    caseSensitive = Param("caseSensitive", "case sensitive matching", False,
                          TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        sw = self.get_or_default("stopWords")
        sw = set(sw) if sw is not None else _DEFAULT_STOPWORDS
        cs = self.get_or_default("caseSensitive")
        if not cs:
            sw = {w.lower() for w in sw}
        col = dataset[self.get_or_default("inputCol")]
        out = [[t for t in toks if (t if cs else t.lower()) not in sw]
               for toks in col]
        return dataset.with_column(self.get_or_default("outputCol"), out)


class NGram(Transformer, HasInputCol, HasOutputCol):
    n = Param("n", "gram length", 2, TypeConverters.to_int)

    def transform(self, dataset: Dataset) -> Dataset:
        n = self.get_or_default("n")
        col = dataset[self.get_or_default("inputCol")]
        out = [[" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1)]
               for toks in col]
        return dataset.with_column(self.get_or_default("outputCol"), out)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams for several lengths (reference: featurize/MultiNGram.scala:18-24)."""

    lengths = Param("lengths", "gram lengths", [1, 2, 3], TypeConverters.to_list_int)

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.get_or_default("inputCol")]
        lengths = self.get_or_default("lengths")
        out = []
        for toks in col:
            grams: List[str] = []
            for n in lengths:
                grams.extend(" ".join(toks[i:i + n])
                             for i in range(len(toks) - n + 1))
            out.append(grams)
        return dataset.with_column(self.get_or_default("outputCol"), out)


class HashingTF(Transformer, HasInputCol, HasOutputCol):
    numFeatures = Param("numFeatures", "hash buckets", 1 << 18, TypeConverters.to_int)
    binary = Param("binary", "presence instead of counts", False, TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        D = int(self.get_or_default("numFeatures"))
        binary = self.get_or_default("binary")
        col = dataset[self.get_or_default("inputCol")]
        n = len(dataset)
        if n * D > (1 << 31):
            raise MemoryError(
                f"dense hashed TF of shape ({n}, {D}) is too large; lower "
                "numFeatures or use VowpalWabbitFeaturizer's padded sparse format")
        out = np.zeros((n, D), np.float32)  # exact width: hash modulo D
        for i, toks in enumerate(col):
            for t in toks:
                j = murmur3_32(t, 0) % D
                if binary:
                    out[i, j] = 1.0
                else:
                    out[i, j] += 1.0
        return dataset.with_column(self.get_or_default("outputCol"), out)


class IDF(Estimator, HasInputCol, HasOutputCol):
    minDocFreq = Param("minDocFreq", "zero out rare terms", 0, TypeConverters.to_int)

    def fit(self, dataset: Dataset) -> "IDFModel":
        tf = dataset.array(self.get_or_default("inputCol"), np.float32)
        n = tf.shape[0]
        df = (tf > 0).sum(axis=0)
        idf = np.log((n + 1.0) / (df + 1.0)).astype(np.float32)
        idf[df < self.get_or_default("minDocFreq")] = 0.0
        model = IDFModel(idf=idf)
        self._copy_params_to(model)
        return model


class IDFModel(Model, HasInputCol, HasOutputCol):
    idf = Param("idf", "inverse document frequencies", None, is_complex=True)

    def __init__(self, idf=None, **kwargs):
        super().__init__(**kwargs)
        if idf is not None:
            self.set(idf=idf)

    def transform(self, dataset: Dataset) -> Dataset:
        tf = dataset.array(self.get_or_default("inputCol"), np.float32)
        out = tf * np.asarray(self.get_or_default("idf"))[None, :]
        return dataset.with_column(self.get_or_default("outputCol"), out)


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    """Configurable tokenize->stopwords->ngram->TF(-IDF) chain
    (reference: featurize/TextFeaturizer.scala:20-408, same toggles)."""

    useTokenizer = Param("useTokenizer", "tokenize input", True, TypeConverters.to_bool)
    tokenizerPattern = Param("tokenizerPattern", "split regex", r"\W+",
                             TypeConverters.to_string)
    tokenizerGaps = Param("tokenizerGaps", "regex matches gaps (split) vs "
                          "tokens (findall)", True, TypeConverters.to_bool)
    toLowercase = Param("toLowercase", "lowercase", True, TypeConverters.to_bool)
    minTokenLength = Param("minTokenLength", "min token length", 0,
                           TypeConverters.to_int)
    useStopWordsRemover = Param("useStopWordsRemover", "remove stop words", False,
                                TypeConverters.to_bool)
    caseSensitiveStopWords = Param("caseSensitiveStopWords", "case sensitive",
                                   False, TypeConverters.to_bool)
    useNGram = Param("useNGram", "emit n-grams", False, TypeConverters.to_bool)
    nGramLength = Param("nGramLength", "gram length", 2, TypeConverters.to_int)
    # reference default is 2^18 with sparse vectors; the dense device-ready
    # matrix here defaults smaller — raise it when rows are few
    numFeatures = Param("numFeatures", "hash buckets", 1 << 12, TypeConverters.to_int)
    binary = Param("binary", "binary TF", False, TypeConverters.to_bool)
    useIDF = Param("useIDF", "apply IDF weighting", True, TypeConverters.to_bool)
    minDocFreq = Param("minDocFreq", "IDF min doc freq", 1, TypeConverters.to_int)

    def fit(self, dataset: Dataset) -> "TextFeaturizerModel":
        from ..core.pipeline import Pipeline

        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol")
        stages = []
        cur = in_col
        if self.get_or_default("useTokenizer"):
            stages.append(Tokenizer(
                inputCol=cur, outputCol="__tokens",
                pattern=self.get_or_default("tokenizerPattern"),
                gaps=self.get_or_default("tokenizerGaps"),
                toLowercase=self.get_or_default("toLowercase"),
                minTokenLength=max(1, self.get_or_default("minTokenLength"))))
            cur = "__tokens"
        if self.get_or_default("useStopWordsRemover"):
            stages.append(StopWordsRemover(
                inputCol=cur, outputCol="__nostop",
                caseSensitive=self.get_or_default("caseSensitiveStopWords")))
            cur = "__nostop"
        if self.get_or_default("useNGram"):
            stages.append(NGram(inputCol=cur, outputCol="__grams",
                                n=self.get_or_default("nGramLength")))
            cur = "__grams"
        stages.append(HashingTF(inputCol=cur, outputCol="__tf",
                                numFeatures=self.get_or_default("numFeatures"),
                                binary=self.get_or_default("binary")))
        if self.get_or_default("useIDF"):
            stages.append(IDF(inputCol="__tf", outputCol=out_col,
                              minDocFreq=self.get_or_default("minDocFreq")))
        else:
            from ..stages.basic import RenameColumn
            stages.append(RenameColumn(inputCol="__tf", outputCol=out_col))
        pipeline_model = Pipeline(stages).fit(dataset)
        model = TextFeaturizerModel(inner=pipeline_model)
        self._copy_params_to(model)
        return model


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    inner = Param("inner", "fitted pipeline", None, is_complex=True)

    def __init__(self, inner=None, **kwargs):
        super().__init__(**kwargs)
        if inner is not None:
            self.set(inner=inner)

    def transform(self, dataset: Dataset) -> Dataset:
        out = self.get_or_default("inner").transform(dataset)
        return out.drop("__tokens", "__nostop", "__grams", "__tf")


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split documents into pages of bounded length on word boundaries
    (reference: featurize/PageSplitter.scala:14-20)."""

    maximumPageLength = Param("maximumPageLength", "max chars per page", 5000,
                              TypeConverters.to_int)
    minimumPageLength = Param("minimumPageLength", "min chars before a break", 4500,
                              TypeConverters.to_int)
    boundaryRegex = Param("boundaryRegex", "preferred break", r"\s", TypeConverters.to_string)

    def transform(self, dataset: Dataset) -> Dataset:
        lo = self.get_or_default("minimumPageLength")
        hi = self.get_or_default("maximumPageLength")
        pat = re.compile(self.get_or_default("boundaryRegex"))
        col = dataset[self.get_or_default("inputCol")]
        out = []
        for s in col:
            s = str(s)
            pages, start = [], 0
            while start < len(s):
                end = min(start + hi, len(s))
                if end < len(s):
                    window = s[start + lo:end]
                    m = None
                    for m in pat.finditer(window):
                        pass
                    if m is not None:
                        end = start + lo + m.end()
                pages.append(s[start:end])
                start = end
            out.append(pages)
        return dataset.with_column(self.get_or_default("outputCol"), out)
