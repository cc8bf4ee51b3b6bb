"""Ranking evaluation + train/validation tooling for recommenders.

The PyTorch port's own copy of ``mmlspark_tpu/recommendation/ranking.py``
(host numpy; the port imports nothing of the JAX package). Equivalents of
the reference's ranking helpers (reference:
recommendation/RankingEvaluator.scala:15-152 — ndcgAt, map, precisionAtk,
recallAtK, diversityAtK, maxDiversity; RankingAdapter.scala:16-151;
RankingTrainValidationSplit.scala:24-328 — per-user stratified split :283).
Metric math is vectorized numpy over fixed-width top-k blocks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dataset import Dataset
from ..core.params import Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer


def _per_user_lists(ds: Dataset, userCol: str, itemCol: str,
                    ratingCol: Optional[str] = None) -> Dict:
    out: Dict = {}
    users = ds[userCol]
    items = ds[itemCol]
    ratings = ds[ratingCol] if ratingCol and ratingCol in ds else None
    for i in range(len(ds)):
        u = users[i]
        out.setdefault(u, []).append(
            (items[i], float(ratings[i]) if ratings is not None else 1.0))
    return out


def _filter_min_counts(dataset, col: str, lo) -> "Dataset":
    """Drop rows whose ``col`` value occurs fewer than ``lo`` times."""
    if not lo or lo <= 1:
        return dataset
    vals = np.asarray(dataset[col])
    uniq, counts = np.unique(vals, return_counts=True)
    mask = np.isin(vals, uniq[counts >= lo])
    return dataset.filter(mask) if not mask.all() else dataset


class RankingEvaluator(Transformer):
    """Computes ranking metrics from (recommendations, ground-truth) datasets
    (reference: recommendation/RankingEvaluator.scala:15-152).

    ``transform`` expects a dataset with a recommendations column (list of
    item ids per user) and a ground-truth column (list of relevant item ids);
    ``evaluate`` returns one scalar.
    """

    k = Param("k", "cutoff position", 10, TypeConverters.to_int)
    metricName = Param("metricName", "ndcgAt | map | precisionAtk | recallAtK "
                       "| diversityAtK | maxDiversity", "ndcgAt",
                       TypeConverters.to_string)
    recsCol = Param("recsCol", "recommended item-id lists", "recommendations",
                    TypeConverters.to_string)
    labelsCol = Param("labelsCol", "ground-truth item-id lists", "labels",
                      TypeConverters.to_string)
    nItems = Param("nItems", "catalog size (diversity metrics)", -1,
                   TypeConverters.to_int)

    def evaluate(self, dataset: Dataset) -> float:
        k = self.get_or_default("k")
        recs = [list(r)[:k] for r in dataset[self.get_or_default("recsCol")]]
        labels = [set(l) for l in dataset[self.get_or_default("labelsCol")]]
        name = self.get_or_default("metricName")
        if name == "ndcgAt":
            vals = []
            for rec, lab in zip(recs, labels):
                if not lab:
                    continue
                dcg = sum(1.0 / np.log2(i + 2.0)
                          for i, item in enumerate(rec) if item in lab)
                idcg = sum(1.0 / np.log2(i + 2.0)
                           for i in range(min(len(lab), k)))
                vals.append(dcg / idcg if idcg > 0 else 0.0)
            return float(np.mean(vals)) if vals else 0.0
        if name == "map":
            vals = []
            for rec, lab in zip(recs, labels):
                if not lab:
                    continue
                hits, s = 0, 0.0
                for i, item in enumerate(rec):
                    if item in lab:
                        hits += 1
                        s += hits / (i + 1.0)
                vals.append(s / min(len(lab), k))
            return float(np.mean(vals)) if vals else 0.0
        if name == "precisionAtk":
            return float(np.mean([
                len([x for x in rec if x in lab]) / float(k)
                for rec, lab in zip(recs, labels)]))
        if name == "recallAtK":
            vals = [len([x for x in rec if x in lab]) / float(len(lab))
                    for rec, lab in zip(recs, labels) if lab]
            return float(np.mean(vals)) if vals else 0.0
        if name in ("diversityAtK", "maxDiversity"):
            shown = {x for rec in recs for x in rec}
            n = self.get_or_default("nItems")
            if n <= 0:
                n = len({x for lab in labels for x in lab} | shown)
            return len(shown) / float(max(n, 1))
        raise ValueError(f"unknown metricName {name!r}")

    def transform(self, dataset: Dataset) -> Dataset:
        return Dataset({self.get_or_default("metricName"):
                        np.asarray([self.evaluate(dataset)])})


class RankingAdapter(Estimator):
    """Wraps a recommender so its output feeds RankingEvaluator
    (reference: recommendation/RankingAdapter.scala:16-151)."""

    recommender = Param("recommender", "inner recommender estimator", None,
                        is_complex=True)
    k = Param("k", "recommendations per user", 10, TypeConverters.to_int)
    userCol = Param("userCol", "user column", "user_idx", TypeConverters.to_string)
    itemCol = Param("itemCol", "item column", "item_idx", TypeConverters.to_string)
    ratingCol = Param("ratingCol", "rating column", "rating", TypeConverters.to_string)
    minRatingsPerUser = Param("minRatingsPerUser", "drop users below this", 1,
                              TypeConverters.to_int)
    minRatingsPerItem = Param("minRatingsPerItem", "drop items below this "
                              "(reference: RankingAdapter "
                              "minRatingsPerItem)", 1,
                              TypeConverters.to_int)

    def __init__(self, recommender=None, **kwargs):
        super().__init__(**kwargs)
        if recommender is not None:
            self.set(recommender=recommender)

    def _filtered(self, dataset: Dataset) -> Dataset:
        # sequential: item counts are recomputed AFTER cold users leave,
        # so surviving items honor their stated minimum on the rows that
        # actually remain
        dataset = _filter_min_counts(
            dataset, self.get_or_default("userCol"),
            self.get_or_default("minRatingsPerUser"))
        return _filter_min_counts(
            dataset, self.get_or_default("itemCol"),
            self.get_or_default("minRatingsPerItem"))

    def fit(self, dataset: Dataset) -> "RankingAdapterModel":
        dataset = self._filtered(dataset)
        fitted = self.get_or_default("recommender").fit(dataset)
        model = RankingAdapterModel(recommenderModel=fitted)
        self._copy_params_to(model)
        return model


class RankingAdapterModel(Model):
    recommenderModel = Param("recommenderModel", "fitted recommender", None,
                             is_complex=True)
    k = Param("k", "recommendations per user", 10, TypeConverters.to_int)
    userCol = Param("userCol", "user column", "user_idx", TypeConverters.to_string)
    itemCol = Param("itemCol", "item column", "item_idx", TypeConverters.to_string)
    ratingCol = Param("ratingCol", "rating column", "rating", TypeConverters.to_string)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def transform(self, dataset: Dataset) -> Dataset:
        """Emit (recommendations, labels) rows per user in the eval dataset."""
        inner = self.get_or_default("recommenderModel")
        k = self.get_or_default("k")
        recs = inner.recommend_for_all_users(k)
        ucol, icol = self.get_or_default("userCol"), self.get_or_default("itemCol")
        truth = _per_user_lists(dataset, ucol, icol,
                                self.get_or_default("ratingCol"))
        rows = []
        rec_users = recs[ucol]
        rec_lists = recs["recommendations"]
        for i in range(len(recs)):
            u = rec_users[i]
            if u in truth:
                rows.append({ucol: u,
                             "recommendations": list(rec_lists[i]),
                             "labels": [it for it, _ in truth[u]]})
        return Dataset.from_rows(rows)


class RankingTrainValidationSplit(Estimator):
    """Per-user stratified train/validation split + fit
    (reference: recommendation/RankingTrainValidationSplit.scala:24-328;
    the per-user split is :283)."""

    estimator = Param("estimator", "recommender to fit on the train split",
                      None, is_complex=True)
    trainRatio = Param("trainRatio", "per-user train fraction", 0.75,
                       TypeConverters.to_float)
    userCol = Param("userCol", "user column", "user_idx", TypeConverters.to_string)
    itemCol = Param("itemCol", "item column", "item_idx", TypeConverters.to_string)
    ratingCol = Param("ratingCol", "rating column", "rating", TypeConverters.to_string)
    minRatingsPerUser = Param("minRatingsPerUser", "drop users below this", 2,
                              TypeConverters.to_int)
    minRatingsPerItem = Param("minRatingsPerItem", "drop items below this "
                              "before splitting", 1, TypeConverters.to_int)
    seed = Param("seed", "random seed", 0, TypeConverters.to_int)
    validationMetrics = Param("validationMetrics", "metrics of the fitted "
                              "candidate on the validation split, set by "
                              "fit() (reference: RankingTrainValidationSplit "
                              "validationMetrics)", None, is_complex=True)

    def __init__(self, estimator=None, **kwargs):
        super().__init__(**kwargs)
        if estimator is not None:
            self.set(estimator=estimator)

    def split(self, dataset: Dataset):
        """Per-user stratified (train, validation) datasets."""
        ucol = self.get_or_default("userCol")
        dataset = _filter_min_counts(
            dataset, self.get_or_default("itemCol"),
            self.get_or_default("minRatingsPerItem"))
        users = np.asarray(dataset[ucol])
        rng = np.random.default_rng(self.get_or_default("seed"))
        ratio = self.get_or_default("trainRatio")
        min_r = self.get_or_default("minRatingsPerUser")
        train_mask = np.zeros(len(dataset), bool)
        keep_mask = np.ones(len(dataset), bool)
        for u in np.unique(users):
            idx = np.nonzero(users == u)[0]
            if len(idx) < min_r:
                keep_mask[idx] = False
                continue
            perm = rng.permutation(idx)
            n_train = max(int(round(ratio * len(idx))), 1)
            if n_train == len(idx):
                n_train -= 1  # every kept user contributes >=1 validation row
            train_mask[perm[:n_train]] = True
        return (dataset.filter(train_mask & keep_mask),
                dataset.filter(~train_mask & keep_mask))

    def fit(self, dataset: Dataset):
        train, valid = self.split(dataset)
        fitted = self.get_or_default("estimator").fit(train)
        self.validation = valid  # exposed for evaluation
        try:
            # validationMetrics parity: when the candidate is a
            # RankingAdapter, its model emits the (recommendations,
            # labels) rows the evaluator consumes — score the held-out
            # split with NDCG like the reference's default metric
            scored = fitted.transform(valid)
            k = (fitted.get_or_default("k")
                 if any(p.name == "k" for p in fitted.params()) else 10)
            self.set(validationMetrics=[float(RankingEvaluator(
                metricName="ndcgAt", k=int(k)).evaluate(scored))])
        except Exception:
            # metric capture is best-effort (non-adapter candidates have
            # no standard eval shape); fitting must not fail on it
            self.set(validationMetrics=None)
        return fitted
