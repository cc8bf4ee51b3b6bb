"""LIME model-agnostic explanations: tabular, image, and text.

The port's copy of ``mmlspark_tpu/explain/lime.py`` (reference:
lime/LIME.scala:28-320 — TabularLIME :166-249, ImageLIME :258-320;
lime/TextLIME.scala:26; lime/Superpixel.scala:46-329;
lime/BreezeUtils.scala:112 LassoUtils). The perturb-and-score batch is
embarrassingly parallel: all nSamples perturbations for a row are scored in
one batched transform through the inner model (the device does the hot work),
then a small weighted lasso is solved per row on host. Everything here is
numpy on the host, as in the JAX package; the device work is the inner
model's ``transform`` (a :class:`~mmlspark_tpu_torch.models.dnn.DNNModel`
on its own ``device``, for images).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataset import Dataset
from ..core.params import (HasInputCol, HasOutputCol, Param, TypeConverters)
from ..core.pipeline import Estimator, Model, Transformer


def lasso_coordinate_descent(X: np.ndarray, y: np.ndarray,
                             sample_weight: Optional[np.ndarray] = None,
                             alpha: float = 0.01, n_iter: int = 200) -> np.ndarray:
    """Weighted lasso via cyclic coordinate descent
    (reference: lime/BreezeUtils.scala LassoUtils closed-form lasso).

    Returns [d + 1]: coefficients then intercept. Small (nSamples x d)
    problems; host numpy is the right tool.
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n, d = X.shape
    w = np.ones(n) if sample_weight is None else np.asarray(sample_weight, np.float64)
    w = w / max(w.sum(), 1e-12)
    xm = (X * w[:, None]).sum(axis=0)
    ym = float((y * w).sum())
    Xc = X - xm
    yc = y - ym
    beta = np.zeros(d)
    col_ss = (w[:, None] * Xc * Xc).sum(axis=0) + 1e-12
    r = yc - Xc @ beta
    for _ in range(n_iter):
        max_delta = 0.0
        for j in range(d):
            r = r + Xc[:, j] * beta[j]
            rho = float((w * Xc[:, j] * r).sum())
            bj = np.sign(rho) * max(abs(rho) - alpha, 0.0) / col_ss[j]
            max_delta = max(max_delta, abs(bj - beta[j]))
            beta[j] = bj
            r = r - Xc[:, j] * bj
        if max_delta < 1e-9:
            break
    intercept = ym - float(xm @ beta)
    return np.concatenate([beta, [intercept]])


def _model_scores(model: Transformer, ds: Dataset, predCol: str) -> np.ndarray:
    out = model.transform(ds)
    col = out[predCol]
    arr = np.asarray(col, np.float64)
    if arr.ndim == 2:  # probability vector: explain P(class 1)
        arr = arr[:, 1] if arr.shape[1] > 1 else arr[:, 0]
    return arr


class _LIMEBase(HasInputCol, HasOutputCol):
    model = Param("model", "inner model to explain", None, is_complex=True)
    predictionCol = Param("predictionCol", "column of the inner model's output "
                          "to explain", "probability", TypeConverters.to_string)
    nSamples = Param("nSamples", "perturbation samples per row", 1000,
                     TypeConverters.to_int)
    samplingFraction = Param("samplingFraction", "keep probability per "
                             "feature/superpixel/token", 0.7, TypeConverters.to_float)
    regularization = Param("regularization", "lasso alpha", 0.01,
                           TypeConverters.to_float)
    kernelWidth = Param("kernelWidth", "locality kernel width (0 = uniform "
                        "weights)", 0.0, TypeConverters.to_float)
    seed = Param("seed", "random seed", 0, TypeConverters.to_int)

    def _weights(self, masks: np.ndarray) -> Optional[np.ndarray]:
        kw = self.get_or_default("kernelWidth")
        if not kw:
            return None
        # cosine-ish locality: fraction of features kept
        d = 1.0 - masks.mean(axis=1)
        return np.exp(-(d ** 2) / (kw ** 2))


class TabularLIME(Estimator, _LIMEBase):
    """Fit collects per-column statistics of the background dataset
    (reference: lime/LIME.scala TabularLIME:166-205)."""

    def __init__(self, model=None, **kwargs):
        super().__init__(**kwargs)
        if model is not None:
            self.set(model=model)

    def fit(self, dataset: Dataset) -> "TabularLIMEModel":
        X = np.asarray(dataset.array(self.get_or_default("inputCol")), np.float64)
        out = TabularLIMEModel(columnMeans=X.mean(axis=0),
                               columnSTDs=X.std(axis=0) + 1e-12)
        self._copy_params_to(out)
        return out


class TabularLIMEModel(Model, _LIMEBase):
    """Per-row lasso over perturbed feature vectors
    (reference: lime/LIME.scala TabularLIMEModel:207-249)."""

    columnMeans = Param("columnMeans", "background feature means", None,
                        is_complex=True)
    columnSTDs = Param("columnSTDs", "background feature stds", None,
                       is_complex=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        X = np.asarray(dataset.array(in_col), np.float64)
        n, d = X.shape
        ns = self.get_or_default("nSamples")
        frac = self.get_or_default("samplingFraction")
        rng = np.random.default_rng(self.get_or_default("seed"))
        means = np.asarray(self.get_or_default("columnMeans"))
        stds = np.asarray(self.get_or_default("columnSTDs"))
        inner = self.get_or_default("model")
        pcol = self.get_or_default("predictionCol")
        alpha = self.get_or_default("regularization")

        coefs = np.zeros((n, d))
        for i in range(n):
            masks = (rng.random((ns, d)) < frac).astype(np.float64)
            noise = rng.normal(means, stds, size=(ns, d))
            perturbed = np.where(masks > 0, X[i][None, :], noise)
            scores = _model_scores(
                inner, Dataset({in_col: perturbed.astype(np.float32)}), pcol)
            coefs[i] = lasso_coordinate_descent(
                masks, scores, self._weights(masks), alpha)[:d]
        out_col = self.get_or_default("outputCol") or f"{in_col}_lime"
        return dataset.with_column(out_col, coefs)


# ---------------------------------------------------------------------------
# Superpixels + image LIME
# ---------------------------------------------------------------------------


class Superpixel:
    """SLIC-style superpixel clustering (reference: lime/Superpixel.scala:46-329).

    K-means over (y, x, L*a*b-ish channels) with centers seeded on a grid —
    a few vectorized numpy iterations; images are small at explanation time.
    """

    def __init__(self, cell_size: float = 16.0, modifier: float = 130.0,
                 n_iter: int = 5):
        self.cell_size = cell_size
        self.modifier = modifier
        self.n_iter = n_iter

    def cluster(self, img: np.ndarray) -> np.ndarray:
        """img: [H, W, C] float; returns int32 [H, W] superpixel ids."""
        H, W = img.shape[:2]
        S = max(int(self.cell_size), 2)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        spatial = np.stack([ys, xs], axis=-1).astype(np.float64)
        color = img.reshape(H, W, -1).astype(np.float64)
        # weight spatial vs color per SLIC: m/S compactness
        m = self.modifier / 255.0
        feats = np.concatenate(
            [spatial * (m / S), color / max(color.max(), 1e-9)], axis=-1
        ).reshape(-1, 2 + color.shape[-1])
        cy = np.arange(S // 2, H, S)
        cx = np.arange(S // 2, W, S)
        centers = feats[(cy[:, None] * W + cx[None, :]).reshape(-1)]
        for _ in range(self.n_iter):
            d = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            assign = d.argmin(axis=1)
            for k in range(len(centers)):
                pts = feats[assign == k]
                if len(pts):
                    centers[k] = pts.mean(axis=0)
        return assign.reshape(H, W).astype(np.int32)


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol):
    """Adds a superpixel-assignment column for image columns
    (reference: lime/SuperpixelTransformer.scala:35)."""

    cellSize = Param("cellSize", "target superpixel size", 16.0,
                     TypeConverters.to_float)
    modifier = Param("modifier", "SLIC compactness", 130.0, TypeConverters.to_float)

    def transform(self, dataset: Dataset) -> Dataset:
        sp = Superpixel(self.get_or_default("cellSize"),
                        self.get_or_default("modifier"))
        imgs = dataset[self.get_or_default("inputCol")]
        out = [sp.cluster(np.asarray(img)) for img in imgs]
        out_col = self.get_or_default("outputCol") or "superpixels"
        return dataset.with_column(out_col, out)


class ImageLIME(Transformer, _LIMEBase):
    """Superpixel-masking LIME for image models
    (reference: lime/LIME.scala ImageLIME:258-320)."""

    cellSize = Param("cellSize", "target superpixel size", 16.0,
                     TypeConverters.to_float)
    modifier = Param("modifier", "SLIC compactness", 130.0, TypeConverters.to_float)
    superpixelCol = Param("superpixelCol", "also output the superpixel map here",
                          None, TypeConverters.to_string)

    def __init__(self, model=None, **kwargs):
        super().__init__(**kwargs)
        if model is not None:
            self.set(model=model)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        imgs = dataset[in_col]
        ns = self.get_or_default("nSamples")
        frac = self.get_or_default("samplingFraction")
        rng = np.random.default_rng(self.get_or_default("seed"))
        inner = self.get_or_default("model")
        pcol = self.get_or_default("predictionCol")
        alpha = self.get_or_default("regularization")
        sp = Superpixel(self.get_or_default("cellSize"),
                        self.get_or_default("modifier"))

        all_coefs, all_sp = [], []
        for img in imgs:
            img = np.asarray(img, np.float32)
            assign = sp.cluster(img)
            K = int(assign.max()) + 1
            masks = (rng.random((ns, K)) < frac)
            # masked-out superpixels are greyed to the image mean
            fill = img.mean(axis=(0, 1), keepdims=True)
            batch = np.where(masks[:, assign][..., None], img[None], fill[None])
            scores = _model_scores(
                inner, Dataset({in_col: list(batch)}), pcol)
            m = masks.astype(np.float64)
            all_coefs.append(lasso_coordinate_descent(
                m, scores, self._weights(m), alpha)[:K])
            all_sp.append(assign)
        out_col = self.get_or_default("outputCol") or f"{in_col}_lime"
        out = dataset.with_column(out_col, all_coefs)
        spcol = self.get_or_default("superpixelCol")
        if spcol:
            out = out.with_column(spcol, all_sp)
        return out


class TextLIME(Transformer, _LIMEBase):
    """Token-masking LIME for text models (reference: lime/TextLIME.scala:26)."""

    tokensCol = Param("tokensCol", "also output the token list here", None,
                      TypeConverters.to_string)

    def __init__(self, model=None, **kwargs):
        super().__init__(**kwargs)
        if model is not None:
            self.set(model=model)

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        texts = dataset[in_col]
        ns = self.get_or_default("nSamples")
        frac = self.get_or_default("samplingFraction")
        rng = np.random.default_rng(self.get_or_default("seed"))
        inner = self.get_or_default("model")
        pcol = self.get_or_default("predictionCol")
        alpha = self.get_or_default("regularization")

        all_coefs, all_tokens = [], []
        for text in texts:
            tokens = str(text).split()
            K = max(len(tokens), 1)
            masks = (rng.random((ns, K)) < frac)
            masks[:, :] |= ~masks.any(axis=1)[:, None]  # never fully empty
            batch = [" ".join(t for t, keep in zip(tokens, m) if keep)
                     for m in masks]
            scores = _model_scores(inner, Dataset({in_col: batch}), pcol)
            m = masks.astype(np.float64)
            all_coefs.append(lasso_coordinate_descent(
                m, scores, self._weights(m), alpha)[:K])
            all_tokens.append(tokens)
        out_col = self.get_or_default("outputCol") or f"{in_col}_lime"
        out = dataset.with_column(out_col, all_coefs)
        tcol = self.get_or_default("tokensCol")
        if tcol:
            out = out.with_column(tcol, all_tokens)
        return out
