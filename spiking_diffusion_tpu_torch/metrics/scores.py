"""Distribution-level generative metrics: Fréchet distance (FID), Inception
Score, Kernel Inception Distance, on feature and probability arrays.

The port's numpy copy of ``spiking_diffusion_tpu/metrics/scores.py``, with
the same arithmetic and the same random subsets (KID draws them from
``np.random.RandomState(seed)`` in the same order):

  * FID: the activation statistics (mu, sigma) and the Fréchet distance,
    its matrix square roots by ``eigh`` (no scipy).
  * IS: the split KLs of the class probabilities, exp(mean KL) per split,
    mean and std over splits.
  * KID: polynomial kernel k(x, y) = (gamma x.y + 1)^3, unbiased MMD^2
    over random subsets; ``normalize="unit"`` L2-normalises the rows first
    (the convention of the LeNet feature space, reported as KID x 1e3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D))."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    mat = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """d^2 = |mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2)).

    tr(sqrt(S1 S2)) is computed as tr(sqrt(S1^1/2 S2 S1^1/2)) — the
    symmetric form is stable without scipy (the reference guards its
    ``scipy.linalg.sqrtm`` against singular products by adding eps*I,
    ``Fid_score.py:138-146``; the eigh route needs no such jitter).
    """
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    inner = _sqrtm_psd(s1h @ sigma2 @ s1h)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(inner))


def fid_from_features(feat1: np.ndarray, feat2: np.ndarray) -> float:
    """Convenience: FID between two feature sets."""
    mu1, s1 = gaussian_stats(feat1)
    mu2, s2 = gaussian_stats(feat2)
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score_from_probs(
    probs: np.ndarray, splits: int = 4
) -> Tuple[float, float]:
    """IS from (N, C) class probabilities.

    Parity: ``IS_score.py:44-66`` — split into ``splits`` parts, per part
    exp(mean_i KL(p(y|x_i) || p(y))), return mean/std over parts.
    """
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (n // splits) : (k + 1) * (n // splits)]
        if part.shape[0] == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _poly_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                 gamma: Optional[float] = None, coef: float = 1.0) -> np.ndarray:
    d = x.shape[1]
    if gamma is None:
        gamma = 1.0 / d
    return (x @ y.T * gamma + coef) ** degree


def _mmd2_unbiased(kxx: np.ndarray, kyy: np.ndarray, kxy: np.ndarray) -> float:
    m = kxx.shape[0]
    diag_x = np.trace(kxx)
    diag_y = np.trace(kyy)
    term_x = (kxx.sum() - diag_x) / (m * (m - 1))
    term_y = (kyy.sum() - diag_y) / (m * (m - 1))
    term_xy = 2.0 * kxy.mean()
    return float(term_x + term_y - term_xy)


def kid_from_features(
    feat_real: np.ndarray,
    feat_fake: np.ndarray,
    subsets: int = 100,
    subset_size: int = 1000,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef: float = 1.0,
    seed: int = 0,
    normalize: str = "none",
) -> Tuple[float, float]:
    """KID = mean/std over random subsets of unbiased MMD^2 with the cubic
    polynomial kernel (torchmetrics defaults: 100 subsets of 1000).

    ``normalize``:
      * ``"none"`` — torchmetrics-exact: raw features, gamma = 1/d. Fine
        for Inception-scale activations; on raw LeNet features the cubic
        kernel explodes (magnitudes ~1e2 -> KID ~1e5, carries no signal).
      * ``"unit"`` — L2-normalize each feature row first and default
        gamma to 1 (x.y in [-1, 1], kernel bounded by (coef+1)^degree),
        so MMD^2 lands in the conventional O(1e-3..1) range regardless of
        the extractor's feature scale. This is the convention for all
        LeNet-frozen-space numbers (report as KID x 1e3).
    """
    feat_real = np.asarray(feat_real, np.float64)
    feat_fake = np.asarray(feat_fake, np.float64)
    if normalize == "unit":
        feat_real = feat_real / np.maximum(
            np.linalg.norm(feat_real, axis=1, keepdims=True), 1e-12)
        feat_fake = feat_fake / np.maximum(
            np.linalg.norm(feat_fake, axis=1, keepdims=True), 1e-12)
        if gamma is None:
            gamma = 1.0
    elif normalize != "none":
        raise ValueError(f"unknown normalize mode: {normalize!r}")
    n = min(feat_real.shape[0], feat_fake.shape[0])
    m = min(subset_size, n)
    rng = np.random.RandomState(seed)
    vals = []
    for _ in range(subsets):
        ri = rng.choice(feat_real.shape[0], m, replace=False)
        fi = rng.choice(feat_fake.shape[0], m, replace=False)
        x, y = feat_real[ri], feat_fake[fi]
        vals.append(
            _mmd2_unbiased(
                _poly_kernel(x, x, degree, gamma, coef),
                _poly_kernel(y, y, degree, gamma, coef),
                _poly_kernel(x, y, degree, gamma, coef),
            )
        )
    return float(np.mean(vals)), float(np.std(vals))
