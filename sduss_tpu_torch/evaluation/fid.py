"""Frechet distance between image-feature distributions (counterpart of
sduss_tpu/evaluation/fid.py).

The reference vendors DistriFuser's COCO evaluation (torchmetrics FID over
InceptionV3).  Inception weights cannot be fetched here, so this computes
the same Frechet metric over any feature extractor; over the CLIP vision
tower (``models/clip_vision.py`` with real weights) it is the published
"CLIP-FID" variant.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^(1/2)) via eigenvalues."""
    diff = mu1 - mu2
    # the trace of sqrtm(S1 S2) from the product's eigenvalues, with tiny
    # negatives from rounding clipped
    prod = sigma1 @ sigma2
    eigvals = np.linalg.eigvals(prod)
    covmean_trace = np.sum(np.sqrt(np.clip(eigvals.real, 0.0, None)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * covmean_trace)


def feature_stats(features: np.ndarray):
    """(N, D) features -> (mean, covariance); needs N >= 2 (np.cov divides
    by N-1, so a single sample would give a silent NaN FID)."""
    features = np.atleast_2d(features)
    if features.shape[0] < 2:
        raise ValueError(
            f"FID needs >= 2 samples per set, got {features.shape[0]}")
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, s1 = feature_stats(np.asarray(real, np.float64))
    mu2, s2 = feature_stats(np.asarray(fake, np.float64))
    return frechet_distance(mu1, s1, mu2, s2)


def clip_fid(real_images: Sequence[np.ndarray],
             fake_images: Sequence[np.ndarray],
             snapshot: Optional[str] = None, batch: int = 16,
             device: str = "cuda") -> float:
    """CLIP-FID between two uint8 image sets (meaningful with real CLIP
    weights; runs end to end with random tiny ones for tests)."""
    from sduss_tpu_torch.evaluation.clip_score import ClipScorer

    scorer = ClipScorer(snapshot=snapshot, tiny=snapshot is None,
                        device=device)

    def embed(images):
        return np.concatenate([
            scorer.image_embeds(np.stack(images[i:i + batch]))
            for i in range(0, len(images), batch)], axis=0)

    return fid_from_features(embed(list(real_images)), embed(list(fake_images)))
