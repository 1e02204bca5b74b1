"""Learned per-step batch latency predictor.

The reference trains an offline SVR over resolution-count distributions and
loads it as a joblib pickle (sduss/worker/scheduler/policy/ESyMReD.py:20-66):
features = [count_per_resolution..., weighted_pixels, nnz_resolutions].

Here: the same feature map feeding a closed-form ridge regression
implemented in numpy — trainable from profiler samples in milliseconds,
serialized as npz.  The analytic fallback (no training data) models
per-step time as base + sum(count_r * slope_r), for batched UNet steps that
scale near-linearly in patch count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from sduss_tpu_torch.scheduler.profiles import StageProfile


def distribution_features(counts: Sequence[int], resolutions: Sequence[int]) -> np.ndarray:
    """Feature row for a resolution-count distribution.

    counts[i] = number of active requests at resolutions[i] (sorted).
    """
    counts = np.asarray(counts, np.float64)
    res = np.asarray(resolutions, np.float64)
    weighted = float(np.sum(counts * (res / 256.0) ** 2))
    nnz = float(np.count_nonzero(counts))
    return np.concatenate([counts, [weighted, nnz]])


class LatencyPredictor:
    """Per-step latency (seconds) from a resolution-count distribution."""

    def __init__(self, resolutions: Sequence[int], profile: StageProfile,
                 weights: Optional[np.ndarray] = None):
        self.resolutions = sorted(resolutions)
        self.profile = profile
        self.weights = weights  # (n_features + 1,) ridge weights incl. bias

    # -- inference -----------------------------------------------------------

    def predict(self, counts: Sequence[int]) -> float:
        """Predicted seconds for ONE denoiser step at this batch mix."""
        if self.weights is not None:
            x = distribution_features(counts, self.resolutions)
            return float(max(np.dot(self.weights[:-1], x) + self.weights[-1], 1e-4))
        # Analytic fallback: base overhead + linear per-request cost.
        total = 0.0
        any_active = False
        for c, r in zip(counts, self.resolutions):
            if c > 0:
                any_active = True
                step = self.profile.step_latency_s(r)
                # Heuristic prior for the un-fitted fallback only: marginal
                # cost of additional same-res requests assumed ~55% of solo
                # (rough shape of the measured sdxl batch curve; fitted
                # weights from the on-device profiler replace this).
                total += step + max(c - 1, 0) * step * 0.55
        return total if any_active else 0.0

    def single_request_step_s(self, resolution: int) -> float:
        return self.profile.step_latency_s(resolution)

    # -- training ------------------------------------------------------------

    def fit(self, count_rows: Sequence[Sequence[int]], step_seconds: Sequence[float],
            l2: float = 1e-6) -> None:
        """Closed-form ridge regression on profiler samples."""
        X = np.stack([distribution_features(c, self.resolutions) for c in count_rows])
        X = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        y = np.asarray(step_seconds, np.float64)
        a = X.T @ X + l2 * np.eye(X.shape[1])
        self.weights = np.linalg.solve(a, X.T @ y)

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, resolutions=np.asarray(self.resolutions))

    @classmethod
    def load(cls, path: str, profile: StageProfile) -> "LatencyPredictor":
        d = np.load(path)
        return cls(list(d["resolutions"]), profile, weights=d["weights"])
