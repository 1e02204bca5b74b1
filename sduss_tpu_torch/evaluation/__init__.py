"""Quality evaluation: CLIP score and CLIP-FID of generated images
(counterpart of sduss_tpu/evaluation/)."""

from sduss_tpu_torch.evaluation.clip_score import ClipScorer, clip_score  # noqa: F401
from sduss_tpu_torch.evaluation.fid import (  # noqa: F401
    clip_fid, feature_stats, fid_from_features, frechet_distance)
