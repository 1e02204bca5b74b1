"""Pipeline registry (counterpart of sduss_tpu/pipelines/__init__.py)."""

from __future__ import annotations

from typing import Optional

import torch

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines.base import BasePipeline
from sduss_tpu_torch.pipelines.sd import StableDiffusionPipeline
from sduss_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from sduss_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

PIPELINES = {"sd15": StableDiffusionPipeline,
             "sdxl": StableDiffusionXLPipeline,
             "sd3": StableDiffusion3Pipeline}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_pipeline(config: Config, device, bundle: Optional[ModelBundle] = None) -> BasePipeline:
    """Random-init a bundle on ``device`` (unless one is given) and build the
    family pipeline.  Loading checkpoints from disk is not ported yet
    (``engine.check_supported`` refuses ``model.model_path``)."""
    family = config.model.family
    if family not in PIPELINES:
        raise ValueError(f"family {family!r} not ported; ported: {sorted(PIPELINES)}")
    if bundle is None:
        bundle = ModelBundle(family, tiny=config.model.test_tiny,
                             dtype=DTYPES[config.model.dtype], device=device)
        bundle.init_random(seed=config.model.seed)
    return PIPELINES[family](bundle, config)
