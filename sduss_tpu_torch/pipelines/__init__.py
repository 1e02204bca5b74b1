"""Pipeline registry (counterpart of sduss_tpu/pipelines/__init__.py)."""

from __future__ import annotations

import os
from typing import Optional

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.models.loader import load_bundle
from sduss_tpu_torch.models.registry import DTYPES, ModelBundle
from sduss_tpu_torch.pipelines.base import BasePipeline
from sduss_tpu_torch.pipelines.sd import StableDiffusionPipeline
from sduss_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from sduss_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

PIPELINES = {"sd15": StableDiffusionPipeline,
             "sdxl": StableDiffusionXLPipeline,
             "sd3": StableDiffusion3Pipeline}


def build_pipeline(config: Config, device,
                   bundle: Optional[ModelBundle] = None) -> BasePipeline:
    """Load the family's weights on ``device`` (unless a bundle is given)
    and build its pipeline.  ``device`` is a device or a replica's device
    list (``parallel/replica.py build_placements``): the weights load on
    its first, and more than one makes the pipeline serve over an sp x tp
    group.  The weights come from the diffusers snapshot at
    ``model.model_path``, or at ``model.model`` when that is a directory,
    as in the JAX package; seeded random ones otherwise.  A given bundle's
    VAE is cast to ``model.vae_dtype`` once here."""
    family = config.model.family
    if family not in PIPELINES:
        raise ValueError(f"family {family!r} not ported; ported: {sorted(PIPELINES)}")
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    mc = config.model
    if bundle is None:
        snapshot = mc.model_path or (mc.model if os.path.isdir(mc.model)
                                     else None)
        bundle = load_bundle(family, snapshot=snapshot, tiny=mc.test_tiny,
                             dtype=DTYPES[mc.dtype], seed=mc.seed,
                             device=devices[0], vae_dtype=mc.vae_dtype)
    else:
        bundle.set_vae_dtype(mc.vae_dtype)
    return PIPELINES[family](bundle, config,
                             devices if len(devices) > 1 else None)
