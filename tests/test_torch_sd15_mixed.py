"""The port's SD-1.5 mixed-resolution patch path against the JAX package
on CPU, with the Euler sampler and with the stateful PNDM.

64^2 + 128^2 + 192^2 requests at 64 px patches (latents of 8, 16 and 24
cells: patch grids 1, 2 and 3, three resolution classes) run the port
through its engine, whose scheduler forms one mixed DENOISING batch per
step, and the JAX pipeline's ``denoise_step_mixed`` directly.  PNDM takes
num_steps + 1 evaluations, its per-request state sliced into patches and
merged back each step.  Same weights, prompts and seeds as
tests/test_torch_sd15_slice.py; bounds: final latents within 1e-4 of
max |JAX|, decoded images within one uint8 level.
"""

from __future__ import annotations

import numpy as np
import pytest

from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from test_torch_sd15_slice import (PROMPTS, assert_outputs_close,
                                   jax_pipeline, port_bundle)
from test_torch_slice import torch_threads  # noqa: F401

MIXED_RES = [64, 128, 192]
STEPS = 2
PATCH = 64


@pytest.fixture(scope="module")
def runs():
    """Per sampler: the JAX pipeline's final latents and images, and the
    port bundle (both from the same numpy-drawn weights)."""
    out = {}
    for sampler in ("euler", "pndm"):
        jpipe = jax_pipeline(sampler, use_mixed_resolution=True,
                             patch_size=PATCH)
        pipe = jpipe.engine.workers[0].pipeline
        reqs = [JaxRequest(f"m{i}", JaxSamplingParams(
            prompt=PROMPTS[i % 2], negative_prompt="blurry", resolution=res,
            num_inference_steps=STEPS, seed=11 + i))
            for i, res in enumerate(MIXED_RES)]
        pipe.prepare(reqs)
        by_res = {r.resolution: [r] for r in reqs}
        for _ in range(reqs[0].sampler_table.num_steps):
            pipe.denoise_step_mixed(by_res)
        latents = [np.asarray(r.latents[0], np.float32) for r in reqs]
        pipe.postprocess(by_res)
        out[sampler] = (latents, [r.output for r in reqs], port_bundle(jpipe))
    return out


@pytest.mark.parametrize("sampler", ["euler", "pndm"])
@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_sd15_mixed_slice_matches_jax(runs, sampler, output_type, tmp_path):
    latents, images, bundle = runs[sampler]
    config = default_config(dtype="float32", test_tiny=True, sampler=sampler)
    config.scheduler.patch_size = PATCH
    config.engine.collect_data = True
    config.engine.collect_dir = str(tmp_path)
    assert config.scheduler.use_mixed_resolution
    port = DiffusionPipeline(config=config, device="cpu", bundle=bundle)
    outs = port.generate([PROMPTS[i % 2] for i in range(len(MIXED_RES))],
                         negative_prompt="blurry", resolution=MIXED_RES,
                         num_inference_steps=STEPS, seed=11,
                         output_type=output_type)
    evals = STEPS + 1 if sampler == "pndm" else STEPS
    denoise = [e["resolutions"] for e in port.engine.workers[0].schedule_log
               if e["stage"] == "denoising"]
    assert denoise == ["64x1;128x1;192x1"] * evals, denoise
    assert_outputs_close(outs, latents if output_type == "latent" else images,
                         output_type)
