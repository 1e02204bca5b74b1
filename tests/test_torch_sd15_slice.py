"""The port's SD-1.5 serving slice against the JAX package on CPU: the
dense path with the Euler sampler (the family default) and with DDIM.

Both packages run the tiny ``sd15`` ``DiffusionPipeline`` (conv-projection
UNet, CLIP-L alone, CFG 7.5) in float32 with the same weights (the JAX
bundle's, drawn with numpy and carried over by ``jax_to_torch_state_dict``),
prompts and seeds, through engine, scheduler, CLIP encode, denoising and VAE
decode; 64^2 and 128^2 requests form two resolution groups (the 128^2
self-attention has 256 keys and takes the K1 route).  Bounds: final latents
within 1e-4 of max |JAX|, decoded images within one uint8 level.  The mixed
patch path with Euler and PNDM is in tests/test_torch_sd15_mixed.py.
"""

from __future__ import annotations

import csv

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.entrypoints.offline import DiffusionPipeline as JaxPipeline
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu_torch.config import Config
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.pipelines.sd import StableDiffusionPipeline
from test_torch_slice import _np_init, torch_threads  # noqa: F401

LATENT_RTOL = 1e-4
PROMPTS = ["a red cat on a mat", "a lighthouse at dusk"]
KW = dict(negative_prompt="blurry", resolution=[64, 128],
          num_inference_steps=3, seed=11)


def jax_pipeline(sampler: str, **scheduler):
    """A tiny float32 JAX ``sd15`` pipeline with numpy-drawn weights (seed
    3) and the given sampler; ``scheduler`` overrides its scheduler
    fields."""
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, use_patched=False, seed=3,
                                  sampler=sampler)
    for field, value in scheduler.items():
        setattr(config.scheduler, field, value)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        return JaxPipeline(config=config)


def port_bundle(jpipe) -> ModelBundle:
    params = jpipe.engine.workers[0].pipeline.bundle.params
    bundle = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    return bundle


def assert_outputs_close(tout, want, output_type):
    """The port's outputs against the JAX package's latents or images."""
    assert [o.finished for o in tout] == [True] * len(want)
    for t, j in zip(tout, want):
        assert t.image.shape == j.shape
        if output_type == "latent":
            err = np.abs(t.image - j).max()
            assert err <= LATENT_RTOL * np.abs(j).max(), err
        else:
            assert t.image.dtype == np.uint8
            assert np.abs(t.image.astype(int) - j.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def jax_pipes():
    """One JAX pipeline per sampler, shared by both output types (its
    compiled steps are reused)."""
    return {s: jax_pipeline(s) for s in ("euler", "ddim")}


@pytest.fixture(scope="module")
def bundle(jax_pipes):
    return port_bundle(jax_pipes["euler"])


@pytest.mark.parametrize("sampler", ["euler", "ddim"])
@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_sd15_dense_slice_matches_jax(jax_pipes, bundle, sampler,
                                      output_type, tmp_path):
    jout = jax_pipes[sampler].generate(PROMPTS, output_type=output_type,
                                       **KW)
    config = default_config(dtype="float32", test_tiny=True, sampler=sampler)
    config.scheduler.use_mixed_resolution = False
    config.engine.collect_data = True
    config.engine.collect_dir = str(tmp_path)
    port = DiffusionPipeline(config=config, device="cpu", bundle=bundle)
    tout = port.generate(PROMPTS, output_type=output_type, **KW)
    assert port.engine.workers[0].pipeline.sampler.kind == sampler
    denoise = [e["resolutions"] for e in port.engine.workers[0].schedule_log
               if e["stage"] == "denoising"]
    assert sorted(set(denoise)) == ["128x1", "64x1"]
    assert_outputs_close(tout, [o.image for o in jout], output_type)


def test_collect_data_writes_the_jax_files(jax_pipes, bundle, tmp_path,
                                           monkeypatch):
    """With ``engine.collect_data`` on, ``generate`` writes
    ``request_data.csv`` and ``schedule_rank0.csv`` to
    ``engine.collect_dir`` with the JAX package's headers
    (engine.py ``dump_data``); the schedule CSV has one row per entry of
    the worker's schedule log."""
    jpipe = jax_pipes["euler"]
    monkeypatch.setattr(jpipe.config.engine, "collect_data", True)
    monkeypatch.setattr(jpipe.config.engine, "collect_dir",
                        str(tmp_path / "jax"))
    jpipe.generate(PROMPTS, output_type="latent", **KW)
    config = default_config(dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.engine.collect_data = True
    config.engine.collect_dir = str(tmp_path / "port")
    port = DiffusionPipeline(config=config, device="cpu", bundle=bundle)
    port.generate(PROMPTS, output_type="latent", **KW)
    for name in ("request_data.csv", "schedule_rank0.csv"):
        jax_lines = (tmp_path / "jax" / name).read_text().splitlines()
        port_lines = (tmp_path / "port" / name).read_text().splitlines()
        assert port_lines[0] == jax_lines[0]
    with open(tmp_path / "port" / "schedule_rank0.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    log = port.engine.workers[0].schedule_log
    assert len(rows) == len(log) > 0
    assert [r["stage"] for r in rows] == [e["stage"] for e in log]
    with open(tmp_path / "port" / "request_data.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == len(PROMPTS)


def test_default_pipeline_is_sd15():
    """``Config()`` and ``DiffusionPipeline()`` default to SD-1.5, as in
    the JAX package, and build (tiny, on the CPU)."""
    assert Config().model.family == "sd15"
    pipe = DiffusionPipeline(device="cpu", dtype="float32", test_tiny=True)
    assert pipe.config.model.family == "sd15"
    assert isinstance(pipe.engine.workers[0].pipeline, StableDiffusionPipeline)
    out = pipe.generate(["a cat"], resolution=64, num_inference_steps=2,
                        seed=0)
    assert out[0].finished and out[0].image.dtype == np.uint8
    assert out[0].image.std() > 0
    config = Config()
    config.model.test_tiny = True
    assert isinstance(build_pipeline(config, "cpu"), StableDiffusionPipeline)
