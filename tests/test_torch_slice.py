"""The port's serving slice against the JAX package, end to end on CPU.

Both packages run the tiny SDXL ``DiffusionPipeline`` in float32 with the
same weights (the JAX bundle's, drawn with numpy, carried over by
``jax_to_torch_state_dict``), prompts and seeds, through engine, scheduler,
CLIP-L/G encode, Euler denoising with CFG and VAE decode.  Bounds: final latents within 1e-3 relative to their
scale (float32 sums taken in another order over three denoise steps), and
decoded images within one uint8 level (rounding at the .5 boundary).

The mixed-resolution slice (128 px + 256 px requests at 128 px patches:
latents of 16 and 32 cells, patch grids 1 and 2) runs the port through
its engine, whose scheduler forms one mixed DENOISING batch, and the JAX
pipeline's ``denoise_step_mixed`` directly (its serving worker would route
a composition whose program is not compiled yet to the dense step), under
the same bounds.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.entrypoints.offline import DiffusionPipeline as JaxPipeline
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.request import SamplingParams
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle

LATENT_RTOL = 1e-3
PROMPTS = ["a red cat on a mat", "a lighthouse at dusk"]
KW = dict(negative_prompt="blurry", resolution=64, num_inference_steps=3,
          seed=11)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch intra-op thread while a port test module runs.  Tier-1
    runs six pytest workers on eight cores, so torch's default of one
    thread a core oversubscribes them (its OpenMP threads spin-wait)
    beside the JAX tests' own thread pools.  Other port test modules
    import this fixture, which makes it autouse there too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_init(self, seed=0, dtype=None, host_roles=()):
    """Random float32 weights for a JAX bundle, drawn with numpy in the trees
    each ``model.init`` builds (JAX's own eager init takes ~20 s here)."""
    for i, (name, model) in enumerate(sorted(self.models.items())):
        rng = np.random.default_rng(seed + i)

        def leaf(path, s, rng=rng):
            if len(s.shape) == 1:  # norm affines and biases
                base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
                return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

        shapes = jax.eval_shape(model.init, jax.random.key(0))
        self.params[name] = jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def both():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jpipe = JaxPipeline("sdxl", dtype="float32", test_tiny=True,
                            use_patched=False, seed=3)
    params = jpipe.engine.workers[0].pipeline.bundle.params
    sds = {role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
           for role, p in params.items()}
    bundle = ModelBundle("sdxl", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts(sds)
    tpipe = DiffusionPipeline("sdxl", device="cpu", dtype="float32",
                              test_tiny=True, bundle=bundle)
    return jpipe, tpipe


MIXED_RES = [128, 256, 256]
MIXED_STEPS = 2


def _mixed_config(config):
    config.scheduler.use_mixed_resolution = True
    config.scheduler.patch_size = 128
    config.engine.collect_data = True
    return config


@pytest.fixture(scope="module")
def mixed_jax(both):
    """JAX: prepare, MIXED_STEPS patched steps, then the final latents and
    the decoded images of the MIXED_RES requests."""
    jpipe = both[0].engine.workers[0].pipeline
    saved = jpipe.config.scheduler
    jpipe.config.scheduler = dataclasses.replace(
        saved, use_mixed_resolution=True, patch_size=128)
    try:
        reqs = [JaxRequest(f"m{i}", JaxSamplingParams(
            prompt=PROMPTS[i % 2], negative_prompt="blurry", resolution=res,
            num_inference_steps=MIXED_STEPS, seed=11 + i))
            for i, res in enumerate(MIXED_RES)]
        jpipe.prepare(reqs)
        by_res = {}
        for r in reqs:
            by_res.setdefault(r.resolution, []).append(r)
        for _ in range(MIXED_STEPS):
            jpipe.denoise_step_mixed(by_res)
        latents = [np.asarray(r.latents[0], np.float32) for r in reqs]
        jpipe.postprocess(by_res)
        return latents, [r.output for r in reqs]
    finally:
        jpipe.config.scheduler = saved


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_mixed_slice_matches_jax(both, mixed_jax, output_type, tmp_path):
    tpipe = both[1]
    config = _mixed_config(default_config("sdxl", dtype="float32",
                                          test_tiny=True))
    config.engine.collect_dir = str(tmp_path)
    port = DiffusionPipeline(config=config, device="cpu",
                             bundle=tpipe.engine.workers[0].pipeline.bundle)
    outs = port.generate([PROMPTS[i % 2] for i in range(len(MIXED_RES))],
                         negative_prompt="blurry", resolution=MIXED_RES,
                         num_inference_steps=MIXED_STEPS, seed=11,
                         output_type=output_type)
    denoise = [e["resolutions"] for e in port.engine.workers[0].schedule_log
               if e["stage"] == "denoising"]
    assert denoise == ["128x1;256x2"] * MIXED_STEPS
    want = mixed_jax[0] if output_type == "latent" else mixed_jax[1]
    for o, j in zip(outs, want):
        assert o.finished and o.image.shape == j.shape
        if output_type == "latent":
            err = np.abs(o.image - j).max()
            assert err <= LATENT_RTOL * np.abs(j).max(), err
        else:
            assert o.image.dtype == np.uint8
            assert np.abs(o.image.astype(int) - j.astype(int)).max() <= 1


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_slice_matches_jax(both, output_type):
    jpipe, tpipe = both
    jout = jpipe.generate(PROMPTS, output_type=output_type, **KW)
    tout = tpipe.generate(PROMPTS, output_type=output_type, **KW)
    assert [o.finished for o in tout] == [True, True]
    for j, t in zip(jout, tout):
        assert t.image.shape == j.image.shape
        if output_type == "latent":
            scale = np.abs(j.image).max()
            err = np.abs(t.image - j.image).max()
            assert err <= LATENT_RTOL * scale, (err, scale)
        else:
            assert t.image.dtype == np.uint8
            diff = np.abs(t.image.astype(int) - j.image.astype(int))
            assert diff.max() <= 1


def test_slice_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline
        p = DiffusionPipeline("sdxl", device="cpu", dtype="float32",
                              test_tiny=True)
        out = p.generate(["a cat"], resolution=64, num_inference_steps=2,
                         seed=0)
        assert out[0].finished and out[0].image.dtype.name == "uint8"
        assert "jax" not in sys.modules, "jax was imported"
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_cuda_device_required_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionPipeline("sdxl")


@pytest.mark.parametrize("section,field,value", [
    ("cache", "enabled", True),
    ("parallel", "dp", 2),
    ("parallel", "sp", 2),
    ("scheduler", "steps_per_dispatch", 4),
])
def test_unported_configs_raise(section, field, value):
    """Each configuration serves on the default mixed patch path: the
    block cache (``cache.enabled``, mode "block" by default) one mixed
    step of finite latents through the cache, ``steps_per_dispatch=4`` one
    mixed 4-step chunk, ``dp=2`` one step on each of two replicas, and
    ``sp=2`` one mixed step on the patch batch split over two shards."""
    config = default_config("sdxl", dtype="float32", test_tiny=True)
    setattr(getattr(config, section), field, value)
    config.scheduler.patch_size = 64
    pipe = DiffusionPipeline(config=config, device="cpu")
    inner = pipe.engine.workers[0].pipeline
    chunks, chunk = [], inner.denoise_chunk_mixed
    inner.denoise_chunk_mixed = lambda by_res, k: (
        chunks.append(k), chunk(by_res, k))[1]
    steps = 4 if section == "scheduler" else 1
    outs = pipe.generate(["a cat", "a dog"], resolution=[64, 128],
                         num_inference_steps=steps, seed=0,
                         output_type="latent")
    if section == "cache":
        assert inner._cache_obj is not None
    elif section == "scheduler":
        assert chunks == [4]
    elif field == "sp":
        assert inner.group.sp == 2 and len(inner.devices) == 2
    else:  # greedy dispatch: one request on each replica
        assert [w.iteration > 0 for w in pipe.engine.workers] == [True] * 2
    assert all(o.finished and np.isfinite(o.image).all() for o in outs)


@pytest.mark.parametrize("kwargs", [
    dict(model_path="/nonexistent/sdxl-snapshot"),
    dict(dp=2),
    dict(dp=4),
])
def test_unported_entry_kwargs_raise(kwargs):
    """The JAX entry point's keywords reach the config: a snapshot that is
    not there raises instead of serving random weights, and ``dp`` builds
    that many replicas (all on the CPU here)."""
    if "model_path" in kwargs:
        with pytest.raises(FileNotFoundError):
            DiffusionPipeline("sdxl", device="cpu", dtype="float32",
                              test_tiny=True, **kwargs)
        return
    pipe = DiffusionPipeline("sdxl", device="cpu", dtype="float32",
                             test_tiny=True, **kwargs)
    workers = pipe.engine.workers
    assert pipe.engine.config.parallel.dp == len(workers) == kwargs["dp"]
    assert {w.device for w in workers} == {torch.device("cpu")}
    assert len({id(w.pipeline.bundle) for w in workers}) == 1


def test_default_config_is_the_mixed_patch_path():
    """The port's defaults are the JAX package's: fcfs_mixed with mixed
    denoise batches on the patch path."""
    config = default_config("sdxl", dtype="float32", test_tiny=True)
    assert config.scheduler.policy == "fcfs_mixed"
    assert config.scheduler.use_mixed_resolution
    assert config.model.use_patched
    assert DiffusionPipeline("sdxl", device="cpu", dtype="float32",
                             test_tiny=True, use_patched=True).config \
        .model.use_patched


def test_model_bundle_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelBundle("sdxl", tiny=True)


def test_abort_and_single_resolution_batches():
    config = default_config("sdxl", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.engine.collect_data = True
    eng = DiffusionPipeline(config=config, device="cpu").engine
    for i, res in enumerate((64, 128, 64, 128)):
        eng.add_request(f"r{i}", SamplingParams(prompt=f"p {i}", resolution=res,
                                                num_inference_steps=2, seed=i))
    assert [o.request_id for o in eng.abort_requests(["r1"])] == ["r1"]
    outs = []
    while eng.has_unfinished_requests():
        outs.extend(eng.step())
    assert sorted(o.request_id for o in outs) == ["r0", "r2", "r3"]
    assert all(o.finished and o.image.dtype == np.uint8 for o in outs)
    denoise = [e for e in eng.workers[0].schedule_log
               if e["stage"] == "denoising"]
    assert {e["resolutions"] for e in denoise} == {"64x2", "128x1"}
