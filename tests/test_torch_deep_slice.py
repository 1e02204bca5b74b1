"""The port's deep-cache serving against the JAX package's engine (CPU,
float32), through ``Engine.add_request`` and ``Engine.step``.

Both engines run the tiny pipelines with the same numpy weights
(``jax_to_torch_state_dict``), prompts and seeds, mixed batches off and
synchronous prepare and decode, under the production cache presets:

- SDXL, ``CacheConfig.production("sdxl", serving=False)`` (the bench's
  default trajectory: drift-adaptive refresh 0.3, cap 30, warmup 1,
  reuse-then-predict 0.5, CFG-pair rows at 0.3, boundary 1): three
  requests, padded to the batch bucket of 4;
- SD-1.5, ``CacheConfig.production("sd15", serving=True)`` (interval 12,
  warmup 3, row-granular warmup): two requests, and a third added once the
  first two have taken 4 denoising steps, so that its warmup runs as
  partial steps; the first two then finish and the third runs on alone
  from their shrunk row caches; and the plain deep cache (no row caches)
  at a fixed interval of 4 with the same admission.  Serving runs the
  ESyMReD policy, which admits mid-flight.

Each run's deep modes (read by a spy on each package's deep step), its
full-step count and its final latents must equal JAX's (latents at RTOL
2e-4, ATOL 5e-4).  Before each engine step the JAX requests' pending drift
values are made ready (JAX's CPU dispatch is asynchronous and the decision
reads the newest ready value; the port's CPU values are ready at once), so
that both decide on the newest value.  The composition store must drop a
finished request's entries before its decode, keep the survivors' shrunk
entry and hold nothing once the run or an abort is over.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.engine.engine import Engine as JaxEngine
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.request import SamplingParams
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
STEPS = 8
ADMIT_AFTER = 4  # denoising steps the first requests take before the third


def serving_policy(scheduler, serving: bool) -> None:
    """Serving admits requests mid-flight, which is ESyMReD's job (the FCFS
    policies run a batch to completion); a loose SLO keeps every admission
    and abort decision independent of the two packages' step times."""
    if serving:
        scheduler.policy = "esymred"
        scheduler.slo_scale = 1e4


def jax_engine(family: str, serving: bool, cache: dict = None):
    config = JaxConfig()
    config.model = JaxModelConfig(model=family, dtype="float32",
                                  test_tiny=True, use_patched=False, seed=3)
    config.scheduler.use_mixed_resolution = False
    serving_policy(config.scheduler, serving)
    config.engine.async_prepare = False
    config.engine.async_postprocess = False
    config.cache = (JaxCacheConfig(**cache) if cache else
                    JaxCacheConfig.production(family, serving=serving))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        engine = JaxEngine(config)
    pipe = engine.workers[0].pipeline
    modes, jit = [], pipe._jit

    def spy(name, fn, donate=()):  # the deep step's program, every step
        if isinstance(name, tuple) and name[0] in ("denoise_deep",
                                                   "denoise_deep_hybrid"):
            modes.append(name[1])
        return jit(name, fn, donate)

    pipe._jit = spy
    return engine, modes


def port_engine(family: str, serving: bool, jengine, cache: dict = None):
    params = jengine.workers[0].pipeline.bundle.params
    bundle = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    serving_policy(config.scheduler, serving)
    config.engine.async_prepare = False
    config.engine.async_postprocess = False
    config.cache = (CacheConfig(**cache) if cache else
                    CacheConfig.production(family, serving=serving))
    engine = Engine(config, "cpu", bundle=bundle)
    pipe = engine.workers[0].pipeline
    modes, step = [], pipe._deep_step

    def spy(mode, *args):
        modes.append(mode)
        return step(mode, *args)

    pipe._deep_step = spy
    return engine, modes


def drive(engine, plan, sampling, is_jax: bool, on_step=None):
    """Add ``plan``'s first requests, then the rest once the first has
    taken ``ADMIT_AFTER`` denoising steps; step to the end.  Returns the
    requests and their outputs by id."""
    first, later = plan
    reqs = [engine.add_request(rid, sampling(rid, res)) for rid, res in first]
    outs = {}
    while engine.has_unfinished_requests():
        if later and reqs[0].sampler_table is not None \
                and reqs[0].sampler_table.step >= ADMIT_AFTER:
            reqs += [engine.add_request(rid, sampling(rid, res))
                     for rid, res in later]
            later = []
        if is_jax:
            for r in reqs:
                jax.block_until_ready(r.drift_pending)
        outs.update({o.request_id: o for o in engine.step()})
        if on_step is not None:
            on_step(engine, reqs)
    return reqs, outs


def run_both(family, serving, plan, on_port_step=None, cache=None):
    jengine, jmodes = jax_engine(family, serving, cache)
    pengine, pmodes = port_engine(family, serving, jengine, cache)

    def sampling(cls):
        return lambda rid, res: cls(
            prompt=f"a prompt for {rid}", negative_prompt="blurry",
            resolution=res, num_inference_steps=STEPS,
            seed=int(rid[1:]) + 5, output_type="latent")

    _, jouts = drive(jengine, plan, sampling(JaxSamplingParams), True)
    preqs, pouts = drive(pengine, plan, sampling(SamplingParams), False,
                         on_port_step)
    assert pmodes == jmodes, (pmodes, jmodes)
    assert pmodes.count("full") == jmodes.count("full")
    assert sorted(pouts) == sorted(jouts)
    for rid, o in pouts.items():
        assert o.finished and o.image.shape == jouts[rid].image.shape
        np.testing.assert_allclose(o.image, jouts[rid].image, rtol=RTOL,
                                   atol=ATOL, err_msg=rid)
    return pengine, pmodes


def test_sdxl_bench_default_trajectory_equals_jax():
    plan = ([("r0", 64), ("r1", 64), ("r2", 64)], [])
    pengine, modes = run_both("sdxl", False, plan)
    assert modes[0] == "full" and "shallow" in modes and len(modes) == STEPS
    pipe = pengine.workers[0].pipeline
    assert not pipe._comp_state and not pipe._deep_carry


def test_sd15_row_warmup_admission_equals_jax():
    """The third request's warmup runs as partial steps; after each step
    the store holds only live requests' entries, and once the first two
    have finished the survivor's shrunk entry."""
    seen = []

    def on_step(engine, reqs):
        pipe = engine.workers[0].pipeline
        live = {r.request_id for r in reqs if r.finish_time is None}
        for key in list(pipe._comp_state) + list(pipe._deep_carry):
            ids = key[3] if len(key) == 5 else key[2]
            assert set(ids) <= live, (key, live)
        if live == {"r2"}:
            seen.append([(k[3], e["anchored"])
                         for k, e in pipe._comp_state.items()])

    plan = ([("r0", 64), ("r1", 64)], [("r2", 64)])
    pengine, modes = run_both("sd15", True, plan, on_step)
    assert "partial" in modes and "shallow" in modes
    assert modes.count("partial") == 3  # the third request's warmup
    assert seen[0] == [(("r2",), True)]  # shrunk from the finished batch
    pipe = pengine.workers[0].pipeline
    assert not pipe._comp_state and not pipe._deep_carry


def test_plain_deep_row_warmup_equals_jax():
    """The plain deep cache (no hybrid rows) at a fixed interval of 4 with
    row warmup: partial steps without row caches, the batch-wide expiry
    full and the batch-form carry."""
    cache = dict(enabled=True, mode="deep", deep_interval=4, deep_warmup=2,
                 deep_row_warmup=True, deep_boundary=1)
    plan = ([("r0", 64), ("r1", 64)], [("r2", 64)])
    pengine, modes = run_both("sd15", True, plan, cache=cache)
    assert {"full", "shallow", "partial"} <= set(modes)
    assert not pengine.workers[0].pipeline._deep_carry


def test_abort_and_finish_evict_the_request_state(monkeypatch):
    """An aborted request's entries go at once and the survivor keeps a
    shrunk entry; ``release_serving_state`` drops every entry, so the next
    step anchors fresh rows with a full step; a finished request's entries
    are gone before its decode; the run ends with an empty store."""
    from sduss_tpu_torch.pipelines.base import BasePipeline

    decoded, decode = [], BasePipeline._decode_group

    def check_decode(self, reqs):
        ids = {r.request_id for r in reqs}
        assert not any(ids.intersection(k[3]) for k in self._comp_state)
        assert not any(ids.intersection(k[2]) for k in self._deep_carry)
        decoded.extend(ids)
        return decode(self, reqs)

    monkeypatch.setattr(BasePipeline, "_decode_group", check_decode)
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    serving_policy(config.scheduler, True)
    config.cache = CacheConfig.production("sd15", serving=True)
    engine = Engine(config, "cpu")
    pipe = engine.workers[0].pipeline
    reqs = [engine.add_request(f"a{i}", SamplingParams(
        prompt=f"p{i}", resolution=64, num_inference_steps=STEPS, seed=i))
        for i in range(2)]
    while reqs[0].sampler_table is None or reqs[0].sampler_table.step < 4:
        engine.step()
    assert [k[3] for k in pipe._comp_state] == [("a0", "a1")]
    assert [o.request_id for o in engine.abort_requests(["a0"])] == ["a0"]
    assert [(k[3], e["anchored"]) for k, e in pipe._comp_state.items()] \
        == [(("a1",), True)]
    assert all("a0" not in k[2] for k in pipe._deep_carry)
    engine.step()
    pipe.release_serving_state()
    assert not pipe._comp_state and not pipe._deep_carry
    modes, step = [], pipe._deep_step
    monkeypatch.setattr(pipe, "_deep_step", lambda mode, *a: (
        modes.append(mode), step(mode, *a))[1])
    engine.step()
    assert modes == ["full"]
    outs = []
    while engine.has_unfinished_requests():
        outs.extend(engine.step())
    assert [o.request_id for o in outs] == ["a1"] and outs[0].finished
    assert decoded == ["a1"]
    assert not pipe._comp_state and not pipe._deep_carry
