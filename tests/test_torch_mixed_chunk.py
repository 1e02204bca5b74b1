"""Fused multi-step dispatch on the mixed patch path: the port's
``denoise_chunk_mixed`` against the JAX package's (CPU, float32, tiny
SD-1.5, 64 px patches: a 64^2 and a 128^2 request, the patch grids 1 and
2 of ``tests/test_mixed_chunk.py``'s 256^2 + 512^2 at 256 px patches; the
same numpy weights through ``jax_to_torch_state_dict``).

One case per case of ``tests/test_mixed_chunk.py``: exactness (dense, the
block cache's rows threaded through the chunk, deep from a full boundary,
deep at any phase with no full inside and with one mid-chunk, the hybrid
from a boundary and at any phase, and per-step steps after a chunk) and
eligibility (the adaptive refresh, ``deep_predict``, warmup, ages out of
lockstep, a stateful sampler, a request shorter than the chunk).  Its
warm-daemon cases (``TestWarmDaemonDefersToProduction``,
``TestMixedWarmMintsChunk``) and ``allow_cold`` case
(``test_cold_key_queues_warm_and_refuses``) have no counterpart: eager
PyTorch compiles nothing, so the port has no cold keys to route around.

Each case runs the same requests through both packages: the same
eligibility at every chunk call, and the same final latents and deep ages
(RTOL 2e-4, ATOL 5e-4); the port's chunk also equals its k per-step
calls.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.config import SchedulerConfig as JaxSchedulerConfig
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu.request import Stage as JaxStage
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
PATCH = 64
RESOLUTIONS = (64, 128)


def cache_kwargs(mode=None, interval=2, hybrid=None, adaptive=0.0,
                 predict=0.0, warmup=0):
    """``tests/test_mixed_chunk.py``'s ``make_pipe`` cache."""
    kw = dict(enabled=mode is not None, deep_interval=interval,
              deep_warmup=warmup, deep_adaptive=adaptive,
              deep_predict=predict, max_hits=2, min_level=0,
              mse_threshold=1e9)
    if mode is not None:
        kw["mode"] = mode
        if hybrid is not None:
            kw["deep_compact_fraction"] = hybrid
    return kw


_JAX_PIPES = {}


def jax_pipe(cache: dict, sampler=None):
    """A JAX pipeline under ``cache``, shared by every case whose compiled
    programs are the same (the same cache mode, hybrid fraction and
    sampler: the interval, the warmup and the adaptive and predict knobs
    are host decisions and traced scalars), its state released."""
    key = (cache.get("mode"), cache.get("deep_compact_fraction"), sampler)
    pipe = _JAX_PIPES.get(key)
    if pipe is None:
        pipe = _JAX_PIPES[key] = _build_jax_pipe(cache, sampler)
    pipe.config.cache = JaxCacheConfig(**cache)
    if hasattr(pipe, "_cache_obj"):
        pipe._cache_obj.config = pipe.config.cache
    pipe.release_serving_state()
    return pipe


def _build_jax_pipe(cache: dict, sampler=None):
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", test_tiny=True,
                                  dtype="float32", seed=3, sampler=sampler)
    config.scheduler = JaxSchedulerConfig(use_mixed_resolution=True,
                                          patch_size=PATCH)
    config.cache = JaxCacheConfig(**cache)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        return jax_build_pipeline(config)


@pytest.fixture(scope="module")
def bundle():
    params = jax_pipe(cache_kwargs()).bundle.params
    b = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    b.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    return b


def port_pipe(cache: dict, bundle, sampler=None):
    config = default_config("sd15", dtype="float32", test_tiny=True,
                            sampler=sampler)
    config.scheduler.patch_size = PATCH
    config.cache = CacheConfig(**cache)
    return build_pipeline(config, "cpu", bundle=bundle)


def drive(pipe, is_jax, steps, plan):
    """The 64^2 and 128^2 requests, then ``plan``: "s" one mixed step,
    "c<k>" a k-step chunk (its eligibility recorded), "p<k>" k mixed steps
    in its place, "a<n>"/"b<n>" n steps of the first/second request
    alone."""
    reqs = [(JaxRequest if is_jax else Request)(
        f"r{i}", (JaxSamplingParams if is_jax else SamplingParams)(
            prompt=f"p{i}", resolution=res, num_inference_steps=steps,
            seed=i)) for i, res in enumerate(RESOLUTIONS)]
    pipe.prepare(reqs)
    by_res = {}
    for r in reqs:
        r.stage = JaxStage.DENOISING if is_jax else Stage.DENOISING
        by_res.setdefault(r.resolution, []).append(r)
    got = []
    for op in plan:
        n = int(op[1:]) if len(op) > 1 else 1
        if op[0] == "c":
            got.append(pipe.denoise_chunk_mixed(by_res, n))
        elif op[0] in "ab":
            r = reqs["ab".index(op[0])]
            for _ in range(n):
                pipe.denoise_step_mixed({r.resolution: [r]})
        else:
            for _ in range(n):
                pipe.denoise_step_mixed(by_res)
    return reqs, got


def lat(r, is_jax):
    return (np.asarray(r.latents, np.float32) if is_jax
            else r.latents.float().numpy())


# name: (cache, steps each, plan, eligibility the JAX tests pin, sampler)
CASES = {
    "dense": (cache_kwargs(), 4, ["c4"], [True], None),
    "block_cache_threads_state": (cache_kwargs("block"), 5, ["s", "c4"],
                                  [True], None),
    "deep_from_boundary": (cache_kwargs("deep", interval=2), 6,
                           ["s2", "c4"], [True], None),
    "deep_any_phase_shallow_only": (cache_kwargs("deep", interval=4), 4,
                                    ["s", "c3"], [True], None),
    "deep_any_phase_mid_interval_full": (cache_kwargs("deep", interval=3), 6,
                                         ["s2", "c4"], [True], None),
    "hybrid_from_boundary": (cache_kwargs("deep", interval=2, hybrid=0.5), 6,
                             ["s2", "c4"], [True], None),
    "hybrid_any_phase": (cache_kwargs("deep", interval=3, hybrid=0.5), 6,
                         ["s2", "c4"], [True], None),
    "chunk_then_per_step_continues": (
        cache_kwargs("deep", interval=2, hybrid=0.5), 6, ["s2", "c2", "s2"],
        [True], None),
    "adaptive_refuses": (cache_kwargs("deep", interval=2, adaptive=0.05), 6,
                         ["s2", "c2"], [False], None),
    "predict_refuses": (cache_kwargs("deep", interval=2, predict=0.5), 6,
                        ["s2", "c2"], [False], None),
    "warmup_refuses": (cache_kwargs("deep", interval=2, warmup=4), 8,
                       ["s2", "c2"], [False], None),
    "non_lockstep_ages_refuse": (cache_kwargs("deep", interval=4), 8,
                                 ["a2", "b3", "c2"], [False], None),
    "stateful_sampler_refuses": (cache_kwargs(), 6, ["c2"], [False], "pndm"),
    "short_requests_refuse": (cache_kwargs(), 2, ["c4"], [False], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_chunk_matches_jax_and_per_step(case, bundle):
    cache, steps, plan, want, sampler = CASES[case]
    jreqs, jgot = drive(jax_pipe(cache, sampler), True, steps, plan)
    preqs, pgot = drive(port_pipe(cache, bundle, sampler), False, steps,
                        plan)
    assert jgot == pgot == want
    if not any(want):
        return
    # the port's k per-step calls in place of its chunks
    sreqs, _ = drive(port_pipe(cache, bundle, sampler), False, steps,
                     ["p" + op[1:] if op[0] == "c" else op for op in plan])
    for j, p, s in zip(jreqs, preqs, sreqs):
        assert p.remain_steps == j.remain_steps == s.remain_steps
        if j.deep_state is not None:
            assert p.deep_age == j.deep_age == s.deep_age
        np.testing.assert_allclose(lat(p, False), lat(j, True), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lat(p, False), lat(s, False), rtol=RTOL,
                                   atol=ATOL)
    if case == "deep_any_phase_shallow_only":
        assert all(r.deep_age == 3 for r in preqs)
