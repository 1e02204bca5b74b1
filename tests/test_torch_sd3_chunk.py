"""Fused multi-step dispatch on SD3's token path: the port's
``denoise_chunk`` against the JAX package's (CPU, float32, the tiny SD3
pipeline with sequence buckets of 64 and 128 px, two 64^2 requests; the
same numpy weights through ``jax_to_torch_state_dict``).

One case per case of ``tests/test_sd3_chunk.py``: exactness (dense, the
compact token cache after its anchor, the span from a fresh entry, at an
off-boundary phase, with no full inside the chunk, span with compact, the
fine gate) and eligibility (an un-anchored compact state, an off-boundary
span start, mixed resolutions, a request shorter than the chunk, the span
with ``deep_predict``).  ``test_cold_key_refuses_when_allow_cold_false``
has no counterpart: eager PyTorch compiles nothing, so the port has no
cold keys and its chunk takes no ``allow_cold``.

Each case runs the same requests through both packages: the same
eligibility at every chunk call, and the same final latents (RTOL 2e-4,
ATOL 5e-4) and span delta age; the port's chunk also equals its k
per-step calls (a cache-off chunk runs the token path, as JAX's does,
where the per-step step is dense: equal within the same tolerance).
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
RESOLUTIONS = (64, 128)


def cache_kwargs(cache=None, span=None, interval=2, fine=0.0, predict=0.0):
    """``tests/test_sd3_chunk.py``'s ``make_pipe`` cache."""
    kw = dict(enabled=cache is not None or span is not None,
              deep_interval=interval, deep_warmup=0, sd3_deep_span=span,
              deep_predict=predict, max_hits=4)
    if cache == "compact":
        kw.update(mode="compact", compact_fraction=0.5,
                  patch_fraction=fine if fine > 0 else 1.0)
    elif span is not None:
        kw["mode"] = "deep"
    return kw


_JAX_PIPES = {}


def jax_pipe(cache: dict):
    """A JAX pipeline under ``cache``, shared by every case whose compiled
    programs are the same (the cache mode, token fraction and span: the
    interval and its phase are traced scalars, ``deep_predict`` a host
    decision), its state released."""
    key = (cache.get("mode"), cache.get("patch_fraction"),
           cache.get("sd3_deep_span"))
    pipe = _JAX_PIPES.get(key)
    if pipe is None:
        config = JaxConfig()
        config.model = JaxModelConfig(model="sd3", test_tiny=True,
                                      dtype="float32", seed=3,
                                      resolutions=RESOLUTIONS)
        config.scheduler = JaxSchedulerConfig(use_mixed_resolution=True)
        config.cache = JaxCacheConfig(**cache)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxBundle, "init_random", _np_init)
            pipe = _JAX_PIPES[key] = jax_build_pipeline(config)
    pipe.config.cache = JaxCacheConfig(**cache)
    if hasattr(pipe, "_sd3_cache_obj"):
        pipe._sd3_cache_obj.config = pipe.config.cache
    pipe.release_serving_state()
    return pipe


@pytest.fixture(scope="module")
def bundle():
    params = jax_pipe(cache_kwargs()).bundle.params
    b = ModelBundle("sd3", tiny=True, dtype=torch.float32, device="cpu")
    b.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    return b


def port_pipe(cache: dict, bundle):
    config = default_config("sd3", dtype="float32", test_tiny=True,
                            resolutions=RESOLUTIONS)
    config.cache = CacheConfig(**cache)
    return build_pipeline(config, "cpu", bundle=bundle)


def drive(pipe, is_jax, steps, plan, resolutions=(64, 64)):
    """Requests at ``resolutions``, then ``plan``: "s<n>" n per-step
    steps, "c<k>" a k-step chunk (its eligibility recorded), "p<k>" k
    per-step steps in its place.  Returns the requests, the recorded
    eligibilities and the span delta's age (None without an entry)."""
    reqs = [(JaxRequest if is_jax else Request)(
        f"r{i}", (JaxSamplingParams if is_jax else SamplingParams)(
            prompt=f"p{i}", resolution=res, num_inference_steps=steps,
            seed=i)) for i, res in enumerate(resolutions)]
    pipe.prepare(reqs)
    by_res = {}
    for r in reqs:
        r.stage = JaxStage.DENOISING if is_jax else Stage.DENOISING
        by_res.setdefault(r.resolution, []).append(r)
    got = []
    for op in plan:
        if op[0] == "c":
            got.append(pipe.denoise_chunk(by_res, int(op[1:])))
        else:
            for _ in range(int(op[1:])):
                pipe.denoise_step(by_res)
    entries = list(getattr(pipe, "_sd3_state", {}).values())
    age = entries[-1]["deep_age"] if entries else None
    return reqs, got, age


def lat(r, is_jax):
    return (np.asarray(r.latents, np.float32) if is_jax
            else r.latents.float().numpy())


# name: (cache, steps each, plan, eligibility the JAX tests pin, resolutions)
CASES = {
    "dense_chunk_matches_per_step": (cache_kwargs(), 4, ["c4"], [True]),
    "compact_chunk_matches_per_step": (cache_kwargs("compact"), 5,
                                       ["s1", "c4"], [True]),
    "span_chunk_matches_per_step": (cache_kwargs(span=(1, 2)), 4, ["c4"],
                                    [True]),
    "span_chunk_off_boundary_phase": (cache_kwargs(span=(1, 2), interval=4),
                                      6, ["s2", "c4"], [True]),
    "span_chunk_no_full_inside": (cache_kwargs(span=(1, 2), interval=12), 5,
                                  ["s2", "c3"], [True]),
    "span_compact_chunk_matches_per_step": (
        cache_kwargs("compact", span=(1, 2)), 6, ["s2", "c4"], [True]),
    "fine_chunk_matches_per_step": (cache_kwargs("compact", fine=0.5), 5,
                                    ["s1", "c4"], [True]),
    "unanchored_compact_refuses": (cache_kwargs("compact"), 4, ["c4"],
                                   [False]),
    "span_off_boundary_now_eligible": (cache_kwargs(span=(1, 2), interval=3),
                                       8, ["s1", "c3"], [True]),
    "mixed_resolutions_refuse": (cache_kwargs(), 4, ["c4"], [False],
                                 (64, 128)),
    "short_requests_refuse": (cache_kwargs(), 2, ["c4"], [False]),
    "span_predict_refuses": (cache_kwargs(span=(1, 2), predict=0.5), 6,
                             ["c4"], [False]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sd3_chunk_matches_jax_and_per_step(case, bundle):
    cache, steps, plan, want, *res = CASES[case]
    res = res[0] if res else (64, 64)
    jreqs, jgot, jage = drive(jax_pipe(cache), True, steps, plan, res)
    preqs, pgot, page = drive(port_pipe(cache, bundle), False, steps, plan,
                              res)
    assert jgot == pgot == want
    if not any(want):
        return
    sreqs, _, sage = drive(port_pipe(cache, bundle), False, steps,
                           ["p" + op[1:] if op[0] == "c" else op
                            for op in plan], res)
    assert page == jage == sage
    if case == "span_chunk_no_full_inside":
        assert page == 4  # the chunk ages the delta by k
    for j, p, s in zip(jreqs, preqs, sreqs):
        assert p.remain_steps == j.remain_steps == s.remain_steps
        np.testing.assert_allclose(lat(p, False), lat(j, True), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lat(p, False), lat(s, False), rtol=RTOL,
                                   atol=ATOL)
