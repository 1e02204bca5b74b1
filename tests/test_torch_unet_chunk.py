"""Fused multi-step dispatch on the UNet dense path: the port's
``denoise_chunk`` against the JAX package's (CPU, float32, tiny SD-1.5 at
64 px, the same numpy weights through ``jax_to_torch_state_dict``).

One case per case of ``tests/test_unet_chunk.py`` (exactness: dense,
compact after its anchor, deep and hybrid from a full boundary;
eligibility: the first steps before a deep feature exists, an
off-boundary start, the adaptive refresh, ``deep_predict``, an un-anchored
compact entry, warmup) and of the two chunk tests of
``tests/test_deep_partial.py`` (the row warmup's partial chunk against
per-step, and a partial chunk right after an admission).  Each case runs
the same requests through both packages: the same eligibility (True or
False) at every chunk call, and after an eligible chunk the same final
latents and deep ages and features (RTOL 2e-4, ATOL 5e-4).  The port's
chunk also equals k per-step calls of the port, the JAX tests' own
invariant.
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
RES = 64


def cache_kwargs(mode=None, interval=2, hybrid=None, adaptive=0.0,
                 predict=0.0, warmup=0):
    """``tests/test_unet_chunk.py``'s ``make_pipe`` cache."""
    kw = dict(enabled=mode is not None, deep_interval=interval,
              deep_warmup=warmup, deep_adaptive=adaptive,
              deep_predict=predict, max_hits=4, min_level=0)
    if mode is not None:
        kw["mode"] = mode
        if mode == "compact":
            kw["compact_fraction"] = 0.5
        if hybrid is not None:
            kw["deep_compact_fraction"] = hybrid
    return kw


def partial_kwargs():
    """``tests/test_deep_partial.py``'s ``make_pipe(True)`` cache."""
    return dict(enabled=True, mode="deep", deep_interval=4, deep_warmup=1,
                deep_adaptive=False, deep_drift_threshold=0.05,
                deep_max_interval=4, deep_row_warmup=True, min_level=0)


_JAX_PIPES = {}


def jax_pipe(cache: dict):
    """A JAX pipeline under ``cache``, shared by every case whose compiled
    programs are the same (the same cache mode, hybrid fraction and row
    warmup: the interval, the warmup and the adaptive and predict knobs
    are host decisions and traced scalars), its state released."""
    key = (cache.get("mode"), cache.get("deep_compact_fraction"),
           cache.get("deep_row_warmup"))
    pipe = _JAX_PIPES.get(key)
    if pipe is None:
        pipe = _JAX_PIPES[key] = _build_jax_pipe(cache)
    pipe.config.cache = JaxCacheConfig(**cache)
    if hasattr(pipe, "_cache_obj"):
        pipe._cache_obj.config = pipe.config.cache
    pipe.release_serving_state()
    return pipe


def _build_jax_pipe(cache: dict):
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", test_tiny=True,
                                  dtype="float32", seed=3)
    config.scheduler = JaxSchedulerConfig(use_mixed_resolution=False)
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


def port_pipe(cache: dict, bundle):
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.cache = CacheConfig(**cache)
    return build_pipeline(config, "cpu", bundle=bundle)


def admit(pipe, by_res, is_jax, index, steps):
    req = (JaxRequest if is_jax else Request)(
        f"r{index}", (JaxSamplingParams if is_jax else SamplingParams)(
            prompt=f"p{index}", resolution=RES, num_inference_steps=steps,
            seed=index))
    pipe.prepare([req])
    req.stage = JaxStage.DENOISING if is_jax else Stage.DENOISING
    by_res.setdefault(RES, []).append(req)
    return req


def drive(pipe, is_jax, n, steps, plan):
    """``n`` requests, then ``plan``: "s" one per-step step, "c<k>" a
    k-step chunk (its eligibility recorded), "p<k>" k per-step steps in
    its place, a callable applied to the requests.  Returns the requests
    and the recorded eligibilities."""
    by_res = {}
    reqs = [admit(pipe, by_res, is_jax, i, steps) for i in range(n)]
    got = []
    for op in plan:
        if callable(op):
            op(reqs, lambda i: reqs.append(admit(pipe, by_res, is_jax, i,
                                                 steps)))
        elif op == "s":
            pipe.denoise_step(by_res)
        elif op[0] == "c":
            got.append(pipe.denoise_chunk(by_res, int(op[1:])))
        else:
            for _ in range(int(op[1:])):
                pipe.denoise_step(by_res)
    return reqs, got


def lat(r, is_jax):
    return (np.asarray(r.latents, np.float32) if is_jax
            else r.latents.float().numpy())


def deep(r, is_jax):
    """A request's deep feature in the JAX layout (2, h, w, C)."""
    if is_jax:
        return np.asarray(r.deep_state, np.float32)
    return r.deep_state.permute(0, 2, 3, 1).float().numpy()


def set_ages(*ages):
    def op(reqs, _admit):
        for r, a in zip(reqs, ages):
            r.deep_age = a
    return op


def admit_third(reqs, admit_one):
    admit_one(2)


# name: (cache, requests, steps each, plan, eligibility the JAX tests pin)
CASES = {
    "dense": (cache_kwargs(), 2, 4, ["c4"], [True]),
    "compact_after_anchor": (cache_kwargs("compact"), 2, 5, ["s", "c4"],
                             [True]),
    "deep_from_boundary": (cache_kwargs("deep", interval=2), 2, 6,
                           ["s", "s", "c4"], [True]),
    "hybrid_from_boundary": (cache_kwargs("deep", interval=2, hybrid=0.5),
                             2, 6, ["s", "s", "c4"], [True]),
    "first_step_refuses_until_deep_seeded": (
        cache_kwargs("deep", interval=2), 2, 6, ["c2", "s", "s", "c2"],
        [False, True]),
    "off_boundary_refuses": (cache_kwargs("deep", interval=3), 2, 9,
                             ["s", "c3", "s", "s", "c3"], [False, True]),
    "adaptive_refuses": (cache_kwargs("deep", interval=2, adaptive=0.05), 2,
                         6, ["s", "s", "c2"], [False]),
    "predict_refuses": (cache_kwargs("deep", interval=2, predict=0.5), 2, 6,
                        ["s", "s", "c2"], [False]),
    "unanchored_compact_refuses": (cache_kwargs("compact"), 2, 4, ["c4"],
                                   [False]),
    "warmup_refuses": (cache_kwargs("deep", interval=2, warmup=4), 2, 8,
                       ["s", "s", "c2"], [False]),
    # tests/test_deep_partial.py:273-320
    "partial_chunk_matches_per_step": (
        partial_kwargs(), 2, 10, ["s", "s", set_ages(3, 1), "c4"], [True]),
    "partial_chunk_admission_mid_window": (
        partial_kwargs(), 2, 10, ["s", "s", admit_third, "c3"], [True]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_matches_jax_and_per_step(case, bundle):
    cache, n, steps, plan, want = CASES[case]
    jreqs, jgot = drive(jax_pipe(cache), True, n, steps, plan)
    preqs, pgot = drive(port_pipe(cache, bundle), False, n, steps, plan)
    assert jgot == pgot == want
    # the port's k per-step calls in place of its chunks
    per_step = ["p" + op[1:] if isinstance(op, str) and op[0] == "c"
                and ok else op for op, ok in zip(
                    plan, _chunk_flags(plan, pgot))]
    sreqs, _ = drive(port_pipe(cache, bundle), False, n, steps, per_step)
    for j, p, s in zip(jreqs, preqs, sreqs):
        assert p.remain_steps == j.remain_steps == s.remain_steps
        np.testing.assert_allclose(lat(p, False), lat(j, True), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lat(p, False), lat(s, False), rtol=RTOL,
                                   atol=ATOL)
        assert np.isfinite(lat(p, False)).all()
        if j.deep_state is not None:
            assert p.deep_age == j.deep_age == s.deep_age
            np.testing.assert_allclose(deep(p, False), deep(j, True),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(deep(p, False), deep(s, False),
                                       rtol=RTOL, atol=ATOL)


def _chunk_flags(plan, got):
    """Each op of ``plan`` with its chunk's eligibility (None otherwise)."""
    it = iter(got)
    return [next(it) if isinstance(op, str) and op[0] == "c" else None
            for op in plan]
