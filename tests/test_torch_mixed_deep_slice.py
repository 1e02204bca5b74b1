"""The port's deep cache on the mixed patch path against the JAX package's
(CPU, float32), through ``denoise_step_mixed``.

Tiny SD-1.5 pipelines with the same numpy weights
(``jax_to_torch_state_dict``), prompts and seeds run 2 x 128^2 + 64^2
requests at 64 px patches (patch grids 2, 2, 1: the composition of
tests/test_cache.py's 512^2 + 256^2 at 256 px patches) for 6 steps, one
patched step each, under:

- the deep x compact hybrid at fraction 0.5 and a fixed interval of 3
  (the 2 x 2 class recomputes one image pair of two on shallow steps);
- the same hybrid with the drift-adaptive refresh (threshold 0.05) and
  reuse-then-predict 0.5, knobs of the offline preset.

The two cases differ only in knobs the host reads at each step, so one
JAX pipeline serves both with the same two compiled step programs (JAX
compiles a tiny patched step in 3-6 s here).  The plain deep cache's
patched passes are held against JAX in tests/test_torch_mixed_deep_unet.py.

Each run's modes (a spy on each package's step) and final latents must
equal JAX's (RTOL 2e-4, ATOL 5e-4); before each step the JAX requests'
pending drift values are made ready, so that both packages decide on the
newest one.  The port's own invariants, as JAX's tests/test_cache.py
holds them: interval 1 equals the cache-off mixed path; the hybrid at
fraction 1 equals the plain mixed deep cache; a request whose batch moves
from the dense path to the patch path takes a full step; a new
composition's fresh entry anchors with a full step; a finish evicts the
mixed entry.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.models.loader import load_bundle
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
PATCH = 64
STEPS = 6
PLAN = [("r0", 128, 0), ("r1", 128, 1), ("rx", 64, 7)]
DEEP = dict(enabled=True, mode="deep", deep_boundary=1, deep_warmup=1)
PLAIN = dict(DEEP, deep_interval=3)
HYBRID = dict(PLAIN, deep_compact_fraction=0.5, deep_compact_pairwise=True)
CASES = {
    "hybrid": HYBRID,
    "adaptive-predict": dict(HYBRID, deep_adaptive=True,
                             deep_drift_threshold=0.05, deep_max_interval=30,
                             deep_predict=0.5),
}


def jax_pipeline(jbundle, cache: dict):
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, seed=3)
    config.scheduler.patch_size = PATCH
    config.cache = JaxCacheConfig(**cache)
    pipe = jax_build_pipeline(config, bundle=jbundle)
    modes, jit = [], pipe._jit

    def spy(name, fn, donate=()):  # the mixed step's program, every step
        if isinstance(name, tuple) and name[0] == "denoise_mixed":
            modes.append(name[2])
        return jit(name, fn, donate)

    pipe._jit = spy
    return pipe, modes


def port_pipeline(bundle, cache: dict):
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.patch_size = PATCH
    config.cache = CacheConfig(**cache)
    pipe = build_pipeline(config, "cpu", bundle=bundle)
    modes, step = [], pipe._deep_step_mixed

    def spy(mode, *args):
        modes.append(mode)
        return step(mode, *args)

    pipe._deep_step_mixed = spy
    return pipe, modes


def requests(request_cls, params_cls, plan=PLAN):
    return [request_cls(rid, params_cls(
        prompt=f"a prompt for {rid}", negative_prompt="blurry",
        resolution=res, num_inference_steps=STEPS, seed=seed))
        for rid, res, seed in plan]


def by_res(reqs) -> dict:
    out = {}
    for r in reqs:
        out.setdefault(r.resolution, []).append(r)
    return out


def drive(pipe, reqs, steps=STEPS, is_jax=False):
    if not is_jax:
        pipe.prepare(reqs)
    for _ in range(steps):
        if is_jax:
            for r in reqs:
                jax.block_until_ready(r.drift_pending)
        pipe.denoise_step_mixed(by_res(reqs))
    return [np.asarray(r.latents, np.float32) for r in reqs]


@pytest.fixture(scope="module")
def bundles():
    """A JAX hybrid pipeline on numpy-drawn weights (seed 3) with its mode
    spy, the port's bundle loaded from its weights, and JAX requests
    prepared once (text encoded, latents drawn), which each JAX run
    copies."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jbundle = load_bundle("sd15", tiny=True, seed=3)
    bundle = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in jbundle.params.items()})
    jpipe, jmodes = jax_pipeline(jbundle, HYBRID)
    prepared = requests(JaxRequest, JaxSamplingParams)
    jpipe.prepare(prepared)
    return (jpipe, jmodes), bundle, prepared


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_deep_equals_jax(bundles, case):
    (jpipe, jmodes), bundle, prepared = bundles
    jpipe.config.cache = JaxCacheConfig(**CASES[case])  # host-side knobs
    jpipe.release_serving_state()  # the same request ids: fresh rows
    del jmodes[:]
    want = drive(jpipe, copy.deepcopy(prepared), is_jax=True)
    pipe, modes = port_pipeline(bundle, CASES[case])
    got = drive(pipe, requests(Request, SamplingParams))
    assert modes == jmodes, (modes, jmodes)
    assert "full" in modes and "shallow" in modes
    for g, w, (rid, _, _) in zip(got, want, PLAN):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=rid)
    if case == "adaptive-predict":
        assert modes.count("full") > 1  # a drift refresh after warmup
    (key, entry), = pipe._comp_state.items()
    assert key[0] == "unet_hybrid_mixed" and entry["anchored"]
    assert key[2] == 4 and key[3] == ("rx", "r0", "r1")  # i_pad, ids
    rows = next(iter(entry["state"].values()))
    assert rows["hits"].shape[0] == 24  # the doubled patch bucket
    assert int(rows["hits"].max()) >= 1  # a row was reused


def port_latents(bundle, cache: dict, steps=STEPS):
    pipe, modes = port_pipeline(bundle, cache)
    return drive(pipe, requests(Request, SamplingParams), steps), modes, pipe


def test_interval_one_equals_cache_off(bundles):
    _, bundle, _ = bundles
    on, modes, _ = port_latents(bundle, dict(DEEP, deep_interval=1))
    off, _, _ = port_latents(bundle, {})
    assert modes == ["full"] * STEPS
    for a, b in zip(on, off):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_hybrid_fraction_one_equals_plain_deep(bundles):
    _, bundle, _ = bundles
    hybrid, hmodes, _ = port_latents(bundle, dict(
        HYBRID, deep_compact_fraction=1.0))
    plain, pmodes, _ = port_latents(bundle, PLAIN)
    assert hmodes == pmodes
    for a, b in zip(hybrid, plain):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_dense_to_patched_flip_forces_full(bundles):
    """Two 128^2 requests take dense deep steps; joined by a 64^2 request
    their batch turns mixed, and their dense deep features force a full
    step; then the patched features carry shallow steps."""
    _, bundle, _ = bundles
    pipe, modes = port_pipeline(bundle, PLAIN)
    reqs = requests(Request, SamplingParams)
    pipe.prepare(reqs)
    pipe.denoise_step({128: reqs[:2]})
    assert tuple(reqs[0].deep_state.shape[:1]) == (2,)
    pipe.denoise_step({128: reqs[:2]})  # a dense shallow step
    pipe.denoise_step({64: reqs[2:]})
    pipe.denoise_step({64: reqs[2:]})
    pipe.denoise_step_mixed(by_res(reqs))
    pipe.denoise_step_mixed(by_res(reqs))
    assert modes == ["full", "shallow"]
    assert reqs[0].deep_state.shape[0] == 2 * 4
    assert all(np.isfinite(r.latents.numpy()).all() for r in reqs)


def test_fresh_entry_anchors_and_finish_evicts(bundles):
    """A new composition's hybrid entry starts un-anchored, which forces a
    full step; once a member finishes the entry is evicted (mixed entries
    are never shrunk), and the survivors' next mixed step anchors a new
    one."""
    _, bundle, _ = bundles
    plan = PLAN + [("r3", 64, 3)]
    pipe, modes = port_pipeline(bundle, dict(HYBRID, deep_interval=12,
                                             deep_row_warmup=True))
    reqs = requests(Request, SamplingParams, plan)
    pipe.prepare(reqs)
    for _ in range(3):
        pipe.denoise_step_mixed(by_res(reqs))
    assert modes == ["full", "shallow", "shallow"]
    pipe.release_serving_state()
    pipe.denoise_step_mixed(by_res(reqs))
    assert modes[-1] == "full"
    (key, entry), = pipe._comp_state.items()
    assert key[0] == "unet_hybrid_mixed" and entry["anchored"]
    pipe.evict_finished_state(["r3"])
    assert not pipe._comp_state
    pipe.denoise_step_mixed(by_res(reqs[:3]))
    pipe.denoise_step_mixed(by_res(reqs[:3]))
    assert modes[-2:] == ["full", "shallow"]
    pipe.evict_finished_state(["r0"])
    assert not pipe._comp_state
