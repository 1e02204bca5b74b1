"""The port's SD3 span-skip deep cache against the JAX package, on the CPU
in float32.

Module parity: the tiny MMDiT (2 blocks, block 0 dual) in ``deep_mode``
full and shallow at spans (0, 1) (interior: the delta carries the context
``c``), (1, 2) (``hi == num_layers``: spliced before the head) and (0, 2),
through ``apply_tokens`` (16 + 64 latent tokens padded to 64, and a
padded row; compared on the real tokens) and the dense ``forward``,
against JAX ``apply_tokens``/``apply`` run eagerly on the same weights
(``models/convert.py``).  RTOL 2e-4 / ATOL 5e-4.  Bad spans raise.

Slice parity: the tiny SD3 pipeline of both packages with the same
weights, prompts and seeds, driven step by step through
``denoise_step`` (with the span cache on, every batch takes the token
path) under span (1, 2) at interval 3, warmup 0 and 1, with
``deep_predict`` 0.5, across a composition change (a request leaves
after 4 steps: the reset costs one full step, and its entry is
evicted) and on a mixed 64 + 128 px batch.  The realized mode of every
step must equal the mode of the JAX trunk program that ran it, and the
final latents must agree within 1e-3 of their scale.

Engine: both ``CacheConfig.production("sd3")`` presets build and serve
through the port's ``Engine`` on the CPU; the composition store holds no
entry once a request finished or was aborted, and the pipeline's live
state bytes count its entries.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.entrypoints.offline import DiffusionPipeline as JaxPipeline
from sduss_tpu.models import mmdit as jmmdit
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine, check_supported
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models import mmdit as tmmdit
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams

from test_torch_models import np_params
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
LATENT_RTOL = 1e-3
CFG = jmmdit.TINY_MMDIT


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def mmdit():
    p = np_params(jmmdit.SD3Transformer2DModel(CFG).init, 0)
    model = tmmdit.SD3Transformer2DModel(tmmdit.TINY_MMDIT)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_to_torch_state_dict("transformer", p).items()},
                          strict=True)
    return p, model.eval(), jmmdit.SD3Transformer2DModel(CFG)


@pytest.fixture(scope="module")
def token_batch(mmdit):
    """16 + 64 latent tokens padded to 64, plus the bucket's padded row
    (a copy of row 1), with timesteps and text features."""
    p, _, jm = mmdit
    rng = np.random.default_rng(2)
    lats = [rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((1, 16, 16, 4)).astype(np.float32)]
    lens = [16, 64]
    tokens = np.zeros((3, 64, CFG.dim), np.float32)
    for i, x in enumerate(lats):
        tk = np.asarray(jm.embed_latents(p, jnp.asarray(x)))
        tokens[i, :tk.shape[1]] = tk[0]
    tokens[2] = tokens[1]
    mask = np.zeros((3, 64), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return dict(tokens=tokens, mask=mask, lens=lens,
                t=np.asarray([900.0, 250.0, 250.0], np.float32),
                ehs=rng.standard_normal((3, 12, CFG.joint_attention_dim)
                                        ).astype(np.float32),
                pooled=rng.standard_normal((3, CFG.pooled_projection_dim)
                                           ).astype(np.float32))


def _args(batch, torch_side: bool):
    keys = ("tokens", "mask", "t", "ehs", "pooled")
    if torch_side:
        return [torch.from_numpy(batch[k]) for k in keys]
    return [jnp.asarray(batch[k]) for k in keys]


def _close_real(port, ref, lens):
    for i, n in enumerate(lens):
        _close(port[i, :n], np.asarray(ref)[i, :n])


@pytest.mark.parametrize("span", [(0, 1), (1, 2), (0, 2)])
def test_span_tokens_equal_jax(mmdit, token_batch, span):
    p, model, jm = mmdit
    lens = token_batch["lens"]
    jout, jdeep = jm.apply_tokens(p, *_args(token_batch, False),
                                  deep_mode="full", deep_span=span)
    jsh, jpass = jm.apply_tokens(p, *_args(token_batch, False),
                                 deep_mode="shallow", deep_span=span,
                                 deep_state=jdeep)
    with torch.no_grad():
        plain = model.apply_tokens(*_args(token_batch, True))
        out, deep = model.apply_tokens(*_args(token_batch, True),
                                       deep_mode="full", deep_span=span)
        sh, passed = model.apply_tokens(*_args(token_batch, True),
                                        deep_mode="shallow", deep_span=span,
                                        deep_state=deep)
    assert set(deep) == set(jdeep) == (
        {"dx", "c"} if span[1] < CFG.num_layers else {"dx"})
    assert passed is deep
    assert torch.equal(out, plain)   # the full pass is the plain forward
    _close_real(out, jout, lens)
    _close_real(deep["dx"], jdeep["dx"], lens)
    if "c" in deep:
        _close(deep["c"], jdeep["c"])
    _close_real(sh, jsh, lens)


@pytest.mark.parametrize("span", [(0, 1), (1, 2)])
def test_span_dense_forward_equals_jax(mmdit, span):
    p, model, jm = mmdit
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([800.0, 40.0], np.float32)
    ehs = rng.standard_normal((2, 12, CFG.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, CFG.pooled_projection_dim)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (lat, t, ehs, pooled)]
    targs = [torch.from_numpy(a) for a in (lat, t, ehs, pooled)]
    jout, jdeep = jm.apply(p, *jargs, deep_mode="full", deep_span=span)
    jsh, _ = jm.apply(p, *jargs, deep_mode="shallow", deep_span=span,
                      deep_state=jdeep)
    with torch.no_grad():
        out, deep = model(*targs, deep_mode="full", deep_span=span)
        sh, _ = model(*targs, deep_mode="shallow", deep_span=span,
                      deep_state=deep)
    assert out.shape == lat.shape
    _close(out, jout)
    _close(sh, jsh)


@pytest.mark.parametrize("span,mode,msg", [
    ((1, 3), "full", "out of range"),
    ((1, 1), "full", "out of range"),
    ((-1, 1), "full", "out of range"),
    ((0, 1), "shallow", "needs deep_state"),
])
def test_span_validation_raises(mmdit, token_batch, span, mode, msg):
    with pytest.raises(ValueError, match=msg), torch.no_grad():
        mmdit[1].apply_tokens(*_args(token_batch, True), deep_mode=mode,
                              deep_span=span)


# -- the slice: both pipelines step by step -----------------------------------

PROMPTS = ["a red cat on a mat", "a lighthouse at dusk", "a bowl of fruit"]
STEPS = 8


@pytest.fixture(scope="module")
def both():
    """The JAX tiny SD3 pipeline (numpy weights) and the port's, carrying
    the same weights; a spy records the deep mode of every JAX trunk
    program that runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jtop = JaxPipeline("sd3", dtype="float32", test_tiny=True,
                           use_patched=False, seed=3)
    jpipe = jtop.engine.workers[0].pipeline
    params = jpipe.bundle.params
    bundle = ModelBundle("sd3", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in params.items()})
    modes, jit = [], jpipe._jit

    def spy(name, fn, donate=()):
        if isinstance(name, tuple) and name[0] == "sd3_mixed":
            modes.append(name[6])
        return jit(name, fn, donate)

    jpipe._jit = spy
    return jpipe, modes, bundle, {}


# sequence buckets of 16 and 64 tokens: a 64 px batch pads to 16, not to
# the default resolutions' 1024
MODEL_RESOLUTIONS = (64, 128)


def run_slice(both, cache: dict, resolutions, drop_after=None,
              trunk_calls=None):
    """Drive both pipelines through ``STEPS`` steps of ``resolutions``
    (one request each) under ``cache``; with ``drop_after`` the last
    request leaves after that many steps (its entries evicted).  Returns
    the port's modes, the JAX modes, both sets of final latents and the
    port pipeline; ``trunk_calls["port"]`` gets the cache arguments of
    every port trunk call."""
    jpipe, jmodes, bundle, last = both
    jmodes.clear()
    config = default_config("sd3", dtype="float32", test_tiny=True,
                            resolutions=MODEL_RESOLUTIONS)
    config.cache = CacheConfig(**cache)
    tpipe = build_pipeline(config, "cpu", bundle=bundle)
    tmodes, trunk = [], tpipe._trunk_fn
    calls = [] if trunk_calls is None else trunk_calls.setdefault("port", [])

    def spy(*args, **kw):
        tmodes.append(kw.get("deep_mode"))
        calls.append({k: kw.get(k, False)
                      for k in ("compact_sync", "fine_kv_stale")}
                     | {"deep_mode": kw.get("deep_mode")})
        return trunk(*args, **kw)

    tpipe._trunk_fn = spy
    saved = (jpipe.config.cache, jpipe.config.model)
    jpipe.config.cache = JaxCacheConfig(**cache)
    jpipe.config.model = dataclasses.replace(saved[1],
                                             resolutions=MODEL_RESOLUTIONS)
    # a fresh composition store and gate object, and no trunk program of
    # another cache configuration (the JAX trunk key holds no cache mode;
    # the schedule knobs change no program)
    for attr in ("_sd3_state", "_sd3_cache_obj"):
        jpipe.__dict__.pop(attr, None)
    sig = {k: v for k, v in cache.items()
           if k not in ("deep_interval", "deep_warmup", "deep_predict")}
    if last.get("sig") != sig:
        for key in [k for k in jpipe._fns if k[0] == "sd3_mixed"]:
            del jpipe._fns[key]
        last["sig"] = sig
    try:
        outs = []
        for req_cls, params_cls, pipe in (
                (JaxRequest, JaxSamplingParams, jpipe),
                (Request, SamplingParams, tpipe)):
            reqs = [req_cls(f"r{i}", params_cls(
                prompt=PROMPTS[i], negative_prompt="blurry", resolution=res,
                num_inference_steps=STEPS, seed=11 + i))
                for i, res in enumerate(resolutions)]
            pipe.prepare(reqs)
            live = list(reqs)
            for step in range(STEPS):
                if drop_after is not None and step == drop_after:
                    pipe.evict_finished_state([live[-1].request_id])
                    live = live[:-1]
                by_res = {}
                for r in live:
                    by_res.setdefault(r.resolution, []).append(r)
                pipe.denoise_step(by_res)
            outs.append([np.asarray(r.latents[0], np.float32) for r in reqs])
    finally:
        jpipe.config.cache, jpipe.config.model = saved
    return tmodes, list(jmodes), outs[1], outs[0], tpipe


def _latents_close(port, ref):
    for p_, j in zip(port, ref):
        assert np.isfinite(p_).all()
        err = np.abs(p_ - j).max()
        assert err <= LATENT_RTOL * np.abs(j).max(), err


SPAN = dict(enabled=True, mode="deep", sd3_deep_span=(1, 2), deep_interval=3)


@pytest.mark.parametrize("warmup,predict", [(0, 0.0), (1, 0.0), (1, 0.5)],
                         ids=["warmup0", "warmup1", "predict0.5"])
def test_span_slice_equals_jax(both, warmup, predict):
    cache = dict(SPAN, deep_warmup=warmup, deep_predict=predict)
    tmodes, jmodes, lat, jlat, tpipe = run_slice(both, cache, [64, 64])
    assert tmodes == jmodes, (tmodes, jmodes)
    # interval 3: each full step's delta serves the next two steps
    assert tmodes == ["full", "shallow", "shallow"] * 2 + ["full", "shallow"]
    _latents_close(lat, jlat)
    (entry,) = tpipe._sd3_state.values()
    assert entry["state"] is None and set(entry["deep"]) == {"dx"}
    assert (entry["deep_slope"] is not None) == bool(predict)


def test_span_composition_change_equals_jax(both):
    """Three requests, the last leaving after 4 steps: the new composition
    has no delta, so its first step is full although no interval expired;
    the leaver's entry is evicted."""
    cache = dict(SPAN, deep_interval=8, deep_warmup=1)
    tmodes, jmodes, lat, jlat, tpipe = run_slice(both, cache, [64, 64, 64],
                                                 drop_after=4)
    assert tmodes == jmodes, (tmodes, jmodes)
    assert tmodes == ["full", "shallow", "shallow", "shallow", "full",
                      "shallow", "shallow", "shallow"]
    _latents_close(lat, jlat)
    assert [k[2] for k in tpipe._sd3_state] == [("r0", "r1")]


def test_span_mixed_resolutions_equal_jax(both):
    cache = dict(SPAN, deep_warmup=1)
    tmodes, jmodes, lat, jlat, _ = run_slice(both, cache, [64, 128])
    assert tmodes == jmodes, (tmodes, jmodes)
    assert "shallow" in tmodes
    _latents_close(lat, jlat)


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sd3_bundle():
    bundle = ModelBundle("sd3", tiny=True, dtype=torch.float32, device="cpu")
    bundle.init_random(seed=0)
    return bundle


def _engine(bundle, cache: CacheConfig) -> Engine:
    config = default_config("sd3", dtype="float32", test_tiny=True,
                            resolutions=MODEL_RESOLUTIONS)
    config.engine.async_prepare = False
    config.engine.async_postprocess = False
    config.cache = cache
    check_supported(config)
    return Engine(config, "cpu", bundle=bundle)


@pytest.mark.parametrize("serving", [True, False], ids=["serving", "offline"])
def test_engine_serves_the_sd3_presets(sd3_bundle, serving):
    """Each preset, with its span cut to the tiny model's two blocks:
    three warmup steps full, then shallow ones; the entry's bytes count in
    the live state while the batch runs, and none is left after it."""
    cache = CacheConfig.production("sd3", serving=serving)
    assert cache.sd3_deep_span == (1, 24) and cache.deep_warmup == 3
    assert cache.deep_interval == (16 if serving else 30)
    engine = _engine(sd3_bundle, dataclasses.replace(cache,
                                                     sd3_deep_span=(1, 2)))
    pipe = engine.workers[0].pipeline
    modes, trunk = [], pipe._trunk_fn

    def spy(*args, **kw):
        modes.append(kw["deep_mode"])
        return trunk(*args, **kw)

    pipe._trunk_fn = spy
    for i in range(2):
        engine.add_request(f"p{i}", SamplingParams(
            prompt=f"prompt {i}", resolution=64, num_inference_steps=6,
            seed=i, output_type="latent"))
    outs, sizes = [], set()
    while engine.has_unfinished_requests():
        outs += engine.step()
        sizes.add(pipe._live_state_bytes())
    assert modes == ["full"] * 3 + ["shallow"] * 3
    assert len(outs) == 2
    assert all(o.finished and np.isfinite(o.image).all() for o in outs)
    # the delta: 2 requests x CFG rows of 16 tokens at the tiny width
    assert 2 * 2 * 16 * CFG.dim * 4 in sizes
    assert not pipe._sd3_state and pipe._live_state_bytes() == 0


def test_engine_evicts_on_abort(sd3_bundle):
    engine = _engine(sd3_bundle, dataclasses.replace(
        CacheConfig.production("sd3"), sd3_deep_span=(0, 1)))
    pipe = engine.workers[0].pipeline
    engine.add_request("a0", SamplingParams(prompt="x", resolution=64,
                                            num_inference_steps=8, seed=0))
    engine.add_request("a1", SamplingParams(prompt="y", resolution=64,
                                            num_inference_steps=8, seed=1))
    while not pipe._sd3_state:
        engine.step()
    (key,) = pipe._sd3_state
    assert key[2] == ("a0", "a1") and pipe._live_state_bytes() > 0
    engine.abort_requests(["a1"])
    assert not pipe._sd3_state
    while engine.has_unfinished_requests():
        engine.step()
    assert not pipe._sd3_state
