"""The port's deep x compact hybrid gates against the JAX package's (CPU,
float32), and the Engine's cache gate.

``BlockCache.gate_compact_pairs`` and ``gate_compact`` take the same
seeded rows, state and block body in both packages (the port's rows NCHW,
JAX's NHWC) and must pick the same rows, in the same order, and give the
same outputs and new state: with every row fresh (every score ties at
``1e6 + rel - threshold``, the lowest index first), with batch-bucket pad
rows, with ``compact_predict`` 0.5 and with a synthetic classifier npz.
The UNet's hybrid forward (write-through on a full step, CFG-pair gating
on a shallow one, ``compact_predict`` off and on) is held against JAX's on
the 3-level tiny SDXL UNet.  Tolerance: RTOL 2e-4, ATOL 5e-4; indices and
hit counts exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.cache.manager import BlockCache as JaxBlockCache
from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.models import unet as junet
from sduss_tpu_torch.cache.manager import BlockCache, top_k_stable
from sduss_tpu_torch.config import CacheConfig, Config
from sduss_tpu_torch.engine.engine import check_supported
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from test_torch_deep_unet import ATOL, RTOL, make_inputs, nchw, torch_inputs
from test_torch_models import np_params
from test_torch_slice import torch_threads  # noqa: F401

MAX_HITS = 4
R, C_IN, C_OUT, S = 8, 6, 5, 4  # rows (4 CFG pairs), channels, side


def nhwc(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 3, 1)


def caches(**kw):
    return (BlockCache(CacheConfig(max_hits=MAX_HITS, **kw)),
            JaxBlockCache(JaxCacheConfig(max_hits=MAX_HITS, **kw)))


def make_case(seed: int, fresh: bool, predict: bool):
    """Rows, a per-row timestep, a cached state (NCHW numpy) and the
    block's weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, C_IN, S, S)).astype(np.float32)
    state = {
        "inp": (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32),
        "out": rng.standard_normal((R, C_OUT, S, S)).astype(np.float32),
        "hits": (np.full((R,), MAX_HITS, np.int32) if fresh else
                 rng.integers(0, MAX_HITS, R).astype(np.int32)),
    }
    if fresh:
        state["inp"][:] = 0.0
        state["out"][:] = 0.0
    if predict:
        state["slope"] = (0.1 * rng.standard_normal(
            state["out"].shape)).astype(np.float32)
        state["seen"] = rng.integers(0, 2, R).astype(bool)
        if fresh:
            state["slope"][:] = 0.0
            state["seen"][:] = False
    w = rng.standard_normal((C_IN, C_OUT)).astype(np.float32)
    side = rng.standard_normal((R,)).astype(np.float32)
    t_norm = rng.uniform(0, 1, R).astype(np.float32)
    return x, state, w, side, t_norm


def port_body(w, side):
    def fn(x_c, idx):
        return torch.tanh(torch.einsum("nchw,cd->ndhw", x_c,
                                       torch.from_numpy(w))) \
            + torch.from_numpy(side)[idx].reshape(-1, 1, 1, 1)
    return fn


def jax_body(w, side):
    def fn(x_c, idx):
        return jnp.tanh(x_c @ w) + jnp.asarray(side)[idx].reshape(-1, 1, 1, 1)
    return fn


def run_gate(pairs: bool, case, kw, row_valid=None):
    """The same gate in both packages; returns (port, jax) results as
    (idx, y, new state), JAX's transposed to NCHW."""
    x, state, w, side, t_norm = case
    port, ref = caches(**kw)
    pstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    jstate = {k: (jnp.asarray(nhwc(v)) if v.ndim == 4 else jnp.asarray(v))
              for k, v in state.items()}
    prv = None if row_valid is None else torch.from_numpy(row_valid)
    jrv = None if row_valid is None else jnp.asarray(row_valid)
    if pairs:
        py, pst, pstats = port.gate_compact_pairs(
            "down0.0", torch.from_numpy(x), torch.from_numpy(t_norm), pstate,
            port_body(w, side), 2, row_valid=prv)
        jy, jst, jstats = ref.gate_compact_pairs(
            "down0.0", jnp.asarray(nhwc(x)), jnp.asarray(t_norm), jstate,
            jax_body(w, side), 2, row_valid=jrv)
    else:
        py, pst, pstats = port.gate_compact(
            "down0.0", torch.from_numpy(x), torch.from_numpy(t_norm), pstate,
            port_body(w, side), 3, row_valid=prv)
        jy, jst, jstats = ref.gate_compact(
            "down0.0", jnp.asarray(nhwc(x)), jnp.asarray(t_norm), jstate,
            jax_body(w, side), 3, row_valid=jrv)
    assert pst is pstate  # updated in place
    jst = {k: (nchw(v) if v.ndim == 4 else np.asarray(v))
           for k, v in jst.items()}
    return ((pstats["idx"].numpy(), py.numpy(),
             {k: v.numpy() for k, v in pst.items()}),
            (np.asarray(jstats["idx"]), nchw(jy), jst))


def assert_same(port, ref):
    (pidx, py, pst), (jidx, jy, jst) = port, ref
    np.testing.assert_array_equal(pidx, jidx)
    np.testing.assert_allclose(py, jy, rtol=RTOL, atol=ATOL)
    assert set(pst) == set(jst)
    for k in pst:
        if pst[k].dtype in (np.int32, bool):
            np.testing.assert_array_equal(pst[k], jst[k])
        else:
            np.testing.assert_allclose(pst[k], jst[k], rtol=RTOL, atol=ATOL)


PAD = np.asarray([True, True, True, False] * 2)  # one pad request


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "rows"])
@pytest.mark.parametrize("fresh,row_valid,predict", [
    (True, None, False),    # every row forced: the tie case
    (True, PAD, False),     # ties with a pad request
    (False, None, False),
    (False, PAD, False),
    (False, None, True),    # compact_predict 0.5
    (True, PAD, True),
], ids=["fresh", "fresh-pad", "drift", "drift-pad", "predict",
        "fresh-pad-predict"])
def test_gates_equal_jax(pairs, fresh, row_valid, predict):
    case = make_case(3, fresh, predict)
    kw = {"compact_predict": 0.5} if predict else {}
    port, ref = run_gate(pairs, case, kw, row_valid)
    assert_same(port, ref)
    if fresh:  # ties: the lowest indices, pad rows never
        valid = np.ones(R, bool) if row_valid is None else row_valid
        want = (np.arange(R // 2)[valid[:R // 2]][:2] if pairs
                else np.arange(R)[valid][:3])
        got = port[0][:2] if pairs else port[0]
        np.testing.assert_array_equal(got, want)


def test_top_k_stable_orders_ties_by_index():
    scores = torch.tensor([1.0, 3.0, 3.0, -torch.inf, 3.0, 2.0])
    assert top_k_stable(scores, 4).tolist() == [1, 2, 4, 5]
    big = torch.tensor([1e6 + 0.01, 1e6 + 0.02, 1e6, 1e6 + 0.03])
    assert top_k_stable(big, 2).tolist() == [0, 1]  # a 0.0625 ulp: all tie


def test_classifier_npz_scores_equal_jax(tmp_path):
    path = str(tmp_path / "clf.npz")
    np.savez(path, **{"down0.0": np.asarray([8.0, -1.5, 0.4, -0.2],
                                            np.float32)})
    case = make_case(5, False, False)
    port, ref = caches(classifier_path=path)
    assert set(port.classifiers) == {"down0.0"}
    x, state, _, _, t_norm = case
    pscore = port._scores("down0.0", torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in state.items()},
                          torch.from_numpy(t_norm))
    jscore = ref._scores("down0.0", jnp.asarray(nhwc(x)),
                         {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v)
                          for k, v in state.items()}, jnp.asarray(t_norm))
    np.testing.assert_allclose(pscore.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=1e-6)
    assert_same(*run_gate(True, case, {"classifier_path": path}))


@pytest.fixture(scope="module")
def sdxl3():
    jmodel = junet.UNet2DConditionModel(junet.TINY3_SDXL_UNET)
    params = np_params(jmodel.init, 6)
    port = tunet.UNet2DConditionModel(tunet.TINY3_SDXL_UNET)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          jax_to_torch_state_dict("unet", params).items()},
                         strict=True)
    return jmodel, params, port.eval(), make_inputs(junet.TINY3_SDXL_UNET, 2)


@pytest.mark.parametrize("predict", [0.0, 0.5], ids=["reuse", "predict"])
def test_hybrid_unet_forward_equals_jax(sdxl3, predict):
    """A full step writes every gated pair through, then a shallow step
    gates them by CFG pairs (1 of 4 pairs at fraction 0.3, one pad
    request); outputs, deep features and row state equal JAX's."""
    jmodel, params, port, inp = sdxl3
    kw = dict(deep_compact_fraction=0.3, deep_compact_pairwise=True,
              deep_boundary=1, compact_predict=predict)
    pcache, jcache = (BlockCache(CacheConfig(**kw)),
                      JaxBlockCache(JaxCacheConfig(**kw)))
    layout = port.shallow_cache_layout(16, 1)
    assert layout == jmodel.shallow_cache_layout(16, 1)
    pstate = {k: pcache.init_rows(k, 8, s, ci, co, torch.float32)
              for k, (s, ci, co) in layout.items()}
    jstate = {k: jcache.init_rows(k, 8, s, ci, co, jnp.float32)
              for k, (s, ci, co) in layout.items()}
    rv = np.asarray([True, True, True, False] * 2)
    ti = torch_inputs(inp)
    jin = jax.tree.map(jnp.asarray, inp)

    def jrun(mode, deep, state, sample):
        return jax.jit(lambda p, i, d, s, r: jmodel.apply(
            p, i["sample"], i["t"], i["ehs"], added_cond=i["added"],
            cache=jcache, cache_state=s, deep_mode=mode, deep_state=d,
            deep_boundary=1, row_valid=r))(params, dict(jin, sample=sample),
                                           deep, state, jnp.asarray(rv))

    jout, jfeat, jstate = jrun("full", None, jstate, jin["sample"])
    with torch.inference_mode():
        pout, pfeat, pst = port(ti["sample"], ti["t"], ti["ehs"],
                                added_cond=ti["added"], cache=pcache,
                                cache_state=pstate, deep_mode="full",
                                deep_boundary=1,
                                row_valid=torch.from_numpy(rv))
    assert pst is pstate
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    # the next step: the latents moved a little
    nxt = inp["sample"] + 0.05 * np.random.default_rng(9).standard_normal(
        inp["sample"].shape).astype(np.float32)
    jout2, _, jstate2 = jrun("shallow", jfeat, jstate, jnp.asarray(nxt))
    with torch.inference_mode():
        pout2, _, pst2 = port(torch.from_numpy(nxt), ti["t"], ti["ehs"],
                              added_cond=ti["added"], cache=pcache,
                              cache_state=pstate, deep_mode="shallow",
                              deep_state=pfeat, deep_boundary=1,
                              row_valid=torch.from_numpy(rv))
    np.testing.assert_allclose(pout2.numpy(), np.asarray(jout2), rtol=RTOL,
                               atol=ATOL)
    assert set(pst2) == set(jstate2) == set(layout)
    for key in layout:
        assert set(pst2[key]) == set(jstate2[key])
        for leaf, v in pst2[key].items():
            want = np.asarray(jstate2[key][leaf])
            if v.dim() == 4:
                np.testing.assert_allclose(v.numpy(), nchw(want), rtol=RTOL,
                                           atol=ATOL)
            else:
                np.testing.assert_array_equal(v.numpy(), want)
        # 1 of 4 pairs recomputed, the pad request never
        hits = pst2[key]["hits"].numpy()
        assert (hits == 0).sum() == 2 and hits[3] == hits[7] == 1


@pytest.mark.parametrize("family,serving,mixed", [
    pytest.param(family, serving, mixed,
                 id=f"{family}-{serving}" + ("-mixed" if mixed else ""))
    for family in ("sd15", "sdxl") for serving in (True, False)
    for mixed in (False, True)])
def test_engine_accepts_the_production_presets(family, serving, mixed):
    """Each preset serves through ``generate``, which leaves no request's
    cache state behind.  With mixed batches on (the default scheduler) a
    64^2 and a 128^2 request at 64 px patches form one mixed batch a step,
    which runs the patched deep path: at least one full and one shallow
    step; with them off, one dense deep step a resolution."""
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = mixed
    config.scheduler.patch_size = 64
    config.cache = CacheConfig.production(family, serving=serving)
    pipe = DiffusionPipeline(config=config, device="cpu")
    inner = pipe.engine.workers[0].pipeline
    assert inner._deep_cache_active()
    modes, step = [], inner._deep_step_mixed
    inner._deep_step_mixed = lambda mode, *a: (modes.append(mode),
                                               step(mode, *a))[1]
    resolution = [64, 128] if mixed else 64
    outs = pipe.generate(["a cat", "a dog"], resolution=resolution,
                         num_inference_steps=4, seed=0)
    assert all(o.finished and o.image.std() > 0 for o in outs)
    assert not inner._comp_state and not inner._deep_carry
    if mixed:  # four steps, each one mixed batch on the patch path
        assert len(modes) == 4 and "full" in modes and "shallow" in modes
    else:
        assert not modes


def _refused(family="sdxl", **changes) -> Config:
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.cache = CacheConfig.production(
        "sd3" if family == "sd3" else family, serving=False)
    for dotted, value in changes.items():
        section, field = dotted.split("__")
        setattr(getattr(config, section), field, value)
    return config


@pytest.mark.parametrize("config,item", [
    # fused multi-step dispatch is served (item None), SD3's span within
    # the tiny MMDiT's 2 blocks
    (_refused("sd3", scheduler__steps_per_dispatch=4,
              cache__sd3_deep_span=(1, 2)), None),
    # dp replicas are served, and so is sp above 1 with SD3's span cache,
    # with the mixed-resolution paths and with a gated cache
    (_refused("sd3", parallel__dp=2, cache__sd3_deep_span=(1, 2)), None),
    (_refused("sd3", parallel__sp=2, cache__sd3_deep_span=(1, 2)), None),
    # the UNet families' modes "block" and "compact" are served (item None)
    (_refused(cache__mode="block"), None),
    (_refused(cache__mode="compact"), None),
    (_refused(scheduler__steps_per_dispatch=4), None),
    # a replica over an sp x tp group (item 10): tp with the production
    # preset, sp with the plain fixed-interval deep cache; pp is not routed
    (_refused(parallel__tp=2), None),
    (_refused(parallel__sp=2, cache__deep_adaptive=False,
              cache__deep_predict=0.0, cache__deep_compact_fraction=None),
     None),
    (_refused(parallel__sp=2), None),
    (_refused(parallel__sp=2, scheduler__use_mixed_resolution=True,
              cache__enabled=False), None),
    (_refused(parallel__pp=2), "MMDiTStagePipeline"),
], ids=["sd3", "sd3-span", "sd3-sp", "block", "compact", "multi-step",
        "tp", "sp-plain-deep", "sp-gated", "sp-mixed", "pp"])
def test_engine_refuses_what_is_not_ported(config, item):
    """What is not ported raises, naming its ROADMAP item; what is (item
    None) builds and serves one step of finite latents."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            check_supported(config)
        return
    check_supported(config)
    pipe = DiffusionPipeline(config=config, device="cpu")
    out, = pipe.generate(["a cat"], resolution=64, num_inference_steps=1,
                         seed=0, output_type="latent")
    assert out.finished and np.isfinite(out.image).all()
