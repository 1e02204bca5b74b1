"""Spatial (displaced patch) parallelism in the port against the JAX
package on CPU.

- ``ShardContext``'s halo convolution (stride 1 and 2) and GroupNorm on a
  CPU ``ShardGroup`` of sp=4 against JAX's ``ShardContext`` under
  ``shard_map`` on ``make_mesh(sp=4)`` (JAX's 8 virtual CPU devices).
- ``DisplacedPatchRunner`` on the tiny SD-1.5 UNet (``ShardContext``) and
  the tiny MMDiT (``MMDiTShardContext``, K/V gathered): all-sync
  trajectories against JAX's runner and against the dense single-device
  trajectory, and displaced ones (stale K/V after one sync step) against
  JAX's displaced trajectory, step by step from the same K/V state; the
  runner threading the fine token gate's rows over the shards' tokens
  (each shard ranks its own): the same hits and latents as JAX's.
- The serving seam (``pipelines/base.py _denoise_group_displaced``) on the
  tiny SD-1.5 at sp=2, ``sp_mode="displaced"``, against JAX's engine on
  the same weights, requests and seeds: the per-composition state (warm
  counts, the K/V dicts per mode, composition keys), the reset at an
  admission, the plain deep cache's full/shallow cadence and the final
  latents.
- The port's ``test_engine_submesh_replicas``: sp=2 x tp=2 (mixed batches
  off) against JAX's sp=2 x tp=2 engine.
- A shard that raises fails the step at once and the group serves on.
- ``Engine(config, "cpu")`` over sp=2, tp=2, sp=2 x tp=2 and displaced
  sp=2 on the tiny SD-1.5, SDXL and SD3: the exact layouts within
  tolerance of the single device (SD-1.5's are held against JAX's
  sharded engines above).
Float32, RTOL 2e-4 / ATOL 5e-4.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.config import ParallelConfig as JaxParallelConfig
from sduss_tpu.engine.engine import Engine as JaxEngine
from sduss_tpu.models import layers as JL
from sduss_tpu.models import mmdit as jmmdit
from sduss_tpu.models import unet as junet
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.parallel import displaced as jdisp
from sduss_tpu.parallel.mesh import make_mesh
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu.samplers import get_sampler as jax_sampler
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.models import layers as TL
from sduss_tpu_torch.parallel import displaced as tdisp
from sduss_tpu_torch.parallel.group import ShardGroup
from sduss_tpu_torch.request import SamplingParams
from sduss_tpu_torch.samplers import get_sampler
from test_torch_dp import ATOL, RTOL, port_config
from test_torch_sd15_slice import port_bundle
from test_torch_slice import _np_init, torch_threads  # noqa: F401
from test_torch_tp import get, model_cache  # noqa: F401

SPEC = P(None, "sp", None, None)


def _jax_local(fn, n: int):
    return shard_map(fn, mesh=make_mesh(sp=n), in_specs=(P(), SPEC),
                     out_specs=SPEC)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_halo_matches_jax(stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 32, 8, 4)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((3, 3, 4, 6))).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    p = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    want = np.asarray(_jax_local(lambda p, x: jdisp.ShardContext().conv(
        p, x, lvl=0, stride=stride), 4)(p, jnp.asarray(x)))
    np.testing.assert_allclose(want, np.asarray(JL.conv2d(
        p, jnp.asarray(x), stride=stride)), rtol=RTOL, atol=ATOL)
    conv = torch.nn.Conv2d(4, 6, 3, stride=stride, padding=1)
    conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(bias)
    group = ShardGroup(["cpu"] * 4, sp=4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def local(rank):
        ctx = tdisp.ShardContext(group)
        with torch.no_grad():
            return ctx.conv(conv, tdisp.shard_rows(xt, group, "sp", 2, rank),
                            stride=stride)

    got = tdisp.gather_rows(group.run(local), group, 2, "cpu")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    group.close()


def test_group_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    scale, bias = (rng.standard_normal(8).astype(np.float32)
                   for _ in range(2))
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(_jax_local(lambda p, x: jdisp.ShardContext().group_norm(
        p, x, groups=4, eps=1e-5, act="silu", lvl=0), 4)(p, jnp.asarray(x)))
    norm = TL.GroupNorm(4, 8, 1e-5)
    norm.weight.data, norm.bias.data = (torch.from_numpy(scale),
                                        torch.from_numpy(bias))
    group = ShardGroup(["cpu"] * 4, sp=4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def local(rank):
        with torch.no_grad():
            return tdisp.ShardContext(group).group_norm(
                norm, tdisp.shard_rows(xt, group, "sp", 2, rank), act="silu")

    got = tdisp.gather_rows(group.run(local), group, 2, "cpu")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    group.close()


def _runners(model_cache, name: str, warmup: int, n: int):
    """(JAX trajectory fn, the port's, the port's dense one) of the tiny
    model ``name`` on ``n`` shards, from the same latents and text."""
    jm, p, tm = get(model_cache, name)
    rng = np.random.default_rng(0)
    sd3 = name == "sd3"
    c_lat = 4
    lat = rng.standard_normal((1, 16, 16, c_lat)).astype(np.float32)
    ehs = rng.standard_normal((2, 9 if sd3 else 7, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    sampler_name, guidance = ("flow_match", 4.5) if sd3 else ("euler", 5.0)

    def jmodel(params, x_in, t2, ctx):
        if sd3:
            return jm.apply(params, x_in, t2, jnp.asarray(ehs),
                            jnp.asarray(pooled), ctx=ctx)
        return jm.apply(params, x_in, t2, jnp.asarray(ehs), ctx=ctx)

    def tmodel(x_in, t2, ctx):
        e = torch.from_numpy(ehs)
        if sd3:
            return tm(x_in, t2, e, torch.from_numpy(pooled), ctx=ctx)
        return tm(x_in, t2, e, ctx=ctx)

    ctx_j = jdisp.MMDiTShardContext if sd3 else jdisp.ShardContext
    ctx_t = tdisp.MMDiTShardContext if sd3 else tdisp.ShardContext

    def run_jax(steps):
        s = jax_sampler(sampler_name)
        runner = jdisp.DisplacedPatchRunner(jmodel, make_mesh(sp=n), s,
                                            warmup_steps=warmup,
                                            ctx_cls=ctx_j)
        return np.asarray(runner.denoise(p, jnp.asarray(lat),
                                         s.make_table(steps), guidance))

    def run_port(steps):
        s = get_sampler(sampler_name)
        group = ShardGroup(["cpu"] * n, sp=n)
        runner = tdisp.DisplacedPatchRunner(tmodel, group, s,
                                            warmup_steps=warmup,
                                            ctx_cls=ctx_t)
        with torch.inference_mode():
            out = runner.denoise(torch.from_numpy(lat), s.make_table(steps),
                                 guidance)
        group.close()
        return out.numpy()

    def run_dense(steps):
        s = get_sampler(sampler_name)
        table = s.make_table(steps)
        x = torch.from_numpy(lat)
        with torch.inference_mode():
            for _ in range(steps):
                c0 = torch.full((1,), float(table.coeffs[table.step, 0]))
                c1 = torch.full((1,), float(table.coeffs[table.step, 1]))
                t2 = torch.full((2,), table.current_timestep())
                out = tmodel(s.scale_model_input(torch.cat([x, x]),
                                                 torch.cat([c0, c0])), t2,
                             None)
                u, c = out.chunk(2)
                x = s.step(x, u + guidance * (c - u), c0, c1)
                table.advance()
        return x.numpy()

    return run_jax, run_port, run_dense


@pytest.mark.parametrize("name,n", [("sd15", 4), ("sd3", 2)])
def test_sync_runner_matches_jax_and_dense(model_cache, name, n):
    run_jax, run_port, run_dense = _runners(model_cache, name, 10**9, n)
    got = run_port(3)
    np.testing.assert_allclose(got, run_jax(3), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, run_dense(3), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,n", [("sd15", 2), ("sd3", 2)])
def test_displaced_runner_matches_jax(model_cache, name, n):
    """One sync step, then stale steps: each displaced step splices this
    shard's fresh K/V into the previous step's, as JAX's does."""
    run_jax, run_port, run_dense = _runners(model_cache, name, 1, n)
    got = run_port(4)
    np.testing.assert_allclose(got, run_jax(4), rtol=RTOL, atol=ATOL)
    assert np.abs(got - run_dense(4)).max() > 0  # it really ran stale


# -- the serving seam ------------------------------------------------------

RES = 64


def _jax_engine(sp: int, tp: int = 1, mode: str = "displaced",
                warmup: int = 1, cache=None, buckets=None):
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, use_patched=False, seed=3)
    config.parallel = JaxParallelConfig(sp=sp, tp=tp, sp_mode=mode,
                                        displaced_warmup=warmup)
    config.scheduler.use_mixed_resolution = False
    if buckets:
        config.scheduler.batch_buckets = buckets
        config.scheduler.max_batch_size = max(buckets)
    if cache:
        config.cache.enabled = True
        for k, v in cache.items():
            setattr(config.cache, k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        return JaxEngine(config)


@pytest.fixture(scope="module")
def bundle():
    class _Pipe:
        engine = _jax_engine(1, mode="gspmd")
    return port_bundle(_Pipe)


def _port_engine(bundle, sp: int, tp: int = 1, mode: str = "displaced",
                 warmup: int = 1, cache=None, buckets=None):
    config = port_config(dp=1)
    config.parallel.sp, config.parallel.tp = sp, tp
    config.parallel.sp_mode, config.parallel.displaced_warmup = mode, warmup
    if buckets:
        config.scheduler.batch_buckets = buckets
        config.scheduler.max_batch_size = max(buckets)
    if cache:
        config.cache = CacheConfig(enabled=True, **cache)
    return Engine(config, "cpu", bundle=bundle)


def _drive(engine, params_cls, plan, snapshot):
    """Serve ``plan`` (``{step index: [(id, seed, steps)]}`` admissions),
    recording after every step each composition's state through
    ``snapshot``; returns (latents by id, snapshots)."""
    outs, snaps, i = {}, {}, 0
    while i <= max(plan) or engine.has_unfinished_requests():
        for rid, seed, steps in plan.get(i, []):
            engine.add_request(rid, params_cls(
                prompt=f"prompt {rid}", resolution=RES,
                num_inference_steps=steps, seed=seed, output_type="latent"))
        for o in engine.step():
            outs[o.request_id] = np.asarray(o.image)
        pipe = engine.workers[0].pipeline
        for e in list(getattr(pipe, "_disp_state", {}).values()):
            snaps[e["comp"]] = snapshot(e)
        i += 1
    assert not getattr(engine.workers[0].pipeline, "_disp_state", {})
    return outs, snaps


def _snap(e):
    return {"warm": e["warm"], "deep": e["deep"] is not None,
            "modes": sorted(str(m) for m, kv in e["kv"].items() if kv)}


@pytest.mark.parametrize("case", ["admission", "deep"])
def test_serving_seam_matches_jax(bundle, case):
    """An admission mid-flight starts its own composition (sync warmup
    again), keyed by composition so that the first one's state is never
    reset; the plain deep cache rides the seam with one K/V dict per mode
    (full steps always sync)."""
    if case == "admission":
        kw = dict(buckets=(1, 2))
        plan = {0: [("ra", 1, 6)], 3: [("rb", 2, 6)]}
    else:
        kw = dict(cache=dict(mode="deep", deep_interval=3, deep_warmup=1))
        plan = {0: [("d0", 9, 6)]}
    jout, jsnap = _drive(_jax_engine(2, **kw), JaxSamplingParams, plan,
                         _snap)
    engine = _port_engine(bundle, 2, **kw)
    tout, tsnap = _drive(engine, SamplingParams, plan, _snap)
    assert tsnap == jsnap
    steps = engine.workers[0].pipeline.displaced_steps
    assert steps["stale"] > 0 and steps["sync"] > 0
    if case == "deep":
        (entry,) = tsnap.values()
        assert entry["modes"] == ["full", "shallow"] and entry["deep"]
    else:
        # the first composition is never reset by the second's steps
        assert tsnap[("ra",)]["warm"] == 6 and tsnap[("rb",)]["warm"] >= 2
    for rid, want in jout.items():
        np.testing.assert_allclose(tout[rid], want, rtol=RTOL, atol=ATOL)


def test_engine_submesh_replicas(bundle):
    """A replica over sp=2 x tp=2 (four CPU shards), mixed batches off,
    against JAX's sp=2 x tp=2 engine and the port's single device."""
    plan = {0: [("s0", 7, 2), ("s1", 8, 2)]}
    jout, _ = _drive(_jax_engine(2, 2, mode="gspmd"), JaxSamplingParams,
                     plan, _snap)
    engine = _port_engine(bundle, 2, 2, mode="gspmd")
    pipe = engine.workers[0].pipeline
    assert (pipe.group.sp, pipe.group.tp, len(pipe.devices)) == (2, 2, 4)
    tout, _ = _drive(engine, SamplingParams, plan, _snap)
    one, _ = _drive(_port_engine(bundle, 1, mode="gspmd"), SamplingParams,
                    plan, _snap)
    assert pipe.displaced_steps == {"sync": 2, "stale": 0}
    for rid, want in jout.items():
        np.testing.assert_allclose(tout[rid], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tout[rid], one[rid], rtol=RTOL, atol=ATOL)


def test_a_shard_that_raises_fails_the_step(bundle, monkeypatch):
    engine = _port_engine(bundle, 2, mode="gspmd")
    pipe = engine.workers[0].pipeline
    shard = pipe.denoiser.shards[1]
    real = type(shard).forward

    def boom(self, *a, **kw):
        if self is shard:
            raise RuntimeError("shard 1 failed")
        return real(self, *a, **kw)

    monkeypatch.setattr(type(shard), "forward", boom)
    engine.add_request("x", SamplingParams(prompt="p", resolution=RES,
                                           num_inference_steps=2, seed=0,
                                           output_type="latent"))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        while engine.has_unfinished_requests():
            engine.step()
    assert time.perf_counter() - t0 < 10.0
    monkeypatch.setattr(type(shard), "forward", real)
    out = pipe.group.run(lambda r: pipe.group.psum(torch.ones(1) * r, "sp"))
    assert [float(o) for o in out] == [1.0, 1.0]


def _fine_runners(model_cache, fraction: float, warmup: int):
    """The tiny MMDiT's runner with the per-token fine gate threading its
    rows over the shards' tokens (JAX's ``_fine_setup``), JAX's and the
    port's: each returns ``(latents, cache rows)``."""
    from sduss_tpu.cache.manager import BlockCache as JaxCache
    from sduss_tpu.config import CacheConfig as JaxCacheConfig
    from sduss_tpu_torch.cache.manager import BlockCache

    jm, p, tm = get(model_cache, "sd3")
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ehs = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    kw = dict(enabled=True, mode="compact", patch_fraction=fraction,
              max_hits=2)
    jcache, tcache = JaxCache(JaxCacheConfig(**kw)), BlockCache(
        CacheConfig(**kw))
    seq, layers, dim = 64, jm.cfg.num_layers, jm.cfg.dim

    def run_jax(steps):
        s = jax_sampler("flow_match")
        state = {f"block{i}": jcache.init_token_rows_fine(
            f"block{i}", 2, seq, dim, jnp.float32) for i in range(layers)}

        def fn(params, x_in, t2, ctx, st):
            return jm.apply(params, x_in, t2, jnp.asarray(ehs),
                            jnp.asarray(pooled), ctx=ctx, cache=jcache,
                            cache_state=st)

        runner = jdisp.DisplacedPatchRunner(
            fn, make_mesh(sp=2), s, warmup_steps=warmup,
            ctx_cls=jdisp.MMDiTShardContext)
        out, st = runner.denoise(p, jnp.asarray(lat), s.make_table(steps),
                                 4.5, cache_state=state)
        return np.asarray(out), jax.tree.map(np.asarray, st)

    def run_port(steps):
        s = get_sampler("flow_match")
        state = {f"block{i}": tcache.init_token_rows_fine(
            f"block{i}", 2, seq, dim, torch.float32, "cpu")
            for i in range(layers)}

        def fn(x_in, t2, ctx, st):
            return tm(x_in, t2, torch.from_numpy(ehs),
                      torch.from_numpy(pooled), ctx=ctx, cache=tcache,
                      cache_state=st), st

        group = ShardGroup(["cpu"] * 2, sp=2)
        runner = tdisp.DisplacedPatchRunner(
            fn, group, s, warmup_steps=warmup,
            ctx_cls=tdisp.MMDiTShardContext)
        with torch.inference_mode():
            out, st = runner.denoise(torch.from_numpy(lat),
                                     s.make_table(steps), 4.5,
                                     cache_state=state)
        group.close()
        return out.numpy(), {k: {n: v.numpy() for n, v in d.items()}
                             for k, d in st.items()}

    return run_jax, run_port


@pytest.mark.parametrize("fraction,warmup", [(0.9999, 10**9), (0.5, 2)])
def test_runner_threads_the_fine_token_gate_like_jax(model_cache, fraction,
                                                     warmup):
    """The token cache's rows split over the shards' tokens: each shard's
    fine gate ranks its own tokens.  At a fraction of every token the
    sync trajectory is the uncached one and no hit is taken; at 0.5 under
    displaced steps the port selects JAX's tokens (the same hits) and
    its latents are JAX's."""
    run_jax, run_port = _fine_runners(model_cache, fraction, warmup)
    got, state = run_port(4)
    want, jstate = run_jax(4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key, rows in state.items():
        np.testing.assert_array_equal(rows["hits"], jstate[key]["hits"])
    if fraction > 0.99:
        plain = _runners(model_cache, "sd3", 10**9, 2)[1](4)
        np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
        assert max(int(r["hits"].max()) for r in state.values()) == 0
    else:
        hits = state["block1"]["hits"]
        assert hits.min() == 0 and hits.max() > 0


@pytest.fixture(scope="module")
def family_bundles():
    from sduss_tpu_torch.models.registry import ModelBundle

    out = {}
    for family in ("sd15", "sdxl", "sd3"):
        b = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
        b.init_random(0)
        out[family] = b
    return out


@pytest.mark.parametrize("family", ["sd15", "sdxl", "sd3"])
@pytest.mark.parametrize("layout", ["sp2", "tp2", "sp2tp2", "sp2-displaced"])
def test_engine_groups_serve_every_family(family_bundles, family, layout):
    """``Engine(config, "cpu")`` over each layout, mixed batches off, two
    64 px requests of 4 steps: the exact layouts within RTOL/ATOL of the
    single device's latents; displaced (one sync step, then stale) finite,
    with 1 sync and 3 stale steps."""
    from sduss_tpu_torch.entrypoints.offline import default_config

    def serve(sp, tp, mode="gspmd"):
        config = default_config(family, dtype="float32", test_tiny=True)
        config.scheduler.use_mixed_resolution = False
        config.parallel.sp, config.parallel.tp = sp, tp
        config.parallel.sp_mode, config.parallel.displaced_warmup = mode, 1
        if family == "sd3":
            config.model.resolutions = (64, 128)
        engine = Engine(config, "cpu", bundle=family_bundles[family])
        for i in range(2):
            engine.add_request(f"g{i}", SamplingParams(
                prompt=f"a cat {i}", resolution=RES, num_inference_steps=4,
                seed=i, output_type="latent"))
        outs = {}
        while engine.has_unfinished_requests():
            for o in engine.step():
                outs[o.request_id] = o.image
        return outs, engine.workers[0].pipeline

    one, _ = serve(1, 1)
    sp, tp = (2 if "sp2" in layout else 1), (2 if "tp2" in layout else 1)
    displaced = layout.endswith("displaced")
    got, pipe = serve(sp, tp, "displaced" if displaced else "gspmd")
    assert len(pipe.devices) == sp * tp
    for rid, want in one.items():
        assert np.isfinite(got[rid]).all()
        if not displaced:
            np.testing.assert_allclose(got[rid], want, rtol=RTOL, atol=ATOL)
    if displaced:
        assert pipe.displaced_steps == {"sync": 1, "stale": 3}
