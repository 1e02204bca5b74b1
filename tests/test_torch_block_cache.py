"""The port's block and compact caches against the JAX package's (CPU,
float32): the gated UNet forward in each regime, the gates' selections,
``cache_layout``, the patch context's row-wise cross-attention, and the
invariants tests/test_cache.py holds the JAX package to.

- ``cache_layout`` equals JAX's for SD-1.5 and SDXL at 16 and 128 cells,
  ``min_level`` 0, 1 and 2.
- ``PatchContext.cross_attention(rows=)`` equals JAX's on the same
  weights (kernel K5's plain version here).
- ``gate_compact`` (dense rows, a pad row, the sync capacity) and the
  two-level ``gate_compact_images`` (non-even sub-composition,
  ``patch_fraction`` 0.5, class pad slots, capacity past a class's real
  images) take the same seeded rows, state and body in both packages (the
  port's rows NCHW, JAX's NHWC): the same selections (``idx``;
  ``gather``, ``images`` and ``tok_sel``), and the same output and state
  within RTOL 2e-4 / ATOL 5e-4, hits exactly.
- The tiny SD-1.5 UNet forward with a cache and no deep mode, two steps
  from fresh rows, in each regime: "block" on a patch batch, "compact" on
  dense rows (the sync step, then a gated one), "compact" on a patch batch
  at ``patch_fraction`` 1.0 and 0.5.  Each gate call's selection equals
  JAX's (the jitted JAX forward returns its gates' stats);
  outputs and rows within the tolerance above.
- Invariants, on the port alone: a threshold of -1 equals cache-off, full
  reuse diverges and stays finite, the hits counter forces a refresh at
  ``max_hits``, rows follow membership changes, full capacity equals
  cache-off on both paths, a fresh dense composition anchors at full
  capacity, ``min_level`` leaves level-0 pairs ungated, a block->compact
  flip keeps serving, ``patch_fraction`` 0.9999 equals image granularity,
  surplus capacity writes nowhere, finished requests drop their
  ``"unet_compact"`` entry, and the Engine serves both modes for sd15 and
  sdxl.
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
from sduss_tpu.ops.patch_ctx import PatchContext as JaxPatchContext
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine, check_supported
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.loader import load_bundle
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.ops.patch_ctx import PatchContext, compact_context
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from test_torch_block_cache_slice import make_bundles, nhwc
from test_torch_mixed_deep_gate import (C_IN, C_OUT, CELLS, MAX_HITS,
                                        make_case, metas)
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4


def close(port, want, what=""):
    np.testing.assert_allclose(nhwc(port), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


# -- cache_layout and the row-wise cross-attention --------------------------

@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("cells", [16, 128])
@pytest.mark.parametrize("min_level", [0, 1, 2])
def test_cache_layout_matches_jax(family, cells, min_level):
    name = {"sd15": "SD15_UNET", "sdxl": "SDXL_UNET"}[family]
    with torch.device("meta"):
        port = tunet.UNet2DConditionModel(getattr(tunet, name))
    want = junet.UNet2DConditionModel(getattr(junet, name)).cache_layout(
        cells, min_level)
    got = port.cache_layout(cells, min_level)
    assert list(got.items()) == list(want.items())


def test_cross_attention_rows_matches_jax():
    meta, jmeta = metas((2, 2, 1))
    rng = np.random.default_rng(5)
    c, d, heads = 16, 12, 2
    attn = tunet.Attention(c, d, heads)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32) / 4))
    jp = {n: {"kernel": jnp.asarray(getattr(attn, n).weight.detach().numpy().T)}
          for n in ("to_q", "to_k", "to_v")}
    h = rng.standard_normal((meta.p_pad, 9, c)).astype(np.float32)
    ehs = rng.standard_normal((meta.i_pad, 7, d)).astype(np.float32)
    rows = np.asarray([5, 0, 17, 3, 11])
    ctx = PatchContext(meta, "cpu")
    with torch.no_grad():
        got = ctx.cross_attention(attn, torch.from_numpy(h[rows]),
                                  torch.from_numpy(ehs),
                                  rows=torch.from_numpy(rows))
        full = ctx.cross_attention(attn, torch.from_numpy(h),
                                   torch.from_numpy(ehs))
    want = JaxPatchContext(jmeta).cross_attention(
        jp, jnp.asarray(h[rows]), jnp.asarray(ehs), heads, 0,
        rows=jnp.asarray(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got, full[rows], rtol=1e-6, atol=1e-6)


# -- the gates' selections ----------------------------------------------------

@pytest.mark.parametrize("sync", [False, True])
def test_gate_compact_rows_match_jax(sync):
    rng = np.random.default_rng(11)
    n = 8
    x = rng.standard_normal((n, C_IN, CELLS, CELLS)).astype(np.float32)
    state = {"inp": (x + rng.uniform(0.05, 1.0, (n, 1, 1, 1))
                     * rng.standard_normal(x.shape)).astype(np.float32),
             "out": rng.standard_normal((n, C_OUT, CELLS, CELLS)).astype(
                 np.float32),
             "hits": rng.integers(0, MAX_HITS, n).astype(np.int32)}
    w = rng.standard_normal((C_IN, C_OUT)).astype(np.float32)
    side = rng.standard_normal((n,)).astype(np.float32)
    t_norm = rng.uniform(0, 1, n).astype(np.float32)
    row_valid = np.asarray([True] * 3 + [False] + [True] * 3 + [False])
    n_active = n if sync else 3
    cc = dict(mode="compact", max_hits=MAX_HITS)

    def port_fn(x_c, idx):
        y = torch.einsum("nchw,cd->ndhw", x_c, torch.from_numpy(w))
        return torch.tanh(y) + torch.from_numpy(side)[idx].reshape(-1, 1, 1, 1)

    def jax_fn(x_c, idx):
        y = jnp.einsum("nhwc,cd->nhwd", x_c, jnp.asarray(w))
        return jnp.tanh(y) + jnp.asarray(side)[idx].reshape(-1, 1, 1, 1)

    pst = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    py, _, pstats = BlockCache(CacheConfig(**cc)).gate_compact(
        "k", torch.from_numpy(x), torch.from_numpy(t_norm), pst, port_fn,
        n_active, row_valid=torch.from_numpy(row_valid))
    jst = {k: jnp.asarray(nhwc(v)) for k, v in state.items()}
    jy, jnew, jstats = JaxBlockCache(JaxCacheConfig(**cc)).gate_compact(
        "k", jnp.asarray(nhwc(x)), jnp.asarray(t_norm), jst, jax_fn,
        n_active, row_valid=jnp.asarray(row_valid))
    np.testing.assert_array_equal(pstats["idx"].numpy(),
                                  np.asarray(jstats["idx"]))
    close(py, jy)
    np.testing.assert_array_equal(pst["hits"].numpy(), np.asarray(jnew["hits"]))
    for leaf in ("inp", "out"):
        close(pst[leaf], jnew[leaf], leaf)


@pytest.mark.parametrize("grids,fraction,seed", [
    ((2, 2, 1), 0.5, 1),       # bucket pad patches (9 -> 12)
    ((2, 2, 2, 1), 1.0, 2),    # class pad slots selected: rows dropped
    ((3, 2, 2, 1), 0.3, 3),    # three classes
])
def test_two_level_gate_matches_jax(grids, fraction, seed):
    """The non-even sub-composition of mode "compact" with
    ``patch_fraction`` 0.5: both packages select the same images, then
    the same ``k_q`` patch rows, and write only the real ones."""
    meta, jmeta = metas(grids)
    x, state, w, sp, si, t_norm = make_case(meta, seed, False)
    cc = dict(mode="compact", max_hits=MAX_HITS, compact_fraction=fraction,
              patch_fraction=0.5)
    sub_ctx, caps = compact_context(CELLS, meta.class_info, fraction, False,
                                    torch.device("cpu"))
    sub_img = sub_ctx.meta.image_id
    seen = {}

    def port_body(x_s, gidx, imgs, sel):
        seen["k_q"], seen["p_sub"] = len(sel), x_s.shape[0]
        y = torch.einsum("nchw,cd->ndhw", x_s, torch.from_numpy(w))
        side = torch.from_numpy(sp)[gidx] + torch.from_numpy(si)[imgs][sub_img]
        return (torch.tanh(y) + side.reshape(-1, 1, 1, 1))[sel]

    def jax_body(x_s, gidx, imgs, sel):
        y = jnp.einsum("nhwc,cd->nhwd", x_s, jnp.asarray(w))
        side = jnp.asarray(sp)[gidx] + jnp.asarray(si)[imgs][sub_img]
        return (jnp.tanh(y) + side.reshape(-1, 1, 1, 1))[sel]

    pst = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    py, _, pstats = BlockCache(CacheConfig(**cc)).gate_compact_images(
        "k", torch.from_numpy(x), torch.from_numpy(t_norm), pst, port_body,
        PatchContext(meta, "cpu"), caps)
    jcache = JaxBlockCache(JaxCacheConfig(**cc))
    jst = {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v)
           for k, v in state.items()}
    jy, jnew, jstats = jax.jit(lambda x, t, st: jcache.gate_compact_images(
        "k", x, t, st, jax_body, JaxPatchContext(jmeta), caps))(
        jnp.asarray(nhwc(x)), jnp.asarray(t_norm), jst)
    assert seen["k_q"] == max(1, round(seen["p_sub"] * 0.5))
    for f in ("gather", "images", "tok_sel"):
        np.testing.assert_array_equal(pstats[f].numpy(), np.asarray(jstats[f]),
                                      err_msg=f)
    close(py, jy)
    np.testing.assert_array_equal(pst["hits"].numpy(), np.asarray(jnew["hits"]))
    for leaf in ("inp", "out"):
        close(pst[leaf], jnew[leaf], leaf)
    # a written row is a selected row of a real image
    fresh = np.flatnonzero(pst["hits"].numpy() == 0)
    gidx = pstats["gather"].numpy()
    assert set(fresh) <= {int(gidx[s]) for s in pstats["tok_sel"].numpy()}
    assert (gidx[pstats["tok_sel"].numpy()] >= 0).sum() == len(fresh)


# -- the gated UNet forward, regime by regime ---------------------------------

REGIMES = {
    "block": dict(mode="block", mse_threshold=0.05),
    "rows": dict(mode="compact", compact_fraction=0.5),
    "images": dict(mode="compact", compact_fraction=0.5),
    "two-level": dict(mode="compact", compact_fraction=0.5,
                      patch_fraction=0.5),
}
GATE_STATS = {"gate": ("fresh",), "gate_compact": ("idx",),
              "gate_compact_images": ("gather", "images", "tok_sel")}


@pytest.fixture(scope="module")
def unets():
    jbundle, bundle = make_bundles("sd15")
    return (jbundle.denoiser, jbundle.params["unet"],
            bundle.models["unet"].eval())


def _spy(cache, record):
    for name, fields in GATE_STATS.items():
        real = getattr(cache, name)

        def spy(*a, _real=real, _fields=fields, **kw):
            y, st, stats = _real(*a, **kw)
            record.append({f: stats[f] for f in _fields if f in stats})
            return y, st, stats

        setattr(cache, name, spy)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_gated_unet_matches_jax(unets, regime):
    jmodel, jparams, port = unets
    cfg = port.cfg
    rng = np.random.default_rng(21)
    dense = regime == "rows"
    cc = dict(enabled=True, max_hits=2, **REGIMES[regime])
    if dense:
        n_img, cells = 6, 8       # 3 images, CFG-doubled; rows 2, 5 pads
        ctx = None
        n_rows = n_img
        row_valid = np.asarray([True, True, False] * 2)
    else:
        meta, jmeta = metas((2, 2, 1))
        cells = CELLS
        ctx = PatchContext(meta, "cpu")
        n_img, n_rows, row_valid = meta.i_pad, meta.p_pad, None
    layout = port.cache_layout(cells, 1)
    assert list(layout.items()) == list(jmodel.cache_layout(cells, 1).items())
    pcache, jcache = BlockCache(CacheConfig(**cc)), JaxBlockCache(
        JaxCacheConfig(**cc))
    prec, jrec, traced = [], [], []
    _spy(pcache, prec)
    _spy(jcache, traced)

    def jax_forward(sync):
        # jitted; the gates' stats, recorded while tracing, are outputs
        def fn(params, xs, t, ehs, st, rv):
            del traced[:]
            out, new = jmodel.apply(
                params, xs, t, ehs, cache=jcache, cache_state=st,
                ctx=None if dense else JaxPatchContext(jmeta), row_valid=rv,
                compact_sync=sync)
            return out, new, list(traced)
        return jax.jit(fn)
    pst = {k: pcache.init_rows(k, n_rows, s, ci, co, torch.float32)
           for k, (s, ci, co) in layout.items()}
    jst = {k: jcache.init_rows(k, n_rows, s, ci, co, jnp.float32)
           for k, (s, ci, co) in layout.items()}
    x = rng.standard_normal((n_rows, cells, cells, 4)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    drift = rng.uniform(0.02, 0.5, (n_rows, 1, 1, 1)).astype(np.float32)
    ehs = rng.standard_normal((n_img, 77, cfg.cross_attention_dim)).astype(
        np.float32)
    for step in range(2):
        xs = x + step * drift * noise
        t = np.linspace(900, 700, n_img).astype(np.float32) - 100 * step
        kw = dict(row_valid=row_valid, compact_sync=dense and step == 0)
        with torch.no_grad():
            pout, pstate = port(
                torch.from_numpy(xs), torch.from_numpy(t),
                torch.from_numpy(ehs), ctx=ctx, cache=pcache, cache_state=pst,
                row_valid=None if row_valid is None
                else torch.from_numpy(row_valid),
                compact_sync=kw["compact_sync"])
        jout, jst, stats = jax_forward(kw["compact_sync"])(
            jparams, jnp.asarray(xs), jnp.asarray(t), jnp.asarray(ehs), jst,
            None if row_valid is None else jnp.asarray(row_valid))
        jrec += stats
        assert pstate is pst
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        for key in layout:
            np.testing.assert_array_equal(pst[key]["hits"].numpy(),
                                          np.asarray(jst[key]["hits"]))
            for leaf in ("inp", "out"):
                close(pst[key][leaf], jst[key][leaf], f"{step} {key} {leaf}")
    assert len(prec) == len(jrec) == 2 * len(layout)
    for p, j in zip(prec, jrec):
        assert set(p) == set(j)
        for f in p:
            np.testing.assert_array_equal(np.asarray(p[f]), np.asarray(j[f]),
                                          err_msg=f)
    if regime == "two-level":
        assert all("tok_sel" in p for p in prec)
    if regime == "rows":  # the sync step takes every row, then 3 of 6
        assert [len(p["idx"]) for p in prec] == [6] * len(layout) \
            + [3] * len(layout)
        assert not any(set(p["idx"].tolist()) & {2, 5}
                       for p in prec[len(layout):])


# -- the port's invariants (JAX tests/test_cache.py) --------------------------

@pytest.fixture(scope="module")
def bundle():
    return load_bundle("sd15", tiny=True, dtype=torch.float32, device="cpu")


def make_pipe(bundle, mixed=True, **cache):
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.patch_size = 64
    config.scheduler.use_mixed_resolution = mixed
    config.cache = CacheConfig(**cache)
    return build_pipeline(config, "cpu", bundle=bundle)


def make_reqs(n=2, res=128, steps=4, plan=None):
    plan = plan or [(f"r{i}", res, i) for i in range(n)]
    return [Request(rid, SamplingParams(prompt=f"p {rid}", resolution=r,
                                        num_inference_steps=steps, seed=s))
            for rid, r, s in plan]


MIXED_PLAN = [("r0", 128, 0), ("r1", 64, 1)]


def run(pipe, reqs, steps, mixed=True, prepare=True):
    if prepare:
        pipe.prepare(reqs)
        for r in reqs:
            r.stage = Stage.DENOISING
    for _ in range(steps):
        by = {}
        for r in reqs:
            by.setdefault(r.resolution, []).append(r)
        (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(by)
    return [r.latents.numpy().copy() for r in reqs]


def max_hits_of(rows_list) -> int:
    return max(int(v["hits"].max()) for rows in rows_list
               for v in rows.values())


class TestBlockCache:
    def test_always_recompute_matches_cache_off(self, bundle):
        base = run(make_pipe(bundle), make_reqs(), 3)
        cached = run(make_pipe(bundle, enabled=True, mse_threshold=-1.0),
                     make_reqs(), 3)
        for a, b in zip(base, cached):
            np.testing.assert_allclose(a, b, atol=1e-5)

    def test_full_reuse_diverges_but_finite(self, bundle):
        base = run(make_pipe(bundle), make_reqs(), 3)
        cached = run(make_pipe(bundle, enabled=True, mse_threshold=1e9,
                               max_hits=100), make_reqs(), 3)
        assert all(np.isfinite(c).all() for c in cached)
        assert any(np.abs(a - b).max() > 1e-6 for a, b in zip(base, cached))

    def test_hits_counter_and_forced_recompute(self, bundle):
        pipe = make_pipe(bundle, enabled=True, mse_threshold=1e9, max_hits=2)
        reqs = make_reqs(n=1, steps=6)
        pipe.prepare(reqs)
        seen = []
        for _ in range(5):
            pipe.denoise_step_mixed({reqs[0].resolution: reqs})
            key = next(iter(reqs[0].cache_rows))
            seen.append(int(reqs[0].cache_rows[key]["hits"].max()))
        # fresh (0), reused twice, forced fresh at max_hits, reused
        assert seen == [0, 1, 2, 0, 1]

    def test_state_rows_follow_membership_changes(self, bundle):
        pipe = make_pipe(bundle, enabled=True, mse_threshold=0.5)
        reqs = make_reqs(n=3, steps=6)
        run(pipe, reqs, 1)
        # drop request 1; the others' rows line up with their patches
        pipe.denoise_step_mixed({128: [reqs[0], reqs[2]]})
        for r in (reqs[0], reqs[2]):
            for rows in r.cache_rows.values():
                assert rows["out"].shape[0] == 2 * 4
                assert torch.isfinite(rows["out"]).all()
        assert int(next(iter(reqs[1].cache_rows.values()))["hits"].max()) \
            == 0  # untouched since its one step


class TestCompactCacheDense:
    def test_full_capacity_matches_cache_off(self, bundle):
        base = run(make_pipe(bundle, mixed=False), make_reqs(), 3, mixed=False)
        compact = run(make_pipe(bundle, mixed=False, enabled=True,
                                mode="compact", compact_fraction=1.0),
                      make_reqs(), 3, mixed=False)
        for a, b in zip(base, compact):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)

    def test_half_capacity_reuses_and_finite(self, bundle):
        pipe = make_pipe(bundle, mixed=False, enabled=True, mode="compact",
                         compact_fraction=0.5)
        reqs = make_reqs(n=3, res=64, steps=5)
        run(pipe, reqs, 4, mixed=False)
        assert all(torch.isfinite(r.latents).all() for r in reqs)
        (entry,) = pipe._comp_state.values()
        assert entry["anchored"]
        assert max_hits_of([entry["state"]]) >= 1

    def test_fresh_composition_anchors_before_splicing(self, bundle):
        base = run(make_pipe(bundle, mixed=False), make_reqs(), 1, mixed=False)
        compact = run(make_pipe(bundle, mixed=False, enabled=True,
                                mode="compact", compact_fraction=0.5),
                      make_reqs(), 1, mixed=False)
        for a, b in zip(base, compact):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)

    def test_finished_request_evicts_compact_entry(self, bundle):
        pipe = make_pipe(bundle, mixed=False, enabled=True, mode="compact",
                         compact_fraction=0.5)
        reqs = make_reqs(n=3, res=64, steps=4)
        run(pipe, reqs, 2, mixed=False)
        (key,) = pipe._comp_state
        assert key[0] == "unet_compact" and key[3] == ("r0", "r1", "r2")
        pipe.evict_finished_state(["r1"])
        assert not pipe._comp_state


class TestCompactCachePatched:
    def test_full_capacity_matches_cache_off(self, bundle):
        base = run(make_pipe(bundle), make_reqs(plan=MIXED_PLAN), 3)
        compact = run(make_pipe(bundle, enabled=True, mode="compact",
                                compact_fraction=1.0),
                      make_reqs(plan=MIXED_PLAN), 3)
        for a, b in zip(base, compact):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)

    def test_half_capacity_reuses_and_finite(self, bundle):
        pipe = make_pipe(bundle, enabled=True, mode="compact",
                         compact_fraction=0.5)
        reqs = make_reqs(n=3, steps=5)  # one class of 3 images: 2 of 6
        run(pipe, reqs, 4)
        assert all(torch.isfinite(r.latents).all() for r in reqs)
        assert max_hits_of([r.cache_rows for r in reqs]) >= 1

    def test_min_level_leaves_shallow_blocks_ungated(self, bundle):
        pipe = make_pipe(bundle, enabled=True, mode="compact",
                         compact_fraction=0.5, min_level=1)
        reqs = make_reqs(plan=MIXED_PLAN)
        run(pipe, reqs, 3)
        assert all(torch.isfinite(r.latents).all() for r in reqs)
        assert not any(k.startswith(("down0", "up1"))
                       for r in reqs for k in r.cache_rows)

    def test_mode_flip_block_to_compact(self, bundle):
        """Block-mode rows share the compact layout: a pipeline in mode
        "compact" serves the same requests on."""
        reqs = make_reqs(plan=MIXED_PLAN, steps=6)
        run(make_pipe(bundle, enabled=True, mse_threshold=0.01), reqs, 1)
        rows = {r.request_id: r.cache_rows for r in reqs}
        run(make_pipe(bundle, enabled=True, mode="compact",
                      compact_fraction=0.5), reqs, 1, prepare=False)
        assert all(torch.isfinite(r.latents).all() for r in reqs)
        assert all(r.cache_rows.keys() == rows[r.request_id].keys()
                   for r in reqs)


class TestGateCompactImagesUnit:
    def test_surplus_capacity_drops_pad_slots(self):
        meta = tpatching.build_meta((2, 2, 2), 8, (16,), (4,))
        (g, ipc), = meta.class_info
        assert ipc == 4  # one class of 4 image slots, 3 real
        ctx = PatchContext(meta, "cpu")
        cache = BlockCache(CacheConfig(enabled=True, mode="compact",
                                       compact_fraction=1.0))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (meta.p_pad, 4, 8, 8)).astype(np.float32))
        state = cache.init_rows("k", meta.p_pad, 8, 4, 4, torch.float32)

        def fn(x_sub, gidx, sel_imgs):
            assert x_sub.shape[0] == 4 * g * g
            return x_sub * 2.0

        y, st, _ = cache.gate_compact_images(
            "k", x, torch.zeros(meta.p_pad), state, fn, ctx, (4,))
        torch.testing.assert_close(y[:12], 2.0 * x[:12])
        assert (y[12:] == 0).all()
        assert (st["hits"][:12] == 0).all() and (st["hits"][12:] > 0).all()


class TestTwoLevelPatchCompact:
    def test_patch_fraction_one_epsilon_matches_image_granular(self, bundle):
        a = run(make_pipe(bundle, enabled=True, mode="compact",
                          compact_fraction=1.0),
                make_reqs(plan=MIXED_PLAN), 3)
        b = run(make_pipe(bundle, enabled=True, mode="compact",
                          compact_fraction=1.0, patch_fraction=0.9999),
                make_reqs(plan=MIXED_PLAN), 3)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=1e-3)

    def test_half_patch_fraction_runs_and_reuses(self, bundle):
        pipe = make_pipe(bundle, enabled=True, mode="compact",
                         compact_fraction=1.0, patch_fraction=0.5)
        reqs = make_reqs(n=3, steps=6)
        run(pipe, reqs, 5)
        assert all(torch.isfinite(r.latents).all() for r in reqs)
        assert max_hits_of([r.cache_rows for r in reqs]) >= 1


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("mode", ["block", "compact"])
def test_engine_serves_unet_cache_modes(family, mode):
    """The Engine takes both modes for the UNet families and serves a
    mixed step on them (two-level rows under "compact")."""
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.patch_size = 64
    config.cache = CacheConfig(enabled=True, mode=mode, patch_fraction=0.5)
    check_supported(config)
    engine = Engine(config, "cpu")
    pipe = engine.workers[0].pipeline
    reqs = make_reqs(plan=MIXED_PLAN, steps=2)
    latents = run(pipe, reqs, 1)
    assert all(np.isfinite(x).all() for x in latents)
    assert all(r.cache_rows for r in reqs)
