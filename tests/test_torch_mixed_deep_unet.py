"""The port's UNet deep modes on a mixed patch batch against the JAX
package's ``apply(ctx=..., deep_mode=...)`` (CPU, float32).

On the tiny SDXL UNet (two levels, linear projections, added time
embeddings; tests/test_torch_mixed_deep_slice.py holds the tiny SD-1.5
UNet's patched deep steps through its pipeline), at deep boundary 1, the
CFG-doubled patch batch of a 2 x 128^2 + 64^2 composition at 64 px
patches (patch grids 2, 2 and 1: the shape of 512^2 and 256^2 at 256 px
patches; 9 patches padded to a bucket of 12) goes through both packages
with the same numpy weights (``jax_to_torch_state_dict``) and inputs:

- ``deep_mode="full"`` equals the plain patched forward exactly and JAX's
  full pass, and its deep feature equals JAX's (NCHW here);
- ``"shallow"`` fed JAX's deep feature, on a later input, equals JAX's
  shallow pass;
- the deep x compact hybrid: a full step writes every gated pair's rows
  through (state equal to JAX's), and a shallow step at fraction 0.5, fed
  JAX's deep feature of an earlier input, gates whole images on the
  sub-composition (output and state equal to JAX's); at fraction 1 its
  shallow output equals the plain shallow pass from the same feature;
- ``"partial"`` with a context raises, as in JAX.

Real patches are compared (the bucket's pad patches belong to no image);
tolerance RTOL 2e-4, ATOL 5e-4; hits exactly.
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
from sduss_tpu.ops import patching as jpatching
from sduss_tpu.ops.patch_ctx import PatchContext as JaxPatchContext
from sduss_tpu.ops.patch_ctx import ctx_arrays
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.ops.patch_ctx import PatchContext
from test_torch_models import np_params
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
CELLS = 8
GRIDS = (2, 2, 1)
PATCH_BUCKETS = (4, 8, 12, 16, 24, 32)
IMAGE_BUCKETS = (1, 2, 4, 8)
CACHE = dict(enabled=True, mode="deep", deep_boundary=1, max_hits=4,
             deep_compact_fraction=0.5, deep_compact_pairwise=True)


def nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2)


def make_inputs(cfg, meta, seed: int) -> dict:
    """The doubled patch batch and its per-image inputs (``i_pad`` rows of
    the doubled meta, pad slots zero)."""
    rng = np.random.default_rng(seed)
    n_img = meta.i_pad
    inp = {
        "sample": rng.standard_normal(
            (meta.p_pad, CELLS, CELLS, 4)).astype(np.float32),
        "t": rng.uniform(1, 999, (n_img,)).astype(np.float32),
        "ehs": (0.3 * rng.standard_normal(
            (n_img, 77, cfg.cross_attention_dim))).astype(np.float32),
    }
    _, pooled_dim, n_ids = cfg.addition_embed
    inp["added"] = {
        "text_embeds": (0.3 * rng.standard_normal(
            (n_img, pooled_dim))).astype(np.float32),
        "time_ids": np.full((n_img, n_ids), 64.0, np.float32)}
    return inp


def real_rows(meta) -> np.ndarray:
    return meta.kv_mask.reshape(-1)[meta.patch_pos]


@pytest.fixture(scope="module")
def models():
    tcfg, jcfg = tunet.TINY_SDXL_UNET, junet.TINY_SDXL_UNET
    jmodel = junet.UNet2DConditionModel(jcfg)
    params = np_params(jmodel.init, 5)
    port = tunet.UNet2DConditionModel(tcfg)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          jax_to_torch_state_dict("unet", params).items()},
                         strict=True)
    args = (GRIDS, CELLS, PATCH_BUCKETS, IMAGE_BUCKETS)
    meta, jmeta = tpatching.double_meta(*args), jpatching.double_meta(*args)
    inp = make_inputs(tcfg, meta, 1)
    later = dict(inp, sample=inp["sample"] * 0.9 + 0.05, t=inp["t"] - 50.0)
    return jmodel, params, port.eval(), meta, jmeta, inp, later


def port_call(port, meta, inp, **kw):
    added = {k: torch.from_numpy(v) for k, v in inp["added"].items()}
    with torch.inference_mode():
        return port(torch.from_numpy(inp["sample"]),
                    torch.from_numpy(inp["t"]), torch.from_numpy(inp["ehs"]),
                    added_cond=added, ctx=PatchContext(meta, "cpu"),
                    deep_boundary=1, **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX's hybrid full pass (output, deep feature and the rows written
    through) and, on a later input, the plain and the hybrid shallow steps
    from that feature: three programs to compile."""
    jmodel, params, port, meta, jmeta, inp, later = models
    arrays = ctx_arrays(jmeta)
    cache = JaxBlockCache(JaxCacheConfig(**CACHE))
    layout = jmodel.shallow_cache_layout(CELLS, 1)
    state0 = {k: cache.init_rows(k, meta.p_pad, s, ci, co, jnp.float32)
              for k, (s, ci, co) in layout.items()}

    def hybrid(mode):
        def f(params, inp, arrays, deep_state, cache_state):
            return jmodel.apply(
                params, jnp.asarray(inp["sample"]), jnp.asarray(inp["t"]),
                jnp.asarray(inp["ehs"]), added_cond=inp["added"],
                ctx=JaxPatchContext(jmeta, arrays=arrays), cache=cache,
                cache_state=cache_state, deep_mode=mode, deep_state=deep_state,
                deep_boundary=1)
        return jax.jit(f)

    # the hybrid's full pass is the plain full pass plus the write-through
    full, feat, state1 = hybrid("full")(params, inp, arrays, None, state0)
    hshallow, _, state2 = hybrid("shallow")(params, later, arrays, feat,
                                            state1)
    shallow, _ = jax.jit(lambda p, inp, a, d: jmodel.apply(
        p, jnp.asarray(inp["sample"]), jnp.asarray(inp["t"]),
        jnp.asarray(inp["ehs"]), added_cond=inp["added"],
        ctx=JaxPatchContext(jmeta, arrays=a), deep_mode="shallow",
        deep_state=d, deep_boundary=1))(params, later, arrays, feat)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return to_np(dict(full=full, feat=feat, state1=state1, shallow=shallow,
                      hshallow=hshallow, state2=state2))


def close(got, want, rows):
    np.testing.assert_allclose(np.asarray(got)[rows], np.asarray(want)[rows],
                               rtol=RTOL, atol=ATOL)


def test_full_equals_plain_and_jax(models, jax_runs):
    _, _, port, meta, _, inp, _ = models
    real = real_rows(meta)
    plain = port_call(port, meta, inp)
    out, feat = port_call(port, meta, inp, deep_mode="full")
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    close(out.numpy(), jax_runs["full"], real)
    assert feat.shape == nchw(jax_runs["feat"]).shape
    close(feat.numpy(), nchw(jax_runs["feat"]), real)


def test_shallow_from_jax_feature_equals_jax(models, jax_runs):
    _, _, port, meta, _, _, later = models
    feat = torch.from_numpy(nchw(jax_runs["feat"]).copy())
    out, got = port_call(port, meta, later, deep_mode="shallow",
                         deep_state=feat)
    assert got is feat
    close(out.numpy(), jax_runs["shallow"], real_rows(meta))


def port_hybrid(port, meta, inp, later, fraction, feat=None):
    """The hybrid's full step on ``inp``, then its shallow step on
    ``later`` from ``feat`` (default: the full step's own feature)."""
    cache = BlockCache(CacheConfig(**dict(CACHE,
                                          deep_compact_fraction=fraction)))
    state = {k: cache.init_rows(k, meta.p_pad, s, ci, co, torch.float32)
             for k, (s, ci, co) in port.shallow_cache_layout(CELLS, 1).items()}
    full, own, st = port_call(port, meta, inp, deep_mode="full",
                              cache=cache, cache_state=state)
    assert st is state
    state1 = {k: {leaf: v.clone() for leaf, v in rows.items()}
              for k, rows in state.items()}
    feat = own if feat is None else feat
    shallow, got, _ = port_call(port, meta, later, deep_mode="shallow",
                                deep_state=feat, cache=cache,
                                cache_state=state)
    assert got is feat
    return full, feat, state1, shallow, state


def close_state(got, want, real):
    assert set(got) == set(want)
    for key in got:
        assert set(got[key]) == set(want[key]) == {"inp", "out", "hits"}
        np.testing.assert_array_equal(got[key]["hits"].numpy(),
                                      want[key]["hits"])
        for leaf in ("inp", "out"):
            close(got[key][leaf].numpy(), nchw(want[key][leaf]), real)


def test_hybrid_write_through_and_image_gate_equal_jax(models, jax_runs):
    _, _, port, meta, _, inp, later = models
    real = real_rows(meta)
    _, _, state1, shallow, state2 = port_hybrid(
        port, meta, inp, later, 0.5,
        torch.from_numpy(nchw(jax_runs["feat"]).copy()))
    close_state(state1, jax_runs["state1"], real)
    close(shallow.numpy(), jax_runs["hshallow"], real)
    close_state(state2, jax_runs["state2"], real)
    # the 2 x 2 class recomputes one image of two (both CFG halves); the
    # 1 x 1 class its only image
    for rows in state2.values():
        assert (rows["hits"].numpy()[real] == 0).sum() == 2 * (4 + 1)


def test_hybrid_at_fraction_one_equals_plain_shallow(models):
    _, _, port, meta, _, inp, later = models
    real = real_rows(meta)
    _, feat, _, hybrid, state = port_hybrid(port, meta, inp, later, 1.0)
    plain, _ = port_call(port, meta, later, deep_mode="shallow",
                         deep_state=feat)
    close(hybrid.numpy(), plain.numpy(), real)
    for rows in state.values():
        assert (rows["hits"].numpy()[real] == 0).all()


def test_partial_is_dense_only(models):
    _, _, port, meta, _, inp, _ = models
    with pytest.raises(ValueError, match="dense-path only"):
        port_call(port, meta, inp, deep_mode="partial",
                  deep_state=torch.zeros(1), deep_sel=torch.zeros(1))
