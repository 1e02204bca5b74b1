"""The port's patched tiny SDXL UNet against the JAX package's, and against
its own dense forward.

The JAX parameters (drawn with numpy) are carried into the port by
``jax_to_torch_state_dict``.  One mixed patch batch goes through the JAX
``apply(..., ctx=PatchContext)`` and the port's ``forward(..., ctx=...)``
(real patches compared; the padded patches of the dummy image slot are
discarded by both pipelines): float32 RTOL 2e-4 / ATOL 5e-4.  Against the
port's dense forward of each image on its own: RTOL 5e-3 / ATOL 5e-4, the
bound of tests/test_patching.py (the per-image statistics and attention
are summed in another order across patches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.models import unet as junet
from sduss_tpu.ops import patching as jpatching
from sduss_tpu.ops.patch_ctx import PatchContext as JaxPatchContext
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.ops.patch_ctx import PatchContext
from test_torch_models import cross_attentions, np_params, spy_cross_short
from test_torch_slice import torch_threads  # noqa: F401

PATCH_BUCKETS = (4, 8, 16, 32, 64)
IMAGE_BUCKETS = (2, 4, 8, 16)
CELLS = 8  # tiny SDXL: level 1 patches are 4x4 = 16 tokens


@pytest.fixture(scope="module")
def models():
    cfg = junet.TINY_SDXL_UNET
    params = np_params(junet.UNet2DConditionModel(cfg).init, 0)
    port = tunet.UNet2DConditionModel(tunet.TINY_SDXL_UNET)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          jax_to_torch_state_dict("unet", params).items()},
                         strict=True)
    return cfg, params, port.eval()


def _inputs(cfg, grids, seed):
    rng = np.random.default_rng(seed)
    n = len(grids)
    images = [rng.standard_normal((1, g * CELLS, g * CELLS, 4)).astype(np.float32)
              for g in grids]
    t = rng.uniform(1, 999, (n,)).astype(np.float32)
    ehs = rng.standard_normal((n, 77, cfg.cross_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((n, cfg.addition_embed[1])).astype(np.float32)
    time_ids = np.asarray([[g * 64.0, g * 64.0, 0, 0, g * 64.0, g * 64.0]
                           for g in grids], np.float32)
    return images, t, ehs, pooled, time_ids


def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def _patch_batch(grids, images, t, ehs, pooled, time_ids):
    meta = tpatching.build_meta(tuple(grids), CELLS, PATCH_BUCKETS,
                                IMAGE_BUCKETS)
    x = np.concatenate([tpatching.split_latent(torch.from_numpy(im),
                                               CELLS).numpy()
                        for im in images])
    per_img = [_pad(a, meta.i_pad) for a in (t, ehs, pooled, time_ids)]
    return meta, _pad(x, meta.p_pad), per_img


def _port_patched(port, meta, x, per_img):
    t, ehs, pooled, time_ids = (torch.from_numpy(a) for a in per_img)
    with torch.no_grad():
        return port(torch.from_numpy(x), t, ehs,
                    added_cond={"text_embeds": pooled, "time_ids": time_ids},
                    ctx=PatchContext(meta, "cpu")).numpy()


@pytest.mark.parametrize("grids,seed", [((2,), 0), ((2, 4), 1),
                                        ((2, 2, 4), 3)])
def test_patched_matches_jax_and_dense(models, grids, seed, monkeypatch):
    """The patched forward sends each text cross-attention (per-patch K/V)
    to K5."""
    cfg, params, port = models
    images, t, ehs, pooled, time_ids = _inputs(cfg, grids, seed)
    meta, x, per_img = _patch_batch(grids, images, t, ehs, pooled, time_ids)
    calls = spy_cross_short(monkeypatch)
    got = _port_patched(port, meta, x, per_img)
    assert calls == [77] * cross_attentions(port) and calls
    n = meta.n_patches

    jmeta = jpatching.build_meta(tuple(grids), CELLS, PATCH_BUCKETS,
                                 IMAGE_BUCKETS)
    jt, jehs, jpooled, jtime_ids = (jnp.asarray(a) for a in per_img)
    want = jax.jit(lambda p, x, t, e, pooled, ids: junet.UNet2DConditionModel(
        cfg).apply(p, x, t, e, added_cond={"text_embeds": pooled,
                                           "time_ids": ids},
                   ctx=JaxPatchContext(jmeta)))(
        params, jnp.asarray(x), jt, jehs, jpooled, jtime_ids)
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], rtol=2e-4,
                               atol=5e-4)

    off = 0
    for i, g in enumerate(grids):
        with torch.no_grad():
            dense = port(torch.from_numpy(images[i]), torch.from_numpy(t[i:i + 1]),
                         torch.from_numpy(ehs[i:i + 1]),
                         added_cond={"text_embeds": torch.from_numpy(pooled[i:i + 1]),
                                     "time_ids": torch.from_numpy(time_ids[i:i + 1])})
        merged = tpatching.merge_patches(torch.from_numpy(got[off:off + g * g]), g)
        off += g * g
        np.testing.assert_allclose(merged.numpy(), dense.numpy(), rtol=5e-3,
                                   atol=5e-4)
    assert np.isfinite(got).all()


def test_context_group_norm_does_not_clamp(models):
    """``PatchContext.group_norm`` mirrors the JAX context's (no variance
    clamp); the fused op's moments clamp.  Same values on real data."""
    _, _, port = models
    meta = tpatching.build_meta((2, 4), CELLS, PATCH_BUCKETS, IMAGE_BUCKETS)
    x = np.random.default_rng(4).standard_normal(
        (meta.p_pad, CELLS, CELLS, 32)).astype(np.float32)
    norm = port.down_blocks[0].resnets[0].norm1
    got = PatchContext(meta, "cpu").group_norm(
        norm, torch.from_numpy(x).permute(0, 3, 1, 2), act="silu")
    p = {"scale": jnp.asarray(norm.weight.detach().numpy()),
         "bias": jnp.asarray(norm.bias.detach().numpy())}
    want = JaxPatchContext(jpatching.build_meta(
        (2, 4), CELLS, PATCH_BUCKETS, IMAGE_BUCKETS)).group_norm(
        p, jnp.asarray(x), norm.num_groups, norm.eps, "silu", 0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=2e-4, atol=5e-4)
