"""The port's SD-1.5 models against the JAX package's (CPU, float32):
the conv-projection spatial transformer at SD-1.5's real width, the tiny
conv-projection UNet dense and patched, the converter round trip with 1x1
conv projections, and the full-size configurations.

JAX parameters (drawn with numpy) are carried into the port by
``jax_to_torch_state_dict`` (a strict ``load_state_dict``).  Tolerance:
RTOL 2e-4, ATOL 5e-4; the patched UNet against its own dense forward
RTOL 5e-3, the bound of tests/test_torch_patch_unet.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.models import clip as jclip
from sduss_tpu.models import convert as jconvert
from sduss_tpu.models import unet as junet
from sduss_tpu.models import vae as jvae
from sduss_tpu.ops import patching as jpatching
from sduss_tpu.ops.patch_ctx import PatchContext as JaxPatchContext
from sduss_tpu_torch.models import convert as tconvert
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models import vae as tvae
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.ops.patch_ctx import PatchContext
from test_torch_models import cross_attentions, np_params, spy_cross_short
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
CELLS = 8  # tiny UNet patches: level 0 is 8x8 = 64 tokens
PATCH_BUCKETS = (4, 8, 16, 32)
IMAGE_BUCKETS = (2, 4, 8)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (tunet.SD15_UNET, junet.SD15_UNET),
    (tunet.TINY_UNET, junet.TINY_UNET),
    (tvae.SD15_VAE, jvae.SD15_VAE),
])
def test_sd15_configs_equal_jax(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def tiny():
    cfg = junet.TINY_UNET
    params = np_params(junet.UNet2DConditionModel(cfg).init, 0)
    port = _load(tunet.UNet2DConditionModel(tunet.TINY_UNET),
                 jax_to_torch_state_dict("unet", params))
    return cfg, params, port


def test_conv_projection_transformer_full_width():
    """One SD-1.5 level-0 transformer (320 ch, 8 heads of 40, context 768,
    1x1-conv projections) over 16x16 tokens, through the K1 route."""
    p = np_params(lambda key: junet._transformer_init(key, 320, 768, 8, 1,
                                                      False), 3)
    assert p["proj_in"]["kernel"].shape == (1, 1, 320, 320)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 320)).astype(np.float32)
    ehs = rng.standard_normal((2, 77, 768)).astype(np.float32)
    ref = jax.jit(lambda p, x, e: junet._transformer_apply(
        p, x, e, 8, 32, False, None, 0))(p, jnp.asarray(x), jnp.asarray(ehs))
    sd = {}
    tconvert._transformer(sd, "t", p)
    model = _load(tunet.Transformer2DModel(320, 768, 8, 1, 32,
                                           use_linear=False),
                  {k[2:]: v for k, v in sd.items()})
    assert isinstance(model.proj_in, torch.nn.Conv2d)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(ehs))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_state_dict_round_trip_conv_projections(tiny):
    """JAX tree -> diffusers names -> JAX tree, the converter taking
    ``use_linear_projection`` from the config; the conv projections are
    diffusers' (C, C, 1, 1) weights."""
    cfg, params, _ = tiny
    sd = jax_to_torch_state_dict("unet", params)
    assert sd["down_blocks.0.attentions.0.proj_in.weight"].shape == (32, 32, 1, 1)
    back = jconvert.convert_unet(sd, cfg.use_linear_projection)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def _inputs(cfg, n, seed, hw=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 4)).astype(np.float32)
    t = rng.uniform(1, 999, (n,)).astype(np.float32)
    ehs = rng.standard_normal((n, 77, cfg.cross_attention_dim)).astype(np.float32)
    return x, t, ehs


def test_tiny_unet_dense_forward(tiny, monkeypatch):
    """Level 0 (1024 tokens) and the mid block (256 tokens) take the K1
    route, each text cross-attention K5; level 1 has no attention."""
    cfg, params, port = tiny
    x, t, ehs = _inputs(cfg, 2, 0)
    ref = jax.jit(junet.UNet2DConditionModel(cfg).apply)(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs))
    calls = spy_cross_short(monkeypatch)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ehs))
    assert calls == [77] * cross_attentions(port) and calls
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


@pytest.mark.parametrize("grids,seed", [((1, 2), 1), ((1, 2, 3), 2)])
def test_tiny_unet_patched(tiny, grids, seed, monkeypatch):
    """One mixed patch batch through the JAX ``apply(ctx=...)`` and the
    port's ``forward(ctx=...)`` (each text cross-attention on K5); each
    image also against the port's dense forward."""
    cfg, params, port = tiny
    rng = np.random.default_rng(seed)
    images = [rng.standard_normal((1, g * CELLS, g * CELLS, 4)).astype(np.float32)
              for g in grids]
    _, t, ehs = _inputs(cfg, len(grids), seed)
    meta = tpatching.build_meta(tuple(grids), CELLS, PATCH_BUCKETS,
                                IMAGE_BUCKETS)
    x = _pad(np.concatenate([tpatching.split_latent(torch.from_numpy(im),
                                                    CELLS).numpy()
                             for im in images]), meta.p_pad)
    tp, ehsp = _pad(t, meta.i_pad), _pad(ehs, meta.i_pad)
    calls = spy_cross_short(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(tp),
                   torch.from_numpy(ehsp), ctx=PatchContext(meta, "cpu")).numpy()
    assert calls == [77] * cross_attentions(port) and calls
    jmeta = jpatching.build_meta(tuple(grids), CELLS, PATCH_BUCKETS,
                                 IMAGE_BUCKETS)
    want = jax.jit(lambda p, x, t, e: junet.UNet2DConditionModel(cfg).apply(
        p, x, t, e, ctx=JaxPatchContext(jmeta)))(
        params, jnp.asarray(x), jnp.asarray(tp), jnp.asarray(ehsp))
    n = meta.n_patches
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], rtol=RTOL,
                               atol=ATOL)
    off = 0
    for i, g in enumerate(grids):
        with torch.no_grad():
            dense = port(torch.from_numpy(images[i]),
                         torch.from_numpy(t[i:i + 1]),
                         torch.from_numpy(ehs[i:i + 1]))
        merged = tpatching.merge_patches(torch.from_numpy(got[off:off + g * g]), g)
        off += g * g
        np.testing.assert_allclose(merged.numpy(), dense.numpy(), rtol=5e-3,
                                   atol=ATOL)


def _jax_numel(init) -> int:
    shapes = jax.eval_shape(init, jax.random.key(0))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_full_size_sd15_bundle_matches_jax():
    """The full-size bundle (built on the meta device, nothing allocated):
    the UNet and CLIP-L have the JAX models' parameter counts, the VAE is
    the SD-1.5 decoder, one tokenizer."""
    bundle = ModelBundle("sd15", dtype=torch.bfloat16, device="cpu")
    assert sorted(bundle.models) == ["text_encoder", "unet", "vae"]
    assert sorted(bundle.tokenizers) == ["tokenizer"]
    assert bundle.models["unet"].cfg == tunet.SD15_UNET
    assert bundle.models["vae"].cfg == tvae.SD15_VAE
    numel = {k: sum(p.numel() for p in m.parameters())
             for k, m in bundle.models.items()}
    assert numel["unet"] == _jax_numel(
        junet.UNet2DConditionModel(junet.SD15_UNET).init)
    te = dataclasses.replace(jclip.CLIP_L, projection_dim=None)
    assert numel["text_encoder"] == _jax_numel(jclip.CLIPTextModel(te).init)
    assert bundle.param_dtype("vae") == torch.float32  # on the CPU
