"""The port's models against the JAX package's (CPU, float32).

JAX initializes the parameters; ``jax_to_torch_state_dict`` carries them
into the port's ``nn.Module``s (a strict ``load_state_dict``, so every
diffusers name must match); both run the same numpy inputs.  Tolerance:
RTOL 2e-4, ATOL 5e-4.  Self-attention at 256+ tokens goes through the
port's K1 route (its plain version on the CPU).
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
from sduss_tpu_torch.models import clip as tclip
from sduss_tpu_torch.models import convert as tconvert
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models import vae as tvae
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.ops import attention as tattn
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4


def np_params(init, seed: int):
    """Random float32 parameters drawn with numpy in the tree that
    ``init(key)`` builds (JAX's own eager init takes seconds)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) == 1:  # norm affines and biases
            base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
            return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def spy_cross_short(monkeypatch) -> list:
    """Count the dispatcher's calls of K5 (``flash_cross_short``): the
    returned list gets each call's key count; the call itself goes on."""
    calls, real = [], tattn.flash_cross_short

    def spy(q, k, v, num_heads, scale):
        calls.append(k.shape[1])
        return real(q, k, v, num_heads, scale)

    monkeypatch.setattr(tattn, "flash_cross_short", spy)
    return calls


def cross_attentions(model) -> int:
    """Cross-attentions of one UNet forward: one per transformer block."""
    return sum(isinstance(m, tunet.BasicTransformerBlock)
               for m in model.modules())


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (tunet.SDXL_UNET, junet.SDXL_UNET),
    (tunet.TINY_SDXL_UNET, junet.TINY_SDXL_UNET),
    (tclip.CLIP_L, jclip.CLIP_L),
    (tclip.CLIP_G, jclip.CLIP_G),
    (tclip.TINY_CLIP, jclip.TINY_CLIP),
    (tvae.SDXL_VAE, jvae.SDXL_VAE),
    (tvae.TINY_VAE, jvae.TINY_VAE),
])
def test_configs_equal_jax(port_cfg, jax_cfg):
    assert [f.name for f in dataclasses.fields(port_cfg)] == \
        [f.name for f in dataclasses.fields(jax_cfg)]
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


@pytest.fixture(scope="module")
def unet_params():
    return np_params(junet.UNet2DConditionModel(junet.TINY_SDXL_UNET).init, 0)


@pytest.fixture(scope="module")
def vae_params():
    return np_params(jvae.AutoencoderKL(jvae.TINY_VAE).init, 2)


@pytest.mark.parametrize("kind", ["unet", "clip", "vae"])
def test_state_dict_round_trip(kind, request):
    if kind == "unet":
        p = request.getfixturevalue("unet_params")
        back = jconvert.convert_unet(jax_to_torch_state_dict("unet", p), True)
    elif kind == "clip":
        p = np_params(jclip.CLIPTextModel(jclip.TINY_CLIP).init, 1)
        back = jconvert.convert_clip(jax_to_torch_state_dict("clip", p),
                                     jclip.TINY_CLIP.num_layers)
    else:
        p = request.getfixturevalue("vae_params")
        back = jconvert.convert_vae(jax_to_torch_state_dict("vae", p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_tiny_sdxl_unet_forward(unet_params, monkeypatch):
    """Self-attention takes K1 (256 keys), each text cross-attention K5."""
    cfg = junet.TINY_SDXL_UNET
    p = unet_params
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 32, 32, 4)  # level 1 = 16x16 = 256 tokens -> K1 route
    t = np.asarray([999.0, 21.0], np.float32)
    ehs = _rand(rng, 2, 77, cfg.cross_attention_dim)
    pooled = _rand(rng, 2, cfg.addition_embed[1])
    time_ids = np.asarray([[512, 512, 0, 0, 512, 512]] * 2, np.float32)
    ref = jax.jit(junet.UNet2DConditionModel(cfg).apply)(
        p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
        added_cond={"text_embeds": jnp.asarray(pooled),
                    "time_ids": jnp.asarray(time_ids)})
    model = _load(tunet.UNet2DConditionModel(tunet.TINY_SDXL_UNET),
                  jax_to_torch_state_dict("unet", p))
    calls = spy_cross_short(monkeypatch)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ehs),
                    added_cond={"text_embeds": torch.from_numpy(pooled),
                                "time_ids": torch.from_numpy(time_ids)})
    assert calls == [77] * cross_attentions(model) and calls
    _close(out, ref)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_sdxl_level1_transformer_full_width():
    """One SDXL level-1 transformer (640 ch, 10 heads, context 2048) over
    16x16 spatial tokens."""
    p = np_params(lambda key: junet._transformer_init(key, 640, 2048, 10, 1,
                                                      True), 3)
    rng = np.random.default_rng(1)
    x, ehs = _rand(rng, 2, 16, 16, 640), _rand(rng, 2, 77, 2048)
    ref = jax.jit(lambda p, x, e: junet._transformer_apply(
        p, x, e, 10, 32, True, None, 1))(p, jnp.asarray(x), jnp.asarray(ehs))
    sd = {}
    tconvert._transformer(sd, "t", p)
    model = _load(tunet.Transformer2DModel(640, 2048, 10, 1, 32),
                  _strip(sd, "t."))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(ehs))
    _close(out.permute(0, 2, 3, 1), ref)


def test_sdxl_level1_resnet_full_width():
    """The first SDXL level-1 resnet (320 -> 640 ch, conv shortcut)."""
    p = np_params(lambda key: junet._resnet_init(key, 320, 640, 1280, 32), 4)
    rng = np.random.default_rng(2)
    x, temb = _rand(rng, 2, 16, 16, 320), _rand(rng, 2, 1280)
    ref = jax.jit(lambda p, x, t: junet._resnet_apply(p, x, t, 32, None, 1))(
        p, jnp.asarray(x), jnp.asarray(temb))
    sd = {}
    tconvert._resnet(sd, "r", p)
    model = _load(tunet.ResnetBlock2D(320, 640, 1280, 32), _strip(sd, "r."))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(temb))
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("act,eos", [("quick_gelu", 49407), ("gelu", 2)])
def test_tiny_clip_penultimate_and_pooled(act, eos):
    jcfg = dataclasses.replace(jclip.TINY_CLIP, hidden_act=act, eos_token_id=eos)
    tcfg = tclip.CLIPTextConfig(**dataclasses.asdict(jcfg))
    p = np_params(jclip.CLIPTextModel(jcfg).init, 5)
    ids = np.random.default_rng(3).integers(3, jcfg.vocab_size, (2, 77))
    ids[0, 9], ids[1, 40] = 2, 2  # EOS positions when eos == 2
    ref = jax.jit(lambda p, i: jclip.CLIPTextModel(jcfg).apply(
        p, i, output_hidden_states=True))(p, jnp.asarray(ids, jnp.int32))
    model = _load(tclip.CLIPTextModel(tcfg), jax_to_torch_state_dict("clip", p))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), output_hidden_states=True)
    _close(out["hidden_states"][-2], ref["hidden_states"][-2])
    _close(out["last_hidden_state"], ref["last_hidden_state"])
    _close(out["pooled"], ref["pooled"])


def test_tiny_vae_decode(vae_params):
    p = vae_params
    lat = _rand(np.random.default_rng(4), 2, 8, 8, 4)
    ref = jax.jit(jvae.AutoencoderKL(jvae.TINY_VAE).decode)(p, jnp.asarray(lat))
    sd = {k: v for k, v in jax_to_torch_state_dict("vae", p).items()
          if not k.startswith(("encoder.", "quant_conv."))}
    model = _load(tvae.AutoencoderKL(tvae.TINY_VAE), sd)
    with torch.no_grad():
        out = model.decode(torch.from_numpy(lat))
    _close(out, ref)
