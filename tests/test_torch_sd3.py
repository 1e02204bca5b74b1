"""The port's SD-3.5 slice against the JAX package, on the CPU in float32.

Module parity: the tiny MMDiT's dense forward (one dual and one plain
block, the last dropping the context stream) and its padded-token forward
on a batch of two token lengths plus a padded row (compared on the real
tokens of the real rows), the state-dict round trip, the position grid,
and the tiled VAE decode in strip and 2D modes.  Weights are drawn with
numpy in the JAX parameter tree and carried into the port by
``models/convert.py``.  RTOL 2e-4 / ATOL 5e-4.

Slice parity: the tiny SD3 ``DiffusionPipeline`` of both packages with
the same weights, prompts and seeds, dense (one resolution, through both
engines) and mixed (64 px + 2 x 128 px in one padded-token batch: the port
through its engine, the JAX pipeline's ``denoise_step_mixed`` directly).
Bounds of tests/test_torch_slice.py: final latents within 1e-3 relative to
their scale (float32 sums in another order over the steps), images within
one uint8 level.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.entrypoints.offline import DiffusionPipeline as JaxPipeline
from sduss_tpu.models import clip as jclip
from sduss_tpu.models import convert as jconvert
from sduss_tpu.models import mmdit as jmmdit
from sduss_tpu.models import vae as jvae
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models import clip as tclip
from sduss_tpu_torch.models import mmdit as tmmdit
from sduss_tpu_torch.models import vae as tvae
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle

from test_torch_models import np_params
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
LATENT_RTOL = 1e-3
TINY_SD3_VAE = dataclasses.replace(jvae.TINY_VAE, latent_channels=4,
                                   scaling_factor=1.5305, shift_factor=0.0609)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (tmmdit.SD35_MEDIUM, jmmdit.SD35_MEDIUM),
    (tmmdit.TINY_MMDIT, jmmdit.TINY_MMDIT),
    (tvae.SD3_VAE, jvae.SD3_VAE),
    (tclip.CLIP_L_PROJ, jclip.CLIP_L_PROJ),
])
def test_sd3_configs_equal_jax(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


@pytest.fixture(scope="module")
def mmdit():
    """JAX params of the tiny MMDiT and the port's model carrying them."""
    p = np_params(jmmdit.SD3Transformer2DModel(jmmdit.TINY_MMDIT).init, 0)
    model = tmmdit.SD3Transformer2DModel(tmmdit.TINY_MMDIT)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_to_torch_state_dict("transformer", p).items()},
                          strict=True)
    return p, model.eval()


def test_mmdit_state_dict_round_trip(mmdit):
    p = mmdit[0]
    back = jconvert.convert_mmdit(jax_to_torch_state_dict("transformer", p),
                                  jmmdit.TINY_MMDIT.num_layers)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,grid,base", [(32, 32, 8), (96, 48, 64)])
def test_sincos_table_equals_jax(dim, grid, base):
    np.testing.assert_array_equal(tmmdit.sincos_2d_pos_embed(dim, grid, base),
                                  jmmdit.sincos_2d_pos_embed(dim, grid, base))


@pytest.mark.parametrize("hp,wp", [(4, 4), (16, 16), (8, 12)])
def test_pos_grid_crop_equals_jax(mmdit, hp, wp):
    jm = jmmdit.SD3Transformer2DModel(jmmdit.TINY_MMDIT)
    np.testing.assert_array_equal(mmdit[1].pos_grid(hp, wp),
                                  np.asarray(jm.pos_embed(hp, wp)))


def test_mmdit_dense_forward(mmdit):
    """Block 0 is dual, block 1 the last (no context output, [scale,
    shift] context norm); 16x16 tokens reach the K1 route."""
    p, model = mmdit
    cfg = jmmdit.TINY_MMDIT
    rng = np.random.default_rng(1)
    lat = _rand(rng, 2, 32, 32, cfg.in_channels)
    t = np.asarray([1000.0, 37.5], np.float32)
    ehs = _rand(rng, 2, 12, cfg.joint_attention_dim)
    pooled = _rand(rng, 2, cfg.pooled_projection_dim)
    ref = jax.jit(jmmdit.SD3Transformer2DModel(cfg).apply)(
        p, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ehs),
        jnp.asarray(pooled))
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(t),
                    torch.from_numpy(ehs), torch.from_numpy(pooled))
    assert out.shape == lat.shape
    _close(out, ref)


def test_mmdit_padded_token_forward(mmdit):
    """``apply_tokens`` over a batch of 16 + 64 latent tokens padded to 64,
    plus a padded row with no real token, compared on the real tokens."""
    p, model = mmdit
    cfg = jmmdit.TINY_MMDIT
    jm = jmmdit.SD3Transformer2DModel(cfg)
    rng = np.random.default_rng(2)
    lats = [_rand(rng, 1, 8, 8, cfg.in_channels),
            _rand(rng, 1, 16, 16, cfg.in_channels)]
    lens, s_pad = [16, 64], 64
    toks = [np.asarray(jm.embed_latents(p, jnp.asarray(x))) for x in lats]
    tokens = np.zeros((3, s_pad, cfg.dim), np.float32)
    for i, tk in enumerate(toks):
        tokens[i, :tk.shape[1]] = tk[0]
    tokens[2] = tokens[1]              # the bucket's padded row
    mask = np.zeros((3, s_pad), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    t = np.asarray([900.0, 250.0, 250.0], np.float32)
    ehs = _rand(rng, 3, 12, cfg.joint_attention_dim)
    pooled = _rand(rng, 3, cfg.pooled_projection_dim)
    ref = np.asarray(jax.jit(jm.apply_tokens)(
        p, jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(t),
        jnp.asarray(ehs), jnp.asarray(pooled)))
    with torch.no_grad():
        port_toks = [model.embed_latents(torch.from_numpy(x)) for x in lats]
        out = model.apply_tokens(torch.from_numpy(tokens),
                                 torch.from_numpy(mask), torch.from_numpy(t),
                                 torch.from_numpy(ehs),
                                 torch.from_numpy(pooled))
    for pt, jt in zip(port_toks, toks):
        _close(pt, jt)
    assert torch.isfinite(out).all()
    for i, n in enumerate(lens):
        _close(out[i, :n], ref[i, :n])


@pytest.mark.parametrize("shape,tile,overlap,strips", [
    ((2, 24, 8, 4), 8, 4, None),     # row strips (the SD3 serving mode)
    ((1, 20, 20, 4), 8, 4, None),    # 2D tiles (a latent too wide for strips)
    ((1, 24, 8, 4), 8, 4, False),    # 2D tiles asked for
    ((1, 8, 8, 4), 8, 4, None),      # one tile: the plain decode
])
def test_vae_decode_tiled(shape, tile, overlap, strips):
    p = np_params(jvae.AutoencoderKL(TINY_SD3_VAE).init, 3)
    lat = _rand(np.random.default_rng(4), *shape)
    ref = jvae.AutoencoderKL(TINY_SD3_VAE).decode_tiled(
        p, jnp.asarray(lat), tile=tile, overlap=overlap, strips=strips)
    sd = {k: v for k, v in jax_to_torch_state_dict("vae", p).items()
          if not k.startswith(("encoder.", "quant_conv."))}
    model = tvae.AutoencoderKL(tvae.VAEConfig(**dataclasses.asdict(TINY_SD3_VAE)))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = model.eval().decode_tiled(torch.from_numpy(lat), tile=tile,
                                        overlap=overlap, strips=strips)
    assert out.shape == (shape[0], shape[1] * 2, shape[2] * 2, 3)
    _close(out, ref)


# -- the slice end to end ------------------------------------------------------

PROMPTS = ["a red cat on a mat", "a lighthouse at dusk"]
KW = dict(negative_prompt="blurry", resolution=64, num_inference_steps=3,
          seed=11)
MIXED_RES = [64, 128, 128]
MIXED_STEPS = 2
RESOLUTIONS = (64, 128)  # sequence buckets of 16 and 64 tokens


@pytest.fixture(scope="module")
def both():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jpipe = JaxPipeline("sd3", dtype="float32", test_tiny=True,
                            use_patched=False, seed=3)
    params = jpipe.engine.workers[0].pipeline.bundle.params
    sds = {role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
           for role, p in params.items()}
    bundle = ModelBundle("sd3", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts(sds)
    tpipe = DiffusionPipeline("sd3", device="cpu", dtype="float32",
                              test_tiny=True, bundle=bundle)
    return jpipe, tpipe


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_sd3_slice_matches_jax(both, output_type):
    jpipe, tpipe = both
    jout = jpipe.generate(PROMPTS, output_type=output_type, **KW)
    tout = tpipe.generate(PROMPTS, output_type=output_type, **KW)
    assert [o.finished for o in tout] == [True, True]
    for j, t in zip(jout, tout):
        assert t.image.shape == j.image.shape
        if output_type == "latent":
            assert t.image.shape == (8, 8, 4)
            err = np.abs(t.image - j.image).max()
            assert err <= LATENT_RTOL * np.abs(j.image).max(), err
        else:
            assert t.image.dtype == np.uint8
            diff = np.abs(t.image.astype(int) - j.image.astype(int))
            assert diff.max() <= 1


@pytest.fixture(scope="module")
def mixed_jax(both):
    """JAX: prepare, MIXED_STEPS padded-token steps, then the final latents
    and the decoded images of the MIXED_RES requests."""
    jpipe = both[0].engine.workers[0].pipeline
    saved = jpipe.config.model
    jpipe.config.model = dataclasses.replace(saved, resolutions=RESOLUTIONS)
    try:
        reqs = [JaxRequest(f"m{i}", JaxSamplingParams(
            prompt=PROMPTS[i % 2], negative_prompt="blurry", resolution=res,
            num_inference_steps=MIXED_STEPS, seed=11 + i))
            for i, res in enumerate(MIXED_RES)]
        jpipe.prepare(reqs)
        by_res = {}
        for r in reqs:
            by_res.setdefault(r.resolution, []).append(r)
        for _ in range(MIXED_STEPS):
            jpipe.denoise_step_mixed(by_res)
        latents = [np.asarray(r.latents[0], np.float32) for r in reqs]
        jpipe.postprocess(by_res)
        return latents, [r.output for r in reqs]
    finally:
        jpipe.config.model = saved


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_sd3_mixed_slice_matches_jax(both, mixed_jax, output_type, tmp_path):
    config = default_config("sd3", dtype="float32", test_tiny=True,
                            resolutions=RESOLUTIONS)
    config.engine.collect_data = True
    config.engine.collect_dir = str(tmp_path)
    port = DiffusionPipeline(config=config, device="cpu",
                             bundle=both[1].engine.workers[0].pipeline.bundle)
    outs = port.generate([PROMPTS[i % 2] for i in range(len(MIXED_RES))],
                         negative_prompt="blurry", resolution=MIXED_RES,
                         num_inference_steps=MIXED_STEPS, seed=11,
                         output_type=output_type)
    denoise = [e["resolutions"] for e in port.engine.workers[0].schedule_log
               if e["stage"] == "denoising"]
    assert denoise == ["64x1;128x2"] * MIXED_STEPS
    want = mixed_jax[0] if output_type == "latent" else mixed_jax[1]
    for o, j in zip(outs, want):
        assert o.finished and o.image.shape == j.shape
        if output_type == "latent":
            err = np.abs(o.image - j).max()
            assert err <= LATENT_RTOL * np.abs(j).max(), err
        else:
            assert o.image.dtype == np.uint8
            assert np.abs(o.image.astype(int) - j.astype(int)).max() <= 1


def test_sd3_bundle_roles_and_tokenizers():
    bundle = ModelBundle("sd3", tiny=True, dtype=torch.float32, device="cpu")
    assert sorted(bundle.models) == ["text_encoder", "text_encoder_2",
                                     "text_encoder_3", "transformer", "vae"]
    assert bundle.denoiser is bundle.models["transformer"]
    assert bundle.latent_channels == 4
    ids = bundle.tokenizers["tokenizer_3"](["a cat"])["input_ids"]
    assert ids.shape == (1, 256) and ids[0, 2] == 1 and ids[0, 3] == 0
    # the VAE dtype rule: float32 on the CPU whatever the serving dtype
    assert ModelBundle("sd3", tiny=True, dtype=torch.bfloat16,
                       device="cpu").param_dtype("vae") == torch.float32
