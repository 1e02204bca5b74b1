"""The port's CLIP vision tower and safety checker against the JAX
package's, on the CPU (tiny tower, float32).

``preprocess`` matches JAX's antialiased ``jax.image.resize(...,
"bilinear")`` within 2e-5 at 32 -> 32, 64 -> 32, 100 -> 32 and a 64 x 48
input; the tower's ``image_embeds`` match JAX's with the JAX weights
carried over by ``clip_vision_state_dict`` (RTOL 2e-4, ATOL 5e-4).
``check`` gives JAX's flags and blanked images: one concept embedding is
set to an image's own embedding so that image is flagged, and every score
stays at least 1e-3 from its threshold, so the float32 sums taken in
another order cannot flip a flag.  The pipeline sets
``RequestOutput.nsfw_flagged`` (JAX ``test_pipelines.py:105``), and both
layouts of a ``safety_checker/`` component load.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

from sduss_tpu.models.clip_vision import TINY_CLIP_VISION as JAX_TINY
from sduss_tpu.models.clip_vision import CLIPVisionModel as JaxVision
from sduss_tpu.models.safety_checker import SafetyChecker as JaxChecker
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models.clip_vision import TINY_CLIP_VISION, CLIPVisionModel
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.safety_checker import SafetyChecker
from test_torch_slice import torch_threads  # noqa: F401

RTOL, ATOL = 2e-4, 5e-4


def images(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def checkers():
    """The JAX checker with its seeded random weights and the port's
    checker holding the same weights."""
    jc = JaxChecker(tiny=True)
    jc.init_random(seed=0)
    tc = SafetyChecker(tiny=True, device="cpu")
    tc.vision = tc.vision.to_empty(device="cpu").eval()
    tc.vision.load_state_dict({
        k: torch.from_numpy(np.array(v)) for k, v in jax_to_torch_state_dict(
            "clip_vision", jax.tree.map(np.asarray, jc.params["vision"]))
        .items()})
    tc.concepts = {k: torch.from_numpy(np.array(jc.params[k], np.float32))
                   for k in ("concept_embeds", "special_care_embeds",
                             "concept_embeds_weights",
                             "special_care_embeds_weights")}
    return jc, tc


@pytest.mark.parametrize("h,w", [(32, 32), (64, 64), (100, 100), (64, 48)])
def test_preprocess_matches_jax_resize(h, w):
    imgs = images(3, h, w, seed=h + w)
    want = np.asarray(JaxVision(JAX_TINY).preprocess(jnp.asarray(imgs)))
    with torch.device("meta"):
        tower = CLIPVisionModel(TINY_CLIP_VISION)
    got = tower.preprocess(torch.from_numpy(imgs)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_image_embeds_match_jax(checkers):
    jc, tc = checkers
    imgs = images(4, 48, 48, seed=1)
    px = jc.vision.preprocess(jnp.asarray(imgs))
    want = np.asarray(jc.vision.apply(jc.params["vision"], px)["image_embeds"])
    got = tc.image_embeds(imgs).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_check_flags_and_images_equal_jax(checkers):
    jc, tc = checkers
    imgs = images(4, 64, 64, seed=2)
    emb = np.asarray(jc.vision.apply(
        jc.params["vision"], jc.vision.preprocess(jnp.asarray(imgs)))
        ["image_embeds"])
    # image 1's own embedding as concept 0 (cosine 1), with its threshold
    # halfway to the next image's cosine: only image 1 is flagged
    concept = np.array(jc.params["concept_embeds"])
    concept[0] = emb[1]
    unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    weights = np.array(jc.params["concept_embeds_weights"])
    weights[0] = (1.0 + np.delete(unit @ unit[1], 1).max()) / 2
    jc.params["concept_embeds"] = jnp.asarray(concept)
    jc.params["concept_embeds_weights"] = jnp.asarray(weights)
    with torch.inference_mode():
        tc.concepts["concept_embeds"] = torch.from_numpy(concept)
        tc.concepts["concept_embeds_weights"] = torch.from_numpy(weights)
        scores = tc.scores(imgs).numpy()
    assert np.abs(scores).min() >= 1e-3, np.abs(scores).min()
    want_imgs, want_flags = jc.check(imgs)
    got_imgs, got_flags = tc.check(imgs)
    assert got_flags == want_flags and want_flags[1] and not all(want_flags)
    np.testing.assert_array_equal(got_imgs, want_imgs)
    assert (got_imgs[1] == 0).all()
    np.testing.assert_array_equal(got_imgs[0], imgs[0])


def test_pipeline_sets_nsfw_flagged():
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.model.safety_checker_path = "random"
    pipe = DiffusionPipeline(config=config, device="cpu")
    kw = dict(resolution=64, num_inference_steps=2, seed=4)
    outs = pipe.generate(["a cat", "a dog"], **kw)
    assert all(o.image.dtype == np.uint8 for o in outs)
    assert [o.nsfw_flagged for o in outs] == [False, False]
    checker = pipe.engine.workers[0].pipeline._safety_checker()
    assert checker.vision.cfg == TINY_CLIP_VISION
    # thresholds below every cosine: every image is flagged and blanked
    with torch.inference_mode():
        checker.concepts["concept_embeds_weights"].fill_(-2.0)
    flagged = pipe.generate(["a cat", "a dog"], **kw)
    assert [o.nsfw_flagged for o in flagged] == [True, True]
    assert all((o.image == 0).all() for o in flagged)
    assert any(o.image.any() for o in outs)


@pytest.mark.parametrize("nested", [True, False])
def test_both_checkpoint_layouts_load(checkers, tmp_path, nested):
    """The stock ``StableDiffusionSafetyChecker`` names the tower
    ``vision_model.vision_model.*``; ``CLIPVisionModelWithProjection``
    names it ``vision_model.*``.  Both load; a missing tensor raises."""
    jc, tc = checkers
    sd = jax_to_torch_state_dict("clip_vision",
                                 jax.tree.map(np.asarray, jc.params["vision"]))
    if nested:
        sd = {("vision_model." + k if k.startswith("vision_model.") else k): v
              for k, v in sd.items()}
    sd.update({k: np.asarray(v, np.float32) for k, v in tc.concepts.items()})
    sd["vision_model.vision_model.embeddings.position_ids" if nested else
       "vision_model.embeddings.position_ids"] = np.arange(17, dtype=np.int64)
    st_numpy.save_file(sd, str(tmp_path / "model.safetensors"))
    loaded = SafetyChecker(tiny=True, device="cpu")
    loaded.load(str(tmp_path))
    imgs = images(2, 40, 40, seed=3)
    np.testing.assert_array_equal(loaded.scores(imgs).numpy(),
                                  tc.scores(imgs).numpy())
    del sd["special_care_embeds"]
    st_numpy.save_file(sd, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="special_care_embeds"):
        SafetyChecker(tiny=True, device="cpu").load(str(tmp_path))
