"""The port's quality evaluation (``evaluation/``) against the JAX
package's, on the CPU with the tiny CLIP towers.

The port's ``ClipScorer`` holds the JAX scorer's seeded random weights
(carried over by ``clip_state_dict``/``clip_vision_state_dict``); its
scores are within 1e-3 of JAX's, ``clip_fid`` over 96 images a set (more
samples than the 64 feature dimensions, so the covariances are full rank)
within 1e-3 relative, and ``fid_from_features`` equals JAX's exactly.
The scorer also loads a CLIP snapshot through the port's loader.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy

from sduss_tpu.evaluation import ClipScorer as JaxScorer
from sduss_tpu.evaluation import clip_fid as jax_clip_fid
from sduss_tpu.evaluation import fid_from_features as jax_fid
from sduss_tpu_torch.evaluation import (ClipScorer, clip_fid, clip_score,
                                        feature_stats, fid_from_features)
from sduss_tpu_torch.models import clip as clip_mod
from sduss_tpu_torch.models import clip_vision as cv
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from test_torch_slice import torch_threads  # noqa: F401

# the package exports the function clip_score under the module's name
clip_score_mod = importlib.import_module("sduss_tpu_torch.evaluation.clip_score")


def images(n, size, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(n)]


def clip_state_dict(jscorer):
    """The JAX scorer's weights as one diffusers/transformers state dict
    (the layout of a CLIP snapshot)."""
    sd = jax_to_torch_state_dict("clip", jax.tree.map(np.asarray,
                                                      jscorer.text_params))
    sd.update(jax_to_torch_state_dict(
        "clip_vision", jax.tree.map(np.asarray, jscorer.vision_params)))
    return {k: np.array(v, np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def scorers():
    jscorer = JaxScorer(tiny=True)
    tscorer = ClipScorer(tiny=True, device="cpu")
    sd = clip_state_dict(jscorer)
    for m in (tscorer.text, tscorer.vision):
        m.load_state_dict({k: torch.from_numpy(sd[k]) for k in m.state_dict()})
    return jscorer, tscorer


def test_clip_score_matches_jax(scorers, monkeypatch):
    jscorer, tscorer = scorers
    prompts = ["a cat", "a dog on a mat", "a red house", "the sea at dusk"]
    imgs = images(4, 64, seed=0)
    want = jscorer.score(prompts, imgs)
    got = tscorer.score(prompts, imgs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert all(0.0 <= s <= 100.0 for s in got)
    monkeypatch.setattr(clip_score_mod, "ClipScorer", lambda **kw: tscorer)
    assert clip_score(prompts, imgs, device="cpu") == float(np.mean(got))


def test_clip_fid_matches_jax(scorers, monkeypatch):
    _, tscorer = scorers
    real, fake = images(96, 48, seed=1), images(96, 48, seed=2)
    want = jax_clip_fid(real, fake)
    monkeypatch.setattr(clip_score_mod, "ClipScorer",
                        lambda **kw: tscorer)
    got = clip_fid(real, fake, device="cpu")
    assert np.isfinite(got) and got >= 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("shift", [0.0, 0.1, 2.0])
def test_fid_from_features_equals_jax(shift):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(256, 16))
    other = base if shift == 0.0 else rng.normal(size=(256, 16)) + shift
    got = fid_from_features(base, other)
    assert got == jax_fid(base, other)
    if shift == 0.0:
        assert abs(got) < 1e-6
    with pytest.raises(ValueError, match=">= 2 samples"):
        feature_stats(base[:1])


def test_scorer_loads_a_clip_snapshot(scorers, tmp_path):
    """A CLIP snapshot's tensors load through the port's loader (no
    tokenizer files here: the hash stub, as the random scorer uses)."""
    jscorer, tscorer = scorers
    sd = clip_state_dict(jscorer)
    sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)
    st_numpy.save_file(sd, str(tmp_path / "model.safetensors"))
    # the tiny configs through a snapshot: patch the full-width ones
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clip_mod, "CLIP_L_PROJ", dataclasses.replace(
            clip_mod.TINY_CLIP, projection_dim=64))
        mp.setattr(cv, "CLIP_VIT_L14", cv.TINY_CLIP_VISION)
        loaded = ClipScorer(snapshot=str(tmp_path), device="cpu")
    prompts, imgs = ["a cat", "a dog"], images(2, 40, seed=4)
    assert loaded.score(prompts, imgs) == tscorer.score(prompts, imgs)
