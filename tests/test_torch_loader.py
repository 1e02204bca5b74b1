"""The port's diffusers snapshot loader (``models/loader.py``) against the
JAX package's, on synthetic snapshots written to disk.

Tiny SD-1.5 and SD3 bundles with numpy-drawn weights are written in
diffusers naming with the JAX tests' helpers (as
``tests/test_loader_snapshot.py`` does); the port's loaded state dicts
equal ``jax_to_torch_state_dict`` of JAX's ``load_bundle`` exactly, and a
denoise step from the loaded snapshot matches JAX's (latents within 1e-4
of max |JAX|, float32).  The port's own safetensors reader matches the
``safetensors`` package on F32, F16, BF16 and I64; shards merge, precision
variants are ignored when the main set exists, F16/BF16 load as their
float32 values, extra tensors are ignored and a missing one raises,
naming it.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy
from safetensors import torch as st_torch

from test_convert import synth_unet_sd
from test_convert_fullsize import (synth_clip_sd, synth_mmdit_sd, synth_t5_sd,
                                   synth_vae_sd)
from sduss_tpu.entrypoints.offline import DiffusionPipeline as JaxPipeline
from sduss_tpu.models.loader import load_bundle as jax_load_bundle
from sduss_tpu.models.registry import get_bundle
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline
from sduss_tpu_torch.models import loader
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import StubTokenizer
from test_torch_slice import _np_init, torch_threads  # noqa: F401

CLASS_NAMES = {"sd15": "StableDiffusionPipeline",
               "sd3": "StableDiffusion3Pipeline"}


def synth_component(name, params, bundle):
    if name == "unet":
        return synth_unet_sd(params, bundle.models["unet"].cfg.use_linear_projection)
    if name == "transformer":
        return synth_mmdit_sd(params)
    if name == "vae":
        return synth_vae_sd(params)
    if name == "text_encoder_3":
        return synth_t5_sd(params)
    return synth_clip_sd(params)


def write_snapshot(root, family, components, writer=st_numpy.save_file,
                   file="diffusion_pytorch_model.safetensors"):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": CLASS_NAMES[family]}, f)
    for name, sd in components.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        writer(sd, os.path.join(root, name, file))
    return root


@pytest.fixture(scope="module", params=["sd15", "sd3"])
def snapshot(request, tmp_path_factory):
    """A tiny float32 snapshot of ``family`` and its diffusers state dicts."""
    family = request.param
    src = get_bundle(family, tiny=True)
    _np_init(src, seed=0)
    sds = {name: {k: np.ascontiguousarray(np.asarray(v, np.float32))
                  for k, v in synth_component(name, p, src).items()}
           for name, p in src.params.items()}
    root = str(tmp_path_factory.mktemp(f"{family}_snap"))
    return family, write_snapshot(root, family, sds), sds


def test_loaded_state_dicts_equal_jax(snapshot):
    family, snap, _ = snapshot
    jb = jax_load_bundle(family, snapshot=snap, tiny=True)
    tb = loader.load_bundle(family, snapshot=snap, tiny=True,
                            dtype=torch.float32, device="cpu")
    assert sorted(tb.models) == sorted(jb.params)
    for name, model in tb.models.items():
        want = jax_to_torch_state_dict(name, jax.tree.map(np.asarray,
                                                          jb.params[name]))
        got = model.state_dict()
        for k, v in got.items():
            assert v.dtype == torch.float32, k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # no tokenizer directories: the hash stubs, T5's without BOS
    assert all(isinstance(t, StubTokenizer) for t in tb.tokenizers.values())
    if family == "sd3":
        t5 = tb.tokenizers["tokenizer_3"]
        assert (t5.model_max_length, t5.bos, t5.eos, t5.pad) == (256, None, 1, 0)


def test_snapshot_step_matches_jax(snapshot):
    """Latents after two steps served from the snapshot by both
    packages' ``DiffusionPipeline(model_path=...)``."""
    family, snap, _ = snapshot
    kw = dict(negative_prompt="blurry", resolution=64, num_inference_steps=2,
              seed=5, output_type="latent")
    jpipe = JaxPipeline(family, model_path=snap, dtype="float32",
                        test_tiny=True)
    want = [o.image for o in jpipe.generate(["a cat", "a dog"], **kw)]
    tpipe = DiffusionPipeline(family, model_path=snap, device="cpu",
                              dtype="float32", test_tiny=True)
    got = tpipe.generate(["a cat", "a dog"], **kw)
    for o, w in zip(got, want):
        assert o.finished and o.image.shape == w.shape
        err = np.abs(o.image - w).max()
        assert err <= 1e-4 * np.abs(w).max(), err
    images = tpipe.generate(["a cat"], resolution=64, num_inference_steps=2)
    assert images[0].image.dtype == np.uint8


def test_read_safetensors_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((3, 3))
                                 .astype(np.float32)).to(torch.bfloat16),
        "i64": torch.arange(11, dtype=torch.int64).reshape(1, 11),
        "odd": torch.from_numpy(rng.standard_normal((1, 3)).astype(np.float16)),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "t.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = loader.read_safetensors(path)
    want = st_torch.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    npath = str(tmp_path / "n.safetensors")
    arrays = {"f32": rng.standard_normal((4, 2)).astype(np.float32),
              "f16": rng.standard_normal((5,)).astype(np.float16),
              "i64": np.arange(6, dtype=np.int64)}
    st_numpy.save_file(arrays, npath)
    got = loader.read_safetensors(npath)
    for k, v in st_numpy.load_file(npath).items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].numpy().dtype == v.dtype


def test_read_safetensors_raises_on_a_bad_file(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    st_numpy.save_file({"x": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        loader.read_safetensors(path)
    path = str(tmp_path / "cut.safetensors")
    st_numpy.save_file({"x": np.zeros(8, np.float32)}, path)
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="x"):
        loader.read_safetensors(path)


def test_shards_merge_and_variants_are_ignored(tmp_path):
    rng = np.random.default_rng(1)
    sd = {f"w{i}": rng.standard_normal((2, 3)).astype(np.float32)
          for i in range(4)}
    d = tmp_path / "comp"
    d.mkdir()
    st_numpy.save_file({k: sd[k] for k in ("w0", "w1")},
                       str(d / "model-00001-of-00002.safetensors"))
    st_numpy.save_file({k: sd[k] for k in ("w2", "w3")},
                       str(d / "model-00002-of-00002.safetensors"))
    st_numpy.save_file({k: np.zeros((2, 3), np.float16) for k in sd},
                       str(d / "model.fp16.safetensors"))
    got = loader._load_safetensors_dir(str(d))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    only_variant = tmp_path / "variant"
    only_variant.mkdir()
    st_numpy.save_file({"w0": sd["w0"].astype(np.float16)},
                       str(only_variant / "model.fp16.safetensors"))
    assert loader._load_safetensors_dir(str(only_variant))["w0"].dtype \
        == torch.float16
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        loader._load_safetensors_dir(str(tmp_path / "empty"))


def test_half_precision_upcast_extras_ignored_missing_raises(snapshot,
                                                             tmp_path):
    """UNet/transformer in BF16 and text encoders in F16 load as their
    float32 values; extra tensors (the VAE encoder, CLIP's position_ids,
    T5's tied embed_tokens) are ignored; a missing tensor raises."""
    family, _, sds = snapshot
    halves = {}
    for name, sd in sds.items():
        t = {k: torch.from_numpy(v) for k, v in sd.items()}
        if name in ("unet", "transformer"):
            t = {k: v.to(torch.bfloat16) for k, v in t.items()}
        elif name.startswith("text_encoder"):
            t = {k: v.to(torch.float16) for k, v in t.items()}
            t["text_model.embeddings.position_ids"] = torch.arange(
                77, dtype=torch.int64)[None]
            if "shared.weight" in t:
                t["encoder.embed_tokens.weight"] = t["shared.weight"].clone()
        halves[name] = t
    snap = write_snapshot(str(tmp_path / "half"), family, halves,
                          writer=st_torch.save_file)
    tb = loader.load_bundle(family, snapshot=snap, tiny=True,
                            dtype=torch.float32, device="cpu")
    for name, model in tb.models.items():
        for k, v in model.state_dict().items():
            assert torch.equal(v, halves[name][k].float()), (name, k)

    broken = dict(halves)
    vae = dict(broken["vae"])
    del vae["decoder.conv_in.weight"]
    broken["vae"] = vae
    snap = write_snapshot(str(tmp_path / "broken"), family, broken,
                          writer=st_torch.save_file)
    with pytest.raises(KeyError, match=r"vae: .*decoder\.conv_in\.weight"):
        loader.load_bundle(family, snapshot=snap, tiny=True,
                           dtype=torch.float32, device="cpu")
