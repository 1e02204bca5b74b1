"""``ModelConfig.vae_dtype`` in the port against the JAX ``_vae_dtype`` rule
(base.py:2813-2821), on the CPU.

"auto" is float32 on the CPU for every family (bf16 on the card, held by
``test_torch_cuda.py``), and "bfloat16"/"float32" force their dtype.  The
tiny SD-1.5 decode at 256^2 after one step (seed 3, the inputs of JAX
``tests/test_pipelines.py::test_vae_bf16_decode_close_to_f32``) differs
between the two dtypes by less than 3 uint8 counts on average, and is not
identical.  The port's bf16 decode of the same latents with the same
weights (the JAX bundle's, carried over by ``jax_to_torch_state_dict``)
is within 1 count on average of JAX's bf16 decode: both cast the weights
and the unscaled latents to bf16 and keep the norms' moments in float32,
but sum in another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from test_torch_slice import _np_init, torch_threads  # noqa: F401


@pytest.mark.parametrize("family", ["sd15", "sdxl", "sd3"])
def test_vae_dtype_rule_on_the_cpu(family):
    def vae(mode):
        return ModelBundle(family, tiny=True, dtype=torch.bfloat16,
                           device="cpu", vae_dtype=mode).param_dtype("vae")

    assert vae("auto") == torch.float32
    assert vae("float32") == torch.float32
    assert vae("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="vae_dtype"):
        vae("float16")


def _port_decode_after_one_step(vae_dtype: str) -> np.ndarray:
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.model.vae_dtype = vae_dtype
    pipe = build_pipeline(config, "cpu")
    assert pipe.bundle.models["vae"].decoder.conv_in.weight.dtype \
        == pipe.bundle.param_dtype("vae")
    req = Request("r", SamplingParams(prompt="x", resolution=256,
                                      num_inference_steps=1, seed=3))
    pipe.prepare([req])
    req.stage = Stage.POSTPROCESSING
    pipe.postprocess({256: [req]})
    return req.output.astype(np.int32)


def test_bf16_decode_close_to_f32_and_not_identical():
    a = _port_decode_after_one_step("float32")
    b = _port_decode_after_one_step("bfloat16")
    diff = np.abs(a - b)
    assert diff.max() > 0, "the bf16 decode is the float32 one"
    assert diff.mean() < 3.0, diff.mean()


def test_bundle_handed_in_is_cast_once():
    bundle = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    bundle.init_random(seed=0)
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.model.vae_dtype = "bfloat16"
    pipe = build_pipeline(config, "cpu", bundle=bundle)
    assert all(p.dtype == torch.bfloat16
               for p in pipe.bundle.models["vae"].parameters())
    assert all(p.dtype == torch.float32
               for p in pipe.bundle.models["unet"].parameters())


def test_bf16_decode_matches_jax():
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, seed=3,
                                  vae_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jpipe = jax_build_pipeline(config)
    bundle = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in jpipe.bundle.params.items()})
    tconfig = default_config("sd15", dtype="float32", test_tiny=True)
    tconfig.model.vae_dtype = "bfloat16"
    pipe = build_pipeline(tconfig, "cpu", bundle=bundle)

    lat = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 4)).astype(np.float32)
    want = np.asarray(jpipe._decode_fn(jpipe.params, jnp.asarray(lat)))
    with torch.inference_mode():
        got = pipe._decode_fn(torch.from_numpy(lat)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())
