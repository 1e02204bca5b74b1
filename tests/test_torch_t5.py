"""The port's T5 encoder and its primitives against the JAX package's
(CPU, float32).

Weights are drawn with numpy in the JAX parameter tree and carried into the
port by ``t5_state_dict`` (a strict ``load_state_dict``); both packages run
the same ids and padding mask.  Tolerance RTOL 2e-4 / ATOL 5e-4, the
float32 bound of the other parity tests.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.models import convert as jconvert
from sduss_tpu.models import layers as JL
from sduss_tpu.models import t5 as jt5
from sduss_tpu_torch.models import layers as TL
from sduss_tpu_torch.models import t5 as tt5
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict

from test_torch_models import np_params
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
# the JAX tiny SD3 T5 (registry.py:106)
TINY_SD3_T5 = dataclasses.replace(jt5.TINY_T5, d_model=32, d_kv=8, num_heads=4)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (tt5.T5_XXL, jt5.T5_XXL), (tt5.TINY_T5, jt5.TINY_T5)])
def test_t5_configs_equal_jax(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


@pytest.mark.parametrize("shape", [(2, 7, 16), (3, 64)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm({"scale": jnp.asarray(w)}, jnp.asarray(x), 1e-6))


def test_gelu_tanh():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(TL.gelu_tanh(torch.from_numpy(x)),
           jax.nn.gelu(jnp.asarray(x), approximate=True))


@pytest.mark.parametrize("seq,buckets,max_dist", [(256, 32, 128), (40, 8, 16)])
def test_relative_position_bucket(seq, buckets, max_dist):
    ctx = np.arange(seq)
    rel = ctx[None, :] - ctx[:, None]
    np.testing.assert_array_equal(
        tt5._relative_position_bucket(rel, buckets, max_dist),
        jt5._relative_position_bucket(rel, buckets, max_dist))


def test_t5_state_dict_round_trip():
    p = np_params(jt5.T5EncoderModel(TINY_SD3_T5).init, 0)
    back = jconvert.convert_t5(jax_to_torch_state_dict("text_encoder_3", p),
                               TINY_SD3_T5.num_layers)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", [TINY_SD3_T5, jt5.TINY_T5])
def test_tiny_t5_with_padding_mask(cfg):
    p = np_params(jt5.T5EncoderModel(cfg).init, 1)
    rng = np.random.default_rng(2)
    ids = rng.integers(2, cfg.vocab_size, (3, 40)).astype(np.int32)
    mask = np.zeros((3, 40), np.int32)
    for row, n in enumerate((40, 13, 1)):  # full, padded, one real token
        mask[row, :n] = 1
        ids[row, n:] = 0
    ref = jax.jit(jt5.T5EncoderModel(cfg).apply)(
        p, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    model = tt5.T5EncoderModel(tt5.T5Config(**dataclasses.asdict(cfg)))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_to_torch_state_dict("t5", p).items()},
                          strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(ids.astype(np.int64)),
                           attention_mask=torch.from_numpy(mask))
    assert out.shape == (3, 40, cfg.d_model)
    _close(out, ref)
