"""The port's NN primitives against sduss_tpu.models.layers (CPU, float32).

Same inputs, made with numpy from a seed, go through the JAX function and
its port.  The port takes torch layouts (NCHW activations, OIHW / (out, in)
weights); the JAX side keeps NHWC / HWIO / (in, out), so each case converts
the same arrays both ways.  The group norm uses the JAX E[x^2]-E[x]^2
moments in both packages, so the float32 tolerance holds for it too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.models import layers as JL
from sduss_tpu_torch.models import layers as TL
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a.transpose(0, 3, 1, 2))


def _close(port, ref):
    if isinstance(port, torch.Tensor):
        port = port.numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 8), _rand(rng, 8, 6)
    p = {"kernel": w}
    b = None
    if bias:
        b = _rand(rng, 6)
        p["bias"] = b
    _close(TL.linear(_t(x), _t(w.T), None if b is None else _t(b)),
           JL.linear(p, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride,hw", [(3, 1, 8), (3, 2, 8), (3, 2, 9),
                                         (1, 1, 7)])
def test_conv2d(k, stride, hw):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, hw, hw, 4), _rand(rng, k, k, 4, 6), _rand(rng, 6)
    ref = JL.conv2d({"kernel": w, "bias": b}, jnp.asarray(x), stride=stride)
    out = TL.conv2d(_nchw(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride)
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("act,eps,offset", [(None, 1e-6, 0.0),
                                            ("silu", 1e-5, 0.0),
                                            ("silu", 1e-5, 3.0)])
def test_group_norm(act, eps, offset):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, 6, 16) + offset
    scale, bias = _rand(rng, 16), _rand(rng, 16)
    ref = JL.group_norm({"scale": scale, "bias": bias}, jnp.asarray(x), 4,
                        eps, act)
    out = TL.group_norm(_nchw(x), _t(scale), _t(bias), 4, eps, act)
    _close(out.permute(0, 2, 3, 1), ref)
    mod = TL.GroupNorm(4, 16, eps)
    with torch.no_grad():
        mod.weight.copy_(_t(scale))
        mod.bias.copy_(_t(bias))
    _close(mod(_nchw(x), act=act).detach().permute(0, 2, 3, 1), ref)


def test_layer_norm():
    rng = np.random.default_rng(3)
    x, s, b = _rand(rng, 2, 7, 32), _rand(rng, 32), _rand(rng, 32)
    ref = JL.layer_norm({"scale": s, "bias": b}, jnp.asarray(x))
    _close(TL.layer_norm(_t(x), _t(s), _t(b)), ref)


def test_geglu():
    rng = np.random.default_rng(4)
    x, w, b = _rand(rng, 2, 5, 8), _rand(rng, 8, 12), _rand(rng, 12)
    ref = JL.geglu({"kernel": w, "bias": b}, jnp.asarray(x))
    _close(TL.geglu(_t(x), _t(w.T), _t(b)), ref)


def test_quick_gelu():
    x = _rand(np.random.default_rng(5), 3, 11) * 4
    _close(TL.quick_gelu(_t(x)), JL.quick_gelu(jnp.asarray(x)))


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.asarray([1.0, 250.0, 999.0, 1024.0], np.float32)
    _close(TL.timestep_embedding(_t(t), dim),
           JL.timestep_embedding(jnp.asarray(t), dim))


def test_nearest_upsample_2x():
    x = _rand(np.random.default_rng(6), 2, 3, 5, 4)
    out = TL.nearest_upsample_2x(_nchw(x)).permute(0, 2, 3, 1)
    _close(out, JL.nearest_upsample_2x(jnp.asarray(x)))


@pytest.mark.parametrize("heads,lq,lk,causal", [(2, 9, 9, True),
                                                (4, 16, 7, False)])
def test_attention(heads, lq, lk, causal):
    rng = np.random.default_rng(7)
    q, k, v = _rand(rng, 2, lq, 32), _rand(rng, 2, lk, 32), _rand(rng, 2, lk, 32)
    mask = np.tril(np.ones((lq, lk), bool))[None, None] if causal else None
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                       mask=None if mask is None else jnp.asarray(mask))
    out = TL.attention(_t(q), _t(k), _t(v), heads,
                       mask=None if mask is None else _t(mask))
    _close(out, ref)


@pytest.mark.parametrize("lq,block_q", [(300, 128), (96, 128)])
def test_attention_blocked(lq, block_q):
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, 1, lq, 16) for _ in range(3))
    ref = JL.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               1, block_q=block_q)
    _close(TL.attention_blocked(_t(q), _t(k), _t(v), 1, block_q=block_q), ref)
