"""The port's fused GroupNorm + SiLU + halo op (kernel K4's plain version on
the CPU) against the JAX op: the Pallas kernel in interpret mode
(``force_pallas=True``) and the unfused jnp composition
(``force_pallas=False``).

The port is NCHW, JAX NHWC: inputs are permuted going in and out.
Tolerances: float32 RTOL 1e-5 / ATOL 1e-5 (the same float32 math in
another order; the JAX kernel folds the affine, the plain version does
not); bfloat16 within one bf16 ulp of the output scale (2^-7 relative to
max |out|: both round once from float32).  The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.ops import patching as jpatching
from sduss_tpu.ops.gn_halo import gn_silu_haloed as jax_gn_silu_haloed
from sduss_tpu_torch.ops import _build
from sduss_tpu_torch.ops import gn_halo as tgn
from test_torch_slice import torch_threads  # noqa: F401

F32_TOL = 1e-5
BF16_MAX_REL = 2.0 ** -7


def _case(grids, s, c, seed):
    meta = jpatching.build_meta(tuple(grids), s, (32,), (4,))
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((meta.p_pad, s, s, c)) + 0.3).astype(
        np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return meta, x, scale, bias


def _port(meta, x, scale, bias, groups, act, dtype):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    out = tgn.gn_silu_haloed(
        xt, torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(meta.image_id), torch.from_numpy(meta.neighbors),
        meta.i_pad, groups, 1e-5, act)
    assert out.dtype == dtype
    return out.float().permute(0, 2, 3, 1).numpy()


def _jax(meta, x, scale, bias, groups, act, dtype, force_pallas):
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    out = jax_gn_silu_haloed(p, jnp.asarray(x, dtype), meta.image_id,
                             meta.neighbors, meta.i_pad, groups, 1e-5, act,
                             force_pallas=force_pallas)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("force_pallas", [True, False])
@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("grids,s,c", [((2, 3), 8, 32), ((1, 2, 1), 4, 64)])
def test_f32_matches_jax(grids, s, c, act, force_pallas):
    meta, x, scale, bias = _case(grids, s, c, seed=s + c)
    got = _port(meta, x, scale, bias, 8, act, torch.float32)
    want = _jax(meta, x, scale, bias, 8, act, jnp.float32, force_pallas)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("force_pallas", [True, False])
def test_bf16_matches_jax(force_pallas):
    meta, x, scale, bias = _case((2, 2), 4, 32, seed=5)
    got = _port(meta, x, scale, bias, 8, "silu", torch.bfloat16)
    want = _jax(meta, x, scale, bias, 8, "silu", jnp.bfloat16, force_pallas)
    assert np.abs(got - want).max() <= BF16_MAX_REL * np.abs(want).max()


def test_image_border_halos_are_zero():
    meta, x, scale, bias = _case((2,), 4, 32, seed=7)
    got = _port(meta, x, scale, bias, 8, "silu", torch.float32)
    # patch 0 is the top-left of a 2x2 grid: top row and left column are
    # image borders; its bottom and right halos come from patches 2 and 1
    np.testing.assert_array_equal(got[0, 0], 0.0)
    np.testing.assert_array_equal(got[0, :, 0], 0.0)
    assert np.abs(got[0, -1, 1:-1]).sum() > 0
    assert np.abs(got[0, 1:-1, -1]).sum() > 0


def test_moments_clamp_and_per_image():
    meta, x, _, _ = _case((2, 3), 4, 32, seed=9)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    mean, var = tgn.moments(xt, torch.from_numpy(meta.image_id), meta.i_pad, 8)
    for img, g in enumerate((2, 3)):
        rows = x[meta.image_id == img].reshape(-1, 8, 4)
        np.testing.assert_allclose(mean[img].numpy(), rows.mean(axis=(0, 2)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var[img].numpy(), rows.var(axis=(0, 2)),
                                   rtol=1e-4, atol=1e-5)
    const = torch.full((4, 32, 4, 4), 3.0)  # E[x^2]-E[x]^2 may round < 0
    assert (tgn.moments(const, torch.zeros(4, dtype=torch.int32), 1, 8)[1]
            >= 0).all()


def test_cpu_wrapper_never_loads_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = tgn.gn_silu_halo.launches
    meta, x, scale, bias = _case((2,), 4, 32, seed=1)
    _port(meta, x, scale, bias, 8, "silu", torch.bfloat16)
    assert tgn.gn_silu_halo.launches == before


def _bf(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _i32(*shape):
    return torch.zeros(*shape, dtype=torch.int32)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(2, 8, 4, 4), _i32(2), _i32(2, 8)), "bfloat16"),
    ((_bf(2, 8, 4, 5), _i32(2), _i32(2, 8)), r"\(P, C, s, s\)"),
    ((_bf(2, 4, 4, 8).permute(0, 3, 1, 2), _i32(2), _i32(2, 8)),
     "contiguous"),
    ((_bf(2, 8, 4, 4), torch.zeros(2, dtype=torch.long), _i32(2, 8)),
     "image_id"),
    ((_bf(2, 8, 4, 4), _i32(2), _i32(2, 4)), "neighbors"),
    ((_bf(2, 8, 4, 4), _i32(2), _i32(2, 8)), "CUDA"),
])
def test_check_inputs_rejects(args, match):
    stats = torch.zeros(1, 4)
    with pytest.raises(ValueError, match=match):
        tgn.check_inputs(*args, stats, stats, torch.zeros(8), torch.zeros(8))


@pytest.mark.parametrize("stats", [
    torch.zeros(1, 4, dtype=torch.float64),
    torch.zeros(1, 4, dtype=torch.bfloat16),
    torch.zeros(1, 8)[:, ::2],
])
def test_check_inputs_rejects_moments(stats):
    """The kernel folds the moments itself: they must be contiguous float32
    (I, G)."""
    with pytest.raises(ValueError, match="mean must be contiguous float32"):
        tgn.check_inputs(_bf(2, 8, 4, 4), _i32(2), _i32(2, 8), stats, stats,
                         torch.zeros(8), torch.zeros(8))
