"""The port's Euler, flow-matching Euler, DDIM and PNDM samplers against
sduss_tpu.samplers.euler, .flow_match, .ddim and .pndm, and the PNDM state's
patch slicing against the JAX pipeline's.

Tables are numpy in both packages and must be identical; the step math
runs in float32 (RTOL 2e-4, ATOL 5e-4, the float32 bound of the other
parity tests).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.pipelines.base import BasePipeline as JaxBasePipeline
from sduss_tpu.samplers import base as jbase
from sduss_tpu.samplers.ddim import DDIMSampler as JaxDDIM
from sduss_tpu.samplers.euler import EulerDiscreteSampler as JaxEuler
from sduss_tpu.samplers.flow_match import FlowMatchEulerSampler as JaxFlow
from sduss_tpu.samplers.pndm import PNDMSampler as JaxPNDM
from sduss_tpu_torch.pipelines.base import BasePipeline
from sduss_tpu_torch.samplers import base as tbase
from sduss_tpu_torch.samplers import get_sampler
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4


@pytest.mark.parametrize("spacing", ["leading", "linspace", "trailing"])
@pytest.mark.parametrize("steps", [3, 8, 30, 50])
def test_tables_identical(spacing, steps):
    jt = JaxEuler(timestep_spacing=spacing).make_table(steps)
    tt = get_sampler("euler", timestep_spacing=spacing).make_table(steps)
    np.testing.assert_array_equal(tt.timesteps, jt.timesteps)
    np.testing.assert_array_equal(tt.coeffs, jt.coeffs)
    assert tt.init_noise_sigma == jt.init_noise_sigma
    assert tt.timesteps.dtype == jt.timesteps.dtype == np.float32
    # per-request gathers at staggered positions
    jts, tts = [JaxEuler().make_table(n) for n in (5, 9)], \
        [get_sampler("euler").make_table(n) for n in (5, 9)]
    for j, t, k in zip(jts, tts, (1, 4)):
        j.step = t.step = k
    np.testing.assert_array_equal(tbase.gather_timesteps(tts),
                                  jbase.gather_timesteps(jts))
    np.testing.assert_array_equal(tbase.gather_coeffs(tts),
                                  jbase.gather_coeffs(jts))


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction", "sample"])
def test_step_matches(prediction):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32) * 14.0
    eps = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    table = JaxEuler().make_table(30)
    c = table.coeffs[[0, 11, 29]]
    jax_s = JaxEuler(prediction_type=prediction)
    port_s = get_sampler("euler", prediction_type=prediction)
    jc0, jc1 = jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1])
    tc0, tc1 = torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1])
    np.testing.assert_allclose(
        port_s.scale_model_input(torch.from_numpy(x), tc0).numpy(),
        np.asarray(jax_s.scale_model_input(jnp.asarray(x), jc0)),
        rtol=RTOL, atol=ATOL)
    out = port_s.step(torch.from_numpy(x), torch.from_numpy(eps), tc0, tc1)
    ref = jax_s.step(jnp.asarray(x), jnp.asarray(eps), jc0, jc1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # the final cast keeps the latent dtype
    assert port_s.step(torch.from_numpy(x).bfloat16(), torch.from_numpy(eps),
                       tc0, tc1).dtype == torch.bfloat16


@pytest.mark.parametrize("shift", [3.0, 1.0])
@pytest.mark.parametrize("steps", [2, 8, 28, 40])
def test_flow_match_tables_identical(shift, steps):
    jt = JaxFlow(shift=shift).make_table(steps)
    tt = get_sampler("flow_match", shift=shift).make_table(steps)
    np.testing.assert_array_equal(tt.timesteps, jt.timesteps)
    np.testing.assert_array_equal(tt.coeffs, jt.coeffs)
    assert tt.init_noise_sigma == jt.init_noise_sigma == 1.0
    assert tt.timesteps.dtype == jt.timesteps.dtype == np.float32


def test_flow_match_step_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 8, 16)).astype(np.float32)
    vel = rng.standard_normal((3, 8, 8, 16)).astype(np.float32)
    c = JaxFlow().make_table(28).coeffs[[0, 13, 27]]
    tc0, tc1 = torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1])
    port = get_sampler("flow_match", shift=3.0)
    # identity model input
    np.testing.assert_array_equal(
        port.scale_model_input(torch.from_numpy(x), tc0).numpy(), x)
    out = port.step(torch.from_numpy(x), torch.from_numpy(vel), tc0, tc1)
    ref = JaxFlow.step(jnp.asarray(x), jnp.asarray(vel),
                       jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert port.step(torch.from_numpy(x).bfloat16(), torch.from_numpy(vel),
                     tc0, tc1).dtype == torch.bfloat16


@pytest.mark.parametrize("steps", [1, 10, 50, 1000])
def test_ddim_tables_identical(steps):
    """1000 steps with offset 1 reaches one past the last training step
    (both clip it)."""
    jt = JaxDDIM().make_table(steps)
    tt = get_sampler("ddim").make_table(steps)
    np.testing.assert_array_equal(tt.timesteps, jt.timesteps)
    np.testing.assert_array_equal(tt.coeffs, jt.coeffs)
    assert tt.init_noise_sigma == jt.init_noise_sigma == 1.0
    assert not get_sampler("ddim").needs_state


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_step_matches(prediction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    c = JaxDDIM().make_table(10).coeffs[[0, 4, 9]]
    port = get_sampler("ddim", prediction_type=prediction)
    tc0, tc1 = torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1])
    np.testing.assert_array_equal(
        port.scale_model_input(torch.from_numpy(x), tc0).numpy(), x)
    out = port.step(torch.from_numpy(x), torch.from_numpy(eps), tc0, tc1)
    ref = JaxDDIM(prediction_type=prediction).step(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(c[:, 0]),
        jnp.asarray(c[:, 1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert port.step(torch.from_numpy(x).bfloat16(), torch.from_numpy(eps),
                     tc0, tc1).dtype == torch.bfloat16


@pytest.mark.parametrize("steps", [1, 2, 4, 10, 50])
def test_pndm_tables_identical(steps):
    """num_steps + 1 model evaluations (the corrector repeats the second
    timestep), one for a single step."""
    jt = JaxPNDM().make_table(steps)
    tt = get_sampler("pndm").make_table(steps)
    np.testing.assert_array_equal(tt.timesteps, jt.timesteps)
    np.testing.assert_array_equal(tt.coeffs, jt.coeffs)
    assert tt.num_steps == (steps + 1 if steps > 1 else 1)
    assert tt.init_noise_sigma == jt.init_noise_sigma == 1.0


def test_pndm_steps_with_state_match():
    """Seven evaluations of a batch of requests at staggered positions of
    their schedules (so each history rung and the corrector run in one
    batch), state threaded through both packages."""
    rng = np.random.default_rng(3)
    b = 3
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    table = JaxPNDM().make_table(8)
    port = get_sampler("pndm")
    assert port.needs_state
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tstate = port.init_state(tx)
    jstate = JaxPNDM.init_state(jx)
    offsets = np.asarray([0, 1, 2])
    for i in range(7):
        eps = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
        rows = table.coeffs[i + offsets]
        if i == 0:  # stagger the counters: request j starts at eval j
            tstate["count"] = torch.from_numpy(offsets.astype(np.int32))
            jstate["count"] = jnp.asarray(offsets, jnp.int32)
        tx, tstate = port.step_with_state(
            tx, torch.from_numpy(eps), torch.from_numpy(rows[:, 0]),
            torch.from_numpy(rows[:, 1]), tstate)
        jx, jstate = JaxPNDM.step_with_state(
            jx, jnp.asarray(eps), jnp.asarray(rows[:, 0]),
            jnp.asarray(rows[:, 1]), jstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=ATOL)
        for key in ("ets", "cur"):
            np.testing.assert_allclose(tstate[key].numpy(),
                                       np.asarray(jstate[key]), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_array_equal(tstate["count"].numpy(),
                                      np.asarray(jstate["count"]))
    assert tstate["ets"].dtype == torch.float32


@pytest.mark.parametrize("grid,cells", [(1, 4), (2, 4), (3, 2)])
def test_pndm_state_patch_round_trip(grid, cells):
    """``_sampler_state_to_patches`` slices the state exactly as the JAX
    pipeline does, and ``_sampler_state_from_patches`` inverts it."""
    rng = np.random.default_rng(grid)
    h = grid * cells
    state = {"ets": rng.standard_normal((1, 3, h, h, 4)).astype(np.float32),
             "cur": rng.standard_normal((1, h, h, 4)).astype(np.float32),
             "count": np.asarray([2], np.int32)}
    for key, leaf in state.items():
        got = BasePipeline._sampler_state_to_patches(
            torch.from_numpy(leaf), grid, cells)
        want = JaxBasePipeline._sampler_state_to_patches(
            jnp.asarray(leaf), grid, cells)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = BasePipeline._sampler_state_from_patches(got, grid, cells)
        np.testing.assert_array_equal(back.numpy(), leaf)
