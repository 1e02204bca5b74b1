"""The port's Euler and flow-matching Euler samplers against
sduss_tpu.samplers.euler and sduss_tpu.samplers.flow_match.

Tables are numpy in both packages and must be identical; the step math
runs in float32 (RTOL 2e-4, ATOL 5e-4, the float32 bound of the other
parity tests).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.samplers import base as jbase
from sduss_tpu.samplers.euler import EulerDiscreteSampler as JaxEuler
from sduss_tpu.samplers.flow_match import FlowMatchEulerSampler as JaxFlow
from sduss_tpu_torch.samplers import base as tbase
from sduss_tpu_torch.samplers import get_sampler

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
