"""Flow-matching Euler sampler (counterpart of
sduss_tpu/samplers/flow_match.py), the SD-3.5 rectified-flow schedule.

Sigmas run from 1 to 1/N with the resolution-independent shift
``sigma' = shift*s / (1 + (shift-1)*s)``; a step is
``x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v``.  The model input is not
scaled and the initial latent is pure noise (``init_noise_sigma = 1``).
Host tables are numpy and identical to the JAX ``make_table``; the step
runs on tensors in float32 and casts back to the latent dtype.
"""

from __future__ import annotations

import numpy as np

from sduss_tpu_torch.samplers.base import Sampler, SamplerTable, expand_to


class FlowMatchEulerSampler(Sampler):
    kind = "flow_match"

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 3.0) -> None:
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift

    def _shift(self, s: np.ndarray) -> np.ndarray:
        return self.shift * s / (1.0 + (self.shift - 1.0) * s)

    def make_table(self, num_steps: int) -> SamplerTable:
        n = self.num_train_timesteps
        # the unshifted grid: num_steps points over [1, 1/n] in t/n units
        t = np.linspace(n, n / num_steps, num_steps, dtype=np.float64)
        sigmas = self._shift(t / n)
        timesteps = (sigmas * n).astype(np.float32)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        coeffs = np.stack([sigmas[:-1], sigmas[1:]], axis=1)
        return SamplerTable(kind=self.kind, timesteps=timesteps,
                            coeffs=coeffs, init_noise_sigma=1.0)

    @staticmethod
    def scale_model_input(x, coeff_t):
        return x

    @staticmethod
    def step(x, model_out, coeff_t, coeff_next):
        sigma = expand_to(coeff_t.float(), x.dim())
        sigma_next = expand_to(coeff_next.float(), x.dim())
        return (x.float() + (sigma_next - sigma) * model_out.float()).to(x.dtype)
