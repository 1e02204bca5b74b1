"""Euler-discrete sampler (counterpart of sduss_tpu/samplers/euler.py).

Host tables are numpy and identical to the JAX ``make_table``; the step
math runs on tensors in float32 and casts back to the latent dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from sduss_tpu_torch.samplers.base import (
    Sampler,
    SamplerTable,
    expand_to,
    leading_timesteps,
    linspace_timesteps,
    trailing_timesteps,
    train_alphas_cumprod,
)


class EulerDiscreteSampler(Sampler):
    kind = "euler"

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "epsilon",
        timestep_spacing: str = "leading",
        steps_offset: int = 1,
    ) -> None:
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        alphas_cumprod = train_alphas_cumprod(num_train_timesteps, beta_start,
                                              beta_end, beta_schedule)
        # sigma_t = sqrt((1 - abar_t) / abar_t): the EDM-style noise level.
        self.train_sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

    def make_table(self, num_steps: int) -> SamplerTable:
        if self.timestep_spacing == "leading":
            ts = leading_timesteps(num_steps, self.num_train_timesteps, self.steps_offset)
        elif self.timestep_spacing == "linspace":
            ts = linspace_timesteps(num_steps, self.num_train_timesteps)
        elif self.timestep_spacing == "trailing":
            ts = trailing_timesteps(num_steps, self.num_train_timesteps)
        else:
            raise NotImplementedError(self.timestep_spacing)
        sigmas = np.interp(ts, np.arange(self.num_train_timesteps), self.train_sigmas)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        coeffs = np.stack([sigmas[:-1], sigmas[1:]], axis=1)
        if self.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = float(sigmas.max())
        else:
            init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
        return SamplerTable(kind=self.kind, timesteps=ts.astype(np.float32),
                            coeffs=coeffs, init_noise_sigma=init_noise_sigma,
                            prediction_type=self.prediction_type)

    @staticmethod
    def scale_model_input(x, coeff_t):
        sigma = expand_to(coeff_t.float(), x.dim())
        return (x.float() / torch.sqrt(sigma**2 + 1.0)).to(x.dtype)

    def step(self, x, model_out, coeff_t, coeff_next, prediction_type: str = None):
        prediction_type = prediction_type or self.prediction_type
        xf = x.float()
        ef = model_out.float()
        sigma = expand_to(coeff_t.float(), x.dim())
        sigma_next = expand_to(coeff_next.float(), x.dim())
        if prediction_type == "epsilon":
            pred_x0 = xf - sigma * ef
        elif prediction_type == "v_prediction":
            pred_x0 = ef * (-sigma / torch.sqrt(sigma**2 + 1.0)) + xf / (sigma**2 + 1.0)
        elif prediction_type == "sample":
            pred_x0 = ef
        else:
            raise ValueError(prediction_type)
        derivative = (xf - pred_x0) / sigma
        return (xf + derivative * (sigma_next - sigma)).to(x.dtype)
