"""DDIM sampler, eta = 0 (counterpart of sduss_tpu/samplers/ddim.py).

The deterministic single-step member of the PNDM family, for SD-1.5.
Coefficient rows are ``[alphabar_t, alphabar_prev]``: the whole transfer
of step i.  Host tables are numpy and identical to the JAX ``make_table``;
the step runs on tensors in float32 and casts back to the latent dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from sduss_tpu_torch.samplers.base import (
    Sampler,
    SamplerTable,
    expand_to,
    leading_timesteps,
    train_alphas_cumprod,
)


class DDIMSampler(Sampler):
    kind = "ddim"

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        steps_offset: int = 1,
        set_alpha_to_one: bool = False,
        prediction_type: str = "epsilon",
    ) -> None:
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.prediction_type = prediction_type
        self.alphas_cumprod = train_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)
        self.final_alpha_cumprod = (1.0 if set_alpha_to_one
                                    else float(self.alphas_cumprod[0]))

    def make_table(self, num_steps: int) -> SamplerTable:
        ts = leading_timesteps(num_steps, self.num_train_timesteps,
                               self.steps_offset)
        # leading spacing + steps_offset can reach num_train_timesteps
        idx = np.clip(ts.astype(np.int64), 0, len(self.alphas_cumprod) - 1)
        ab = self.alphas_cumprod[idx]
        ab_prev = np.concatenate([ab[1:], [self.final_alpha_cumprod]])
        coeffs = np.stack([ab, ab_prev], axis=1).astype(np.float32)
        return SamplerTable(kind=self.kind, timesteps=ts.astype(np.float32),
                            coeffs=coeffs, init_noise_sigma=1.0,
                            prediction_type=self.prediction_type)

    @staticmethod
    def scale_model_input(x, coeff_t):
        return x

    def step(self, x, model_out, coeff_t, coeff_next,
             prediction_type: str = None):
        prediction_type = prediction_type or self.prediction_type
        xf = x.float()
        ef = model_out.float()
        ab_t = expand_to(coeff_t.float(), x.dim())
        ab_prev = expand_to(coeff_next.float(), x.dim())
        if prediction_type == "epsilon":
            pred_x0 = (xf - torch.sqrt(1.0 - ab_t) * ef) / torch.sqrt(ab_t)
            eps = ef
        elif prediction_type == "v_prediction":
            pred_x0 = torch.sqrt(ab_t) * xf - torch.sqrt(1.0 - ab_t) * ef
            eps = torch.sqrt(ab_t) * ef + torch.sqrt(1.0 - ab_t) * xf
        else:
            raise ValueError(prediction_type)
        prev = torch.sqrt(ab_prev) * pred_x0 + torch.sqrt(1.0 - ab_prev) * eps
        return prev.to(x.dtype)
