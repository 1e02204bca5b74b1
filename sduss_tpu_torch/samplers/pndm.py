"""PNDM (PLMS) sampler, linear multistep over an epsilon history
(counterpart of sduss_tpu/samplers/pndm.py), with ``skip_prk_steps``
semantics, the SD-1.5 serving default:

* model eval 0: a first-order step; the latents are kept as ``cur``;
* model eval 1: the corrector at the same (t0 -> t1) transfer, applying
  (e0 + e1) / 2 from ``cur`` (the schedule repeats its second timestep, so
  a request takes num_steps + 1 model evaluations);
* later evals: the Adams-Bashforth ladder over the last <= 4 epsilons.

Stateful (``needs_state``): each request carries its epsilon history
``ets`` (B, 3, ...), newest first, the corrector base ``cur`` (B, ...) and
a counter ``count`` (B,).  Every update is element-wise in the latent with
per-request scalars, so the state can be sliced into patches like the
latents.  Coefficient rows are ``[alphabar_t, alphabar_prev]``.  Host
tables are numpy and identical to the JAX ``make_table``; the step runs in
float32 and casts back to the latent and state dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from sduss_tpu_torch.samplers.base import (
    Sampler,
    SamplerTable,
    expand_to,
    train_alphas_cumprod,
)


class PNDMSampler(Sampler):
    kind = "pndm"
    needs_state = True

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        steps_offset: int = 1,
        prediction_type: str = "epsilon",
    ) -> None:
        if prediction_type != "epsilon":
            raise NotImplementedError("PNDM supports epsilon prediction only")
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.alphas_cumprod = train_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)
        self.final_alpha_cumprod = float(self.alphas_cumprod[0])

    def _abar(self, t: np.ndarray) -> np.ndarray:
        idx = np.clip(t.astype(np.int64), 0, self.num_train_timesteps - 1)
        return self.alphas_cumprod[idx]

    def make_table(self, num_steps: int) -> SamplerTable:
        ratio = self.num_train_timesteps // num_steps
        asc = (np.arange(num_steps) * ratio).round().astype(np.int64) \
            + self.steps_offset
        desc = asc[::-1].copy()
        if num_steps == 1:
            # no corrector: one first-order transfer to the final alpha-bar
            coeffs = np.asarray(
                [[self._abar(desc[:1])[0], self.final_alpha_cumprod]],
                np.float32)
            return SamplerTable(kind=self.kind,
                                timesteps=desc.astype(np.float32),
                                coeffs=coeffs, init_noise_sigma=1.0)
        # the second entry twice: eval 1 is the corrector at (t0 -> t1)
        ts = np.concatenate([desc[:1], desc[1:2], desc[1:]]).astype(np.float64)
        n_evals = len(ts)  # num_steps + 1
        abar_t = np.empty(n_evals)
        abar_prev = np.empty(n_evals)
        prev_of = np.concatenate([desc[1:], [desc[-1] - ratio]])
        abar_t[0] = abar_t[1] = self._abar(desc[:1])[0]
        abar_prev[0] = abar_prev[1] = self._abar(desc[1:2])[0]
        for i in range(2, n_evals):
            t, pt = desc[i - 1], prev_of[i - 1]
            abar_t[i] = self._abar(np.asarray([t]))[0]
            abar_prev[i] = (self._abar(np.asarray([pt]))[0] if pt >= 0
                            else self.final_alpha_cumprod)
        coeffs = np.stack([abar_t, abar_prev], axis=1).astype(np.float32)
        return SamplerTable(kind=self.kind, timesteps=ts.astype(np.float32),
                            coeffs=coeffs, init_noise_sigma=1.0)

    @staticmethod
    def init_state(latents):
        """eps history (B, 3, ...), corrector base (B, ...), counter (B,)."""
        b = latents.shape[0]
        return {
            "ets": latents.new_zeros((b, 3) + tuple(latents.shape[1:])),
            "cur": torch.zeros_like(latents),
            "count": torch.zeros(b, dtype=torch.int32, device=latents.device),
        }

    @staticmethod
    def scale_model_input(x, coeff_t):
        return x  # PNDM does not scale the model input

    @staticmethod
    def step_with_state(x, model_out, coeff_t, coeff_next, state):
        xf = x.float()
        e_now = model_out.float()
        ets = state["ets"].float()  # newest first
        cur = state["cur"].float()
        count = state["count"]
        h0, h1, h2 = ets[:, 0], ets[:, 1], ets[:, 2]
        c = expand_to(count, xf.dim())
        eps = torch.where(
            c == 0, e_now, torch.where(
                c == 1, (e_now + h0) / 2.0, torch.where(
                    c == 2, (3.0 * e_now - h0) / 2.0, torch.where(
                        c == 3, (23.0 * e_now - 16.0 * h0 + 5.0 * h1) / 12.0,
                        (55.0 * e_now - 59.0 * h0 + 37.0 * h1 - 9.0 * h2)
                        / 24.0))))
        # eval 1 re-applies the (t0 -> t1) transfer from the stored sample
        base = torch.where(c == 1, cur, xf)
        abar_t = expand_to(coeff_t.float(), xf.dim())
        abar_prev = expand_to(coeff_next.float(), xf.dim())
        x0 = (base - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
        x_prev = torch.sqrt(abar_prev) * x0 + torch.sqrt(1.0 - abar_prev) * eps
        # the history is not pushed on the corrector eval (count == 1)
        shifted = torch.cat([e_now[:, None], ets[:, :2]], dim=1)
        push = expand_to(count != 1, ets.dim())
        new_state = {
            "ets": torch.where(push, shifted, ets).to(state["ets"].dtype),
            "cur": torch.where(c == 0, xf, cur).to(state["cur"].dtype),
            "count": count + 1,
        }
        return x_prev.to(x.dtype), new_state
