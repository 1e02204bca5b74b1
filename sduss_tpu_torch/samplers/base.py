"""Per-request sampler tables (counterpart of sduss_tpu/samplers/base.py).

Schedule state is split as in the JAX package: a host-side numpy
``SamplerTable`` per request (timesteps and ``[coeff_t, coeff_next]`` rows,
plus the current step index), and step math on device tensors that
consumes only per-sample coefficient rows, so requests at different
timesteps share one model forward.  A stateful sampler (PNDM's epsilon
history) also keeps a per-request dict of device tensors, threaded through
``step_with_state`` like the latents (the ``needs_state`` protocol).  The
tables are copied rather than imported: ``sduss_tpu.samplers`` imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class SamplerTable:
    """Host-side schedule for one request.

    ``coeffs`` (num_steps, 2): row i holds ``[coeff_t, coeff_next]`` for step
    i (sigma_t / sigma_next for Euler).  ``timesteps`` (num_steps,): the
    value fed to the model's time embedding at each step.
    """

    kind: str
    timesteps: np.ndarray
    coeffs: np.ndarray
    init_noise_sigma: float
    step: int = 0
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @property
    def done(self) -> bool:
        return self.step >= self.num_steps

    def current_timestep(self) -> float:
        return float(self.timesteps[self.step])

    def current_coeffs(self) -> np.ndarray:
        return self.coeffs[self.step]

    def advance(self) -> None:
        if self.done:
            raise RuntimeError("sampler table already exhausted")
        self.step += 1


class Sampler:
    """Family interface: ``make_table(num_steps)`` (the host table of one
    request), ``scale_model_input(x, coeff_t)`` and the step math.

    Stateless samplers implement ``step(x, model_out, coeff_t,
    coeff_next)``.  A sampler with ``needs_state`` instead implements
    ``init_state(latents)`` (a dict of tensors whose rows are the batch
    rows) and ``step_with_state(x, model_out, coeff_t, coeff_next, state)
    -> (x_next, new_state)``.
    """

    kind: str = "base"
    needs_state: bool = False


def gather_timesteps(tables: Sequence[SamplerTable]) -> np.ndarray:
    """(B,) float32 model-timestep values for a batch of requests."""
    return np.asarray([t.current_timestep() for t in tables], dtype=np.float32)


def gather_coeffs(tables: Sequence[SamplerTable]) -> np.ndarray:
    """(B, 2) float32 ``[coeff_t, coeff_next]`` rows for a batch."""
    out = np.empty((len(tables), 2), dtype=np.float32)
    for i, t in enumerate(tables):
        out[i] = t.current_coeffs()[:2]
    return out


def expand_to(x, ndim: int):
    """Reshape a (B,) coefficient vector to (B, 1, 1, ...) for broadcasting."""
    return x.reshape(x.shape[0], *([1] * (ndim - 1)))


def train_alphas_cumprod(num_train_timesteps: int, beta_start: float,
                         beta_end: float, beta_schedule: str) -> np.ndarray:
    """float64 cumulative products of 1 - beta over the training steps."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    return np.cumprod(1.0 - betas)


def leading_timesteps(num_steps: int, num_train_timesteps: int, steps_offset: int) -> np.ndarray:
    """'leading' timestep spacing (descending), as used by SD/SDXL configs."""
    ratio = num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].copy().astype(np.float32)
    return ts + steps_offset


def linspace_timesteps(num_steps: int, num_train_timesteps: int) -> np.ndarray:
    return np.linspace(0, num_train_timesteps - 1, num_steps, dtype=np.float32)[::-1].copy()


def trailing_timesteps(num_steps: int, num_train_timesteps: int) -> np.ndarray:
    ratio = num_train_timesteps / num_steps
    ts = np.arange(num_train_timesteps, 0, -ratio).round().astype(np.float32) - 1
    return ts
