"""Euler discrete sampling (k-diffusion form of diffusers'
``EulerDiscreteScheduler``): the schedule of a configuration's
``scheduler`` group and the float32 step."""

from __future__ import annotations

import numpy as np
import torch


def schedule(cfg: dict, steps: int):
    """``(timesteps (steps,), sigmas (steps + 1,), init_noise_sigma)``:
    ``scaled_linear`` betas, ``leading`` spacing with ``steps_offset``."""
    n = cfg["num_train_timesteps"]
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    train_sigmas = np.sqrt((1.0 - abar) / abar)
    if cfg["timestep_spacing"] != "leading":
        raise ValueError(cfg["timestep_spacing"])
    ratio = n // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.float32) \
        + cfg["steps_offset"]
    sig = np.interp(ts, np.arange(n), train_sigmas)
    sig = np.concatenate([sig, [0.0]]).astype(np.float32)
    return ts, sig, float((sig.max() ** 2 + 1) ** 0.5)


def scale_input(x, sigma: float):
    return x.float() / (sigma ** 2 + 1.0) ** 0.5


def step(x, eps, sigma: float, sigma_next: float):
    """x_next = x + eps (sigma_next - sigma), in float32."""
    return x.float() + eps.float() * (sigma_next - sigma)


def initial_latents(seed: int, hw: int, channels: int, sigma0: float):
    """The request's starting noise: numpy's ``default_rng(seed)`` standard
    normals ``(1, hw, hw, C)`` times the initial sigma."""
    noise = np.random.default_rng(seed).standard_normal(
        (1, hw, hw, channels), dtype=np.float32)
    return torch.from_numpy(noise * sigma0)
