"""Sampler registry: Euler (SD-1.5's and SDXL's default), flow-matching
Euler (SD-3.5), DDIM and the stateful PNDM (SD-1.5)."""

from __future__ import annotations

from typing import Any

from sduss_tpu_torch.samplers.base import (  # noqa: F401
    Sampler,
    SamplerTable,
    gather_coeffs,
    gather_timesteps,
)
from sduss_tpu_torch.samplers.ddim import DDIMSampler
from sduss_tpu_torch.samplers.euler import EulerDiscreteSampler
from sduss_tpu_torch.samplers.flow_match import FlowMatchEulerSampler
from sduss_tpu_torch.samplers.pndm import PNDMSampler

_REGISTRY = {"euler": EulerDiscreteSampler,
             "flow_match": FlowMatchEulerSampler,
             "ddim": DDIMSampler,
             "pndm": PNDMSampler}


def get_sampler(name: str, **kwargs: Any) -> Sampler:
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; ported: {sorted(_REGISTRY)}") from None
