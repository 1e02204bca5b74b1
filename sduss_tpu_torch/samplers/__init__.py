"""Sampler registry (the port carries the Euler sampler of SDXL and the
flow-matching Euler sampler of SD-3.5)."""

from __future__ import annotations

from typing import Any

from sduss_tpu_torch.samplers.base import (  # noqa: F401
    SamplerTable,
    gather_coeffs,
    gather_timesteps,
)
from sduss_tpu_torch.samplers.euler import EulerDiscreteSampler
from sduss_tpu_torch.samplers.flow_match import FlowMatchEulerSampler

_REGISTRY = {"euler": EulerDiscreteSampler,
             "flow_match": FlowMatchEulerSampler}


def get_sampler(name: str, **kwargs: Any):
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; ported: {sorted(_REGISTRY)}") from None
