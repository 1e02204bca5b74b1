"""Request model: sampling params, lifecycle state machine, outputs.

Collapses the reference's three request wrappers (dispatcher/wrappers.py:14-98
engine Request, worker/wrappers.py:16-183 WorkerRequest,
worker/runner/wrappers.py:19-70 RunnerRequest) into ONE object — possible
because the design is single-controller: there are no process boundaries
to serialize across, so the engine-, scheduler- and device-facing state live
together.  The PyTorch port's own copy of the JAX package's request model.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class SamplingParams:
    """Per-request generation parameters (reference sampling_params.py:12-101)."""

    prompt: str
    negative_prompt: str = ""
    resolution: int = 512  # square images; height == width == resolution
    num_inference_steps: int = 50
    guidance_scale: Optional[float] = None  # None => family default
    seed: Optional[int] = None
    output_type: str = "np"  # "np" | "pil" | "latent"

    def __post_init__(self) -> None:
        if self.resolution % 64 != 0:
            raise ValueError(f"resolution must be a multiple of 64, got {self.resolution}")
        if self.num_inference_steps < 1:
            raise ValueError("num_inference_steps must be >= 1")


class Stage(enum.Enum):
    """Three-stage lifecycle (reference worker/wrappers.py:16-28)."""

    WAITING = "waiting"          # not yet admitted to a replica
    PREPARE = "prepare"          # needs text encode + latent init
    PREPARING = "preparing"      # prepare running on a background host thread
    DENOISING = "denoising"      # needs remain_steps more denoiser steps
    POSTPROCESSING = "post"      # needs VAE decode
    DECODING = "decoding"        # decode running on a background host thread
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclasses.dataclass
class Request:
    request_id: str
    params: SamplingParams
    arrival_time: float = dataclasses.field(default_factory=time.time)
    # SLO deadline (absolute seconds) for ESyMReD admission; None => best effort.
    deadline: Optional[float] = None

    stage: Stage = Stage.WAITING
    dp_rank: Optional[int] = None

    # Denoising progress.
    remain_steps: int = 0
    sampler_table: Any = None  # samplers.base.SamplerTable
    sampler_state: Any = None  # device pytree for stateful samplers (PNDM)

    # Device-side state (host references to device tensors).
    latents: Any = None            # (1, h, w, C)
    conditioning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Block-cache rows: key -> {inp,out,hits}
    # with leading dim 2*n_patches (uncond rows then cond rows).
    cache_rows: Optional[Dict[str, Any]] = None
    # Deep-reuse feature (cache mode "deep"): (2, h', w', C) [uncond, cond]
    # and steps since the last full pass.
    deep_state: Any = None
    deep_age: int = 0
    # Reuse-then-predict (CacheConfig.deep_predict): per-step deep-feature
    # velocity between the last two full passes, same shape as deep_state
    # (float32); None until two same-layout full passes have run.
    deep_slope: Any = None
    # Adaptive deep refresh (CacheConfig.deep_adaptive): latent at the last
    # full pass, pending on-device drift scalars (oldest first), and the
    # most recent fetched drift value.
    lat_ref: Any = None
    drift_pending: list = dataclasses.field(default_factory=list)
    drift_last: float = 0.0

    # Latency-predictor bookkeeping (ESyMReD, reference wrappers.py:108-155).
    predicted_step_ms: float = 0.0
    start_denoising_time: Optional[float] = None

    # Timings + result.
    first_scheduled_time: Optional[float] = None
    finish_time: Optional[float] = None
    output: Any = None
    error: Optional[str] = None
    nsfw_flagged: bool = False

    def __post_init__(self) -> None:
        self.remain_steps = self.params.num_inference_steps

    @property
    def resolution(self) -> int:
        return self.params.resolution

    @property
    def finished(self) -> bool:
        return self.stage in (Stage.FINISHED, Stage.ABORTED)

    def latent_hw(self, vae_scale: int = 8) -> int:
        return self.params.resolution // vae_scale

    def slack_s(self, now: float, post_time_s: float) -> float:
        """Seconds of slack against the deadline, given predicted remaining work."""
        if self.deadline is None:
            return float("inf")
        remaining = self.remain_steps * self.predicted_step_ms / 1000.0 + post_time_s
        return self.deadline - now - remaining


@dataclasses.dataclass
class RequestOutput:
    """Final per-request result (reference entrypoints/wrappers.py:8-42)."""

    request_id: str
    prompt: str
    resolution: int
    finished: bool
    aborted: bool = False
    image: Optional[np.ndarray] = None  # (H, W, 3) uint8
    nsfw_flagged: bool = False
    error: Optional[str] = None
    arrival_time: float = 0.0
    finish_time: float = 0.0
    first_scheduled_time: Optional[float] = None

    @property
    def e2e_latency_s(self) -> float:
        return self.finish_time - self.arrival_time

    @classmethod
    def from_request(cls, req: Request) -> "RequestOutput":
        image = req.output
        if req.params.output_type == "pil" and image is not None \
                and image.ndim == 3:
            try:
                from PIL import Image

                image = Image.fromarray(image)
            except ImportError:  # pragma: no cover
                pass
        return cls(
            request_id=req.request_id,
            prompt=req.params.prompt,
            resolution=req.resolution,
            finished=req.stage == Stage.FINISHED,
            aborted=req.stage == Stage.ABORTED,
            image=image,
            nsfw_flagged=req.nsfw_flagged,
            error=req.error,
            arrival_time=req.arrival_time,
            finish_time=req.finish_time or time.time(),
            first_scheduled_time=req.first_scheduled_time,
        )
