"""Offline batch API (counterpart of sduss_tpu/entrypoints/offline.py)."""

from __future__ import annotations

import uuid
from typing import List, Optional, Sequence, Union

import torch

from sduss_tpu_torch.config import Config, ModelConfig
from sduss_tpu_torch.request import RequestOutput, SamplingParams
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.models.registry import ModelBundle


def default_config(model: str = "sd15", **model_kwargs) -> Config:
    """The JAX package's defaults: the ``fcfs_mixed`` policy with
    mixed-resolution denoise batches (SDXL: the patch path; SD3: the
    padded-token path), and for full-size SD3 the tiled VAE decode."""
    config = Config()
    config.model = ModelConfig(model=model, **model_kwargs)
    return config


class DiffusionPipeline:
    """Synchronous offline generation driving the full engine stack.

    ``device`` defaults to ``"cuda"`` and must exist: a missing GPU raises,
    the port never carries on on the CPU unasked.  ``bundle`` serves given
    weights (e.g. the JAX package's, through ``ModelBundle.load_state_dicts``)
    instead of seeded random ones.
    """

    def __init__(self, model: str = "sd15", *, config: Optional[Config] = None,
                 device: torch.device | str = "cuda",
                 bundle: Optional[ModelBundle] = None, **kwargs):
        if config is None:
            # the JAX entry point's keywords (dp: replicas on cuda:0..dp-1,
            # or all on the CPU)
            config = default_config(model, **{
                k: v for k, v in kwargs.items()
                if k in ("model_path", "dtype", "seed", "test_tiny",
                         "use_patched")})
            if "policy" in kwargs:
                config.scheduler.policy = kwargs["policy"]
            if "max_batch_size" in kwargs:
                config.scheduler.max_batch_size = kwargs["max_batch_size"]
            if "dp" in kwargs:
                config.parallel.dp = kwargs["dp"]
        self.config = config
        self.engine = Engine(config, device, bundle=bundle)

    def generate(
        self,
        prompts: Union[str, Sequence[str]],
        negative_prompt: str = "",
        resolution: Union[int, Sequence[int]] = 512,
        num_inference_steps: int = 50,
        guidance_scale: Optional[float] = None,
        seed: Optional[int] = None,
        output_type: str = "np",
    ) -> List[RequestOutput]:
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(resolution, int):
            resolution = [resolution] * len(prompts)
        order: dict = {}
        for i, (p, res) in enumerate(zip(prompts, resolution)):
            rid = f"offline-{uuid.uuid4().hex[:8]}-{i}"
            order[rid] = i
            self.engine.add_request(
                rid,
                SamplingParams(
                    prompt=p, negative_prompt=negative_prompt, resolution=res,
                    num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale,
                    seed=None if seed is None else seed + i,
                    output_type=output_type))
        outputs: List[RequestOutput] = []
        while self.engine.has_unfinished_requests():
            outputs.extend(self.engine.step())
        # results in PROMPT order
        outputs.sort(key=lambda o: order.get(o.request_id, len(order)))
        if self.config.engine.collect_data:
            self.engine.dump_data()
        return outputs
