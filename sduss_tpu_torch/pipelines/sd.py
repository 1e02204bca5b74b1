"""SD-1.5 pipeline: CLIP-L conditioning, the conv-projection UNet
(counterpart of sduss_tpu/pipelines/sd.py)."""

from __future__ import annotations

from typing import Dict, List

import torch

from sduss_tpu_torch.pipelines.base import _PAD, BasePipeline


class StableDiffusionPipeline(BasePipeline):
    FAMILY = "sd15"

    def encode_conditioning(self, prompts: List[str], negatives: List[str],
                            resolutions: List[int]) -> List[Dict[str, torch.Tensor]]:
        tok = self.bundle.tokenizers["tokenizer"]
        # the last hidden state of CLIP-L; no pooled output, no time ids
        emb, _ = self._encode_clip("text_encoder",
                                   tok(prompts, max_length=77, **_PAD)["input_ids"],
                                   penultimate=False)
        nemb, _ = self._encode_clip("text_encoder",
                                    tok(negatives, max_length=77, **_PAD)["input_ids"],
                                    penultimate=False)
        return [{"embeds": emb[i:i + 1], "neg_embeds": nemb[i:i + 1]}
                for i in range(len(prompts))]

    def denoiser_forward(self, latents_in, t, cond, ctx=None, **deep):
        # CFG rows: [uncond, cond]
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        return self.denoiser(
            latents_in, t, ehs.to(latents_in.dtype), ctx=ctx,
            deep_boundary=self.config.cache.deep_boundary, **deep)
