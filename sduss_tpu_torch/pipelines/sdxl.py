"""SDXL pipeline: dual CLIP conditioning + text_time added embeddings
(counterpart of sduss_tpu/pipelines/sdxl.py)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sduss_tpu_torch.pipelines.base import _PAD, BasePipeline


class StableDiffusionXLPipeline(BasePipeline):
    FAMILY = "sdxl"

    def encode_conditioning(self, prompts: List[str], negatives: List[str],
                            resolutions: List[int]) -> List[Dict[str, torch.Tensor]]:
        tok1 = self.bundle.tokenizers["tokenizer"]
        tok2 = self.bundle.tokenizers["tokenizer_2"]

        def enc(texts):
            ids1 = tok1(texts, max_length=77, **_PAD)["input_ids"]
            ids2 = tok2(texts, max_length=77, **_PAD)["input_ids"]
            # penultimate hidden states of both encoders; pooled from enc 2
            e1, _ = self._encode_clip("text_encoder", ids1, penultimate=True)
            e2, pooled = self._encode_clip("text_encoder_2", ids2,
                                           penultimate=True)
            return torch.cat([e1, e2], dim=-1), pooled

        emb, pooled = enc(prompts)
        nemb, npooled = enc(negatives)
        conds = []
        for i, res in enumerate(resolutions):
            r = float(res)
            # (original_size, crop_top_left, target_size) per SDXL conditioning
            time_ids = torch.from_numpy(
                np.asarray([[r, r, 0.0, 0.0, r, r]], np.float32)).to(self.device)
            conds.append({
                "embeds": emb[i:i + 1],
                "neg_embeds": nemb[i:i + 1],
                "pooled": pooled[i:i + 1],
                "neg_pooled": npooled[i:i + 1],
                "time_ids": time_ids,
            })
        return conds

    def denoiser_forward(self, latents_in, t, cond, ctx=None, **deep):
        dtype = latents_in.dtype
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        pooled = torch.cat([cond["neg_pooled"], cond["pooled"]], dim=0)
        time_ids = torch.cat([cond["time_ids"], cond["time_ids"]], dim=0)
        added = {"text_embeds": pooled.to(dtype), "time_ids": time_ids}
        return self.denoiser(
            latents_in, t, ehs.to(dtype), added_cond=added, ctx=ctx,
            deep_boundary=self.config.cache.deep_boundary, **deep)
