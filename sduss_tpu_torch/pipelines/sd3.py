"""SD-3.5 pipeline: CLIP-L + CLIP-G + T5-XXL conditioning, flow matching,
the MMDiT denoiser (counterpart of sduss_tpu/pipelines/sd3.py).

Two DENOISING routes, as in the JAX pipeline:

* dense — one MMDiT forward per resolution group (``BasePipeline``'s
  ``denoise_step``);
* mixed token path — ``denoise_step_mixed``: every request's latent tokens
  right-padded to the sequence bucket and masked in attention, so several
  resolutions share one forward.  The sequence bucket and the batch bucket
  are the JAX package's, so both packages form the same token batch.

The JAX pipeline's token caches, span-skip deep cache, warm-key routing
and fused multi-step dispatch are not ported.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from sduss_tpu_torch.config import bucket_for
from sduss_tpu_torch.pipelines.base import BasePipeline
from sduss_tpu_torch.samplers import gather_coeffs, gather_timesteps


class StableDiffusion3Pipeline(BasePipeline):
    FAMILY = "sd3"

    T5_SEQ_LEN = 256
    # Serving repeats T5 rows constantly (every CFG request re-encodes the
    # same negative prompt); the JAX pipeline keeps an LRU of float16 rows
    # (sd3.py:21-45).  The port keeps the same rows, on the device.
    T5_CACHE_ROWS = 32

    def __init__(self, bundle, config):
        super().__init__(bundle, config)
        self._t5_row_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()

    def _encode_t5(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """T5 features ``(n, 256, d_model)`` in float32, through the row LRU
        (rows stored as float16, exactly as the JAX cache rounds them)."""
        cache = self._t5_row_cache
        keys = [ids[i].tobytes() + mask[i].tobytes() for i in range(ids.shape[0])]
        miss = sorted({i for i, k in enumerate(keys) if k not in cache})
        if miss:
            model = self.bundle.models["text_encoder_3"]
            fresh = model(
                torch.from_numpy(np.asarray(ids[miss], np.int64)).to(self.device),
                attention_mask=torch.from_numpy(
                    np.asarray(mask[miss], np.int64)).to(self.device))
            for j, i in enumerate(miss):
                cache[keys[i]] = fresh[j].to(torch.float16)
                while len(cache) > self.T5_CACHE_ROWS:
                    cache.popitem(last=False)
        out = torch.stack([cache[k] for k in keys]).float()
        for k in keys:  # LRU touch
            cache.move_to_end(k)
        return out

    def encode_conditioning(self, prompts: List[str], negatives: List[str],
                            resolutions: List[int]) -> List[Dict[str, torch.Tensor]]:
        tok1 = self.bundle.tokenizers["tokenizer"]
        tok2 = self.bundle.tokenizers["tokenizer_2"]
        tok3 = self.bundle.tokenizers["tokenizer_3"]
        joint_dim = self.bundle.models["transformer"].cfg.joint_attention_dim
        b = len(prompts)
        # ONE batched pass over prompts + negatives (sd3.py:101-106)
        texts = list(prompts) + list(negatives)
        e1, p1 = self._encode_clip(
            "text_encoder", tok1(texts, max_length=77)["input_ids"],
            penultimate=True)
        e2, p2 = self._encode_clip(
            "text_encoder_2", tok2(texts, max_length=77)["input_ids"],
            penultimate=True)
        t3 = tok3(texts, max_length=self.T5_SEQ_LEN)
        e3 = self._encode_t5(t3["input_ids"], t3["attention_mask"])
        clip = torch.cat([e1, e2], dim=-1).float()
        # CLIP features zero-padded to the T5 width, then joined along the
        # sequence: 77 + 256 = 333 tokens
        clip = torch.nn.functional.pad(clip, (0, joint_dim - clip.shape[-1]))
        embeds = torch.cat([clip, e3], dim=1)
        pooled = torch.cat([p1, p2], dim=-1).float()
        return [{"embeds": embeds[i:i + 1], "neg_embeds": embeds[b + i:b + i + 1],
                 "pooled": pooled[i:i + 1], "neg_pooled": pooled[b + i:b + i + 1]}
                for i in range(b)]

    def denoiser_forward(self, latents_in, t, cond, ctx=None):
        dtype = latents_in.dtype
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        pooled = torch.cat([cond["neg_pooled"], cond["pooled"]], dim=0)
        return self.bundle.models["transformer"](
            latents_in, t, ehs.to(dtype), pooled.to(dtype))

    @torch.inference_mode()
    def denoise_step_mixed(self, reqs_by_res) -> None:
        """ONE MMDiT step over a mixed-resolution padded-token batch
        (sd3.py:139-361 without the cache, deep and warm-key branches).

        Tokens of each request are right-padded to the smallest sequence
        bucket (the token counts of the configured resolutions) that holds
        the longest, the batch is padded to its batch bucket by repeating
        the last row with an all-False token mask, and one
        ``apply_tokens`` forward serves every request.  A single-resolution
        batch takes the dense step (no padding to pay for).
        """
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        if not ordered:
            return
        if len({r.resolution for r in ordered}) <= 1:
            return self.denoise_step(reqs_by_res)
        tr = self.bundle.models["transformer"]
        ps = tr.cfg.patch_size
        dev = self.device
        sc = self.config.scheduler
        lens = [(r.latent_hw(self.vae_scale) // ps) ** 2 for r in ordered]
        seq_buckets = sorted({(res // self.vae_scale // ps) ** 2
                              for res in self.config.model.resolutions})
        s_pad = bucket_for(max(lens), seq_buckets)
        b = len(ordered)
        bb = bucket_for(b, sc.batch_buckets)
        groups = _groups(ordered)

        tables = [r.sampler_table for r in ordered]
        coeffs = torch.from_numpy(gather_coeffs(tables)).to(dev)
        tok_rows = []
        for i, j in groups:
            lat = torch.cat([r.latents for r in ordered[i:j]], dim=0)
            toks = tr.embed_latents(
                self.sampler.scale_model_input(lat, coeffs[i:j, 0]))
            tok_rows.append(torch.nn.functional.pad(
                toks, (0, 0, 0, s_pad - toks.shape[1])))
        tokens = _pad_rows(torch.cat(tok_rows, dim=0), bb)
        mask = np.zeros((bb, s_pad), bool)
        for idx, n in enumerate(lens):
            mask[idx, :n] = True
        t = np.zeros((bb,), np.float32)
        t[:b] = gather_timesteps(tables)
        guidance = np.zeros((bb,), np.float32)
        guidance[:b] = [r.params.guidance_scale if r.params.guidance_scale
                        is not None else self.spec.default_guidance
                        for r in ordered]
        cond = {key: _pad_rows(torch.cat([r.conditioning[key] for r in ordered],
                                         dim=0), bb)
                for key in ordered[0].conditioning}

        out = self._trunk_fn(tokens, torch.from_numpy(mask).to(dev),
                             torch.from_numpy(t).to(dev),
                             torch.from_numpy(guidance).to(dev), cond)
        for i, j in groups:
            hp = ordered[i].latent_hw(self.vae_scale) // ps
            lat = torch.cat([r.latents for r in ordered[i:j]], dim=0)
            v = tr.unpatchify(out[i:j], hp, hp)
            new_lat = self.sampler.step(lat, v.to(lat.dtype), coeffs[i:j, 0],
                                        coeffs[i:j, 1])
            for k, r in enumerate(ordered[i:j]):
                r.latents = new_lat[k:k + 1]
                r.sampler_table.advance()
                r.remain_steps -= 1

    def _trunk_fn(self, tokens, mask, t, guidance, cond):
        """CFG-doubled token forward + guidance combine (sd3.py:802-851)."""
        tr = self.bundle.models["transformer"]
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        pooled = torch.cat([cond["neg_pooled"], cond["pooled"]], dim=0)
        out = tr.apply_tokens(torch.cat([tokens, tokens]), torch.cat([mask, mask]),
                              torch.cat([t, t]), ehs.to(tokens.dtype),
                              pooled.to(tokens.dtype))
        uncond, text = out.chunk(2, dim=0)
        return uncond + guidance.reshape(-1, 1, 1) * (text - uncond)


def _groups(ordered):
    """``[(i, j), ...]``: the runs of equal resolution in ``ordered``."""
    out, i = [], 0
    while i < len(ordered):
        j = i
        while j < len(ordered) and ordered[j].resolution == ordered[i].resolution:
            j += 1
        out.append((i, j))
        i = j
    return out


def _pad_rows(x, rows: int):
    """Pad the leading axis to ``rows`` by repeating the last row, as the
    JAX ``_pad_batch`` does."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])], dim=0)
