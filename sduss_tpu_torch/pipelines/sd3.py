"""SD-3.5 pipeline: CLIP-L + CLIP-G + T5-XXL conditioning, flow matching,
the MMDiT denoiser (counterpart of sduss_tpu/pipelines/sd3.py).

Two DENOISING routes, as in the JAX pipeline:

* dense — one MMDiT forward per resolution group (``BasePipeline``'s
  ``denoise_step``), cache-off only;
* token path — ``denoise_step_mixed``: every request's latent tokens
  right-padded to the sequence bucket and masked in attention, so several
  resolutions share one forward.  The sequence bucket and the batch bucket
  are the JAX package's, so both packages form the same token batch.

The MMDiT's caches run only on the token path, so with one on every batch
takes it, a uniform one too (``denoise_step``):

* the span-skip deep cache (``CacheConfig.sd3_deep_span``, the
  ``CacheConfig.production("sd3")`` preset): each step is full or shallow
  for the whole batch (full while there is no delta, at the interval or
  in any request's warmup); a shallow step skips the span's blocks and
  splices the last full step's residual delta, extrapolated with
  ``deep_predict``;
* the token caches (``mode`` "block", "compact", and the per-token fine
  gate at ``patch_fraction < 1`` with its stale K/V, ``fine_stale_kv``).

Their device state lives in a store keyed by the batch composition
(``_sd3_state``): a stable batch reuses its entry, any change starts a
fresh one (so an admission or a finish costs one full step), and the
pipeline frees a finished request's entries.  The JAX pipeline's warm-key
routing (compile keys) and fused multi-step dispatch are not ported.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import bucket_for
from sduss_tpu_torch.pipelines.base import _PAD, BasePipeline, _state_nbytes
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
        # the token caches' and the span cache's state, per batch
        # composition: (s_pad, bb, request ids, mode signature) -> entry
        self._sd3_state: OrderedDict = OrderedDict()

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
            "text_encoder", tok1(texts, max_length=77, **_PAD)["input_ids"],
            penultimate=True)
        e2, p2 = self._encode_clip(
            "text_encoder_2", tok2(texts, max_length=77, **_PAD)["input_ids"],
            penultimate=True)
        t3 = tok3(texts, max_length=self.T5_SEQ_LEN, **_PAD)
        e3 = self._encode_t5(np.asarray(t3["input_ids"]),
                             np.asarray(t3["attention_mask"]))
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
    def denoise_step(self, reqs_by_res) -> None:
        """With a token cache or the span cache on, uniform batches take the
        token path too (sd3.py:126-137): it holds the MMDiT's only cached
        trunk, and the dense step would run them cache-off."""
        if (self._sd3_cache() is not None
                or self._sd3_deep_span() is not None) and not (
                self.sampler.needs_state and self.config.cache.enabled):
            return self.denoise_step_mixed(reqs_by_res)
        return super().denoise_step(reqs_by_res)

    @torch.inference_mode()
    def denoise_step_mixed(self, reqs_by_res) -> None:
        """ONE MMDiT step over a padded-token batch (sd3.py:139-361 without
        the warm-key routing).

        Tokens of each request are right-padded to the smallest sequence
        bucket (the token counts of the configured resolutions) that holds
        the longest, the batch is padded to its batch bucket by repeating
        the last row with an all-False token mask, and one
        ``apply_tokens`` forward serves every request.  A single-resolution
        batch with no cache takes the dense step (no padding to pay for).
        With a cache the composition's entry of ``_sd3_state`` carries the
        token-cache rows and the span delta; the step's deep mode is
        ``_sd3_deep_mode``'s.
        """
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        if not ordered:
            return
        cache, span = self._sd3_cache(), self._sd3_deep_span()
        if (len({r.resolution for r in ordered}) <= 1 and cache is None
                and span is None):
            return self.denoise_step(reqs_by_res)
        tr = self.bundle.models["transformer"]
        ps = tr.cfg.patch_size
        dev = self.device
        sc, cc = self.config.scheduler, self.config.cache
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

        kw = {}
        entry = deep_mode = None
        fine = (cache is not None and cc.mode == "compact"
                and cc.patch_fraction < 1.0)
        if cache is not None or span is not None:
            entry = self._sd3_state_entry(ordered, bb, s_pad, cache)
        if cache is not None:
            row_valid = torch.zeros(bb, dtype=torch.bool, device=dev)
            row_valid[:b] = True
            # the stale K/V rows are valid once the composition's state has
            # been through a step that computes K/V in full; the compact
            # rows, once a step at full capacity has anchored them
            kw.update(cache=cache, cache_state=entry["state"],
                      row_valid=row_valid,
                      fine_kv_stale=fine and cc.fine_stale_kv
                      and entry["kv_ok"],
                      compact_sync=(cc.mode == "compact" and not fine
                                    and not entry["anchored"]))
        if span is not None:
            deep_mode = self._sd3_deep_mode(entry, ordered)
            kw.update(deep_mode=deep_mode, deep_span=span,
                      deep_state=(self._sd3_deep_predicted(entry)
                                  if deep_mode == "shallow" else None))
        out, deep_out = self._trunk_fn(
            tokens, torch.from_numpy(mask).to(dev),
            torch.from_numpy(t).to(dev), torch.from_numpy(guidance).to(dev),
            cond, **kw)
        if cache is not None:
            entry["anchored"] = True
            entry["kv_ok"] = fine and cc.fine_stale_kv
        if deep_mode == "full":
            self._sd3_deep_update_slope(entry, deep_out)
            entry["deep"], entry["deep_age"] = deep_out, 0
        elif deep_mode == "shallow":
            entry["deep_age"] += 1

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

    def _trunk_fn(self, tokens, mask, t, guidance, cond, row_valid=None,
                  **kw):
        """CFG-doubled token forward (rows ``[uncond x bb | cond x bb]``) +
        guidance combine (sd3.py:802-851).  ``kw`` are ``apply_tokens``'s
        cache and deep arguments.  Returns ``(combined, deep_out)``;
        ``deep_out`` None without ``deep_mode``."""
        tr = self.bundle.models["transformer"]
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        pooled = torch.cat([cond["neg_pooled"], cond["pooled"]], dim=0)
        if row_valid is not None:
            kw["row_valid"] = torch.cat([row_valid, row_valid])
        out = tr.apply_tokens(torch.cat([tokens, tokens]),
                              torch.cat([mask, mask]), torch.cat([t, t]),
                              ehs.to(tokens.dtype), pooled.to(tokens.dtype),
                              **kw)
        out, deep_out = out if kw.get("deep_mode") else (out, None)
        uncond, text = out.chunk(2, dim=0)
        return uncond + guidance.reshape(-1, 1, 1) * (text - uncond), deep_out

    # -- the caches' state ---------------------------------------------------

    def _sd3_cache(self):
        """The token caches' gates (modes "block" and "compact"), or None."""
        cfg = self.config.cache
        if not cfg.enabled or cfg.mode not in ("block", "compact"):
            return None
        if self._cache_obj is None:
            self._cache_obj = BlockCache(cfg)
        return self._cache_obj

    def _sd3_deep_span(self):
        """``(lo, hi)`` of the span-skip deep cache, or None.  Scheduling
        reuses ``deep_interval``/``deep_warmup``; it composes with the
        token gates or runs alone.  Mode "deep" without a span mints no
        cache at all (as in JAX)."""
        cc = self.config.cache
        if not cc.enabled or cc.sd3_deep_span is None:
            return None
        return tuple(cc.sd3_deep_span)

    def _sd3_deep_mode(self, entry, ordered) -> str:
        """One mode per batch per step (sd3.py:285-293): full when the
        entry has no delta (fresh or reset composition), the delta is
        ``deep_interval - 1`` steps old or any request is in its
        ``deep_warmup`` steps; shallow otherwise."""
        cc = self.config.cache
        need_full = (entry["deep"] is None
                     or entry["deep_age"] >= max(cc.deep_interval, 1) - 1
                     or any(r.sampler_table.step < cc.deep_warmup
                            for r in ordered))
        return "full" if need_full else "shallow"

    def _sd3_state_entry(self, ordered, bb: int, s_pad: int, cache) -> dict:
        """The composition's entry (sd3.py:600-680): ``{"state", "kv_ok",
        "anchored", "deep", "deep_age", "deep_slope"}``, keyed by ``(s_pad,
        bb, request ids, mode signature)``.  A new entry holds fresh rows:
        CFG-doubled ``[uncond x bb | cond x bb]``, zeros with hits at
        ``max_hits`` (so the first gate recomputes them), and no delta.
        LRU-bounded by ``comp_state_lru`` and ``comp_state_bytes``; the
        newest entry is always kept."""
        cfg = self.config.cache
        tr = self.bundle.models["transformer"]
        fine = (cache is not None and cfg.mode == "compact"
                and cfg.patch_fraction < 1.0)
        want_kv = fine and cfg.fine_stale_kv
        ctx_seq = None
        if cache is not None and cfg.mode == "compact" and not fine:
            ctx_seq = ordered[0].conditioning["embeds"].shape[1]
        mode_sig = (cache is not None and type(cache).__name__, cfg.mode,
                    fine, want_kv, ctx_seq, self._sd3_deep_span())
        key = (s_pad, bb, tuple(r.request_id for r in ordered), mode_sig)
        store = self._sd3_state
        entry = store.get(key)
        if entry is None:
            dtype, dev = self.bundle.dtype, self.device
            layout = tr.token_cache_layout(s_pad).items()
            state = None
            if fine:
                # K/V pairs a block carries: two for a dual block
                pairs = {i: (2 if i in tr.cfg.dual_attention_layers else 1)
                         if want_kv else 0 for i in range(tr.cfg.num_layers)}
                state = {k: cache.init_token_rows_fine(
                    k, 2 * bb, seq, dim, dtype, dev, kv_pairs=pairs[int(k[5:])])
                    for k, (seq, dim) in layout}
            elif cache is not None:
                state = {k: cache.init_token_rows(k, 2 * bb, seq, dim, dtype,
                                                  dev, ctx_seq=ctx_seq)
                         for k, (seq, dim) in layout}
            entry = {"state": state, "kv_ok": False, "anchored": False,
                     "deep": None, "deep_age": 0, "deep_slope": None}
            store[key] = entry
        store.move_to_end(key)
        while len(store) > max(int(cfg.comp_state_lru), 1):
            store.popitem(last=False)
        while (len(store) > 1 and sum(_state_nbytes(e) for e in store.values())
               > float(cfg.comp_state_bytes)):
            store.popitem(last=False)
        return entry

    def release_serving_state(self) -> None:
        super().release_serving_state()
        self._sd3_state.clear()

    def evict_finished_state(self, req_ids) -> None:
        """Also drop the ``_sd3_state`` entries holding a finished or
        aborted request (their keys' request ids, at index 2)."""
        super().evict_finished_state(req_ids)
        ids = set(req_ids)
        for k in [k for k in list(self._sd3_state) if ids.intersection(k[2])]:
            self._sd3_state.pop(k, None)

    def _live_state_bytes(self) -> int:
        return super()._live_state_bytes() + sum(
            _state_nbytes(e) for e in list(self._sd3_state.values()))

    # -- span reuse-then-predict (CacheConfig.deep_predict) -----------------

    def _sd3_deep_predicted(self, entry):
        """The delta a shallow step splices: the last full pass's, or with
        ``deep_predict`` m and a slope, ``delta + m * (deep_age + 1) *
        slope`` (sd3.py:750-774), in the delta's dtype."""
        m = float(self.config.cache.deep_predict or 0.0)
        dp, sl = entry["deep"], entry["deep_slope"]
        if not m or sl is None:
            return dp
        k = float(entry["deep_age"] + 1)
        return {n: (d.float() + m * k * sl[n].float()).to(d.dtype)
                for n, d in dp.items()}

    def _sd3_deep_update_slope(self, entry, new) -> None:
        """On a full pass with ``deep_predict``: the per-step velocity
        ``(new - old) / (deep_age + 1)`` of the delta, in its dtype; no
        slope across a change of structure or shape (sd3.py:776-800)."""
        if not float(self.config.cache.deep_predict or 0.0):
            return
        old = entry["deep"]
        if (old is None or set(old) != set(new)
                or any(old[n].shape != new[n].shape for n in new)):
            entry["deep_slope"] = None
            return
        g = float(entry["deep_age"] + 1)
        entry["deep_slope"] = {n: ((new[n].float() - old[n].float()) / g).to(
            new[n].dtype) for n in new}


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
