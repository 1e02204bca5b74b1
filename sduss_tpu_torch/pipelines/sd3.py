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
pipeline frees a finished request's entries.  ``denoise_chunk`` runs k
steps of a uniform batch on the token path in one dispatch, from captured
step graphs on the card.  The JAX pipeline's warm-key routing (compile
keys) is not ported: eager PyTorch has no cold program to route around.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import bucket_for
from sduss_tpu_torch.parallel.sharding import ShardedTensor, tmap
from sduss_tpu_torch.pipelines.base import (_PAD, BasePipeline, _split_tc,
                                            _state_nbytes)
from sduss_tpu_torch.pipelines.graphs import clone_tree, keep_leaves, store
from sduss_tpu_torch.samplers import gather_coeffs, gather_timesteps


class StableDiffusion3Pipeline(BasePipeline):
    FAMILY = "sd3"

    T5_SEQ_LEN = 256
    # Serving repeats T5 rows constantly (every CFG request re-encodes the
    # same negative prompt); the JAX pipeline keeps an LRU of float16 rows
    # (sd3.py:21-45).  The port keeps the same rows, on the device.
    T5_CACHE_ROWS = 32

    def __init__(self, bundle, config, devices=None):
        super().__init__(bundle, config, devices)
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
        return self.denoiser(latents_in, t, ehs.to(dtype), pooled.to(dtype),
                             ctx=ctx)

    def _row_multiple(self) -> int:
        """A shard's latent rows must tile into 2x2 patches."""
        return self.bundle.denoiser.cfg.patch_size

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
        tracing.phase("denoise.batch")
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
        mask = np.zeros((bb, s_pad), bool)
        for idx, n in enumerate(lens):
            mask[idx, :n] = True
        t = np.zeros((bb,), np.float32)
        t[:b] = gather_timesteps(tables)
        guidance, cond = self._token_batch(ordered, bb)

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
            self._record_mode(deep_mode, len(ordered))
            kw.update(deep_mode=deep_mode, deep_span=span,
                      deep_state=(self._sd3_deep_predicted(entry)
                                  if deep_mode == "shallow" else None))
        tracing.phase("denoise.forward")
        new_lats, deep_out = self._token_step(
            [torch.cat([r.latents for r in ordered[i:j]]) for i, j in groups],
            [ordered[i].latent_hw(self.vae_scale) // ps for i, _ in groups],
            coeffs, s_pad, bb, torch.from_numpy(mask).to(dev),
            torch.from_numpy(t).to(dev), guidance, cond, kw)
        tracing.phase("denoise.update")
        if cache is not None:
            entry["anchored"] = True
            entry["kv_ok"] = fine and cc.fine_stale_kv
        if deep_mode == "full":
            self._sd3_deep_update_slope(entry, deep_out)
            entry["deep"], entry["deep_age"] = deep_out, 0
        elif deep_mode == "shallow":
            entry["deep_age"] += 1

        for (i, j), new_lat in zip(groups, new_lats):
            for k, r in enumerate(ordered[i:j]):
                r.latents = new_lat[k:k + 1]
                r.sampler_table.advance()
                r.remain_steps -= 1

    def _token_batch(self, ordered, bb: int):
        """``(guidance, cond)`` of a token batch padded to ``bb`` rows: pad
        rows get guidance 0 and repeat the last row's conditioning."""
        guidance = np.zeros((bb,), np.float32)
        guidance[:len(ordered)] = [
            r.params.guidance_scale if r.params.guidance_scale is not None
            else self.spec.default_guidance for r in ordered]
        cond = {key: _pad_rows(torch.cat([r.conditioning[key]
                                          for r in ordered], dim=0), bb)
                for key in ordered[0].conditioning}
        return torch.from_numpy(guidance).to(self.device), cond

    def _token_step(self, lats, hps, coeffs, s_pad: int, bb: int, mask, t,
                    guidance, cond, kw):
        """One token-path step over resolution runs: ``lats`` each run's
        latents (rows in batch order), ``hps`` their patch grids, ``coeffs``
        (b, 2).  Each run's scaled latents are embedded and right-padded to
        ``s_pad`` tokens, the batch to ``bb`` rows by repeating the last;
        ``_trunk_fn`` (with the cache and deep arguments ``kw``), then each
        run's sampler update.  Returns ``(new latents per run,
        deep_out)``."""
        tr = self.bundle.models["transformer"]
        tok_rows, i = [], 0
        for lat in lats:
            n = lat.shape[0]
            toks = tr.embed_latents(
                self.sampler.scale_model_input(lat, coeffs[i:i + n, 0]))
            tok_rows.append(torch.nn.functional.pad(
                toks, (0, 0, 0, s_pad - toks.shape[1])))
            i += n
        tokens = _pad_rows(torch.cat(tok_rows, dim=0), bb)
        out, deep_out = self._trunk_fn(tokens, mask, t, guidance, cond, **kw)
        new, i = [], 0
        for lat, hp in zip(lats, hps):
            n = lat.shape[0]
            v = tr.unpatchify(out[i:i + n], hp, hp)
            new.append(self.sampler.step(lat, v.to(lat.dtype),
                                         coeffs[i:i + n, 0],
                                         coeffs[i:i + n, 1]))
            i += n
        return new, deep_out

    # -- fused multi-step dispatch (SchedulerConfig.steps_per_dispatch) -----

    @torch.inference_mode()
    def denoise_chunk(self, reqs_by_res, k: int) -> bool:
        """Run ``k`` steps of a uniform batch on the token path in one
        dispatch (JAX sd3.py:363-589): embed -> trunk -> unpatchify ->
        sampler step per step, the latents, the token-cache rows and the
        span delta carried through; on the card k replays of captured step
        graphs.  False, as in JAX, for mixed resolutions, a stateful
        sampler, a request with fewer than ``k`` steps, the fine gate's
        stale K/V, the adaptive refresh, the span with ``deep_predict``, an
        un-anchored compact state, and the span during warmup.  The span
        runs at any interval phase: step j is full when ``(phase + j) %
        itv == itv - 1``, the per-step recurrence, with ``phase`` the
        delta's age (``itv - 1`` without one).  A cache-off chunk runs the
        token path too, as JAX's does."""
        if self._sp() > 1:
            return self._sp_chunk(reqs_by_res, k)
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        if not ordered or k <= 1:
            return False
        cc = self.config.cache
        cache, span = self._sd3_cache(), self._sd3_deep_span()
        fine = (cache is not None and cc.mode == "compact"
                and cc.patch_fraction < 1.0)
        if (len({r.resolution for r in ordered}) != 1
                or self.sampler.needs_state
                or any(r.remain_steps < k for r in ordered)
                or (fine and cc.fine_stale_kv) or cc.deep_adaptive
                or (span is not None and cc.deep_predict)):
            return False
        tr = self.bundle.models["transformer"]
        hp = ordered[0].latent_hw(self.vae_scale) // tr.cfg.patch_size
        s_pad = hp * hp
        b = len(ordered)
        bb = bucket_for(b, self.config.scheduler.batch_buckets)
        itv = max(cc.deep_interval, 1)
        entry = None
        if cache is not None or span is not None:
            entry = self._sd3_state_entry(ordered, bb, s_pad, cache)
            if (cache is not None and cc.mode == "compact" and not fine
                    and not entry["anchored"]):
                return False  # the anchoring sync step runs per-step
            if span is not None and any(
                    r.sampler_table.step < cc.deep_warmup for r in ordered):
                return False
        dev = self.device
        sset = self.graphs.step_set(
            ("sd3", s_pad, b, bb, cache is not None and cc.mode, fine, span))
        sset.load("lat", torch.cat([r.latents for r in ordered]))
        guidance, cond = self._token_batch(ordered, bb)
        sset.load("guid", guidance)
        sset.load("cond", cond)
        mask = np.zeros((bb, s_pad), bool)
        mask[:b] = True
        sset.load("mask", torch.from_numpy(mask).to(dev))
        sset.load("row_valid", self._row_valid(b, bb))
        if cache is not None:
            sset.adopt("state", entry, self._entry_live)
        per_step = {"tc": self._step_rows([r.sampler_table for r in ordered],
                                          k, bb, b, repeat=False)}
        if span is not None:
            phase = (itv - 1 if entry["deep"] is None
                     else min(entry["deep_age"], itv - 1))
            sset.load("deep", entry["deep"] if entry["deep"] is not None
                      else self._span_zeros(
                          2 * bb, s_pad,
                          ordered[0].conditioning["embeds"].shape[1], dev))
            kinds = ["full" if (phase + j) % itv == itv - 1 else "shallow"
                     for j in range(k)]
        else:
            kinds = ["token"] * k

        def make_step(kind):
            def step(bufs):
                t, c = _split_tc(bufs["tc"], bb, b)
                state = bufs.get("state")
                kw = {}
                if cache is not None:
                    kw.update(cache=cache, cache_state=state,
                              row_valid=bufs["row_valid"])
                if span is not None:
                    kw.update(deep_mode=kind, deep_span=span,
                              deep_state=bufs["deep"] if kind == "shallow"
                              else None)
                (lat,), deep = keep_leaves(state, lambda: self._token_step(
                    [bufs["lat"]], [hp], c, s_pad, bb, bufs["mask"], t,
                    bufs["guid"], bufs["cond"], kw))
                store(bufs["lat"], lat)
                if span is not None:
                    store(bufs["deep"], deep)
            return step

        tracing.phase("denoise.forward")
        self._run_chunk(sset, per_step, kinds, make_step)
        tracing.phase("denoise.update")
        if cache is not None:
            entry["anchored"] = True
        if span is not None:
            for kind in kinds:
                self._record_mode(kind, len(ordered))
            entry["deep"] = clone_tree(sset.bufs["deep"])
            # the per-step recurrence's age: the last full at j* leaves
            # k - 1 - j*; none ages the delta by k
            fulls = [j for j, kind in enumerate(kinds) if kind == "full"]
            entry["deep_age"] = (k - 1 - fulls[-1]) if fulls else phase + k
            entry["deep_slope"] = None
        lat = sset.bufs["lat"]
        for i, r in enumerate(ordered):
            r.latents = lat[i:i + 1].clone()
        self._finish_chunk(ordered, k)
        return True

    def denoise_chunk_mixed(self, reqs_by_res, k: int) -> bool:
        """Mixed SD3 batches step one at a time on the token path: JAX's
        SD3 chunk takes uniform batches only (its base class's patch chunk
        would run a UNet program on the MMDiT)."""
        return False

    def _trunk_fn(self, tokens, mask, t, guidance, cond, row_valid=None,
                  **kw):
        """CFG-doubled token forward (rows ``[uncond x bb | cond x bb]``) +
        guidance combine (sd3.py:802-851).  ``kw`` are ``apply_tokens``'s
        cache and deep arguments.  Returns ``(combined, deep_out)``;
        ``deep_out`` None without ``deep_mode``."""
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]], dim=0)
        pooled = torch.cat([cond["neg_pooled"], cond["pooled"]], dim=0)
        if row_valid is not None:
            kw["row_valid"] = torch.cat([row_valid, row_valid])
        out = self.denoiser.apply_tokens(torch.cat([tokens, tokens]),
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
        LRU-bounded by ``comp_state_lru``, and by ``comp_state_bytes``
        together with the step sets' rows (``_trim_row_state``); the
        newest entry is always kept."""
        cfg = self.config.cache
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
            state = self._sd3_rows(cache, 2 * bb, s_pad, ctx_seq, self.device)
            entry = {"state": state, "kv_ok": False, "anchored": False,
                     "deep": None, "deep_age": 0, "deep_slope": None}
            store[key] = entry
        store.move_to_end(key)
        while len(store) > max(int(cfg.comp_state_lru), 1):
            store.popitem(last=False)
        self._trim_row_state(store)
        return entry

    def _sd3_rows(self, cache, n_rows: int, s_pad: int, ctx_seq, device):
        """Fresh token-cache rows of every block (None without a token
        cache): the fine gate's (with its K/V pairs under
        ``fine_stale_kv``, two for a dual block), or the block/compact
        gates' (``ctx_seq``: compact's context stream)."""
        if cache is None:
            return None
        cfg = self.config.cache
        tr = self.bundle.models["transformer"]
        dtype = self.bundle.dtype
        layout = tr.token_cache_layout(s_pad).items()
        if cfg.mode == "compact" and cfg.patch_fraction < 1.0:
            pairs = {i: (2 if i in tr.cfg.dual_attention_layers else 1)
                     if cfg.fine_stale_kv else 0
                     for i in range(tr.cfg.num_layers)}
            return {k: cache.init_token_rows_fine(
                k, n_rows, seq, dim, dtype, device, kv_pairs=pairs[int(k[5:])])
                for k, (seq, dim) in layout}
        return {k: cache.init_token_rows(k, n_rows, seq, dim, dtype, device,
                                         ctx_seq=ctx_seq)
                for k, (seq, dim) in layout}

    def _span_zeros(self, n_rows: int, s_pad: int, ctx_len: int, device):
        """A zero span delta: ``{"dx"}``, with ``"c"`` for an interior
        span (the shape a full pass emits)."""
        tr = self.bundle.models["transformer"]
        d = {"dx": torch.zeros((n_rows, s_pad, tr.cfg.dim),
                               dtype=self.bundle.dtype, device=device)}
        if self._sd3_deep_span()[1] < tr.cfg.num_layers:
            d["c"] = torch.zeros((n_rows, ctx_len, tr.cfg.dim),
                                 dtype=self.bundle.dtype, device=device)
        return d

    def estimate_serving_state_bytes(self, res: int, bucket: int) -> int:
        """Bytes of the state a uniform (res, bucket) token-path step mints:
        the token-cache rows and the span delta, built on the meta device
        (shape math only, JAX sd3.py:695-735)."""
        cache, span = self._sd3_cache(), self._sd3_deep_span()
        if cache is None and span is None:
            return 0
        ps = self.bundle.models["transformer"].cfg.patch_size
        s_pad = (res // self.vae_scale // ps) ** 2
        ctx = 77 + self.T5_SEQ_LEN
        cfg = self.config.cache
        meta = torch.device("meta")
        rows = self._sd3_rows(cache, 2 * bucket, s_pad, ctx if (
            cfg.mode == "compact" and cfg.patch_fraction >= 1.0) else None,
            meta)
        delta = None if span is None else self._span_zeros(2 * bucket, s_pad,
                                                           ctx, meta)
        return _state_nbytes(rows) + _state_nbytes(delta)

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

    def _store_trees(self) -> list:
        return super()._store_trees() + list(self._sd3_state.values())

    def _live_entries(self) -> list:
        return super()._live_entries() + list(self._sd3_state.values())

    def _state_store(self):
        return self._sd3_state

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
        # on every shard's part under sp
        return tmap(lambda d, s: (d.float() + m * k * s.float()).to(d.dtype),
                    dp, sl)

    def _sd3_deep_update_slope(self, entry, new) -> None:
        """On a full pass with ``deep_predict``: the per-step velocity
        ``(new - old) / (deep_age + 1)`` of the delta, in its dtype; no
        slope across a change of structure or shape (sd3.py:776-800)."""
        if not float(self.config.cache.deep_predict or 0.0):
            return
        old = entry["deep"]
        if (old is None or set(old) != set(new)
                or any(_shape(old[n]) != _shape(new[n]) for n in new)):
            entry["deep_slope"] = None
            return
        g = float(entry["deep_age"] + 1)
        entry["deep_slope"] = tmap(
            lambda n_, o: ((n_.float() - o.float()) / g).to(n_.dtype),
            new, old)


def _shape(t):
    """A tensor's shape, or the shapes of a sharded tensor's parts."""
    if isinstance(t, ShardedTensor):
        return tuple(None if p is None else tuple(p.shape) for p in t.parts)
    return tuple(t.shape)


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
