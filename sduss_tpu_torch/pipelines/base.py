"""Staged diffusion pipeline (counterpart of sduss_tpu/pipelines/base.py).

* ``prepare``            — tokenize + text-encode + per-request latent init
                           + sampler table.
* ``denoise_step``       — ONE scheduled denoiser step for a batch of
                           requests grouped by resolution: CFG pairing,
                           input scaling, model forward, guidance combine
                           and sampler update, one forward per resolution.
* ``denoise_step_mixed`` — ONE step for a mixed-resolution batch as a single
                           patched UNet forward (the mixed patch path; the
                           SD3 pipeline's padded-token step overrides it).
* ``postprocess``        — VAE decode to uint8 images (or the final latents),
                           tiled for SD3 as in the JAX pipeline, then the
                           safety checker when one is configured.

The dense path runs batches at their real size: eager PyTorch has no
compile cache to key.  The patch path pads the patch and image counts to
the configured buckets like the JAX package, so both form the same patch
batch and the padded image slots reach the masked attention kernel.
Requests at different timesteps batch through per-request sampler
coefficient rows.  A stateful sampler (PNDM) keeps its state per request in
the dense latent layout (``Request.sampler_state``); the mixed step slices
it into patches like the latents and merges it back, so a request may move
between dense and patched steps.

The deep cache (``CacheConfig.mode == "deep"``) runs on both paths of the
UNet families.  On the dense path each step of a resolution group is full,
shallow or partial (``_denoise_group_deep``), with the drift-adaptive
refresh, the reuse-then-predict extrapolation, the row-granular warmup and
the deep x compact hybrid's CFG-pair row caches, which live in a store
keyed by the batch's composition (``_comp_state``).  Like the JAX package,
the deep branch pads the batch to its bucket by repeating the last row,
because the hybrid's gate capacity comes from the bucket.  On the patch
path a mixed batch's step is full or shallow batch-wide
(``_deep_mode_mixed``); the hybrid gates whole images per resolution class
and keeps its rows, one per doubled patch, in a ``"unet_hybrid_mixed"``
entry of the same store.  A request whose batch moves between the two
paths holds a deep feature of the other layout, which forces a full step.
The block and compact caches (modes "block" and "compact") gate every
pair of the UNet's ``cache_layout``.  On the patch path each request keeps
its rows, two per patch (uncond, then cond), in ``Request.cache_rows``;
they are gathered into the doubled patch batch each step and scattered
back, so rows follow membership changes (under sp a composition's rows
stay on the shards in ``_batch_rows`` until it changes).  On the dense path mode "block"
is cache-off, as in the JAX package, and mode "compact" keeps its rows in
a ``"unet_compact"`` entry of the composition store, anchored by one step
at full capacity.  The SD3 pipeline runs its own caches on its token path
(``pipelines/sd3.py``).

Fused multi-step dispatch (``SchedulerConfig.steps_per_dispatch``):
``denoise_chunk`` (dense) and ``denoise_chunk_mixed`` (patch path) run k
steps in one dispatch with the JAX package's eligibility rules and
in-chunk schedules, from the same per-step bodies; on the card each step
replays a captured CUDA graph of its kind (``pipelines/graphs.py``).
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import Config, bucket_for
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.request import Request
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.models.safety_checker import SafetyChecker
from sduss_tpu_torch.ops import patching
from sduss_tpu_torch.ops.patch_ctx import PatchContext, compact_context
from sduss_tpu_torch.parallel.group import ShardGroup
from sduss_tpu_torch.parallel.replica import check_group
from sduss_tpu_torch.parallel.sharding import (ShardedDenoiser,
                                               ShardedTensor, SpStep, parts_of,
                                               tmap)
from sduss_tpu_torch.pipelines.graphs import (StepGraphs, keep_leaves,
                                              store, unique_nbytes)
from sduss_tpu_torch.samplers import gather_coeffs, gather_timesteps, get_sampler

logger = init_logger(__name__)

# tokenizer arguments of every text encode: a snapshot's transformers
# tokenizers pad and truncate to max_length only when asked (the stub
# always does), as in the JAX pipelines
_PAD = {"padding": "max_length", "truncation": True}


def _pad_batch(arr: torch.Tensor, target: int) -> torch.Tensor:
    """Pad the leading axis to ``target`` by repeating the last row."""
    b = arr.shape[0]
    if b == target:
        return arr
    return torch.cat([arr, arr[-1:].expand((target - b,) + arr.shape[1:])])


def _split_tc(tc: torch.Tensor, n_t: int, n_c: Optional[int] = None):
    """A ``"tc"`` row of :meth:`BasePipeline._step_rows` -> ``(t (n_t,),
    coeffs (n_c, 2))``, contiguous views."""
    n_c = n_t if n_c is None else n_c
    return tc[:n_t], tc[n_t:n_t + 2 * n_c].view(n_c, 2)


class _BatchRows:
    """The block or compact rows of one patch-batch composition under sp,
    in the pipeline's store (``_batch_rows``, keyed by the request ids):
    the composition's requests, its meta, and the state tree whose leaves
    the sharded route keeps on the shards.  Its requests' own
    ``cache_rows`` are None meanwhile."""

    def __init__(self, reqs, meta, state):
        self.reqs = reqs
        self.meta = meta
        self.state = state


def _latent_drift(new, ref):
    """Relative MSE of the current latent against the latent of the last
    full pass (the adaptive deep refresh's trigger), a float32 scalar."""
    d = (new - ref).float()
    return d.square().mean() / (ref.float().square().mean() + 1e-12)


def _state_nbytes(tree) -> int:
    """Bytes held by the tensors of a composition-state tree (nested dicts
    of tensors, every shard's part of a sharded leaf; other leaves hold
    none)."""
    return sum(t.numel() * t.element_size() for t in parts_of(tree))


class _DriftScalar:
    """A drift value on its way to the host.  On the card: a non-blocking
    copy into pinned memory and the event recorded after it, so that the
    value is read only once the event has completed; on the CPU the value
    itself, ready at once."""

    def __init__(self, value: torch.Tensor):
        self._event = None
        if value.is_cuda:
            self._value = torch.empty((), dtype=torch.float32,
                                      pin_memory=True)
            self._value.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._value = value

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __float__(self) -> float:
        return float(self._value)


class BasePipeline:
    """Family-agnostic staged pipeline over a ModelBundle.

    ``devices``: the replica's devices, one (the bundle's) or ``sp * tp``
    of them (``parallel/replica.py``), the first the bundle's.  Over more
    than one the denoiser is a ``ShardedDenoiser`` on a ``ShardGroup``:
    tensor-parallel forwards on every path, and with ``sp > 1`` every
    forward of every path and cache runs on the sp shards through the
    denoiser's one sharded route; the cache-off and plain deep dense step
    adds the displaced mode (:meth:`_denoise_group_displaced`).  The text
    encoders, the VAE and the safety checker run on the lead device, where
    the requests' latents stay whole."""

    def __init__(self, bundle: ModelBundle, config: Config, devices=None):
        self.bundle = bundle
        self.config = config
        self.spec = bundle.spec
        self.device = bundle.device
        self.devices = ([self.device] if devices is None
                        else [torch.device(d) for d in devices])
        par = config.parallel
        self.group = None
        self.denoiser = bundle.denoiser
        if len(self.devices) > 1:
            check_group(config)
            self.group = ShardGroup(self.devices, par.sp, par.tp)
            self.denoiser = ShardedDenoiser(bundle.denoiser, self.group)
        # the stale K/V (sp_mode "displaced") and deep feature of each
        # composition under sp > 1 (_denoise_group_displaced)
        self._disp_state: collections.OrderedDict = collections.OrderedDict()
        self.displaced_steps = {"sync": 0, "stale": 0}
        if config.model.sampler:
            self.sampler = get_sampler(config.model.sampler)
        else:
            self.sampler = get_sampler(self.spec.default_sampler,
                                       **self.spec.sampler_kwargs)
        self.vae_scale = self.spec.vae_scale
        # the deep cache's device state, per batch composition: the
        # hybrid's row caches and the batch-form deep carry
        self._comp_state: collections.OrderedDict = collections.OrderedDict()
        self._deep_carry: collections.OrderedDict = collections.OrderedDict()
        # under sp, the patch batch's block or compact rows, per
        # composition (:meth:`_batch_cache_rows`)
        self._batch_rows: Dict[tuple, _BatchRows] = {}
        self._cache_obj = None
        self._safety_obj = None
        # the captured step graphs of fused multi-step dispatch, and, when
        # a caller sets it to a list, the deep mode of every step run
        self.graphs = StepGraphs(self.device)
        if self.group is not None:
            # cross-thread peer copies cannot live in per-shard graphs: a
            # group's chunks run their steps eagerly
            self.graphs.live = False
        self.step_modes = None

    # -- family hooks --------------------------------------------------------

    def encode_conditioning(self, prompts: List[str], negatives: List[str],
                            resolutions: List[int]) -> List[Dict[str, torch.Tensor]]:
        """Run the text encoders; return one conditioning dict per request."""
        raise NotImplementedError

    def denoiser_forward(self, latents_in, t, cond, ctx=None, **deep):
        """Model forward on a CFG-paired batch.

        Dense: latents_in ``(2B, h, w, C)``, cond arrays ``(B, ...)``
        CFG-concatenated by the implementation.  Patched: latents_in is the
        doubled patch batch, t is per image (already doubled), cond per
        image, and ctx the doubled batch's ``PatchContext``.  ``deep``
        passes the UNet's cache keywords through (``deep_mode``,
        ``deep_state``, ``deep_sel``, ``cache``, ``cache_state``,
        ``row_valid``, ``compact_sync``), with ``deep_boundary`` from the
        cache config.
        """
        raise NotImplementedError

    # -- stage 1: prepare ----------------------------------------------------

    @torch.inference_mode()
    def prepare(self, requests: Sequence[Request]) -> None:
        prompts = [r.params.prompt for r in requests]
        negatives = [r.params.negative_prompt for r in requests]
        resolutions = [r.resolution for r in requests]
        tracing.phase("prepare.encode")
        conds = self.encode_conditioning(prompts, negatives, resolutions)
        tracing.phase("prepare.latents")
        for req, cond in zip(requests, conds):
            req.conditioning = cond
            req.sampler_table = self.sampler.make_table(req.params.num_inference_steps)
            req.remain_steps = req.sampler_table.num_steps
            h = req.latent_hw(self.vae_scale)
            seed = req.params.seed if req.params.seed is not None \
                else abs(hash(req.request_id)) % (2**31)
            # host float32 noise from numpy, exactly as the JAX package
            # draws it, so both packages start from the same latents
            noise = np.random.default_rng(seed).standard_normal(
                (1, h, h, self.bundle.latent_channels), dtype=np.float32)
            lat = noise * req.sampler_table.init_noise_sigma
            req.latents = torch.from_numpy(lat).to(self.device, self.bundle.dtype)

    # -- stage 2: one denoising step ----------------------------------------

    @torch.inference_mode()
    def denoise_step(self, reqs_by_res: Dict[int, List[Request]]) -> None:
        """Run ONE denoiser step for every request, one forward per
        resolution group."""
        for res in sorted(reqs_by_res):
            if reqs_by_res[res]:
                self._denoise_group(reqs_by_res[res])

    def _group_batch(self, reqs: List[Request]):
        """``(latents, guidance, cond)`` of a dense batch, request rows in
        order."""
        latents = torch.cat([r.latents for r in reqs], dim=0)
        guidance = torch.tensor(
            [r.params.guidance_scale if r.params.guidance_scale is not None
             else self.spec.default_guidance for r in reqs],
            dtype=torch.float32, device=self.device)
        cond = {key: torch.cat([r.conditioning[key] for r in reqs], dim=0)
                for key in reqs[0].conditioning}
        return latents, guidance, cond

    def _denoise_group(self, reqs: List[Request]) -> None:
        tracing.phase("denoise.batch")
        tables = [r.sampler_table for r in reqs]
        dev = self.device
        latents, guidance, cond = self._group_batch(reqs)
        t = torch.from_numpy(gather_timesteps(tables)).to(dev)
        coeffs = torch.from_numpy(gather_coeffs(tables)).to(dev)
        # the JAX branch order: a stateful sampler first (PNDM runs without
        # the caches, in both packages), then the deep cache, then compact;
        # under sp > 1 the sp step serves what rides its seam (cache-off,
        # a stateful sampler, the plain deep cache), and the gated caches
        # take their own branches, whose forwards shard all the same (the
        # JAX package's GSPMD precedence)
        if self._sp() > 1:
            self._check_sp_rows(reqs[0].resolution, latents.shape[1])
            if self._sp_gated() and self._displaced_requested():
                self._warn_once("displaced sp_mode: this cache configuration "
                                "takes precedence — serving on the sync "
                                "sharded path (plain deep interval "
                                "composes; hybrid/compact/adaptive do not)")
        if self._sp() > 1 and not self._sp_gated():
            new_latents = self._denoise_group_displaced(reqs, latents, t,
                                                        coeffs, guidance, cond)
        elif self.sampler.needs_state:
            tracing.phase("denoise.forward")
            self._init_sampler_state(reqs)
            state = {key: torch.cat([r.sampler_state[key] for r in reqs])
                     for key in reqs[0].sampler_state}
            new_latents, new_state = self._denoise_fn_stateful(
                latents, t, coeffs, guidance, cond, state)
            tracing.phase("denoise.update")
            for i, r in enumerate(reqs):
                r.sampler_state = {key: a[i:i + 1]
                                   for key, a in new_state.items()}
        elif self._deep_cache_active():
            new_latents = self._denoise_group_deep(reqs, latents, t, coeffs,
                                                   guidance, cond)
        elif self._compact_cache_active():
            new_latents = self._denoise_group_compact(reqs, latents, t,
                                                      coeffs, guidance, cond)
        else:
            tracing.phase("denoise.forward")
            new_latents = self._denoise_fn(latents, t, coeffs, guidance, cond)
        tracing.phase("denoise.update")
        for i, req in enumerate(reqs):
            req.latents = new_latents[i:i + 1]
            req.sampler_table.advance()
            req.remain_steps -= 1

    def _denoise_fn(self, latents, t, coeffs, guidance, cond):
        """CFG duplicate -> scale -> model -> combine -> sampler step."""
        noise_pred, c0, c1 = self._cfg_forward(latents, t, coeffs, guidance,
                                               cond)
        return self.sampler.step(latents, noise_pred, c0, c1)

    def _denoise_fn_stateful(self, latents, t, coeffs, guidance, cond, state):
        """As :meth:`_denoise_fn`, through ``step_with_state``."""
        noise_pred, c0, c1 = self._cfg_forward(latents, t, coeffs, guidance,
                                               cond)
        return self.sampler.step_with_state(latents, noise_pred, c0, c1, state)

    def _cfg_step(self, latents, t, coeffs, guidance, model_call):
        """The CFG skeleton of the dense steps: duplicate (rows go uncond
        first, then cond) -> scale -> ``model_call(lat_in, t2)`` -> split
        -> guidance combine.  ``model_call`` returns the model output or
        ``(output, extra)``; ``extra`` passes through.  Returns ``(eps, c0,
        c1, extra)``."""
        lat_in = torch.cat([latents, latents], dim=0)
        t2 = torch.cat([t, t], dim=0)
        c0, c1 = coeffs[:, 0], coeffs[:, 1]
        lat_in = self.sampler.scale_model_input(lat_in, torch.cat([c0, c0]))
        out = model_call(lat_in, t2)
        model_out, extra = out if isinstance(out, tuple) else (out, None)
        uncond, text = model_out.chunk(2, dim=0)
        g = guidance.reshape(-1, *([1] * (latents.dim() - 1)))
        return uncond + g * (text - uncond), c0, c1, extra

    def _cfg_forward(self, latents, t, coeffs, guidance, cond):
        noise_pred, c0, c1, _ = self._cfg_step(
            latents, t, coeffs, guidance,
            lambda lat_in, t2: self.denoiser_forward(lat_in, t2, cond))
        return noise_pred, c0, c1

    # -- spatial parallelism over the group's sp axis -----------------------

    def _sp(self) -> int:
        return self.group.sp if self.group is not None else 1

    def _warn_once(self, msg: str) -> None:
        if not hasattr(self, "_warned"):
            self._warned = set()
        if msg not in self._warned:
            self._warned.add(msg)
            logger.warning(msg)

    def _displaced_requested(self) -> bool:
        return self.config.parallel.sp_mode == "displaced" and self._sp() > 1

    def _sp_gated(self) -> bool:
        """Does a dense step under sp take a gated cache's branch (the deep
        cache's hybrid, adaptive or predict modes, or mode "compact")
        rather than the sp step?  A stateful sampler runs without the
        caches, on the sp step (JAX base.py:1018-1025)."""
        if self.sampler.needs_state:
            return False
        return self._compact_cache_active() or (
            self._deep_cache_active() and not self._displaced_deep_ok())

    def _check_sp_rows(self, res: int, hw: int) -> None:
        mult = self._sp() * self._row_multiple()
        if hw % mult:
            raise ValueError(f"resolution {res}: {hw} latent rows do not "
                             f"split into sp={self._sp()} shards of a "
                             f"multiple of {self._row_multiple()} rows")

    def _displaced_deep_ok(self) -> bool:
        """Does the enabled cache ride the sp step?  The plain
        fixed-interval deep cache of the UNet families (JAX base.py:1028),
        the predicate ESyMReD's admission mirror shares."""
        return (self.config.cache.plain_fixed_deep()
                and hasattr(self.bundle.denoiser, "cache_layout"))

    def _row_multiple(self) -> int:
        """Latent rows each shard's slice must be a multiple of: the UNet
        halves them at every downsample."""
        return 2 ** (len(self.bundle.denoiser.cfg.block_out_channels) - 1)

    def _denoise_group_displaced(self, reqs, latents, t, coeffs, guidance,
                                 cond):
        """One dense step of a resolution group on the sp row shards (JAX
        base.py:1042-1132); returns the new latents.

        The denoiser's sharded route splits the CFG batch's rows over the
        shards, each on a ``ShardContext`` (``MMDiTShardContext`` for SD3)
        built from this step's :class:`SpStep`, and gathers the model
        output on the lead device, where the CFG combine and the sampler
        update the whole latents (a stateful sampler's state stays whole).
        ``sp_mode="gspmd"`` runs every step in sync (fresh K/V gathers,
        exact).  Under ``"displaced"`` the K/V state of a composition lives
        in ``_disp_state`` under ``(res, bucket, request ids)``, LRU 4: its
        first ``displaced_warmup`` steps run sync, later ones stale (this
        shard's fresh rows spliced into the previous step's full K/V).  A
        stateful sampler serves the exact sync path instead, with JAX's
        warning.  The plain fixed-interval deep cache rides the seam: the
        mode is chosen as on the dense deep path, the deep feature is
        composition state (rows sharded like the latents), full steps
        always run sync and each mode keeps its own K/V dict."""
        tracing.phase("denoise.decide")
        res = reqs[0].resolution
        bb = bucket_for(len(reqs), self.config.scheduler.batch_buckets)
        key = (res, bb, tuple(r.request_id for r in reqs))
        st = self._disp_state.get(key)
        if st is None:
            st = {"comp": key[2], "kv": {}, "warm": 0, "deep": None,
                  "deep_age": 0}
            self._disp_state[key] = st
        self._disp_state.move_to_end(key)
        while len(self._disp_state) > 4:
            self._disp_state.popitem(last=False)

        stateful = self.sampler.needs_state
        displaced = self._displaced_requested()
        if displaced and stateful:
            self._warn_once("displaced sp_mode: stateful sampler — serving "
                            "on the exact sync path instead")
        deep_on = (self.config.cache.enabled and self._displaced_deep_ok()
                   and not stateful)
        mode = None
        if deep_on:
            interval, warmup_deep, _ = self._deep_policy()
            steps_done = min(r.sampler_table.step for r in reqs)
            need_full = (st["deep"] is None
                         or st["deep_age"] >= interval - 1
                         or steps_done < warmup_deep)
            mode = "full" if need_full else "shallow"
            self._record_mode(mode, len(reqs))
        kv = st["kv"].get(mode or "dense", {})
        stale = (displaced and not stateful and mode != "full"
                 and st["warm"] >= self.config.parallel.displaced_warmup
                 and bool(kv))
        seam = SpStep(stale, kv)
        kw = {} if mode is None else {"deep_mode": mode}
        if mode == "shallow":
            kw["deep_state"] = st["deep"]
        tracing.phase("denoise.forward")
        eps, c0, c1, deep_out = self._cfg_step(
            latents, t, coeffs, guidance,
            lambda lat_in, t2: self.denoiser_forward(lat_in, t2, cond,
                                                     ctx=seam, **kw))
        new_kv = seam.new_kv
        self.displaced_steps["stale" if stale else "sync"] += 1
        if displaced and not stateful:
            st["kv"][mode or "dense"] = new_kv
        st["warm"] += 1
        if mode == "full":
            st["deep"], st["deep_age"] = deep_out, 0
        elif mode == "shallow":
            st["deep_age"] += 1
        if deep_on:
            # ESyMReD's deep-phase admission gate reads the cadence here
            for r in reqs:
                r.deep_state, r.deep_age = st["deep"], st["deep_age"]
        if stateful:
            self._init_sampler_state(reqs)
            state = {k: torch.cat([r.sampler_state[k] for r in reqs])
                     for k in reqs[0].sampler_state}
            new_latents, new_state = self.sampler.step_with_state(
                latents, eps, c0, c1, state)
            for i, r in enumerate(reqs):
                r.sampler_state = {k: a[i:i + 1] for k, a in new_state.items()}
        else:
            new_latents = self.sampler.step(latents, eps, c0, c1)
        self._trim_row_state(self._disp_state)
        return new_latents

    def _sp_chunk(self, reqs_by_res, k: int, mixed: bool = False) -> bool:
        """A chunk under sp > 1: its k steps run one after another through
        the sharded step (eager, no step graphs), the dense step's or
        (``mixed``) the mixed one's; False where JAX refuses a chunk
        (``sp_mode="displaced"``, JAX base.py:525-747 and :2010-2334; a
        stateful sampler; a request with fewer than k steps; the adaptive
        refresh or ``deep_predict``; on the dense path mixed resolutions;
        on the patch path a resolution that does not divide into
        patches)."""
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        cc = self.config.cache
        if (not ordered or k <= 1 or self._displaced_requested()
                or self.sampler.needs_state
                or any(r.remain_steps < k for r in ordered)
                or (cc.enabled and cc.mode == "deep"
                    and (cc.deep_adaptive or cc.deep_predict))):
            return False
        if not mixed and len({r.resolution for r in ordered}) != 1:
            return False
        cells = self.config.scheduler.patch_size // self.vae_scale
        if mixed and any(r.latent_hw(self.vae_scale) % cells
                         for r in ordered):
            return False
        step = self.denoise_step_mixed if mixed else self.denoise_step
        for _ in range(k):
            step(reqs_by_res)
        return True

    # -- the compact cache on the dense path (CacheConfig.mode "compact") ---

    def _compact_cache_active(self) -> bool:
        return (self.config.cache.enabled
                and self.config.cache.mode == "compact"
                and hasattr(self.bundle.denoiser, "cache_layout"))

    def _denoise_group_compact(self, reqs, latents, t, coeffs, guidance,
                               cond):
        """One compact-cache step of a resolution group; returns the
        bucket's new latents.  Rows are whole images (CFG-doubled,
        ``[uncond x bb | cond x bb]``), independent under every pair, so
        each gated pair recomputes its most-drifted rows and splices cached
        outputs into the rest; the batch's pad rows rank last.  The rows
        live in the composition's ``"unet_compact"`` entry; a fresh entry's
        first step runs at full capacity (``compact_sync``) to anchor
        them."""
        res = reqs[0].resolution
        bb = bucket_for(len(reqs), self.config.scheduler.batch_buckets)
        latents, t, coeffs, guidance = (_pad_batch(a, bb) for a in
                                        (latents, t, coeffs, guidance))
        cond = {key: _pad_batch(a, bb) for key, a in cond.items()}
        tracing.phase("denoise.decide")
        cache = self._block_cache()
        cc = self.config.cache
        layout = self.bundle.denoiser.cache_layout(res // self.vae_scale,
                                                   cc.min_level)

        def mk_state(n):
            return {key: cache.init_rows(key, n, s, c_in, c_out,
                                         self.bundle.dtype, self.device)
                    for key, (s, c_in, c_out) in layout.items()}

        sig = (type(cache).__name__, cc.min_level, cc.compact_fraction)
        entry = self._comp_state_entry("unet_compact", res, reqs, bb, sig,
                                       mk_state)
        tracing.phase("denoise.forward")
        out = self._compact_step(latents, t, coeffs, guidance, cond,
                                 entry["state"], self._row_valid(len(reqs), bb),
                                 sync=not entry["anchored"])
        entry["anchored"] = True
        return out

    def _compact_step(self, latents, t, coeffs, guidance, cond, state,
                      row_valid, sync: bool):
        """One compact-cache step of the padded batch over the rows
        ``state``; ``row_valid`` (bb,) marks the real rows, ``sync`` runs
        every row (the anchoring step)."""
        kwargs = dict(cache=self._block_cache(), cache_state=state,
                      row_valid=torch.cat([row_valid, row_valid]),
                      compact_sync=sync)
        noise_pred, c0, c1, _ = self._cfg_step(
            latents, t, coeffs, guidance,
            lambda lat_in, t2: self.denoiser_forward(lat_in, t2, cond,
                                                     **kwargs))
        return self.sampler.step(latents, noise_pred, c0, c1)

    def _row_valid(self, b: int, n: int) -> torch.Tensor:
        """(n,) bool: True at the batch's ``b`` real rows."""
        return torch.arange(n, device=self.device) < b

    # -- the deep cache on the dense path (CacheConfig.mode "deep") ----------

    def _deep_cache_active(self) -> bool:
        return (self.config.cache.enabled
                and self.config.cache.mode == "deep"
                and hasattr(self.bundle.denoiser, "shallow_cache_layout"))

    def _deep_state_shape(self, res: int) -> tuple:
        """A request's deep feature at ``res``: ``(2, C, h', w')``, the CFG
        halves of the feature entering up block ``n_levels - boundary``,
        at the spatial size of level ``boundary - 1``."""
        cfg = self.bundle.denoiser.cfg
        n = len(cfg.block_out_channels)
        bdy = self.config.cache.deep_boundary
        bdy = max(1, min(bdy if bdy is not None else n - 1, n - 1))
        hw = (res // self.vae_scale) >> (bdy - 1)
        return (2, cfg.block_out_channels[bdy], hw, hw)

    def _deep_policy(self):
        """(interval cap, warmup, adaptive?) of the deep-reuse decision."""
        cc = self.config.cache
        if cc.deep_adaptive:
            return max(cc.deep_max_interval, 1), cc.deep_warmup, True
        return max(cc.deep_interval, 1), cc.deep_warmup, False

    def _denoise_group_deep(self, reqs, latents, t, coeffs, guidance, cond):
        """One deep-cache step of a resolution group; returns the bucket's
        new latents.

        The batch shares one mode.  Full when a request has no usable deep
        feature or is in trajectory warmup, or when an incumbent's interval
        expired or (adaptive) its latent drifted past the threshold; with
        ``deep_row_warmup`` the warmup needs of a few requests are served
        by a partial step instead (the deep tail for their rows only);
        shallow otherwise.  Interval and drift expiry stay batch-wide: one
        aligned full re-syncs every age.
        """
        res = reqs[0].resolution
        bb = bucket_for(len(reqs), self.config.scheduler.batch_buckets)
        latents, t, coeffs, guidance = (_pad_batch(a, bb) for a in
                                        (latents, t, coeffs, guidance))
        cond = {key: _pad_batch(a, bb) for key, a in cond.items()}
        tracing.phase("denoise.decide")
        interval, warmup, adaptive = self._deep_policy()
        cc = self.config.cache
        want = self._deep_state_shape(res)

        def _warm_need(r):
            return (r.deep_state is None
                    or tuple(r.deep_state.shape) != want
                    or r.sampler_table.step < warmup)

        def _expired(r):
            return (r.deep_age >= interval - 1
                    or (adaptive and self._drift_exceeds(r)))

        need = [i for i, r in enumerate(reqs) if _warm_need(r)]
        expiry = any(_expired(r) for r in reqs if not _warm_need(r))
        entry = None
        if cc.deep_compact_fraction is not None:
            mk_state = self._hybrid_state_factory(res // self.vae_scale)
            if cc.deep_row_warmup:
                # an admission seeds the new composition's rows from the
                # previous one's survivors; an anchoring full is needed
                # only when the fresh pairs exceed the gate's capacity
                entry, fresh_pairs = self._hybrid_entry_carry(
                    res, reqs, bb, self._hybrid_sig(), mk_state)
                if (fresh_pairs > self._hybrid_pair_cap(bb)
                        or not entry["anchored"]):
                    expiry = True
            else:
                entry = self._comp_state_entry("unet_hybrid", res, reqs, bb,
                                               self._hybrid_sig(), mk_state)
                if not entry["anchored"]:
                    expiry = True  # the full step's write-through anchors
        kb = 1
        while kb < len(need):
            kb *= 2
        partial = (cc.deep_row_warmup and not expiry
                   and 0 < len(need) < len(reqs) and kb < bb)
        mode = ("partial" if partial
                else "full" if (need or expiry) else "shallow")
        need_set = set(need)

        # The batch-form carry: every step's deep output is the next step's
        # deep input for a stable composition, so it is kept per
        # composition instead of being rebuilt from the requests' features.
        carry_key = (res, bb, tuple(r.request_id for r in reqs))
        use_carry = cc.deep_row_warmup and not cc.deep_predict
        deep = None
        if mode != "full":
            deep = self._deep_carry_get(carry_key, reqs) if use_carry else None
        if mode != "full" and deep is None:
            if mode == "shallow":
                states = [self._deep_predicted(r) for r in reqs]
            else:
                # a refreshed row's input is overwritten by the scatter:
                # feed its stale feature where the shape fits, else zeros
                tmpl = next(r.deep_state for i, r in enumerate(reqs)
                            if i not in need_set)
                states = [
                    (r.deep_state if i in need_set
                     and r.deep_state is not None
                     and r.deep_state.shape == tmpl.shape
                     else torch.zeros_like(tmpl) if i in need_set
                     else self._deep_predicted(r))
                    for i, r in enumerate(reqs)]
            states += [states[-1]] * (bb - len(reqs))
            deep = torch.cat([s[0:1] for s in states]
                             + [s[1:2] for s in states])

        sel = None
        if mode == "partial":
            # bucketed to a power of two with copies of the first need
            sel = np.full((kb,), need[0], np.int64)
            sel[:len(need)] = need
            sel = torch.from_numpy(sel).to(self.device)
        self._record_mode(mode, len(reqs),
                          len(need) if mode == "partial" else 0)
        if entry is not None:
            # an un-anchored entry forces mode "full" above, whose
            # write-through anchors every gated pair's rows
            assert entry["anchored"] or mode == "full"
            if mode != "full":
                self._count_pairs(len(entry["state"]), len(reqs), bb)
        tracing.phase("denoise.forward")
        new_latents, deep_out = self._deep_step(
            mode, self._row_valid(len(reqs), bb), latents, t, coeffs,
            guidance, cond, deep, None if entry is None else entry["state"],
            sel)
        tracing.phase("denoise.update")
        if entry is not None and mode == "full":
            entry["anchored"] = True
        refreshed = (set(range(len(reqs))) if mode == "full"
                     else need_set if mode == "partial" else set())
        for i, r in enumerate(reqs):
            if i in refreshed:
                new = torch.stack([deep_out[i], deep_out[bb + i]])
                self._deep_update_slope(r, new)
                r.deep_state = new
                r.deep_age = 0
            else:
                r.deep_age += 1
            if adaptive:
                # refreshed: the reference is the latent the features were
                # computed from (this step's input); else this step's
                # output is the next decision's current latent
                self._note_drift(r, "full" if i in refreshed else "shallow",
                                 latents[i:i + 1] if i in refreshed
                                 else new_latents[i:i + 1])
        if use_carry:
            # after the update: the identities stored must be the features
            # the next step's decision sees
            self._deep_carry_put(carry_key, deep_out, reqs)
        return new_latents

    def _deep_step(self, mode, row_valid, latents, t, coeffs, guidance,
                   cond, deep, state, sel):
        """One deep-mode step of the padded batch: CFG forward in ``mode``
        (with the hybrid's row caches ``state`` when given: CFG-doubled
        rows ``[uncond x bb | cond x bb]``, the pad rows, False in
        ``row_valid``, masked out of the gates) and the sampler update.
        Returns ``(new_latents, deep_feature)``."""
        kwargs = dict(deep_mode=mode, deep_state=deep, deep_sel=sel)
        if state is not None:
            kwargs.update(cache=self._cache_obj, cache_state=state,
                          row_valid=torch.cat([row_valid, row_valid]))

        def call(lat_in, t2):
            out = self.denoiser_forward(lat_in, t2, cond, **kwargs)
            return out[0], out[1]

        noise_pred, c0, c1, deep_out = self._cfg_step(
            latents, t, coeffs, guidance, call)
        return self.sampler.step(latents, noise_pred, c0, c1), deep_out

    def _deep_carry_get(self, key, reqs):
        """The batch-form deep carry of this exact composition, valid only
        while every member's ``deep_state`` is the object recorded at put
        time (a request refreshed in another composition invalidates it)."""
        v = self._deep_carry.get(key)
        if v is None:
            return None
        carry, tokens = v
        if len(tokens) != len(reqs) or any(
                tok is not r.deep_state for tok, r in zip(tokens, reqs)):
            del self._deep_carry[key]
            return None
        self._deep_carry.move_to_end(key)
        return carry

    def _deep_carry_put(self, key, carry, reqs) -> None:
        store = self._deep_carry
        store[key] = (carry, [r.deep_state for r in reqs])
        store.move_to_end(key)
        while len(store) > 2:  # this composition and one predecessor
            store.popitem(last=False)

    # -- reuse-then-predict (CacheConfig.deep_predict) ----------------------

    def _deep_predicted(self, r):
        """The deep feature a shallow step feeds for ``r``: the last full
        pass's, extrapolated ``deep_age + 1`` steps along the velocity
        between the last two full passes when ``deep_predict`` is on."""
        m = self.config.cache.deep_predict
        if not m or r.deep_slope is None:
            return r.deep_state
        k = float(r.deep_age + 1)
        return (r.deep_state.float() + m * k * r.deep_slope.float()).to(
            r.deep_state.dtype)

    def _deep_update_slope(self, r, new) -> None:
        """On a refresh: the per-step feature velocity ``(new - old) /
        (deep_age + 1)``, stored in the feature's dtype; a layout change
        resets it."""
        if not self.config.cache.deep_predict:
            return
        old = r.deep_state
        if old is None or old.shape != new.shape:
            r.deep_slope = None
            return
        r.deep_slope = ((new.float() - old.float())
                        / (r.deep_age + 1)).to(new.dtype)

    # -- drift-triggered adaptive refresh (CacheConfig.deep_adaptive) -------

    def _drift_exceeds(self, r) -> bool:
        """True when the newest drift value that has reached the host
        crosses the threshold.  Pending values are polled newest first
        without blocking; the decision lags the device by at most the
        steps in flight, and ``deep_max_interval`` caps a stale read."""
        if r.lat_ref is None:
            return True
        pending = r.drift_pending
        for j in range(len(pending) - 1, -1, -1):
            if not pending[j].is_ready():
                continue
            r.drift_last = float(pending[j])
            del pending[: j + 1]
            break
        return r.drift_last > self.config.cache.deep_drift_threshold

    def _note_drift(self, r, mode: str, latent) -> None:
        """After a step: a refresh resets the reference latent; any other
        step queues its output's drift against it."""
        if mode == "full":
            r.lat_ref = latent
            r.drift_pending.clear()
            r.drift_last = 0.0
        else:
            r.drift_pending.append(_DriftScalar(_latent_drift(latent,
                                                              r.lat_ref)))

    # -- the deep x compact hybrid's row caches (deep_compact_fraction) ----

    def _hybrid_sig(self):
        """Composition-store signature: a knob that changes the state
        layout or the gating resets the state."""
        cc = self.config.cache
        return ("hybrid", cc.deep_compact_fraction, cc.deep_boundary)

    def _hybrid_pair_cap(self, bb: int) -> int:
        """The CFG pairs of a ``bb``-pair bucket that the hybrid's gates
        recompute in a dense shallow or partial step (the row gate's rows
        in pairs when ``deep_compact_pairwise`` is off)."""
        cc = self.config.cache
        if cc.deep_compact_pairwise:
            return BlockCache.pair_cap(bb, cc.deep_compact_fraction)
        return max(1, round(2 * bb * cc.deep_compact_fraction)) // 2

    def _hybrid_state_factory(self, cells: int, n_rows=None):
        """``mk_state(n)``: zero row caches for every pair a shallow step
        gates on a ``cells``-wide latent or patch (``shallow_cache_layout``),
        ``n`` rows, or ``n_rows`` when given (the patch path's rows are the
        doubled patch batch, whatever the store asks)."""
        if self._cache_obj is None:
            self._cache_obj = BlockCache(self.config.cache)
        cache = self._cache_obj
        layout = self.bundle.denoiser.shallow_cache_layout(
            cells, self.config.cache.deep_boundary)

        def mk_state(n):
            return {key: cache.init_rows(key, n_rows or n, s, c_in, c_out,
                                         self.bundle.dtype, self.device)
                    for key, (s, c_in, c_out) in layout.items()}

        return mk_state

    def _comp_state_entry(self, kind, res, reqs, bb, sig, mk_state) -> dict:
        """The row-cache entry of this batch composition, LRU- and
        byte-bounded.  A stable batch reuses its entry across steps; any
        change (membership, bucket, cache knobs) starts a fresh one,
        ``{"state": ..., "anchored": False}``, which must be anchored by a
        full step before any splice reads its zero out rows."""
        key = (kind, res, bb, tuple(r.request_id for r in reqs), sig)
        entry = self._comp_state.get(key)
        if entry is None:
            entry = {"state": mk_state(2 * bb), "anchored": False}
            self._comp_state[key] = entry
        self._comp_state.move_to_end(key)
        self._trim_comp_state()
        return entry

    def _hybrid_entry_carry(self, res, reqs, bb, sig, mk_state):
        """Get or create the hybrid entry with row carry-over
        (``deep_row_warmup``): a new composition's entry gathers the
        surviving requests' rows from the newest entry of the same
        resolution and signature.  New requests' rows keep the fresh init
        (``hits = max_hits``, forced into the next gate); carried rows'
        hits are clamped to ``max_hits - 1`` so that only the fresh ones
        are forced.  Returns ``(entry, fresh pairs at creation)``."""
        kind = "unet_hybrid"
        key = (kind, res, bb, tuple(r.request_id for r in reqs), sig)
        entry = self._comp_state.get(key)
        if entry is not None:
            self._comp_state.move_to_end(key)
            return entry, 0
        parent = next((pk for pk in reversed(self._comp_state)
                       if pk[0] == kind and pk[1] == res and pk[4] == sig),
                      None)
        if parent is None:
            entry = {"state": mk_state(2 * bb), "anchored": False}
            self._comp_state[key] = entry
            self._trim_comp_state()
            return entry, len(reqs)  # every pair fresh: anchor required
        old_bb = parent[2]
        pos = {rid: i for i, rid in enumerate(parent[3])}
        fresh = [i for i, r in enumerate(reqs) if r.request_id not in pos]
        # CFG-doubled row map [u x bb | c x bb]; -1 = a fresh row
        idx = np.full((2 * bb,), -1, np.int64)
        for j, r in enumerate(reqs):
            i = pos.get(r.request_id)
            if i is not None:
                idx[j] = i
                idx[bb + j] = old_bb + i
        parent_entry = self._comp_state.pop(parent)
        gather = torch.from_numpy(np.maximum(idx, 0))
        fresh_rows = torch.from_numpy(idx < 0)
        maxh = int(self.config.cache.max_hits)
        old, state = parent_entry["state"], {}

        # on every shard's part under sp (rows are batch rows there too)
        def carry(v):
            g, f = gather.to(v.device), fresh_rows.to(v.device)
            return v[g].masked_fill_(f.reshape((-1,) + (1,) * (v.dim() - 1)),
                                     0)

        def carry_hits(h):
            g, f = gather.to(h.device), fresh_rows.to(h.device)
            return torch.where(f, maxh, h[g].clamp(max=maxh - 1)).to(
                torch.int32)

        for k in list(old):
            st = old.pop(k)  # the parent's rows go as the new ones come
            new = {k2: tmap(carry, v) for k2, v in st.items()}
            new["hits"] = tmap(carry_hits, st["hits"])
            state[k] = new  # a fresh row's "seen" is False by the fill
        entry = {"state": state, "anchored": parent_entry["anchored"]}
        self._comp_state[key] = entry
        self._trim_comp_state()
        return entry, len(fresh)

    def _shrink_hybrid_entry(self, store, key, entry, live) -> None:
        """Gather the surviving requests' CFG-doubled rows into an entry of
        their smaller bucket (pads repeat the last live row), from which
        ``_hybrid_entry_carry`` seeds the next composition."""
        kind, res, bb, ids, sig = key
        nb = bucket_for(len(live), self.config.scheduler.batch_buckets)
        pos = {rid: i for i, rid in enumerate(ids)}
        idx = [pos[live[min(j, len(live) - 1)]] for j in range(nb)]
        g = torch.tensor(idx + [i + bb for i in idx])
        state = {k: {k2: tmap(lambda v: v[g.to(v.device)], v)
                     for k2, v in st.items()}
                 for k, st in entry["state"].items()}
        store[(kind, res, nb, tuple(live), sig)] = {"state": state,
                                                    "anchored": True}
        self._trim_comp_state()

    def _trim_comp_state(self) -> None:
        """Evict the oldest entries past ``comp_state_lru`` entries, then
        keep the row state within ``comp_state_bytes``
        (:meth:`_trim_row_state`)."""
        store = self._comp_state
        lru = max(int(self.config.cache.comp_state_lru), 1)
        while len(store) > lru:
            store.popitem(last=False)
        self._trim_row_state(store)

    def _trim_row_state(self, store) -> None:
        """Keep the row state, the composition stores' and the step sets'
        buffers together (:meth:`_row_state_bytes`), within
        ``comp_state_bytes``: first drop the oldest step sets whose rows
        no live entry holds (their graphs go with them; the newest set
        stays), then the oldest entries of ``store``, always keeping its
        newest."""
        budget = float(self.config.cache.comp_state_bytes)
        while self._row_state_bytes() > budget:
            if self.graphs.drop_idle(self._entry_live):
                continue
            if len(store) <= 1:
                break
            store.popitem(last=False)

    def _live_entries(self) -> list:
        """The composition stores' entries."""
        return list(self._comp_state.values())

    def _entry_live(self, entry: dict) -> bool:
        return any(entry is e for e in self._live_entries())

    def release_serving_state(self) -> None:
        """Drop every composition's row caches and deep carry, the sp
        step's K/V state, and the step sets holding row state, with their
        graphs."""
        self._comp_state.clear()
        self._deep_carry.clear()
        self._disp_state.clear()
        self._batch_rows.clear()
        self.graphs.drop_rows()

    def evict_finished_state(self, req_ids) -> None:
        """Drop the composition-state entries of any finished or aborted
        request: their keys hold the exact request-id tuple, so they can
        never be used again.  With ``deep_row_warmup`` an anchored dense
        hybrid entry's survivors keep their rows in a shrunk entry, so that
        a finish does not cost the next composition an anchoring full; a
        patch-path entry (``"unet_hybrid_mixed"``) just goes."""
        ids = set(req_ids)
        if not ids:
            return
        for k in [k for k in self._deep_carry if ids.intersection(k[2])]:
            del self._deep_carry[k]
        for k in [k for k in self._disp_state if ids.intersection(k[2])]:
            del self._disp_state[k]
        self._release_batch_rows(ids, finished=True)
        store = self._comp_state
        for k in [k for k in store if ids.intersection(k[3])]:
            entry = store.pop(k)
            if (self.config.cache.deep_row_warmup and k[0] == "unet_hybrid"
                    and entry["anchored"]):
                live = [rid for rid in k[3] if rid not in ids]
                if live:
                    self._shrink_hybrid_entry(store, k, entry, live)

    # -- stage 2b: one denoising step on the mixed patch path ---------------

    @torch.inference_mode()
    def denoise_step_mixed(self, reqs_by_res: Dict[int, List[Request]]) -> None:
        """ONE denoiser step over a mixed-resolution patch batch.

        All requests share one UNet forward: latents are cut into
        ``patch_size`` patches, concatenated patch-major (requests sorted by
        resolution) and padded to the patch bucket, and the patch context
        provides halo convs, per-image group norm and grouped attention.
        A resolution that does not divide into patches falls back to the
        dense step, and so does a stateful sampler with a cache enabled (as
        in the JAX package).  The JAX package routes a composition whose
        compiled program is not warm yet to the dense step for a while;
        eager PyTorch compiles nothing, so the port always runs patched.

        With the deep cache the step is full or shallow for the whole batch
        (``_deep_mode_mixed``); the hybrid's row caches live in the
        ``"unet_hybrid_mixed"`` entry of this composition, and a fresh entry
        forces an anchoring full step.  With the block or compact cache
        the requests' rows are gathered into the batch and scattered back
        (``_gather_cache_state``).
        """
        if self.sampler.needs_state and self.config.cache.enabled:
            return self.denoise_step(reqs_by_res)
        tracing.phase("denoise.decide")
        ordered: List[Request] = []
        for res in sorted(reqs_by_res):
            ordered.extend(reqs_by_res[res])
        sc = self.config.scheduler
        cells = sc.patch_size // self.vae_scale
        grids = []
        for r in ordered:
            hw = r.latent_hw(self.vae_scale)
            if hw % cells != 0:
                return self.denoise_step(reqs_by_res)
            grids.append(hw // cells)
        grids = tuple(grids)
        meta = patching.build_meta(grids, cells, tuple(sc.patch_buckets),
                                   tuple(sc.batch_buckets))
        meta2 = patching.double_meta(grids, cells, tuple(sc.patch_buckets),
                                     tuple(sc.batch_buckets))
        dev = self.device
        deep_mode = self._deep_mode_mixed(ordered, grids)
        entry = None
        if (deep_mode is not None
                and self.config.cache.deep_compact_fraction is not None):
            sig = (self._hybrid_sig() + ("mixed",) + meta.compile_key
                   + meta2.compile_key)
            entry = self._comp_state_entry(
                "unet_hybrid_mixed", 0, ordered, meta.i_pad, sig,
                self._hybrid_state_factory(cells, meta2.p_pad))
            if not entry["anchored"]:
                deep_mode = "full"  # the write-through anchors fresh rows

        tracing.phase("denoise.batch")
        x, guidance, cond = self._patch_batch(ordered, meta, cells)

        # per-image rows padded to i_pad (coefficients with 1.0, so the pad
        # slots' sampler math stays finite)
        def pad_i(arr, fill=0.0):
            out = np.full((meta.i_pad,) + arr.shape[1:], fill, arr.dtype)
            out[: arr.shape[0]] = arr
            return torch.from_numpy(out).to(dev)

        tables = [r.sampler_table for r in ordered]
        t = pad_i(gather_timesteps(tables))
        coeffs = pad_i(gather_coeffs(tables), fill=1.0)

        ctx1, ctx2 = PatchContext(meta, dev), PatchContext(meta2, dev)
        # the JAX branch order: the deep cache (with or without the
        # hybrid), a stateful sampler, cache-off, then the block cache
        cache = self._block_cache()
        tracing.phase("denoise.forward")
        if deep_mode is not None:
            self._record_mode(deep_mode, len(ordered))
            if entry is not None:
                assert entry["anchored"] or deep_mode == "full"
                if deep_mode != "full":
                    self._count_image_pairs(len(entry["state"]), meta2)
            new_x, deep_out = self._deep_step_mixed(
                deep_mode, x, t, coeffs, guidance, cond, ctx1, ctx2,
                self._gather_deep_mixed(ordered, grids, meta, deep_mode),
                None if entry is None else entry["state"])
            if entry is not None and deep_mode == "full":
                entry["anchored"] = True
            self._scatter_deep_mixed(ordered, grids, meta, deep_mode,
                                     deep_out)
        elif self.sampler.needs_state:
            state = self._gather_sampler_state_mixed(ordered, grids, cells,
                                                     meta.p_pad)
            new_x, new_state = self._mixed_fn(x, t, coeffs, guidance, cond,
                                              ctx1, ctx2, state)
            self._scatter_sampler_state_mixed(ordered, grids, cells,
                                              new_state)
        elif cache is None:
            new_x = self._mixed_fn(x, t, coeffs, guidance, cond, ctx1, ctx2)
        elif self._sp() > 1:
            state = self._batch_cache_rows(ordered, grids, meta, cells)
            new_x, _ = self._mixed_fn(x, t, coeffs, guidance, cond, ctx1,
                                      ctx2, deep=dict(cache=cache,
                                                      cache_state=state))
        else:
            state = self._gather_cache_state(ordered, grids, meta, cells)
            new_x, _ = self._mixed_fn(x, t, coeffs, guidance, cond, ctx1,
                                      ctx2, deep=dict(cache=cache,
                                                      cache_state=state))
            self._scatter_cache_state(ordered, grids, meta, state)
        tracing.phase("denoise.update")
        adaptive = deep_mode is not None and self.config.cache.deep_adaptive
        off = 0
        for r, g in zip(ordered, grids):
            n = g * g
            prev = r.latents
            r.latents = patching.merge_patches(new_x[off:off + n], g)
            off += n
            r.sampler_table.advance()
            r.remain_steps -= 1
            if adaptive:
                # full: the reference is this step's input, the latent the
                # deep features came from; shallow: this step's output
                self._note_drift(r, deep_mode,
                                 prev if deep_mode == "full" else r.latents)

    def _patch_batch(self, ordered, meta, cells: int):
        """``(x, guidance, cond)`` of a patch batch: the requests' patches,
        patch-major, zero-padded to ``meta.p_pad``; guidance and
        conditioning per image, zero-padded to ``meta.i_pad``."""
        x = torch.cat([patching.split_latent(r.latents, cells)
                       for r in ordered], dim=0)
        x = torch.cat([x, x.new_zeros((meta.p_pad - x.shape[0],)
                                      + x.shape[1:])], dim=0)
        guidance = np.zeros((meta.i_pad,), np.float32)
        guidance[:len(ordered)] = [
            r.params.guidance_scale if r.params.guidance_scale is not None
            else self.spec.default_guidance for r in ordered]
        cond = {}
        for key in ordered[0].conditioning:
            arr = torch.cat([r.conditioning[key] for r in ordered], dim=0)
            cond[key] = torch.cat([arr, arr.new_zeros(
                (meta.i_pad - arr.shape[0],) + arr.shape[1:])], dim=0)
        return x, torch.from_numpy(guidance).to(self.device), cond

    def _mixed_fn(self, x, t, coeffs, guidance, cond, ctx1, ctx2, state=None,
                  deep=None):
        """CFG duplicate -> scale -> patched model -> combine -> sampler
        step, per patch with its image's coefficients (rows go uncond
        block first, then cond, as in the JAX ``_make_mixed_fn``).  With a
        patch-sliced sampler ``state`` it returns ``(x, new_state)``: the
        stateful update is element-wise, so it is exact per patch.  With
        ``deep`` (the UNet's cache keywords) it returns ``(x, second
        output)``: the deep feature, or the cache state without a deep
        mode."""
        c0, c1 = coeffs[:, 0], coeffs[:, 1]  # per image (i_pad,)
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        x2 = self.sampler.scale_model_input(x2, torch.cat([c0, c0])[ctx2.image_id])
        out = self.denoiser_forward(x2, t2, cond, ctx=ctx2, **(deep or {}))
        model_out, feature = (out[0], out[1]) if deep else (out, None)
        uncond, text = model_out.chunk(2, dim=0)
        g = guidance[ctx1.image_id].reshape(-1, 1, 1, 1)
        noise_pred = uncond + g * (text - uncond)
        c0p, c1p = c0[ctx1.image_id], c1[ctx1.image_id]
        if state is not None:
            return self.sampler.step_with_state(x, noise_pred, c0p, c1p, state)
        stepped = self.sampler.step(x, noise_pred, c0p, c1p)
        return stepped if deep is None else (stepped, feature)

    # -- the block and compact caches' rows on the patch path ----------------

    def _block_cache(self):
        """The gates of modes "block" and "compact" for a UNet, or None
        (the SD3 pipeline's token caches read the same ``_cache_obj``)."""
        cc = self.config.cache
        if not cc.enabled or cc.mode not in ("block", "compact"):
            return None
        if not hasattr(self.bundle.denoiser, "cache_layout"):
            return None
        if self._cache_obj is None:
            self._cache_obj = BlockCache(cc)
        return self._cache_obj

    def _gather_cache_state(self, ordered, grids, meta, cells) -> dict:
        """Each request's rows, laid out like the doubled patch batch
        (``[uncond | pad | cond | pad]``, the pads fresh rows).  A request
        keeps ``2 g^2`` rows a pair, its uncond patches then its cond ones;
        missing rows and rows of another patch grid are initialised
        anew."""
        cache = self._block_cache()
        layout = self.bundle.denoiser.cache_layout(
            cells, self.config.cache.min_level)
        dtype, dev = self.bundle.dtype, self.device
        first = next(iter(layout))
        for r, g in zip(ordered, grids):
            rows = r.cache_rows
            if (rows is None or first not in rows
                    or rows[first]["inp"].shape[0] != 2 * g * g):
                r.cache_rows = {
                    key: cache.init_rows(key, 2 * g * g, s, c_in, c_out,
                                         dtype, dev)
                    for key, (s, c_in, c_out) in layout.items()}
        pad = meta.p_pad - sum(g * g for g in grids)
        state = {}
        for key, (s, c_in, c_out) in layout.items():
            halves = ([], [])
            for r, g in zip(ordered, grids):
                rows = r.cache_rows[key]
                halves[0].append({k: a[:g * g] for k, a in rows.items()})
                halves[1].append({k: a[g * g:] for k, a in rows.items()})
            if pad:
                fresh = cache.init_rows(key, pad, s, c_in, c_out, dtype, dev)
                halves[0].append(fresh)
                halves[1].append(fresh)
            parts = halves[0] + halves[1]
            state[key] = {k: torch.cat([p[k] for p in parts])
                          for k in parts[0]}
        return state

    def _batch_cache_rows(self, ordered, grids, meta, cells) -> dict:
        """The patch batch's rows under sp: they stay on the shards (the
        sharded route splits them at their first forward) in one
        :class:`_BatchRows` of the store ``_batch_rows``.  A stable
        composition reuses it as it is; any other first gives the requests
        of every stored batch it shares a request with their rows back
        (:meth:`_release_batch_rows`), then lays out the new batch as
        :meth:`_gather_cache_state` does."""
        ids = tuple(r.request_id for r in ordered)
        rows = self._batch_rows.get(ids)
        if rows is not None and rows.meta is meta:
            return rows.state
        self._release_batch_rows(set(ids))
        rows = _BatchRows(list(ordered), meta,
                          self._gather_cache_state(ordered, grids, meta,
                                                   cells))
        for r in ordered:
            r.cache_rows = None
        self._batch_rows[ids] = rows
        return rows.state

    def _release_batch_rows(self, ids, finished: bool = False) -> None:
        """Drop every stored batch of rows that holds one of ``ids``, and
        give its requests their rows back, ``2 g^2`` a pair, whole on the
        lead device; with ``finished`` (``ids`` have finished) only the
        others take theirs."""
        def whole(v):
            if not isinstance(v, ShardedTensor):
                return v
            return torch.cat([v.parts[q].to(self.device)
                              for q in self.group.lead_ranks()])

        for key in [k for k in self._batch_rows if ids.intersection(k)]:
            rows = self._batch_rows.pop(key)
            if finished and ids.issuperset(key):
                continue
            state = {name: {k: whole(v) for k, v in entry.items()}
                     for name, entry in rows.state.items()}
            off = 0
            for r, g in zip(rows.reqs, rows.meta.grids):
                n, c = g * g, rows.meta.p_pad + off
                off += n
                if not (finished and r.request_id in ids):
                    r.cache_rows = {
                        name: {k: torch.cat([a[off - n:off], a[c:c + n]])
                               for k, a in entry.items()}
                        for name, entry in state.items()}

    def _scatter_cache_state(self, ordered, grids, meta, state) -> None:
        """The batch's updated rows back to each request (inverse of
        :meth:`_gather_cache_state`)."""
        for key, entry in state.items():
            off = 0
            for r, g in zip(ordered, grids):
                n, c = g * g, meta.p_pad + off
                r.cache_rows[key] = {
                    k: torch.cat([a[off:off + n], a[c:c + n]])
                    for k, a in entry.items()}
                off += n

    # -- the deep cache on the patch path ------------------------------------

    def _deep_mode_mixed(self, ordered, grids):
        """The batch-wide full/shallow decision of a mixed step, on the
        host (None with the deep cache off).  Full when any request has no
        deep feature, is at its interval cap or in warmup, holds a feature
        of another layout (its batch was on the dense path) or (adaptive)
        drifted past the threshold."""
        if not self._deep_cache_active():
            return None
        interval, warmup, adaptive = self._deep_policy()
        need_full = any(
            r.deep_state is None or r.deep_age >= interval - 1
            or r.sampler_table.step < warmup
            or r.deep_state.shape[0] != 2 * g * g
            or (adaptive and self._drift_exceeds(r))
            for r, g in zip(ordered, grids))
        return "full" if need_full else "shallow"

    def _gather_deep_mixed(self, ordered, grids, meta, mode):
        """A shallow step's deep input: each request's (predicted) feature
        rows laid out like the doubled patch batch, ``[uncond | pad | cond
        | pad]``, the pads zero.  None for a full step."""
        if mode != "shallow":
            return None
        halves = ([], [])
        for r, g in zip(ordered, grids):
            n = g * g
            dp = self._deep_predicted(r)
            halves[0].append(dp[:n])
            halves[1].append(dp[n:])
        pad = meta.p_pad - sum(g * g for g in grids)
        if pad:
            z = halves[0][0].new_zeros((pad,) + tuple(halves[0][0].shape[1:]))
            halves[0].append(z)
            halves[1].append(z)
        return torch.cat(halves[0] + halves[1])

    def _scatter_deep_mixed(self, ordered, grids, meta, mode, deep_out):
        """After a full step each request keeps its ``(2 g^2, C, s', s')``
        rows of the new feature (uncond patches, then cond); a shallow
        step ages them."""
        off = 0
        for r, g in zip(ordered, grids):
            n = g * g
            if mode == "full":
                cond = meta.p_pad + off
                new = torch.cat([deep_out[off:off + n],
                                 deep_out[cond:cond + n]])
                self._deep_update_slope(r, new)
                r.deep_state = new
                r.deep_age = 0
            else:
                r.deep_age += 1
            off += n

    def _deep_step_mixed(self, mode, x, t, coeffs, guidance, cond, ctx1,
                         ctx2, deep, state):
        """One deep-mode step of the patch batch (with the hybrid's rows
        ``state`` when given); returns ``(new_x, deep_feature)``."""
        kwargs = dict(deep_mode=mode, deep_state=deep)
        if state is not None:
            kwargs.update(cache=self._cache_obj, cache_state=state)
        return self._mixed_fn(x, t, coeffs, guidance, cond, ctx1, ctx2,
                              deep=kwargs)

    # -- stateful sampler state on the patch path ---------------------------

    @staticmethod
    def _sampler_state_to_patches(leaf, g: int, cells: int):
        """``(1, *L, h, w, C)`` -> ``(g*g, *L, s, s, C)``, sliced exactly
        like the latents; a per-request scalar row ``(1,)`` is repeated per
        patch."""
        if leaf.dim() < 4:
            return leaf.expand((g * g,) + tuple(leaf.shape[1:]))
        lead = tuple(leaf.shape[1:-3])
        parts = [patching.split_latent(flat[None], cells)
                 for flat in leaf.reshape((-1,) + tuple(leaf.shape[-3:]))]
        stacked = torch.stack(parts, dim=1)  # (g*g, K, s, s, C)
        return stacked.reshape((g * g,) + lead + tuple(stacked.shape[-3:]))

    @staticmethod
    def _sampler_state_from_patches(leaf, g: int, cells: int):
        """Inverse of :meth:`_sampler_state_to_patches` (a scalar row takes
        patch 0's value)."""
        if leaf.dim() < 4:
            return leaf[:1]
        lead = tuple(leaf.shape[1:-3])
        flat = leaf.reshape((g * g, -1) + tuple(leaf.shape[-3:]))
        merged = torch.stack([patching.merge_patches(flat[:, k], g)[0]
                              for k in range(flat.shape[1])])  # (K, h, w, C)
        return merged.reshape((1,) + lead + tuple(merged.shape[-3:]))

    def _init_sampler_state(self, reqs) -> None:
        """A request's state starts at its first step (zeros, count 0)."""
        for r in reqs:
            if r.sampler_state is None:
                r.sampler_state = self.sampler.init_state(r.latents)

    def _gather_sampler_state_mixed(self, ordered, grids, cells, p_pad):
        """Per-request dense sampler state -> one patch-major batch, padded
        with zero rows to ``p_pad`` patches."""
        self._init_sampler_state(ordered)
        out = {}
        for key in ordered[0].sampler_state:
            a = torch.cat([self._sampler_state_to_patches(
                r.sampler_state[key], g, cells) for r, g in zip(ordered, grids)])
            out[key] = torch.cat([a, a.new_zeros((p_pad - a.shape[0],)
                                                 + tuple(a.shape[1:]))])
        return out

    def _scatter_sampler_state_mixed(self, ordered, grids, cells, new_state):
        off = 0
        for r, g in zip(ordered, grids):
            n = g * g
            r.sampler_state = {key: self._sampler_state_from_patches(
                a[off:off + n], g, cells) for key, a in new_state.items()}
            off += n

    # -- fused multi-step dispatch (SchedulerConfig.steps_per_dispatch) -----

    def _record_mode(self, mode, rows: int, refreshed: int = 0) -> None:
        """The cache mode of one step of ``rows`` requests, ``refreshed``
        of them recomputing their deep feature in a partial step: appended
        to ``step_modes`` when a caller set it to a list, and counted on
        the stage span (the request-steps ``mode.<mode>``, ``refreshed``)."""
        if self.step_modes is not None:
            self.step_modes.append(mode)
        if tracing.enabled():
            tracing.count(f"mode.{mode}", rows)
            if refreshed:
                tracing.count("refreshed", refreshed)
            tracing.stage_set(mode=mode)

    def _count_pairs(self, gated: int, rows: int, bb: int) -> None:
        """Count on the stage span the real CFG pairs that the hybrid's
        ``gated`` pair gates score in a dense shallow or partial step of
        ``rows`` requests padded to ``bb`` (``pairs``), and those they
        recompute (``pairs_fresh``): each gate takes its cap's most drifted
        pairs, and the pad pairs rank last.  The row gate
        (``deep_compact_pairwise`` off) scores rows, not pairs: uncounted."""
        if tracing.enabled() and self.config.cache.deep_compact_pairwise:
            tracing.count("pairs", gated * rows)
            tracing.count("pairs_fresh",
                          gated * min(self._hybrid_pair_cap(bb), rows))

    def _count_image_pairs(self, gated: int, meta2) -> None:
        """:meth:`_count_pairs` on the patch path: the hybrid's ``gated``
        image gates on the CFG-doubled composition ``meta2`` score its real
        images' pairs and recompute the real images of their capacities,
        both halves of an image together (``patching.gate_images``)."""
        if tracing.enabled():
            _, caps = patching.compact_submeta(
                meta2.patch_cells, meta2.class_info,
                self.config.cache.deep_compact_fraction, True)
            tracing.count("pairs", gated * (meta2.n_images // 2))
            tracing.count("pairs_fresh", gated
                          * sum(patching.gate_images(meta2, caps)) // 2)

    def _run_chunk(self, sset, per_step: dict, kinds, make_step) -> None:
        """A chunk's steps on the step set ``sset``: before step j each
        ``per_step`` table's row j (device, ``(k, ...)``) goes into the
        buffer of its name, then the step of ``kinds[j]`` runs
        (``pipelines/graphs.py``)."""
        for name, rows in per_step.items():
            sset.load(name, rows[0])
        for j, kind in enumerate(kinds):
            if j:
                for name, rows in per_step.items():
                    sset.bufs[name].copy_(rows[j])
            sset.run(kind, make_step(kind))

    def _step_rows(self, tables, k: int, n_t: int, n_c: int,
                   repeat: bool) -> torch.Tensor:
        """``(k, n_t + 2 n_c)`` float32 on the device: the chunk's steps'
        timesteps, padded to ``n_t`` rows, then their ``[coeff_t,
        coeff_next]`` rows, padded to ``n_c``.  Pads repeat the last row
        (``repeat``, the dense path) or are 0 and 1 (the patch path); split
        with :func:`_split_tc`."""
        ts = np.stack([tb.timesteps[tb.step:tb.step + k] for tb in tables],
                      1).astype(np.float32)
        cs = np.stack([tb.coeffs[tb.step:tb.step + k, :2] for tb in tables],
                      1).astype(np.float32)

        def pad(a, n, fill):
            if a.shape[1] == n:
                return a
            extra = (np.repeat(a[:, -1:], n - a.shape[1], 1) if repeat else
                     np.full((k, n - a.shape[1]) + a.shape[2:], fill,
                             np.float32))
            return np.concatenate([a, extra], 1)

        rows = np.concatenate([pad(ts, n_t, 0.0),
                               pad(cs, n_c, 1.0).reshape(k, -1)], 1)
        return torch.from_numpy(rows).to(self.device)

    def _finish_chunk(self, ordered, k: int) -> None:
        for r in ordered:
            for _ in range(k):
                r.sampler_table.advance()
            r.remain_steps -= k
        # the chunk's set is the newest: older sets' rows may go
        self._trim_row_state(self._state_store())

    def _state_store(self):
        """The composition store whose entries a chunk's trim may evict."""
        return self._comp_state

    @torch.inference_mode()
    def denoise_chunk(self, reqs_by_res: Dict[int, List[Request]],
                      k: int) -> bool:
        """Run ``k`` sampler steps of a uniform dense batch in one dispatch
        (JAX base.py:525-747): on the card k replays of captured step
        graphs, on the CPU k eager steps on the same buffers.  True when
        the chunk ran (tables and latents advanced by ``k``), False when
        the configuration is not eligible, exactly where JAX refuses: the
        worker then runs the per-step path.

        Modes: ``dense``; ``compact`` once its entry is anchored; ``deep``
        and ``hybrid`` from a full boundary, step j full when ``j % itv ==
        0``; with ``deep_row_warmup`` ``partial`` and ``hybrid_partial``,
        whose steps follow :meth:`_plan_partial_chunk` (0 shallow, 1
        partial over the planned rows, 2 full).  The drift-adaptive refresh
        and ``deep_predict`` decide on the host each step: refused.  The
        dense mode runs the real batch like the per-step dense step; the
        others pad it to its bucket, as theirs do.  One difference from
        JAX: a ``hybrid_partial`` entry created here with more fresh pairs
        than the gate's capacity is marked un-anchored before the refusal,
        so the per-step path runs the anchoring full it would have run
        (JAX's per-step path finds the entry made and skips it)."""
        if self._sp() > 1:
            return self._sp_chunk(reqs_by_res, k)
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        if not ordered or k <= 1:
            return False
        cc = self.config.cache
        if (len({r.resolution for r in ordered}) != 1
                or self.sampler.needs_state
                or any(r.remain_steps < k for r in ordered)
                or self.config.parallel.sp_mode == "displaced"):
            return False
        res = ordered[0].resolution
        b = len(ordered)
        bb = bucket_for(b, self.config.scheduler.batch_buckets)
        itv = max(cc.deep_interval, 1)
        mode, entry, plan = "dense", None, None
        if cc.enabled and cc.mode == "deep":
            if cc.deep_adaptive or cc.deep_predict:
                return False
            if cc.deep_row_warmup and itv > 1:
                plan = self._plan_partial_chunk(ordered, k, itv, bb)
                if plan is None:
                    return False
                mode = "partial"
                if cc.deep_compact_fraction is not None:
                    mode = "hybrid_partial"
                    entry, fresh = self._hybrid_entry_carry(
                        res, ordered, bb, self._hybrid_sig(),
                        self._hybrid_state_factory(res // self.vae_scale))
                    if fresh > self._hybrid_pair_cap(bb):
                        entry["anchored"] = False
                    if not entry["anchored"]:
                        return False  # the per-step anchoring full first
            else:
                if any(r.sampler_table.step < cc.deep_warmup
                       for r in ordered):
                    return False
                mode = ("hybrid" if cc.deep_compact_fraction is not None
                        else "deep")
                # the chunk starts where the per-step path runs a full
                # (lockstep ages from j = 0), from dense-layout features
                shapes = {None if r.deep_state is None
                          else tuple(r.deep_state.shape) for r in ordered}
                if (None in shapes or len(shapes) != 1
                        or next(iter(shapes))[0] != 2):
                    return False
                if not any(r.deep_age + 1 >= itv for r in ordered):
                    return False
                if mode == "hybrid":
                    entry = self._comp_state_entry(
                        "unet_hybrid", res, ordered, bb, self._hybrid_sig(),
                        self._hybrid_state_factory(res // self.vae_scale))
        elif cc.enabled and cc.mode == "compact":
            if not self._compact_cache_active():
                return False
            cache = self._block_cache()
            layout = self.bundle.denoiser.cache_layout(
                res // self.vae_scale, cc.min_level)

            def mk_state(n):
                return {key: cache.init_rows(key, n, s, c_in, c_out,
                                             self.bundle.dtype, self.device)
                        for key, (s, c_in, c_out) in layout.items()}

            entry = self._comp_state_entry(
                "unet_compact", res, ordered, bb,
                (type(cache).__name__, cc.min_level, cc.compact_fraction),
                mk_state)
            if not entry["anchored"]:
                return False  # the anchoring sync step runs per-step
            mode = "compact"
        elif cc.enabled:
            return False  # mode "block" on the dense path: per-step only

        n = b if mode == "dense" else bb
        # one step set for the modes that share their steps' buffers
        family = {"partial": "deep", "hybrid_partial": "hybrid"}.get(mode,
                                                                     mode)
        sig = (self._hybrid_sig() if family == "hybrid" else
               (cc.compact_fraction, cc.min_level) if family == "compact"
               else None)
        sset = self.graphs.step_set(("unet", family, res, n, sig))
        dev = self.device
        latents, guidance, cond = self._group_batch(ordered)
        sset.load("lat", _pad_batch(latents, n))
        sset.load("guid", _pad_batch(guidance, n))
        sset.load("cond", {key: _pad_batch(a, n) for key, a in cond.items()})
        sset.load("row_valid", self._row_valid(b, n))
        per_step = {"tc": self._step_rows(
            [r.sampler_table for r in ordered], k, n, n, repeat=True)}
        if entry is not None:
            sset.adopt("state", entry, self._entry_live)
        deep_modes = mode not in ("dense", "compact")
        carry_key = (res, bb, tuple(r.request_id for r in ordered))
        if mode in ("deep", "hybrid"):
            # the batch-form carry [uncond x bb | cond x bb]; the j = 0
            # full overwrites it
            states = [r.deep_state for r in ordered]
            states += [states[-1]] * (bb - b)
            sset.load("deep", torch.cat([s[0:1] for s in states]
                                        + [s[1:2] for s in states]))
            kinds = ["full" if j % itv == 0 else "shallow" for j in range(k)]
        elif deep_modes:
            sel, act, final_age, kb = plan
            carry = self._deep_carry_get(carry_key, ordered)
            if carry is None:
                # zeros for rows awaiting their first refresh: sel[0]
                # holds them, and the scatter writes them before any read
                want = self._deep_state_shape(res)
                dtype = self.bundle.dtype
                states = [r.deep_state if r.deep_state is not None
                          and tuple(r.deep_state.shape) == want
                          else torch.zeros(want, dtype=dtype, device=dev)
                          for r in ordered]
                states += [states[-1]] * (bb - b)
                carry = torch.cat([s[0:1] for s in states]
                                  + [s[1:2] for s in states])
            sset.load("deep", carry)
            per_step[f"sel{kb}"] = torch.from_numpy(
                sel.astype(np.int64)).to(dev)
            kinds = [("shallow", "partial", "full")[a] if a != 1
                     else ("partial", kb) for a in act]
        else:
            kinds = [mode] * k

        def make_step(kind):
            def step(bufs):
                t, c = _split_tc(bufs["tc"], n)
                args = (bufs["lat"], t, c, bufs["guid"], bufs["cond"])
                state = bufs.get("state")
                if kind == "dense":
                    store(bufs["lat"], self._denoise_fn(*args))
                    return
                if kind == "compact":
                    store(bufs["lat"], keep_leaves(
                        state, lambda: self._compact_step(
                            *args, state, bufs["row_valid"], sync=False)))
                    return
                dmode, sel = ((kind[0], bufs[f"sel{kind[1]}"])
                              if isinstance(kind, tuple) else (kind, None))
                lat, deep = self._deep_step(
                    dmode, bufs["row_valid"], *args,
                    None if dmode == "full" else bufs["deep"], state, sel)
                store(bufs["lat"], lat)
                store(bufs["deep"], deep)
            return step

        tracing.phase("denoise.forward")
        self._run_chunk(sset, per_step, kinds, make_step)
        tracing.phase("denoise.update")
        if deep_modes:
            for j, kind in enumerate(kinds):
                if isinstance(kind, str):
                    self._record_mode(kind, b)
                else:  # a partial step refreshes the planned rows sel[j]
                    self._record_mode(kind[0], b, len(set(plan[0][j])))
                if entry is not None and kind != "full":
                    self._count_pairs(len(entry["state"]), b, bb)
        if entry is not None:
            entry["anchored"] = True
        lat = sset.bufs["lat"]
        deep = sset.bufs.get("deep") if deep_modes else None
        for i, r in enumerate(ordered):
            r.latents = lat[i:i + 1].clone()
            if deep_modes:
                r.deep_state = torch.stack([deep[i], deep[bb + i]])
                r.deep_age = (final_age[i] if plan is not None
                              else (k - 1) % itv)
                r.deep_slope = None
        self._finish_chunk(ordered, k)
        if deep_modes and cc.deep_row_warmup:
            # after the update: the identities the next decision sees
            self._deep_carry_put(carry_key, deep.clone(), ordered)
        return True

    def _plan_partial_chunk(self, ordered, k: int, itv: int, bb: int):
        """The host's row-refresh plan of a k-step partial chunk (JAX
        base.py:1414-1482): ages and warmup evolve deterministically inside
        the window, so each step's per-step decision is known ahead.  Step
        j refreshes ``sel[j]``, its warmup rows (a missing or other-layout
        feature, or a step before ``deep_warmup``), padded to ``kb`` with
        copies of the first (``act[j] = 1``); a step where an incumbent's
        interval expires runs a batch-wide full (``act[j] = 2``, every age
        reset); a step with no need runs shallow (0).  Returns ``(sel (k,
        kb), act (k,), final ages, kb)``, or None when the window's needs
        reach the bucket."""
        warmup = max(self.config.cache.deep_warmup, 0)
        b = len(ordered)
        want = self._deep_state_shape(ordered[0].resolution)
        missing0 = [r.deep_state is None or tuple(r.deep_state.shape) != want
                    for r in ordered]
        age0 = [r.deep_age for r in ordered]
        step0 = [r.sampler_table.step for r in ordered]

        def plan(record):
            age, missing = list(age0), list(missing0)
            max_need = 1
            sel = np.zeros((k, record or 1), np.int32)
            act = np.zeros((k,), np.int32)
            for j in range(k):
                need = [i for i in range(b)
                        if missing[i] or step0[i] + j < warmup]
                need_set = set(need)
                if any(age[i] >= itv - 1 for i in range(b)
                       if i not in need_set):
                    act[j] = 2
                    age, missing = [0] * b, [False] * b
                    continue
                if need:
                    act[j] = 1
                    max_need = max(max_need, len(need))
                    if record:
                        row = need + [need[0]] * (record - len(need))
                        sel[j] = row[:record]
                for i in range(b):
                    if i in need_set:
                        age[i], missing[i] = 0, False
                    else:
                        age[i] += 1
            return sel, act, age, max_need

        max_need = plan(0)[3]
        kb = 1
        while kb < max_need:
            kb *= 2
        if kb >= bb:
            return None
        sel, act, final_age, _ = plan(kb)
        return sel, act, final_age, kb

    @torch.inference_mode()
    def denoise_chunk_mixed(self, reqs_by_res: Dict[int, List[Request]],
                            k: int) -> bool:
        """Run ``k`` steps of a mixed-resolution patch batch in one dispatch
        (JAX base.py:2010-2334); the composition is pinned for the chunk.
        True when it ran, False where JAX refuses: a stateful sampler, a
        request with fewer than ``k`` steps, a resolution that does not
        divide into patches, the adaptive refresh or ``deep_predict``,
        warmup, ages out of lockstep, or an un-anchored hybrid entry with
        no full due now (peeked before it is created, so that the per-step
        path runs its anchoring full).

        Modes: ``dense``; ``cached`` (modes "block"/"compact": the
        requests' rows gathered once, threaded through the chunk and
        scattered back); ``deep`` and ``hybrid`` at any interval phase:
        step j is full when ``(j + off) % itv == 0``, ``off = (a0 + 1) %
        itv``, with ``a0 = itv - 1`` when a batch-wide full is due now
        (the carry starts as zeros, written before any read) and the
        requests' common age otherwise.  Under sp > 1 the chunk's steps run
        eagerly through the sharded step (:meth:`_sp_chunk`)."""
        if self._sp() > 1:
            return self._sp_chunk(reqs_by_res, k, mixed=True)
        ordered: List[Request] = []
        for res in sorted(reqs_by_res):
            ordered.extend(reqs_by_res[res])
        if not ordered or k <= 1:
            return False
        if (self.sampler.needs_state
                or any(r.remain_steps < k for r in ordered)
                or self.config.parallel.sp_mode == "displaced"):
            return False
        sc, cc = self.config.scheduler, self.config.cache
        cells = sc.patch_size // self.vae_scale
        grids = []
        for r in ordered:
            hw = r.latent_hw(self.vae_scale)
            if hw % cells != 0:
                return False
            grids.append(hw // cells)
        grids = tuple(grids)
        cache = self._block_cache()
        mode, itv, need_full, a0 = "dense", 1, False, 0
        if self._deep_cache_active():
            if cc.deep_adaptive or cc.deep_predict:
                return False
            interval, warmup, _ = self._deep_policy()
            itv = max(interval, 1)
            if any(r.sampler_table.step < warmup for r in ordered):
                return False
            need_full = self._deep_mode_mixed(ordered, grids) == "full"
            if need_full:
                a0 = itv - 1
            else:
                ages = {r.deep_age for r in ordered}
                if len(ages) != 1:
                    return False
                a0 = ages.pop()
            mode = "hybrid" if cc.deep_compact_fraction is not None else "deep"
        elif cache is not None:
            mode = "cached"
        elif cc.enabled:
            return False
        meta = patching.build_meta(grids, cells, tuple(sc.patch_buckets),
                                   tuple(sc.batch_buckets))
        meta2 = patching.double_meta(grids, cells, tuple(sc.patch_buckets),
                                     tuple(sc.batch_buckets))
        dev = self.device
        entry = None
        sig = None
        if mode == "hybrid":
            sig = (self._hybrid_sig() + ("mixed",) + meta.compile_key
                   + meta2.compile_key)
            peeked = self._comp_state.get(
                ("unet_hybrid_mixed", 0, meta.i_pad,
                 tuple(r.request_id for r in ordered), sig))
            if not need_full and (peeked is None or not peeked["anchored"]):
                return False
            entry = self._comp_state_entry(
                "unet_hybrid_mixed", 0, ordered, meta.i_pad, sig,
                self._hybrid_state_factory(cells, meta2.p_pad))
        sset = self.graphs.step_set(("mixed", mode, meta.compile_key,
                                     meta2.compile_key, sig))
        if "ctx" not in sset.bufs:
            # the contexts (and the gates' sub-context) the graphs read:
            # held here, so that no lru cache frees them under a graph
            ctx2 = PatchContext(meta2, dev)
            sub = None
            if mode == "hybrid" or (mode == "cached"
                                    and cc.mode == "compact"):
                sub = compact_context(
                    meta2.patch_cells, meta2.class_info,
                    cc.deep_compact_fraction if mode == "hybrid"
                    else cc.compact_fraction, mode == "hybrid",
                    ctx2.image_id.device)
            sset.bufs["ctx"] = (PatchContext(meta, dev), ctx2, sub)
        ctx1, ctx2, _ = sset.bufs["ctx"]

        x, guidance, cond = self._patch_batch(ordered, meta, cells)
        sset.load("x", x)
        sset.load("guid", guidance)
        sset.load("cond", cond)
        per_step = {"tc": self._step_rows([r.sampler_table for r in ordered],
                                          k, meta.i_pad, meta.i_pad,
                                          repeat=False)}
        deep_modes = mode in ("deep", "hybrid")
        if deep_modes:
            if need_full:
                shape = self._deep_state_shape(sc.patch_size)
                sset.load("deep", torch.zeros(
                    (2 * meta.p_pad,) + shape[1:], dtype=self.bundle.dtype,
                    device=dev))
            else:
                sset.load("deep", self._gather_deep_mixed(
                    ordered, grids, meta, "shallow"))
            if entry is not None:
                sset.adopt("state", entry, self._entry_live)
            off = (a0 + 1) % itv
            kinds = ["full" if (j + off) % itv == 0 else "shallow"
                     for j in range(k)]
        elif mode == "cached":
            sset.load("state", self._gather_cache_state(ordered, grids, meta,
                                                        cells))
            kinds = ["cached"] * k
        else:
            kinds = ["dense"] * k

        def make_step(kind):
            def step(bufs):
                t, c = _split_tc(bufs["tc"], meta.i_pad)
                args = (bufs["x"], t, c, bufs["guid"], bufs["cond"], ctx1,
                        ctx2)
                state = bufs.get("state")
                if kind == "dense":
                    store(bufs["x"], self._mixed_fn(*args))
                elif kind == "cached":
                    new_x, _ = keep_leaves(state, lambda: self._mixed_fn(
                        *args, deep=dict(cache=cache, cache_state=state)))
                    store(bufs["x"], new_x)
                else:
                    new_x, deep = keep_leaves(
                        state, lambda: self._deep_step_mixed(
                            kind, *args,
                            bufs["deep"] if kind == "shallow" else None,
                            state))
                    store(bufs["x"], new_x)
                    store(bufs["deep"], deep)
            return step

        tracing.phase("denoise.forward")
        self._run_chunk(sset, per_step, kinds, make_step)
        tracing.phase("denoise.update")
        new_x = sset.bufs["x"]
        if deep_modes:
            for kind in kinds:
                self._record_mode(kind, len(ordered))
                if entry is not None and kind != "full":
                    self._count_image_pairs(len(entry["state"]), meta2)
            fulls = [j for j, kind in enumerate(kinds) if kind == "full"]
            final_age = (k - 1 - fulls[-1]) if fulls else a0 + k
            if entry is not None and fulls:
                entry["anchored"] = True
            deep = sset.bufs["deep"]
        elif mode == "cached":
            self._scatter_cache_state(ordered, grids, meta, sset.bufs["state"])
        pos = 0
        for r, g in zip(ordered, grids):
            n = g * g
            r.latents = patching.merge_patches(new_x[pos:pos + n], g).clone()
            if deep_modes:
                r.deep_state = torch.cat([
                    deep[pos:pos + n],
                    deep[meta.p_pad + pos:meta.p_pad + pos + n]])
                r.deep_age = final_age
                r.deep_slope = None
            pos += n
        self._finish_chunk(ordered, k)
        return True

    # -- stage 3: postprocess ------------------------------------------------

    def postprocess(self, reqs_by_res: Dict[int, List[Request]]) -> None:
        self.plan_postprocess(reqs_by_res)()

    def plan_postprocess(self, reqs_by_res: Dict[int, List[Request]]):
        """Free the requests' composition state and size the decode
        groups on the calling thread, the only one that touches the
        composition store; return the decode, which may run on any thread
        (the worker's background decode)."""
        tracing.phase("decode.plan")
        # these requests' composition-state entries can never be used
        # again: free them before the decode, the pipeline's memory peak
        self.evict_finished_state(
            {r.request_id for reqs in reqs_by_res.values() for r in reqs})
        groups = []
        for res in sorted(reqs_by_res):
            reqs = [r for r in reqs_by_res[res]
                    if r.params.output_type != "latent"]
            # full-res decode activations are the pipeline's memory peak
            chunk = max(self.config.scheduler.decode_batch, 1)
            if self._tiled(res // self.vae_scale):
                # a tiled decode runs one image at a time, as in the JAX
                # pipeline (base.py:2707-2713)
                chunk = 1
            chunk = min(chunk, self._decode_capacity_chunk(res))
            groups += [reqs[i:i + chunk] for i in range(0, len(reqs), chunk)]
        latent = [r for reqs in reqs_by_res.values() for r in reqs
                  if r.params.output_type == "latent"]
        return functools.partial(self._decode_groups, latent, groups)

    @torch.inference_mode()
    def _decode_groups(self, latent: List[Request],
                       groups: List[List[Request]]) -> None:
        # the latent output type skips the VAE decode entirely
        if latent:
            tracing.phase("decode.readback")
        for r in latent:
            r.output = r.latents[0].float().cpu().numpy()
        for reqs in groups:
            self._decode_group(reqs)

    def _bytes_limit(self) -> float:
        """The device's memory: the card's total, or
        ``engine.hbm_bytes_fallback`` on the CPU."""
        if self.device.type == "cuda":
            return float(torch.cuda.get_device_properties(
                self.device).total_memory)
        return float(self.config.engine.hbm_bytes_fallback)

    def param_bytes_on(self, device: torch.device) -> dict:
        """``{storage pointer: bytes}`` of the storages holding the
        parameters and buffers this pipeline has on ``device``: the
        bundle's (the port keeps no encoder on the host) and its shards'
        (a shard's slice along dim 0 is a view of the bundle's storage,
        counted once; its other slices and copies are its own)."""
        tensors = [t for m in self.bundle.models.values()
                   for t in list(m.parameters()) + list(m.buffers())]
        if self.group is not None:
            tensors += list(self.denoiser.param_tensors())
        out = {}
        for t in tensors:
            if t.device == device:
                st = t.untyped_storage()
                out[st.data_ptr()] = st.nbytes()
        return out

    def device_param_bytes(self) -> int:
        """Bytes of the parameters on the lead device, each storage once."""
        return sum(self.param_bytes_on(self.device).values())

    def estimate_serving_state_bytes(self, res: int, bucket: int) -> int:
        """Bytes of the composition state a uniform (res, bucket) dense
        step mints: the hybrid's or the compact cache's rows, built by the
        same ``init_rows`` on the meta device (shape math only, nothing
        allocated; JAX base.py:866-910).  0 when it mints none."""
        cc = self.config.cache
        if not cc.enabled or not hasattr(self.bundle.denoiser, "cache_layout"):
            return 0
        cells = res // self.vae_scale
        if cc.mode == "deep" and cc.deep_compact_fraction is not None:
            layout = self.bundle.denoiser.shallow_cache_layout(
                cells, cc.deep_boundary)
        elif cc.mode == "compact":
            layout = self.bundle.denoiser.cache_layout(cells, cc.min_level)
        else:
            return 0
        cache = self._cache_obj or BlockCache(cc)
        meta = torch.device("meta")
        return _state_nbytes({
            key: cache.init_rows(key, 2 * bucket, s, c_in, c_out,
                                 self.bundle.dtype, meta)
            for key, (s, c_in, c_out) in layout.items()})

    def _store_trees(self) -> list:
        """The device state of the composition stores, the sp step's K/V
        and deep features included (every shard's full-sequence K/V count,
        as the row caches do)."""
        return ([e["state"] for e in list(self._comp_state.values())]
                + [{"kv": e["kv"], "deep": e["deep"]}
                   for e in list(self._disp_state.values())])

    def _state_trees(self) -> list:
        """The stores' state and, under sp, the patch batch's rows, which
        one device keeps on its requests."""
        return (self._store_trees()
                + [b.state for b in list(self._batch_rows.values())])

    def shard_state_bytes(self) -> List[int]:
        """Bytes of the composition stores' state on each shard, rank order
        (a whole tensor on the lead device counts to rank 0)."""
        out = [0] * (1 if self.group is None else self.group.size)

        def walk(tree):
            if isinstance(tree, torch.Tensor):
                out[0] += tree.numel() * tree.element_size()
            elif isinstance(tree, ShardedTensor):
                for r, p in enumerate(tree.parts):
                    if p is not None:
                        out[r] += p.numel() * p.element_size()
            elif isinstance(tree, dict):
                for v in tree.values():
                    walk(v)

        for tree in self._state_trees():
            walk(tree)
        return out

    def _live_state_bytes(self) -> int:
        """Bytes of the composition stores and of the step graphs' buffers,
        each tensor once (an entry's rows may live in a buffer)."""
        return unique_nbytes(self._state_trees() + self.graphs.buffers())

    def _row_state_bytes(self) -> int:
        """Bytes of the row state ``comp_state_bytes`` bounds: the
        composition stores and the step sets' row buffers, each tensor
        once (a request's rows, or under sp its batch's, are not
        bounded)."""
        return unique_nbytes(self._store_trees() + self.graphs.row_states())

    def post_overlap_ok(self, reqs_by_res) -> bool:
        """May this postprocess run on the background thread while the
        loop keeps denoising?  Overlap puts the decode transient next to a
        denoise step's workspace, live sets that never coexist under a
        synchronous decode; it is allowed only when the parameters, the
        live composition state, one decode group
        (``engine.decode_bytes_per_pixel`` x res^2 an image) and both
        margins fit the device's memory.  No estimate: False (decode
        synchronously)."""
        try:
            ec = self.config.engine
            need = 0.0
            for res, reqs in reqs_by_res.items():
                chunk = min(max(self.config.scheduler.decode_batch, 1),
                            max(len(reqs), 1))
                per_img = float(ec.decode_bytes_per_pixel) * res * res
                need = max(need, per_img * chunk)
            head = (self._bytes_limit() - self.device_param_bytes()
                    - self._live_state_bytes()
                    - float(ec.prewarm_hbm_margin)
                    - float(ec.decode_hbm_margin))
            return head >= need
        except Exception:  # noqa: BLE001 — no estimate: stay synchronous
            return False

    def _decode_capacity_chunk(self, res: int) -> int:
        """Largest decode group at ``res`` whose transient fits next to the
        parameters and the live composition state (other compositions'
        row caches stay resident while a request decodes)."""
        try:
            ec = self.config.engine
            head = (self._bytes_limit() - self.device_param_bytes()
                    - self._live_state_bytes() - float(ec.decode_hbm_margin))
            per_img = float(ec.decode_bytes_per_pixel) * res * res
            return max(1, int(head // per_img)) if per_img > 0 else 1
        except Exception:  # noqa: BLE001
            return max(self.config.scheduler.decode_batch, 1)

    def _decode_group(self, reqs: List[Request]) -> None:
        tracing.phase("decode.vae")
        latents = torch.cat([r.latents for r in reqs], dim=0)
        images = self._decode_fn(latents)
        tracing.phase("decode.readback")
        images = images.cpu().numpy()
        checker = self._safety_checker()
        if checker is not None:
            tracing.phase("decode.safety")
            images, flags = checker.check(images)
            for req, flagged in zip(reqs, flags):
                req.nsfw_flagged = flagged
        for i, req in enumerate(reqs):
            req.output = images[i]

    def _safety_checker(self):
        """The lazy safety checker of ``ModelConfig.safety_checker_path``
        (JAX base.py:2796-2811): "random" is random weights from the
        model seed, a directory the stock ``safety_checker/`` component.
        Built at the first decode, it lives outside the bundle, so
        ``device_param_bytes`` does not count it, as in JAX."""
        path = self.config.model.safety_checker_path
        if not path:
            return None
        if self._safety_obj is None:
            checker = SafetyChecker(tiny=self.config.model.test_tiny,
                                    device=self.device)
            if path == "random":
                checker.init_random(seed=self.config.model.seed)
            else:
                checker.load(path)
            self._safety_obj = checker
        return self._safety_obj

    def _tiled(self, latent_hw: int) -> bool:
        """Does a latent this wide take the tiled decode?  (SD3: 64-cell
        tiles past 512^2; ``ModelConfig.vae_tile_latent``, 0 = never.)"""
        tile = self.config.model.vae_tile_latent
        return bool(tile) and latent_hw > tile

    def _decode_fn(self, latents):
        """VAE decode in the VAE's dtype (``ModelConfig.vae_dtype``; "auto"
        is bf16 on the card, float32 on the CPU) -> uint8; tiled where
        :meth:`_tiled` says so."""
        vae = self.bundle.models["vae"]
        if self._tiled(latents.shape[1]):
            mc = self.config.model
            img = vae.decode_tiled(latents.float(), tile=mc.vae_tile_latent,
                                   overlap=mc.vae_tile_overlap)
        else:
            img = vae.decode(latents.float())
        img = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8)

    # -- helpers -------------------------------------------------------------

    def _encode_clip(self, role: str, ids: np.ndarray, *, penultimate: bool):
        """CLIP encode -> (features, pooled) on the device."""
        ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        out = self.bundle.models[role](ids_t, output_hidden_states=penultimate)
        feats = out["hidden_states"][-2] if penultimate else out["last_hidden_state"]
        return feats, out["pooled"]
