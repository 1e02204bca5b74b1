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
                           tiled for SD3 as in the JAX pipeline.

The dense path runs batches at their real size: eager PyTorch has no
compile cache to key.  The patch path pads the patch and image counts to
the configured buckets like the JAX package, so both form the same patch
batch and the padded image slots reach the masked attention kernel.
Requests at different timesteps batch through per-request sampler
coefficient rows.  A stateful sampler (PNDM) keeps its state per request in
the dense latent layout (``Request.sampler_state``); the mixed step slices
it into patches like the latents and merges it back, so a request may move
between dense and patched steps.  The block caches and the fused
multi-step dispatch are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.request import Request
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.ops import patching
from sduss_tpu_torch.ops.patch_ctx import PatchContext
from sduss_tpu_torch.samplers import gather_coeffs, gather_timesteps, get_sampler


class BasePipeline:
    """Family-agnostic staged pipeline over a ModelBundle on one device."""

    def __init__(self, bundle: ModelBundle, config: Config):
        self.bundle = bundle
        self.config = config
        self.spec = bundle.spec
        self.device = bundle.device
        if config.model.sampler:
            self.sampler = get_sampler(config.model.sampler)
        else:
            self.sampler = get_sampler(self.spec.default_sampler,
                                       **self.spec.sampler_kwargs)
        self.vae_scale = self.spec.vae_scale

    # -- family hooks --------------------------------------------------------

    def encode_conditioning(self, prompts: List[str], negatives: List[str],
                            resolutions: List[int]) -> List[Dict[str, torch.Tensor]]:
        """Run the text encoders; return one conditioning dict per request."""
        raise NotImplementedError

    def denoiser_forward(self, latents_in, t, cond, ctx=None):
        """Model forward on a CFG-paired batch.

        Dense: latents_in ``(2B, h, w, C)``, cond arrays ``(B, ...)``
        CFG-concatenated by the implementation.  Patched: latents_in is the
        doubled patch batch, t is per image (already doubled), cond per
        image, and ctx the doubled batch's ``PatchContext``.
        """
        raise NotImplementedError

    # -- stage 1: prepare ----------------------------------------------------

    @torch.inference_mode()
    def prepare(self, requests: Sequence[Request]) -> None:
        prompts = [r.params.prompt for r in requests]
        negatives = [r.params.negative_prompt for r in requests]
        resolutions = [r.resolution for r in requests]
        conds = self.encode_conditioning(prompts, negatives, resolutions)
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

    def _denoise_group(self, reqs: List[Request]) -> None:
        tables = [r.sampler_table for r in reqs]
        dev = self.device
        latents = torch.cat([r.latents for r in reqs], dim=0)
        t = torch.from_numpy(gather_timesteps(tables)).to(dev)
        coeffs = torch.from_numpy(gather_coeffs(tables)).to(dev)
        guidance = torch.tensor(
            [r.params.guidance_scale if r.params.guidance_scale is not None
             else self.spec.default_guidance for r in reqs],
            dtype=torch.float32, device=dev)
        cond = {key: torch.cat([r.conditioning[key] for r in reqs], dim=0)
                for key in reqs[0].conditioning}
        if self.sampler.needs_state:
            self._init_sampler_state(reqs)
            state = {key: torch.cat([r.sampler_state[key] for r in reqs])
                     for key in reqs[0].sampler_state}
            new_latents, new_state = self._denoise_fn_stateful(
                latents, t, coeffs, guidance, cond, state)
            for i, r in enumerate(reqs):
                r.sampler_state = {key: a[i:i + 1]
                                   for key, a in new_state.items()}
        else:
            new_latents = self._denoise_fn(latents, t, coeffs, guidance, cond)
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

    def _cfg_forward(self, latents, t, coeffs, guidance, cond):
        """Rows go uncond first, then cond (the JAX ``_cfg_step`` order)."""
        lat_in = torch.cat([latents, latents], dim=0)
        t2 = torch.cat([t, t], dim=0)
        c0, c1 = coeffs[:, 0], coeffs[:, 1]
        lat_in = self.sampler.scale_model_input(lat_in, torch.cat([c0, c0]))
        uncond, text = self.denoiser_forward(lat_in, t2, cond).chunk(2, dim=0)
        g = guidance.reshape(-1, *([1] * (latents.dim() - 1)))
        return uncond + g * (text - uncond), c0, c1

    # -- stage 2b: one denoising step on the mixed patch path ---------------

    @torch.inference_mode()
    def denoise_step_mixed(self, reqs_by_res: Dict[int, List[Request]]) -> None:
        """ONE denoiser step over a mixed-resolution patch batch.

        All requests share one UNet forward: latents are cut into
        ``patch_size`` patches, concatenated patch-major (requests sorted by
        resolution) and padded to the patch bucket, and the patch context
        provides halo convs, per-image group norm and grouped attention.
        A resolution that does not divide into patches falls back to the
        dense step.  The JAX package routes a composition whose compiled
        program is not warm yet to the dense step for a while; eager
        PyTorch compiles nothing, so the port always runs patched.
        """
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

        x = torch.cat([patching.split_latent(r.latents, cells)
                       for r in ordered], dim=0)
        if x.shape[0] < meta.p_pad:
            x = torch.cat([x, x.new_zeros((meta.p_pad - x.shape[0],)
                                          + x.shape[1:])], dim=0)

        # per-image rows padded to i_pad (coefficients with 1.0, so the pad
        # slots' sampler math stays finite)
        def pad_i(arr, fill=0.0):
            out = np.full((meta.i_pad,) + arr.shape[1:], fill, arr.dtype)
            out[: arr.shape[0]] = arr
            return torch.from_numpy(out).to(dev)

        tables = [r.sampler_table for r in ordered]
        t = pad_i(gather_timesteps(tables))
        coeffs = pad_i(gather_coeffs(tables), fill=1.0)
        guidance = pad_i(np.asarray(
            [r.params.guidance_scale if r.params.guidance_scale is not None
             else self.spec.default_guidance for r in ordered], np.float32))
        cond = {}
        for key in ordered[0].conditioning:
            arr = torch.cat([r.conditioning[key] for r in ordered], dim=0)
            cond[key] = torch.cat([arr, arr.new_zeros(
                (meta.i_pad - arr.shape[0],) + arr.shape[1:])], dim=0)

        ctx1, ctx2 = PatchContext(meta, dev), PatchContext(meta2, dev)
        if self.sampler.needs_state:
            state = self._gather_sampler_state_mixed(ordered, grids, cells,
                                                     meta.p_pad)
            new_x, new_state = self._mixed_fn(x, t, coeffs, guidance, cond,
                                              ctx1, ctx2, state)
            self._scatter_sampler_state_mixed(ordered, grids, cells,
                                              new_state)
        else:
            new_x = self._mixed_fn(x, t, coeffs, guidance, cond, ctx1, ctx2)
        off = 0
        for r, g in zip(ordered, grids):
            n = g * g
            r.latents = patching.merge_patches(new_x[off:off + n], g)
            off += n
            r.sampler_table.advance()
            r.remain_steps -= 1

    def _mixed_fn(self, x, t, coeffs, guidance, cond, ctx1, ctx2, state=None):
        """CFG duplicate -> scale -> patched model -> combine -> sampler
        step, per patch with its image's coefficients (rows go uncond
        block first, then cond, as in the JAX ``_make_mixed_fn``).  With a
        patch-sliced sampler ``state`` it returns ``(x, new_state)``: the
        stateful update is element-wise, so it is exact per patch."""
        c0, c1 = coeffs[:, 0], coeffs[:, 1]  # per image (i_pad,)
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        x2 = self.sampler.scale_model_input(x2, torch.cat([c0, c0])[ctx2.image_id])
        uncond, text = self.denoiser_forward(x2, t2, cond, ctx=ctx2).chunk(2, dim=0)
        g = guidance[ctx1.image_id].reshape(-1, 1, 1, 1)
        noise_pred = uncond + g * (text - uncond)
        c0p, c1p = c0[ctx1.image_id], c1[ctx1.image_id]
        if state is not None:
            return self.sampler.step_with_state(x, noise_pred, c0p, c1p, state)
        return self.sampler.step(x, noise_pred, c0p, c1p)

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

    # -- stage 3: postprocess ------------------------------------------------

    @torch.inference_mode()
    def postprocess(self, reqs_by_res: Dict[int, List[Request]]) -> None:
        for res in sorted(reqs_by_res):
            all_reqs = reqs_by_res[res]
            # the latent output type skips the VAE decode entirely
            for r in all_reqs:
                if r.params.output_type == "latent":
                    r.output = r.latents[0].float().cpu().numpy()
            reqs = [r for r in all_reqs if r.params.output_type != "latent"]
            # full-res decode activations are the pipeline's memory peak
            chunk = max(self.config.scheduler.decode_batch, 1)
            if self._tiled(res // self.vae_scale):
                # a tiled decode runs one image at a time, as in the JAX
                # pipeline (base.py:2707-2713)
                chunk = 1
            for i in range(0, len(reqs), chunk):
                self._decode_group(reqs[i:i + chunk])

    def _decode_group(self, reqs: List[Request]) -> None:
        latents = torch.cat([r.latents for r in reqs], dim=0)
        images = self._decode_fn(latents).cpu().numpy()
        for i, req in enumerate(reqs):
            req.output = images[i]

    def _tiled(self, latent_hw: int) -> bool:
        """Does a latent this wide take the tiled decode?  (SD3: 64-cell
        tiles past 512^2; ``ModelConfig.vae_tile_latent``, 0 = never.)"""
        tile = self.config.model.vae_tile_latent
        return bool(tile) and latent_hw > tile

    def _decode_fn(self, latents):
        """VAE decode in the VAE's dtype (bf16 on the card, float32 on the
        CPU and for SDXL) -> uint8; tiled where :meth:`_tiled` says so."""
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
