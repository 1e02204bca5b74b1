#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure propagates and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ``sduss_tpu_torch/csrc`` (one nvcc per
     source, run together; timed);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving paths give it, and time the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call (``scaled_dot_product_attention``) with CUDA events: K1
     (flash_mha_fused, SDXL's head dim 64 and SD-1.5's 40/80/160), K2a/K3b
     (flash_mha, at SD3.5-medium's joint and dual shapes, ragged and with
     kv_len < Lk), the masked flash attention K2b/K3a (flash_mha_masked,
     SDXL and SD-1.5 patch groups and the SD3 token batches, including
     batch rows with no valid key, and the SD3 fine token gate's shapes:
     fewer queries than keys, off the query tile), K4 (gn_silu_halo, SDXL's patch sides and
     SD-1.5's s = 4; the patched step's moments and the fused op must
     repeat bit for bit) and K5
     (flash_cross_short: the text cross-attention of the dense and patch
     paths, also timed beside the plain route it replaced; negative and
     zero scale) and K6 (gn_dense, the dense GroupNorm + SiLU: SDXL's and
     SD-1.5's UNet shapes and the VAE decoder's at 512^2 and 1024^2, bf16
     and float32, with and without the fused add; it must repeat bit for
     bit; timed beside ``F.group_norm``); with the SDXL bundle, K6's exact
     launches for one full, one shallow forward and one decode (every
     serving phase after it also counts K6, one call a GroupNorm of each
     dense UNet forward by its deep mode, none on the patch batch or under
     sp, and one a GroupNorm of each VAE decoder forward);
     hold one full-width SDXL transformer block (through K1), SD3.5-medium's
     dual block 0 (through flash_mha) and an SD-1.5 conv-projection
     transformer (through K1 at hd 40) on the card in bf16 against the same
     block on the CPU in float32;
  4. hold one full-width SDXL UNet forward on a 768^2 + 1024^2 patch batch
     against the dense forward of each image (bf16, on the card);
  5. SDXL dense serving: three requests at full width (random weights from
     a seed) through ``DiffusionPipeline.generate`` with mixed batches off;
     check the images and that the path launched K1 and K5; read the step
     time of the two-request 1024^2 batch;
  6. SDXL mixed serving: [768, 1024, 1024, 1024] with the default
     configuration (one patched UNet step per iteration); check the mixed
     batch in the schedule log, the images and that the path launched K4,
     the masked kernel and K5 (one per cross-attention and step); read the
     mixed step time;
  7. free the SDXL bundle; SD3.5-medium dense serving (MMDiT, CLIP-L/G,
     T5-XXL, 16-channel tiled VAE; random bf16 weights): [1024, 1024, 768]
     with mixed batches off; check the images, the latents and that every
     attention launched flash_mha; read the 1024^2 pair's step time, the
     prepare and tiled-decode times and the peak memory;
  8. SD3.5-medium mixed serving: [512, 1024, 1024] with the default
     configuration (one padded-token MMDiT step per iteration); check the
     mixed batches, the images and the masked launches; read the step time;
  9. SD3.5-medium's caches, with its bundle still loaded
     (``serve_sd3_deep``): ``apply_tokens`` at 2 x 1024^2 (CFG, 4 rows) in
     the span's full pass (equal to the plain forward within one bf16
     ulp), its shallow pass (within 5e-2 of the full one) and each token
     gate at fraction 1 (block, compact, fine with stale K/V; two steps,
     within one ulp of the plain forward); 4 x 1024^2, 30 steps, under
     ``CacheConfig.production("sd3", serving=False)`` (3 full, then 27
     shallow steps) and cache-off: step ms per mode, their ratio, end to
     end seconds, delta bytes, peak memory; ``production("sd3",
     serving=True)`` under ``fcfs_mixed``: 512^2 x 12 steps and 2 x
     1024^2 x 20, a 1024^2 request added after 4 steps, the 512^2 exit
     costing exactly one full step and no finished request's state left;
     2 x 1024^2, 8 steps, under each token mode; every step launching the
     masked kernel exactly 37 times (2 on a shallow span step);
 10. free the SD3 bundle; SD-1.5 (conv-projection UNet, CLIP-L, bf16 VAE;
     random bf16 weights): the full-width UNet patched against dense on a
     256^2 + 512^2 + 768^2 batch, then four serving runs, each checking
     images, latents, the DENOISING batches and the exact launches of K1,
     the masked kernel, K4, K5 and K6 that SD15_UNET gives: dense
     [512, 512, 768] with Euler, 8 steps; mixed [256, 512, 768] in the
     default configuration, Euler, 8 steps; the same mixed batch with PNDM
     (4 steps, 5 evaluations) and the dense one with DDIM (4 steps);
 11. the deep cache (``CacheConfig.mode="deep"``, dense path): with the
     SDXL bundle, one full-width UNet forward at 1024^2 (2 requests, CFG)
     in ``deep_mode`` full (equal to the plain forward within one bf16
     ulp), shallow from that deep feature and partial with one selected
     request (both within 5e-2 of the full pass); 8 x 1024^2 requests, 30
     Euler steps, under ``CacheConfig.production("sdxl", serving=False)``
     (the bench's default trajectory), then the same run cache-off: the
     images, finite final latents, at least one full and one shallow
     step, K1 and K5 launches exactly 70 per full step, the step time of
     each mode, the row-cache bytes, the peak memory and both runs' wall
     time; with the SD-1.5 bundle, ``production("sd15", serving=True)``
     under ESyMReD: two 512^2 requests and a third added through
     ``Engine.add_request`` once they have taken 4 steps, 16 Euler steps,
     at least one partial step and exact K1/K5 launches per mode;
 12. the deep cache on the mixed patch path: K4 at the gated
     sub-compositions of SDXL's (768^2 + 3 x 1024^2: 50 patches) and
     SD-1.5's (4 x 512^2 + 768^2: 26 patches) shallow steps and the masked
     kernel at SD-1.5's (with the kernel checks of phase 3); the SDXL UNet's
     patched deep modes at 768^2 + 1024^2 (full equal to the plain patched
     forward within one bf16 ulp, shallow and the hybrid at fraction 1
     within 5e-2) and the image gate choosing the same images on the card
     as on the CPU; SDXL's serving mix under ``production("sdxl",
     serving=True)``, ``serving=False`` and cache-off (12 steps): at least
     one full and one shallow step, step ms per mode, end to end seconds,
     peak memory, row-cache bytes and launches exactly as the modes give;
     SD-1.5 under ``production("sd15", serving=True)`` and ESyMReD: 4 x
     512^2 on the dense path, joined by a 768^2 request after 4 steps, which
     flips their batch to the patched path with a full step, then shallow
     steps whose gate skips images; exact launches per path and mode;
 13. the UNet families' block and compact caches, with the SDXL bundle:
     SDXL's serving mix (768^2 + 3 x 1024^2, 8 steps) cache-off and in mode
     "block" at threshold -1 (the latents equal, bitwise or within 2^-7),
     then with the committed classifiers while one 1024^2 request leaves
     after 4 steps (fresh share per step, hits within max_hits, images);
     4 x 1024^2 on the dense path cache-off, under mode "compact" at 0.5
     (a sync step, then 4 of 8 rows a gated pair: K1's rows a launch) and
     at 1.0 (equal to cache-off); the mix under "compact" at 1.0 (equal to
     cache-off), 0.5 and 0.5 with two-level rows at ``patch_fraction`` 0.5
     (K5 at 36 rows); step ms per mode from CUDA events and launches per
     step equal to cache-off's in every run; the kernels checked at these
     shapes in phase 3 (K1 at 4 rows, the masked kernel and K4 on the
     compact sub-composition, K5 at 36 rows); ``cache.train.main`` at
     512/768/1024 x 6 steps (11 classifiers) and a block step on its npz;
     ``api_server.main --use-cache`` in modes "block" and "compact"
     (768^2 + 1024^2 over HTTP as one mixed batch, every gate called);
 14. the serving front, with the SDXL bundle before it is freed:
     ``entrypoints/api_server.py`` on its own event loop and thread in the
     serving configuration (``production("sdxl", serving=True)``,
     ``fcfs_mixed``, the background decode at its default); the port's
     client sends 768^2 and 2 x 1024^2 requests together, 2 x 1024^2 a
     second later, and aborts one of those while it denoises: answers,
     PNGs, /health, /stats, /abort and /clear, a decode group on the
     decode thread while DENOISING iterations go on, no hand kernel off
     the engine's thread, exact launches per realized mode, latencies,
     iteration times with and without a decode in flight, and the bf16
     decode's measured bytes per pixel against the memory gate's; with
     the SD-1.5 bundle, 3 x 512^2 with the background prepare
     (``engine.async_prepare=True``: every prepare on its thread);
 15. ``vae_dtype``, with the SDXL bundle before the serving front: the
     same two 1024^2 latents decoded under "auto" (bf16 on the card,
     SDXL's force_upcast VAE included) and "float32", finite uint8
     images within 3 counts of each other on average, the decode times
     and the bf16 decode's bytes per pixel (the serving front's memory
     gate then runs on the bf16 decode);
 16. the loader and the safety checker, with the SD-1.5 bundle: the bundle
     written as a bf16 diffusers snapshot (the script's own safetensors
     writer, no tokenizer directories) and served from it through
     ``DiffusionPipeline(model_path=...)``, 2 x 512^2 x 8 Euler steps,
     bitwise equal to the in-memory bundle's images, exact K1/K5
     launches; then with ``safety_checker_path="random"`` (ViT-L/14,
     float32): the checker's embeddings on the card against the CPU,
     unflagged images equal to the unchecked ones, a flagged image all
     zero, the checker's ms per decode group;
 17. ESyMReD's stage profiles: the SDXL bundle rebuilt by
     ``scheduler/profiler.py`` fits a profile (512/768/1024, decode
     batches up to 4) and a predictor on the card, every value finite and
     positive; the committed ``scheduler/h100/`` files load; 3 SDXL
     requests served under ESyMReD with the fresh profile and predictor;
 18. fused multi-step dispatch (``steps_per_dispatch``): each of these
     serves the same requests through ``Engine`` twice, chunks replayed
     from captured step graphs after ``Engine.prewarm`` and then one step a
     dispatch, and checks the final latents within 2^-7 of max |per-step|
     (printing whether they are bitwise equal), the realized deep mode of
     every step, the launches (equal between the runs and to the per-mode
     counts above), that serving after prewarm captured no graph and that
     the row state after prewarm and after serving stays within
     ``comp_state_bytes``; prints each mode's step ms under both
     dispatches (CUDA events), the prewarm seconds and the graph memory:
     with the SDXL bundle, the mix
     768^2 + 3 x 1024^2 under ``production("sdxl", serving=True)`` (12
     steps, chunks of 6 on the patch path); with the SD3 bundle, 4 x
     1024^2 under ``production("sd3", serving=True)`` (16 steps, chunks of
     8, the first entering mid-interval); both also time a replayed full
     step; with the SD-1.5 bundle, 2 x 512^2 cache-off (24 steps, chunks
     of 6; the dispatch window's wall and CUDA-event ms a step, and the
     wall and device-busy ms a step of one profiled round, chunked and
     per-step) and ``production("sd15", serving=True)`` under ESyMReD
     (buckets 2 and 4 prewarmed; 3 x 512^2 and a fourth after 6 steps,
     chunks of 3: hybrid partial chunks);
 19. a replica over an sp x tp group of devices, on one card (devices
     [0, 0]: both shards on card 0, each on its own thread and stream),
     each run against the same requests on one device: with the SDXL
     bundle (``serve_tp2``), tp=2 on the dense 2 x 1024^2 pair and the
     768^2 + 1024^2 patch batch, cache-off and under
     ``production("sdxl")``, 8 steps: latents within 2^-7, every kernel
     launched exactly twice as often (each shard's forward at its local
     heads and channels: K4 at C / 2, checked in phase 3 at 160/320/640
     channels over 16 groups), the same deep modes, and one forward's
     shards bitwise equal and within 3e-2 of one device's forward, and
     in float32 within 1e-4 (the sharding alone, attention on the plain
     versions);
     (``serve_sp2``) the dense pair under sp=2: ``sp_mode="gspmd"``
     (every step sync) within 2^-7, then ``"displaced"`` over 30 steps (2
     sync, 28 stale) and the plain fixed-interval deep cache on the
     displaced seam, both within 5e-2 of one device with the expected
     modes and sync/stale counts; with the SD3 bundle
     (``serve_sd3_sp2``), one CFG 2 x 1024^2 forward and the dense pair's
     4-step trajectory under sp=2 with the latent K/V gathered (within
     2^-7) and under tp=2 (within 3e-2: SD3's random-weight trajectory
     moves ~2e-2 under any change of summation order, measured beside it
     with one device's attention on the plain versions; the tp shards
     bitwise equal, and the float32 forward within 1e-4), one forward
     with the K/V rotated around the ring (within 3e-2), then
     ``MMDiTStagePipeline`` on two stages on card 0 bitwise equal to the
     single-device forward; the step ms of every run beside the card's
     name and power limit;
 20. print the kernels' JSON line, then the result line
     ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import os
import shutil
import socket
import struct
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

import torch.nn.functional as F

from sduss_tpu_torch import configure_numerics
from sduss_tpu_torch.benchmark.metrics import (compute_metrics,
                                               records_from_csv,
                                               records_to_csv)
from sduss_tpu_torch.benchmark.replay import run_replay
from sduss_tpu_torch.benchmark.traces import load_trace
from sduss_tpu_torch.cache import train as cache_train
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.async_engine import AsyncEngine
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints import api_server, client
from sduss_tpu_torch.entrypoints.offline import DiffusionPipeline, default_config
from sduss_tpu_torch.models import mmdit
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.models.safety_checker import SafetyChecker
from sduss_tpu_torch.models import unet as unet_mod
from sduss_tpu_torch.models.unet import BasicTransformerBlock
from sduss_tpu_torch.models import layers
from sduss_tpu_torch.models import vae as vae_mod
from sduss_tpu_torch.ops import attention as attention_mod
from sduss_tpu_torch.ops.attention import FLASH_MIN_KV
from sduss_tpu_torch.ops import _build, patching
from sduss_tpu_torch.ops.flash import (flash_cross_short,
                                       flash_cross_short_reference, flash_mha,
                                       flash_mha_fused,
                                       flash_mha_fused_reference,
                                       flash_mha_masked,
                                       flash_mha_masked_reference,
                                       flash_mha_reference)
from sduss_tpu_torch.ops.gn_dense import (gn_dense, group_norm_reference,
                                          plan_cluster)
from sduss_tpu_torch.ops.gn_halo import (gn_silu_halo, gn_silu_halo_reference,
                                         gn_silu_haloed, moments)
from sduss_tpu_torch.ops.patch_ctx import PatchContext, compact_context
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.pipelines.base import _state_nbytes
from sduss_tpu_torch.pipelines.graphs import unique_nbytes
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from sduss_tpu_torch.scheduler.predictor import LatencyPredictor
from sduss_tpu_torch.scheduler.profiler import Profiler
from sduss_tpu_torch.scheduler.profiles import StageProfile

# K1 against its plain version (float32 softmax(q k^T) v, rounded to bf16
# once), on N(0, 1) bf16 inputs, relative to the output's scale:
# - max |kernel - plain| <= K1_MAX_REL * max |plain|: 2^-6 is two bf16 ulps
#   at the largest output (the output rounding plus the kernel's bf16 P);
# - ||kernel - plain|| / ||plain|| <= K1_RMS_REL: bf16 rounding gives
#   ~2.4e-3 on an H100, and a fault that scales rows by ~0.5% or more (an
#   unmasked padded key tile, a wrong row sum) adds its own size on top.
K1_MAX_REL = 2.0 ** -6
K1_RMS_REL = 5e-3
BLOCK_BOUND = 5e-2   # bf16 card block vs fp32 CPU block, max error / max |ref|
# patched vs dense full-width UNet, both bf16 on the card, max error /
# max |dense|: the per-image statistics and attention sum in another order
PATCH_BOUND = 5e-2
# K4 against its plain version: both compute in float32 and round to bf16
# once, so they differ by at most one bf16 ulp at the output's scale
K4_MAX_REL = 2.0 ** -7
K1_SHAPES = [        # (B, Lq, Lk, D, H)
    (2, 4096, 4096, 640, 10),   # SDXL level 1 at 1024^2
    (2, 1024, 1024, 1280, 20),  # SDXL level 2 at 1024^2
    (3, 1000, 1000, 640, 10),   # ragged query and key tiles
    (3, 1000, 65, 640, 10),     # last key tile 1 real key + 63 padded
    (2, 4096, 4096, 320, 8),    # SD-1.5 level 0 at 512^2, hd 40
    (2, 1024, 1024, 640, 8),    # SD-1.5 level 1 at 512^2, hd 80
    (2, 256, 256, 1280, 8),     # SD-1.5 level 2 at 512^2, hd 160
    (2, 144, 144, 1280, 8),     # SD-1.5 mid block at 768^2: ragged keys
    (3, 1000, 777, 320, 8),     # ragged query and key tiles at hd 40
    # edge cases of the K/V ring (2 or 3 slots of 64 keys, csrc/flash_fused.cu
    # Shape<hd>): one query row, one key, one tile more than the ring holds
    (2, 1, 1000, 640, 10),      # Lq = 1
    (2, 300, 1, 640, 10),       # Lk = 1: one ragged tile with one key
    (2, 500, 129, 640, 10),     # Lk = 64 * 2 + 1
    (2, 500, 193, 640, 10),     # Lk = 64 * 3 + 1
    (2, 500, 129, 1280, 8),     # the same at hd 160
    (2, 500, 193, 1280, 8),
]
# the dense compact cache's gated steps (4 x 1024^2 at fraction 0.5: 4 of
# the 8 CFG rows at levels 1 and 2)
K1_COMPACT_SHAPES = [(4, 4096, 4096, 640, 10), (4, 1024, 1024, 1280, 20)]
K1_SHAPES += K1_COMPACT_SHAPES
# timed beside the plain version and SDPA: SDXL's two and SD-1.5's three,
# and the dense compact cache's two
K1_TIMED = K1_SHAPES[:2] + K1_SHAPES[4:7] + K1_COMPACT_SHAPES
# K2a/K3b (flash_mha) at SD3.5-medium's width, CFG pair at 1024^2:
# (B, Lq, Lk, D, H, kv_len); kv_len None = Lk.  Same bounds as K1.
K2A_SHAPES = [
    (2, 4096, 4096, 1536, 24, None),  # dual self-attention (latent tokens)
    (2, 4429, 4429, 1536, 24, None),  # joint attention (4096 + 77 + 256)
    (3, 1000, 777, 1536, 24, None),   # ragged query and key tiles
    (2, 2637, 2760, 1536, 24, 2637),  # kv_len < Lk: keys past it hold 1e4
    (2, 300, 129, 1536, 24, 1),       # kv_len = 1: one key of three tiles
]
# The mixed serving phase's class groups (768^2 + 3 x 1024^2, CFG-doubled:
# the 1024^2 class has 6 real of 8 image slots): (B, L, D, H, dead rows),
# plus one random-mask case with ragged tiles (dead rows None), plus the SD3
# mixed phase's padded-token batch (512^2 + 2 x 1024^2 padded to 4096
# latent tokens and a batch of 4, CFG-doubled): its joint and dual
# attention masks ("joint" / "dual": built by MMDiTMaskCtx).
MASKED_SHAPES = [
    (8, 4096, 640, 10, 2),    # 1024^2 class, level 1
    (2, 2304, 640, 10, 0),    # 768^2 class, level 1
    (8, 1024, 1280, 20, 2),   # 1024^2 class, level 2
    (2, 576, 1280, 20, 0),    # 768^2 class, level 2
    (3, 1000, 640, 10, None),  # random mask, ragged
    (8, 4429, 1536, 24, "joint"),  # SD3 joint: latent + 333 text keys
    (8, 4096, 1536, 24, "dual"),   # SD3 dual: latent keys only
    # SD3's cached token steps on a uniform 4 x 1024^2 batch (a full or a
    # shallow span step): every key valid
    (8, 4429, 1536, 24, "joint-all"),
    (8, 4096, 1536, 24, "dual-all"),
    # SD-1.5 mixed phase (256^2 + 512^2 + 768^2, CFG-doubled: classes of 2
    # images of 1, 4 and 9 patches of 32^2 latent cells), each group with
    # one more image slot that has no valid key:
    (3, 9216, 320, 8, 1),      # 768^2 class, level 0, hd 40
    (3, 1024, 640, 8, 1),      # 512^2 class, level 1, hd 80
    (3, 576, 1280, 8, 1),      # 768^2 class, level 2, hd 160
    (3, 144, 1280, 8, 1),      # 768^2 class, mid block (level 3): ragged
    (3, 1000, 320, 8, None),   # random mask, ragged, hd 40
    # the ring walks only tiles with a valid key:
    (3, 1000, 640, 10, "last"),  # only the last key of the last tile
    (3, 1000, 640, 10, "alt"),   # keys valid only in alternate tiles
    (3, 1000, 320, 8, "last"),   # the same at hd 40
    (3, 1000, 320, 8, "alt"),
    (1, 16448, 64, 1, None),   # 257 key tiles: the list is built in two chunks
    # the SD-1.5 mixed deep run's gated sub-composition (4 x 512^2 + 768^2,
    # CFG-doubled, production fraction 0.3: 2 of 8 512^2 slots, 2 of 2
    # 768^2; exact-fit classes, no dead rows), level 0, hd 40; SDXL's
    # shallow spine (level 0) has no attention
    (2, 9216, 320, 8, 0),      # 768^2 class of the sub-composition
    (2, 4096, 320, 8, 0),      # 512^2 class of the sub-composition
    # mode "compact" on SDXL's serving mix at fraction 0.5: the non-even
    # sub-composition holds 4 of 8 1024^2 slots and 1 of 2 768^2 ones
    # (exact fit, no dead rows), levels 1 and 2
    (4, 4096, 640, 10, 0),
    (4, 1024, 1280, 20, 0),
    (1, 2304, 640, 10, 0),
    (1, 576, 1280, 20, 0),
]
# masked cases that are checked but not timed (no serving shape)
MASKED_UNTIMED = (None, "last", "alt")
K4_SHAPES = [(32, 320), (16, 640), (8, 1280)]  # (s, C) at SDXL levels 0-2
SD15_K4_SHAPES = [(4, 1280)]  # SD-1.5 level 3: the side without a template
# K4 on the gated sub-composition of a shallow step (level 0 of SDXL and
# SD-1.5: the resnets' norm1 inputs of 320, 640 and 960 channels)
SUB_K4_SHAPES = [(32, 320), (32, 640), (32, 960)]
# K4 on mode "compact"'s sub-composition of SDXL's serving mix (the gated
# pairs of levels 1 and 2: 640 channels, an up pair's 1920-channel concat,
# 1280 at level 2)
COMPACT_K4_SHAPES = [(16, 640), (16, 1920), (8, 1280)]
# the two-level compact rows' text cross-attention: k_q of the compact
# sub-composition's 73 patches at patch_fraction 0.5 (serve_sdxl_compact
# checks it)
TWO_LEVEL_ROWS = 36
# K5 (flash_cross_short) at scripts/bench_cross_kernel.py's text
# cross-attention shapes (B, Lq, Lk, D, H), the serving paths' own (dense
# CFG pairs; per-patch K/V of the patch path: B = patches), then edge cases:
# 256 keys at hd 160 (two key chunks, the most shared memory a block
# takes), a second chunk with one key, a 5-key and a 1-key sequence
K5_SHAPES = [
    (16, 1024, 77, 1280, 20),   # SDXL level 2
    (16, 4096, 77, 640, 10),    # SDXL level 1
    (16, 4096, 77, 320, 8),     # SD-1.5 level 0, hd 40
    (16, 1024, 77, 640, 8),     # SD-1.5 level 1, hd 80
    (4, 4096, 77, 640, 10),     # SDXL dense 1024^2 pair, level 1
    (4, 1024, 77, 1280, 20),    # SDXL dense 1024^2 pair, level 2
    (128, 256, 77, 640, 10),    # SDXL patch batch, level 1
    (128, 64, 77, 1280, 20),    # SDXL patch batch, level 2
    (32, 1024, 77, 320, 8),     # SD-1.5 patch batch, level 0, hd 40
    (32, 64, 77, 1280, 8),      # SD-1.5 patch batch, level 2, hd 160
    (4, 64, 64, 1280, 8),       # SD-1.5 512^2 mid-block self-attention
    # two-level compact rows on SDXL's serving mix (fraction 0.5,
    # patch_fraction 0.5): k_q = 36 of the sub-composition's 73 patches
    (TWO_LEVEL_ROWS, 256, 77, 640, 10),    # level 1
    (TWO_LEVEL_ROWS, 64, 77, 1280, 20),    # level 2
    (2, 1000, 256, 1280, 8),    # hd 160, the longest key sequence
    (2, 300, 129, 640, 10),     # a second key chunk with one key
    (3, 100, 5, 640, 8),        # ragged query tile, one key tile
    (2, 50, 1, 320, 8),         # one key, hd 40
]
K5_TIMED = K5_SHAPES[:13]
REQUESTS = [1024, 1024, 768]
MIXED_REQUESTS = [768, 1024, 1024, 1024]
SD3_REQUESTS = [1024, 1024, 768]
SD3_MIXED_REQUESTS = [512, 1024, 1024]
SD3_CTX = 77 + 256  # CLIP + T5 tokens
SD15_REQUESTS = [512, 512, 768]
SD15_MIXED_REQUESTS = [256, 512, 768]
SD15_SAMPLER_STEPS = 4  # the PNDM (mixed) and DDIM (dense) runs
STEPS = 8
# The deep cache: the full pass against the plain forward is the same op
# sequence (any gap above one bf16 ulp means a wrong capture point); the
# shallow and partial passes against the full one take PATCH_BOUND.
DEEP_FULL_MAX_REL = 2.0 ** -7
DEEP_REQUESTS = [1024] * 8
DEEP_STEPS = 30
DEEP_SD15_STEPS = 16
DEEP_SD15_RES = 512
# The deep cache on the mixed patch path: SDXL's serving mix under both
# production presets and cache-off; SD-1.5's 4 x 512^2 (the gate skips 3 of
# 4 512^2 pairs) joined by a 768^2 request once they have taken
# MIXED_SD15_ADMIT steps, which flips their batch from the dense path to
# the patched one
MIXED_DEEP_STEPS = 12
MIXED_SD15_FIRST = [512] * 4
MIXED_SD15_ADMIT = 4
MIXED_SD15_LATE = 768
# The UNet families' block and compact caches (SDXL's serving mix): the
# latents at threshold -1 (block) and fraction 1 (compact) against
# cache-off (one bf16 ulp at their scale); the committed classifiers; the
# request that leaves the mix early; the dense compact batch; the
# classifier training's resolutions and steps
CACHE_MAX_REL = 2.0 ** -7
SDXL_CLASSIFIERS = "exp/cache_classifiers_sdxl_v5e.npz"
CACHE_SHORT_STEPS = 4
COMPACT_DENSE = [1024] * 4
COMPACT_FRACTION = 0.5
TRAIN_RES = (512, 768, 1024)
TRAIN_STEPS = 6
# SD3.5-medium's caches: the offline preset's trajectory (4 x 1024^2, 30
# steps), the serving preset's run ((resolution, steps) of the first batch
# and of the request added after SD3_SERVE_ADMIT steps), the token modes
# (2 x 1024^2, 8 steps) and the gates at fraction 1 (every row or token)
SD3_INVARIANT_RES = 1024
SD3_SPAN_REQUESTS = [1024] * 4
SD3_SPAN_STEPS = 30
SD3_SERVE_FIRST = [(512, 12), (1024, 20), (1024, 20)]
SD3_SERVE_LATE = (1024, 8)
SD3_SERVE_ADMIT = 4
SD3_TOKEN_STEPS = 8
SD3_TOKEN_MODES = {
    "block": dict(mode="block", max_hits=2),
    "compact": dict(mode="compact", compact_fraction=0.5, max_hits=2),
    "fine": dict(mode="compact", patch_fraction=0.5, max_hits=2),
    "fine_stale_kv": dict(mode="compact", patch_fraction=0.5, max_hits=2,
                          fine_stale_kv=True),
}
SD3_FULL_FRACTION = {
    "block": dict(mode="block", mse_threshold=-1.0),
    "compact": dict(mode="compact", compact_fraction=1.0),
    "fine stale-KV": dict(mode="compact", patch_fraction=0.9999,
                          fine_stale_kv=True),
}
# the masked kernel at the fine gate's shapes, 2 x 1024^2 (CFG 4 rows) at
# patch_fraction 0.5: k_t = 2048 of 4096 latent queries, all keys; then
# ragged: k_t = 2047 (off the query tile), a shorter request, a pad row
# (B, Lq, Lk, D, H, kind)
FINE_MASKED_SHAPES = [
    (4, 2048 + SD3_CTX, 4096 + SD3_CTX, 1536, 24, "joint"),
    (4, 2048, 4096, 1536, 24, "dual"),
    (3, 2047 + SD3_CTX, 4096 + SD3_CTX, 1536, 24, "joint-ragged"),
    (3, 2047, 4096, 1536, 24, "dual-ragged"),
]
# vae_dtype: SDXL's bf16 ("auto" on the card) and float32 decodes of the
# same latents within 3 uint8 counts on average (JAX
# tests/test_pipelines.py:138); the safety checker's image embeddings on
# the card (float32, TF32 off) within 1e-3 relative of the CPU's
VAE_DTYPE_MEAN_COUNTS = 3.0
CHECKER_REL = 1e-3
SNAPSHOT_REQUESTS = [512, 512]
# the ESyMReD stage profile fitted in the run (SDXL, max_post_batch 4) and
# the files the profiler CLI fitted on an H100 (sduss_tpu_torch/scheduler/h100)
PROFILE_RES = (512, 768, 1024)
PROFILE_POST_BATCH = 4
PROFILE_REQUESTS = [512, 768, 1024]
H100_PROFILES = "sduss_tpu_torch/scheduler/h100"
# Fused multi-step dispatch: chunked (captured step graphs) against
# per-step latents within one bf16 ulp at their scale; SD-1.5 dense 512^2
# x 2 (24 steps) and the serving preset (3 x 512^2, a fourth after 6
# steps: chunks of 3 keep the admission at the same step under both
# dispatches), SDXL's mix (12 steps) and SD3 4 x 1024^2 (16 steps, chunks
# of 8: the first enters mid-interval)
CHUNK_MAX_REL = 2.0 ** -7
CHUNK_K = 6
CHUNK_SD15_STEPS = 24
CHUNK_SD15_K = 3
CHUNK_SD15_ADMIT = 6
CHUNK_SD3_K = 8
CHUNK_SD3_STEPS = 16
# The trace replay (benchmark/replay.py): the first REPLAY_N rows of the
# committed SDXL trace (512/768/1024^2, 50 steps, Poisson at 1 qps) under
# ESyMReD with the card's fitted profile and predictor and the serving
# cache preset, slo 5; eight requests never fill a bucket above 8, so
# prewarm walks (1, 2, 4, 8).  The records' CSV (times written to the
# microsecond) read back gives the metrics of the records at that
# precision, exactly.
REPLAY_TRACE = "exp/sdxl/qps_1.0.csv"
REPLAY_N = 8
REPLAY_SLO = 5
REPLAY_BUCKETS = (1, 2, 4, 8)
# dp replicas on one card (ParallelConfig.devices = [0, 0]): four
# same-resolution SD-1.5 requests added at once
DP2_DEVICES = [0, 0]
DP2_REQUESTS = [512] * 4
# a replica over an sp x tp group on one card (devices [0, 0]): SDXL's
# dense pair and a mixed 768^2 + 1024^2 batch under tp=2, the dense pair
# under sp=2 (sync, then displaced over DISPLACED_STEPS with
# DISPLACED_WARMUP sync steps, then the plain deep cache on the displaced
# seam), SD3.5-medium's dense pair under sp=2 (gather; one forward with
# the K/V rotated around the ring) and tp=2, and the MMDiT stage pipeline
# on two stages; exact modes within GROUP_MAX_REL of the single-device
# run (max error / max |single|), the displaced ones within
# DISPLACED_MAX_REL (the shallow-mode bound)
GROUP_DEVICES = [0, 0]
GROUP_DENSE = [1024, 1024]
GROUP_MIXED = [768, 1024]
GROUP_STEPS = 8
SD3_GROUP_STEPS = 4
DISPLACED_STEPS = 30
DISPLACED_WARMUP = 2
DISPLACED_DEEP = dict(deep_interval=5, deep_warmup=2)
GROUP_MAX_REL = 2.0 ** -7
DISPLACED_MAX_REL = 5e-2
# what another summation order moves: SD3.5-medium's tp trajectory and
# ring forward, and the tp forwards (the row-parallel layers sum bf16
# partials; ring attention is float32 PyTorch math).  On an H100 these
# read up to 2.14e-2, as far as one device's SD3 trajectory moves with its
# attention on the plain versions (2.03e-2, printed beside them).  Each tp
# forward also runs in float32 (TP_FLOAT32_MAX_REL), where only the order
# of float32 sums differs (1.2e-6 and 2.3e-6 on an H100), so that a
# sharding fault cannot hide under the bf16 rounding.
MOVED_MAX_REL = 3e-2
TP_FLOAT32_MAX_REL = 1e-4
# K4 at a tp=2 shard's norm2: SDXL's C / 2 channels over 16 groups
K4_TP2_SHAPES = [(32, 160), (16, 320), (8, 640)]
# K6 (dense GroupNorm + SiLU) at the main path's (N, C, H, W): SDXL's
# levels 0-2 and the 960-channel level-0 up-block input at the shallow
# steps' 8 rows and the full steps' 24, SD-1.5's levels 0-3 and the
# 2560-channel up-block input at 32 rows, the VAE decoder's at 512^2 and
# 1024^2 (one image).  Against group_norm_reference, relative to the
# output's scale: bf16 within 2^-7 of max |plain| (one bf16 ulp at the
# largest output: both compute in float32 and round once; the sums are
# taken in another order and the kernel's x * a + b is one FMA), float32
# within 1e-5 (the same float32 math in another order).
K6_UNET_SHAPES = [(8, 320, 128, 128), (8, 640, 64, 64), (8, 1280, 32, 32),
                  (8, 960, 128, 128), (24, 320, 128, 128), (24, 640, 64, 64),
                  (24, 1280, 32, 32), (24, 960, 128, 128),
                  (32, 320, 64, 64), (32, 640, 32, 32), (32, 1280, 16, 16),
                  (32, 1280, 8, 8), (32, 2560, 8, 8)]
K6_VAE_SHAPES = [(1, 512, 64, 64), (1, 512, 128, 128), (1, 512, 256, 256),
                 (1, 256, 512, 512), (1, 128, 512, 512), (1, 512, 512, 512),
                 (1, 256, 1024, 1024), (1, 128, 1024, 1024)]
K6_MAX_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    operations at the bf16 tensor-core peak and the bytes at the memory
    rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(q, k, v, h, scale, mask=None):
    """The one PyTorch call computing the same attention (timed only)."""
    b, lq, d = q.shape

    def heads(x):
        return x.view(b, x.shape[1], h, d // h).transpose(1, 2)

    return F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v),
        attn_mask=None if mask is None else mask[:, None, None, :],
        scale=scale)


def k1_errors(out, ref) -> tuple:
    """(max abs error, max abs error / max |ref|, relative RMS error)."""
    diff, ref = (out.float() - ref.float()), ref.float()
    err = diff.abs().max().item()
    return (err, err / ref.abs().max().item(),
            (diff.norm() / ref.norm()).item())


def check_k1(card: str) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst, times = 0.0, {}
    for shape in K1_SHAPES:
        b, lq, lk, d, h = shape
        q = torch.randn(b, lq, d, generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        scale = 1.0 / np.sqrt(d // h)
        out = flash_mha_fused(q, k, v, h, scale)
        ref = flash_mha_fused_reference(q, k, v, h, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 non-finite at {shape}")
        err, max_rel, rms_rel = k1_errors(out, ref)
        print(f"K1 flash_mha_fused {shape}: max_abs_err {err:.3e}, "
              f"/ max|plain| {max_rel:.3e} (bound {K1_MAX_REL:.3e}), "
              f"rel RMS {rms_rel:.3e} (bound {K1_RMS_REL:.0e})")
        if not (max_rel <= K1_MAX_REL and rms_rel <= K1_RMS_REL):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape}: {max_rel}, {rms_rel}")
        worst = max(worst, err)
        if shape == K1_SHAPES[2]:
            # the kernel folds a positive scale into its exponent; a negative
            # one negates Q, and 0 weighs every key the same
            for s in (-scale, 0.0):
                e = k1_errors(flash_mha_fused(q, k, v, h, s),
                              flash_mha_fused_reference(q, k, v, h, s))
                print(f"K1 flash_mha_fused {shape} scale {s:.4f}: / max|plain| "
                      f"{e[1]:.3e}, rel RMS {e[2]:.3e}")
                if not (e[1] <= K1_MAX_REL and e[2] <= K1_RMS_REL):
                    raise AssertionError(f"K1 disagrees with its plain version "
                                         f"at {shape}, scale {s}: {e}")
        if shape in K1_TIMED:
            # alternate plain, kernel, kernel, plain on one card
            p1 = cuda_ms(lambda: flash_mha_fused_reference(q, k, v, h, scale), 5)
            k1 = cuda_ms(lambda: flash_mha_fused(q, k, v, h, scale), 20)
            k2 = cuda_ms(lambda: flash_mha_fused(q, k, v, h, scale), 20)
            p2 = cuda_ms(lambda: flash_mha_fused_reference(q, k, v, h, scale), 5)
            lib = cuda_ms(lambda: sdpa(q, k, v, h, scale), 20)
            kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
            flops = 4.0 * b * h * lq * lk * (d // h)
            bms, by = bound(flops, 2.0 * (q.numel() + k.numel() + v.numel()
                                          + q.numel()))
            print(f"K1 time {shape}: kernel {kms:.4f} ms "
                  f"({flops / kms / 1e9:.1f} TFLOP/s), plain {pms:.4f} ms, "
                  f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
            times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def check_k2a(card: str) -> dict:
    """K2a/K3b (flash_mha) against its plain version at SD3's joint and dual
    shapes, a ragged case and a kv_len < Lk case whose excluded keys and
    values are large (a kernel that reads past kv_len fails the bounds)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, times = 0.0, {}
    for shape in K2A_SHAPES:
        b, lq, lk, d, h, kv_len = shape
        q = torch.randn(b, lq, d, generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        n = lk if kv_len is None else kv_len
        k[:, n:], v[:, n:] = 1e4, 1e4
        scale = 1.0 / np.sqrt(d // h)
        out = flash_mha(q, k, v, h, scale, kv_len=kv_len)
        ref = flash_mha_reference(q, k, v, h, scale, kv_len=kv_len)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_mha non-finite at {shape}")
        err, max_rel, rms_rel = k1_errors(out, ref)
        print(f"K2a flash_mha {shape}: max_abs_err {err:.3e}, / max|plain| "
              f"{max_rel:.3e} (bound {K1_MAX_REL:.3e}), rel RMS {rms_rel:.3e} "
              f"(bound {K1_RMS_REL:.0e})")
        if not (max_rel <= K1_MAX_REL and rms_rel <= K1_RMS_REL):
            raise AssertionError(f"flash_mha disagrees with its plain version "
                                 f"at {shape}: {max_rel}, {rms_rel}")
        worst = max(worst, err)
        if shape in K2A_SHAPES[:2]:  # the two SD3 1024^2 shapes
            p1 = cuda_ms(lambda: flash_mha_reference(q, k, v, h, scale), 3)
            k1 = cuda_ms(lambda: flash_mha(q, k, v, h, scale), 10)
            k2 = cuda_ms(lambda: flash_mha(q, k, v, h, scale), 10)
            p2 = cuda_ms(lambda: flash_mha_reference(q, k, v, h, scale), 3)
            lib = cuda_ms(lambda: sdpa(q, k, v, h, scale), 10)
            kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
            flops = 4.0 * b * h * lq * n * (d // h)
            bms, by = bound(flops, 2.0 * (2 * q.numel() + 2 * b * n * d))
            print(f"K2a time {shape}: kernel {kms:.4f} ms "
                  f"({flops / kms / 1e9:.1f} TFLOP/s), plain {pms:.4f} ms, "
                  f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
            times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def sd3_mixed_ctx(device="cuda") -> "mmdit.MMDiTMaskCtx":
    """The attention masks of the SD3 mixed phase's CFG-doubled token batch
    (pipelines/sd3.py denoise_step_mixed with the default configuration)."""
    sc, mc = default_config("sd3").scheduler, default_config("sd3").model
    lens = [(r // 16) ** 2 for r in SD3_MIXED_REQUESTS]
    s_pad = min(b for b in sorted((r // 16) ** 2 for r in mc.resolutions)
                if b >= max(lens))
    bb = min(b for b in sc.batch_buckets if b >= len(lens))
    mask = torch.zeros(bb, s_pad, dtype=torch.bool, device=device)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return mmdit.MMDiTMaskCtx(torch.cat([mask, mask]), SD3_CTX)


def masked_inputs(gen, shape):
    """bf16 N(0, 1) q, k, v and the (B, L) key mask of one masked case."""
    b, length, d, h, dead = shape
    dev = gen.device
    q, k, v = (torch.randn(b, length, d, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    if dead in ("joint", "dual"):
        ctx = sd3_mixed_ctx()
        mask = ctx.joint_mask if dead == "joint" else ctx.token_mask
        if tuple(mask.shape) != (b, length):
            raise AssertionError(f"SD3 token mask {tuple(mask.shape)} != "
                                 f"{(b, length)}")
    elif dead in ("joint-all", "dual-all"):
        mask = torch.ones(b, length, dtype=torch.bool, device=dev)
    elif dead is None:
        mask = torch.rand(b, length, generator=gen, device=dev) > 0.3
        mask[:, :64] = False   # a whole key tile masked
        mask[:, -1] = True
    elif dead == "last":
        mask = torch.zeros(b, length, dtype=torch.bool, device=dev)
        mask[:, -1] = True
    elif dead == "alt":
        tile = torch.arange(length, device=dev) // 64
        mask = (tile % 2 == 0).expand(b, length).contiguous()
    else:
        mask = torch.ones(b, length, dtype=torch.bool, device=dev)
        mask[b - dead:] = False  # padded image slots: no valid key
    return q, k, v, mask


def check_masked(card: str) -> dict:
    """The masked flash kernel against its plain version at the mixed
    path's class-group shapes, over rows with a valid key (same bounds as
    K1); rows with none must be exactly 0 (finite).  Timed beside the plain
    version and SDPA with the same boolean mask."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, times = 0.0, {}
    for shape in MASKED_SHAPES:
        b, length, d, h, dead = shape
        q, k, v, mask = masked_inputs(gen, shape)
        scale = 1.0 / np.sqrt(d // h)
        out = flash_mha_masked(q, k, v, mask, h, scale)
        ref = flash_mha_masked_reference(q, k, v, mask, h, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"masked flash non-finite at {shape}")
        live = mask.any(dim=1)
        if not (out[~live] == 0).all():
            raise AssertionError(f"masked flash: rows with no valid key are "
                                 f"not zero at {shape}")
        err, max_rel, rms_rel = k1_errors(out[live], ref[live])
        print(f"masked flash_mha_masked {shape}: {int((~live).sum())} rows "
              f"with no valid key (zeros); max_abs_err {err:.3e}, / max|plain| "
              f"{max_rel:.3e} (bound {K1_MAX_REL:.3e}), rel RMS {rms_rel:.3e} "
              f"(bound {K1_RMS_REL:.0e})")
        if not (max_rel <= K1_MAX_REL and rms_rel <= K1_RMS_REL):
            raise AssertionError(f"masked flash disagrees with its plain "
                                 f"version at {shape}: {max_rel}, {rms_rel}")
        worst = max(worst, err)
        if dead not in MASKED_UNTIMED:
            p1 = cuda_ms(lambda: flash_mha_masked_reference(q, k, v, mask, h,
                                                            scale), 3)
            k1 = cuda_ms(lambda: flash_mha_masked(q, k, v, mask, h, scale), 10)
            k2 = cuda_ms(lambda: flash_mha_masked(q, k, v, mask, h, scale), 10)
            p2 = cuda_ms(lambda: flash_mha_masked_reference(q, k, v, mask, h,
                                                            scale), 3)
            lib = cuda_ms(lambda: sdpa(q, k, v, h, scale, mask), 10)
            kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
            # the work these inputs need: every query row of a batch row
            # against that row's valid keys
            flops = 4.0 * h * (d // h) * length * mask.sum().item()
            bms, by = bound(flops, 2.0 * 4 * q.numel() + mask.numel())
            print(f"masked time {shape}: kernel {kms:.4f} ms "
                  f"({flops / kms / 1e9:.1f} TFLOP/s), plain {pms:.4f} ms, "
                  f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
            times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def mixed_meta(family: str = "sdxl", requests=MIXED_REQUESTS):
    """The CFG-doubled patch metadata of a mixed serving phase."""
    sc = default_config(family).scheduler
    grids = tuple(r // 8 // (sc.patch_size // 8) for r in requests)
    return patching.double_meta(grids, sc.patch_size // 8,
                                tuple(sc.patch_buckets), tuple(sc.batch_buckets))


def sub_meta(family: str, requests):
    """The gated sub-composition of a mixed deep shallow step under the
    family's production preset (``compact_submeta`` of the doubled meta,
    pair-coherent capacities)."""
    meta = mixed_meta(family, requests)
    frac = CacheConfig.production(family).deep_compact_fraction
    return patching.compact_submeta(meta.patch_cells, meta.class_info, frac,
                                    True)[0]


def check_k4(card: str, meta=None, shapes=K4_SHAPES, seed: int = 2,
             groups: int = 32) -> dict:
    """K4 against its plain version on a mixed phase's doubled patch batch
    (SDXL's by default: 128 patches of 8 image slots, real border patches
    and a dummy image) at each (s, C) of ``shapes`` over ``groups`` groups
    (a tensor-parallel shard's norm2: C / tp channels, 32 / tp groups),
    with a bf16 GroupNorm weight and bias (the model's dtype); halo cells
    of -1 neighbours must be exactly 0.  The moments and the fused op
    (``gn_silu_haloed``) must give the same bits on a second call."""
    meta = mixed_meta() if meta is None else meta
    gen = torch.Generator(device="cuda").manual_seed(seed)
    image_id = torch.from_numpy(meta.image_id).cuda()
    nb = neighbors = torch.from_numpy(meta.neighbors).cuda()
    worst, times = 0.0, {}
    for s, c in shapes:
        shape = (meta.p_pad, s, c)
        x = (1.5 * torch.randn(meta.p_pad, c, s, s, generator=gen,
                               device="cuda") + 0.2).to(torch.bfloat16)
        w, bias = (torch.randn(c, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        stats = moments(x, image_id, meta.i_pad, groups)
        again = moments(x, image_id, meta.i_pad, groups)
        haloed = [gn_silu_haloed(x, w, bias, image_id, neighbors, meta.i_pad,
                                 groups, 1e-5) for _ in range(2)]
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(stats, again))
                and torch.equal(*haloed)):
            raise AssertionError(f"K4's moments or gn_silu_haloed differ "
                                 f"between two calls at {shape}")
        print(f"K4 (P, s, C) {shape}, {groups} groups: moments and "
              f"gn_silu_haloed repeat bit for bit")
        mean, var = stats
        rstd = torch.rsqrt(var + 1e-5)
        out = gn_silu_halo(x, image_id, neighbors, mean, rstd, w, bias)
        ref = gn_silu_halo_reference(x, image_id, neighbors, mean, rstd, w,
                                     bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        max_rel = err / ref.float().abs().max().item()
        borders = [out[nb[:, 0] < 0][:, :, 0, :], out[nb[:, 1] < 0][:, :, -1, :],
                   out[nb[:, 2] < 0][:, :, :, 0], out[nb[:, 3] < 0][:, :, :, -1]]
        if not all((t == 0).all() for t in borders):
            raise AssertionError(f"K4 halo of an image border not zero at "
                                 f"{shape}")
        print(f"K4 gn_silu_halo (P, s, C) {shape}: max_abs_err {err:.3e}, "
              f"/ max|plain| {max_rel:.3e} (bound {K4_MAX_REL:.3e}), image "
              f"borders 0")
        if not max_rel <= K4_MAX_REL:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{shape}: {max_rel}")
        worst = max(worst, err)
        args = (x, image_id, neighbors, mean, rstd, w, bias)
        p1 = cuda_ms(lambda: gn_silu_halo_reference(*args), 5)
        k1 = cuda_ms(lambda: gn_silu_halo(*args), 20)
        k2 = cuda_ms(lambda: gn_silu_halo(*args), 20)
        p2 = cuda_ms(lambda: gn_silu_halo_reference(*args), 5)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        # bf16 in and out, the float32 moments, the bf16 affine, the index
        # arrays
        nbytes = (2.0 * (x.numel() + out.numel()) + 2 * 4 * meta.i_pad * groups
                  + 2 * 2 * c + 4 * 9 * meta.p_pad)
        bms, by = bound(2.0 * out.numel(), nbytes)
        print(f"K4 time {shape}: kernel {kms:.4f} ms "
              f"({nbytes / kms / 1e6:.1f} GB/s), plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]")
        times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": None,
                        "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def rotating_ms(fn, xs, iters: int) -> float:
    """:func:`cuda_ms` of ``fn`` over the inputs ``xs`` in turn: enough
    copies that each call reads its input from device memory, not L2."""
    inputs = itertools.cycle(xs)
    return cuda_ms(lambda: fn(next(inputs)), iters)


def check_k6(card: str) -> dict:
    """K6 (gn_dense) against its plain version at the main path's shapes:
    bf16 and (the VAE's) float32, act none and SiLU, with and without the
    time-embedding add (the UNet's norm2); two calls give the same bits.
    Times the kernel, its bound (one read and one write), the plain
    version and ``F.group_norm`` (PyTorch's own, the library yardstick;
    the port never calls it), each over inputs that do not fit L2."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst, times = 0.0, {}
    cases = [(s, torch.bfloat16, "unet") for s in K6_UNET_SHAPES]
    cases += [(s, dt, "vae") for s in K6_VAE_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dtype, kind in cases:
        n, c = shape[:2]
        eps = 1e-5 if kind == "unet" else 1e-6
        x = (1.5 * torch.randn(*shape, generator=gen, device="cuda")
             + 0.2).to(dtype)
        w, b = (torch.randn(c, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        add = (torch.randn(n, c, generator=gen, device="cuda").to(dtype)
               if kind == "unet" else None)
        variants = [("silu", None), (None, None)]
        if add is not None:
            variants += [("silu", add), (None, add)]
        shape_abs = shape_rel = 0.0
        for act, a in variants:
            args = (x, w, b, 32, eps, act, a)
            out = gn_dense(*args)
            again = gn_dense(*args)
            ref = group_norm_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"K6 differs between two calls at "
                                     f"{shape} {dtype} act {act} add "
                                     f"{a is not None}")
            err = (out.float() - ref.float()).abs().max().item()
            max_rel = err / ref.float().abs().max().item()
            if not (torch.isfinite(out).all() and max_rel <= K6_MAX_REL[dtype]):
                raise AssertionError(f"K6 disagrees with its plain version at "
                                     f"{shape} {dtype} act {act} add "
                                     f"{a is not None}: {max_rel}")
            worst = max(worst, err)
            shape_abs, shape_rel = max(shape_abs, err), max(shape_rel, max_rel)
        print(f"K6 gn_dense {shape} {str(dtype)[6:]}: max_abs_err "
              f"{shape_abs:.3e}, / max|plain| {shape_rel:.3e} (bound "
              f"{K6_MAX_REL[dtype]:.1e}) for act silu/none"
              f"{', with add' if add is not None else ''}; repeats bit for "
              f"bit")
        if kind == "unet" and shape[2] < 64 and n != 8:
            continue  # timed: the 8-row shapes, 64^2 and 128^2, the decodes
        nbytes = 2.0 * x.numel() * x.element_size()
        xs = [x] + [x.clone() for _ in range(
            max(0, min(int(-(-2.5 * 50e6 // nbytes)), 16) - 1))]
        k1 = rotating_ms(lambda t: gn_dense(t, w, b, 32, eps, "silu"), xs, 20)
        p1 = rotating_ms(lambda t: group_norm_reference(t, w, b, 32, eps,
                                                        "silu"), xs, 5)
        lib = rotating_ms(lambda t: F.group_norm(t, 32, w, b, eps), xs, 20)
        k2 = rotating_ms(lambda t: gn_dense(t, w, b, 32, eps, "silu"), xs, 20)
        p2 = rotating_ms(lambda t: group_norm_reference(t, w, b, 32, eps,
                                                        "silu"), xs, 5)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        bms, by = bound(10.0 * x.numel(), nbytes)
        cs = plan_cluster(n, c, x.numel() // (n * c), 32, x.element_size())
        design = f"single read, {cs} blocks a group" if cs else "two passes"
        print(f"K6 time {shape} {str(dtype)[6:]} act silu ({design}): "
              f"kernel {kms:.4f} "
              f"ms ({nbytes / kms / 1e6:.1f} GB/s, {kms / bms:.2f}x the "
              f"bound), plain {pms:.4f} ms ({pms / kms:.1f}x), F.group_norm "
              f"{lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
        times[(shape, str(dtype)[6:])] = {
            "ms": kms, "plain_ms": pms, "library_ms": lib, "bound_ms": bms,
            "bound_by": by, "design": design}
        del xs
    return {"max_abs_err": worst, "times": times}


def norms_of(*modules) -> int:
    """The dense GroupNorms in ``modules``."""
    return sum(isinstance(m, layers.GroupNorm) for mod in modules
               for m in mod.modules())


def check_k6_launches(card: str, bundle: ModelBundle) -> dict:
    """Every dense GroupNorm goes through K6 (one launch or two): one full
    SDXL UNet forward at 8 x 1024^2 rows (the plain forward, deep mode
    "full" at boundary 1), one shallow forward (the levels below the
    boundary and conv_norm_out) and one 1024^2 decode, each exactly one
    call a GroupNorm (``gn_dense.launches`` counts calls)."""
    unet = bundle.denoiser
    vae = bundle.models["vae"]
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = 8
    x = rand(rows, 128, 128, 4)
    t = torch.tensor([700.0, 300.0] * (rows // 2), device="cuda")
    ehs = rand(rows, 77, unet.cfg.cross_attention_dim)
    added = {"text_embeds": rand(rows, unet.cfg.addition_embed[1]),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]]
                                      * rows, device="cuda")}
    n_up = len(unet.up_blocks)
    want = {"full": norms_of(unet),
            "shallow": norms_of(unet.down_blocks[0], unet.up_blocks[n_up - 1],
                                unet.conv_norm_out),
            "decode": norms_of(vae.decoder)}
    # the count the serving phases expect, from the config, is the module's
    if (dense_norms(unet.cfg), dense_norms(unet.cfg, 1)) != (
            want["full"], want["shallow"]):
        raise AssertionError(f"dense_norms {dense_norms(unet.cfg)} / "
                             f"{dense_norms(unet.cfg, 1)} != the UNet's "
                             f"{want['full']} / {want['shallow']}")
    got = {}
    with torch.inference_mode():
        before = gn_dense.launches
        unet(x, t, ehs, added_cond=added)
        got["plain"] = gn_dense.launches - before
        before = gn_dense.launches
        _, feat = unet(x, t, ehs, added_cond=added, deep_mode="full",
                       deep_boundary=1)
        got["full"] = gn_dense.launches - before
        before = gn_dense.launches
        unet(x, t, ehs, added_cond=added, deep_mode="shallow",
             deep_state=feat, deep_boundary=1)
        got["shallow"] = gn_dense.launches - before
        lat = rand(1, 128, 128, vae.cfg.latent_channels,
                   dtype=next(vae.parameters()).dtype)
        before = gn_dense.launches
        vae.decode(lat)
        got["decode"] = gn_dense.launches - before
    torch.cuda.synchronize()
    expect = {"plain": want["full"], "full": want["full"],
              "shallow": want["shallow"], "decode": want["decode"]}
    print(f"K6 launches: SDXL forward at {rows} x 1024^2 {got['plain']}, "
          f"deep full {got['full']}, shallow {got['shallow']}, 1024^2 decode "
          f"{got['decode']} (expected {expect}: one a GroupNorm, "
          f"{want['full']} / {want['shallow']} / {want['decode']} GroupNorms) "
          f"[{card}]")
    if got != expect:
        raise AssertionError(f"K6 launches {got} != {expect}")
    return got


def check_k5(card: str) -> dict:
    """K5 (flash_cross_short) against its plain version at the text
    cross-attention shapes of the bench and of the serving paths and at the
    key chunks' edges (same bounds as K1), and with a negative and a zero
    scale; timed beside the plain version, SDPA and the plain route the
    dispatcher took before it routed here (``layers.attention``)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, times = 0.0, {}
    for shape in K5_SHAPES:
        b, lq, lk, d, h = shape
        q = torch.randn(b, lq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        scale = 1.0 / np.sqrt(d // h)
        out = flash_cross_short(q, k, v, h, scale)
        ref = flash_cross_short_reference(q, k, v, h, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K5 non-finite at {shape}")
        err, max_rel, rms_rel = k1_errors(out, ref)
        print(f"K5 flash_cross_short {shape}: max_abs_err {err:.3e}, "
              f"/ max|plain| {max_rel:.3e} (bound {K1_MAX_REL:.3e}), "
              f"rel RMS {rms_rel:.3e} (bound {K1_RMS_REL:.0e})")
        if not (max_rel <= K1_MAX_REL and rms_rel <= K1_RMS_REL):
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{shape}: {max_rel}, {rms_rel}")
        worst = max(worst, err)
        if shape == K5_SHAPES[-3]:
            # the kernel folds a positive scale into its exponent; a negative
            # one negates Q, and 0 weighs every key the same
            for sc in (-scale, 0.0):
                e = k1_errors(flash_cross_short(q, k, v, h, sc),
                              flash_cross_short_reference(q, k, v, h, sc))
                print(f"K5 flash_cross_short {shape} scale {sc:.4f}: / "
                      f"max|plain| {e[1]:.3e}, rel RMS {e[2]:.3e}")
                if not (e[1] <= K1_MAX_REL and e[2] <= K1_RMS_REL):
                    raise AssertionError(f"K5 disagrees with its plain "
                                         f"version at {shape}, scale {sc}: {e}")
        if shape in K5_TIMED:
            p1 = cuda_ms(lambda: flash_cross_short_reference(q, k, v, h, scale), 5)
            k1 = cuda_ms(lambda: flash_cross_short(q, k, v, h, scale), 20)
            k2 = cuda_ms(lambda: flash_cross_short(q, k, v, h, scale), 20)
            p2 = cuda_ms(lambda: flash_cross_short_reference(q, k, v, h, scale), 5)
            route = cuda_ms(lambda: layers.attention(q, k, v, h, scale=scale),
                            20)
            lib = cuda_ms(lambda: sdpa(q, k, v, h, scale), 20)
            kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
            flops = 4.0 * b * lq * lk * d
            nbytes = 2.0 * (2 * q.numel() + 2 * k.numel())
            bms, by = bound(flops, nbytes)
            print(f"K5 time {shape}: kernel {kms:.4f} ms "
                  f"({nbytes / kms / 1e6:.1f} GB/s), plain {pms:.4f} ms, "
                  f"the plain route it replaced (layers.attention) "
                  f"{route:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}) [{card}]")
            times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def check_block() -> None:
    """A full-width SDXL level-1 transformer block (640 ch, 10 heads,
    context 2048, 32x32 tokens): card bf16 through K1 vs CPU float32."""
    torch.manual_seed(0)
    blk = BasicTransformerBlock(640, 2048, 10).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.05)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 1024, 640), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 2048), dtype=np.float32))
    with torch.inference_mode():
        ref = blk(x, ctx)
        gpu = blk.to("cuda", torch.bfloat16)
        before = flash_mha_fused.launches
        out = gpu(x.to("cuda", torch.bfloat16), ctx.to("cuda", torch.bfloat16))
        torch.cuda.synchronize()
    if flash_mha_fused.launches != before + 1:
        raise AssertionError("the block's self-attention did not launch K1")
    rel = ((out.float().cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"SDXL transformer block (2, 1024, 640) card bf16 vs CPU fp32: "
          f"max err / max |ref| {rel:.3e} (bound {BLOCK_BOUND:.0e})")
    if not rel <= BLOCK_BOUND:
        raise AssertionError(f"transformer block disagrees with CPU: {rel}")


def check_sd3_block() -> None:
    """SD3.5-medium's block 0 (dual attention, 24 heads x 64) over 48^2
    latent tokens + 333 context tokens, CFG pair: card bf16 vs CPU float32.
    Its joint (2637 keys) and dual (2304 keys) K rows exceed 6 MiB, so both
    attentions launch flash_mha (K2a)."""
    torch.manual_seed(0)
    cfg = mmdit.SD35_MEDIUM
    blk = mmdit.JointTransformerBlock(cfg, last=False, dual=True).eval()
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm_" in name:
                p.copy_(1.0 + 0.1 * torch.randn_like(p))
            else:
                p.normal_(0.0, 0.02)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 48 * 48, cfg.dim),
                                             dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((2, SD3_CTX, cfg.dim),
                                             dtype=np.float32))
    temb = torch.from_numpy(rng.standard_normal((2, cfg.dim), dtype=np.float32))
    with torch.inference_mode():
        ref_x, ref_c = blk(x, c, temb)
        gpu = blk.to("cuda", torch.bfloat16)
        before = flash_mha.launches
        out_x, out_c = gpu(*(t.to("cuda", torch.bfloat16) for t in (x, c, temb)))
        torch.cuda.synchronize()
    if flash_mha.launches != before + 2:
        raise AssertionError(f"the SD3 block launched flash_mha "
                             f"{flash_mha.launches - before} times, not 2")
    for name, out, ref in (("x", out_x, ref_x), ("context", out_c, ref_c)):
        rel = ((out.float().cpu() - ref).abs().max() / ref.abs().max()).item()
        print(f"SD3 dual block 0 {name} (2, {ref.shape[1]}, {cfg.dim}) card "
              f"bf16 vs CPU fp32: max err / max |ref| {rel:.3e} (bound "
              f"{BLOCK_BOUND:.0e})")
        if not rel <= BLOCK_BOUND:
            raise AssertionError(f"SD3 block {name} disagrees with CPU: {rel}")


def check_sd15_block() -> None:
    """A full-width SD-1.5 level-0 spatial transformer (320 ch, 8 heads of
    40, context 768, 1x1-conv projections) over 64x64 tokens, CFG pair:
    card bf16 through K1 at hd 40 vs CPU float32."""
    torch.manual_seed(0)
    blk = unet_mod.Transformer2DModel(320, 768, 8, 1, 32,
                                      use_linear=False).eval()
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.startswith("norm"):
                continue  # GroupNorm affine stays (1, 0)
            p.normal_(0.0, 0.05)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 320, 64, 64),
                                             dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 768), dtype=np.float32))
    with torch.inference_mode():
        ref = blk(x, ctx)
        gpu = blk.to("cuda", torch.bfloat16)
        before = flash_mha_fused.launches
        out = gpu(x.to("cuda", torch.bfloat16), ctx.to("cuda", torch.bfloat16))
        torch.cuda.synchronize()
    if flash_mha_fused.launches != before + 1:
        raise AssertionError("the SD-1.5 block's self-attention did not "
                             "launch K1")
    rel = ((out.float().cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"SD-1.5 conv-projection transformer (2, 320, 64, 64) card bf16 vs "
          f"CPU fp32: max err / max |ref| {rel:.3e} (bound {BLOCK_BOUND:.0e})")
    if not rel <= BLOCK_BOUND:
        raise AssertionError(f"SD-1.5 block disagrees with CPU: {rel}")


def check_ptxas(log: str) -> None:
    """Registers and spills of the flash template's eight instantiations
    (hd 40/64/80/160 x masked), none of which may spill at hd 40, 64 or
    80, and of K5's four (hd 40/64/80/160), none of which may spill.  A
    fresh build's log only: a reused library has none."""
    if not log:
        print("ptxas: the library was reused, no build log")
        return
    usage = _build.ptxas_usage(log)
    for u in usage:
        print(f"ptxas {u['kernel']}: {u['registers']} registers, "
              f"{u['spill_stores']} bytes spill stores, {u['spill_loads']} "
              f"bytes spill loads, {u['smem']} bytes static smem")
    flash = [u for u in usage if u["kernel"].startswith("mha_fused_kernel<")]
    cross = [u for u in usage if u["kernel"].startswith("cross_short_kernel<")]
    if len(flash) != 8 or len(cross) != 4:
        raise AssertionError(f"{len(flash)} flash and {len(cross)} K5 "
                             f"instantiations in the ptxas log, not 8 and 4")
    spilled = [u["kernel"] for u in flash if u["spill_stores"]
               and not u["kernel"].startswith("mha_fused_kernel<160,")]
    spilled += [u["kernel"] for u in cross
                if u["spill_stores"] or u["spill_loads"]]
    if spilled:
        raise AssertionError(f"instantiations spill: {spilled}")


def build_bundle(family: str = "sdxl") -> ModelBundle:
    t0 = time.perf_counter()
    bundle = ModelBundle(family, dtype=torch.bfloat16, device="cuda")
    bundle.init_random(seed=0)
    torch.cuda.synchronize()
    n = {k: sum(p.numel() for p in m.parameters())
         for k, m in bundle.models.items()}
    print(f"{family} bundle built (random bf16 weights, "
          f"{bundle.param_dtype('vae')} VAE) in "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{k} {v / 1e9:.3f} B" for k, v in sorted(n.items())))
    return bundle


def check_patched(bundle: ModelBundle, res=(768, 1024)) -> None:
    """One full-width UNet forward on a patch batch of ``res`` images (bf16)
    against the dense forward of each image."""
    unet = bundle.denoiser
    family = bundle.family
    sc = default_config(family).scheduler
    cells = sc.patch_size // 8
    grids = tuple(r // 8 // cells for r in res)
    meta = patching.build_meta(grids, cells, tuple(sc.patch_buckets),
                               tuple(sc.batch_buckets))
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    n = len(res)
    images = [rand(1, r // 8, r // 8, 4) for r in res]
    t = torch.linspace(700.0, 300.0, n, device="cuda")
    ehs = rand(n, 77, unet.cfg.cross_attention_dim)
    added = None
    if unet.cfg.addition_embed is not None:  # SDXL's text_time conditioning
        added = {"text_embeds": rand(n, unet.cfg.addition_embed[1]),
                 "time_ids": torch.tensor([[r, r, 0, 0, r, r] for r in res],
                                          dtype=torch.float32, device="cuda")}

    def pad(x, rows):
        return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])

    def rows(i, j):
        return None if added is None else {k: a[i:j] for k, a in added.items()}

    x = pad(torch.cat([patching.split_latent(im, cells) for im in images]),
            meta.p_pad)
    with torch.inference_mode():
        out = unet(x, pad(t, meta.i_pad), pad(ehs, meta.i_pad),
                   added_cond=None if added is None else {
                       k: pad(a, meta.i_pad) for k, a in added.items()},
                   ctx=PatchContext(meta, "cuda"))
        off = 0
        for i, g in enumerate(grids):
            dense = unet(images[i], t[i:i + 1], ehs[i:i + 1],
                         added_cond=rows(i, i + 1))
            got = patching.merge_patches(out[off:off + g * g], g)
            off += g * g
            rel = ((got.float() - dense.float()).abs().max()
                   / dense.float().abs().max()).item()
            print(f"{family} UNet {res[i]}^2 patched (in a {list(res)} patch "
                  f"batch) vs dense, bf16 on the card: max err / max |dense| "
                  f"{rel:.3e} (bound {PATCH_BOUND:.0e})")
            if not (np.isfinite(rel) and rel <= PATCH_BOUND):
                raise AssertionError(f"patched UNet disagrees with dense at "
                                     f"{res[i]}: {rel}")


def check_outputs(outs, resolutions, card: str) -> None:
    if len(outs) != len(resolutions):
        raise AssertionError(f"{len(outs)} outputs for {len(resolutions)} "
                             f"requests")
    for o, res in zip(outs, resolutions):
        if o.aborted or not o.finished:
            raise AssertionError(f"request {o.request_id} aborted/unfinished")
        img = o.image
        if img.dtype != np.uint8 or img.shape != (res, res, 3):
            raise AssertionError(f"bad image {img.dtype} {img.shape}")
        if img.std() == 0:
            raise AssertionError("constant image")
        print(f"request {o.request_id} {res}x{res}: latency "
              f"{o.e2e_latency_s:.3f} s, image mean {img.mean():.2f} "
              f"std {img.std():.2f} [{card}]")


def step_gaps(log, resolutions: str, label: str, card: str) -> float:
    """Device step time of one batch: the gaps between its consecutive
    DENOISING iterations in the schedule log.  With the worker's bounded
    runahead each iteration waits for an earlier step, so past the first
    two the gap is the device step time."""
    starts = [e["time"] for e in log
              if e["stage"] == "denoising" and e["resolutions"] == resolutions]
    gaps = np.diff(starts)[2:] * 1e3
    print(f"denoise step, {label}: mean {gaps.mean():.2f} ms over {len(gaps)} "
          f"steps (min {gaps.min():.2f}, max {gaps.max():.2f}) [{card}]")
    return float(gaps.mean())


def serve(card: str, bundle: ModelBundle) -> dict:
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False  # the dense path
    config.engine.collect_data = True  # per-iteration schedule log
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    unet = pipe.engine.workers[0].pipeline.bundle.denoiser
    n_self = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    prompts = ["a lighthouse on a cliff at dusk", "a bowl of ramen, studio photo",
               "an astronaut riding a horse"]

    reset_counts()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, resolution=REQUESTS,
                         num_inference_steps=STEPS, seed=1234)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()

    check_outputs(outs, REQUESTS, card)
    # two single-resolution groups (1024 pair, then 768), STEPS steps each;
    # every transformer block has one self- and one text cross-attention
    expected = n_self * STEPS * len(set(REQUESTS))
    # K6: one a GroupNorm of each group's forward a step, and of each decode
    want_k6 = (dense_norms(unet.cfg) * STEPS * len(set(REQUESTS))
               + decode_launches()["k6"])
    print(f"serving: {len(outs)} requests in {wall:.3f} s, launches {got} "
          f"(K1 and K5 expected >= {expected} each: {n_self} self- and "
          f"cross-attentions x {STEPS} steps x {len(set(REQUESTS))} groups; "
          f"K6 >= {want_k6})")
    if got["k1"] < expected or got["k5"] < expected or got["k6"] < want_k6:
        raise AssertionError("the serving path did not go through K1, K5 "
                             "and K6")

    # final latents are finite (the uint8 cast would hide NaN)
    lat = pipe.generate(prompts[:1], resolution=768, num_inference_steps=2,
                        seed=7, output_type="latent")[0].image
    if lat.shape != (96, 96, 4) or not np.isfinite(lat).all():
        raise AssertionError(f"bad latents {lat.shape}")

    # the 1024^2 pair (4 UNet rows with CFG)
    step_gaps(pipe.engine.workers[0].schedule_log, "1024x2",
              "batch 2 x 1024^2 (CFG 4 rows)", card)
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{card}]")
    return got


def serve_mixed(card: str, bundle: ModelBundle) -> dict:
    """The default configuration: one mixed 768^2 + 3 x 1024^2 DENOISING
    batch per iteration, one patched UNet forward each."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.engine.collect_data = True
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    if not (config.scheduler.use_mixed_resolution
            and config.scheduler.policy == "fcfs_mixed"):
        raise AssertionError("the default configuration is not the mixed path")
    unet = pipe.engine.workers[0].pipeline.bundle.denoiser
    n_self = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    n_k4 = 2 * len([m for m in unet.modules()
                    if type(m).__name__ == "ResnetBlock2D"]) + 1
    prompts = ["a red fox in snow", "a harbor at night, long exposure",
               "a watercolor of a mountain lake", "a robot reading a book"]

    reset_counts()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, resolution=MIXED_REQUESTS,
                         num_inference_steps=STEPS, seed=99)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    masked, k4 = got["masked"], got["k4"]

    check_outputs(outs, MIXED_REQUESTS, card)
    log = pipe.engine.workers[0].schedule_log
    key = ";".join(f"{r}x{MIXED_REQUESTS.count(r)}"
                   for r in sorted(set(MIXED_REQUESTS)))
    batches = [e["resolutions"] for e in log if e["stage"] == "denoising"]
    if batches != [key] * STEPS:
        raise AssertionError(f"expected {STEPS} mixed DENOISING batches "
                             f"{key}, got {batches}")
    classes = len(set(MIXED_REQUESTS))
    want_masked = n_self * classes * STEPS
    want_k4 = n_k4 * STEPS
    want_k5 = n_self * STEPS  # one text cross-attention per block
    print(f"mixed serving: {len(outs)} requests in {wall:.3f} s; DENOISING "
          f"batches {batches[0]} x {len(batches)}; masked flash launches "
          f"{masked} (expected >= {want_masked}: {n_self} self-attentions x "
          f"{classes} classes x {STEPS} steps), K4 launches {k4} (expected "
          f">= {want_k4}: {n_k4} per forward x {STEPS} steps), K5 launches "
          f"{got['k5']} (expected {want_k5}: {n_self} cross-attentions x "
          f"{STEPS} steps), all {got}")
    if masked < want_masked or k4 < want_k4 or got["k5"] != want_k5:
        raise AssertionError("the mixed path did not go through its kernels")
    check_decode_k6(got, "mixed serving")  # the patch batch runs no K6

    meta = mixed_meta()
    step_gaps(log, key, f"mixed {key} patch batch (CFG: {meta.p_pad} "
              f"patches of {meta.patch_cells}^2, {meta.n_patches} real)", card)
    peak = torch.cuda.max_memory_allocated()

    # final latents are finite (the uint8 cast would hide NaN)
    lat = pipe.generate(prompts, resolution=MIXED_REQUESTS,
                        num_inference_steps=2, seed=7, output_type="latent")
    for o, r in zip(lat, MIXED_REQUESTS):
        if o.image.shape != (r // 8, r // 8, 4) or not np.isfinite(o.image).all():
            raise AssertionError(f"bad mixed latents {o.image.shape}")
    print(f"max_memory_allocated {peak / 2**30:.2f} GiB [{card}]")
    return got


def build_sd3_bundle() -> ModelBundle:
    t0 = time.perf_counter()
    bundle = ModelBundle("sd3", dtype=torch.bfloat16, device="cuda")
    bundle.init_random(seed=0)
    torch.cuda.synchronize()
    n = {k: sum(p.numel() for p in m.parameters())
         for k, m in bundle.models.items()}
    print(f"SD3.5-medium bundle built (random bf16 weights) in "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{k} {v / 1e9:.3f} B" for k, v in sorted(n.items())))
    return bundle


def sd3_attentions(bundle: ModelBundle, skip=(0, 0)) -> int:
    """Attention calls per MMDiT forward: one joint per block, one more per
    dual block (24 + 13 for SD3.5-medium), without the blocks ``lo <= i <
    hi`` of ``skip`` (a shallow span step's)."""
    lo, hi = skip
    return sum(1 + blk.dual for i, blk in
               enumerate(bundle.denoiser.transformer_blocks)
               if not lo <= i < hi)


def time_sd3_stages(pipe, card: str) -> None:
    """PREPARE of two 1024^2 requests (the three text encoders, cold, then
    again through the T5 row cache) and the tiled VAE decode of one
    1024^2 latent, host clock around work that ends in a synchronise."""
    p = pipe.engine.workers[0].pipeline

    def reqs():
        return [Request(f"t{i}", SamplingParams(
            prompt=f"a stage timing prompt {i}", resolution=1024,
            num_inference_steps=STEPS, seed=i)) for i in range(2)]

    times = []
    for _ in range(2):
        rs = reqs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.prepare(rs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        p._decode_fn(rs[0].latents)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = p._decode_fn(rs[0].latents)
        torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) * 1e3
    print(f"SD3 prepare (2 x 1024^2, CLIP-L + CLIP-G + T5-XXL): "
          f"{times[0]:.2f} ms cold, {times[1]:.2f} ms through the T5 row "
          f"cache; tiled VAE decode 1024^2 ({p.bundle.param_dtype('vae')}, "
          f"{tuple(img.shape)}): {dec:.2f} ms [{card}]")


def serve_sd3(card: str, bundle: ModelBundle) -> int:
    """SD3 dense serving: [1024, 1024, 768] with mixed batches off, one
    MMDiT forward per resolution group; every attention launches
    flash_mha (K2a)."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd3", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False
    config.engine.collect_data = True
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    prompts = ["a lighthouse on a cliff at dusk", "a bowl of ramen, studio photo",
               "an astronaut riding a horse"]
    n_attn = sd3_attentions(bundle)

    reset_counts()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, resolution=SD3_REQUESTS,
                         num_inference_steps=STEPS, seed=1234)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    launches = got["flash_mha"]

    check_outputs(outs, SD3_REQUESTS, card)
    groups = len(set(SD3_REQUESTS))
    expected = n_attn * STEPS * groups
    print(f"SD3 dense serving: {len(outs)} requests in {wall:.3f} s, "
          f"flash_mha launches {launches} (expected >= {expected}: {n_attn} "
          f"attentions x {STEPS} steps x {groups} groups), all {got}")
    if launches < expected:
        raise AssertionError("the SD3 dense path did not go through flash_mha")
    check_decode_k6(got, "SD3 dense serving")
    res, n = SD3_REQUESTS[0], SD3_REQUESTS.count(SD3_REQUESTS[0])
    step_gaps(pipe.engine.workers[0].schedule_log, f"{res}x{n}",
              f"SD3 batch {n} x {res}^2 (CFG {2 * n} rows)", card)
    peak = torch.cuda.max_memory_allocated()

    r = SD3_REQUESTS[-1]
    lat = pipe.generate(prompts[:1], resolution=r, num_inference_steps=2,
                        seed=7, output_type="latent")[0].image
    if lat.shape != (r // 8, r // 8, bundle.latent_channels) \
            or not np.isfinite(lat).all():
        raise AssertionError(f"bad SD3 latents {lat.shape}")
    time_sd3_stages(pipe, card)
    print(f"max_memory_allocated {peak / 2**30:.2f} GiB (SD3 dense) [{card}]")
    return got


def serve_sd3_mixed(card: str, bundle: ModelBundle) -> int:
    """SD3 with the default configuration: one padded-token MMDiT forward
    per step for [512, 1024, 1024]; every attention launches the masked
    kernel."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd3", dtype="bfloat16", seed=0)
    config.engine.collect_data = True
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    if not (config.scheduler.use_mixed_resolution
            and config.scheduler.policy == "fcfs_mixed"):
        raise AssertionError("the default configuration is not the mixed path")
    prompts = ["a red fox in snow", "a harbor at night, long exposure",
               "a watercolor of a mountain lake"]
    n_attn = sd3_attentions(bundle)

    reset_counts()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, resolution=SD3_MIXED_REQUESTS,
                         num_inference_steps=STEPS, seed=99)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    masked = got["masked"]

    check_outputs(outs, SD3_MIXED_REQUESTS, card)
    log = pipe.engine.workers[0].schedule_log
    key = ";".join(f"{r}x{SD3_MIXED_REQUESTS.count(r)}"
                   for r in sorted(set(SD3_MIXED_REQUESTS)))
    batches = [e["resolutions"] for e in log if e["stage"] == "denoising"]
    if batches != [key] * STEPS:
        raise AssertionError(f"expected {STEPS} mixed DENOISING batches "
                             f"{key}, got {batches}")
    want = n_attn * STEPS
    print(f"SD3 mixed serving: {len(outs)} requests in {wall:.3f} s; "
          f"DENOISING batches {batches[0]} x {len(batches)}; masked flash "
          f"launches {masked} (expected >= {want}: {n_attn} attentions x "
          f"{STEPS} steps), all {got}")
    if masked < want:
        raise AssertionError("the SD3 mixed path did not go through the "
                             "masked kernel")
    check_decode_k6(got, "SD3 mixed serving")
    ctx = sd3_mixed_ctx(pipe.engine.workers[0].pipeline.device)
    step_gaps(log, key, f"SD3 mixed {key} token batch (CFG {ctx.token_mask.shape[0]} "
              f"rows of {ctx.token_mask.shape[1]} + {SD3_CTX} tokens)", card)
    peak = torch.cuda.max_memory_allocated()

    lat = pipe.generate(prompts, resolution=SD3_MIXED_REQUESTS,
                        num_inference_steps=2, seed=7, output_type="latent")
    for o, r in zip(lat, SD3_MIXED_REQUESTS):
        if o.image.shape != (r // 8, r // 8, bundle.latent_channels) \
                or not np.isfinite(o.image).all():
            raise AssertionError(f"bad SD3 mixed latents {o.image.shape}")
    print(f"max_memory_allocated {peak / 2**30:.2f} GiB (SD3 mixed) [{card}]")
    return got


# -- SD3.5-medium's caches (the span-skip deep cache and the token caches) ---

def sd3_steps_spy(pipe) -> list:
    """Record every token-path step of the SD3 pipeline ``pipe``: CUDA
    events around it, its realized deep mode and cache flags (from the
    trunk call), the kernel launches it made, the request ids of its batch
    and of every ``_sd3_state`` key after it, and the store's bytes.  The
    decode checks that the final latents are finite."""
    steps = []
    mixed, trunk, decode = pipe.denoise_step_mixed, pipe._trunk_fn, \
        pipe._decode_fn

    def step(reqs_by_res):
        before = read_counts()
        rec = {"start": torch.cuda.Event(enable_timing=True),
               "end": torch.cuda.Event(enable_timing=True),
               "ids": tuple(r.request_id for res in sorted(reqs_by_res)
                            for r in reqs_by_res[res]),
               "min_step": min(r.sampler_table.step for rs in
                               reqs_by_res.values() for r in rs)}
        steps.append(rec)
        rec["start"].record()
        mixed(reqs_by_res)
        rec["end"].record()
        after = read_counts()
        rec["launches"] = {k: after[k] - before[k] for k in after}
        rec["store_ids"] = {i for key in pipe._sd3_state for i in key[2]}
        rec["state_bytes"] = pipe._live_state_bytes()

    def trunk_fn(*args, **kw):
        steps[-1].update(mode=kw.get("deep_mode"),
                         sync=kw.get("compact_sync", False),
                         stale=kw.get("fine_kv_stale", False))
        return trunk(*args, **kw)

    def decode_fn(latents):
        if not torch.isfinite(latents).all():
            raise AssertionError("non-finite final latents")
        return decode(latents)

    pipe.denoise_step_mixed = step
    pipe._trunk_fn = trunk_fn
    pipe._decode_fn = decode_fn
    return steps


def sd3_step_ms(steps, key, label: str, card: str) -> dict:
    """Mean CUDA-event ms of the recorded steps grouped by ``key(rec)``."""
    torch.cuda.synchronize()
    by: dict = {}
    for rec in steps:
        by.setdefault(key(rec), []).append(rec["start"].elapsed_time(rec["end"]))
    for k, ms in sorted(by.items(), key=lambda kv: str(kv[0])):
        print(f"SD3 step {label}, {k}: {len(ms)} steps, mean {np.mean(ms):.2f} "
              f"ms (min {np.min(ms):.2f}, max {np.max(ms):.2f}; CUDA events) "
              f"[{card}]")
    return {k: float(np.mean(ms)) for k, ms in by.items()}


def check_sd3_launches(steps, bundle: ModelBundle, label: str, got: dict,
                       span=(0, 0)) -> None:
    """Every token-path step launches only the masked kernel, once per
    attention of the blocks it runs: all 37 on a full or gated step, those
    outside ``span`` (block 0's joint and dual attention under the
    preset's 1:24) on a shallow one.  The MMDiT has no GroupNorm: K6 runs
    only in the decodes, ``got`` (the run's launches) holding exactly
    theirs (a step's window is not checked for K6, since a decode on the
    decode thread may run inside it)."""
    for i, rec in enumerate(steps):
        want = {"k1": 0, "flash_mha": 0, "k4": 0, "k5": 0,
                "masked": sd3_attentions(bundle, span if rec["mode"] ==
                                         "shallow" else (0, 0))}
        if {k: rec["launches"][k] for k in want} != want:
            raise AssertionError(f"{label} step {i} ({rec['mode']}) launched "
                                 f"{rec['launches']}, not {want}")
    check_decode_k6(got, label)


def check_decode_k6(got: dict, label: str) -> None:
    """A run whose denoiser has no dense GroupNorm (the MMDiT, the patch
    batch) launched K6 exactly for its decodes."""
    if got["k6"] != decode_launches()["k6"]:
        raise AssertionError(f"{label}: K6 launches {got['k6']}, not the "
                             f"decodes' {decode_launches()['k6']}")


def check_sd3_deep_invariant(bundle: ModelBundle, card: str) -> None:
    """SD3.5-medium's ``apply_tokens`` at 2 x 1024^2 (CFG: 4 rows of 4096
    latent + 333 text tokens, bf16): the span-skip full pass against the
    plain forward, the shallow pass from its delta against the full one,
    and each token gate at fraction 1 (every row or token recomputed)
    against the plain forward."""
    tr = bundle.denoiser
    dev = next(tr.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            bundle.dtype)

    n = (SD3_INVARIANT_RES // 16) ** 2
    tokens = rand(4, n, tr.cfg.dim)
    mask = torch.ones(4, n, dtype=torch.bool, device=dev)
    t = torch.tensor([700.0, 300.0, 700.0, 300.0], device=dev)
    ehs, pooled = rand(4, SD3_CTX, tr.cfg.joint_attention_dim), \
        rand(4, tr.cfg.pooled_projection_dim)
    args = (tokens, mask, t, ehs, pooled)
    span = CacheConfig.production("sd3").sd3_deep_span

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    errs = {}
    with torch.inference_mode():
        plain = tr.apply_tokens(*args)
        full, deep = tr.apply_tokens(*args, deep_mode="full", deep_span=span)
        shallow, _ = tr.apply_tokens(*args, deep_mode="shallow",
                                     deep_span=span, deep_state=deep)
        errs["span full vs plain"] = (rel(full, plain), DEEP_FULL_MAX_REL)
        errs["span shallow vs full"] = (rel(shallow, full), PATCH_BOUND)
        delta = _state_nbytes(deep)
        del deep, full, shallow
        row_valid = torch.ones(4, dtype=torch.bool, device=dev)
        for name, kw in SD3_FULL_FRACTION.items():
            cc = CacheConfig(enabled=True, **kw)
            cache = BlockCache(cc)
            fine = cc.mode == "compact" and cc.patch_fraction < 1.0
            if fine:
                state = {k: cache.init_token_rows_fine(
                    k, 4, seq, dim, bundle.dtype, dev,
                    kv_pairs=(2 if int(k[5:]) in tr.cfg.dual_attention_layers
                              else 1) if cc.fine_stale_kv else 0)
                    for k, (seq, dim) in tr.token_cache_layout(n).items()}
            else:
                state = {k: cache.init_token_rows(
                    k, 4, seq, dim, bundle.dtype, dev,
                    ctx_seq=SD3_CTX if cc.mode == "compact" else None)
                    for k, (seq, dim) in tr.token_cache_layout(n).items()}
            # two steps: the anchoring (sync) one, then the steady one
            for step in range(2):
                out = tr.apply_tokens(
                    *args, cache=cache, cache_state=state, row_valid=row_valid,
                    compact_sync=cc.mode == "compact" and step == 0,
                    fine_kv_stale=cc.fine_stale_kv and step == 1)
                errs[f"{name} gate at fraction 1, step {step} vs plain"] = (
                    rel(out, plain), DEEP_FULL_MAX_REL)
            print(f"SD3 {name} cache rows at 2 x 1024^2: "
                  f"{_state_nbytes(state) / 1e9:.3f} GB [{card}]")
            del state, out
    print(f"SD3 span {span} delta at 2 x 1024^2 (CFG 4 rows): "
          f"{delta / 1e6:.1f} MB [{card}]")
    for name, (err, bnd) in errs.items():
        print(f"SD3 MMDiT {name}: max err / max |ref| {err:.3e} (bound "
              f"{bnd:.3e}) [{card}]")
        if not (np.isfinite(err) and err <= bnd):
            raise AssertionError(f"SD3 {name}: {err} > {bnd}")


def serve_sd3_span(card: str, bundle: ModelBundle) -> list:
    """4 x 1024^2 SD3.5-medium requests, 30 flow-match steps, under
    ``CacheConfig.production("sd3", serving=False)`` (span 1:24, interval
    30, warmup 3), then the same requests cache-off (the dense path)."""
    prompts = [f"a photograph of place {i}, golden hour" for i in range(4)]
    n_attn = sd3_attentions(bundle)
    runs, walls = [], {}
    for cache in (CacheConfig.production("sd3", serving=False), CacheConfig()):
        torch.cuda.reset_peak_memory_stats()
        config = default_config("sd3", dtype="bfloat16", seed=0)
        config.engine.collect_data = True
        config.cache = cache
        pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
        steps = sd3_steps_spy(pipe.engine.workers[0].pipeline)
        reset_counts()
        t0 = time.perf_counter()
        outs = pipe.generate(prompts, resolution=SD3_SPAN_REQUESTS,
                             num_inference_steps=SD3_SPAN_STEPS, seed=515)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        runs.append(got)
        check_outputs(outs, SD3_SPAN_REQUESTS, card)
        label = "on" if cache.enabled else "off"
        walls[label] = wall
        peak = torch.cuda.max_memory_allocated()
        print(f"SD3 4 x 1024^2, {SD3_SPAN_STEPS} steps, cache {label}: end to "
              f"end {wall:.3f} s, launches {got}, max_memory_allocated "
              f"{peak / 2**30:.2f} GiB [{card}]")
        if not cache.enabled:
            if steps or got["flash_mha"] != n_attn * SD3_SPAN_STEPS:
                raise AssertionError(f"SD3 cache-off run: {len(steps)} token "
                                     f"steps, launches {got}")
            continue
        modes = [rec["mode"] for rec in steps]
        want = ["full"] * cache.deep_warmup + ["shallow"] * (
            SD3_SPAN_STEPS - cache.deep_warmup)
        if modes != want:
            raise AssertionError(f"SD3 span modes {modes} != {want}")
        check_sd3_launches(steps, bundle, "SD3 span offline", got,
                           cache.sd3_deep_span)
        ms = sd3_step_ms(steps, lambda r: r["mode"], "4 x 1024^2 span 1:24",
                         card)
        print(f"SD3 span shallow/full step ratio {ms['shallow'] / ms['full']:.4f}"
              f"; delta bytes {max(r['state_bytes'] for r in steps) / 1e6:.1f}"
              f" MB [{card}]")
    print(f"SD3 4 x 1024^2 end to end: span cache {walls['on']:.3f} s vs "
          f"cache-off {walls['off']:.3f} s ({walls['off'] / walls['on']:.2f}x) "
          f"[{card}]")
    return runs


def expected_sd3_modes(steps, interval: int, warmup: int) -> list:
    """The span cache's modes for the recorded batches: full while a
    composition has no delta (its first step), at the interval and in any
    request's warmup (pipelines/sd3.py ``_sd3_deep_mode``)."""
    out, ids, age = [], None, 0
    for rec in steps:
        full = (rec["ids"] != ids or age >= interval - 1
                or rec["min_step"] < warmup)
        ids = rec["ids"]
        age = 0 if full else age + 1
        out.append("full" if full else "shallow")
    return out


def serve_sd3_span_serving(card: str, bundle: ModelBundle) -> dict:
    """``production("sd3", serving=True)`` under ``fcfs_mixed``: 512^2 x 12
    steps and 2 x 1024^2 x 20 in one padded-token batch, and a fourth
    1024^2 request (8 steps) added once they have taken 4 steps; FCFS runs
    a batch to completion, so it is served after them.  When the 512^2
    request leaves, the two 1024^2 requests form a new composition, whose
    first step is full (past every warmup): exactly one extra full step."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd3", dtype="bfloat16", seed=0)
    config.engine.collect_data = True
    config.cache = CacheConfig.production("sd3", serving=True)
    cc = config.cache
    engine = DiffusionPipeline(config=config, device="cuda",
                               bundle=bundle).engine
    pipe = engine.workers[0].pipeline
    steps = sd3_steps_spy(pipe)

    def add(i, res, n):
        return engine.add_request(f"sd3-serve-{i}", SamplingParams(
            prompt=f"a serving prompt {i}", resolution=res,
            num_inference_steps=n, seed=40 + i))

    reset_counts()
    t0 = time.perf_counter()
    reqs = [add(i, res, n) for i, (res, n) in enumerate(SD3_SERVE_FIRST)]
    outs = []
    while engine.has_unfinished_requests():
        if len(reqs) == 3 and reqs[0].sampler_table is not None \
                and reqs[0].sampler_table.step >= SD3_SERVE_ADMIT:
            reqs.append(add(3, *SD3_SERVE_LATE))
        outs.extend(engine.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    outs.sort(key=lambda o: o.request_id)
    check_outputs(outs, [r for r, _ in SD3_SERVE_FIRST] + [SD3_SERVE_LATE[0]],
                  card)
    modes = [rec["mode"] for rec in steps]
    want = expected_sd3_modes(steps, cc.deep_interval, cc.deep_warmup)
    comps = list(dict.fromkeys(rec["ids"] for rec in steps))
    print(f"SD3 span serving: {len(outs)} requests in {wall:.3f} s; "
          f"compositions {comps}; modes {modes}; launches {got} [{card}]")
    if modes != want:
        raise AssertionError(f"SD3 serving modes {modes} != {want}")
    # the 1024^2 pair after the 512^2 request left: past warmup, so its one
    # full step is the composition reset's
    pair = [rec for rec in steps if rec["ids"] == comps[1]]
    if len(comps) != 3 or [r["mode"] for r in pair].count("full") != 1 \
            or pair[0]["mode"] != "full" or pair[0]["min_step"] < cc.deep_warmup:
        raise AssertionError(f"composition reset: {comps}, "
                             f"{[r['mode'] for r in pair]}")
    for rec in steps:
        if not rec["store_ids"] <= set(rec["ids"]):
            raise AssertionError(f"a finished request's SD3 state is still "
                                 f"held: {rec['store_ids']} after {rec['ids']}")
    if pipe._sd3_state:
        raise AssertionError(f"SD3 state left after serving: "
                             f"{list(pipe._sd3_state)}")
    check_sd3_launches(steps, bundle, "SD3 span serving", got,
                       cc.sd3_deep_span)
    sd3_step_ms(steps, lambda r: (len(r["ids"]), r["mode"]),
                "serving (batch size, mode)", card)
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (SD3 span serving) [{card}]")
    return got


def serve_sd3_token_caches(card: str, bundle: ModelBundle) -> list:
    """2 x 1024^2, 8 steps, under each token cache mode (a uniform batch
    takes the token path): images, finite latents, the trunk flags each
    step ran with, 37 masked launches a step and the step ms."""
    runs = []
    for name, kw in SD3_TOKEN_MODES.items():
        torch.cuda.reset_peak_memory_stats()
        config = default_config("sd3", dtype="bfloat16", seed=0)
        config.cache = CacheConfig(enabled=True, **kw)
        pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
        steps = sd3_steps_spy(pipe.engine.workers[0].pipeline)
        reset_counts()
        t0 = time.perf_counter()
        outs = pipe.generate([f"a token cache prompt {i}" for i in range(2)],
                             resolution=[1024, 1024],
                             num_inference_steps=SD3_TOKEN_STEPS, seed=77)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        runs.append(got)
        check_outputs(outs, [1024, 1024], card)
        flags = [("sync" if r["sync"] else "stale" if r["stale"] else "gated")
                 for r in steps]
        first = "sync" if config.cache.mode == "compact" and \
            config.cache.patch_fraction >= 1.0 else "gated"
        rest = "stale" if config.cache.fine_stale_kv else "gated"
        if flags != [first] + [rest] * (SD3_TOKEN_STEPS - 1):
            raise AssertionError(f"SD3 {name} steps {flags}")
        check_sd3_launches(steps, bundle, f"SD3 {name}", got)
        ms = sd3_step_ms(steps, lambda r: "sync" if r["sync"] else
                         "stale" if r["stale"] else "gated",
                         f"2 x 1024^2 {name}", card)
        print(f"SD3 2 x 1024^2 {name}: {wall:.3f} s end to end, state "
              f"{max(r['state_bytes'] for r in steps) / 1e9:.3f} GB, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, step ms "
              f"{ms} [{card}]")
    return runs


def check_masked_fine(card: str) -> dict:
    """The masked kernel at the fine token gate's shapes (fewer queries
    than keys) against its plain version, timed beside it, masked SDPA and
    its bound; the ragged cases (``Lq`` off the query tile, a shorter
    request, a pad row) are checked untimed."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst, times = 0.0, {}
    for shape in FINE_MASKED_SHAPES:
        b, lq, lk, d, h, kind = shape
        ctx = SD3_CTX if kind.startswith("joint") else 0
        q = torch.randn(b, lq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        mask = torch.ones(b, lk, dtype=torch.bool, device="cuda")
        if kind.endswith("ragged"):
            s_pad = lk - ctx
            mask[0, s_pad // 4:s_pad] = False   # a 512^2 request's pad keys
            mask[2, :s_pad] = False             # a bucket pad row
        scale = 1.0 / np.sqrt(d // h)
        out = flash_mha_masked(q, k, v, mask, h, scale)
        ref = flash_mha_masked_reference(q, k, v, mask, h, scale)
        torch.cuda.synchronize()
        live = mask.any(dim=1)
        if not torch.isfinite(out).all() or not (out[~live] == 0).all():
            raise AssertionError(f"masked flash at {shape}: non-finite or a "
                                 f"row with no valid key not zero")
        err, max_rel, rms_rel = k1_errors(out[live], ref[live])
        print(f"masked flash fine-gate {shape}: max_abs_err {err:.3e}, / "
              f"max|plain| {max_rel:.3e} (bound {K1_MAX_REL:.3e}), rel RMS "
              f"{rms_rel:.3e} (bound {K1_RMS_REL:.0e})")
        if not (max_rel <= K1_MAX_REL and rms_rel <= K1_RMS_REL):
            raise AssertionError(f"masked flash disagrees with its plain "
                                 f"version at {shape}: {max_rel}, {rms_rel}")
        worst = max(worst, err)
        if kind.endswith("ragged"):
            continue
        p1 = cuda_ms(lambda: flash_mha_masked_reference(q, k, v, mask, h,
                                                        scale), 3)
        k1 = cuda_ms(lambda: flash_mha_masked(q, k, v, mask, h, scale), 10)
        k2 = cuda_ms(lambda: flash_mha_masked(q, k, v, mask, h, scale), 10)
        p2 = cuda_ms(lambda: flash_mha_masked_reference(q, k, v, mask, h,
                                                        scale), 3)
        lib = cuda_ms(lambda: sdpa(q, k, v, h, scale, mask), 10)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        flops = 4.0 * d * lq * mask.sum().item()
        bms, by = bound(flops, 2.0 * (2 * q.numel() + 2 * k.numel())
                        + mask.numel())
        print(f"masked time fine-gate {shape}: kernel {kms:.4f} ms "
              f"({flops / kms / 1e9:.1f} TFLOP/s), plain {pms:.4f} ms, sdpa "
              f"{lib:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")
        times[shape] = {"ms": kms, "plain_ms": pms, "library_ms": lib,
                        "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": worst, "times": times}


def serve_sd3_deep(card: str, bundle: ModelBundle) -> list:
    """The phase of SD3.5-medium's caches, with its bundle loaded."""
    t0 = time.perf_counter()
    check_sd3_deep_invariant(bundle, card)
    runs = serve_sd3_span(card, bundle)
    runs.append(serve_sd3_span_serving(card, bundle))
    runs += serve_sd3_token_caches(card, bundle)
    print(f"serve_sd3_deep: {time.perf_counter() - t0:.1f} s")
    return runs


def sd15_self_attention_keys(cfg, res: int) -> list:
    """Key count of every self-attention of one dense UNet forward at
    ``res``^2: each transformer block attends over its level's latent
    cells (down and up blocks of the levels with attention, the mid block
    at the deepest level)."""
    n_levels = len(cfg.block_out_channels)
    keys = []
    for lvl in range(n_levels):
        if cfg.down_block_has_attn[lvl]:
            per_level = (2 * cfg.layers_per_block + 1) * cfg.transformer_layers[lvl]
            keys += [((res // 8) >> lvl) ** 2] * per_level
    mid = max(cfg.transformer_layers[-1], 1)
    return keys + [((res // 8) >> (n_levels - 1)) ** 2] * mid


def dense_norms(cfg, boundary=None) -> int:
    """The GroupNorms of one dense UNet forward, from the config: two a
    resnet and one a transformer (its ``norm``) on every level's down and
    up blocks (``layers_per_block`` and one more resnets), the mid block's
    two resnets and transformer, and ``conv_norm_out``; ``boundary``: a
    shallow forward, the levels below it and ``conv_norm_out`` only."""
    lpb = cfg.layers_per_block
    levels = range(len(cfg.block_out_channels) if boundary is None
                   else boundary)
    n = sum((2 * lpb + 1) * (2 + cfg.down_block_has_attn[lvl])
            for lvl in levels) + 1
    return n if boundary is not None else n + 2 * 2 + 1


def deep_launches(cfg, res: int, boundary: int = 1) -> dict:
    """K1, K5 and K6 launches of one dense deep step per mode at
    ``res``^2: a full or partial step runs every transformer (each
    self-attention over >= FLASH_MIN_KV keys on K1, a shorter one on K5,
    each text cross-attention on K5) and every GroupNorm (one K6 call
    each); a shallow step the levels < boundary (the gated pairs' one call
    each on the gathered rows) and ``conv_norm_out``."""
    keys = sd15_self_attention_keys(cfg, res)
    spine = []
    for lvl in range(boundary):
        if cfg.down_block_has_attn[lvl]:
            spine += [((res // 8) >> lvl) ** 2] * (
                (2 * cfg.layers_per_block + 1) * cfg.transformer_layers[lvl])

    def count(ks, norms):
        return {"k1": sum(k >= FLASH_MIN_KV for k in ks),
                "k5": len(ks) + sum(k < FLASH_MIN_KV for k in ks),
                "k6": norms}

    full = count(keys, dense_norms(cfg))
    return {"full": full, "partial": full,
            "shallow": count(spine, dense_norms(cfg, boundary))}


def spy_deep(pipe) -> list:
    """Record every deep step of ``pipe``: a dense group step (path
    "dense", its resolution) or a mixed step (path "mixed", its resolution
    classes; mode "off" with the cache off), its mode (from the deep step
    call), CUDA events around the whole step, the bytes of the hybrid's row
    caches after it and, on the device, the largest hit count in them.
    Also checks that the final latents entering the VAE decode are finite
    (the uint8 cast would hide NaN)."""
    steps = []
    group, step, decode = (pipe._denoise_group_deep, pipe._deep_step,
                           pipe._decode_fn)
    mixed, mixed_step = pipe.denoise_step_mixed, pipe._deep_step_mixed

    def deep_step(mode, *args):
        steps[-1]["mode"] = mode
        return step(mode, *args)

    def deep_step_mixed(mode, *args):
        steps[-1]["mode"] = mode
        return mixed_step(mode, *args)

    def timed(fn, rec, arg):
        rec.update(start=torch.cuda.Event(enable_timing=True),
                   end=torch.cuda.Event(enable_timing=True))
        steps.append(rec)
        rec["start"].record()
        out = fn(arg)
        rec["end"].record()
        rec["state_bytes"] = sum(_state_nbytes(e["state"])
                                 for e in pipe._comp_state.values())
        hits = [st["hits"].max() for e in pipe._comp_state.values()
                for st in e["state"].values()]
        rec["hits"] = torch.stack(hits).max() if hits else None
        return out

    def group_deep(reqs, *args):
        return timed(lambda r: group(r, *args),
                     {"path": "dense", "res": reqs[0].resolution}, reqs)

    def step_mixed(reqs_by_res):
        return timed(mixed, {"path": "mixed", "mode": "off",
                             "classes": len(reqs_by_res)}, reqs_by_res)

    def decode_fn(latents):
        if not torch.isfinite(latents).all():
            raise AssertionError("non-finite final latents")
        return decode(latents)

    pipe._denoise_group_deep = group_deep
    pipe._deep_step = deep_step
    pipe.denoise_step_mixed = step_mixed
    pipe._deep_step_mixed = deep_step_mixed
    pipe._decode_fn = decode_fn
    return steps


def mixed_launches(cfg, n_classes: int, boundary: int = 1) -> dict:
    """K4, masked and K5 launches of one patched step per deep mode ("off":
    cache off) over ``n_classes`` resolution classes: a full step runs
    every resnet (K4 before each of its two 3x3 convs, one more before
    conv_out) and every transformer (one masked self-attention per class,
    one K5 text cross-attention); a shallow step the levels < boundary, the
    gated pairs once each on the sub-composition, whose classes are the
    batch's (each keeps at least one image).  No K6: the patch batch
    normalises through K4 and its context's per-image moments."""
    n_levels, lpb = len(cfg.block_out_channels), cfg.layers_per_block

    def count(levels, mid):
        res = (2 * lpb + 1) * len(levels) + 2 * mid
        tr = sum((2 * lpb + 1) * cfg.transformer_layers[lvl] for lvl in levels
                 if cfg.down_block_has_attn[lvl])
        tr += mid * max(cfg.transformer_layers[-1], 1)
        return {"k1": 0, "flash_mha": 0, "masked": tr * n_classes,
                "k4": 2 * res + 1, "k5": tr, "k6": 0}

    full = count(range(n_levels), 1)
    return {"full": full, "off": full, "shallow": count(range(boundary), 0)}


def expected_launches(steps, cfg) -> dict:
    """The launches of every recorded deep step (``spy_deep``), each by its
    path and mode, and of the VAE decodes since :func:`reset_counts`."""
    want = decode_launches()
    for rec in steps:
        per = (mixed_launches(cfg, rec["classes"]) if rec["path"] == "mixed"
               else deep_launches(cfg, rec["res"]))[rec["mode"]]
        for k, n in per.items():
            want[k] += n
    return want


def report_deep(steps, label: str, card: str) -> dict:
    """Print each mode's step time (CUDA events around the group step)."""
    torch.cuda.synchronize()
    by_mode: dict = {}
    for rec in steps:
        by_mode.setdefault(rec["mode"], []).append(
            rec["start"].elapsed_time(rec["end"]))
    for mode, ms in sorted(by_mode.items()):
        print(f"deep step {label}, {mode}: {len(ms)} steps, mean "
              f"{np.mean(ms):.2f} ms (min {np.min(ms):.2f}, max "
              f"{np.max(ms):.2f}; CUDA events) [{card}]")
    return {mode: len(ms) for mode, ms in by_mode.items()}


def check_deep_invariant(bundle: ModelBundle, card: str) -> None:
    """One full-width SDXL UNet forward at 1024^2 (2 requests, CFG: 4 rows,
    bf16) in each deep mode at boundary 1 against the plain forward."""
    unet = bundle.denoiser
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    x = rand(4, 128, 128, 4)
    t = torch.tensor([700.0, 300.0, 700.0, 300.0], device="cuda")
    ehs = rand(4, 77, unet.cfg.cross_attention_dim)
    added = {"text_embeds": rand(4, unet.cfg.addition_embed[1]),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 4,
                                      device="cuda")}

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    with torch.inference_mode():
        args = (x, t, ehs)
        plain = unet(*args, added_cond=added)
        full, feat = unet(*args, added_cond=added, deep_mode="full",
                          deep_boundary=1)
        shallow, _ = unet(*args, added_cond=added, deep_mode="shallow",
                          deep_state=feat, deep_boundary=1)
        carry = torch.zeros_like(feat)
        part, _ = unet(*args, added_cond=added, deep_mode="partial",
                       deep_state=carry, deep_boundary=1,
                       deep_sel=torch.tensor([0], device="cuda"))
    errs = {"full vs plain": (rel(full, plain), DEEP_FULL_MAX_REL),
            "shallow vs full": (rel(shallow, full), PATCH_BOUND),
            "partial vs full, selected rows": (
                rel(part[[0, 2]], full[[0, 2]]), PATCH_BOUND),
            "partial feature vs full, selected rows": (
                rel(carry[[0, 2]], feat[[0, 2]]), PATCH_BOUND)}
    print(f"SDXL deep feature at 1024^2, boundary 1: {tuple(feat.shape)} "
          f"{feat.dtype} ({feat[:2].numel() * feat.element_size() / 1e6:.1f} "
          f"MB a request) [{card}]")
    for name, (err, bnd) in errs.items():
        print(f"SDXL UNet deep mode {name}: max err / max |ref| {err:.3e} "
              f"(bound {bnd:.3e}) [{card}]")
        if not (np.isfinite(err) and err <= bnd):
            raise AssertionError(f"deep mode {name}: {err} > {bnd}")
    if carry[[1, 3]].abs().max().item() != 0:
        raise AssertionError("partial wrote an unselected row's feature")


def serve_sdxl_deep(card: str, bundle: ModelBundle) -> list:
    """8 x 1024^2 SDXL requests, 30 Euler steps, guidance 5.0, under the
    bench's default trajectory (``CacheConfig.production("sdxl",
    serving=False)``), then the same requests cache-off."""
    prompts = [f"an image of scene {i}, detailed" for i in range(8)]
    runs = []
    for cache in (CacheConfig.production("sdxl", serving=False),
                  CacheConfig()):
        torch.cuda.reset_peak_memory_stats()
        config = default_config("sdxl", dtype="bfloat16", seed=0)
        config.scheduler.use_mixed_resolution = False
        config.engine.collect_data = True
        config.cache = cache
        pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
        steps = spy_deep(pipe.engine.workers[0].pipeline)
        reset_counts()
        t0 = time.perf_counter()
        outs = pipe.generate(prompts, resolution=DEEP_REQUESTS,
                             num_inference_steps=DEEP_STEPS,
                             guidance_scale=5.0, seed=2024)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        runs.append(got)
        check_outputs(outs, DEEP_REQUESTS, card)
        label = "on" if cache.enabled else "off"
        step_gaps(pipe.engine.workers[0].schedule_log,
                  f"{DEEP_REQUESTS[0]}x{len(DEEP_REQUESTS)}",
                  f"SDXL 8 x 1024^2 cache {label} (schedule log)", card)
        peak = torch.cuda.max_memory_allocated()
        print(f"SDXL 8 x 1024^2, {DEEP_STEPS} steps, cache {label}: "
              f"end to end {wall:.3f} s, launches {got}, "
              f"max_memory_allocated {peak / 2**30:.2f} GiB [{card}]")
        if not cache.enabled:
            continue
        modes = report_deep(steps, "SDXL 8 x 1024^2 (16 rows)", card)
        state = max(rec["state_bytes"] for rec in steps)
        print(f"SDXL hybrid row caches: {state / 1e9:.3f} GB at bucket 8 "
              f"[{card}]")
        per = deep_launches(bundle.denoiser.cfg, DEEP_REQUESTS[0])
        want = {k: sum(per[m][k] * n for m, n in modes.items())
                for k in ("k1", "k5", "k6")}
        want["k6"] += decode_launches()["k6"]
        print(f"deep modes {modes}; K1/K5/K6 expected {want}")
        if (modes.get("full", 0) < 1 or modes.get("shallow", 0) < 1
                or sum(modes.values()) != DEEP_STEPS):
            raise AssertionError(f"deep modes {modes}")
        if bundle.denoiser.cfg == unet_mod.SDXL_UNET and (
                per["full"] != {"k1": 70, "k5": 70, "k6": 46}
                or per["shallow"] != {"k1": 0, "k5": 0, "k6": 11}):
            raise AssertionError(f"SDXL launches per deep step {per}")
        if {k: got[k] for k in want} != want \
                or got["masked"] or got["k4"] or got["flash_mha"]:
            raise AssertionError(f"SDXL deep launches {got} != {want}")
    return runs


def serve_sd15_rowwarm(card: str, bundle: ModelBundle) -> dict:
    """``production("sd15", serving=True)`` (row-granular warmup) under
    ESyMReD, whose admissions join a running batch: two 512^2 requests,
    then a third added once they have taken 4 denoising steps, so that
    its warmup runs as partial steps.  A loose SLO keeps every request
    admitted: the phase checks the cache, not SLO attainment."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd15", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False
    config.scheduler.policy = "esymred"
    config.scheduler.slo_scale = 1e4
    config.engine.collect_data = True
    config.cache = CacheConfig.production("sd15", serving=True)
    engine = DiffusionPipeline(config=config, device="cuda",
                               bundle=bundle).engine
    steps = spy_deep(engine.workers[0].pipeline)

    def add(i):
        return engine.add_request(f"rowwarm-{i}", SamplingParams(
            prompt=f"a row warmup prompt {i}", resolution=DEEP_SD15_RES,
            num_inference_steps=DEEP_SD15_STEPS, seed=i))

    reset_counts()
    t0 = time.perf_counter()
    reqs, outs = [add(0), add(1)], []
    while engine.has_unfinished_requests():
        if len(reqs) == 2 and reqs[0].sampler_table is not None \
                and reqs[0].sampler_table.step >= 4:
            reqs.append(add(2))
        outs.extend(engine.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    outs.sort(key=lambda o: o.request_id)
    check_outputs(outs, [DEEP_SD15_RES] * 3, card)
    modes = report_deep(steps, f"SD-1.5 {DEEP_SD15_RES}^2 row warmup", card)
    per = deep_launches(bundle.denoiser.cfg, DEEP_SD15_RES)
    want = decode_launches()
    for mode, n in modes.items():
        for k in ("k1", "k5", "k6"):
            want[k] += per[mode][k] * n
    print(f"SD-1.5 row warmup: 3 requests in {wall:.3f} s; deep modes "
          f"{modes} (per step {per}); launches {got} (expected {want}); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if modes.get("partial", 0) < 1:
        raise AssertionError(f"no partial step: {modes}")
    if got != want:
        raise AssertionError(f"SD-1.5 row warmup launches {got} != {want}")
    return got


def check_mixed_deep_invariant(bundle: ModelBundle, card: str) -> None:
    """The SDXL UNet's deep modes on a 768^2 + 1024^2 patch batch (CFG:
    2 x 25 patches in a bucket of 64, bf16) against the plain patched
    forward, and the image gate on the card against the CPU."""
    unet = bundle.denoiser
    meta = mixed_meta("sdxl", [768, 1024])
    ctx = PatchContext(meta, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    n_img = meta.i_pad
    x = rand(meta.p_pad, meta.patch_cells, meta.patch_cells, 4)
    t = torch.tensor([700.0, 300.0] * (n_img // 2), device="cuda")
    ehs = rand(n_img, 77, unet.cfg.cross_attention_dim)
    sides = [768.0, 1024.0] + [1024.0] * (n_img // 2 - 2)
    added = {"text_embeds": rand(n_img, unet.cfg.addition_embed[1]),
             "time_ids": torch.tensor([[r, r, 0, 0, r, r] for r in sides * 2],
                                      device="cuda")}
    real = ctx.patch_valid
    cc = CacheConfig.production("sdxl", serving=False)
    cc.deep_compact_fraction = 1.0
    cache = BlockCache(cc)
    state = {k: cache.init_rows(k, meta.p_pad, side, ci, co, torch.bfloat16,
                                "cuda")
             for k, (side, ci, co) in unet.shallow_cache_layout(
                 meta.patch_cells, 1).items()}

    def rel(a, b):
        a, b = a[real].float(), b[real].float()
        return ((a - b).abs().max() / b.abs().max()).item()

    with torch.inference_mode():
        kw = dict(added_cond=added, ctx=ctx, deep_boundary=1)
        plain = unet(x, t, ehs, **kw)
        full, feat = unet(x, t, ehs, deep_mode="full", **kw)
        shallow, _ = unet(x, t, ehs, deep_mode="shallow", deep_state=feat,
                          **kw)
        hfull, hfeat, _ = unet(x, t, ehs, deep_mode="full", cache=cache,
                               cache_state=state, **kw)
        hshallow, _, _ = unet(x, t, ehs, deep_mode="shallow",
                              deep_state=hfeat, cache=cache,
                              cache_state=state, **kw)
    errs = {"full vs plain": (rel(full, plain), DEEP_FULL_MAX_REL),
            "shallow vs full": (rel(shallow, full), PATCH_BOUND),
            "hybrid full vs full": (rel(hfull, full), DEEP_FULL_MAX_REL),
            "hybrid shallow at fraction 1 vs shallow": (
                rel(hshallow, shallow), PATCH_BOUND)}
    print(f"SDXL patched deep feature, 768^2 + 1024^2 (CFG: {meta.p_pad} "
          f"patches, {meta.n_patches} real), boundary 1: "
          f"{tuple(feat.shape)} {feat.dtype} [{card}]")
    for name, (err, bnd) in errs.items():
        print(f"SDXL patched UNet deep mode {name}: max err / max |ref| "
              f"{err:.3e} (bound {bnd:.3e}) [{card}]")
        if not (np.isfinite(err) and err <= bnd):
            raise AssertionError(f"patched deep mode {name}: {err} > {bnd}")
    if not all((st["hits"][real] == 0).all() for st in state.values()):
        raise AssertionError("the hybrid at fraction 1 skipped an image")
    check_gate_card_vs_cpu(card)


def check_gate_card_vs_cpu(card: str) -> None:
    """``gate_compact_images`` on SDXL's serving mix (768^2 + 3 x 1024^2,
    doubled: 128 patch rows of 64 channels at 32^2, production fraction
    0.3) on the card and on the CPU with the same rows and state: the same
    patches and images, the same output and hits.  Per-image drifts are
    spread apart; the uncond half of one image is forced (hits at the
    cap), so that no two images tie."""
    meta = mixed_meta()
    gen = torch.Generator().manual_seed(6)
    side = meta.patch_cells
    x = torch.randn(meta.p_pad, 64, side, side, generator=gen).to(
        torch.bfloat16)
    scale = 0.05 * (1 + torch.from_numpy(meta.image_id).float()) ** 1.5
    inp = (x.float() + scale.reshape(-1, 1, 1, 1) * torch.randn(
        x.shape, generator=gen)).to(torch.bfloat16)
    cc = CacheConfig.production("sdxl", serving=False)
    hits = torch.randint(0, cc.max_hits, (meta.p_pad,), generator=gen,
                         dtype=torch.int32)
    hits[torch.from_numpy(meta.image_id == 1)] = cc.max_hits  # one pair
    t_norm = torch.rand(meta.p_pad, generator=gen)
    runs = {}
    for dev in ("cuda", "cpu"):
        ctx = PatchContext(meta, dev)
        sub_ctx, caps = compact_context(side, meta.class_info,
                                        cc.deep_compact_fraction, True,
                                        ctx.image_id.device)
        st = {"inp": inp.to(dev), "out": torch.zeros_like(inp, device=dev),
              "hits": hits.to(dev)}
        y, st, stats = BlockCache(cc).gate_compact_images(
            "up2.0", x.to(dev), t_norm.to(dev), st,
            lambda x_s, gidx, imgs: x_s, ctx, caps,
            cfg_pair_offset=meta.i_pad // 2, two_level=False)
        runs[dev] = [a.cpu() for a in (stats["gather"], stats["images"], y,
                                       st["hits"], st["inp"])]
    names = ("gathered patches", "images", "output", "hits", "state inputs")
    for name, a, b in zip(names, runs["cuda"], runs["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"image gate on the card vs the CPU: the "
                                 f"{name} differ")
    print(f"image gate, SDXL serving mix: card and CPU select images "
          f"{runs['cuda'][1].tolist()} (sub-batch of "
          f"{runs['cuda'][0].numel()} patches, caps {caps}) [{card}]")


def serve_sdxl_mixed_deep(card: str, bundle: ModelBundle) -> list:
    """SDXL's serving mix (768^2 + 3 x 1024^2, one mixed batch a step) in
    the default configuration under ``production("sdxl", serving=True)``
    and ``serving=False``, then cache-off: modes, step ms per mode (CUDA
    events), end to end seconds, peak memory, the row-cache bytes and the
    exact launches per realized mode."""
    prompts = ["a red fox in snow", "a harbor at night, long exposure",
               "a watercolor of a mountain lake", "a robot reading a book"]
    cfg = bundle.denoiser.cfg
    runs = []
    for label, cache in (
            ("serving", CacheConfig.production("sdxl", serving=True)),
            ("offline", CacheConfig.production("sdxl", serving=False)),
            ("off", CacheConfig())):
        torch.cuda.reset_peak_memory_stats()
        config = default_config("sdxl", dtype="bfloat16", seed=0)
        config.cache = cache
        pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
        steps = spy_deep(pipe.engine.workers[0].pipeline)
        reset_counts()
        t0 = time.perf_counter()
        outs = pipe.generate(prompts, resolution=MIXED_REQUESTS,
                             num_inference_steps=MIXED_DEEP_STEPS,
                             guidance_scale=5.0, seed=77)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        runs.append(got)
        check_outputs(outs, MIXED_REQUESTS, card)
        if len(steps) != MIXED_DEEP_STEPS or any(r["path"] != "mixed"
                                                 for r in steps):
            raise AssertionError(f"expected {MIXED_DEEP_STEPS} mixed steps, "
                                 f"got {[r['path'] for r in steps]}")
        modes = report_deep(steps, f"SDXL mixed 768^2 + 3 x 1024^2, cache "
                                   f"{label}", card)
        want = expected_launches(steps, cfg)
        state = max(rec["state_bytes"] for rec in steps)
        print(f"SDXL mixed deep ({label}): {MIXED_DEEP_STEPS} steps, modes "
              f"{modes}, end to end {wall:.3f} s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, row "
              f"caches {state / 1e9:.3f} GB; launches {got} (expected "
              f"{want}; per step {mixed_launches(cfg, 2)}) [{card}]")
        if cache.enabled and (modes.get("full", 0) < 1
                              or modes.get("shallow", 0) < 1):
            raise AssertionError(f"SDXL mixed deep modes {modes}")
        if got != want:
            raise AssertionError(f"SDXL mixed launches {got} != {want}")
    return runs


# -- the UNet families' block and compact caches ------------------------------

def compact_sub_meta():
    """Mode "compact"'s sub-composition of SDXL's serving mix (its doubled
    meta) at COMPACT_FRACTION (non-even capacities)."""
    meta = mixed_meta("sdxl", MIXED_REQUESTS)
    return patching.compact_submeta(meta.patch_cells, meta.class_info,
                                    COMPACT_FRACTION, False)[0]


def spy_cache_steps(pipe) -> list:
    """Record every denoise step of ``pipe``: a mixed step (path "mixed",
    its resolution classes, mode "step") or a dense group step (path
    "dense"; mode "sync" or "gated" for a compact step, else "off"), CUDA
    events around it, and in mode "block" the gates' fresh share over the
    real patch rows and the largest hit count of the requests' rows (both
    on the device, read after the run).  Also checks that the final
    latents entering the VAE decode are finite."""
    steps = []
    mixed, group, plain, decode = (pipe.denoise_step_mixed,
                                   pipe._denoise_group_compact,
                                   pipe._denoise_fn, pipe._decode_fn)
    cache = pipe._block_cache()
    valid = [None]
    if cache is not None and pipe.config.cache.mode == "block":
        gate = cache.gate

        def spy_gate(key, x, t_norm, state_k, fn, **kw):
            y, st, stats = gate(key, x, t_norm, state_k, fn, **kw)
            v = valid[0]
            steps[-1]["fresh"].append((stats["fresh"] & v).sum() / v.sum())
            return y, st, stats

        cache.gate = spy_gate

    def timed(fn, rec, *args):
        rec.update(start=torch.cuda.Event(enable_timing=True),
                   end=torch.cuda.Event(enable_timing=True), fresh=[])
        steps.append(rec)
        rec["start"].record()
        out = fn(*args)
        rec["end"].record()
        return out

    def step_mixed(reqs_by_res):
        ordered = [r for res in sorted(reqs_by_res) for r in reqs_by_res[res]]
        sc = pipe.config.scheduler
        cells = sc.patch_size // 8
        meta2 = patching.double_meta(
            tuple(r.resolution // 8 // cells for r in ordered), cells,
            tuple(sc.patch_buckets), tuple(sc.batch_buckets))
        valid[0] = torch.from_numpy(
            meta2.kv_mask.reshape(-1)[meta2.patch_pos]).cuda()
        out = timed(mixed, {"path": "mixed", "mode": "step",
                            "classes": len(reqs_by_res)}, reqs_by_res)
        rows = [v["hits"].max() for r in ordered
                for v in (r.cache_rows or {}).values()]
        steps[-1]["hits"] = torch.stack(rows).max() if rows else None
        return out

    def group_compact(reqs, *args):
        ids = tuple(r.request_id for r in reqs)
        sync = not any(e["anchored"] for k, e in pipe._comp_state.items()
                       if k[0] == "unet_compact" and k[3] == ids)
        return timed(group, {"path": "dense", "res": reqs[0].resolution,
                             "mode": "sync" if sync else "gated"}, reqs, *args)

    def plain_fn(latents, *args):
        return timed(plain, {"path": "dense", "res": 8 * latents.shape[1],
                             "mode": "off"}, latents, *args)

    def decode_fn(latents):
        if not torch.isfinite(latents).all():
            raise AssertionError("non-finite final latents")
        return decode(latents)

    pipe.denoise_step_mixed = step_mixed
    pipe._denoise_group_compact = group_compact
    pipe._denoise_fn = plain_fn
    pipe._decode_fn = decode_fn
    return steps


def spy_rows(module, name: str, rows: list) -> callable:
    """Record the batch rows of every call of ``module.<name>`` (the
    attention dispatcher's kernel entry); returns the undo."""
    real = getattr(module, name)

    def spy(q, *args, **kw):
        rows.append(q.shape[0])
        return real(q, *args, **kw)

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def serve_cache_run(card: str, bundle: ModelBundle, cache: CacheConfig,
                    resolutions, steps, output_type="latent", mixed=True):
    """Serve ``resolutions`` (``steps`` a request) through the engine under
    ``cache``; returns (outputs in request order, recorded steps, launches,
    end to end seconds)."""
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = mixed
    config.cache = cache
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    rec = spy_cache_steps(pipe.engine.workers[0].pipeline)
    engine = pipe.engine
    prompts = ["a red fox in snow", "a harbor at night, long exposure",
               "a watercolor of a mountain lake", "a robot reading a book"]
    reset_counts()
    t0 = time.perf_counter()
    for i, (res, n) in enumerate(zip(resolutions, steps)):
        engine.add_request(f"c{i}", SamplingParams(
            prompt=prompts[i % len(prompts)], negative_prompt="blurry",
            resolution=res, num_inference_steps=n, guidance_scale=5.0,
            seed=77 + i, output_type=output_type))
    outs = []
    while engine.has_unfinished_requests():
        outs += engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    outs.sort(key=lambda o: int(o.request_id[1:]))
    return outs, rec, got, wall


def cache_launches(rec, cfg) -> dict:
    """The launches the recorded steps make, each as a cache-off step of
    its path (a gated pair runs its body once, on whatever rows), and the
    VAE decodes' since :func:`reset_counts`."""
    want = decode_launches()
    for r in rec:
        per = (mixed_launches(cfg, r["classes"])["off"] if r["path"] == "mixed"
               else deep_launches(cfg, r["res"])["full"])
        for k, n in per.items():
            want[k] += n
    return want


def step_ms(rec, label: str, card: str) -> dict:
    """Mean ms per mode of the recorded steps (CUDA events), printed."""
    torch.cuda.synchronize()
    by_mode: dict = {}
    for r in rec:
        by_mode.setdefault(r["mode"], []).append(
            r["start"].elapsed_time(r["end"]))
    out = {}
    for mode, ms in sorted(by_mode.items()):
        out[mode] = float(np.mean(ms))
        print(f"cache step {label}, {mode}: {len(ms)} steps, mean "
              f"{out[mode]:.2f} ms (min {np.min(ms):.2f}, max "
              f"{np.max(ms):.2f}; CUDA events) [{card}]")
    return out


def latents_close(got, want, label: str, card: str) -> None:
    """Final latents within CACHE_MAX_REL of max |want|; prints whether
    they are bitwise equal."""
    errs = [float(np.abs(g.image.astype(np.float32)
                         - w.image.astype(np.float32)).max()
                  / np.abs(w.image.astype(np.float32)).max())
            for g, w in zip(got, want)]
    same = all(np.array_equal(g.image, w.image) for g, w in zip(got, want))
    print(f"{label} vs cache-off: max err / max |off| per request "
          f"{[f'{e:.3e}' for e in errs]} (bound {CACHE_MAX_REL:.3e}); "
          f"bitwise equal: {same} [{card}]")
    if not all(np.isfinite(e) and e <= CACHE_MAX_REL for e in errs):
        raise AssertionError(f"{label} disagrees with cache-off: {errs}")


def serve_sdxl_block(card: str, bundle: ModelBundle) -> tuple:
    """Mode "block" on SDXL's serving mix (768^2 + 3 x 1024^2, STEPS
    steps, one mixed batch a step): at threshold -1 every row recomputes,
    so the latents equal cache-off's; then the committed classifiers with
    one 1024^2 request leaving after CACHE_SHORT_STEPS steps (the rows
    follow the change): fresh share per step, hits within ``max_hits``,
    uint8 images.  Launches per step equal cache-off's in every run.
    Returns (launches of each run, cache-off latents, cache-off step
    ms)."""
    t0 = time.perf_counter()
    cfg = bundle.denoiser.cfg
    n = len(MIXED_REQUESTS)
    runs, result = [], {}
    for label, cache in (("off", CacheConfig()),
                         ("block at threshold -1",
                          CacheConfig(enabled=True, mse_threshold=-1.0))):
        outs, rec, got, wall = serve_cache_run(card, bundle, cache,
                                               MIXED_REQUESTS, [STEPS] * n)
        want = cache_launches(rec, cfg)
        ms = step_ms(rec, f"SDXL mixed {label}", card)
        print(f"SDXL mixed, cache {label}: {len(rec)} steps in {wall:.3f} s, "
              f"launches {got} (expected {want}) [{card}]")
        if got != want or len(rec) != STEPS:
            raise AssertionError(f"SDXL {label} launches {got} != {want}")
        if cache.enabled and min(float(f) for r in rec
                                 for f in r["fresh"]) < 1.0:
            raise AssertionError("threshold -1 reused a row")
        runs.append(got)
        result[label] = (outs, ms)
    latents_close(result["block at threshold -1"][0], result["off"][0],
                  "SDXL mixed block at threshold -1", card)

    cache = CacheConfig(enabled=True, classifier_path=SDXL_CLASSIFIERS)
    steps = [STEPS] * (n - 1) + [CACHE_SHORT_STEPS]
    outs, rec, got, wall = serve_cache_run(card, bundle, cache,
                                           MIXED_REQUESTS, steps, "np")
    check_outputs(outs, MIXED_REQUESTS, card)
    want = cache_launches(rec, cfg)
    ms = step_ms(rec, "SDXL mixed block, classifiers", card)
    fresh = [round(float(torch.stack(r["fresh"]).mean()), 4) for r in rec
             if r["fresh"]]
    hits = max(int(r["hits"]) for r in rec if r.get("hits") is not None)
    print(f"SDXL mixed block with {SDXL_CLASSIFIERS}: requests {steps} steps, "
          f"{len(rec)} mixed steps ({[r['classes'] for r in rec]} classes) "
          f"in {wall:.3f} s; fresh share of the real rows per step {fresh}; "
          f"max hits {hits} (max_hits {cache.max_hits}); launches {got} "
          f"(expected {want}) [{card}]")
    if (got != want or hits > cache.max_hits or len(rec) != STEPS
            or len(fresh) != STEPS):
        raise AssertionError(f"SDXL block with classifiers: launches {got} "
                             f"vs {want}, hits {hits}, {len(rec)} steps")
    runs.append(got)
    print(f"serve_sdxl_block phase {time.perf_counter() - t0:.1f} s [{card}]")
    return runs, result["off"][0], result["off"][1]


def serve_sdxl_compact(card: str, bundle: ModelBundle, off_latents,
                       off_ms) -> list:
    """Mode "compact": 4 x 1024^2 on the dense path at COMPACT_FRACTION (a
    sync step at full capacity, then 4 of 8 CFG rows a gated pair), its
    cache-off run and the same at fraction 1 (equal to cache-off); SDXL's
    serving mix at COMPACT_FRACTION with ``patch_fraction`` 1.0 and 0.5
    (two-level rows), and at fraction 1 against the mix's cache-off
    latents.  Step ms per mode from CUDA events, K1's rows a launch on the
    dense path and K5's under two-level rows; launches per step equal
    cache-off's."""
    t0 = time.perf_counter()
    cfg = bundle.denoiser.cfg
    runs, dense = [], {}
    nd = len(COMPACT_DENSE)
    for label, cache in (
            ("off", CacheConfig()),
            (f"compact {COMPACT_FRACTION}",
             CacheConfig(enabled=True, mode="compact",
                         compact_fraction=COMPACT_FRACTION)),
            ("compact 1.0", CacheConfig(enabled=True, mode="compact",
                                        compact_fraction=1.0))):
        k1_rows = []
        undo = spy_rows(attention_mod, "flash_mha_fused", k1_rows)
        try:
            outs, rec, got, wall = serve_cache_run(
                card, bundle, cache, COMPACT_DENSE, [STEPS] * nd, mixed=False)
        finally:
            undo()
        want = cache_launches(rec, cfg)
        ms = step_ms(rec, f"SDXL dense 4 x 1024^2 {label}", card)
        per_launch = collections.Counter(k1_rows)
        print(f"SDXL dense 4 x 1024^2, cache {label}: modes "
              f"{[r['mode'] for r in rec]} in {wall:.3f} s; K1 rows a launch "
              f"{dict(per_launch)}; launches {got} (expected {want}) [{card}]")
        if got != want or len(rec) != STEPS:
            raise AssertionError(f"dense {label} launches {got} != {want}")
        if label == f"compact {COMPACT_FRACTION}":
            gated = int(2 * nd * COMPACT_FRACTION)
            n_k1 = deep_launches(cfg, 1024)["full"]["k1"]
            if (per_launch != {2 * nd: n_k1, gated: n_k1 * (STEPS - 1)}
                    or [r["mode"] for r in rec]
                    != ["sync"] + ["gated"] * (STEPS - 1)):
                raise AssertionError(f"dense compact rows {per_launch}")
            print(f"SDXL dense compact {COMPACT_FRACTION}: gated step "
                  f"{ms['gated']:.2f} ms = {ms['gated'] / dense['off'][1]['off']:.3f} "
                  f"x cache-off's {dense['off'][1]['off']:.2f} ms; sync step "
                  f"{ms['sync']:.2f} ms [{card}]")
        runs.append(got)
        dense[label] = (outs, ms)
    latents_close(dense["compact 1.0"][0], dense["off"][0],
                  "SDXL dense compact at fraction 1", card)

    n = len(MIXED_REQUESTS)
    k_q = max(1, round(compact_sub_meta().p_pad * 0.5))
    mixed = {}
    for label, cache in (
            ("compact 1.0", CacheConfig(enabled=True, mode="compact",
                                        compact_fraction=1.0)),
            (f"compact {COMPACT_FRACTION}",
             CacheConfig(enabled=True, mode="compact",
                         compact_fraction=COMPACT_FRACTION)),
            (f"compact {COMPACT_FRACTION} two-level 0.5",
             CacheConfig(enabled=True, mode="compact",
                         compact_fraction=COMPACT_FRACTION,
                         patch_fraction=0.5))):
        k5_rows = []
        undo = spy_rows(attention_mod, "flash_cross_short", k5_rows)
        try:
            outs, rec, got, wall = serve_cache_run(card, bundle, cache,
                                                   MIXED_REQUESTS,
                                                   [STEPS] * n)
        finally:
            undo()
        want = cache_launches(rec, cfg)
        ms = step_ms(rec, f"SDXL mixed {label}", card)
        print(f"SDXL mixed, cache {label}: {len(rec)} steps in {wall:.3f} s, "
              f"step {ms['step']:.2f} ms = {ms['step'] / off_ms['step']:.3f} x "
              f"cache-off's {off_ms['step']:.2f} ms; K5 rows a launch "
              f"{dict(collections.Counter(k5_rows))}; launches {got} "
              f"(expected {want}) [{card}]")
        if got != want or len(rec) != STEPS:
            raise AssertionError(f"mixed {label} launches {got} != {want}")
        if "two-level" in label and (k_q not in k5_rows or (
                cfg == unet_mod.SDXL_UNET and k_q != TWO_LEVEL_ROWS)):
            raise AssertionError(f"two-level K5 rows {set(k5_rows)}, k_q "
                                 f"{k_q} (checked at {TWO_LEVEL_ROWS})")
        if not all(np.isfinite(o.image).all() for o in outs):
            raise AssertionError(f"non-finite latents under {label}")
        runs.append(got)
        mixed[label] = (outs, ms["step"])
    latents_close(mixed["compact 1.0"][0], off_latents,
                  "SDXL mixed compact at fraction 1", card)
    one, two = (mixed[f"compact {COMPACT_FRACTION}"][1],
                mixed[f"compact {COMPACT_FRACTION} two-level 0.5"][1])
    print(f"SDXL mixed two-level 0.5 step {two:.2f} ms = {two / one:.3f} x "
          f"the one-level compact step {one:.2f} ms [{card}]")
    print(f"serve_sdxl_compact phase {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return runs


def train_classifiers(card: str, bundle: ModelBundle) -> list:
    """``cache.train.main`` in this process on the card: SDXL (its own
    random bf16 bundle from seed 0), TRAIN_STEPS steps at each of
    TRAIN_RES, one request a collection pass, into a temporary file: one
    (4,) classifier per gated pair of ``cache_layout``, every weight
    finite, and launches per traced step equal to cache-off's one-class
    mixed step; then a block-mode mixed step that loads them."""
    t0 = time.perf_counter()
    cfg = bundle.denoiser.cfg
    root = tempfile.mkdtemp(prefix="train_", dir="build")
    try:
        path = os.path.join(root, "classifiers.npz")
        reset_counts()
        fitted = cache_train.main(
            ["--family", "sdxl", "--steps", str(TRAIN_STEPS), "--resolutions"]
            + [str(r) for r in TRAIN_RES] + ["--out", path])
        torch.cuda.synchronize()
        got = read_counts()
        keys = set(bundle.denoiser.cache_layout(32, 1))
        loaded = np.load(path)
        want = {k: n * TRAIN_STEPS * len(TRAIN_RES)
                for k, n in mixed_launches(cfg, 1)["off"].items()}
        print(f"classifier training (SDXL, {TRAIN_STEPS} steps at "
              f"{TRAIN_RES}): {len(fitted)} blocks in "
              f"{time.perf_counter() - t0:.1f} s; launches {got} (expected "
              f"{want}); weights " + ", ".join(
                  f"{k} {np.round(loaded[k], 4).tolist()}"
                  for k in sorted(loaded.files)) + f" [{card}]")
        if (set(loaded.files) != keys
                or (cfg == unet_mod.SDXL_UNET and len(keys) != 11)
                or not all(loaded[k].shape == (4,)
                           and np.isfinite(loaded[k]).all() for k in keys)):
            raise AssertionError(f"fitted classifiers {loaded.files}")
        if got != want:
            raise AssertionError(f"training launches {got} != {want}")
        cache = CacheConfig(enabled=True, classifier_path=path)
        outs, rec, served, _ = serve_cache_run(card, bundle, cache,
                                               [768, 1024], [2, 2])
        if not all(np.isfinite(o.image).all() for o in outs) or len(rec) != 2:
            raise AssertionError("block step with the fitted classifiers")
        print(f"block mode with the fitted classifiers: {len(rec)} mixed "
              f"steps of 768^2 + 1024^2, finite latents, fresh share "
              f"{[round(float(torch.stack(r['fresh']).mean()), 4) for r in rec]}"
              f"; launches {served}; phase {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
    finally:
        shutil.rmtree(root)
    return [got, served]

def serve_api_cache(card: str) -> list:
    """The HTTP entry point under the UNet caches:
    ``python -m sduss_tpu_torch.entrypoints.api_server --model sdxl
    --use-cache [--cache-mode compact]``, its ``main`` on a thread of this
    process (its own random bf16 SDXL bundle from seed 0), a 768^2 and a
    1024^2 request (STEPS steps each) held until both have arrived, so
    that they denoise as one mixed batch: PNG answers of the right size,
    the mode's gate called on every step, then /clear closes the server.
    Returns each mode's launches."""
    made, runs = {}, []

    class Recorded(AsyncEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made["engine"] = self

    for mode in ("block", "compact"):
        t0 = time.perf_counter()
        made.clear()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        argv = ["--model", "sdxl", "--use-cache", "--cache-mode", mode,
                "--device", "cuda", "--host", "127.0.0.1", "--port",
                str(port)]
        server = threading.Thread(target=api_server.main, args=(argv,),
                                  name="api-server")
        api_server.AsyncEngine = Recorded
        reset_counts()
        try:
            server.start()
            wait_for(lambda: "engine" in made, "the async engine", 300)
            url = f"http://127.0.0.1:{port}"

            def up():
                try:
                    with urllib.request.urlopen(url + "/health", timeout=5):
                        return True
                except OSError:
                    return False

            wait_for(up, "the HTTP server", 300)
            aeng = made["engine"]
            calls = collections.Counter()
            cache = aeng.engine.workers[0].pipeline._block_cache()
            for name in ("gate", "gate_compact_images"):
                real = getattr(cache, name)

                def spy(*args, _real=real, _name=name, **kw):
                    calls[_name] += 1
                    return _real(*args, **kw)

                setattr(cache, name, spy)
            gate = threading.Event()
            aeng._executor.submit(gate.wait)
            answers, senders = {}, []
            for rid, res in (("a", 768), ("b", 1024)):
                def send(rid=rid, res=res):
                    answers[rid] = client.post_json(url + "/generate", {
                        "prompt": f"an HTTP request {rid}", "resolution": res,
                        "num_inference_steps": STEPS, "seed": ord(rid),
                        "request_id": rid, "guidance_scale": 5.0})
                senders.append(threading.Thread(target=send))
                senders[-1].start()
                wait_for(lambda rid=rid: rid in aeng._streams, f"{rid}'s "
                         f"arrival")
            gate.set()
            for th in senders:
                th.join(600)
            got = read_counts()
            cleared = client.post_json(url + "/clear", {})
            server.join(120)
        finally:
            api_server.AsyncEngine = AsyncEngine
        for rid, res in (("a", 768), ("b", 1024)):
            out = answers.get(rid, {})
            if not out.get("finished") or "error" in out:
                raise AssertionError(f"{mode}: request {rid}: {out}")
            img = client.decode_png(base64.b64decode(out["image_base64"]))
            if img.shape != (res, res, 3) or img.std() == 0:
                raise AssertionError(f"{mode}: bad PNG for {rid}")
        want = "gate" if mode == "block" else "gate_compact_images"
        n_gated = len(cache_layout_keys())
        print(f"api_server --use-cache --cache-mode {mode}: 768^2 + 1024^2 x "
              f"{STEPS} steps answered in {time.perf_counter() - t0:.1f} s "
              f"(server start included); gate calls {dict(calls)} "
              f"({n_gated} pairs a mixed step); launches {got}; /clear "
              f"{cleared} [{card}]")
        if (calls[want] != n_gated * STEPS or cleared != {"status": "cleared"}
                or server.is_alive()):
            raise AssertionError(f"api_server {mode}: gate calls {calls}, "
                                 f"/clear {cleared}")
        runs.append(got)
    return runs


def cache_layout_keys() -> list:
    """The gated pairs of SDXL's ``cache_layout`` at the default
    ``min_level``, on a 256-px patch."""
    with torch.device("meta"):
        unet = unet_mod.UNet2DConditionModel(unet_mod.SDXL_UNET)
    return list(unet.cache_layout(32, CacheConfig().min_level))

def serve_sd15_mixed_deep(card: str, bundle: ModelBundle) -> dict:
    """``production("sd15", serving=True)`` under ESyMReD: 4 x 512^2
    requests take dense deep steps, then a 768^2 request joins their batch,
    which turns mixed: the 512^2 requests' dense deep features force a full
    patched step, and on shallow steps the gate recomputes 1 of 4 512^2
    image pairs.  Modes per path, step ms per mode, exact launches."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd15", dtype="bfloat16", seed=0)
    config.scheduler.policy = "esymred"
    config.scheduler.slo_scale = 1e4
    config.cache = CacheConfig.production("sd15", serving=True)
    engine = DiffusionPipeline(config=config, device="cuda",
                               bundle=bundle).engine
    steps = spy_deep(engine.workers[0].pipeline)

    def add(i, res):
        return engine.add_request(f"mixdeep-{i}", SamplingParams(
            prompt=f"a mixed deep prompt {i}", resolution=res,
            num_inference_steps=DEEP_SD15_STEPS, seed=i))

    reset_counts()
    t0 = time.perf_counter()
    reqs = [add(i, r) for i, r in enumerate(MIXED_SD15_FIRST)]
    outs = []
    while engine.has_unfinished_requests():
        if len(reqs) == len(MIXED_SD15_FIRST) \
                and reqs[0].sampler_table is not None \
                and reqs[0].sampler_table.step >= MIXED_SD15_ADMIT:
            reqs.append(add(len(reqs), MIXED_SD15_LATE))
        outs.extend(engine.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    outs.sort(key=lambda o: o.request_id)
    check_outputs(outs, MIXED_SD15_FIRST + [MIXED_SD15_LATE], card)
    mixed = [r for r in steps if r["path"] == "mixed"]
    dense = [r for r in steps if r["path"] == "dense"]
    dmodes = report_deep(dense, "SD-1.5 dense (512^2 group, then 768^2 "
                                "alone)", card)
    mmodes = report_deep(mixed, "SD-1.5 mixed 4 x 512^2 + 768^2", card)
    want = expected_launches(steps, bundle.denoiser.cfg)
    hits = max((int(r["hits"]) for r in mixed if r["hits"] is not None),
               default=0)
    print(f"SD-1.5 mixed deep: 5 requests in {wall:.3f} s; dense modes "
          f"{dmodes}, mixed modes {mmodes} (first mixed step "
          f"{mixed[0]['mode'] if mixed else None}); largest row hit count "
          f"{hits}; launches {got} (expected {want}); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if not dense or not mixed or mixed[0]["mode"] != "full" \
            or "shallow" not in mmodes:
        raise AssertionError("no dense-to-patched flip with a full step "
                             "and shallow steps after it")
    if hits < 1:
        raise AssertionError("the image gate never skipped an image")
    if got != want:
        raise AssertionError(f"SD-1.5 mixed deep launches {got} != {want}")
    return got


def decode_bytes_per_pixel(pipe, res: int, n: int) -> float:
    """The transient of one decode group of ``n`` images at ``res``^2 on
    the card: ``max_memory_allocated`` during the decode less the memory
    allocated before it, over the group's pixels."""
    lat = torch.randn((n, res // 8, res // 8, pipe.bundle.latent_channels),
                      generator=torch.Generator("cuda").manual_seed(5),
                      device="cuda", dtype=pipe.bundle.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.inference_mode():
        pipe._decode_fn(lat).cpu()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / (n * res * res)


def wait_for(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def serve_http(card: str, bundle: ModelBundle) -> dict:
    """The port served over HTTP (``entrypoints/api_server.py``) in the
    serving configuration: SDXL, ``production("sdxl", serving=True)``,
    ``fcfs_mixed`` with mixed patch batches, the background decode at its
    default (``async_postprocess="auto"``).  The server runs on its own
    event loop and thread; the port's client sends, from threads, A (768^2,
    8 steps) with B and C (1024^2, 16 steps), whose mixed batch A leaves
    first, so that its decode overlaps B's and C's steps; D (1024^2, 8
    steps) and E (1024^2, 16 steps) about a second later, queued behind
    them under FCFS; and /abort for E once it denoises.  Checks the
    answers, PNGs, /health, /stats and /clear; that a decode group ran on
    the decode thread while DENOISING iterations went on, that no hand
    kernel launched off the engine's thread but the decoder's K6 on the
    decode thread (one call a GroupNorm of each group it decoded), and the
    launches per realized
    mode.  Prints the latencies, the decode thread's ms per group, the
    gate's decisions, the observed step times with and without a decode
    in flight, the measured decode bytes per pixel and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.cache = CacheConfig.production("sdxl", serving=True)
    config.engine.collect_data = True
    config.engine.collect_dir = "build/serve_http"
    engine = Engine(config, "cuda", bundle=bundle)
    pipe = engine.workers[0].pipeline
    steps = spy_deep(pipe)
    decodes, gates, observed = [], [], []
    decode_group, overlap_ok = pipe._decode_group, pipe.post_overlap_ok
    observe = engine.workers[0].scheduler.policy.observe_step_time

    def spy_decode_group(reqs):
        t0 = time.time()
        decode_group(reqs)
        decodes.append({"thread": threading.current_thread().name,
                        "start": t0, "end": time.time(), "n": len(reqs),
                        "res": reqs[0].resolution})

    def spy_overlap_ok(by_res):
        ok = overlap_ok(by_res)
        gates.append(({r: len(v) for r, v in by_res.items()}, ok))
        return ok

    def spy_observe(reqs, ms):
        observed.append((time.time(), ms, steps[-1]["path"],
                         steps[-1].get("mode")))
        return observe(reqs, ms)

    launch_threads: collections.Counter = collections.Counter()
    check = _build.check

    def spy_check(lib, err, what):
        launch_threads[threading.current_thread().name, what] += 1
        return check(lib, err, what)

    pipe._decode_group = spy_decode_group
    pipe.post_overlap_ok = spy_overlap_ok
    engine.workers[0].scheduler.policy.observe_step_time = spy_observe
    aeng = AsyncEngine(config, engine=engine)
    box, ready = {}, threading.Event()

    def run_server():
        async def main():
            box["server"] = await api_server.build_server(aeng, "127.0.0.1", 0)
            ready.set()
            await box["server"].wait_closed()
        asyncio.run(main())

    server_thread = threading.Thread(target=run_server, name="http-server")
    server_thread.start()
    if not ready.wait(60):
        raise AssertionError("the HTTP server did not start")
    url = f"http://127.0.0.1:{box['server'].port}"
    traffic = {"A": (768, 8), "B": (1024, 16), "C": (1024, 16),
               "D": (1024, 8), "E": (1024, 16)}
    answers = {}

    def send(rid):
        res, n = traffic[rid]
        answers[rid] = client.post_json(url + "/generate", {
            "prompt": f"an HTTP request {rid}", "resolution": res,
            "num_inference_steps": n, "seed": ord(rid), "request_id": rid,
            "guidance_scale": 5.0})

    def start(rid):
        th = threading.Thread(target=send, args=(rid,), name=f"client-{rid}")
        th.start()
        return th

    _build.check = spy_check
    try:
        reset_counts()
        t0 = time.perf_counter()
        # A, B and C join one batch with A the oldest, so that under FCFS
        # A's decode starts while B and C still denoise: the engine's
        # executor (which runs every add and step in order) is held until
        # all three adds wait in it, A's first
        gate = threading.Event()
        aeng._executor.submit(gate.wait)
        senders = []
        for rid in "ABC":
            senders.append(start(rid))
            wait_for(lambda: rid in aeng._streams, f"{rid}'s arrival")
        gate.set()
        time.sleep(1.0)
        senders += [start(rid) for rid in "DE"]
        wait_for(lambda: getattr(engine.workers[0].scheduler.pool.get("E"),
                                 "stage", None) is Stage.DENOISING,
                 "E in DENOISING")
        if client.post_json(url + "/abort", {"request_id": "E"}) \
                != {"status": "aborted"}:
            raise AssertionError("/abort failed")
        for th in senders:
            th.join(600)
            if th.is_alive():
                raise AssertionError(f"{th.name} did not return")
        wall = time.perf_counter() - t0
        got = read_counts()
    finally:
        _build.check = check
    peak = torch.cuda.max_memory_allocated()
    with urllib.request.urlopen(url + "/health", timeout=60) as resp:
        health = json.loads(resp.read())
    with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    cleared = client.post_json(url + "/clear", {})
    server_thread.join(120)

    # the answers and their PNGs
    for rid in "ABCD":
        out = answers[rid]
        res = traffic[rid][0]
        if not out.get("finished") or out.get("aborted") or "error" in out:
            raise AssertionError(f"request {rid}: {out}")
        img = client.decode_png(base64.b64decode(out["image_base64"]))
        if img.shape != (res, res, 3) or img.std() == 0:
            raise AssertionError(f"bad PNG for {rid}: {img.shape}")
        print(f"HTTP request {rid} {res}^2 x {traffic[rid][1]} steps: "
              f"latency_s {out['latency_s']:.3f}, e2e_latency_s "
              f"{out['e2e_latency_s']:.3f}, image mean {img.mean():.2f} "
              f"std {img.std():.2f} [{card}]")
    if not answers["E"].get("aborted") or answers["E"].get("finished"):
        raise AssertionError(f"E was not aborted: {answers['E']}")
    if health != {"status": "ok"} or cleared != {"status": "cleared"}:
        raise AssertionError(f"/health {health}, /clear {cleared}")
    if (stats["finished"], stats["aborted"]) != (4, 1) or not any(
            d.get("platform") == "gpu" and d.get("bytes_limit")
            for d in stats["devices"]):
        raise AssertionError(f"/stats {stats}")
    if server_thread.is_alive() or engine.has_unfinished_requests():
        raise AssertionError("the server or the engine did not stop")

    # the decode thread overlapped denoising
    denoise_times = [e["time"] for e in engine.workers[0].schedule_log
                     if e["stage"] == "denoising"]
    overlapped = [d for d in decodes if d["thread"].startswith("post-")
                  and any(d["start"] < t < d["end"] for t in denoise_times)]
    t_first = min(denoise_times)
    for d in decodes:
        inside = sum(d["start"] < t < d["end"] for t in denoise_times)
        print(f"decode group {d['n']} x {d['res']}^2 on {d['thread']}: "
              f"{(d['end'] - d['start']) * 1e3:.2f} ms (host wall, the "
              f"group's .cpu() included), from +"
              f"{d['start'] - t_first:.3f} s, {inside} DENOISING "
              f"iterations began inside it [{card}]")
    print(f"post_overlap_ok decisions: {gates} (parameters "
          f"{pipe.device_param_bytes() / 1e9:.3f} GB, card "
          f"{pipe._bytes_limit() / 1e9:.3f} GB) [{card}]")
    if not overlapped:
        raise AssertionError(f"no decode group overlapped a DENOISING "
                             f"iteration: {decodes}")
    # the decode thread's only hand kernel is K6, once per GroupNorm of
    # each decode group it ran
    off_loop = {key: n for key, n in launch_threads.items()
                if not key[0].startswith("engine-step")}
    n_post = sum(d["thread"].startswith("post-") for d in decodes)
    want_post = norms_of(pipe.bundle.models["vae"].decoder) * n_post
    got_post = sum(n for (name, what), n in off_loop.items()
                   if name.startswith("post-") and what == "gn_dense launch")
    if got_post != sum(off_loop.values()) or got_post != want_post:
        raise AssertionError(f"hand kernels launched off the engine's "
                             f"thread: {dict(launch_threads)} (expected "
                             f"only K6 on the decode thread, {want_post} "
                             f"calls for {n_post} decode groups)")

    # the wall time of each DENOISING iteration (to the next logged
    # iteration) and the step times fed to the policy, with and without a
    # background decode in flight during them
    spans = [(d["start"], d["end"]) for d in decodes
             if d["thread"].startswith("post-")]

    def during(a, b):
        return any(s < b and a < e for s, e in spans)

    log = [e["time"] for e in engine.workers[0].schedule_log]
    walls: dict = {True: [], False: []}
    for e, t_next in zip(engine.workers[0].schedule_log, log[1:]):
        if e["stage"] == "denoising":
            walls[during(e["time"], t_next)].append((t_next - e["time"]) * 1e3)
    fed: dict = {True: [], False: []}
    for t, ms, _, _ in observed:
        fed[during(t - ms / 1e3, t)].append(ms)
    for label, groups in (("iteration wall time", walls),
                          ("step time fed to the policy", fed)):
        print(f"{label}: " + "; ".join(
            f"{'decode in flight' if k else 'no decode'} {len(v)} "
            f"(mean {np.mean(v) if v else 0.0:.2f} ms, max "
            f"{max(v, default=0.0):.2f})" for k, v in groups.items())
            + f" [{card}]")

    modes = report_deep(steps, "HTTP serving (SDXL serving preset)", card)
    want = expected_launches(steps, bundle.denoiser.cfg)
    print(f"HTTP serving: 5 requests in {wall:.3f} s; modes {modes}; "
          f"launches {got} (expected {want}); launch threads "
          f"{dict(launch_threads)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB [{card}]")
    if got != want:
        raise AssertionError(f"HTTP serving launches {got} != {want}")

    # the decode transient the memory gate assumes per pixel
    bpp = {n: decode_bytes_per_pixel(pipe, 1024, n) for n in (1, 2)}
    print(f"decode transient, SDXL {pipe.bundle.param_dtype('vae')} VAE at "
          f"1024^2: "
          + ", ".join(f"{n} image(s) {v:.1f} B/px" for n, v in bpp.items())
          + f" (engine.decode_bytes_per_pixel "
          f"{config.engine.decode_bytes_per_pixel:.0f}) [{card}]")
    if max(bpp.values()) > config.engine.decode_bytes_per_pixel:
        raise AssertionError(f"decode transient {bpp} B/px exceeds the "
                             f"gate's {config.engine.decode_bytes_per_pixel}")
    return got


def check_vae_dtype(card: str, bundle: ModelBundle) -> None:
    """SDXL's decode of the same two 1024^2 latents under ``vae_dtype``
    "auto" (bf16 on the card, SDXL's force_upcast VAE included) and
    "float32": finite uint8 images within VAE_DTYPE_MEAN_COUNTS of each
    other on average; the decode times of one and two images and the
    bf16 decode's transient bytes per pixel.  The shared bundle's VAE is
    cast by each pipeline built on it, so the last one built here is
    "auto" again."""
    lat = torch.randn((2, 128, 128, 4), generator=torch.Generator("cuda")
                      .manual_seed(11), device="cuda", dtype=torch.bfloat16)
    images, ms, bpp = {}, {}, {}
    for mode, want in (("float32", torch.float32), ("auto", torch.bfloat16)):
        config = default_config("sdxl", dtype="bfloat16", seed=0)
        config.model.vae_dtype = mode
        pipe = build_pipeline(config, "cuda", bundle=bundle)
        vae = pipe.bundle.models["vae"]
        if pipe.bundle.param_dtype("vae") != want or any(
                p.dtype != want for p in vae.parameters()):
            raise AssertionError(f"vae_dtype {mode!r}: the VAE is not {want}")
        with torch.inference_mode():
            images[mode] = pipe._decode_fn(lat).cpu().numpy()
            ms[mode] = {n: cuda_ms(lambda: pipe._decode_fn(lat[:n]), 3)
                        for n in (1, 2)}
        if mode == "auto":
            bpp = {n: decode_bytes_per_pixel(pipe, 1024, n) for n in (1, 2)}
    for mode, img in images.items():
        if img.dtype != np.uint8 or img.shape != (2, 1024, 1024, 3) \
                or img.std() == 0:
            raise AssertionError(f"bad {mode} decode {img.dtype} {img.shape}")
    diff = np.abs(images["auto"].astype(np.int32)
                  - images["float32"].astype(np.int32))
    print(f"SDXL VAE decode at 1024^2: bf16 (vae_dtype auto) "
          + ", ".join(f"{n} image(s) {v:.2f} ms" for n, v in ms["auto"].items())
          + "; float32 "
          + ", ".join(f"{n} image(s) {v:.2f} ms" for n, v in ms["float32"].items())
          + f"; bf16 vs float32 mean |diff| {diff.mean():.4f} counts (max "
          f"{diff.max()}, bound {VAE_DTYPE_MEAN_COUNTS}); bf16 decode transient "
          + ", ".join(f"{n} image(s) {v:.1f} B/px" for n, v in bpp.items())
          + f" [{card}]")
    if not diff.mean() < VAE_DTYPE_MEAN_COUNTS:
        raise AssertionError(f"bf16 and float32 decodes differ by "
                             f"{diff.mean()} counts on average")


def write_safetensors(tensors: dict, path: str) -> None:
    """A safetensors file of bf16 tensors: an 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes), the raw
    bytes."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().to("cpu", torch.bfloat16).contiguous() \
            .view(torch.uint8).numpy()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + raw.nbytes]}
        blobs.append(raw)
        off += raw.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(memoryview(raw))


def write_snapshot(bundle: ModelBundle, root: str) -> None:
    """The bundle as a diffusers snapshot: ``model_index.json`` and one
    directory of bf16 safetensors per component; no tokenizer
    directories, so the loader falls back to its hash stub."""
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionPipeline"}, f)
    for name, model in bundle.models.items():
        os.makedirs(os.path.join(root, name))
        write_safetensors(model.state_dict(), os.path.join(
            root, name, "diffusion_pytorch_model.safetensors"))


def serve_sd15_snapshot(card: str, bundle: ModelBundle) -> dict:
    """The full-width SD-1.5 bundle written as a diffusers snapshot (bf16,
    so the round trip is exact) and served from it through
    ``DiffusionPipeline(model_path=...)``: 2 x 512^2, 8 Euler steps, the
    images bitwise equal to the same requests served from the in-memory
    bundle, and the launches of K1, K5 and K6 one dense forward's a step
    (and K6's of each decode).  Then
    served again with ``safety_checker_path="random"`` (ViT-L/14, float32):
    the checker's image embeddings on the card within CHECKER_REL of the
    same checker on the CPU; no flag with the random concepts, so the
    images equal the unchecked ones; with concept 0 set to image 0's
    embedding (its threshold halfway to image 1's cosine), image 0 flagged
    and all zero and every unflagged image equal to the unchecked run; the
    checker's ms per decode group."""
    prompts = ["a lighthouse on a cliff at dusk", "a bowl of ramen"]
    kw = dict(resolution=SNAPSHOT_REQUESTS, num_inference_steps=STEPS,
              seed=1234)
    per_forward = deep_launches(bundle.denoiser.cfg, 512)["full"]
    total = dict.fromkeys(COUNTED_WRAPPERS, 0)

    def serve(pipe, label, flagged_ok=False):
        reset_counts()
        outs = pipe.generate(prompts, **kw)
        torch.cuda.synchronize()
        got = read_counts()
        want = decode_launches()
        for k in ("k1", "k5", "k6"):
            want[k] += per_forward[k] * STEPS
        # a flagged image is all zero: check_outputs takes the others
        check_outputs([o for o in outs if not (flagged_ok and o.nsfw_flagged)],
                      [r for o, r in zip(outs, SNAPSHOT_REQUESTS)
                       if not (flagged_ok and o.nsfw_flagged)], card)
        if got != want:
            raise AssertionError(f"{label} launches {got} != {want}")
        for k in total:
            total[k] += got[k]
        return outs

    config = default_config("sd15", dtype="bfloat16", seed=0)
    ref = serve(DiffusionPipeline(config=config, device="cuda", bundle=bundle),
                "SD-1.5 in memory")
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="sd15_snapshot_", dir="build")
    try:
        t0 = time.perf_counter()
        write_snapshot(bundle, root)
        t_write = time.perf_counter() - t0
        config = default_config("sd15", dtype="bfloat16", seed=0)
        config.model.model_path = root
        t0 = time.perf_counter()
        snap = DiffusionPipeline(config=config, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        outs = serve(snap, "SD-1.5 from the snapshot")
        same = [np.array_equal(o.image, r.image) for o, r in zip(outs, ref)]
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)
        print(f"SD-1.5 snapshot ({size / 1e9:.3f} GB bf16): written in "
              f"{t_write:.1f} s, loaded in {t_load:.1f} s; {len(outs)} x "
              f"512^2 x {STEPS} "
              f"steps bitwise equal to the in-memory bundle's: {same}; "
              f"launches {read_counts()} a run [{card}]")
        if not all(same):
            raise AssertionError("the snapshot's images differ from the "
                                 "in-memory bundle's")
    finally:
        shutil.rmtree(root)

    config.model.safety_checker_path = "random"
    checked = DiffusionPipeline(config=config, device="cuda",
                                bundle=snap.engine.workers[0].pipeline.bundle)
    t0 = time.perf_counter()
    checker = checked.engine.workers[0].pipeline._safety_checker()
    t_init = time.perf_counter() - t0
    group_ms = []
    check = checker.check

    def spy_check(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = check(images)
        torch.cuda.synchronize()
        group_ms.append((len(images), (time.perf_counter() - t0) * 1e3))
        return out

    checker.check = spy_check
    plain = np.stack([r.image for r in ref])
    cpu = SafetyChecker(device="cpu")
    cpu.init_random(seed=config.model.seed)
    emb = checker.image_embeds(plain).cpu()
    emb_cpu = cpu.image_embeds(plain)
    rel = ((emb - emb_cpu).abs().max() / emb_cpu.abs().max()).item()
    print(f"safety checker (ViT-L/14, float32; random weights drawn in "
          f"{t_init:.1f} s): image_embeds card vs CPU max err / max |CPU| "
          f"{rel:.3e} (bound {CHECKER_REL:.0e}) [{card}]")
    if not rel <= CHECKER_REL:
        raise AssertionError(f"checker embeddings card vs CPU {rel}")

    def serve_checked(label):
        outs = serve(checked, label, flagged_ok=True)
        flags = [o.nsfw_flagged for o in outs]
        for o, r in zip(outs, ref):
            if o.image.shape != r.image.shape or o.image.dtype != np.uint8:
                raise AssertionError(f"{label}: bad image {o.image.shape}")
            if o.nsfw_flagged and o.image.any():
                raise AssertionError(f"{label}: a flagged image is not zero")
            if not o.nsfw_flagged and not np.array_equal(o.image, r.image):
                raise AssertionError(f"{label}: an unflagged image changed")
        return flags

    random_flags = serve_checked("SD-1.5 with the random checker")
    unit = emb / emb.norm(dim=-1, keepdim=True)
    cos01 = float(unit[0] @ unit[1])
    with torch.inference_mode():
        checker.concepts["concept_embeds"][0] = emb[0].to("cuda")
        checker.concepts["concept_embeds_weights"][0] = (1.0 + cos01) / 2
    set_flags = serve_checked("SD-1.5 with concept 0 = image 0")
    print(f"safety checker flags: random concepts {random_flags}; concept 0 "
          f"= image 0's embedding (cosine to image 1 {cos01:.4f}) "
          f"{set_flags}; check ms per decode group "
          + ", ".join(f"{n} x 512^2 {t:.2f}" for n, t in group_ms)
          + f" [{card}]")
    if any(random_flags) or not set_flags[0]:
        raise AssertionError(f"checker flags {random_flags} {set_flags}")
    return total


def profile_h100(card: str) -> dict:
    """ESyMReD's stage profile and latency predictor fitted on the card
    (``scheduler/profiler.py``): SDXL at PROFILE_RES with
    PROFILE_POST_BATCH, every value finite and > 0, standalone denoising
    50 x the step; the committed H100 files load into ``StageProfile`` and
    ``LatencyPredictor``; then 3 SDXL requests served under ESyMReD with the
    fresh profile and predictor (uint8 images).  Returns the launches of
    the profiling and of the serving run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="profile_", dir="build")
    try:
        prof = Profiler("sdxl", resolutions=PROFILE_RES, device="cuda")
        bundle = prof.pipe.bundle  # random bf16 weights, drawn on the card
        reset_counts()
        profile = prof.build_profile(max_post_batch=PROFILE_POST_BATCH)
        pred_path = os.path.join(root, "predictor.npz")
        prof.fit_predictor(pred_path)
        torch.cuda.synchronize()
        got = read_counts()
        values = [v for t in profile["standalone"].values() for v in t.values()]
        values += list(profile["step_latency"].values())
        values += [v for t in profile["post_batch_latency"].values() for v in t]
        if not all(np.isfinite(v) and v > 0 for v in values):
            raise AssertionError(f"bad profile {profile}")
        for res, s in profile["step_latency"].items():
            if profile["standalone"]["denoising"][res] != 50.0 * s:
                raise AssertionError(f"standalone denoise at {res} is not "
                                     f"50 x the step")
        print(f"SDXL stage profile on the card (seconds): "
              f"{json.dumps(profile)}; profiling launches {got} [{card}]")

        for family in ("sd15", "sdxl", "sd3"):
            with open(os.path.join(H100_PROFILES,
                                   f"profile_{family}.json")) as f:
                sp = StageProfile(**json.load(f))
            lp = LatencyPredictor.load(os.path.join(
                H100_PROFILES, f"predictor_{family}.npz"), sp)
            counts = [1] * len(lp.resolutions)
            if not (lp.predict(counts) > 0 and sp.e2e_ddl_s(
                    lp.resolutions[-1]) > 0):
                raise AssertionError(f"bad H100 files for {family}")

        config = default_config("sdxl", dtype="bfloat16", seed=0)
        config.scheduler.policy = "esymred"
        config.scheduler.stage_latency_overrides = profile
        config.scheduler.predictor_path = pred_path
        pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
        policy = pipe.engine.workers[0].scheduler.policy
        if policy.profile.step_latency != profile["step_latency"] \
                or policy.predictor.weights is None:
            raise AssertionError("ESyMReD did not take the fitted profile")
        reset_counts()
        outs = pipe.generate(["a cat", "a lighthouse", "a bowl of ramen"],
                             resolution=PROFILE_REQUESTS,
                             num_inference_steps=STEPS, seed=99)
        torch.cuda.synchronize()
        served = read_counts()
        check_outputs(outs, PROFILE_REQUESTS, card)
        print(f"SDXL under ESyMReD with the fitted profile: launches "
              f"{served}; phase {time.perf_counter() - t0:.1f} s [{card}]")
    finally:
        shutil.rmtree(root)
    return {k: got[k] + served[k] for k in got}


# -- fused multi-step dispatch: chunks replayed from captured step graphs --

def spy_dispatch(pipe) -> list:
    """Record every per-step dispatch of ``pipe`` (CUDA events around it,
    its requests' count) and every chunk (its steps); the per-step modes
    come from ``pipe.step_modes``, the chunk steps' events from
    ``pipe.graphs.events``."""
    recs, depth = [], [0]
    for name in ("denoise_step", "denoise_step_mixed"):
        fn = getattr(pipe, name)

        def step(by_res, fn=fn):
            if depth[0]:  # SD3's cached step goes on to the token path
                return fn(by_res)
            rec = {"start": torch.cuda.Event(enable_timing=True),
                   "end": torch.cuda.Event(enable_timing=True), "steps": 1,
                   "n_modes": len(pipe.step_modes)}
            depth[0] += 1
            rec["start"].record()
            try:
                fn(by_res)
            finally:
                depth[0] -= 1
            rec["end"].record()
            rec["mode"] = (pipe.step_modes[-1] if len(pipe.step_modes)
                           > rec["n_modes"] else "off")
            recs.append(rec)
        setattr(pipe, name, step)
    for name in ("denoise_chunk", "denoise_chunk_mixed"):
        fn = getattr(pipe, name)

        def chunk(by_res, k, fn=fn):
            ok = fn(by_res, k)
            if ok:
                recs.append({"steps": k, "chunk": True})
            return ok
        setattr(pipe, name, chunk)
    return recs


def check_row_budget(pipe, cfg, label: str, after: str) -> int:
    """The row state (composition stores and step-set row buffers) within
    ``comp_state_bytes``, or held by one step set alone (the newest is
    always kept); returns its bytes."""
    rows = pipe._row_state_bytes()
    if (rows > cfg.cache.comp_state_bytes
            and len(pipe.graphs.row_states()) > 1):
        raise AssertionError(f"{label}: {rows} bytes of row state after "
                             f"{after}, over comp_state_bytes "
                             f"{cfg.cache.comp_state_bytes:.0f}")
    return rows


def chunk_window(pipe, comp: dict, k: int, reps: int, chunked: bool,
                 card: str) -> dict:
    """Dispatch cost at one composition ``{res: count}``, the worker's
    throttle aside: ``reps`` chunks of ``k`` steps (kinds already
    captured) or ``reps * k`` per-step steps on fresh requests; wall ms
    and CUDA-event ms a step, then one more round under torch.profiler:
    the device-busy ms a step (the union of kernel spans) and the wall ms
    a step of that same round, whose ratio is the busy share."""
    reqs = [Request(f"window-{res}-{i}-{chunked}", SamplingParams(
        prompt="a timing prompt", resolution=res,
        num_inference_steps=2 * reps * k + k, seed=i))
            for res, n in sorted(comp.items()) for i in range(n)]
    pipe.prepare(reqs)
    by_res = {}
    for r in reqs:
        by_res.setdefault(r.resolution, []).append(r)
    mixed = len(by_res) > 1

    def round_():
        if chunked:
            ok = (pipe.denoise_chunk_mixed(by_res, k) if mixed
                  else pipe.denoise_chunk(by_res, k))
            if not ok:
                raise AssertionError(f"chunk ineligible at {comp}")
        else:
            for _ in range(k):
                (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(
                    by_res)

    round_()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps - 1):
        round_()
    end.record()
    torch.cuda.synchronize()
    n = (reps - 1) * k
    wall = (time.perf_counter() - t0) * 1e3 / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / k
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = None
    if spans:
        busy_us, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy = (busy_us + cur_e - cur_s) / 1e3 / k
        if busy > prof_wall:
            raise AssertionError(
                f"dispatch window {comp}: device busy {busy:.3f} ms a step "
                f"exceeds the profiled round's wall {prof_wall:.3f} ms")
    out = {"wall_ms": wall, "event_ms": start.elapsed_time(end) / n,
           "busy_ms": busy, "profiled_wall_ms": prof_wall}
    print(f"dispatch window {comp} {'chunks of ' + str(k) if chunked else 'per-step'}: "
          f"wall {wall:.2f} ms a step, CUDA events {out['event_ms']:.2f} ms; "
          f"profiled round: wall {prof_wall:.2f} ms a step, device busy "
          + (f"{busy:.2f} ms ({busy / prof_wall:.1%} of its wall)"
             if busy is not None
             else "not measured (the profiler saw no kernel)")
          + f" [{card}]")
    return out


def replay_full(pipe, comp: dict, k: int, label: str, card: str) -> None:
    """One chunk of fresh requests at ``comp`` whose first step is an
    interval's full: the warmup's per-step steps, then every age (the SD3
    delta's too) set to ``deep_interval - 1``, as at an expiry.  Prints the
    CUDA-event ms of each replayed kind; captures nothing new."""
    reqs = [Request(f"replay-{res}-{i}", SamplingParams(
        prompt="a replay prompt", resolution=res,
        num_inference_steps=pipe.config.cache.deep_warmup + k, seed=i))
            for res, n in sorted(comp.items()) for i in range(n)]
    pipe.prepare(reqs)
    by_res = {}
    for r in reqs:
        by_res.setdefault(r.resolution, []).append(r)
    mixed = len(by_res) > 1
    for _ in range(pipe.config.cache.deep_warmup):
        (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(by_res)
    itv = pipe.config.cache.deep_interval
    for r in reqs:
        r.deep_age = itv - 1
    for entry in getattr(pipe, "_sd3_state", {}).values():
        entry["deep_age"] = itv - 1
    captures, pipe.graphs.events = pipe.graphs.captures, []
    if not (pipe.denoise_chunk_mixed if mixed else pipe.denoise_chunk)(
            by_res, k):
        raise AssertionError(f"{label}: the replay chunk is ineligible")
    torch.cuda.synchronize()
    if pipe.graphs.captures != captures:
        raise AssertionError(f"{label}: the replay chunk captured a graph")
    by: dict = {}
    for kind, start, end in pipe.graphs.events:
        by.setdefault(kind, []).append(start.elapsed_time(end))
    pipe.graphs.events = None
    if "full" not in by:
        raise AssertionError(f"{label}: no full step in the replay chunk")
    for kind, ms in sorted(by.items()):
        print(f"{label} replayed {kind}: {len(ms)} steps, mean "
              f"{np.mean(ms):.2f} ms (min {np.min(ms):.2f}, max "
              f"{np.max(ms):.2f}; CUDA events) [{card}]")


def serve_chunked(card: str, bundle: ModelBundle, label: str, config,
                  first, late=None, k: int = CHUNK_K, prewarm=None,
                  per_step=None, window=None, full=None) -> list:
    """The same requests served through ``Engine`` twice, each dispatch
    a chunk of up to ``k`` steps replayed from captured step graphs (after
    ``engine.prewarm(**prewarm)``), then one step at a time.  ``first``:
    (resolution, steps) of the first requests; ``late``: (after, (res,
    steps)), a request added once the first has taken ``after`` steps.
    Checks each request's final latents within CHUNK_MAX_REL of max |ref|
    (printing whether they are bitwise equal), the realized deep mode of
    every step, the launches (equal between the runs and to
    ``per_step(mode)`` summed over the steps), and that serving after
    prewarm captured no new graph; prints the prewarm seconds, the graph
    memory, each mode's CUDA-event ms a step under both dispatches and
    the end-to-end seconds, and the graph memory beside the per-step
    run's peak memory above its start (the eager steps' workspace).
    ``window``: also time the dispatch cost at that composition
    (:func:`chunk_window`); ``full``: time a replayed full step there
    (:func:`replay_full`).  Returns both runs' launches."""
    runs = {}
    for spd in (k, 1):
        cfg = copy.deepcopy(config)
        cfg.scheduler.steps_per_dispatch = spd
        cfg.engine.prewarm = spd > 1
        gc.collect()
        torch.cuda.empty_cache()
        engine = Engine(cfg, "cuda", bundle=bundle)
        pipe = engine.workers[0].pipeline
        rec = {}
        if spd > 1:
            torch.cuda.synchronize()
            r0 = torch.cuda.memory_reserved()
            rec["prewarm_s"] = engine.prewarm(**prewarm)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            rec["graph_bytes"] = torch.cuda.memory_reserved() - r0
            rec["buffer_bytes"] = unique_nbytes(pipe.graphs.buffers())
            rec["captures"] = pipe.graphs.captures
            rec["row_bytes"] = check_row_budget(pipe, cfg, label, "prewarm")
            pipe.graphs.events = []
        pipe.step_modes = []
        dispatches = spy_dispatch(pipe)
        reset_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reqs, outs = [], []
        for i, (res, steps) in enumerate(first):
            reqs.append(engine.add_request(f"chunk-{i}", SamplingParams(
                prompt=f"a chunked prompt {i}", resolution=res,
                num_inference_steps=steps, seed=i, output_type="latent")))
        while engine.has_unfinished_requests():
            if (late is not None and len(reqs) == len(first)
                    and reqs[0].sampler_table is not None
                    and reqs[0].sampler_table.step >= late[0]):
                res, steps = late[1]
                reqs.append(engine.add_request(
                    f"chunk-{len(first)}", SamplingParams(
                        prompt="a late prompt", resolution=res,
                        num_inference_steps=steps, seed=len(first),
                        output_type="latent")))
            outs.extend(engine.step())
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        rec["launches"] = read_counts()
        rec["modes"] = list(pipe.step_modes)
        rec["latents"] = {o.request_id: o.image for o in outs}
        rec["steps"] = sum(d["steps"] for d in dispatches)
        rec["chunks"] = [d["steps"] for d in dispatches if d.get("chunk")]
        by_mode: dict = {}
        for d in dispatches:
            if not d.get("chunk"):
                by_mode.setdefault(d["mode"], []).append(
                    d["start"].elapsed_time(d["end"]))
        rec["per_step_ms"] = {m: float(np.mean(v)) for m, v in by_mode.items()}
        chunk_ms: dict = {}
        for kind, s, e in pipe.graphs.events or ():
            name = kind if isinstance(kind, str) else kind[0]
            chunk_ms.setdefault(name, []).append(s.elapsed_time(e))
        rec["chunk_ms"] = {m: float(np.mean(v)) for m, v in chunk_ms.items()}
        if spd > 1:
            check_row_budget(pipe, cfg, label, "serving")
            if pipe.graphs.captures != rec["captures"]:
                raise AssertionError(
                    f"{label}: serving after prewarm captured "
                    f"{pipe.graphs.captures - rec['captures']} new graphs")
            if not rec["chunks"]:
                raise AssertionError(f"{label}: no chunk ran")
            if window is not None:
                pipe.graphs.events = None
                rec["window"] = {c: chunk_window(pipe, window, k, 4, c, card)
                                 for c in (True, False)}
            if full is not None:
                replay_full(pipe, full, k, label, card)
        runs[spd] = rec
        del engine, pipe
    chunked, stepped = runs[k], runs[1]
    bitwise = True
    for rid, ref in stepped["latents"].items():
        got = chunked["latents"][rid]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: bad latents {rid} {got.shape}")
        err = float(np.abs(got - ref).max())
        bitwise &= err == 0.0
        if err > CHUNK_MAX_REL * float(np.abs(ref).max()):
            raise AssertionError(f"{label}: {rid} chunked latents {err:.3e} "
                                 f"off per-step (max |ref| "
                                 f"{np.abs(ref).max():.3e})")
    if chunked["modes"] != stepped["modes"]:
        raise AssertionError(f"{label}: modes {chunked['modes']} != "
                             f"per-step {stepped['modes']}")
    want = dict.fromkeys(COUNTED_WRAPPERS, 0)  # latents only: no decode
    for mode in stepped["modes"] or ["off"] * stepped["steps"]:
        for key, n in per_step(mode).items():
            want[key] += n
    if not chunked["launches"] == stepped["launches"] == want:
        raise AssertionError(f"{label}: launches chunked "
                             f"{chunked['launches']}, per-step "
                             f"{stepped['launches']}, expected {want}")
    print(f"{label}: chunks {chunked['chunks']} of {chunked['steps']} steps; "
          f"latents bitwise equal to per-step: {bitwise}; modes "
          f"{collections.Counter(chunked['modes'])}; launches "
          f"{chunked['launches']}; end to end {chunked['wall_s']:.3f} s "
          f"chunked, {stepped['wall_s']:.3f} s per-step; prewarm "
          f"{chunked['prewarm_s']:.1f} s, {chunked['captures']} graphs "
          "captured, "
          f"graph memory {chunked['graph_bytes'] / 2**20:.1f} MiB (step-set "
          f"buffers {chunked['buffer_bytes'] / 2**20:.1f} MiB, row state "
          f"after prewarm {chunked['row_bytes'] / 2**20:.1f} MiB) against the "
          f"per-step run's peak {stepped['peak_bytes'] / 2**20:.1f} MiB "
          f"above its start [{card}]")
    for mode in sorted(set(chunked["chunk_ms"]) | set(stepped["per_step_ms"])):
        c, s = chunked["chunk_ms"].get(mode), stepped["per_step_ms"].get(mode)
        print(f"{label} step {mode}: chunked (graph replays) "
              + ("-" if c is None else f"{c:.2f}")
              + " ms, per-step " + ("-" if s is None else f"{s:.2f}")
              + f" ms (CUDA events) [{card}]")
    return [chunked["launches"], stepped["launches"]]


def serve_sd15_chunked(card: str, bundle: ModelBundle) -> list:
    """SD-1.5 dense 512^2 x 2, cache off, chunks of CHUNK_K, with the
    dispatch window; then ``production("sd15", serving=True)`` under
    ESyMReD: 3 x 512^2 and a fourth admitted after CHUNK_SD15_ADMIT steps
    (hybrid_partial chunks, the admission's warmup as partial steps)."""
    cfg = bundle.denoiser.cfg
    per = deep_launches(cfg, 512)
    config = default_config("sd15", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False
    runs = serve_chunked(
        card, bundle, "SD-1.5 dense 512^2 x 2, chunked", config,
        [(512, CHUNK_SD15_STEPS)] * 2, prewarm=dict(
            resolutions=(512,), buckets=(2,)),
        per_step=lambda mode: {**per["full"], "flash_mha": 0, "masked": 0,
                               "k4": 0},
        window={512: 2})
    config = default_config("sd15", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False
    config.scheduler.policy = "esymred"
    config.scheduler.slo_scale = 1e4
    config.cache = CacheConfig.production("sd15", serving=True)
    runs += serve_chunked(
        card, bundle, "SD-1.5 serving preset, chunked", config,
        [(512, DEEP_SD15_STEPS)] * 3,
        late=(CHUNK_SD15_ADMIT, (512, DEEP_SD15_STEPS - CHUNK_SD15_ADMIT)),
        k=CHUNK_SD15_K, prewarm=dict(resolutions=(512,), buckets=(2, 4)),
        per_step=lambda mode: {**per[mode], "flash_mha": 0, "masked": 0,
                               "k4": 0})
    return runs


def serve_sdxl_chunked(card: str, bundle: ModelBundle) -> list:
    """SDXL's mix 768^2 + 3 x 1024^2 under ``production("sdxl",
    serving=True)``: mixed-path chunks (the masked kernel, K4 and K5
    replayed), the composition prewarmed."""
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.cache = CacheConfig.production("sdxl", serving=True)
    per = mixed_launches(bundle.denoiser.cfg, 2)
    return serve_chunked(
        card, bundle, "SDXL mix 768^2 + 3 x 1024^2, chunked", config,
        [(r, MIXED_DEEP_STEPS) for r in MIXED_REQUESTS],
        prewarm=dict(resolutions=(), buckets=(), steps=4,
                     compositions=[{768: 1, 1024: 3}]),
        per_step=lambda mode: per[mode], full={768: 1, 1024: 3})


def serve_sd3_chunked(card: str, bundle: ModelBundle) -> list:
    """SD3.5-medium 4 x 1024^2 under ``production("sd3", serving=True)``
    (span 1:24, interval 16): chunks of CHUNK_SD3_K, the first entering
    mid-interval, on the token path."""
    config = default_config("sd3", dtype="bfloat16", seed=0)
    config.cache = CacheConfig.production("sd3", serving=True)
    span = config.cache.sd3_deep_span
    return serve_chunked(
        card, bundle, "SD3 4 x 1024^2 span 1:24, chunked", config,
        [(1024, CHUNK_SD3_STEPS)] * 4, k=CHUNK_SD3_K,
        prewarm=dict(resolutions=(1024,), buckets=(4,), steps=4),
        full={1024: 4},
        per_step=lambda mode: {
            "k1": 0, "flash_mha": 0, "k4": 0, "k5": 0, "k6": 0,
            "masked": sd3_attentions(bundle, span if mode == "shallow"
                                     else (0, 0))})


# the wrappers chip_smoke counts, by the key the launch dicts use
COUNTED_WRAPPERS = {"k1": flash_mha_fused, "flash_mha": flash_mha,
                    "masked": flash_mha_masked, "k4": gn_silu_halo,
                    "k5": flash_cross_short, "k6": gn_dense}
# the GroupNorms of each VAE decoder forward since reset_counts
# (spy_decoders)
DECODER_NORMS: list = []


def reset_counts() -> None:
    for fn in COUNTED_WRAPPERS.values():
        fn.launches = 0
        fn.__dict__.pop("by_thread", None)
    DECODER_NORMS.clear()


def spy_decoders() -> None:
    """Record the GroupNorms of every VAE decoder forward, on any thread
    (the decode thread too), in DECODER_NORMS."""
    real = vae_mod.Decoder.forward

    def forward(self, z):
        DECODER_NORMS.append(norms_of(self))
        return real(self, z)

    vae_mod.Decoder.forward = forward


def decode_launches() -> dict:
    """The launches of the VAE decodes since :func:`reset_counts`: one K6
    call a GroupNorm of each decoder forward (every GroupNorm of the
    decoder is dense), no other kernel."""
    out = dict.fromkeys(COUNTED_WRAPPERS, 0)
    out["k6"] = sum(DECODER_NORMS)
    return out


def shard_counts(n: int) -> list:
    """Each shard's launches since :func:`reset_counts` (a group's shard
    ``r`` launches from its thread ``shard-<r>_*``), rank order."""
    out = [dict.fromkeys(COUNTED_WRAPPERS, 0) for _ in range(n)]
    for key, fn in COUNTED_WRAPPERS.items():
        for name, k in fn.__dict__.get("by_thread", {}).items():
            if name.startswith("shard-"):
                out[int(name[6:].split("_")[0])][key] += k
    return out


@contextlib.contextmanager
def plain_routes():
    """Count the kernels' plain versions as their wrappers call them (a
    wrapper takes its plain version for CPU tensors only): yields the
    ``{name: calls}`` dict."""
    from sduss_tpu_torch.ops import flash as flash_mod
    from sduss_tpu_torch.ops import gn_halo as gn_mod

    calls: dict = {}
    saved = []
    for mod, name in ((flash_mod, "flash_mha_fused_reference"),
                      (flash_mod, "flash_mha_reference"),
                      (flash_mod, "flash_mha_masked_reference"),
                      (flash_mod, "flash_cross_short_reference"),
                      (gn_mod, "gn_silu_halo_reference")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        saved.append((mod, name, real))
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


@contextlib.contextmanager
def gate_picks():
    """Record what every ``BlockCache`` gate selects (device copies, read
    after the run), by the rank of the shard thread that ran it (0 off
    the shard threads): yields ``{rank: [(gate, key, {stat: tensor})]}``."""
    stats = {"gate": ("fresh",), "gate_compact": ("idx",),
             "gate_compact_pairs": ("idx",),
             "gate_compact_images": ("images", "gather", "tok_sel"),
             "gate_tokens_fine": ("sel",)}
    calls = collections.defaultdict(list)
    saved = []
    for name, keys in stats.items():
        real = getattr(BlockCache, name)

        def spy(self, key, *a, _real=real, _name=name, _keys=keys, **kw):
            out = _real(self, key, *a, **kw)
            thread = threading.current_thread().name
            rank = (int(thread[6:].split("_")[0])
                    if thread.startswith("shard-") else 0)
            calls[rank].append((_name, key, {
                k: out[2][k].clone() for k in _keys
                if out[2] and k in out[2]}))
            return out

        saved.append((name, real))
        setattr(BlockCache, name, spy)
    try:
        yield calls
    finally:
        for name, real in saved:
            setattr(BlockCache, name, real)


def equal_picks(one: list, group: list) -> tuple:
    """``(equal, total)`` gate calls whose selections (all stats) are
    one device's; a call the group did not make counts unequal."""
    eq = 0
    for k, (name, key, stats) in enumerate(one):
        if k >= len(group) or group[k][:2] != (name, key):
            continue
        got = group[k][2]
        if set(got) == set(stats) and all(
                torch.equal(got[s].cpu(), v.cpu()) for s, v in stats.items()):
            eq += 1
    return eq, max(len(one), len(group))


def read_counts() -> dict:
    return {key: fn.launches for key, fn in COUNTED_WRAPPERS.items()}


def serve_sd15(card: str, bundle: ModelBundle, mixed: bool, sampler: str,
               steps: int, requests: list, async_prepare=False) -> dict:
    """SD-1.5 serving through ``DiffusionPipeline.generate``: the dense path
    (mixed batches off, one UNet forward per resolution group) or the
    default configuration (one patched forward per step).  Asserts the
    images, the DENOISING batches and the launches of K1, the masked kernel,
    K4, K5 and K6 that SD15_UNET gives for these requests (K6: each dense
    forward's GroupNorms and each decode's).  ``async_prepare``:
    also asserts that every prepare ran on the worker's prepare thread."""
    torch.cuda.reset_peak_memory_stats()
    config = default_config("sd15", dtype="bfloat16", seed=0, sampler=sampler)
    config.scheduler.use_mixed_resolution = mixed
    config.engine.collect_data = True
    config.engine.async_prepare = async_prepare
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    prepare_threads = []
    prepare = pipe.engine.workers[0].pipeline.prepare

    def spy_prepare(reqs):
        prepare_threads.append(threading.current_thread().name)
        return prepare(reqs)

    pipe.engine.workers[0].pipeline.prepare = spy_prepare
    if mixed and config.scheduler.policy != "fcfs_mixed":
        raise AssertionError("the default configuration is not the mixed path")
    cfg = bundle.denoiser.cfg
    n_k4 = 2 * sum(type(m).__name__ == "ResnetBlock2D"
                   for m in bundle.denoiser.modules()) + 1
    prompts = ["a lighthouse on a cliff at dusk", "a bowl of ramen",
               "an astronaut riding a horse", "a red fox in snow"][:len(requests)]
    evals = pipe.engine.workers[0].pipeline.sampler.make_table(steps).num_steps

    reset_counts()
    t0 = time.perf_counter()
    outs = pipe.generate(prompts, resolution=requests,
                         num_inference_steps=steps, seed=1234)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()

    check_outputs(outs, requests, card)
    log = pipe.engine.workers[0].schedule_log
    batches = [e["resolutions"] for e in log if e["stage"] == "denoising"]
    groups = sorted(set(requests))
    counts = [f"{r}x{requests.count(r)}" for r in groups]
    if mixed:
        if batches != [";".join(counts)] * evals:
            raise AssertionError(f"expected {evals} mixed DENOISING batches "
                                 f"{';'.join(counts)}, got {batches}")
    elif sorted(batches) != sorted(counts * evals):
        raise AssertionError(f"expected {evals} DENOISING batches of each of "
                             f"{counts}, got {batches}")
    # the launches each logged batch makes: a mixed batch is one patched
    # forward (one masked call per resolution class and self-attention, one
    # K4 per GroupNorm+SiLU before a 3x3 conv, one K5 per text
    # cross-attention); a dense one is a forward per resolution, each
    # self-attention with >= FLASH_MIN_KV keys on K1, each shorter one and
    # each cross-attention on K5
    n_self = len(sd15_self_attention_keys(cfg, requests[0]))
    want = decode_launches()
    for entry in batches:
        res = [int(part.split("x")[0]) for part in entry.split(";")]
        if mixed:
            want["masked"] += n_self * len(res)
            want["k4"] += n_k4
            want["k5"] += n_self
        else:
            keys = [k for r in res for k in sd15_self_attention_keys(cfg, r)]
            want["k1"] += sum(k >= FLASH_MIN_KV for k in keys)
            want["k5"] += len(keys) + sum(k < FLASH_MIN_KV for k in keys)
            want["k6"] += dense_norms(cfg) * len(res)
    key = batches[0]
    path = "mixed" if mixed else "dense"
    print(f"SD-1.5 {path} serving ({sampler}, {steps} steps = {evals} "
          f"evaluations, async_prepare {async_prepare}): {len(outs)} "
          f"requests in {wall:.3f} s; DENOISING batches "
          f"{sorted(set(batches))} x {len(batches)}; launches {got} "
          f"(expected {want}); prepare threads {prepare_threads}")
    if got != want:
        raise AssertionError(f"SD-1.5 {path} launches {got} != {want}")
    if async_prepare and not all(name.startswith("prepare-")
                                 for name in prepare_threads):
        raise AssertionError(f"prepare ran on {prepare_threads}")
    step_gaps(log, key, f"SD-1.5 {path} {key} ({sampler})", card)
    peak = torch.cuda.max_memory_allocated()

    # final latents are finite (the uint8 cast would hide NaN)
    lat = pipe.generate(prompts, resolution=requests, num_inference_steps=2,
                        seed=7, output_type="latent")
    for o, r in zip(lat, requests):
        if o.image.shape != (r // 8, r // 8, 4) or not np.isfinite(o.image).all():
            raise AssertionError(f"bad SD-1.5 latents {o.image.shape}")
    print(f"max_memory_allocated {peak / 2**30:.2f} GiB (SD-1.5 {path}, "
          f"{sampler}) [{card}]")
    return got


# -- the trace replay and dp replicas --------------------------------------

def busy_shares(prof, wall_s: float) -> dict:
    """Each card's busy share of a profiled window of ``wall_s`` seconds:
    the union of its kernel spans over the window."""
    spans = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans[e.device_index].append((e.time_range.start,
                                          e.time_range.end))
    out = {}
    for dev, sp in sorted(spans.items()):
        sp.sort()
        busy_us, cur_s, cur_e = 0.0, *sp[0]
        for a, b in sp[1:]:
            if a > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        out[dev] = (busy_us + cur_e - cur_s) / 1e6 / wall_s
    return out


def replay_sdxl(card: str, bundle: ModelBundle, devices=None,
                buckets=REPLAY_BUCKETS, busy: bool = False) -> dict:
    """``benchmark.replay.run_replay`` on the card: SDXL-base (the random
    bf16 bundle of seed 0), ``CacheConfig.production("sdxl")``, ESyMReD
    with the committed H100 profile and predictor, the first REPLAY_N rows
    of REPLAY_TRACE, after the replay's prewarm of their resolutions.
    Checks REPLAY_N records, an image of its resolution with contrast for
    every finished request, and ``compute_metrics`` of the records (times
    at the microsecond) against that of their CSV round trip; prints the
    SLO metrics, each request's latency and the prewarm seconds.
    ``devices`` (card indices): dp replicas there; ``busy``: the replay
    runs under torch.profiler (CUDA activity) and each card's busy share
    is printed.  Returns the launches of the replay (prewarm excluded)."""
    t0 = time.perf_counter()
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.scheduler.policy = "esymred"
    config.scheduler.batch_buckets = tuple(buckets)
    config.scheduler.max_batch_size = buckets[-1]
    if devices is not None:
        config.parallel.dp = len(devices)
        config.parallel.devices = list(devices)
    config.cache = CacheConfig.production("sdxl")
    with open(os.path.join(H100_PROFILES, "profile_sdxl.json")) as f:
        config.scheduler.stage_latency_overrides = json.load(f)
    config.scheduler.predictor_path = os.path.join(H100_PROFILES,
                                                   "predictor_sdxl.npz")
    rows = load_trace(REPLAY_TRACE)[:REPLAY_N]
    engine = Engine(config, "cuda", bundle=bundle)
    outs, prewarm_s = [], []
    step, prewarm = engine.step, engine.prewarm

    def spy_step():
        got = step()
        outs.extend(got)
        return got

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if busy else None
    window = []

    def spy_prewarm(**kw):
        prewarm_s.append(prewarm(**kw))
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        reset_counts()  # the replay's launches only
        if prof is not None:
            prof.start()
        window.append(time.perf_counter())
        return prewarm_s[-1]

    engine.step, engine.prewarm = spy_step, spy_prewarm
    per_rank = collections.Counter()  # requests dispatched to each replica
    for w in engine.workers:
        w.add_requests = (lambda reqs, add=w.add_requests, r=w.rank:
                          (per_rank.update({r: len(reqs)}), add(reqs))[1])
    t1 = time.perf_counter()
    records = run_replay(config, rows, slo=REPLAY_SLO, device="cuda",
                         engine=engine)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    window.append(time.perf_counter())
    got = read_counts()
    if prof is not None:
        prof.stop()
        shares = busy_shares(prof, window[1] - window[0])
        print(f"replay busy share per card over its {window[1] - window[0]:.3f}"
              f" s (profiled): " + (", ".join(
                  f"cuda:{d} {v:.1%}" for d, v in shares.items())
                  or "not measured (the profiler saw no kernel)")
              + f" [{card}]")

    if len(records) != REPLAY_N or len(outs) != REPLAY_N or not prewarm_s:
        raise AssertionError(f"{len(records)} records, {len(outs)} outputs "
                             f"for {REPLAY_N} rows; prewarm {prewarm_s}")
    by_id = {o.request_id: o for o in outs}
    for rec in sorted(records, key=lambda r: r.arrival_time):
        o = by_id[rec.request_id]
        if not rec.aborted:
            img = o.image
            if img is None or img.dtype != np.uint8 or img.shape != (
                    rec.resolution, rec.resolution, 3) or img.std() == 0:
                raise AssertionError(
                    f"bad image for {rec.request_id}: "
                    f"{None if img is None else (img.dtype, img.shape)}")
        print(f"replay {rec.request_id} {rec.resolution}^2: latency "
              f"{rec.latency_s:.3f} s, {'aborted' if rec.aborted else 'ok'}"
              f" [{card}]")
    m = compute_metrics(records, "sdxl", slo=REPLAY_SLO)
    root = tempfile.mkdtemp(prefix="replay_", dir="build")
    try:
        path = os.path.join(root, "client.csv")
        records_to_csv(records, path)
        back = compute_metrics(records_from_csv(path), "sdxl",
                               slo=REPLAY_SLO)
    finally:
        shutil.rmtree(root)
    micro = [dataclasses.replace(
        r, arrival_time=float(f"{r.arrival_time:.6f}"),
        finish_time=float(f"{r.finish_time:.6f}")) for r in records]
    want = compute_metrics(micro, "sdxl", slo=REPLAY_SLO)
    if json.dumps(want) != json.dumps(back):  # NaN equal to NaN
        raise AssertionError(f"metrics {want} != CSV round trip {back}")
    if got["k5"] == 0 or got["k6"] == 0:
        raise AssertionError(f"the replay launched no text cross-attention "
                             f"or dense GroupNorm kernel: {got}")
    print(f"replay_sdxl metrics ({REPLAY_N} rows of {REPLAY_TRACE}, slo "
          f"{REPLAY_SLO}, ESyMReD, production('sdxl'), dp "
          f"{len(engine.workers)}, requests per replica "
          f"{[per_rank[w.rank] for w in engine.workers]}): {json.dumps(m)}; "
          f"prewarm {prewarm_s[0]:.1f} s, replay "
          f"{time.perf_counter() - t1 - prewarm_s[0]:.1f} s, launches {got}; "
          f"phase {time.perf_counter() - t0:.1f} s [{card}]")
    return got


def greedy_ranks(resolutions, replicas: int) -> list:
    """The greedy dispatch recomputed on the host: each request to the
    least-loaded replica by pending pixels, first one on ties."""
    loads, ranks = [0] * replicas, []
    for res in resolutions:
        r = loads.index(min(loads))
        loads[r] += res * res
        ranks.append(r)
    return ranks


def dp_latents(engine: Engine, reqs: list, loads=None) -> dict:
    """Add ``reqs`` at once, serve them to the end; finite latents by id.
    ``loads`` receives each replica's pending pixels after the first
    step, which dispatches them."""
    engine.add_requests(reqs)
    outs = engine.step()
    if loads is not None:
        loads += [w.pending_pixels() for w in engine.workers]
    while engine.has_unfinished_requests():
        outs += engine.step()
    for o in outs:
        if not o.finished or not np.isfinite(o.image).all():
            raise AssertionError(f"bad output {o.request_id}")
    return {o.request_id: o.image for o in outs}


def dp_requests(resolutions) -> list:
    return [Request(f"dp-{i}", SamplingParams(
        prompt=f"a lighthouse, view {i}", resolution=res,
        num_inference_steps=STEPS, seed=100 + i, output_type="latent"))
        for i, res in enumerate(resolutions)]


def serve_dp(card: str, bundle: ModelBundle, devices: list,
             resolutions: list, spd: int = 1) -> tuple:
    """dp = len(devices) SD-1.5 replicas on ``devices`` (card indices,
    repeats allowed) behind the greedy dispatcher; the requests added at
    once.  Checks the dispatch against :func:`greedy_ranks`, that every
    replica serves, and each replica's latents bitwise against a dp = 1
    engine on that replica's card serving that replica's requests, both
    with ``steps_per_dispatch`` ``spd`` (above 1: chunks from step graphs
    captured on each replica's card).  Returns the launches of the dp run
    and the per-replica loads at dispatch."""
    config = default_config("sd15", dtype="bfloat16", seed=0)
    config.scheduler.steps_per_dispatch = spd
    config.parallel.dp = len(devices)
    config.parallel.devices = list(devices)
    engine = Engine(config, "cuda", bundle=bundle)
    want_dev = [torch.device("cuda", i) for i in devices]
    if [w.device for w in engine.workers] != want_dev:
        raise AssertionError(f"replicas on {[w.device for w in engine.workers]}")
    for w in engine.workers:
        shared = w.pipeline.bundle is bundle
        if shared != (w.device == torch.device("cuda", 0)):
            raise AssertionError(f"replica {w.rank} on {w.device}: bundle "
                                 f"shared {shared}")
    reqs, loads = dp_requests(resolutions), []
    reset_counts()
    t0 = time.perf_counter()
    latents = dp_latents(engine, reqs, loads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    ranks = [r.dp_rank for r in reqs]
    want = greedy_ranks(resolutions, len(devices))
    if ranks != want or set(ranks) != set(range(len(devices))):
        raise AssertionError(f"dispatch {ranks}, host greedy {want}")
    if got["k1"] == 0 or got["k5"] == 0 or got["k6"] == 0:
        raise AssertionError(f"dp launches {got}")
    for rank, dev in enumerate(devices):
        mine = [r for r, k in zip(reqs, ranks) if k == rank]
        one = default_config("sd15", dtype="bfloat16", seed=0)
        one.scheduler.steps_per_dispatch = spd
        one.parallel.devices = [dev]
        ref = dp_latents(Engine(one, "cuda", bundle=bundle), [
            Request(f"ref-{r.request_id}", dataclasses.replace(r.params))
            for r in mine])
        for r in mine:
            a, b = latents[r.request_id], ref[f"ref-{r.request_id}"]
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"replica {rank} (cuda:{dev}) {r.request_id}: max |dp - "
                    f"dp=1| {np.abs(a.astype(np.float64) - b).max():.3e}")
    print(f"dp={len(devices)} on cards {devices} (steps_per_dispatch "
          f"{spd}, graphs captured per replica "
          f"{[w.pipeline.graphs.captures for w in engine.workers]}): {len(reqs)} x "
          f"{sorted(set(resolutions))}^2 x {STEPS} steps in {wall:.3f} s; "
          f"greedy ranks {ranks}; pending pixels per replica at dispatch "
          f"{loads}; latents bitwise equal to dp=1 on each replica's card; "
          f"launches {got} [{card}]")
    return got, loads


def serve_dp2(card: str, bundle: ModelBundle) -> dict:
    """Two SD-1.5 replicas on one card (devices [0, 0], one shared
    bundle): :func:`serve_dp` on DP2_REQUESTS."""
    got, _ = serve_dp(card, bundle, DP2_DEVICES, DP2_REQUESTS)
    return got


def group_requests(resolutions, steps, tag: str) -> list:
    """``steps``: one count for every request, or a list, one a request."""
    counts = steps if isinstance(steps, list) else [steps] * len(resolutions)
    return [Request(f"{tag}-{i}", SamplingParams(
        prompt=f"a harbour at dawn, view {i}", resolution=res,
        num_inference_steps=n, seed=300 + i, output_type="latent"))
        for i, (res, n) in enumerate(zip(resolutions, counts))]


def time_denoise(pipe) -> list:
    """CUDA events around each denoise call of ``pipe`` (dense and mixed),
    on the engine's stream, which waits for every shard's."""
    rec = []
    for name in ("denoise_step", "denoise_step_mixed"):
        fn = getattr(pipe, name)

        def timed(by_res, fn=fn, name=name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(by_res)
            end.record()
            rec.append((name, start, end))
            return out

        setattr(pipe, name, timed)
    return rec


def serve_group(bundle: ModelBundle, family: str, resolutions, steps,
                tag: str, sp: int = 1, tp: int = 1, mixed: bool = False,
                cache=None, sp_mode: str = "gspmd", keep: bool = False,
                devices=None, record: bool = False) -> dict:
    """One Engine run of ``resolutions`` (added at once) on a replica over
    sp x tp devices (card indices ``devices``; by default card 0 of
    GROUP_DEVICES, repeated), or on one device.
    Returns the latents by request position, the launches (and each
    shard's), the mean step ms of the resolution-group steps (CUDA
    events), the pipeline's sync and stale step counts, its step modes,
    the most composition-state bytes each shard held after a step, and
    the calls of the kernels' plain versions (none on the card); with
    ``record`` every gate's selections (:func:`gate_picks`); with
    ``keep`` the pipeline too, its shard threads running (the caller
    closes its group)."""
    config = default_config(family, dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = mixed
    config.parallel.sp, config.parallel.tp = sp, tp
    config.parallel.sp_mode = sp_mode
    config.parallel.displaced_warmup = DISPLACED_WARMUP
    config.parallel.devices = (list(devices) if devices is not None
                               else [GROUP_DEVICES[0]] * (sp * tp))
    if cache is not None:
        config.cache = cache
    engine = Engine(config, "cuda", bundle=bundle)
    pipe = engine.workers[0].pipeline
    pipe.step_modes = []
    rec = time_denoise(pipe)
    held = [0] * (sp * tp)
    for name in ("denoise_step", "denoise_step_mixed"):
        fn = getattr(pipe, name)

        def watched(by_res, fn=fn):
            out = fn(by_res)
            held[:] = map(max, held, pipe.shard_state_bytes())
            return out

        setattr(pipe, name, watched)
    reqs = group_requests(resolutions, steps, tag)
    torch.cuda.synchronize()
    reset_counts()
    picks = gate_picks() if record else contextlib.nullcontext({})
    t0 = time.perf_counter()
    with plain_routes() as plain, picks as calls:
        lat = dp_latents(engine, reqs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    ms = [s.elapsed_time(e) for _, s, e in rec]
    out = {"latents": [lat[r.request_id] for r in reqs], "counts": counts,
           "shard_counts": shard_counts(sp * tp),
           "ms": float(np.mean(ms[1:] if len(ms) > 1 else ms)),
           "wall": wall, "steps": len(ms),
           "sync_stale": dict(pipe.displaced_steps),
           "modes": list(pipe.step_modes), "shard_bytes": held,
           "plain": dict(plain), "picks": dict(calls)}
    if keep:
        out["pipe"] = pipe
    elif pipe.group is not None:
        pipe.group.close()
    return out


def group_err(got, want) -> list:
    """Max |got - want| / max |want| per request."""
    return [float(np.abs(g.astype(np.float64) - w).max() / np.abs(w).max())
            for g, w in zip(got["latents"], want["latents"])]


def check_group_run(label: str, got, want, bound_rel: float, card: str,
                    launch_ratio=None, k6=None) -> None:
    """Print and check a group run against its single-device run: the
    latents within ``bound_rel``, finite, and (``launch_ratio``) every
    kernel launched that many times as often, each shard's forward
    launching what one device's does; ``k6``: K6's launches instead (a
    group over sp normalises through its shard context's moments: 0)."""
    errs = group_err(got, want)
    same = all(np.array_equal(g, w) for g, w in
               zip(got["latents"], want["latents"]))
    print(f"{label}: step {got['ms']:.2f} ms (single device "
          f"{want['ms']:.2f} ms; mean of {got['steps'] - 1} steps after the "
          f"first, CUDA events), wall {got['wall']:.2f} s; max err / max "
          f"|single| per request {[f'{e:.3e}' for e in errs]} (bound "
          f"{bound_rel:.3e}), bitwise equal: {same}; sync/stale "
          f"{got['sync_stale']}; launches {got['counts']} (single device "
          f"{want['counts']}) [{card}]")
    if not all(np.isfinite(g).all() for g in got["latents"]):
        raise AssertionError(f"{label}: latents not finite")
    if not all(np.isfinite(e) and e <= bound_rel for e in errs):
        raise AssertionError(f"{label} disagrees with one device: {errs}")
    if launch_ratio is not None:
        want_n = {k: launch_ratio * v for k, v in want["counts"].items()}
        if k6 is not None:
            want_n["k6"] = k6
        if got["counts"] != want_n:
            raise AssertionError(f"{label}: launches {got['counts']}, want "
                                 f"{launch_ratio} x one device's {want_n}")


def forward_err(got, want) -> float:
    """Max |got - want| / max |want| of one forward's outputs."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_replicas(pipe, model, args: tuple, kwargs: dict, label: str,
                   card: str) -> None:
    """One tensor-parallel forward through the pipeline's sharded
    denoiser: every shard's output (the replicated residual stream after
    the head) bitwise equal, and shard 0's within MOVED_MAX_REL of
    ``model``'s forward on one device (the row-parallel layers sum
    rounded bf16 partials: another summation order); then the same
    forward in float32 (``check_tp_float32``)."""
    den = pipe.denoiser
    den.keep_outputs = True
    with torch.inference_mode():
        den(*args, **kwargs)
        want = model(*args, **kwargs)
    torch.cuda.synchronize()
    outs = den.last_outputs
    den.keep_outputs, den.last_outputs = False, None
    check_shards(outs, want, MOVED_MAX_REL, label, card)
    del outs, want
    check_tp_float32(pipe, model, args, kwargs, label, card)


def check_shards(outs: list, want, bound: float, label: str,
                 card: str) -> None:
    """Every shard's output bitwise equal, and shard 0's within ``bound``
    of ``want`` (max error / max |want|)."""
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    err = forward_err(outs[0], want)
    print(f"{label}: the {len(outs)} shards' outputs bitwise equal: {same}; "
          f"max err / max |one device| {err:.3e} (bound {bound:.3e}) "
          f"[{card}]")
    if not same or not err <= bound:
        raise AssertionError(f"{label}: shards differ ({same}) or the "
                             f"forward is off one device's ({err})")


def check_tp_float32(pipe, model, args: tuple, kwargs: dict, label: str,
                     card: str) -> None:
    """The tp forward's sharding alone: ``model`` in float32, sharded over
    the pipeline's group, against the float32 model on one device within
    TP_FLOAT32_MAX_REL, the attention of both on its kernels' plain
    versions (the kernels take bf16).  No partial is rounded to bf16
    before the psum, so only the order of float32 sums differs."""
    from sduss_tpu_torch.parallel.sharding import ShardedDenoiser

    def f32(v):
        if isinstance(v, dict):
            return {k: f32(x) for k, x in v.items()}
        return v.float() if torch.is_floating_point(v) else v

    model32 = copy.deepcopy(model).float()
    den = ShardedDenoiser(model32, pipe.group)
    den.keep_outputs = True
    args32, kwargs32 = [f32(a) for a in args], f32(kwargs)
    with plain_attention(), torch.inference_mode():
        den(*args32, **kwargs32)
        want = model32(*args32, **kwargs32)
    torch.cuda.synchronize()
    check_shards(den.last_outputs, want, TP_FLOAT32_MAX_REL,
                 f"{label}, float32 (plain attention)", card)
    del den, model32, want
    gc.collect()
    torch.cuda.empty_cache()


def serve_tp2(card: str, bundle: ModelBundle) -> list:
    """SDXL tp=2 on devices [0, 0]: the dense 2 x 1024^2 pair and the
    768^2 + 1024^2 patch batch, cache off and under production("sdxl"),
    each against the single-device run (GROUP_MAX_REL) with every kernel
    launched exactly twice as often (each shard's forward launches what
    one device's does, at its local heads and channels); the shards'
    outputs bitwise equal; K4 at a shard's norm2 (C / 2, 16 groups) in
    phase 3's kernel checks.  Returns the launches of every run and the
    single-device runs (``(path, cache label)``: serve_sp2's and
    serve_sp2_paths' references, with their gate selections)."""
    runs, refs = [], {}
    for cache_label, cache in (("cache-off", None),
                               ("production", CacheConfig.production("sdxl"))):
        for mixed, res in ((False, GROUP_DENSE), (True, GROUP_MIXED)):
            path = "mixed" if mixed else "dense"
            one = serve_group(bundle, "sdxl", res, GROUP_STEPS,
                              f"tp1-{path}-{cache_label}", mixed=mixed,
                              cache=cache, record=cache is not None)
            refs[path, cache_label] = one
            first = cache is None and not mixed
            two = serve_group(bundle, "sdxl", res, GROUP_STEPS,
                              f"tp1-{path}-{cache_label}", tp=2, mixed=mixed,
                              cache=cache, keep=first)
            check_group_run(f"serve_tp2 SDXL {path} {res} x {GROUP_STEPS} "
                            f"steps, {cache_label}, tp=2 on {GROUP_DEVICES}",
                            two, one, GROUP_MAX_REL, card, launch_ratio=2)
            if mixed and two["counts"]["k4"] == 0:
                raise AssertionError("serve_tp2: the patch path ran no K4")
            if two["modes"] != one["modes"]:
                raise AssertionError(f"serve_tp2 modes {two['modes']} vs "
                                     f"{one['modes']}")
            if first:
                pipe = two.pop("pipe")
                gen = torch.Generator(device="cuda").manual_seed(5)
                x = torch.randn(4, 128, 128, 4, generator=gen,
                                device="cuda").to(torch.bfloat16)
                ehs = torch.randn(4, 77, 2048, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                added = {"text_embeds": torch.randn(
                    4, 1280, generator=gen, device="cuda").to(torch.bfloat16),
                    "time_ids": torch.tensor([[1024.0] * 2 + [0.0] * 2
                                              + [1024.0] * 2] * 4,
                                             device="cuda")}
                check_replicas(pipe, bundle.models["unet"],
                               (x, torch.full((4,), 500.0, device="cuda"),
                                ehs), {"added_cond": added},
                               "serve_tp2 SDXL 2 x 1024^2 CFG forward", card)
                pipe.group.close()
                del pipe
            runs += [one["counts"], two["counts"]]
    return runs, refs


def expected_displaced(steps: int, warmup: int, interval=None,
                       deep_warmup: int = 0) -> tuple:
    """The sp step's modes and sync/stale counts for one composition over
    ``steps`` (pipelines/base.py _denoise_group_displaced): full steps
    always sync, each mode's first step sync, then stale once
    ``warmup`` steps of the composition have run."""
    modes, kv, deep, age = [], set(), None, 0
    counts = {"sync": 0, "stale": 0}
    for step in range(steps):
        mode = None
        if interval is not None:
            full = deep is None or age >= interval - 1 or step < deep_warmup
            mode = "full" if full else "shallow"
            modes.append(mode)
            deep, age = (1, 0) if full else (deep, age + 1)
        stale = mode != "full" and step >= warmup and mode in kv
        counts["stale" if stale else "sync"] += 1
        kv.add(mode)
    return modes, counts


def serve_sp2(card: str, bundle: ModelBundle, ref_dense: dict) -> list:
    """SDXL 2 x 1024^2 under sp=2 on devices [0, 0], mixed batches off:
    sp_mode "gspmd" (every step sync) within GROUP_MAX_REL of one device
    (tp phase's run) and launching twice as often; "displaced" over
    DISPLACED_STEPS (DISPLACED_WARMUP sync steps, then stale) within
    DISPLACED_MAX_REL of one device's trajectory; then the plain
    fixed-interval deep cache on the displaced seam against one device
    under the same cache (modes and sync/stale counts as expected)."""
    runs = []
    sync = serve_group(bundle, "sdxl", GROUP_DENSE, GROUP_STEPS, "tp1-dense-"
                       "cache-off", sp=2)
    check_group_run(f"serve_sp2 SDXL {GROUP_DENSE} x {GROUP_STEPS} steps, "
                    f"sp=2 gspmd on {GROUP_DEVICES}", sync, ref_dense,
                    GROUP_MAX_REL, card, launch_ratio=2, k6=0)
    runs.append(sync["counts"])
    for label, cache, interval in (
            ("cache-off", None, None),
            ("plain deep", CacheConfig(enabled=True, mode="deep",
                                       **DISPLACED_DEEP),
             DISPLACED_DEEP["deep_interval"])):
        one = serve_group(bundle, "sdxl", GROUP_DENSE, DISPLACED_STEPS,
                          f"sp-disp-{label}", cache=cache)
        disp = serve_group(bundle, "sdxl", GROUP_DENSE, DISPLACED_STEPS,
                           f"sp-disp-{label}", sp=2, sp_mode="displaced",
                           cache=cache)
        check_group_run(f"serve_sp2 SDXL {GROUP_DENSE} x {DISPLACED_STEPS} "
                        f"steps, {label}, sp=2 displaced (warmup "
                        f"{DISPLACED_WARMUP}) on {GROUP_DEVICES}", disp, one,
                        DISPLACED_MAX_REL, card)
        modes, counts = expected_displaced(
            DISPLACED_STEPS, DISPLACED_WARMUP, interval,
            DISPLACED_DEEP["deep_warmup"])
        if disp["sync_stale"] != counts or disp["modes"] != modes \
                or one["modes"] != modes:
            raise AssertionError(
                f"serve_sp2 {label}: sync/stale {disp['sync_stale']} modes "
                f"{disp['modes']}, want {counts} {modes} (one device "
                f"{one['modes']})")
        runs += [one["counts"], disp["counts"]]
    return runs


@contextlib.contextmanager
def plain_attention():
    """Every attention of the dispatcher on its kernel's plain version
    (float32 softmax; a calibration of how far another summation order
    moves the serving latents)."""
    names = ("flash_mha_fused", "flash_mha", "flash_mha_masked",
             "flash_cross_short")
    saved = {n: getattr(attention_mod, n) for n in names}
    attention_mod.flash_mha_fused = flash_mha_fused_reference
    attention_mod.flash_mha = (lambda q, k, v, h, s:
                               flash_mha_reference(q, k, v, h, s))
    attention_mod.flash_mha_masked = flash_mha_masked_reference
    attention_mod.flash_cross_short = flash_cross_short_reference
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(attention_mod, n, fn)


def sd3_inputs(seed: int) -> tuple:
    """A CFG-doubled 2 x 1024^2 SD3.5-medium forward's inputs, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(4, 128, 128, 16, generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([900.0, 900.0, 400.0, 400.0], device="cuda")
    ehs = torch.randn(4, SD3_CTX, 4096, generator=gen,
                      device="cuda").to(torch.bfloat16)
    pooled = torch.randn(4, 2048, generator=gen,
                         device="cuda").to(torch.bfloat16)
    return x, t, ehs, pooled


def sp_forward(pipe, args: tuple, kv_mode: str):
    """One MMDiT forward of ``args`` on the pipeline's sp row shards
    (``MMDiTShardContext``), the rows gathered back."""
    from sduss_tpu_torch.parallel.displaced import (MMDiTShardContext,
                                                    gather_rows, shard_rows)

    group, den = pipe.group, pipe.denoiser
    x, rest = args[0], args[1:]
    with torch.inference_mode():
        outs = group.run(lambda r: den(
            shard_rows(x, group, "sp", 1, r), *rest,
            ctx=MMDiTShardContext(group, kv_mode=kv_mode)))
    return gather_rows(outs, group, 1, x.device)


def serve_sd3_sp2(card: str, bundle: ModelBundle) -> list:
    """SD3.5-medium 2 x 1024^2, mixed batches off, on devices [0, 0]: one
    forward under sp=2 with the latent K/V gathered within GROUP_MAX_REL
    of one device's, and with them rotated around the ring
    (``MMDiTShardContext(kv_mode="ring")``: float32 PyTorch math,
    parallel/ring.py, no kernel; a library seam the Engine does not
    serve) within MOVED_MAX_REL, printed beside one device's forward with
    its attention on the plain versions; under tp=2 the shards bitwise
    equal and within MOVED_MAX_REL, and in float32 within
    TP_FLOAT32_MAX_REL (``check_replicas``); the 4-step trajectories
    under sp=2 gather within GROUP_MAX_REL of one device and under tp=2
    (its dual attention's 6 MiB K row goes to K1) within MOVED_MAX_REL,
    printed beside how far one device's trajectory moves with its
    attention on the plain versions, each launching every attention
    twice as often; then ``MMDiTStagePipeline`` with two stages on
    [0, 0] bitwise equal to the single-device forward (one microbatch,
    and two against the single-device forward of each)."""
    from sduss_tpu_torch.parallel.pipeline import MMDiTStagePipeline

    model = bundle.models["transformer"]
    runs = []
    one = serve_group(bundle, "sd3", GROUP_DENSE, SD3_GROUP_STEPS, "sd3-g")
    runs.append(one["counts"])
    attn = sum(one["counts"].values())
    with plain_attention():
        plain = serve_group(bundle, "sd3", GROUP_DENSE, SD3_GROUP_STEPS,
                            "sd3-g")
    print(f"serve_sd3_sp2 calibration: one device with the plain attention "
          f"versions, max err / max |kernels| per request "
          f"{[f'{e:.3e}' for e in group_err(plain, one)]}; step "
          f"{plain['ms']:.2f} ms [{card}]")
    args = sd3_inputs(6)
    with torch.inference_mode():
        want = model(*args)
        with plain_attention():
            want_plain = model(*args)
    for label, kw in (("sp=2 gather", dict(sp=2)), ("tp=2", dict(tp=2))):
        got = serve_group(bundle, "sd3", GROUP_DENSE, SD3_GROUP_STEPS,
                          "sd3-g", keep=True, **kw)
        pipe = got.pop("pipe")
        exact = label == "sp=2 gather"
        if not exact:
            check_replicas(pipe, model, args, {}, "serve_sd3_sp2 "
                           "SD3.5-medium 2 x 1024^2 CFG forward, tp=2", card)
        else:
            for kv_mode, bound in (("gather", GROUP_MAX_REL),
                                   ("ring", MOVED_MAX_REL)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = sp_forward(pipe, args, kv_mode)
                end.record()
                torch.cuda.synchronize()
                err = forward_err(out, want)
                print(f"serve_sd3_sp2 SD3.5-medium 2 x 1024^2 CFG forward, "
                      f"sp=2 {kv_mode}: {start.elapsed_time(end):.2f} ms; "
                      f"max err / max |one device| {err:.3e} (bound "
                      f"{bound:.3e}); vs one device with the plain "
                      f"attention versions {forward_err(out, want_plain):.3e}"
                      f" [{card}]")
                if not err <= bound:
                    raise AssertionError(f"serve_sd3_sp2 sp=2 {kv_mode} "
                                         f"forward: {err}")
        pipe.group.close()
        del pipe
        check_group_run(f"serve_sd3_sp2 SD3.5-medium {GROUP_DENSE} x "
                        f"{SD3_GROUP_STEPS} steps, {label} on "
                        f"{GROUP_DEVICES}", got, one,
                        GROUP_MAX_REL if exact else MOVED_MAX_REL, card)
        if not exact:
            print(f"serve_sd3_sp2 {label} vs one device with the plain "
                  f"attention versions: "
                  f"{[f'{e:.3e}' for e in group_err(got, plain)]} [{card}]")
        # each shard launches one device's attentions (tp moves the dual
        # attention's 6 MiB K row from flash_mha to K1)
        n = sum(got["counts"].values())
        if n != 2 * attn:
            raise AssertionError(f"serve_sd3_sp2 {label}: {n} attention "
                                 f"launches, one device {attn}")
        runs.append(got["counts"])
    x, t, ehs, pooled = sd3_inputs(7)
    with torch.inference_mode():
        want = model(x, t, ehs, pooled)
        halves = torch.cat([model(x[i:i + 2], t[i:i + 2], ehs[i:i + 2],
                                  pooled[i:i + 2]) for i in (0, 2)])
    for n_micro, ref in ((1, want), (2, halves)):
        stages = MMDiTStagePipeline(model, ["cuda:0"] * 2, n_micro=n_micro)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = stages(x, t, ehs, pooled)
        end.record()
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        print(f"serve_sd3_sp2 MMDiTStagePipeline 2 stages {stages.spans} on "
              f"cuda:0, {n_micro} microbatch(es) of the CFG 2 x 1024^2 "
              f"batch: bitwise equal to the single-device forward: {same}; "
              f"{start.elapsed_time(end):.2f} ms [{card}]")
        if not same:
            raise AssertionError("MMDiTStagePipeline differs from the "
                                 "single-device forward")
    return runs


# PR 15's one-device step ms on the H100 80GB HBM3 at 700 W (PERF.md):
# the group runs below print beside them
PR15_ONE_DEVICE_MS = {"SDXL 768^2 + 1024^2": 137.43,
                      "production dense": 41.71, "production mixed": 48.31,
                      "SD3 2 x 1024^2": 189.64}
SD3_GROUP_MIXED = [512, 1024]


def check_paths_run(label: str, got, one, card: str, pr15: str,
                    per_shard: dict) -> None:
    """A group run against its single-device run (``check_group_run`` at
    GROUP_MAX_REL, the same deep modes), printed beside PR 15's
    one-device step ms, with the share of gate decisions equal to one
    device's, each shard's launches and state bytes; ``per_shard``:
    ``{kernel: "equal"}`` (each shard launches one device's count) or
    ``{kernel: "some"}`` (each shard launches it at least once: at sp=4,
    where a shard may hold no query patch of a class).  No launch takes
    a kernel's plain version."""
    check_group_run(label, got, one, GROUP_MAX_REL, card)
    eq, total = equal_picks(one["picks"].get(0, []),
                            got["picks"].get(0, []))
    modes_eq = sum(a == b for a, b in zip(got["modes"], one["modes"]))
    print(f"{label}: PR 15 one device {PR15_ONE_DEVICE_MS[pr15]:.2f} ms "
          f"({pr15}, H100 80GB HBM3, 700 W); gate decisions equal to one "
          f"device's: {eq}/{total}, deep modes {modes_eq}/"
          f"{len(one['modes'])}; each shard's launches "
          f"{got['shard_counts']}; each shard's state bytes (most after a "
          f"step) {got['shard_bytes']} (one device {one['shard_bytes']}) "
          f"[{card}]")
    if got["modes"] != one["modes"]:
        raise AssertionError(f"{label}: modes {got['modes']} vs one "
                             f"device's {one['modes']}")
    if got["plain"] or one["plain"]:
        raise AssertionError(f"{label}: plain versions ran: {got['plain']} "
                             f"{one['plain']}")
    for r, counts in enumerate(got["shard_counts"]):
        for key, rule in per_shard.items():
            n, want = counts[key], one["counts"][key]
            if (rule == "equal" and n != want) or (rule == "some"
                                                    and not 0 < n):
                raise AssertionError(
                    f"{label}: shard {r} launched {key} {n} times (one "
                    f"device {want}, rule {rule!r})")


def serve_sp2_paths(card: str, bundle: ModelBundle, refs: dict) -> list:
    """SDXL under sp=2 on devices [0, 0] on what the group serves beyond
    the dense cache-off step: the 768^2 + 1024^2 patch batch cache-off and
    under production("sdxl"), and the dense 2 x 1024^2 pair under
    production("sdxl"), 8 steps each, against the single-device runs of
    serve_tp2 (``check_paths_run``).  Each shard launches one device's
    K4, masked attention (K2b/K3a) and K5 on the patch batch, under the
    gates too (their sub-batches split over the shards), and one
    device's K1 and K5 on the dense pair."""
    runs = []
    for path, cache_label, res in (("mixed", "cache-off", GROUP_MIXED),
                                   ("mixed", "production", GROUP_MIXED),
                                   ("dense", "production", GROUP_DENSE)):
        one = refs[path, cache_label]
        cache = (CacheConfig.production("sdxl") if cache_label
                 == "production" else None)
        got = serve_group(bundle, "sdxl", res, GROUP_STEPS,
                          f"tp1-{path}-{cache_label}", sp=2,
                          mixed=path == "mixed", cache=cache,
                          record=cache is not None)
        rule = dict.fromkeys(("k4", "masked", "k5") if path == "mixed"
                             else ("k1", "k5"), "equal")
        pr15 = ("SDXL 768^2 + 1024^2" if cache is None
                else f"production {path}")
        check_paths_run(f"serve_sp2_paths SDXL {path} {res} x {GROUP_STEPS}"
                        f" steps, {cache_label}, sp=2 on {GROUP_DEVICES}",
                        got, one, card, pr15, rule)
        runs += [got["counts"]]
    return runs


def serve_sd3_sp2_paths(card: str, bundle: ModelBundle) -> list:
    """SD3.5-medium 512^2 + 1024^2 on the padded-token path under sp=2 on
    devices [0, 0] (the tokens and their mask split over the shards, the
    padded keys masked in every attention): production("sd3") and the
    fine token gate at patch_fraction 0.5 with its stale K/V, 4 steps,
    against one device (``check_paths_run``); each shard launches one
    device's masked attentions (K2b/K3a)."""
    runs = []
    fine = CacheConfig(enabled=True, mode="compact", patch_fraction=0.5,
                       fine_stale_kv=True)
    for label, cache in (("production", CacheConfig.production("sd3")),
                         ("fine token gate 0.5", fine)):
        one = serve_group(bundle, "sd3", SD3_GROUP_MIXED, SD3_GROUP_STEPS,
                          "sd3-p", mixed=True, cache=cache, record=True)
        got = serve_group(bundle, "sd3", SD3_GROUP_MIXED, SD3_GROUP_STEPS,
                          "sd3-p", sp=2, mixed=True, cache=cache,
                          record=True)
        check_paths_run(f"serve_sd3_sp2_paths SD3.5-medium {SD3_GROUP_MIXED}"
                        f" x {SD3_GROUP_STEPS} steps, {label}, sp=2 on "
                        f"{GROUP_DEVICES}", got, one, card, "SD3 2 x 1024^2",
                        {"masked": "equal"})
        runs += [one["counts"], got["counts"]]
    return runs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    configure_numerics()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    spy_decoders()

    t0 = time.perf_counter()
    built = _build.build()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {built.seconds:.1f} s) -> {built.path.name}")
    for line in built.log.splitlines():
        if "ptxas info" in line:
            print(line.strip())
    check_ptxas(built.log)

    k1 = check_k1(card)
    k2a = check_k2a(card)
    masked = check_masked(card)
    masked_fine = check_masked_fine(card)
    masked["max_abs_err"] = max(masked["max_abs_err"],
                                masked_fine["max_abs_err"])
    k4 = check_k4(card)
    k4_sd15 = check_k4(card, mixed_meta("sd15", SD15_MIXED_REQUESTS),
                       SD15_K4_SHAPES, seed=7)
    # the gated sub-compositions of the mixed deep shallow steps (SDXL:
    # 50 patches of 768^2 + 3 x 1024^2; SD-1.5: 26 of 4 x 512^2 + 768^2)
    k4_sub = check_k4(card, sub_meta("sdxl", MIXED_REQUESTS), SUB_K4_SHAPES,
                      seed=8)
    k4_sub_sd15 = check_k4(card, sub_meta("sd15", MIXED_SD15_FIRST
                                          + [MIXED_SD15_LATE]),
                           SUB_K4_SHAPES, seed=9)
    # mode "compact"'s sub-composition of SDXL's serving mix
    k4_compact = check_k4(card, compact_sub_meta(), COMPACT_K4_SHAPES,
                          seed=10)
    # a tp=2 shard's norm2 on SDXL's patch batch: C / 2 over 16 groups
    k4_tp2 = check_k4(card, shapes=K4_TP2_SHAPES, seed=11, groups=16)
    k4["max_abs_err"] = max(k4["max_abs_err"], k4_sd15["max_abs_err"],
                            k4_sub["max_abs_err"], k4_sub_sd15["max_abs_err"],
                            k4_compact["max_abs_err"],
                            k4_tp2["max_abs_err"])
    k5 = check_k5(card)
    k6 = check_k6(card)
    check_block()
    check_sd3_block()
    check_sd15_block()
    bundle = build_bundle()
    check_k6_launches(card, bundle)
    check_patched(bundle)
    runs = [serve(card, bundle), serve_mixed(card, bundle)]
    check_deep_invariant(bundle, card)
    runs += serve_sdxl_deep(card, bundle)
    check_mixed_deep_invariant(bundle, card)
    runs += serve_sdxl_mixed_deep(card, bundle)
    runs += serve_sdxl_chunked(card, bundle)
    block_runs, off_latents, off_ms = serve_sdxl_block(card, bundle)
    runs += block_runs
    runs += serve_sdxl_compact(card, bundle, off_latents, off_ms)
    runs += train_classifiers(card, bundle)
    runs += serve_api_cache(card)
    check_vae_dtype(card, bundle)
    runs.append(serve_http(card, bundle))
    runs.append(replay_sdxl(card, bundle))
    tp_runs, refs = serve_tp2(card, bundle)
    runs += tp_runs
    runs += serve_sp2(card, bundle, refs["dense", "cache-off"])
    runs += serve_sp2_paths(card, bundle, refs)
    del refs
    # free each bundle so each family's peak memory reads alone
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    sd3 = build_sd3_bundle()
    runs += [serve_sd3(card, sd3), serve_sd3_mixed(card, sd3)]
    runs += serve_sd3_deep(card, sd3)
    runs += serve_sd3_chunked(card, sd3)
    runs += serve_sd3_sp2(card, sd3)
    runs += serve_sd3_sp2_paths(card, sd3)
    del sd3
    gc.collect()
    torch.cuda.empty_cache()
    sd15 = build_bundle("sd15")
    check_patched(sd15, SD15_MIXED_REQUESTS)
    runs += [
        serve_sd15(card, sd15, False, "euler", STEPS, SD15_REQUESTS),
        serve_sd15(card, sd15, True, "euler", STEPS, SD15_MIXED_REQUESTS),
        serve_sd15(card, sd15, True, "pndm", SD15_SAMPLER_STEPS,
                   SD15_MIXED_REQUESTS),
        serve_sd15(card, sd15, False, "ddim", SD15_SAMPLER_STEPS,
                   SD15_REQUESTS),
        serve_sd15(card, sd15, False, "euler", STEPS, [512] * 3,
                   async_prepare=True),
        serve_sd15_rowwarm(card, sd15),
        *serve_sd15_chunked(card, sd15),
        serve_sd15_mixed_deep(card, sd15),
        serve_sd15_snapshot(card, sd15),
        serve_dp2(card, sd15),
    ]
    del sd15
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(profile_h100(card))
    # launches: the sum over the serving paths, each read just after its run
    launches = {key: sum(r[key] for r in runs) for key in runs[0]}
    print(f"launches on the serving paths: {launches}")
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s [{card}]")

    kernels = [
        ("flash_mha_fused", "sduss_tpu_torch/csrc/flash_fused.cu",
         "sduss_tpu/ops/flash.py:373", launches["k1"], k1, K1_SHAPES[0]),
        ("flash_mha", "sduss_tpu_torch/csrc/flash_fused.cu",
         "sduss_tpu/ops/flash.py:570", launches["flash_mha"], k2a,
         K2A_SHAPES[1]),
        ("flash_mha_masked", "sduss_tpu_torch/csrc/flash_fused.cu",
         "sduss_tpu/ops/flash.py:579", launches["masked"], masked,
         MASKED_SHAPES[0]),
        ("gn_silu_halo", "sduss_tpu_torch/csrc/gn_halo.cu",
         "sduss_tpu/ops/gn_halo.py:196", launches["k4"], k4,
         (mixed_meta().p_pad,) + K4_SHAPES[0]),
        ("flash_cross_short", "sduss_tpu_torch/csrc/flash_cross.cu",
         "sduss_tpu/ops/flash.py:421", launches["k5"], k5, K5_SHAPES[2]),
        ("gn_dense", "sduss_tpu_torch/csrc/gn_dense.cu",
         "none (XLA fuses sduss_tpu/models/layers.py group_norm)",
         launches["k6"], k6, (K6_UNET_SHAPES[0], "bfloat16")),
    ]
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": res["max_abs_err"],
         **res["times"][shape]}
        for name, src, rep, n, res, shape in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
