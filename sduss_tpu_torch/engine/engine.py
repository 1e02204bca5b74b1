"""Serving engine over dp replicas (counterpart of
sduss_tpu/engine/engine.py).

The engine holds one ``Worker`` per data-parallel replica, each on its own
device or its own ``sp * tp`` devices (``parallel/replica.py``:
consecutive cards from ``cuda:0``, an explicit ``ParallelConfig.devices``
list that may repeat a card, or the CPU); a replica over more than one
device serves its denoiser over a ``ShardGroup``.
``step()`` hands the waiting requests to the replicas through the
dispatch policy (``dispatcher/``: greedy over the workers'
``pending_pixels`` by default) and runs one iteration on every replica in
turn, on this thread, as the JAX engine does.  ``add_request()``,
``abort_requests()`` and ``has_unfinished_requests()`` keep the JAX
engine's semantics over all replicas; ``abort_requests`` also reaches
requests parked in PREPARING or DECODING while a worker thread runs their
stage.  Replicas on one device share one ``ModelBundle``; a replica on
another card serves a copy of the same weights.  There is no compilation
cache: eager PyTorch compiles nothing ahead of a step.  ``prewarm``
builds the kernels and, with ``steps_per_dispatch > 1``, captures the
step graphs that chunks replay (``pipelines/graphs.py``), replica by
replica.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.dispatcher import get_dispatch_policy
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.metrics import EngineStats
from sduss_tpu_torch.request import Request, RequestOutput, SamplingParams, Stage
from sduss_tpu_torch import configure_numerics, tracing
from sduss_tpu_torch.engine.worker import Worker
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.parallel.replica import (build_placements, canonical,
                                              check_group, on_device)
from sduss_tpu_torch.pipelines import build_pipeline

logger = init_logger(__name__)


def check_supported(config: Config) -> None:
    """Raise, when the Engine is built, for configurations whose code paths
    are not ported yet, naming the ROADMAP item that ports them.

    Every cache of the JAX package is served.  The UNet families (sd15,
    sdxl) run the deep cache (``mode="deep"``, with its adaptive refresh,
    prediction, row warmup and CFG-pair hybrid) on dense batches and, with
    ``use_mixed_resolution``, on the patch path, so each
    ``CacheConfig.production`` preset of those families runs as it is;
    mode "block" on the patch path (on the dense path it is cache-off, as
    in JAX), and mode "compact" on both paths, with two-level patch rows at
    ``patch_fraction < 1``.  SD3 serves the span-skip deep cache
    (``sd3_deep_span``, both ``production("sd3")`` presets) and the token
    caches, modes "block" and "compact" (the per-token fine gate at
    ``patch_fraction < 1``, with ``fine_stale_kv``), alone or together, on
    its token path.  As in JAX, an SD3 config with ``mode="deep"`` and no
    ``sd3_deep_span`` mints no cache at all, and the UNet families ignore
    ``sd3_deep_span``.  ``steps_per_dispatch`` above 1 runs fused
    multi-step chunks (captured step graphs on the card) and
    ``engine.prewarm`` warms them.  ``dp`` replicas are served, two or
    more on one card included, and each replica may span an ``sp x tp``
    group of devices: ``tp`` and ``sp`` on every path and cache (the
    patch batch and SD3's token path included).  What is refused
    (``parallel/replica.py check_group``): ``pp > 1``, which the Engine
    does not route (``MMDiTStagePipeline`` is driven directly)."""
    check_group(config)


class Engine:
    """``device`` is the engine's device (``cuda``, ``cuda:N`` or ``cpu``),
    from which ``build_placements`` places the replicas; ``bundle``, when
    given, serves the replicas on its device and is copied to any other."""

    def __init__(self, config: Config, device: torch.device | str,
                 bundle: Optional[ModelBundle] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "explicitly to run on the CPU")
        check_supported(config)
        configure_numerics()
        tracing.enable(config.engine.collect_data)
        self.config = config
        par = config.parallel
        placements = build_placements(par.dp, par.sp, par.tp, par.devices,
                                      device)
        bundles: Dict[torch.device, ModelBundle] = {}
        if bundle is not None:
            bundles[canonical(bundle.device)] = bundle
        self.workers: List[Worker] = []
        for rank, devs in enumerate(placements):
            lead = devs[0]
            b = bundles.get(lead)
            if b is None and bundles:
                b = next(iter(bundles.values())).replicate(lead)
            pipe = build_pipeline(config, devs, bundle=b)
            bundles.setdefault(lead, pipe.bundle)
            self.workers.append(Worker(rank, pipe, config))
        self.dispatch_policy = get_dispatch_policy(
            config.engine.dispatcher_policy)
        self._waiting: List[Request] = []
        self._known: Dict[str, int] = {}  # request id -> dp rank (-1 waiting)
        self.stats = EngineStats()

    # -- request API ---------------------------------------------------------

    def add_requests(self, reqs: Sequence[Request]) -> None:
        with tracing.span("engine.add", reqs):
            for req in reqs:
                if req.request_id in self._known:
                    raise ValueError(f"duplicate request id {req.request_id}")
                self._known[req.request_id] = -1
                self._waiting.append(req)
                self.stats.on_arrival(req)

    def add_request(self, request_id: str, params: SamplingParams,
                    deadline: Optional[float] = None) -> Request:
        req = Request(request_id, params, deadline=deadline)
        self.add_requests([req])
        return req

    def abort_requests(self, request_ids: Sequence[str]) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        with tracing.span("engine.abort", outs):
            self._abort(set(request_ids), outs)
        return outs

    def _abort(self, ids: set, outs: List[RequestOutput]) -> None:
        still_waiting = []
        for req in self._waiting:
            if req.request_id in ids:
                req.stage = Stage.ABORTED
                req.finish_time = time.time()
                self._known.pop(req.request_id, None)
                outs.append(RequestOutput.from_request(req))
                ids.discard(req.request_id)
            else:
                still_waiting.append(req)
        self._waiting = still_waiting
        for worker in self.workers:
            for req in worker.abort_requests(list(ids)):
                self._known.pop(req.request_id, None)
                outs.append(RequestOutput.from_request(req))
                ids.discard(req.request_id)
        for out in outs:
            self.stats.on_finish(out)

    def has_unfinished_requests(self) -> bool:
        return bool(self._waiting) or any(w.has_unfinished()
                                          for w in self.workers)

    # -- main loop -----------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        """Dispatch the waiting requests over the replicas (each request's
        ``dp_rank``), run one iteration on each replica, collect finished
        outputs (JAX engine.py:118-139)."""
        with tracing.span("engine.step"):
            return self._step()

    def _step(self) -> List[RequestOutput]:
        if self._waiting:
            loads = [w.pending_pixels() for w in self.workers]
            ranks = self.dispatch_policy.assign(self._waiting, loads)
            per_rank: Dict[int, List[Request]] = {}
            for req, rank in zip(self._waiting, ranks):
                per_rank.setdefault(rank, []).append(req)
                self._known[req.request_id] = rank
            for rank, reqs in per_rank.items():
                self.workers[rank].add_requests(reqs)
            self._waiting = []

        outputs: List[RequestOutput] = []
        for worker in self.workers:
            for req in worker.step():
                self._known.pop(req.request_id, None)
                out = RequestOutput.from_request(req)
                self.stats.on_finish(out)
                outputs.append(out)
        return outputs

    # -- prewarm -------------------------------------------------------------

    def prewarm(self, resolutions: Optional[Sequence[int]] = None,
                buckets: Optional[Sequence[int]] = None,
                steps: Optional[int] = None,
                compositions: Optional[Sequence[Dict[int, int]]] = None
                ) -> float:
        """Warm every (resolution x batch bucket) step ahead of serving
        with throwaway requests (JAX engine.py:141-199); returns the
        elapsed seconds and resets the engine's stats.

        Each pair up to ``max_batch_size`` runs ``steps`` per-step steps
        (with a deep or span cache, by default enough for the full and the
        shallow kinds: warmup + interval + 1), releases its state and
        decodes.  Then, pair by pair, with ``steps_per_dispatch > 1`` a
        second set of requests runs to its end in chunks, capturing each
        step kind its trajectory reaches (``_prewarm_chunk``), and with the
        row warmup the partial kinds of every row bucket below the batch's
        (``_prewarm_partial``); the step sets keep their rows and graphs
        for serving as far as ``comp_state_bytes`` allows.
        ``compositions``, mixed batches ``{res: count}``, run the patch
        path and its chunks; none is enumerated here (JAX's "auto" is not
        ported).  ``resolutions`` and ``buckets`` default to the config's;
        an empty list warms no uniform batch.  The adaptive refresh's drift
        threshold is pinned at inf, so that both kinds run.  A bucket whose
        state does not fit the card (:meth:`_bucket_fits`), or that runs
        out of memory, caps ``max_batch_size`` at the previous bucket."""
        if isinstance(compositions, str):
            raise NotImplementedError(
                "compositions='auto' (enumerate_mixed_compositions) is not "
                "ported: pass the mixed batches to warm as a list")
        t0 = time.time()
        cc = self.config.cache
        interval = max(cc.deep_max_interval if cc.deep_adaptive
                       else cc.deep_interval, 1)
        if steps is None:
            steps = 2
            if cc.enabled and (cc.mode == "deep"
                               or cc.sd3_deep_span is not None):
                steps = cc.deep_warmup + interval + 1
            if self.config.parallel.sp_mode == "displaced":
                # both the sync and the stale step (JAX engine.py:183-185)
                steps = max(steps, self.config.parallel.displaced_warmup + 1)
        saved = cc.deep_drift_threshold
        if cc.enabled and cc.mode == "deep" and cc.deep_adaptive:
            cc.deep_drift_threshold = float("inf")
        try:
            self._prewarm_inner(
                self.config.model.resolutions if resolutions is None
                else resolutions, buckets, steps, compositions or ())
        finally:
            cc.deep_drift_threshold = saved
        self.stats = EngineStats()
        dt = time.time() - t0
        logger.info("prewarm: %.1f s, %d step graphs captured", dt,
                    sum(w.pipeline.graphs.captures for w in self.workers))
        return dt

    def _prewarm_inner(self, res_list, buckets, steps: int,
                       compositions) -> None:
        """Each replica's pipeline in turn (JAX engine.py:407, :495: a
        dispatch through the engine would split a bucket over the
        replicas), under its device.  Two passes over (resolution x
        bucket): first the per-step steps and the decode of each pair,
        each decode after a release, so that no row state sits beside it;
        then the chunks and partial steps, whose step sets keep their row
        buffers and graphs for serving within ``comp_state_bytes`` (those
        runs end with their throwaway requests' eviction, not a release,
        which would drop the sets).  ``max_batch_size`` is shared: a cap
        met on one replica holds for the next, and the gate of a replica
        counts what the replicas before it hold on its device."""
        for worker in self.workers:
            with on_device(worker.pipeline.device):
                self._prewarm_replica(worker.pipeline, res_list, buckets,
                                      steps, compositions)

    def _prewarm_replica(self, pipe, res_list, buckets, steps: int,
                         compositions) -> None:
        sc, cc = self.config.scheduler, self.config.cache
        bks = [b for b in (sc.batch_buckets if buckets is None else buckets)
               if b <= sc.max_batch_size]
        for res in res_list:
            for b in bks:
                if b > sc.max_batch_size:
                    break  # capped at a smaller resolution
                if not self._bucket_fits(pipe, res, b):
                    self._cap(res, b, bks, "does not fit the card")
                    break
                with self._oom_caps(pipe, res, b, bks):
                    reqs = _throwaway(pipe, f"prewarm-{res}-{b}", {res: b},
                                      steps)
                    by_res = {res: reqs}
                    for _ in range(steps):
                        pipe.denoise_step(by_res)
                    for r in reqs:
                        r.stage = Stage.POSTPROCESSING
                    # the decode is the memory peak: no row state beside it
                    pipe.release_serving_state()
                    pipe.postprocess(by_res)
                if b > sc.max_batch_size:
                    break
        partial = (cc.enabled and cc.mode == "deep" and cc.deep_row_warmup
                   and hasattr(pipe.bundle.denoiser, "_deep_tail"))
        if sc.steps_per_dispatch > 1 or partial:
            for res in res_list:
                for b in [b for b in bks if b <= sc.max_batch_size]:
                    with self._oom_caps(pipe, res, b, bks):
                        if sc.steps_per_dispatch > 1:
                            self._prewarm_chunk(pipe, res, b)
                        if partial:
                            self._prewarm_partial(pipe, res, b)
                    if b > sc.max_batch_size:
                        break
        k = sc.steps_per_dispatch
        itv = max(cc.deep_interval, 1) if cc.enabled else 1
        for comp in compositions:
            by_res: Dict[int, List[Request]] = {}
            reqs = _throwaway(pipe, "prewarm-mix", comp, steps + itv + k + 2)
            for r in reqs:
                by_res.setdefault(r.resolution, []).append(r)
            for _ in range(steps):
                pipe.denoise_step_mixed(by_res)
            if k > 1:
                _drive(by_res, pipe.denoise_chunk_mixed,
                       pipe.denoise_step_mixed, k)
            pipe.evict_finished_state([r.request_id for r in reqs])

    def _cap(self, res: int, b: int, bks, why: str) -> None:
        """Cap ``max_batch_size`` below bucket ``b``."""
        sc = self.config.scheduler
        prev = max((x for x in bks if x < b), default=1)
        logger.warning("prewarm: res %d bucket %d %s: max_batch_size capped "
                       "at %d", res, b, why, prev)
        sc.max_batch_size = min(sc.max_batch_size, prev)

    @contextlib.contextmanager
    def _oom_caps(self, pipe, res: int, b: int, bks):
        """A bucket that runs out of the card's memory caps
        ``max_batch_size`` below it and releases the serving state."""
        try:
            yield
        except torch.cuda.OutOfMemoryError:
            self._cap(res, b, bks, "ran out of memory")
            pipe.release_serving_state()
            gc.collect()
            torch.cuda.empty_cache()

    def _device_bytes(self, device: torch.device) -> float:
        """The card's memory (``torch.cuda.mem_get_info``), or
        ``engine.hbm_bytes_fallback`` on the CPU."""
        if device.type == "cuda":
            return float(torch.cuda.mem_get_info(device)[1])
        return float(self.config.engine.hbm_bytes_fallback)

    def _held_bytes(self, device: torch.device) -> int:
        """Bytes the replicas hold on ``device``: the parameters there, each
        storage once (replicas on one card share a bundle; every shard of a
        group on the card counts its slices and copies), and the row state
        (composition stores, the sp step's K/V and step-set row buffers) of
        every replica whose lead device it is."""
        params: Dict[int, int] = {}
        for w in self.workers:
            pipe = w.pipeline
            if w.device == device:  # the replica's lead card
                params.update(pipe.param_bytes_on(pipe.device))
            elif device in pipe.devices:  # its shards on another card
                params.update(pipe.param_bytes_on(device))
        return (sum(params.values())
                + sum(w.pipeline._row_state_bytes() for w in self.workers
                      if w.device == device))

    def _bucket_fits(self, pipe, res: int, bucket: int) -> bool:
        """Prewarm's capacity gate (JAX engine.py:229-259): what the
        replicas on the pipeline's device hold (:meth:`_held_bytes`:
        parameters and row state), the bucket's composition state (from
        the layouts' shapes, nothing allocated) and ``prewarm_hbm_margin``
        must fit the card.  With ``steps_per_dispatch > 1`` the bucket's
        state counts twice: a composition's fresh rows are copied into its
        step set's buffer when that buffer already holds an earlier one's
        (``pipelines/graphs.py``)."""
        need = pipe.estimate_serving_state_bytes(res, bucket)
        if not need:
            return True
        if self.config.scheduler.steps_per_dispatch > 1:
            need *= 2
        device = next(w.device for w in self.workers if w.pipeline is pipe)
        total = (self._held_bytes(device) + need
                 + float(self.config.engine.prewarm_hbm_margin))
        return total <= self._device_bytes(device)

    def _prewarm_chunk(self, pipe, res: int, b: int) -> None:
        """Throwaway requests of (res, b) run to their end in chunks of
        ``steps_per_dispatch`` (per-step where a chunk is not eligible, as
        the worker serves them), long enough for an interval's full inside
        a chunk (JAX engine.py:261-291 stops at the first chunk: its one
        program holds every kind, a step graph holds one)."""
        cc = self.config.cache
        k = self.config.scheduler.steps_per_dispatch
        n_steps = k + max(cc.deep_interval, 1) + max(cc.deep_warmup, 0) + 2
        reqs = _throwaway(pipe, f"prewarm-chunk-{res}-{b}", {res: b}, n_steps)
        if not _drive({res: reqs}, pipe.denoise_chunk, pipe.denoise_step, k):
            logger.info("prewarm: no chunk is eligible at res %d bucket %d "
                        "under this configuration", res, b)
        pipe.evict_finished_state([r.request_id for r in reqs])

    def _prewarm_partial(self, pipe, res: int, b: int) -> None:
        """The row warmup's partial steps of (res, b), one per power-of-two
        row bucket kb < b (JAX engine.py:293-335): past the warmup, the
        deep features of kb requests are dropped before a dispatch, as an
        admission leaves them; with ``steps_per_dispatch > 1`` that
        dispatch is a chunk, capturing the partial kind."""
        cc = self.config.cache
        k = self.config.scheduler.steps_per_dispatch
        kbs = []
        kb = 1
        while kb < b:
            kbs.append(kb)
            kb *= 2
        if not kbs or max(cc.deep_interval, 1) <= 1:
            return
        warm = max(cc.deep_warmup, 0)
        reqs = _throwaway(pipe, f"prewarm-partial-{res}-{b}", {res: b},
                          warm + 1 + len(kbs) * max(k, 1))
        by_res = {res: reqs}
        for _ in range(warm + 1):
            pipe.denoise_step(by_res)
        for kb in kbs:
            for j, r in enumerate(reqs):
                if j < kb:
                    r.deep_state = None
                r.deep_age = 0
            n = min(k, min(r.remain_steps for r in reqs))
            if not (n > 1 and pipe.denoise_chunk(by_res, n)):
                pipe.denoise_step(by_res)
        pipe.evict_finished_state([r.request_id for r in reqs])

    # -- data collection -----------------------------------------------------

    def dump_data(self, out_dir: Optional[str] = None) -> None:
        """Write ``request_data.csv``, ``schedule_rank{r}.csv`` (each
        worker's per-iteration schedule log), ``spans.csv`` and
        ``counters.json`` (the process's recorder, ``tracing.py``) to
        ``out_dir``, by default ``engine.collect_dir``."""
        out_dir = out_dir or self.config.engine.collect_dir
        os.makedirs(out_dir, exist_ok=True)
        self.stats.dump_csv(os.path.join(out_dir, "request_data.csv"))
        tracing.dump(os.path.join(out_dir, "spans.csv"),
                     os.path.join(out_dir, "counters.json"))
        for worker in self.workers:
            log = worker.schedule_log
            if not log:
                continue
            path = os.path.join(out_dir, f"schedule_rank{worker.rank}.csv")
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(log[0]))
                w.writeheader()
                w.writerows(log)


def _throwaway(pipe, prefix: str, comp: Dict[int, int], steps: int):
    """Prepared DENOISING requests, ``comp[res]`` at each resolution."""
    reqs = [Request(f"{prefix}-{res}-{i}", SamplingParams(
                prompt="", resolution=res, num_inference_steps=steps, seed=0))
            for res, count in sorted(comp.items()) for i in range(count)]
    pipe.prepare(reqs)
    for r in reqs:
        r.stage = Stage.DENOISING
    return reqs


def _drive(by_res, chunk, step, k: int) -> bool:
    """Run the requests to their end as the worker would: chunks of up to
    ``k`` steps, one step where a chunk is not eligible.  True when a
    chunk ran."""
    reqs = [r for rs in by_res.values() for r in rs]
    ran = False
    while min(r.remain_steps for r in reqs) > 0:
        n = min(k, min(r.remain_steps for r in reqs))
        if n > 1 and chunk(by_res, n):
            ran = True
        else:
            step(by_res)
    return ran
