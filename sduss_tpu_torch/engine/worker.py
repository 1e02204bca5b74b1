"""Per-replica worker (counterpart of sduss_tpu/engine/worker.py).

One engine iteration = one scheduled stage execution: PREPARE, one
DENOISING dispatch, or POSTPROCESSING, chosen by the port's copy of the
scheduler (``sduss_tpu_torch.scheduler``).  A DENOISING batch that mixes
resolutions runs as one forward (``denoise_step_mixed``: a patched UNet
for SDXL, a padded-token MMDiT for SD3) when
``scheduler.use_mixed_resolution`` is on.  With
``scheduler.steps_per_dispatch`` k > 1 a dispatch first tries a chunk of
``min(k, remain_steps)`` steps (``denoise_chunk``, or
``denoise_chunk_mixed`` for a mixed batch), as the JAX worker does
(worker.py:238-257), and steps once where the chunk is not eligible; the
policy's step-time feedback divides the dispatch by its steps.

PyTorch launches CUDA work asynchronously, so, as
in the JAX worker, the host's lead over the device is bounded: after each
denoise iteration the worker keeps a 1-element probe of the step output and
past ``engine.max_inflight_steps`` probes reads the oldest with ``.item()``,
which waits for that step.

Prepare and postprocess may run on background threads, one thread each,
as in the JAX worker: while a stage runs there its requests are parked in
PREPARING or DECODING, invisible to the policies, and the loop keeps
denoising.  ``engine.async_postprocess="auto"`` decodes in the background
whenever no other decode group is in flight and the pipeline's memory
estimate (``post_overlap_ok``) fits the decode next to a running step;
otherwise the decode blocks the loop.  ``engine.async_prepare="auto"`` is
synchronous: the JAX package backgrounds prepare only when its encoders
live on the host (``encoders_on_host``, a memory policy for a 16 GB TPU
chip), and every model of the port's bundle stays on the card.

Each worker serves one dp replica on its own device
(``parallel/replica.py``).  The engine's thread steps every replica in
turn, so each step runs under ``torch.cuda.device(replica device)``, and
the ``prepare-{rank}`` and ``post-{rank}`` threads make that device
current when they start: the kernels' launches and the step graphs act
on the current device.

Both threads issue their kernels to the same CUDA stream as the loop (a
new thread starts on the device's default stream), so a decode's kernels
interleave with the denoise steps' as XLA's do on one compute stream, and
the memory peak stays the larger of the two, not their sum.  The
composition-state store is touched only on the loop thread: a background
decode's eviction and group sizing run there before it is submitted
(``BasePipeline.plan_postprocess``).  An exception on a pool thread
reaches the engine loop when the future is read.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import time
from typing import Dict, List

import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.config import Config
from sduss_tpu_torch.request import Request, Stage
from sduss_tpu_torch.scheduler import WorkerScheduler
from sduss_tpu_torch.scheduler.policies import ScheduledBatch
from sduss_tpu_torch.parallel.replica import canonical, on_device
from sduss_tpu_torch.pipelines.base import BasePipeline


class Worker:
    def __init__(self, rank: int, pipeline: BasePipeline, config: Config):
        self.rank = rank
        self.pipeline = pipeline
        self.config = config
        self.device = canonical(pipeline.device)
        self.scheduler = WorkerScheduler(config.scheduler, pipeline.bundle.family,
                                         cache_config=config.cache,
                                         parallel_config=config.parallel)
        self.iteration = 0
        # Per-step schedule log, populated when engine.collect_data is on.
        self.schedule_log: List[Dict] = []
        # 1-element probes of in-flight denoise outputs (module docstring).
        self._inflight: collections.deque = collections.deque()
        # "auto": prepare in the background exactly when the encoders live
        # on the host, which they never do in the port (module docstring)
        ap = config.engine.async_prepare
        self._prepare_pool = (self._pool(f"prepare-{rank}")
                              if (False if ap == "auto" else bool(ap))
                              else None)
        self._preparing: collections.deque = collections.deque()
        app = config.engine.async_postprocess
        self._post_pool = (self._pool(f"post-{rank}")
                           if (True if app == "auto" else bool(app))
                           else None)
        self._posting: collections.deque = collections.deque()
        if config.scheduler.steps_per_dispatch > 1:
            # a step-graph capture never races a background decode
            pipeline.graphs.before_capture = self._wait_posted

    def _pool(self, name: str) -> concurrent.futures.ThreadPoolExecutor:
        """One background thread whose current CUDA device is the
        replica's."""
        init = (functools.partial(torch.cuda.set_device, self.device)
                if self.device.type == "cuda" else None)
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=name, initializer=init)

    # -- request management --------------------------------------------------

    def add_requests(self, reqs: List[Request]) -> None:
        for req in reqs:
            req.dp_rank = self.rank
            self.scheduler.add_request(req)

    def abort_requests(self, request_ids: List[str]) -> List[Request]:
        out = []
        for rid in request_ids:
            req = self.scheduler.abort_request(rid)
            if req is not None:
                req.finish_time = time.time()
                out.append(req)
        if out:
            self.pipeline.evict_finished_state([r.request_id for r in out])
        return out

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    def pending_pixels(self) -> int:
        return self.scheduler.pool.pending_pixels()

    # -- iteration -----------------------------------------------------------

    def step(self) -> List[Request]:
        """Run one scheduled iteration on the replica's device; return
        requests finished this step."""
        with on_device(self.device):
            return self._step()

    def _step(self) -> List[Request]:
        with tracing.span("worker.advance"):
            self._poll_prepared(block=False)
            done_async = self._poll_posted(block=False)
        batch = self.scheduler.schedule()
        if batch is None or batch.empty:
            # nothing schedulable but a prepare or decode in flight: block
            # briefly on the oldest so the engine loop does not spin
            if self._preparing:
                with tracing.span("worker.wait"):
                    self._poll_prepared(block=True)
            elif self._posting:
                with tracing.span("worker.wait"):
                    done_async += self._poll_posted(block=True)
            return done_async
        self.iteration += 1
        now = time.time()
        for req in batch.requests:
            if req.first_scheduled_time is None:
                req.first_scheduled_time = now
        parked = self._execute(batch) if batch.requests else False
        if self.config.engine.collect_data:
            res_counts: Dict[int, int] = {}
            for r in batch.requests:
                res_counts[r.resolution] = res_counts.get(r.resolution, 0) + 1
            self.schedule_log.append({
                "time": now, "iteration": self.iteration,
                "stage": batch.stage.value, "batch_size": len(batch.requests),
                "resolutions": ";".join(f"{k}x{v}" for k, v in sorted(res_counts.items())),
                "predicted_step_ms": batch.requests[0].predicted_step_ms
                if batch.requests else 0.0,
            })
        with tracing.span("worker.advance"):
            return done_async + self._advance(batch, parked)

    def _advance(self, batch: ScheduledBatch, parked: bool) -> List[Request]:
        if parked:
            # _execute submitted the stage to a pool thread: park the
            # requests until its future completes.  The batch's policy
            # aborts finish now, since advance() is skipped.
            if batch.stage is Stage.PREPARE:
                self.scheduler.begin_prepare(batch)
            else:
                self.scheduler.begin_postprocess(batch)
            aborted = list(batch.aborts)
            if aborted:
                now2 = time.time()
                for req in aborted:
                    req.finish_time = now2
                    self.scheduler.pool.remove(req.request_id)
                self.pipeline.evict_finished_state(
                    [r.request_id for r in aborted])
            return aborted
        finished = self.scheduler.advance(batch)
        for req in finished:
            req.finish_time = time.time()
        if finished:
            # composition-state keys hold request ids: entries touching a
            # finished or aborted request are unreachable; free them now
            self.pipeline.evict_finished_state(
                [r.request_id for r in finished])
        return finished

    def _poll_posted(self, block: bool) -> List[Request]:
        """Finish the requests whose background decode completed; with
        ``block``, wait briefly on the oldest one in flight."""
        finished: List[Request] = []
        while self._posting:
            fut, reqs = self._posting[0]
            if not fut.done():
                if not block:
                    break
                concurrent.futures.wait([fut], timeout=0.05)
                if not fut.done():
                    break
            self._posting.popleft()
            fut.result()  # a decode's exception reaches the engine loop
            done = self.scheduler.finish_postprocess(reqs)
            now = time.time()
            for req in done:
                req.finish_time = now
            finished.extend(done)
            block = False  # drain further completed futures without waiting
        return finished

    def _wait_posted(self) -> None:
        """Wait for the decodes in flight on the post thread (their
        results are read later, by ``_poll_posted``)."""
        concurrent.futures.wait([fut for fut, _ in self._posting])

    def _poll_prepared(self, block: bool) -> None:
        """Release the requests whose background prepare completed; with
        ``block``, wait briefly on the oldest one in flight."""
        while self._preparing:
            fut, reqs = self._preparing[0]
            if not fut.done():
                if not block:
                    return
                concurrent.futures.wait([fut], timeout=0.05)
                if not fut.done():
                    return
            self._preparing.popleft()
            fut.result()  # a prepare's exception reaches the engine loop
            self.scheduler.finish_prepare(reqs)
            block = False  # drain further completed futures without waiting

    def _execute(self, batch: ScheduledBatch) -> bool:
        """Run the batch's stage; True when it went to a pool thread."""
        pipe = self.pipeline
        by_res: Dict[int, List[Request]] = {}
        for r in batch.requests:
            by_res.setdefault(r.resolution, []).append(r)
        if batch.stage is Stage.PREPARE:
            reqs = list(batch.requests)
            if self._prepare_pool is not None:
                fut = self._prepare_pool.submit(_staged, "stage.prepare",
                                                reqs, pipe.prepare, reqs)
                self._preparing.append((fut, reqs))
                return True
            with tracing.span("stage.prepare", reqs):
                pipe.prepare(reqs)
        elif batch.stage is Stage.DENOISING:
            t0 = time.perf_counter()
            with tracing.span("stage.denoise", batch.requests) as sp:
                if sp:
                    sp.set(rows=len(batch.requests), res=sorted(by_res))
                steps_run = self._denoise(batch, by_res)
            with tracing.span("worker.throttle"):
                saturated = self._throttle(batch.requests[0].latents)
            if saturated:
                # saturated: wall time per iteration tracks device time,
                # so feed the realized step time back to the policy
                self.scheduler.policy.observe_step_time(
                    batch.requests,
                    (time.perf_counter() - t0) * 1e3 / steps_run)
        elif batch.stage is Stage.POSTPROCESSING:
            with tracing.span("worker.throttle"):
                self._drain_inflight()
            reqs = list(batch.requests)
            # Background the decode only when no other decode group is in
            # flight (one overlapped decode at a time) and the pipeline's
            # estimate fits its transient next to a running denoise step;
            # otherwise decode on the loop.  The plan runs here either way.
            with tracing.span("stage.decode", reqs):
                background = (self._post_pool is not None
                              and not self._posting
                              and pipe.post_overlap_ok(by_res))
                decode = pipe.plan_postprocess(by_res)
                if not background:
                    decode()
            if background:
                fut = self._post_pool.submit(_staged, "stage.decode", reqs,
                                             decode)
                self._posting.append((fut, reqs))
                return True
        else:  # pragma: no cover
            raise ValueError(batch.stage)
        return False

    def _denoise(self, batch: ScheduledBatch, by_res) -> int:
        """One DENOISING dispatch; returns the steps it ran."""
        pipe = self.pipeline
        mixed = batch.mixed and self.config.scheduler.use_mixed_resolution
        k = min(self.config.scheduler.steps_per_dispatch,
                min(r.remain_steps for r in batch.requests))
        steps_run = 1
        # fused multi-step dispatch: k steps in one dispatch, tables and
        # latents advanced by k, scheduling at chunk boundaries; an
        # ineligible configuration returns False and steps once
        if k > 1 and (pipe.denoise_chunk_mixed(by_res, k) if mixed
                      else not batch.mixed
                      and pipe.denoise_chunk(by_res, k)):
            steps_run = k
        elif mixed:
            pipe.denoise_step_mixed(by_res)
        else:
            pipe.denoise_step(by_res)
        for r in batch.requests:
            if r.start_denoising_time is None:
                r.start_denoising_time = time.time()
        return steps_run

    def _throttle(self, latents) -> bool:
        """Bound the host's lead to engine.max_inflight_steps; True when a
        probe was read this call (the pipeline is saturated)."""
        depth = self.config.engine.max_inflight_steps
        if depth <= 0:
            return False
        self._inflight.append(latents[0, 0, 0, 0:1])
        saturated = False
        while len(self._inflight) > depth:
            self._inflight.popleft().item()
            saturated = True
        return saturated

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._inflight.popleft().item()


def _staged(name: str, reqs, fn, *args):
    """``fn(*args)`` under the stage span ``name`` of ``reqs``, on a pool
    thread."""
    with tracing.span(name, reqs):
        return fn(*args)
