"""Per-replica worker (counterpart of sduss_tpu/engine/worker.py).

One engine iteration = one scheduled stage execution: PREPARE, one
DENOISING step, or POSTPROCESSING, chosen by the port's copy of the
scheduler (``sduss_tpu_torch.scheduler``).  A DENOISING batch that mixes
resolutions runs as one forward (``denoise_step_mixed``: a patched UNet
for SDXL, a padded-token MMDiT for SD3) when
``scheduler.use_mixed_resolution`` is on.

PyTorch launches CUDA work asynchronously, so, as
in the JAX worker, the host's lead over the device is bounded: after each
denoise iteration the worker keeps a 1-element probe of the step output and
past ``engine.max_inflight_steps`` probes reads the oldest with ``.item()``,
which waits for that step.

Every model of the bundle, the three SD3 text encoders included, stays on
the card: the JAX package's ``encoders_on_host`` is a memory policy for a
16 GB TPU chip that an 80 GB card does not need, so PREPARE runs on the
device like the other stages.

Prepare and postprocess run synchronously in this port.  The JAX worker's
background prepare/decode threads (with the decode-overlap memory bound and
the warm-daemon deferral) are not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.request import Request, Stage
from sduss_tpu_torch.scheduler import WorkerScheduler
from sduss_tpu_torch.scheduler.policies import ScheduledBatch
from sduss_tpu_torch.pipelines.base import BasePipeline

_ASYNC_TODO = ("ROADMAP 'Queue 1' item 4: async prepare/postprocess with the "
               "decode-overlap bound")


def _check_sync(name: str, value) -> None:
    """``"auto"`` resolves to synchronous in the port; True raises."""
    if value != "auto" and value is not False:
        raise ValueError(f"engine.{name}={value!r} is not ported yet ({_ASYNC_TODO})")


class Worker:
    def __init__(self, rank: int, pipeline: BasePipeline, config: Config):
        self.rank = rank
        self.pipeline = pipeline
        self.config = config
        self.scheduler = WorkerScheduler(config.scheduler, pipeline.bundle.family,
                                         cache_config=config.cache,
                                         parallel_config=config.parallel)
        _check_sync("async_prepare", config.engine.async_prepare)
        _check_sync("async_postprocess", config.engine.async_postprocess)
        self.iteration = 0
        # Per-step schedule log, populated when engine.collect_data is on.
        self.schedule_log: List[Dict] = []
        # 1-element probes of in-flight denoise outputs (module docstring).
        self._inflight: collections.deque = collections.deque()

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

    # -- iteration -----------------------------------------------------------

    def step(self) -> List[Request]:
        """Run one scheduled iteration; return requests finished this step."""
        batch = self.scheduler.schedule()
        if batch is None or batch.empty:
            return []
        self.iteration += 1
        now = time.time()
        for req in batch.requests:
            if req.first_scheduled_time is None:
                req.first_scheduled_time = now
        if batch.requests:
            self._execute(batch)
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
        finished = self.scheduler.advance(batch)
        for req in finished:
            req.finish_time = time.time()
        if finished:
            # composition-state keys hold request ids: entries touching a
            # finished or aborted request are unreachable; free them now
            self.pipeline.evict_finished_state(
                [r.request_id for r in finished])
        return finished

    def _execute(self, batch: ScheduledBatch) -> None:
        pipe = self.pipeline
        by_res: Dict[int, List[Request]] = {}
        for r in batch.requests:
            by_res.setdefault(r.resolution, []).append(r)
        if batch.stage is Stage.PREPARE:
            pipe.prepare(batch.requests)
        elif batch.stage is Stage.DENOISING:
            t0 = time.perf_counter()
            if batch.mixed and self.config.scheduler.use_mixed_resolution:
                pipe.denoise_step_mixed(by_res)
            else:
                pipe.denoise_step(by_res)
            for r in batch.requests:
                if r.start_denoising_time is None:
                    r.start_denoising_time = time.time()
            if self._throttle(batch.requests[0].latents):
                # saturated: wall time per iteration tracks device time,
                # so feed the realized step time back to the policy
                self.scheduler.policy.observe_step_time(
                    batch.requests, (time.perf_counter() - t0) * 1e3)
        elif batch.stage is Stage.POSTPROCESSING:
            self._drain_inflight()
            pipe.postprocess(by_res)
        else:  # pragma: no cover
            raise ValueError(batch.stage)

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
