"""Worker-side iteration scheduler.

Stage bookkeeping equivalent of the reference Scheduler
(sduss/worker/scheduler/scheduler.py:23-206): owns the per-replica pool,
delegates batch choice to a policy, and advances request stages after each
executed iteration.
"""

from __future__ import annotations

from typing import List, Optional

from sduss_tpu_torch import tracing
from sduss_tpu_torch.config import SchedulerConfig
from sduss_tpu_torch.request import Request, Stage
from sduss_tpu_torch.scheduler.policies import ScheduledBatch, get_policy
from sduss_tpu_torch.scheduler.request_pool import RequestPool


class WorkerScheduler:
    def __init__(self, config: SchedulerConfig, family: str,
                 cache_config=None, parallel_config=None):
        self.config = config
        self.pool = RequestPool()
        self.policy = get_policy(config.policy, config, family)
        # Cache settings inform admission timing (deep-phase alignment);
        # None (tests / cache-off) disables the gate.
        self.policy.cache_config = cache_config
        # Parallel settings inform displaced-mode admission batching (an
        # admission under sp_mode="displaced" is a KV-state boundary that
        # re-runs sync warmup for the whole batch).
        self.policy.parallel_config = parallel_config

    def add_request(self, req: Request) -> None:
        req.stage = Stage.PREPARE
        self.pool.add(req)

    def abort_request(self, request_id: str) -> Optional[Request]:
        req = self.pool.get(request_id)
        if req is None:
            return None
        self.pool.move(req, Stage.ABORTED)
        self.pool.remove(request_id)
        return req

    def has_unfinished(self) -> bool:
        return self.pool.unfinished() > 0

    def schedule(self) -> Optional[ScheduledBatch]:
        with tracing.span("worker.schedule") as sp:
            batch = self.policy.schedule(self.pool)
            if batch is not None:
                for req in batch.aborts:
                    self.pool.move(req, Stage.ABORTED)
            if sp and batch is not None:
                sp.set(stage=batch.stage.value, rows=len(batch.requests))
        return batch

    # -- asynchronous prepare (engine/worker.py _submit_prepare) -------------

    def begin_prepare(self, batch: ScheduledBatch) -> None:
        """Park a scheduled PREPARE batch while it encodes on a background
        host thread: PREPARING requests are invisible to every policy (no
        policy reads that stage) but still count as unfinished/pending."""
        for req in batch.requests:
            self.pool.move(req, Stage.PREPARING)

    def finish_prepare(self, reqs: List[Request]) -> None:
        """Background prepare completed: release requests to the denoiser.
        Requests aborted mid-prepare have already left PREPARING — skip."""
        for req in reqs:
            if req.stage is Stage.PREPARING:
                self.pool.move(req, Stage.DENOISING)

    def begin_postprocess(self, batch: ScheduledBatch) -> None:
        """Park a scheduled POSTPROCESSING batch while its VAE decode +
        image fetch run on a background host thread (the mirror of
        begin_prepare): DECODING requests are invisible to every policy
        but still count as unfinished/pending."""
        for req in batch.requests:
            self.pool.move(req, Stage.DECODING)

    def finish_postprocess(self, reqs: List[Request]) -> List[Request]:
        """Background decode completed: finish the requests.  Requests
        aborted mid-decode have already left DECODING — skip."""
        finished: List[Request] = []
        for req in reqs:
            if req.stage is Stage.DECODING:
                self.pool.move(req, Stage.FINISHED)
                self.pool.remove(req.request_id)
                finished.append(req)
        return finished

    def advance(self, batch: ScheduledBatch) -> List[Request]:
        """Update stages after the batch executed; return finished requests."""
        finished: List[Request] = []
        if batch.stage is Stage.PREPARE:
            for req in batch.requests:
                self.pool.move(req, Stage.DENOISING)
        elif batch.stage is Stage.DENOISING:
            for req in batch.requests:
                if req.remain_steps <= 0:
                    self.pool.move(req, Stage.POSTPROCESSING)
        elif batch.stage is Stage.POSTPROCESSING:
            for req in batch.requests:
                self.pool.move(req, Stage.FINISHED)
                self.pool.remove(req.request_id)
                finished.append(req)
        finished.extend(batch.aborts)
        for req in batch.aborts:
            self.pool.remove(req.request_id)
        return finished
