"""Iteration-level scheduling policies (reference worker/scheduler/policy/).

Each policy picks the next stage batch for one engine iteration:
  * FCFS_Single    — oldest request's (stage, resolution); single-res batches
                     (policy/FCFS_Single.py:11-63).
  * FCFS_Mixed     — oldest request's stage; denoising batches mix resolutions
                     via the patch batch (policy/FCFS_Mixed.py:13-77).
  * Orca_ResByRes  — drain one resolution completely before the next
                     (policy/Orca_ResByRes.py:14-81).
  * Orca_RoundRobin— rotate over resolutions each iteration
                     (policy/Orca_Round_Robin.py:13-95).
The SLO-aware ESyMReD policy lives in scheduler/esymred.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

from sduss_tpu_torch.config import SchedulerConfig
from sduss_tpu_torch.request import Request, Stage
from sduss_tpu_torch.scheduler.request_pool import RequestPool


@dataclasses.dataclass
class ScheduledBatch:
    stage: Stage
    requests: List[Request]
    # Denoising only: batch mixes resolutions -> use the patch path.
    mixed: bool = False
    # Requests the policy decided to abort this iteration (ESyMReD).
    aborts: List[Request] = dataclasses.field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.requests and not self.aborts


class Policy:
    """Base: subclasses implement schedule(pool) -> ScheduledBatch | None."""

    supports_mixed_resolution = False
    # CacheConfig of the serving pipeline (set by WorkerScheduler); policies
    # may use it to align admissions with cache phases.  None = cache-off.
    cache_config = None
    # ParallelConfig of the serving deployment (set by WorkerScheduler);
    # informs displaced-mode admission batching.  None = single device.
    parallel_config = None

    def __init__(self, config: SchedulerConfig, family: str = "sd15"):
        self.config = config
        self.family = family

    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        raise NotImplementedError

    def observe_step_time(self, requests: List[Request], ms: float) -> None:
        """Realized wall ms of one executed denoise iteration (fed by the
        worker once its dispatch throttle saturates).  Base: ignored."""

    # -- shared helpers ------------------------------------------------------

    def _oldest_nonempty_stage(self, pool: RequestPool) -> Optional[Stage]:
        """Stage of the longest-waiting request among actionable stages."""
        best = None
        best_stage = None
        for stage in (Stage.POSTPROCESSING, Stage.PREPARE, Stage.DENOISING):
            reqs = pool.in_stage(stage)
            if reqs and (best is None or reqs[0].arrival_time < best):
                best = reqs[0].arrival_time
                best_stage = stage
        return best_stage

    def _take(self, reqs: List[Request], n: int) -> List[Request]:
        return reqs[: max(1, n)]


class FCFSSingle(Policy):
    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        stage = self._oldest_nonempty_stage(pool)
        if stage is None:
            return None
        reqs = pool.in_stage(stage)
        # batch only requests at the oldest request's resolution
        res = reqs[0].resolution
        same = [r for r in reqs if r.resolution == res]
        return ScheduledBatch(stage, self._take(same, self.config.max_batch_size))


class FCFSMixed(Policy):
    """FCFS with mixed-resolution denoise batches (reference FCFS_Mixed.py).

    Note the run-to-completion admission semantics shared by the FCFS
    baselines: ``_oldest_nonempty_stage`` favors the oldest request's
    stage, so arrivals that stagger into PREPARE while an older batch is
    DENOISING wait for it to drain — mixed batches form from requests
    admitted together.  Mid-flight admission (continuous batching) is
    ESyMReD's job (slack-driven, deep-phase-aligned)."""

    supports_mixed_resolution = True

    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        stage = self._oldest_nonempty_stage(pool)
        if stage is None:
            return None
        reqs = pool.in_stage(stage)
        if stage is Stage.DENOISING and not self.config.use_mixed_resolution:
            # mixed denoising disabled at the config: single-res batches
            res = reqs[0].resolution
            reqs = [r for r in reqs if r.resolution == res]
        # Every stage batches oldest-first ACROSS resolutions (reference
        # FCFS_Mixed.py:44-57 collects by status only; prepare is
        # res-independent and the worker groups postprocess by res) — a
        # same-res prepare restriction would make denoise cohorts
        # single-res under run-to-completion, collapsing this policy into
        # Orca_ResByRes.
        batch = self._take(reqs, self.config.max_batch_size)
        mixed = (stage is Stage.DENOISING
                 and len({r.resolution for r in batch}) > 1)
        return ScheduledBatch(stage, batch, mixed=mixed)


class OrcaResByRes(Policy):
    """Serve the resolution with the oldest waiting request until drained."""

    def __init__(self, config: SchedulerConfig, family: str = "sd15"):
        super().__init__(config, family)
        self._current_res: Optional[int] = None

    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        stage = self._oldest_nonempty_stage(pool)
        if stage is None:
            return None
        reqs = pool.in_stage(stage)
        if stage is not Stage.DENOISING:
            res = reqs[0].resolution
            return ScheduledBatch(stage, self._take(
                [r for r in reqs if r.resolution == res], self.config.max_batch_size))
        live = {r.resolution for r in reqs}
        if self._current_res not in live:
            self._current_res = reqs[0].resolution
        same = [r for r in reqs if r.resolution == self._current_res]
        return ScheduledBatch(stage, self._take(same, self.config.max_batch_size))


class OrcaRoundRobin(Policy):
    """Rotate across resolutions every iteration."""

    def __init__(self, config: SchedulerConfig, family: str = "sd15"):
        super().__init__(config, family)
        self._last_res: Optional[int] = None

    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        stage = self._oldest_nonempty_stage(pool)
        if stage is None:
            return None
        reqs = pool.in_stage(stage)
        if stage is not Stage.DENOISING:
            res = reqs[0].resolution
            return ScheduledBatch(stage, self._take(
                [r for r in reqs if r.resolution == res], self.config.max_batch_size))
        ress = sorted({r.resolution for r in reqs})
        if self._last_res in ress:
            nxt = ress[(ress.index(self._last_res) + 1) % len(ress)]
        else:
            nxt = ress[0]
        self._last_res = nxt
        same = [r for r in reqs if r.resolution == nxt]
        return ScheduledBatch(stage, self._take(same, self.config.max_batch_size))


_POLICIES: Dict[str, Type[Policy]] = {
    "fcfs_single": FCFSSingle,
    "fcfs_mixed": FCFSMixed,
    "orca_resbyres": OrcaResByRes,
    "orca_round_robin": OrcaRoundRobin,
}


def get_policy(name: str, config: SchedulerConfig, family: str = "sd15") -> Policy:
    if name == "esymred":
        from sduss_tpu_torch.scheduler.esymred import ESyMReDPolicy

        return ESyMReDPolicy(config, family)
    try:
        return _POLICIES[name](config, family)
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(_POLICIES) + ['esymred']}") from None
