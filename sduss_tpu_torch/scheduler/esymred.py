"""ESyMReD: SLO-slack-driven admission/abort scheduling.

Rebuild of the reference's core policy
(sduss/worker/scheduler/policy/ESyMReD.py:69-456 + slack math in
worker/wrappers.py:108-155).  Decision flow preserved:

1. POSTPROCESSING first (complete requests ASAP); admission into the decode
   batch is limited so the batched decode still fits the most urgent
   request's remaining time budget (postprocessing_ratio, :187-208).
2. PREPARE next (text encode is cheap; emptying it feeds the denoiser).
3. DENOISING: requests already denoising always continue .  New
   admissions iterate in slack order; each candidate admission is evaluated
   with the latency predictor against ALL running requests' slacks — if any
   would go negative, stop admitting; when the most urgent candidate has
   ample slack, admit the smallest-resolution candidate instead (throughput
   mode, :325-436).  Candidates whose own slack is already negative are
   aborted (:323-327, 405-412).

Slack(t) = DDL(resolution) - elapsed(t) - predicted_remaining, with
DDL = standalone latency x SLO scale (esymred_utils.py:14-44).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from sduss_tpu_torch.config import SchedulerConfig
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.request import Request, Stage
from sduss_tpu_torch.scheduler.policies import Policy, ScheduledBatch
from sduss_tpu_torch.scheduler.predictor import LatencyPredictor
from sduss_tpu_torch.scheduler.profiles import get_profile
from sduss_tpu_torch.scheduler.request_pool import RequestPool

logger = init_logger(__name__)

# Admission guard: stop admitting when a running request's projected slack
# falls under this (reference hardcodes 0.2 s, ESyMReD.py:305).
MIN_RUNNING_SLACK_S = 0.2
# Throughput mode kicks in when the urgent candidate's slack exceeds this
# multiple of its own remaining denoise time (reference :330).
THROUGHPUT_SLACK_RATIO = 2.0


class ESyMReDPolicy(Policy):
    supports_mixed_resolution = True

    def __init__(self, config: SchedulerConfig, family: str = "sdxl"):
        super().__init__(config, family)
        self.profile = get_profile(family, slo_scale=config.slo_scale,
                                   overrides=config.stage_latency_overrides or None)
        if config.predictor_path:
            self.predictor = LatencyPredictor.load(config.predictor_path, self.profile)
        else:
            self.predictor = LatencyPredictor([], self.profile)
        self._resolutions: List[int] = []
        # Multiplicative realized/predicted step-time correction (EMA fed by
        # Worker.observe_step_time).  The fitted predictor measures cache-off
        # dense steps; serving may run cache-on, so raw predictions can
        # overestimate and the slack math would abort healthy requests.
        # Primed lazily from the cache schedule's expected steady-state
        # factor (profiles.py cache_step_factor), so admissions do not
        # starve while the EMA learns from 1.0.
        self._step_correction = 1.0
        self._outlier_cut = 6.0
        self._correction_primed = False

    def observe_step_time(self, requests: List[Request], ms: float) -> None:
        alpha = getattr(self.config, "step_time_ema", 0.0)
        if alpha <= 0 or not requests or ms <= 0:
            return
        pred = requests[0].predicted_step_ms
        if pred <= 0.05:
            return
        # Outlier guard: a one-off hiccup (a cold load mid-pass) shows up
        # as one iteration far above the prediction.  A single outlier is
        # dropped; TWO consecutive ones are believed — a real regime shift
        # (e.g. cache-off fallback) repeats, a one-off load doesn't.  The
        # cut must sit above the legitimate periodic ratio of a cache-on
        # full step against the averaged prediction: cut = max(6,
        # 2/factor), primed with the correction.
        ratio = ms / pred
        if ratio > self._outlier_cut:
            self._outlier_streak = getattr(self, "_outlier_streak", 0) + 1
            if self._outlier_streak < 2:
                return
        else:
            self._outlier_streak = 0
        # predicted_step_ms already includes the current correction, so the
        # observed ratio is the residual multiplier.
        target = self._step_correction * min(max(ratio, 0.05), 20.0)
        self._step_correction = min(max(
            (1.0 - alpha) * self._step_correction + alpha * target,
            0.05), 20.0)

    # corrected prediction helpers --------------------------------------------

    def _maybe_prime_correction(self) -> None:
        """One-time cache-factor prior (cache_config is assigned after
        construction by WorkerScheduler, so priming is lazy)."""
        if not self._correction_primed:
            self._correction_primed = True
            factor = self.profile.cache_step_factor(self.cache_config)
            self._step_correction = factor
            self._outlier_cut = max(6.0, 2.0 / max(factor, 1e-3))

    def _predict_counts(self, counts: List[int]) -> float:
        self._maybe_prime_correction()
        return self.predictor.predict(counts) * self._step_correction

    def _single_step_s(self, resolution: int) -> float:
        self._maybe_prime_correction()
        return self.predictor.single_request_step_s(resolution) \
            * self._step_correction

    def _ensure_resolutions(self, pool: RequestPool) -> None:
        if self.predictor.weights is not None:
            # Fitted weights fix the feature axes at training time; pool
            # resolutions outside them are mapped to the nearest trained
            # axis in _counts_key (overwriting here would misalign the
            # ridge feature dimension and crash predict()).
            self._resolutions = list(self.predictor.resolutions)
            return
        res = sorted(set(self._resolutions)
                     | {r.resolution for r in pool.in_stage(Stage.DENOISING)})
        if res != self._resolutions:
            self._resolutions = res
            self.predictor.resolutions = res

    def _counts_key(self, resolution: int) -> int:
        """Axis a request's resolution contributes to (nearest trained)."""
        if resolution in self._resolutions or not self._resolutions:
            return resolution
        return min(self._resolutions, key=lambda r: abs(r - resolution))

    # -- slack --------------------------------------------------------------

    def _denoise_slack(self, req: Request, now: float, predicted_remaining_s: float) -> float:
        ddl = self.profile.denoising_ddl_s(req.resolution)
        return ddl - (now - req.arrival_time) - predicted_remaining_s

    def _post_slack_budget(self, req: Request, now: float) -> float:
        """Remaining e2e budget for a request awaiting decode."""
        return self.profile.e2e_ddl_s(req.resolution) - (now - req.arrival_time)

    # -- schedule ------------------------------------------------------------

    def schedule(self, pool: RequestPool) -> Optional[ScheduledBatch]:
        now = time.time()
        self._ensure_resolutions(pool)

        post = pool.in_stage(Stage.POSTPROCESSING)
        if post:
            return self._schedule_post(post, now)

        prep = pool.in_stage(Stage.PREPARE)
        if prep:
            return ScheduledBatch(Stage.PREPARE, prep[: self.config.max_batch_size])

        return self._schedule_denoising(pool, now)

    def _schedule_post(self, post: List[Request], now: float) -> ScheduledBatch:
        # Most urgent first; single resolution per decode batch.
        post = sorted(post, key=lambda r: self._post_slack_budget(r, now))
        target = post[0]
        res = target.resolution
        budget = max(self._post_slack_budget(target, now), 1e-3)
        batch = [target]
        for r in post[1:]:
            if r.resolution != res:
                continue
            if len(batch) >= self.config.max_batch_size:
                break
            # Admit while the bigger decode batch still fits the target budget.
            if self.profile.post_latency_s(res, len(batch) + 1) / budget \
                    < self.config.postprocessing_ratio:
                batch.append(r)
            else:
                break
        return ScheduledBatch(Stage.POSTPROCESSING, batch)

    def _deep_defer(self, running: List[Request], urgent: Request, now: float,
                    step_s: float) -> bool:
        """True when admissions should wait for the next full-pass boundary.

        Mirrors the pipeline's mode choice (pipelines/base.py
        _denoise_group_deep): the upcoming step is full iff any running row
        lacks a fresh deep feature, is at the end of its interval, or is in
        trajectory warmup.  Admitting DURING a shallow phase would force
        fulls for `deep_warmup` consecutive steps across the whole batch.
        """
        cc = self.cache_config
        if cc is None or not getattr(cc, "enabled", False) \
                or getattr(cc, "mode", None) != "deep" \
                or not getattr(cc, "phase_admission", True):
            return False
        if getattr(cc, "deep_row_warmup", False):
            # Row-granular warmup (partial programs; the hybrid composes
            # via row carry-over): an admission warms only its own rows —
            # there is no batch-wide full phase to align with, so deferral
            # would just add queueing latency.
            return False
        adaptive = getattr(cc, "deep_adaptive", False)
        interval = max(cc.deep_max_interval if adaptive else cc.deep_interval, 1)
        if interval <= 1:
            return False
        full_next = any(
            r.deep_state is None or r.deep_age >= interval - 1
            or (r.sampler_table is not None
                and r.sampler_table.step < cc.deep_warmup)
            # adaptive refresh: read the last FETCHED drift only (the
            # pipeline owns the pending-poll; a stale read here just
            # shifts the admission by a step)
            or (adaptive and r.drift_last > cc.deep_drift_threshold)
            for r in running)
        if full_next:
            return False
        steps_to_full = max(
            min(interval - 1 - r.deep_age for r in running), 1)
        wait_s = steps_to_full * max(step_s, 1e-3)
        rem = self._single_step_s(urgent.resolution) \
            * urgent.remain_steps
        # SLO beats cache: admit now if waiting would sink the candidate.
        return self._denoise_slack(urgent, now, rem) \
            > wait_s + MIN_RUNNING_SLACK_S

    def _displaced_defer(self, running: List[Request],
                         waiting: List[Request], now: float,
                         step_s: float) -> bool:
        """Accumulate-then-admit under displaced sequence parallelism.

        Every admission under ``sp_mode="displaced"`` is a KV-state
        boundary: the new composition re-runs ``displaced_warmup``
        fresh-gather sync steps for the WHOLE batch
        (pipelines/base.py _denoise_group_displaced), so trickling
        admissions one per iteration pays that resync per request.  Defer
        a candidate when (a) the accumulated waiting set can't yet fill
        the batch to its next bucket (one resync would amortize over more
        admissions) AND (b) the most urgent candidate's slack comfortably
        covers both the wait and the resync it will eventually trigger.
        SLO beats batching: pressure admits immediately.
        """
        pc = self.parallel_config
        if (pc is None or getattr(pc, "sp_mode", None) != "displaced"
                or not running or not waiting):
            return False
        # The pipeline serves GSPMD (no composition resync to amortize)
        # whenever the enabled cache is not plain fixed-interval deep on a
        # UNet family — mirror of pipelines/base.py _displaced_deep_ok;
        # deferring there would add queueing latency for nothing.
        cc = self.cache_config
        if cc is not None and getattr(cc, "enabled", False):
            plain_deep = (
                bool(getattr(cc, "plain_fixed_deep", lambda: False)())
                and self.family != "sd3")
            if not plain_deep:
                return False
        cur = len(running)
        next_bucket = next((b for b in self.config.batch_buckets
                            if b > cur), None)
        if next_bucket is None or len(waiting) >= next_bucket - cur:
            return False  # enough accumulated: admit the batch now
        urgent = waiting[0]
        rem = self._single_step_s(urgent.resolution) * urgent.remain_steps
        resync_s = getattr(pc, "displaced_warmup", 2) * max(step_s, 1e-3)
        return self._denoise_slack(urgent, now, rem) \
            > 2.0 * resync_s + MIN_RUNNING_SLACK_S

    def _schedule_denoising(self, pool: RequestPool, now: float) -> Optional[ScheduledBatch]:
        den = pool.in_stage(Stage.DENOISING)
        if not den:
            return None

        running = [r for r in den if r.start_denoising_time is not None]
        waiting = [r for r in den if r.start_denoising_time is None]
        aborts: List[Request] = []

        counts: Dict[int, int] = {res: 0 for res in self._resolutions}
        for r in running:
            key = self._counts_key(r.resolution)
            counts[key] = counts.get(key, 0) + 1

        def predict_step(extra_res: Optional[int] = None) -> float:
            c = dict(counts)
            if extra_res is not None:
                key = self._counts_key(extra_res)
                c[key] = c.get(key, 0) + 1
            return self._predict_counts(
                [c.get(res, 0) for res in self._resolutions])

        batch = list(running)
        budget = self.config.max_batch_size - len(batch)

        # slack-ordered candidates
        def cand_slack(r: Request) -> float:
            rem = self._single_step_s(r.resolution) * r.remain_steps
            return self._denoise_slack(r, now, rem)

        waiting = sorted(waiting, key=cand_slack)

        # Deep-phase-aligned admission: the deep cache runs one full/shallow
        # mode per batch step, and a new member's warmup forces full passes
        # for everyone — rolling admissions degrade the cache to off.  Defer
        # admissions until the step that will be a full pass anyway (it
        # refreshes every row's deep feature, so the batch re-synchronizes),
        # unless the most urgent candidate's slack cannot afford the wait.
        step_now = predict_step()
        if waiting and running and self._displaced_defer(running, waiting,
                                                         now, step_now):
            for r in batch:
                r.predicted_step_ms = step_now * 1000.0
            mixed = len({r.resolution for r in batch}) > 1
            return ScheduledBatch(Stage.DENOISING, batch, mixed=mixed)
        if waiting and running and self._deep_defer(running, waiting[0], now,
                                                    step_now):
            # batch == running here, non-empty by the gate
            for r in batch:
                r.predicted_step_ms = step_now * 1000.0
            mixed = len({r.resolution for r in batch}) > 1
            return ScheduledBatch(Stage.DENOISING, batch, mixed=mixed)

        while budget > 0 and waiting:
            target = waiting[0]
            t_slack = cand_slack(target)
            if t_slack < 0:
                # Cannot meet SLO even alone: abort (reference :323-327).
                waiting.pop(0)
                aborts.append(target)
                continue

            # Throughput mode: urgent candidate has ample slack => admit the
            # smallest-resolution candidate instead (reference :325-436).
            rem_t = self._single_step_s(target.resolution) * target.remain_steps
            if rem_t > 0 and t_slack / rem_t > THROUGHPUT_SLACK_RATIO:
                target = min(waiting, key=lambda r: r.resolution)

            # Would admitting `target` sink any running request?
            step_after = predict_step(target.resolution)
            ok = True
            for r in batch:
                rem = step_after * r.remain_steps
                if self._denoise_slack(r, now, rem) < MIN_RUNNING_SLACK_S:
                    ok = False
                    break
            if not ok:
                break

            waiting.remove(target)
            target.start_denoising_time = now
            target.predicted_step_ms = step_after * 1000.0
            # _counts_key, not the raw resolution: a fitted predictor only
            # has trained axes, and an off-axis count would be dropped from
            # every later feature vector (under-predicting the step)
            key = self._counts_key(target.resolution)
            counts[key] = counts.get(key, 0) + 1
            batch.append(target)
            budget -= 1

        if not batch and not aborts:
            return None
        step_s = predict_step()
        for r in batch:
            r.predicted_step_ms = step_s * 1000.0
        mixed = len({r.resolution for r in batch}) > 1
        return ScheduledBatch(Stage.DENOISING, batch, mixed=mixed, aborts=aborts)
