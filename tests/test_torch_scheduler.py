"""The port's copy of the scheduler decides as the JAX package's does.

Both ``WorkerScheduler``s get one scripted arrival trace (resolutions,
step counts, arrival times) on a fake clock; after each iteration both
execute the same bookkeeping (prepare sets the step count, a denoise step
takes one off).  Every iteration must schedule the same stage, the same
requests in the same order, the same mixed flag and the same aborts, under
``fcfs_mixed`` and ``esymred``.
"""

from __future__ import annotations

import time

import pytest

from sduss_tpu import config as jconfig
from sduss_tpu import request as jrequest
from sduss_tpu import scheduler as jscheduler
from sduss_tpu_torch import config as tconfig
from sduss_tpu_torch import request as trequest
from sduss_tpu_torch import scheduler as tscheduler
from test_torch_slice import torch_threads  # noqa: F401

T0 = 1_000_000.0
TICK_S = 0.05
# (offset s at which the request is added, resolution, steps, age s: how
# long before that it arrived — an old one has no slack left and ESyMReD
# aborts it)
TRACE = [
    (0.0, 512, 4, 0.0), (0.0, 1024, 6, 0.0), (0.1, 768, 4, 0.0),
    (0.3, 1024, 3, 0.0), (0.3, 512, 5, 0.0), (0.6, 768, 6, 10_000.0),
    (0.6, 1024, 2, 0.0), (1.0, 512, 3, 0.0), (1.2, 768, 4, 0.0),
]


def _run(pkg_config, pkg_request, pkg_scheduler, policy, clock):
    """Drive one scheduler through TRACE; ``clock[0]`` is what time.time
    returns."""
    clock[0] = T0
    sc = pkg_config.SchedulerConfig(policy=policy, max_batch_size=4,
                                    step_time_ema=0.0)
    sched = pkg_scheduler.WorkerScheduler(sc, "sdxl")
    pending = list(enumerate(TRACE))
    log = []
    for _ in range(400):
        now = clock[0]
        while pending and T0 + pending[0][1][0] <= now:
            i, (off, res, steps, age) = pending.pop(0)
            req = pkg_request.Request(
                f"r{i}", pkg_request.SamplingParams(
                    prompt=f"p{i}", resolution=res, num_inference_steps=steps),
                arrival_time=T0 + off - age)
            sched.add_request(req)
        if not pending and not sched.has_unfinished():
            break
        batch = sched.schedule()
        if batch is not None and not batch.empty:
            log.append((batch.stage.value, [r.request_id for r in batch.requests],
                        batch.mixed, [r.request_id for r in batch.aborts],
                        [round(r.predicted_step_ms, 9) for r in batch.requests]))
            for r in batch.requests:
                if batch.stage.value == "prepare":
                    r.remain_steps = r.params.num_inference_steps
                elif batch.stage.value == "denoising":
                    r.remain_steps -= 1
            sched.advance(batch)
        clock[0] += TICK_S
    assert not sched.has_unfinished()
    return log


@pytest.mark.parametrize("policy", ["fcfs_mixed", "esymred"])
def test_same_batches_in_same_order(monkeypatch, policy):
    clock = [T0]
    # every policy reads the clock through time.time
    monkeypatch.setattr(time, "time", lambda: clock[0])
    jax_log = _run(jconfig, jrequest, jscheduler, policy, clock)
    port_log = _run(tconfig, trequest, tscheduler, policy, clock)
    assert port_log == jax_log
    stages = {entry[0] for entry in jax_log}
    assert {"prepare", "denoising", "post"} <= stages
    assert any(entry[2] for entry in jax_log)  # a mixed denoise batch
    if policy == "esymred":
        assert any(entry[3] for entry in jax_log)  # an abort
