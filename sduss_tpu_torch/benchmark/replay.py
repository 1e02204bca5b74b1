"""Trace replay: the primary serving benchmark (counterpart of
sduss_tpu/benchmark/replay.py).

Rebuild of the reference's direct-test harness
(tests/server/direct_test.py:56-100): replays a Poisson trace against an
in-process ``AsyncEngine`` as asyncio coroutines, records per-request
results and reports the paper's SLO metrics (scripts/draw/get_metric.py).
A request's arrival is stamped before it is added, so the wait for the
engine's thread (a step in flight) counts in its latency.

CLI (``--device`` defaults to ``cuda``; ``--tiny --device cpu`` runs the
replay on the CPU at small sizes)::

    python -m sduss_tpu_torch.benchmark.replay --model sdxl \
        --trace exp/sdxl/qps_1.0.csv --num-requests 8 --policy esymred \
        --profile sduss_tpu_torch/scheduler/h100/profile_sdxl.json \
        --predictor sduss_tpu_torch/scheduler/h100/predictor_sdxl.npz \
        --slo 5 --out client.csv
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import List, Optional, Sequence

import torch

from sduss_tpu_torch.benchmark.metrics import (RequestRecord, compute_metrics,
                                               records_to_csv, slo_deadline_s)
from sduss_tpu_torch.benchmark.traces import TraceRow, generate_trace, load_trace
from sduss_tpu_torch.config import Config, ModelConfig
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.request import SamplingParams

logger = init_logger(__name__)


async def replay(engine, rows: Sequence[TraceRow], family: str, slo: int = 5,
                 time_scale: float = 1.0) -> List[RequestRecord]:
    """Replay a trace; returns one record per request (incl. aborted)."""
    start = time.time()
    records: List[RequestRecord] = []

    async def one(i: int, row: TraceRow):
        target = start + row.arrival_ms / 1000.0 * time_scale
        delay = target - time.time()
        if delay > 0:
            await asyncio.sleep(delay)
        arrival = time.time()
        deadline = arrival + slo_deadline_s(family, row.resolution, slo)
        params = SamplingParams(prompt=row.prompt, resolution=row.resolution,
                                num_inference_steps=row.steps, seed=i)
        out = await engine.generate(params, request_id=f"replay-{i}",
                                    deadline=deadline)
        records.append(RequestRecord(
            out.request_id, row.resolution, arrival, time.time(),
            aborted=out.aborted))

    await asyncio.gather(*(one(i, r) for i, r in enumerate(rows)))
    return records


def run_replay(config: Config, rows: Sequence[TraceRow], slo: int = 5,
               time_scale: float = 1.0, prewarm: bool = True,
               device: torch.device | str = "cuda",
               engine=None) -> List[RequestRecord]:
    """Build an ``AsyncEngine`` on ``device`` (or serve ``engine``, a
    prebuilt ``Engine``), prewarm the trace's resolutions on every replica
    before timing (JAX replay.py:69), replay ``rows`` and stop the
    engine."""
    from sduss_tpu_torch.engine.async_engine import AsyncEngine

    async def main():
        aengine = AsyncEngine(config, engine=engine, device=device)
        try:
            if prewarm:
                # kernels built, allocator and graphs warm at every (res x
                # bucket) the trace can hit, before the clock starts
                res = sorted({r.resolution for r in rows})
                aengine.engine.prewarm(resolutions=res)
            return await replay(aengine, rows, config.model.family, slo,
                                time_scale)
        finally:
            await aengine.stop()

    return asyncio.run(main())


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser("sduss_tpu_torch trace replay")
    ap.add_argument("--model", default="sdxl")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--resolutions", default="",
                    help="comma list overriding the family's deployed "
                         "resolutions (tiny CPU runs of the replay)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--qps", type=float, default=1.0)
    ap.add_argument("--num-requests", type=int, default=100)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--distribution", default="uniform")
    ap.add_argument("--policy", default="esymred")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--slo", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="replay a saved trace CSV (exp/*/qps_*.csv) instead "
                         "of generating one")
    ap.add_argument("--out", default=None)
    ap.add_argument("--predictor", default=None,
                    help="LatencyPredictor npz (scheduler/profiler.py; the "
                         "card's fits are in sduss_tpu_torch/scheduler/h100)")
    ap.add_argument("--profile", default=None,
                    help="StageProfile JSON (scheduler/profiler.py)")
    ap.add_argument("--classifiers", default=None,
                    help="cache classifier npz (cache/train.py); enables "
                         "the block cache")
    ap.add_argument("--cache-mode", default="compact",
                    choices=("block", "compact", "deep"))
    ap.add_argument("--compact-fraction", type=float, default=0.5)
    ap.add_argument("--deep-interval", type=int, default=0,
                    help="enable temporal deep-block reuse at this interval "
                         "(no classifiers needed)")
    ap.add_argument("--no-prewarm", dest="prewarm", action="store_false",
                    default=True,
                    help="skip warming every (resolution x bucket) step "
                         "before the timed replay")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda, cuda:N or cpu); "
                         "cuda raises without a GPU; dp replicas take "
                         "cuda:0..dp-1")
    args = ap.parse_args(argv)

    config = Config()
    config.model = ModelConfig(
        model=args.model, test_tiny=args.tiny, dtype=args.dtype,
        resolutions=tuple(int(r) for r in args.resolutions.split(","))
        if args.resolutions else ())
    config.scheduler.policy = args.policy
    config.scheduler.slo_scale = float(args.slo)
    config.parallel.dp = args.dp
    if args.predictor:
        config.scheduler.predictor_path = args.predictor
    if args.profile:
        with open(args.profile) as f:
            config.scheduler.stage_latency_overrides = json.load(f)
    if args.classifiers:
        config.cache.enabled = True
        config.cache.mode = args.cache_mode
        config.cache.compact_fraction = args.compact_fraction
        config.cache.classifier_path = args.classifiers
    if args.deep_interval:
        config.cache.enabled = True
        config.cache.mode = "deep"
        config.cache.deep_interval = args.deep_interval

    if args.trace:
        rows = load_trace(args.trace)[: args.num_requests]
    else:
        rows = generate_trace(args.qps, args.num_requests,
                              config.model.resolutions, args.distribution,
                              steps=args.steps, seed=args.seed)
    records = run_replay(config, rows, slo=args.slo, prewarm=args.prewarm,
                         device=args.device)
    metrics = compute_metrics(records, config.model.family, slo=args.slo)
    if args.out:
        records_to_csv(records, args.out)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
