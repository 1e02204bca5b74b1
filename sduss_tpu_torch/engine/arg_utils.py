"""CLI argument surface -> Config (counterpart of
sduss_tpu/engine/arg_utils.py).

The JAX package's flags with its defaults, plus ``--device``.  ``--dp``
replicas are served (on ``cuda:0..dp-1`` from ``--device cuda``, all on
the CPU from ``--device cpu``) behind ``--dispatcher-policy`` (greedy or
round_robin); ``--tp``/``--sp`` above 1 give each replica an sp x tp
group of consecutive cards (``parallel/replica.py``); what a group does
not serve is refused by ``engine.check_supported`` when the Engine is
built.
"""

from __future__ import annotations

import argparse

from sduss_tpu_torch.config import (CacheConfig, Config, EngineConfig,
                                    ModelConfig, ParallelConfig,
                                    SchedulerConfig)


def add_engine_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    g = parser.add_argument_group("model")
    g.add_argument("--model", type=str, default="sd15",
                   help="family name (sd15|sdxl|sd3) or HF snapshot path")
    g.add_argument("--model-path", type=str, default=None)
    g.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--test-tiny", action="store_true",
                   help="tiny random-weight model (tests/dev)")
    g.add_argument("--no-patched", action="store_true",
                   help="disable the mixed-resolution patch pipeline")
    g.add_argument("--sampler", type=str, default=None,
                   choices=["euler", "flow_match", "ddim", "pndm"],
                   help="sampler override; default = family default")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu); "
                        "cuda raises without a GPU")

    g = parser.add_argument_group("parallel")
    g.add_argument("--data-parallel-size", "--dp", type=int, default=1)
    g.add_argument("--tensor-parallel-size", "--tp", type=int, default=1)
    g.add_argument("--spatial-parallel-size", "--sp", type=int, default=1)

    g = parser.add_argument_group("scheduler")
    g.add_argument("--policy", type=str, default="fcfs_mixed")
    g.add_argument("--max-batchsize", type=int, default=12)
    g.add_argument("--no-mixed-resolution", action="store_true")
    g.add_argument("--slo", type=float, default=5.0)
    g.add_argument("--predictor-path", type=str, default=None)

    g = parser.add_argument_group("cache")
    g.add_argument("--use-cache", action="store_true",
                   help="enable the output cache (see --cache-mode)")
    g.add_argument("--cache-mode", type=str, default="block",
                   choices=["block", "deep", "compact"],
                   help="block: per-patch masked splice; deep: temporal "
                        "deep-block reuse (the only mode the port serves); "
                        "compact: top-K compact recompute")
    g.add_argument("--deep-interval", type=int, default=2)
    g.add_argument("--deep-warmup", type=int, default=3)
    g.add_argument("--deep-adaptive", type=float, default=0.0,
                   help="drift threshold >0 switches deep reuse to "
                        "drift-triggered refresh (relative latent MSE "
                        "since the last full pass)")
    g.add_argument("--deep-max-interval", type=int, default=6,
                   help="safety cap between full passes under "
                        "--deep-adaptive")
    g.add_argument("--deep-row-warmup", action="store_true",
                   help="row-granular deep refresh: admissions / interval "
                        "expiries warm only their own rows (UNet families)")
    g.add_argument("--compact-fraction", type=float, default=0.5,
                   help="rows each gated block recomputes in compact mode")
    g.add_argument("--cache-classifier-path", type=str, default=None)

    g = parser.add_argument_group("engine")
    g.add_argument("--dispatcher-policy", type=str, default="greedy")
    g.add_argument("--collect-data", action="store_true",
                   help="record the schedule log, spans and counters, and "
                        "write them to engine.collect_dir when the engine "
                        "stops (README)")
    g.add_argument("--prewarm", action="store_true",
                   help="build the kernels and capture the step graphs "
                        "before serving (Engine.prewarm)")
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(
            model=args.model, model_path=args.model_path, dtype=args.dtype,
            seed=args.seed, use_patched=not args.no_patched,
            test_tiny=args.test_tiny, sampler=args.sampler),
        parallel=ParallelConfig(
            dp=args.data_parallel_size, tp=args.tensor_parallel_size,
            sp=args.spatial_parallel_size),
        scheduler=SchedulerConfig(
            policy=args.policy, max_batch_size=args.max_batchsize,
            use_mixed_resolution=not args.no_mixed_resolution,
            slo_scale=args.slo, predictor_path=args.predictor_path),
        cache=CacheConfig(enabled=args.use_cache, mode=args.cache_mode,
                          deep_interval=args.deep_interval,
                          deep_warmup=args.deep_warmup,
                          deep_adaptive=args.deep_adaptive > 0,
                          deep_drift_threshold=(args.deep_adaptive
                                                if args.deep_adaptive > 0
                                                else 0.05),
                          deep_max_interval=args.deep_max_interval,
                          deep_row_warmup=args.deep_row_warmup,
                          compact_fraction=args.compact_fraction,
                          classifier_path=args.cache_classifier_path),
        engine=EngineConfig(
            dispatcher_policy=args.dispatcher_policy,
            collect_data=args.collect_data,
            prewarm=args.prewarm),
    )
