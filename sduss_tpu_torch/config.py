"""Typed configuration for the whole framework.

The port's own copy of the JAX package's configuration (same dataclasses,
fields and defaults), so that ``sduss_tpu_torch`` imports nothing of
``sduss_tpu``.  Everything lives in one place, as plain dataclasses that
serialize to/from dicts, so engine, scheduler and kernels share a single
source of truth.  Fields of paths the port has not carried over yet (the
caches, sequence/tensor parallelism, prewarm) are kept so both packages
read the same configuration; the engine refuses the values it cannot serve.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, Union


def _positive(name: str, value: int) -> None:
    if value < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")


@dataclass
class ModelConfig:
    """Which model family to serve and how to realize it on device.

    ``model`` is either a registered family name ("sd15", "sdxl", "sd3") for
    random/tiny instantiation, or a path to a HuggingFace snapshot directory
    containing ``model_index.json``.
    """

    model: str = "sd15"
    # Path to a HF snapshot dir; None => randomly initialized weights.
    model_path: Optional[str] = None
    # Compute dtype for the denoiser/encoders ("bfloat16" | "float32").
    dtype: str = "bfloat16"
    # VAE decode dtype ("auto" = the family's default).
    vae_dtype: str = "auto"
    # Sampler override ("euler" | "flow_match" | "ddim" | "pndm");
    # None => family default.
    sampler: Optional[str] = None
    seed: int = 0
    # Use the mixed-resolution patch pipeline (vs plain per-res batch).
    use_patched: bool = True
    # Tiny-model override for tests: scale factor applied to channel widths.
    test_tiny: bool = False
    # Resolutions this deployment accepts; default filled per family.
    resolutions: Tuple[int, ...] = ()
    # Safety checker: None = off; a HF safety_checker/ dir = load weights;
    # "random" = random weights (tests only).
    safety_checker_path: Optional[str] = None
    # Keep text-encoder params in host memory and run text encoding on the
    # host ("auto" decides from the bundle's size against device memory).
    encoders_on_host: Union[bool, str] = "auto"
    # "auto" residency spills encoders when bundle bytes exceed this
    # fraction of device memory (leaves room for step activations).
    SPILL_FRACTION: ClassVar[float] = 0.6
    # Spatially-tiled VAE decode: latent tile edge (0 = full-frame decode).
    # "auto" (-1) per family in __post_init__: 64 for sd3, off otherwise.
    vae_tile_latent: int = -1
    vae_tile_overlap: int = 16

    def __post_init__(self) -> None:
        if not self.resolutions:
            defaults = {
                "sd15": (256, 512, 768),
                "sdxl": (512, 768, 1024),
                "sd3": (512, 768, 1024),
            }
            fam = self.family
            self.resolutions = tuple(defaults.get(fam, (256, 512)))
        if self.vae_tile_latent < 0:  # auto: tile the memory-heavy SD3 decode
            self.vae_tile_latent = 64 if (self.family == "sd3"
                                          and not self.test_tiny) else 0

    @property
    def family(self) -> str:
        """Model family key: sd15 | sdxl | sd3."""
        m = self.model.lower()
        for fam in ("sd15", "sdxl", "sd3"):
            if fam in m.replace("-", "").replace("_", "").replace(".", ""):
                return fam
        if os.path.isdir(self.model) or (self.model_path and os.path.isdir(self.model_path)):
            # Inspect model_index.json for the pipeline class.
            root = self.model_path or self.model
            idx = os.path.join(root, "model_index.json")
            if os.path.exists(idx):
                with open(idx) as f:
                    cls = json.load(f).get("_class_name", "")
                if "3" in cls:
                    return "sd3"
                if "XL" in cls:
                    return "sdxl"
                return "sd15"
        raise ValueError(f"Cannot infer model family from {self.model!r}")


@dataclass
class ParallelConfig:
    """Device layout: ``dp`` replicas x ``tp`` tensor-parallel shards x
    ``sp`` spatial(patch)-parallel shards x ``pp`` pipeline stages."""

    dp: int = 1
    tp: int = 1
    sp: int = 1  # spatial / displaced-patch parallel degree
    # How a replica's sp>1 group runs the serving denoise step:
    #   "gspmd"     — fresh KV gathers/halos every step (exact, the default);
    #   "displaced" — stale-KV path: after ``displaced_warmup`` sync steps
    #                 the self-attention K/V of remote rows come from the
    #                 previous step's state.  Requires tp == 1.
    sp_mode: str = "gspmd"
    displaced_warmup: int = 2  # sync steps after a composition change
    # Pipeline-stage parallel degree.
    pp: int = 1
    # Explicit device list (device indices); None => first world_size.
    devices: Optional[List[int]] = None

    def __post_init__(self) -> None:
        _positive("dp", self.dp)
        _positive("tp", self.tp)
        _positive("sp", self.sp)
        _positive("pp", self.pp)
        if self.sp_mode not in ("gspmd", "displaced"):
            raise ValueError(f"sp_mode must be gspmd|displaced, got {self.sp_mode!r}")
        if self.sp_mode == "displaced" and self.tp > 1:
            raise ValueError("sp_mode='displaced' shards the denoiser over "
                             "'sp' only; tp must be 1")
        if self.displaced_warmup < 1:
            raise ValueError("displaced_warmup must be >= 1 (the first step "
                             "after a composition change must gather fresh KV)")

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.sp * self.pp


@dataclass
class SchedulerConfig:
    """Worker-side iteration scheduler knobs, plus the ESyMReD
    hyper-parameters."""

    policy: str = "fcfs_mixed"  # fcfs_single|fcfs_mixed|orca_resbyres|orca_round_robin|esymred
    max_batch_size: int = 12
    # Fused multi-step dispatch: when > 1, a stable denoising batch runs up
    # to this many sampler steps per host dispatch (on the card, replays of
    # captured step graphs).  Admissions and aborts then act at chunk
    # boundaries.  Ineligible configurations (stateful samplers, adaptive
    # deep refresh, stale-KV, SD3 mixed batches) step once per dispatch.
    steps_per_dispatch: int = 1
    # Mixed-resolution patch batching.
    use_mixed_resolution: bool = True
    patch_size: int = 256  # pixels; /8 => 32x32 latent patches
    # ESyMReD knobs.  Aborted requests leave the pool immediately.
    slo_scale: float = 5.0
    postprocessing_ratio: float = 0.9
    # Path to a trained latency predictor (npz); None => analytic fallback.
    predictor_path: Optional[str] = None
    # EMA weight for the realized-step-time correction: the predictor is
    # fitted on cache-off profiler steps, so the policy learns a
    # multiplicative correction from executed iterations once the worker's
    # dispatch throttle saturates.  0 disables (tests that assert exact
    # predicted_step_ms values do).
    step_time_ema: float = 0.2
    # Per-(family,resolution) standalone stage latencies in SECONDS used for
    # deadlines (StageProfile tables are seconds, scheduler/profiles.py),
    # populated by profiling (profiles.py has defaults).
    stage_latency_overrides: Dict[str, Any] = field(default_factory=dict)
    # Max images per VAE-decode call: full-res decode activations are the
    # memory peak of the whole pipeline; bigger post batches are chunked.
    decode_batch: int = 2
    # Batch-size buckets (admission ceiling; metadata padding).
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 12, 16, 24, 32)
    # Patch-count buckets for the mixed-resolution patch batch. Finer steps
    # in the common range: e.g. a (512 + 1024) pair is 20 patches — a
    # 32-bucket would waste 60% of the patch compute.
    patch_buckets: Tuple[int, ...] = (4, 8, 12, 16, 20, 24, 32, 40, 48, 64,
                                      80, 96, 128, 160, 192, 256)

    def __post_init__(self) -> None:
        # The largest bucket is the hard batch ceiling: every stage pads to
        # a bucket, so a policy batch above buckets[-1] would need a
        # negative pad.  Narrowing the bucket list narrows max_batch_size.
        if self.batch_buckets:
            self.max_batch_size = min(self.max_batch_size,
                                      self.batch_buckets[-1])


@dataclass
class CacheConfig:
    """Learned per-block output cache settings.  The port serves every
    mode of the JAX package: for sd15 and sdxl ``mode="deep"`` on the dense
    and the mixed patch path, "block" on the patch path (the dense path
    runs it cache-off, as JAX does) and "compact" on both; for SD3
    ``sd3_deep_span`` and the token modes "block" and "compact" on its
    token path."""

    enabled: bool = False
    # "block": per-patch masked recompute splice;
    # "deep": temporal deep-block reuse — full step every deep_interval
    # steps, shallow steps reuse the cached deep feature;
    # "compact": top-K compact recompute — each gated block recomputes only
    # the compact_fraction most-drifted rows and reuses cached outputs for
    # the rest (rows must be independent under the block).
    mode: str = "block"
    # Fraction of rows each gated block recomputes in "compact" mode.
    compact_fraction: float = 0.5
    # Second-level per-PATCH fraction inside recomputed images on the mixed
    # patch path: only the patch_fraction most-drifted patch rows run the
    # per-token transformer tail; 1.0 = off (image granularity only).
    patch_fraction: float = 1.0
    # Stale-KV splice for the per-token fine cache (MMDiT): unselected
    # tokens reuse the previous step's attention K/V.  Exact at
    # patch_fraction 1.0, approximate below it.
    fine_stale_kv: bool = False
    # LRU bound on the batch-composition row-state stores.
    comp_state_lru: int = 2
    # Byte budget across retained composition-state entries; the newest
    # entry is always kept.
    comp_state_bytes: float = 3e9
    deep_interval: int = 2
    # Always-full steps at the start of each trajectory.
    deep_warmup: int = 3
    # Drift-triggered adaptive refresh (replaces the fixed interval when
    # True): a request runs a full pass only once its latent has drifted
    # past deep_drift_threshold (relative MSE vs its latent at the last
    # full pass) or deep_max_interval shallow steps have elapsed.
    deep_adaptive: bool = False
    deep_drift_threshold: float = 0.05
    deep_max_interval: int = 6
    # Deep-phase-aligned admission: ESyMReD defers admissions to full-pass
    # boundaries; a candidate whose SLO slack cannot afford the wait is
    # admitted immediately (SLO beats cache).
    phase_admission: bool = True
    # Row-granular deep warmup (UNet dense path): rows that need a full
    # pass are served by a "partial" step — shallow spine for every row
    # plus the deep tail for just those rows.  It composes with the hybrid
    # (deep_compact_fraction): a new batch composition's row caches are
    # carried over from the previous one's surviving rows, and a finished
    # request's survivors keep theirs.
    deep_row_warmup: bool = False
    # Deep x compact hybrid (mode "deep" only): on shallow steps, gate the
    # shallow block pairs with top-K compact row recompute.  None = off;
    # 1.0 = on at full capacity (equal to plain deep mode).
    deep_compact_fraction: Optional[float] = None
    # Hybrid row selection unit: True = CFG pairs (both halves of an image
    # recompute together).
    deep_compact_pairwise: bool = True
    # Reuse-then-predict: shallow steps feed a first-order extrapolation of
    # the deep features instead of holding them frozen.  0 = plain reuse.
    deep_predict: float = 0.0
    # Reuse-then-predict for compact row caches.  0 = plain splice.
    compact_predict: float = 0.0
    # Deep boundary level; None => deepest level + mid.
    deep_boundary: Optional[int] = None
    # SD3/MMDiT span-skip deep cache: (lo, hi) block span skipped on
    # shallow steps via the cached residual delta.  None = off.
    sd3_deep_span: Optional[Tuple[int, int]] = None
    # Force recompute after this many consecutive cache hits.
    max_hits: int = 4
    # Only gate blocks at resolution level >= this (0 = full latent res).
    min_level: int = 1
    # Path to trained per-block classifiers (one npz); None =>
    # relative-MSE-threshold fallback.
    classifier_path: Optional[str] = None
    mse_threshold: float = 0.01

    def plain_fixed_deep(self) -> bool:
        """Enabled plain fixed-interval deep reuse — no hybrid rows, no
        adaptive refresh, no reuse-then-predict (the one predicate the
        pipeline and the ESyMReD policy share)."""
        return (self.enabled and self.mode == "deep"
                and self.deep_compact_fraction is None
                and not self.deep_adaptive and not self.deep_predict)

    @classmethod
    def production(cls, family: str, serving: bool = True) -> "CacheConfig":
        """Cache presets per model family.

        - sdxl/sd15: deep reuse x compact CFG-pair rows (fraction 0.3) at
          boundary 1; serving keeps a fixed interval (24 for SDXL with
          row-granular warmup), offline batches get the adaptive schedule.
        - sd3: wide span-skip 1:24, interval 16 serving / 30 offline.
        """
        if family == "sd3":
            return cls(enabled=True, mode="deep", sd3_deep_span=(1, 24),
                       deep_interval=16 if serving else 30, deep_warmup=3)
        cfg = cls(enabled=True, mode="deep", deep_interval=12,
                  deep_warmup=3, deep_compact_fraction=0.3,
                  deep_compact_pairwise=True, deep_boundary=1)
        if serving and family == "sdxl":
            cfg.deep_interval = 24
            cfg.deep_row_warmup = True
        if serving and family == "sd15":
            cfg.deep_row_warmup = True
        if not serving:
            cfg.deep_adaptive = True
            cfg.deep_drift_threshold = 0.3
            cfg.deep_max_interval = 30
            cfg.deep_warmup = 1
            cfg.deep_predict = 0.5
        return cfg


@dataclass
class EngineConfig:
    """Front-end engine + dispatcher settings."""

    dispatcher_policy: str = "greedy"
    # Warm every step kind at startup (Engine.prewarm): the kernels are
    # built and, with steps_per_dispatch > 1, the step graphs captured.
    prewarm: bool = False
    # Max denoise steps the host may dispatch ahead of the device (see
    # engine/worker.py module docstring).  0 disables throttling.
    max_inflight_steps: int = 2
    # Run the prepare stage (text encode + latent init) on a background host
    # thread ("auto" = async exactly when the encoders live on the host).
    async_prepare: Union[bool, str] = "auto"
    # Run VAE decode + image fetch on a background host thread.
    async_postprocess: Union[bool, str] = "auto"
    # Seconds between background engine-loop polls when idle.
    poll_interval_s: float = 0.01
    log_requests: bool = True
    collect_data: bool = False
    collect_dir: str = "outputs"
    # Persistent compilation cache directory; None disables.
    compilation_cache_dir: Optional[str] = "~/.cache/sduss_tpu_xla"
    # Prewarm capacity gate: workspace margin in bytes.
    prewarm_hbm_margin: float = 4e9
    # Cap on auto-enumerated mixed compositions prewarm compiles.
    # 0 = unlimited.
    prewarm_mixed_limit: int = 24
    # Device memory budget when the runtime reports none.
    hbm_bytes_fallback: float = 16e9
    # Serving-decode capacity gate: per-image transient bytes per pixel and
    # a margin, capping the decode group to what fits next to live state.
    # 3585: the transient of SDXL's bf16 VAE decode at 1024^2 on an H100
    # (3584.4 B/px for one and two images, chip_smoke.py
    # check_vae_dtype), the largest of the port's decodes.  The JAX
    # package's 768 comes from XLA, which fuses the decoder's group norms;
    # the port's eager group norm keeps float32 copies of the largest
    # activation (its moments and affine run in float32), so its bf16
    # decode peaks above the float32 one (3072.50 B/px).
    decode_bytes_per_pixel: float = 3585.0
    decode_hbm_margin: float = 1.5e9


@dataclass
class Config:
    """Top-level bundle passed around the system."""

    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(
            model=ModelConfig(**d.get("model", {})),
            parallel=ParallelConfig(**d.get("parallel", {})),
            scheduler=SchedulerConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                         for k, v in d.get("scheduler", {}).items()}),
            cache=CacheConfig(**d.get("cache", {})),
            engine=EngineConfig(**d.get("engine", {})),
        )


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value.

    A value above the largest bucket is a scheduling bug: SchedulerConfig
    clamps max_batch_size to buckets[-1], so raise loudly if a batch slips
    past that invariant.
    """
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(
        f"batch of {value} exceeds the largest bucket {buckets[-1]}; "
        "max_batch_size must be <= batch_buckets[-1]")
