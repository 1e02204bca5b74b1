"""Stage-latency profiles used for SLO deadlines and admission decisions.

Rebuilds the reference's esymred.json + sm_util_*.csv profile tables
(sduss/worker/scheduler/configs/esymred.json:1-48, ESyMReD.py:105-119) as one
typed structure.  Defaults below are the reference config's anchors; a
profile JSON the SchedulerConfig points at replaces them.  The port's
profiler (``scheduler/profiler.py``) measures them on the card; the files
it fitted on an H100 are in ``scheduler/h100/``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

# Standalone single-request latencies in SECONDS at 50 denoising steps
# (denoise) and for one VAE decode (post), per family per resolution.
_DEFAULT_STANDALONE: Dict[str, Dict[str, Dict[str, float]]] = {
    "sd15": {
        "denoising": {"256": 1.0, "512": 1.6, "768": 2.4},
        "postprocessing": {"256": 0.03, "512": 0.05, "768": 0.08},
    },
    "sdxl": {
        "denoising": {"512": 3.2, "768": 3.4, "1024": 3.7},
        "postprocessing": {"512": 0.07, "768": 0.1, "1024": 0.16},
    },
    "sd3": {
        "denoising": {"512": 2.07, "768": 3.37, "1024": 5.92},
        "postprocessing": {"512": 0.09, "768": 0.12, "1024": 0.17},
    },
}

# Per-step single-request denoiser latency in seconds (reference
# ESyMReD.py:30-42 hardcodes these per model).
_DEFAULT_STEP_LATENCY: Dict[str, Dict[str, float]] = {
    "sd15": {"256": 0.012, "512": 0.02, "768": 0.032},
    "sdxl": {"512": 0.04, "768": 0.045, "1024": 0.054},
    "sd3": {"512": 0.0414, "768": 0.0574, "1024": 0.065},
}

# Shallow/full deep-cache step-cost ratios (the JAX package's defaults;
# SD1.5's UNet mirrors SDXL's structure).
_SHALLOW_STEP_RATIO: Dict[str, float] = {
    "sdxl": 0.434, "sd15": 0.434, "sd3": 0.053}


def shallow_step_ratio(family: str, cache_config=None) -> float:
    """Boundary-aware shallow/full step-cost ratio — the ONE source of
    truth for both the scheduler's EMA prior (cache_step_factor) and the
    policy-matrix simulator's virtual clock.  Boundary-1 shallow steps
    are conv-only, far cheaper than the default-boundary ratio says."""
    ratio = _SHALLOW_STEP_RATIO.get(family, 1.0)
    if (cache_config is not None
            and getattr(cache_config, "deep_boundary", None) == 1
            and family in ("sdxl", "sd15")):
        ratio = 0.06
    return ratio


@dataclasses.dataclass
class StageProfile:
    family: str
    slo_scale: float = 5.0
    standalone: Dict[str, Dict[str, float]] = None  # type: ignore[assignment]
    step_latency: Dict[str, float] = None  # type: ignore[assignment]
    # post latency per batch size (index b-1 => batch of b); extrapolated
    # linearly past the table end.
    post_batch_latency: Optional[Dict[str, List[float]]] = None

    def __post_init__(self) -> None:
        if self.standalone is None:
            self.standalone = _DEFAULT_STANDALONE[self.family]
        if self.step_latency is None:
            self.step_latency = _DEFAULT_STEP_LATENCY[self.family]
        if self.post_batch_latency is None:
            self.post_batch_latency = {
                res: [t * (1 + 0.35 * b) for b in range(32)]
                for res, t in self.standalone["postprocessing"].items()
            }

    # -- deadlines (reference esymred_utils.py:14-44) ------------------------

    @staticmethod
    def _lookup(table: Dict[str, float], resolution: int) -> float:
        """Table lookup with pixel-count extrapolation for unseen
        resolutions: scale the nearest measured entry by the pixel ratio
        (denoise/VAE cost is ~linear in latent pixels).  A deployment
        serving a resolution outside its profile (e.g. an sdxl profile
        asked about 256) must degrade to an estimate, not KeyError."""
        key = str(resolution)
        if key in table:
            return table[key]
        nearest = min(table, key=lambda r: abs(int(r) - resolution))
        return table[nearest] * (resolution / int(nearest)) ** 2

    def denoising_ddl_s(self, resolution: int) -> float:
        return self._lookup(self.standalone["denoising"],
                            resolution) * self.slo_scale

    def e2e_ddl_s(self, resolution: int) -> float:
        return (self._lookup(self.standalone["denoising"], resolution)
                + self._lookup(self.standalone["postprocessing"],
                               resolution)) * self.slo_scale

    def step_latency_s(self, resolution: int) -> float:
        return self._lookup(self.step_latency, resolution)

    def post_latency_s(self, resolution: int, batch_size: int = 1) -> float:
        key = str(resolution)
        if key not in self.post_batch_latency:
            nearest = min(self.post_batch_latency,
                          key=lambda r: abs(int(r) - resolution))
            tbl = [t * (resolution / int(nearest)) ** 2
                   for t in self.post_batch_latency[nearest]]
        else:
            tbl = self.post_batch_latency[key]
        if batch_size <= len(tbl):
            return tbl[batch_size - 1]
        return tbl[-1] * batch_size / len(tbl)

    def cache_step_factor(self, cache_config) -> float:
        """Expected steady-state (cache-on / cache-off) step-cost ratio.

        The latency predictor is fitted on cache-off profiler steps, but
        serving may run cache-on — raw predictions overestimate ~(1/factor)x
        and a cold-start EMA takes tens of iterations to learn it down,
        during which the slack math refuses healthy admissions.  Priming
        the correction from the cache schedule removes the cold start; the
        realized-step-time EMA still refines the residual online.

        Steady state under a deep interval k: 1 full + (k-1) shallow
        steps per k, shallow costing ``_SHALLOW_STEP_RATIO[family]`` of a
        full.
        """
        cc = cache_config
        if cc is None or not getattr(cc, "enabled", False):
            return 1.0
        if getattr(cc, "mode", None) != "deep":
            return 1.0  # compact/fine token gates: smaller, load-dependent
        adaptive = getattr(cc, "deep_adaptive", False)
        interval = max(cc.deep_max_interval if adaptive
                       else cc.deep_interval, 1)
        if interval <= 1:
            return 1.0
        ratio = shallow_step_ratio(self.family, cc)
        return (1.0 + (interval - 1) * ratio) / interval

    # -- persistence ---------------------------------------------------------

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "StageProfile":
        with open(path) as f:
            d = json.load(f)
        return cls(**d)


def get_profile(family: str, slo_scale: float = 5.0,
                overrides: Optional[dict] = None) -> StageProfile:
    kw = dict(overrides or {})
    kw.pop("family", None)
    kw.pop("slo_scale", None)
    return StageProfile(family=family, slo_scale=slo_scale, **kw)
