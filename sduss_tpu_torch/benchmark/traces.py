"""Workload traces: Poisson arrivals over resolution mixtures (counterpart
of sduss_tpu/benchmark/traces.py; numpy only, so the same seed gives the
same rows in both packages).

Mirrors the reference's trace format (exp/{sdxl,sd3,sd1.5}/qps_*.csv:
arrival_ms, resolution, steps — consumed by tests/server/direct_test.py) and
its resolution-distribution variants (_small/_medium/_large,
scripts/paper/distribution.sh:21).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Resolution mixture variants (probability per resolution, low->high).
DISTRIBUTIONS: Dict[str, Sequence[float]] = {
    "uniform": (1 / 3, 1 / 3, 1 / 3),
    "small": (0.6, 0.3, 0.1),
    "medium": (0.2, 0.6, 0.2),
    "large": (0.1, 0.3, 0.6),
}


@dataclasses.dataclass
class TraceRow:
    arrival_ms: float
    resolution: int
    steps: int
    prompt: str = "a photograph of an astronaut riding a horse"


def generate_trace(qps: float, num_requests: int, resolutions: Sequence[int],
                   distribution: str = "uniform", steps: int = 50,
                   seed: int = 0,
                   prompts: Optional[Sequence[str]] = None) -> List[TraceRow]:
    """Poisson arrivals at ``qps`` with the given resolution mixture."""
    rng = np.random.default_rng(seed)
    probs = DISTRIBUTIONS[distribution]
    if len(probs) != len(resolutions):
        if distribution != "uniform":
            # silently substituting uniform would make a small/medium/large
            # distribution sweep report identical numbers with no error
            raise ValueError(
                f"distribution {distribution!r} has {len(probs)} weights "
                f"but {len(resolutions)} resolutions are deployed")
        probs = [1.0 / len(resolutions)] * len(resolutions)
    gaps = rng.exponential(1000.0 / qps, size=num_requests)
    arrivals = np.cumsum(gaps)
    res = rng.choice(list(resolutions), size=num_requests, p=list(probs))
    rows = []
    for i in range(num_requests):
        prompt = prompts[i % len(prompts)] if prompts else TraceRow.prompt
        rows.append(TraceRow(float(arrivals[i]), int(res[i]), steps, prompt))
    return rows


def save_trace(rows: Sequence[TraceRow], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["arrival_ms", "resolution", "steps", "prompt"])
        for r in rows:
            w.writerow([f"{r.arrival_ms:.3f}", r.resolution, r.steps, r.prompt])


def load_trace(path: str) -> List[TraceRow]:
    rows = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            rows.append(TraceRow(float(rec["arrival_ms"]), int(rec["resolution"]),
                                 int(rec["steps"]),
                                 rec.get("prompt", TraceRow.prompt)))
    return rows
