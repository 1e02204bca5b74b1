"""SLO metric extraction (counterpart of sduss_tpu/benchmark/metrics.py;
reference scripts/draw/get_metric.py:7-120).

Given per-request records, computes the paper's four report metrics:
SLO attainment rate, average latency, goodput (SLO-met req/s) and
throughput (req/s), with the reference's SLO deadline tables and scale
factors (get_metric.py:36-57).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# E2E deadlines in seconds at SLO scale 5 (reference get_metric.py:44-57).
_SLO5_DEADLINES: Dict[str, Dict[int, float]] = {
    "sdxl": {512: 16.35, 768: 17.5, 1024: 19.31},
    "sd3": {512: 11.0, 768: 18.0, 1024: 30.0},
    # sd15 has no published table; scaled from its standalone latencies.
    "sd15": {256: 5.0, 512: 8.0, 768: 12.0},
}

# SLO scale factors (reference get_metric.py:36-42).
_SLO_FACTORS = {3: 0.6, 5: 1.0, 10: 2.0}


def slo_deadline_s(family: str, resolution: int, slo: int = 5,
                   overrides: Optional[Dict[int, float]] = None) -> float:
    table = overrides or _SLO5_DEADLINES[family]
    if resolution not in table:
        # Resolution outside the published table (e.g. SD3 at 256 in tiny
        # tests): scale the nearest entry by pixel count — deadlines track
        # per-step cost, which is ~linear in pixels.
        near = min(table, key=lambda r: abs(r - resolution))
        ddl = table[near] * (resolution / near) ** 2
    else:
        ddl = table[resolution]
    return ddl * _SLO_FACTORS.get(slo, slo / 5.0)


@dataclasses.dataclass
class RequestRecord:
    request_id: str
    resolution: int
    arrival_time: float
    finish_time: float
    aborted: bool = False

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.arrival_time


def compute_metrics(records: Sequence[RequestRecord], family: str,
                    slo: int = 5,
                    deadline_overrides: Optional[Dict[int, float]] = None) -> dict:
    if not records:
        return {"num_requests": 0}
    lat = np.asarray([r.latency_s for r in records])
    ok = np.asarray([
        (not r.aborted) and r.latency_s
        <= slo_deadline_s(family, r.resolution, slo, deadline_overrides)
        for r in records
    ])
    t0 = min(r.arrival_time for r in records)
    t1 = max(r.finish_time for r in records)
    span = max(t1 - t0, 1e-9)
    done = np.asarray([not r.aborted for r in records])
    return {
        "num_requests": len(records),
        "slo_attainment": float(ok.mean()),
        "avg_latency_s": float(lat[done].mean()) if done.any() else float("nan"),
        "p50_latency_s": float(np.percentile(lat[done], 50)) if done.any() else float("nan"),
        "p99_latency_s": float(np.percentile(lat[done], 99)) if done.any() else float("nan"),
        "goodput_rps": float(ok.sum() / span),
        "throughput_rps": float(done.sum() / span),
        "abort_rate": float(1.0 - done.mean()),
    }


def records_to_csv(records: Sequence[RequestRecord], path: str) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["request_id", "resolution", "arrival_time", "finish_time",
                    "latency_s", "aborted"])
        for r in records:
            w.writerow([r.request_id, r.resolution, f"{r.arrival_time:.6f}",
                        f"{r.finish_time:.6f}", f"{r.latency_s:.6f}", int(r.aborted)])


def records_from_csv(path: str) -> List[RequestRecord]:
    import csv

    out = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            out.append(RequestRecord(
                rec["request_id"], int(rec["resolution"]),
                float(rec["arrival_time"]), float(rec["finish_time"]),
                bool(int(rec["aborted"]))))
    return out
