"""Engine metrics: counters + per-request records + SLO/goodput extraction.

Replaces the reference's unwired aioprometheus gauges (engine/metrics.py:7-51)
and CSV post-processing (scripts/draw/get_metric.py:7-120) with an in-process
stats object the API server and benchmark harness read directly.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

from sduss_tpu_torch.request import Request, RequestOutput

# E2E SLO deadlines in seconds at SLO scale 5 (reference
# scripts/draw/get_metric.py:44-57); scaled by slo_scale/5.
_E2E_DDL_S = {
    "sdxl": {512: 16.35, 768: 17.5, 1024: 19.31},
    "sd3": {512: 11.0, 768: 18.0, 1024: 30.0},
    "sd15": {256: 5.0, 512: 8.0, 768: 12.0},
}


@dataclasses.dataclass
class RequestRecord:
    request_id: str
    resolution: int
    arrival_time: float
    finish_time: float
    first_scheduled_time: Optional[float]
    aborted: bool

    @property
    def e2e_s(self) -> float:
        return self.finish_time - self.arrival_time


class EngineStats:
    def __init__(self) -> None:
        self.started = time.time()
        self.arrived = 0
        self.finished = 0
        self.aborted = 0
        self.records: List[RequestRecord] = []

    def on_arrival(self, req: Request) -> None:
        self.arrived += 1

    def on_finish(self, out: RequestOutput) -> None:
        if out.aborted:
            self.aborted += 1
        else:
            self.finished += 1
        self.records.append(RequestRecord(
            out.request_id, out.resolution, out.arrival_time, out.finish_time,
            out.first_scheduled_time, out.aborted))

    # -- aggregate metrics (reference get_metric.py:62-120) -------------------

    def summary(self, family: str = "sdxl", slo_scale: float = 5.0) -> Dict[str, float]:
        """Counts, rates over the span from the first arrival to the last
        finish, and latency over the finished requests: the mean and the
        nearest-rank p50 and p99 (the ``ceil(p * n)``-th smallest, as
        ``perfbench/lib/window.py`` takes them; 0.0 with none).
        ``slo_attainment`` is over every request that ended, an aborted
        one counting as a missed deadline."""
        done = [r for r in self.records if not r.aborted]
        total_span = max(
            (max((r.finish_time for r in self.records), default=self.started)
             - min((r.arrival_time for r in self.records), default=self.started)),
            1e-9)
        ddl_table = _E2E_DDL_S.get(family, {})
        scale = slo_scale / 5.0
        slo_met = [r for r in done
                   if r.e2e_s <= ddl_table.get(r.resolution, float("inf")) * scale]
        lat = sorted(r.e2e_s for r in done)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(max(math.ceil(p * len(lat)) - 1, 0), len(lat) - 1)]

        return {
            "arrived": self.arrived,
            "finished": len(done),
            "aborted": self.aborted,
            "throughput_rps": len(done) / total_span,
            "goodput_rps": len(slo_met) / total_span,
            "slo_attainment": (len(slo_met) / len(self.records)
                               if self.records else 0.0),
            "avg_latency_s": (sum(lat) / len(lat)) if lat else 0.0,
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
        }

    def dump_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("request_id,resolution,arrival_time,first_scheduled_time,finish_time,aborted\n")
            for r in self.records:
                f.write(f"{r.request_id},{r.resolution},{r.arrival_time},"
                        f"{r.first_scheduled_time or ''},{r.finish_time},{int(r.aborted)}\n")
