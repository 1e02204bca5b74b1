"""The window arithmetic of the end-to-end metrics.

Deadlines: the SLO table of the reference system's ``get_metric.py``
(SDXL, SD3) and the SD-1.5 scaling of the JAX package, as copied into
``sduss_tpu_torch/benchmark/metrics.py`` (``_SLO5_DEADLINES``,
``slo_deadline_s``); a later change may delete the program's copy.

What differs from the program's ``compute_metrics``: every request due in
the window counts, a failed or aborted one as later than any other and as
a missed deadline; percentiles are nearest-rank over all of them; rates
run over the window, not from the first arrival to the last finish.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

SLO5_DEADLINES: Dict[str, Dict[int, float]] = {
    "sdxl": {512: 16.35, 768: 17.5, 1024: 19.31},
    "sd3": {512: 11.0, 768: 18.0, 1024: 30.0},
    "sd15": {256: 5.0, 512: 8.0, 768: 12.0},
}
SLO_FACTORS = {3: 0.6, 5: 1.0, 10: 2.0}


def slo_deadline_s(family: str, resolution: int, slo: int = 5) -> float:
    table = SLO5_DEADLINES[family]
    if resolution in table:
        ddl = table[resolution]
    else:  # scale the nearest entry by pixels
        near = min(table, key=lambda r: abs(r - resolution))
        ddl = table[near] * (resolution / near) ** 2
    return ddl * SLO_FACTORS.get(slo, slo / 5.0)


@dataclasses.dataclass
class Record:
    """One request as the client saw it; times on the harness's clock
    (seconds).  ``done`` is when its image returned, None if it never did;
    ``given_up`` when the harness stopped waiting for it."""
    index: int
    request_id: str
    resolution: int
    due: float
    sent: float
    done: Optional[float] = None
    ok: bool = False
    error: Optional[str] = None
    given_up: Optional[float] = None
    first_scheduled: Optional[float] = None

    def latency(self) -> float:
        """Seconds from due to the image; a failed request's runs to when
        it was given up, later than every finished request's."""
        if self.ok:
            return self.done - self.due
        end = self.given_up if self.given_up is not None else self.done
        return (end - self.due) + 1e-3


def nearest_rank(values: Sequence[float], q: float) -> float:
    v = sorted(values)
    k = min(max(int(math.ceil(q * len(v))) - 1, 0), len(v) - 1)
    return v[k]


def due_in(records: Sequence[Record], w0: float, w1: float) -> List[Record]:
    return [r for r in records if w0 <= r.due < w1]


def open_loop(records: Sequence[Record], w0: float, w1: float,
              family: str, slo: int) -> dict:
    """Latency percentiles and SLO attainment over the requests due in
    ``[w0, w1)``; failures count as the latest and as misses."""
    rs = due_in(records, w0, w1)
    if not rs:
        raise ValueError("no request fell due in the window")
    lat = [r.latency() for r in rs]
    met = sum(1 for r in rs
              if r.ok and r.latency() <= slo_deadline_s(family, r.resolution,
                                                        slo))
    return {"attempted": len(rs), "failed": sum(1 for r in rs if not r.ok),
            "p50_latency_s": nearest_rank(lat, 0.5),
            "p90_latency_s": nearest_rank(lat, 0.9),
            "slo_attainment": met / len(rs)}


def closed_loop(records: Sequence[Record], w0: float, w1: float) -> dict:
    """Megapixels of the images returned in ``[w0, w1)`` over the window's
    seconds; the requests sent in the window are the attempted ones."""
    px = sum(r.resolution ** 2 for r in records
             if r.ok and w0 <= r.done < w1)
    sent = [r for r in records if w0 <= r.sent < w1]
    return {"attempted": len(sent),
            "failed": sum(1 for r in sent if not r.ok),
            "mpix_per_s": px / 1e6 / (w1 - w0)}


def denoise_iterations(served) -> List[tuple]:
    """``[(start, seconds to the next iteration, batch size)]`` of the
    window's DENOISING iterations in the worker's ``schedule_log``, on the
    harness's clock."""
    log, off = served.schedule_log, served.clock_to_wall
    out = []
    for a, b in zip(log, log[1:]):
        t = a["time"] - off
        if a["stage"] == "denoising" and served.w0 <= t < served.w1:
            out.append((t, b["time"] - a["time"], a["batch_size"]))
    return out
