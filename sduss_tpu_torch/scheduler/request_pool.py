"""Per-replica request pool: plain dict + stage indexes.

Replaces the reference's pandas-DataFrame pools
(sduss/worker/scheduler/request_pool.py:12-211, dispatcher/request_pool.py:12-130)
with O(1) dict/set indexes — the pandas layer was pure overhead in the
reference's hot loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sduss_tpu_torch.request import Request, Stage


class RequestPool:
    def __init__(self) -> None:
        self._reqs: Dict[str, Request] = {}
        # insertion-ordered ids per stage (dict used as ordered set)
        self._by_stage: Dict[Stage, Dict[str, None]] = {s: {} for s in Stage}

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._reqs

    def get(self, request_id: str) -> Optional[Request]:
        return self._reqs.get(request_id)

    def add(self, req: Request) -> None:
        if req.request_id in self._reqs:
            raise ValueError(f"duplicate request id {req.request_id}")
        self._reqs[req.request_id] = req
        self._by_stage[req.stage][req.request_id] = None

    def remove(self, request_id: str) -> Optional[Request]:
        req = self._reqs.pop(request_id, None)
        if req is not None:
            self._by_stage[req.stage].pop(request_id, None)
        return req

    def move(self, req: Request, new_stage: Stage) -> None:
        self._by_stage[req.stage].pop(req.request_id, None)
        req.stage = new_stage
        self._by_stage[new_stage][req.request_id] = None

    def in_stage(self, stage: Stage) -> List[Request]:
        """Requests in a stage, oldest first (insertion order)."""
        return [self._reqs[rid] for rid in self._by_stage[stage]]

    def count(self, stage: Stage) -> int:
        return len(self._by_stage[stage])

    def unfinished(self) -> int:
        return sum(self.count(s) for s in
                   (Stage.WAITING, Stage.PREPARE, Stage.PREPARING,
                    Stage.DENOISING, Stage.POSTPROCESSING, Stage.DECODING))

    def pending_pixels(self) -> int:
        """Workload proxy: sum of resolution^2 over unfinished requests,
        matching the reference (dispatcher/request_pool.py:95-102)."""
        total = 0
        for s in (Stage.PREPARE, Stage.PREPARING, Stage.DENOISING,
                  Stage.POSTPROCESSING, Stage.DECODING):
            for req in self.in_stage(s):
                total += req.resolution * req.resolution
        return total

    def resolutions_in_stage(self, stage: Stage) -> List[int]:
        return sorted({r.resolution for r in self.in_stage(stage)})
