"""Cross-replica data-parallel dispatcher (counterpart of
sduss_tpu/dispatcher/__init__.py).

Rebuild of sduss/dispatcher/ (dispatcher.py:21-127, policy/greedy.py:7-36):
assigns waiting requests to DP replicas.  Replicas are devices in one
process (``parallel/replica.py``; two may share a card), each served by
its own ``Worker``, so the dispatcher is a pure host-side load balancer
with no queues.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from sduss_tpu_torch.request import Request


class DispatchPolicy:
    def assign(self, reqs: Sequence[Request], pending_pixels: List[int]) -> List[int]:
        """Return a replica index per request."""
        raise NotImplementedError


class GreedyDispatch(DispatchPolicy):
    """Least-loaded by pending pixels (reference policy/greedy.py:16-36)."""

    def assign(self, reqs: Sequence[Request], pending_pixels: List[int]) -> List[int]:
        load = list(pending_pixels)
        out = []
        for req in reqs:
            rank = min(range(len(load)), key=lambda i: load[i])
            load[rank] += req.resolution * req.resolution
            out.append(rank)
        return out


class RoundRobinDispatch(DispatchPolicy):
    def __init__(self) -> None:
        self._next = 0

    def assign(self, reqs: Sequence[Request], pending_pixels: List[int]) -> List[int]:
        n = len(pending_pixels)
        out = []
        for _ in reqs:
            out.append(self._next % n)
            self._next += 1
        return out


_POLICIES: Dict[str, Callable[[], DispatchPolicy]] = {
    "greedy": GreedyDispatch,
    "round_robin": RoundRobinDispatch,
}


def get_dispatch_policy(name: str) -> DispatchPolicy:
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown dispatch policy {name!r}; available: {sorted(_POLICIES)}") from None
