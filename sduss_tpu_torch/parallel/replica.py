"""Per-replica placement (counterpart of sduss_tpu/parallel/replica.py).

The reference's DP workers are OS processes pinned to one GPU each
(worker/runner/model_runner.py:29-30 CUDA_VISIBLE_DEVICES).  Here, as in
the JAX package, a DP replica is a device owned by one ``Worker`` in this
process: ``build_placements`` gives one ``torch.device`` per replica.  An
explicit device list may repeat an index, which puts several replicas on
one card (each with its own pipeline, row state and step graphs, all
sharing one copy of the weights).  A replica over an (sp x tp) group of
devices is not ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch


def canonical(device: torch.device | str) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device inside the block (the
    kernels' launches and ``cudaFuncSetAttribute`` act on the current
    device, CUDA graphs capture and replay on it); nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def build_placements(dp: int, sp: int = 1, tp: int = 1,
                     devices: Optional[Sequence[int]] = None,
                     base: torch.device | str = "cuda") -> List[torch.device]:
    """One device per replica.

    ``base`` is the engine's device.  On the CPU every replica is ``cpu``.
    On the card, ``devices`` (``ParallelConfig.devices``: card indices,
    repeats allowed) gives replica ``r`` the card ``devices[r]``; with
    ``devices=None`` the replicas take consecutive cards from ``base``'s
    index (0 for ``cuda``).  Too few cards raises ``ValueError`` ("need n
    devices"), as in the JAX package; ``sp * tp > 1`` raises
    ``NotImplementedError``."""
    if sp * tp > 1:
        raise NotImplementedError(
            f"a replica over sp={sp} x tp={tp} devices is not ported "
            f"(ROADMAP Queue 1 item 10)")
    base = torch.device(base)
    if base.type != "cuda":
        return [base] * dp
    have = torch.cuda.device_count()
    if devices is None:
        start = base.index or 0
        devices = list(range(start, start + dp))
        if devices[-1] >= have:
            raise ValueError(f"need {dp} devices for dp={dp} sp={sp} tp={tp} "
                             f"from cuda:{start}, have {have}")
    if len(devices) < dp:
        raise ValueError(f"need {dp} devices for dp={dp} sp={sp} tp={tp}, "
                         f"have {len(devices)}")
    bad = [i for i in devices[:dp] if not 0 <= int(i) < have]
    if bad:
        raise ValueError(f"devices {bad} outside the {have} visible cards")
    return [torch.device("cuda", int(i)) for i in devices[:dp]]
