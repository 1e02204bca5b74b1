"""Per-replica placement (counterpart of sduss_tpu/parallel/replica.py).

The reference's DP workers are OS processes pinned to one GPU each
(worker/runner/model_runner.py:29-30 CUDA_VISIBLE_DEVICES).  Here, as in
the JAX package, a DP replica is owned by one ``Worker`` in this process
and holds a slice of the device list: ``sp * tp`` consecutive entries
(``build_placements``), one device or a group over which the denoiser is
tensor-parallel and the latent rows spatial-parallel
(``parallel/group.py``, ``parallel/sharding.py``).  The list may repeat an
index, which puts several replicas, or several shards of one replica, on
one card (each replica with its own pipeline, row state and step graphs;
replicas on one card share one copy of the weights).  ``check_group``
states what a group serves.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from .mesh import make_mesh


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
                     base: torch.device | str = "cuda"
                     ) -> List[List[torch.device]]:
    """The devices of each replica: ``sp * tp`` of them, rank order.

    ``base`` is the engine's device.  On the CPU every shard is ``cpu``.
    On the card, ``devices`` (``ParallelConfig.devices``: card indices,
    repeats allowed) gives replica ``r`` the entries ``[r * n, (r + 1) *
    n)``, ``n = sp * tp`` (JAX replica.py:62-74); with ``devices=None`` the
    shards take consecutive cards from ``base``'s index (0 for ``cuda``).
    Too few devices raises ``ValueError`` ("need n devices"), as in the
    JAX package."""
    per = sp * tp
    need = dp * per
    base = torch.device(base)
    if base.type != "cuda":
        return _slices(dp, sp, tp, [base] * need)
    have = torch.cuda.device_count()
    if devices is None:
        start = base.index or 0
        devices = list(range(start, start + need))
        if devices[-1] >= have:
            raise ValueError(f"need {need} devices for dp={dp} sp={sp} "
                             f"tp={tp} from cuda:{start}, have {have}")
    if len(devices) < need:
        raise ValueError(f"need {need} devices for dp={dp} sp={sp} tp={tp}, "
                         f"have {len(devices)}")
    bad = [i for i in devices[:need] if not 0 <= int(i) < have]
    if bad:
        raise ValueError(f"devices {bad} outside the {have} visible cards")
    return _slices(dp, sp, tp, [torch.device("cuda", int(i))
                                for i in devices[:need]])


def _slices(dp: int, sp: int, tp: int, devices: list) -> list:
    """Each replica's ``dp`` slice of the ``dp x sp x tp`` mesh, rank
    order."""
    mesh = make_mesh(dp=dp, sp=sp, tp=tp, devices=devices)
    return [list(mesh.devices[r].reshape(-1)) for r in range(dp)]


def check_group(config) -> None:
    """Raise what a replica over an sp x tp group does not serve
    (``NotImplementedError``): ``pp > 1``, which the Engine does not route
    (the MMDiT stage pipeline, ``parallel/pipeline.py MMDiTStagePipeline``,
    is a library class).  Every path and cache serves over ``sp`` and
    ``tp``: ``tp`` with a replicated residual stream, ``sp`` through the
    denoiser's sharded route (``parallel/sharding.py``), the dense latent
    rows, the patch batch's rows and SD3's token columns split over the
    shards, the cache gates selecting over the whole batch."""
    par = config.parallel
    if par.pp > 1:
        raise NotImplementedError(
            f"pp={par.pp}: the Engine serves no pipeline-stage parallelism; "
            f"drive sduss_tpu_torch.parallel.pipeline.MMDiTStagePipeline "
            f"directly (ROADMAP item 10)")
