"""Device meshes (counterpart of sduss_tpu/parallel/mesh.py).

A ``Mesh`` lays a device list out on named axes in JAX's order: ``dp``
(request-level replicas), ``sp`` (latent rows), ``tp`` (attention heads
and feed-forward channels), and ``pp`` (pipeline stages, between ``dp``
and ``sp``) when asked for.  The port has no partitioner: a mesh is the
layout from which replicas (``parallel/replica.py build_placements``), a
shard group's coordinates and axis peers (``parallel/group.py``) and stage
placements are cut.  Devices may repeat.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an object array of ``torch.device`` shaped by the axes;
    ``shape``: ``{axis: size}``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def coords(self, flat: int) -> Dict[str, int]:
        """``{axis: index}`` of the ``flat``-th device (row-major)."""
        at = np.unravel_index(flat, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def line(self, flat: int, axis: str) -> List[int]:
        """The flat indices of the devices that share every coordinate of
        the ``flat``-th but ``axis``'s, in ``axis`` order."""
        at = list(np.unravel_index(flat, self.devices.shape))
        at[self.axis_names.index(axis)] = slice(None)
        grid = np.arange(self.devices.size).reshape(self.devices.shape)
        return [int(i) for i in grid[tuple(at)]]


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """``dp x sp x tp`` (``dp x pp x sp x tp`` with ``pp > 1``) over the
    first ``dp * pp * sp * tp`` of ``devices`` (default: every visible
    card, or the CPU repeated when there is none), mesh.py:30-41."""
    n = dp * tp * sp * pp
    if devices is None:
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(count)] if count
                   else [torch.device("cpu")] * n)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    if pp > 1:
        return Mesh(arr.reshape(dp, pp, sp, tp), ("dp", "pp", "sp", "tp"))
    return Mesh(arr.reshape(dp, sp, tp), ("dp", "sp", "tp"))


def pp_stage_params(stages: Sequence, mesh: Mesh) -> list:
    """Each stage's module (or state dict) on the first device of its
    ``pp`` slice of replica 0 (mesh.py:44-66)."""
    if "pp" not in mesh.axis_names:
        raise ValueError("mesh has no 'pp' axis")
    n = mesh.shape["pp"]
    if len(stages) != n:
        raise ValueError(f"{len(stages)} stages for pp={n}")
    placed = []
    for i, sub in enumerate(stages):
        dev = mesh.devices[0, i].reshape(-1)[0]
        if isinstance(sub, dict):
            placed.append({k: v.to(dev) for k, v in sub.items()})
        else:
            placed.append(sub.to(dev))
    return placed
