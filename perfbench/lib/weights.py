"""Random weights of a configuration, made on the device from the seed.

The names and shapes are the reference modules' (diffusers' keys), so the
same tensors load into the program and into the reference.  All of them
live in one flat buffer of the serving dtype, filled in a few large calls:
one normal draw over every weight and embedding (in chunks of 2^30
values), one scale per distinct fan-in, one fill of ones and one of zeros.
The same seed on the same kind of device gives the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import models

_CHUNK = 1 << 30


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{component: {key: tensor}}``: views into one flat buffer."""
    mods = models.build(cfg)
    entries = []  # (order, std, comp, key, shape, numel)
    for comp in sorted(mods):
        for key, p in mods[comp].named_parameters():
            kind = models.param_kind(key)
            std = (1.0 / math.sqrt(p[0].numel()) if kind == "w"
                   else 1.0 if kind == "emb" else None)
            order = (0 if std is not None else 1 if kind == "one" else 2,
                     -(std or 0.0))
            entries.append((order, std, comp, key, tuple(p.shape), p.numel()))
    entries.sort(key=lambda e: e[0])
    total = sum(e[5] for e in entries)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_rand = sum(e[5] for e in entries if e[1] is not None)
    for a in range(0, n_rand, _CHUNK):
        flat[a:min(a + _CHUNK, n_rand)].normal_(generator=gen)
    out: Dict[str, Dict[str, torch.Tensor]] = {c: {} for c in mods}
    off, run_std, run_start = 0, None, 0
    for order, std, comp, key, shape, numel in entries:
        if std != run_std or order[0] != 0:
            if run_std is not None:
                flat[run_start:off].mul_(run_std)
            run_std, run_start = (std if order[0] == 0 else None), off
        out[comp][key] = flat[off:off + numel].view(shape)
        off += numel
    if run_std is not None:
        flat[run_start:n_rand].mul_(run_std)
    n_one = sum(e[5] for e in entries if e[0][0] == 1)
    flat[n_rand:n_rand + n_one].fill_(1.0)
    flat[n_rand + n_one:].zero_()
    return out


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size()
               for comp in tensors.values() for t in comp.values())
