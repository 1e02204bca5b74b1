"""Fingerprints of cached rows, taken by the probe from the program's row
caches and deep features and by the check from the reference's own values,
so that the check can hold what the program holds against what the
reference worked out, without copying whole rows out of the window.

A row ``(C, h, w)`` is fingerprinted by ``K`` spatial weightings per
channel: the plain sum and ``K - 1`` sums under fixed random signs.  The
plain sum alone hides a change whose mean over the image is near zero,
as a block's drift from one step to the next mostly is; a signed sum
carries it at about its share of the row's norm.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

K = 4
_SIGNS: Dict[Tuple[int, int, str], torch.Tensor] = {}


def signs(h: int, w: int, device) -> torch.Tensor:
    """``(K, h, w)`` float32 weights: ones, then fixed random signs."""
    key = (h, w, str(device))
    s = _SIGNS.get(key)
    if s is None:
        g = torch.Generator().manual_seed(20_18)
        r = torch.randint(0, 2, (K - 1, h, w), generator=g).float() * 2 - 1
        s = torch.cat([torch.ones(1, h, w), r]).to(device)
        _SIGNS[key] = s
    return s


def of(rows: torch.Tensor) -> torch.Tensor:
    """``(R, K, C)`` fingerprints of NCHW ``rows``, in float32."""
    x = rows.float()
    return torch.einsum("rchw,khw->rkc", x, signs(x.shape[2], x.shape[3],
                                                  x.device))


def distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` of two fingerprints (``b`` the reference's)."""
    a = a.to(b.device).float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def is_zero(fp: torch.Tensor) -> bool:
    """A fingerprint of rows that hold zeros (a fresh row cache)."""
    return bool(fp.abs().max() == 0)
