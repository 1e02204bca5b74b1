"""Plain float32 operations of the reference models, with the fp8 control.

Every linear map and convolution of the reference goes through
:func:`linear` or :func:`conv`.  They compute in float32 with TF32 off
(:func:`float32_numerics`).  Under :func:`fp8` both operands of each of
them are first rounded to float8 e4m3 with a per-tensor scale (amax to
448): the precision below the bf16 that the configurations serve in, the
control that the comparison has to reject.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_state = threading.local()


def float32_numerics() -> None:
    """True float32 matmuls and convolutions on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def fp8(on: bool = True):
    """Round every linear and convolution operand to e4m3 inside."""
    prev = getattr(_state, "fp8", False)
    _state.fp8 = on
    try:
        yield
    finally:
        _state.fp8 = prev


def fp8_active() -> bool:
    return getattr(_state, "fp8", False)


def quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = _E4M3_MAX / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


def _q(x):
    return quant(x) if fp8_active() else x.float()


def linear(x, w, b=None):
    return F.linear(_q(x), _q(w), None if b is None else b.float())


def conv(x, w, b=None, stride: int = 1):
    pad = (w.shape[-1] - 1) // 2
    return F.conv2d(_q(x), _q(w), None if b is None else b.float(),
                    stride=stride, padding=pad)


def group_norm(x, w, b, groups: int, eps: float):
    return F.group_norm(x.float(), groups, w.float(), b.float(), eps)


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def attention(q, k, v, heads: int, causal: bool = False, block: int = 4096):
    """Multi-head softmax attention over ``(B, L, D)``, float32, computed
    ``block`` query rows at a time so that the score matrix stays small."""
    b, lq, d = q.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(0, lq, block):
        s = torch.matmul(_q(qh[:, :, i:i + block]), _q(kh).transpose(-1, -2))
        s = s * scale
        if causal:
            lk = kh.shape[2]
            rows = torch.arange(i, min(i + block, lq), device=q.device)
            mask = torch.arange(lk, device=q.device)[None, :] > rows[:, None]
            s = s.masked_fill(mask, float("-inf"))
        outs.append(torch.matmul(_q(torch.softmax(s, dim=-1)), _q(vh)))
    o = torch.cat(outs, dim=2)
    return o.transpose(1, 2).reshape(b, lq, d)


def timestep_embedding(t, dim: int):
    """Sinusoidal embedding with cos first (``flip_sin_to_cos``), shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
