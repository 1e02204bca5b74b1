"""NN primitives of the port (counterpart of sduss_tpu/models/layers.py).

Plain functions on tensors plus the few ``nn.Module``s whose numerics differ
from torch's stock ones.  Convolutions and group norms take channels-first
(NCHW) tensors, the torch idiom; attention takes ``(B, L, D)`` tensors with
head ``h`` at columns ``[h*hd, (h+1)*hd)``, the JAX package's layout.

Numerics follow the JAX functions: matmuls and convolutions keep the input
dtype and accumulate in float32 (cuBLAS/cuDNN do for bf16), norms and
softmax compute in float32 and cast back.  Weights keep torch's layout:
Linear ``(out, in)``, Conv ``OIHW``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sduss_tpu_torch.ops.gn_dense import gn_dense


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` in x's dtype (weight is torch ``(out, in)``)."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def conv2d(x, weight, bias=None, stride: int = 1):
    """NCHW conv with OIHW kernel and symmetric ``(k-1)//2`` padding.

    At stride 2 the padding is symmetric on both sides, like torch
    ``Conv2d(padding=1)`` and the JAX conv2d's explicit padding
    (layers.py:68-69).
    """
    pad = (weight.shape[-1] - 1) // 2
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=pad)


def conv_apply(conv, x, stride: int = 1, padding=0):
    """``conv``'s weights on ``x`` at ``stride`` and ``padding`` (a context's
    haloed input).  A module that sums its convolution across shards (the
    row-parallel conv of ``parallel/sharding.py``) adds its bias after the
    sum, through its ``conv_at``."""
    conv_at = getattr(conv, "conv_at", None)
    if conv_at is not None:
        return conv_at(x, stride, padding)
    return F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding)


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-5,
               act: Optional[str] = None, add=None):
    """GroupNorm over an ``(N, C, ...)`` tensor with float32 moments.

    The moments are E[x] and E[x^2] - E[x]^2, clamped at 0, exactly as the
    JAX group_norm and the fused patch kernel compute them (layers.py:90-119),
    not torch's two-pass variance; ``act="silu"`` fuses the activation and
    ``add`` (N, C) is added to x first, in x's dtype.  On the card kernel
    K6 (``ops/gn_dense.py``), on the CPU its plain version.
    """
    # a UNet transformer's residual add returns channels-last strides;
    # K6 takes NCHW
    return gn_dense(x.contiguous(), weight, bias, num_groups, eps, act, add)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis in float32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm over the last axis in float32, cast back (layers.py:136)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU in float32, cast back (CLIP-G, GEGLU)."""
    return F.gelu(x.float()).to(x.dtype)


def gelu_tanh(x):
    """tanh-approximate GELU in float32, cast back (the MMDiT and T5
    feed-forwards: ``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def quick_gelu(x):
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def geglu(x, weight, bias):
    """GEGLU gate: project to 2*inner, ``a * gelu(g)`` with the halves in
    the JAX order (layers.py:235-239) — diffusers' GEGLU order too."""
    a, g = linear(x, weight, bias).chunk(2, dim=-1)
    return a * gelu(g)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0, scale: float = 1.0):
    """Sinusoidal embedding ``(B,) -> (B, dim)`` in float32 (layers.py:214)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = scale * torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def nearest_upsample_2x(x):
    """NCHW nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _heads(x, num_heads: int):
    b, length, d = x.shape
    return x.reshape(b, length, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, length, hd = x.shape
    return x.transpose(1, 2).reshape(b, length, h * hd)


def attention(q, k, v, num_heads: int, mask=None,
              scale: Optional[float] = None, bias=None):
    """Plain multi-head attention over ``(B, L, D)`` tensors.

    float32 logits and softmax; the weights are cast to q's dtype before
    the PV product, as in the JAX function (layers.py:147-170).  ``bias``
    is added to the float32 logits (T5's relative position bias);
    ``mask`` is boolean, True = attend; both broadcast to
    ``(B, H, Lq, Lk)``.
    """
    hd = q.shape[-1] // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w.float(), vh.float()).to(q.dtype)
    return _merge_heads(out)


def attention_blocked(q, k, v, num_heads: int, block_q: int = 1024,
                      scale: Optional[float] = None):
    """:func:`attention` computed ``block_q`` query rows at a time.

    Bounds the live float32 logits to ``(block_q, Lk)`` per head — the VAE's
    16,384-token single-head mid attention at 1024^2 would otherwise
    materialize a 1 GiB score matrix per image (layers.py:173-211).
    """
    if q.shape[1] <= block_q:
        return attention(q, k, v, num_heads, scale=scale)
    return torch.cat([attention(q[:, i:i + block_q], k, v, num_heads,
                                scale=scale)
                      for i in range(0, q.shape[1], block_q)], dim=1)


class GroupNorm(nn.Module):
    """GroupNorm with the float32 E[x^2]-E[x]^2 moments of :func:`group_norm`.

    State-dict keys ``weight``/``bias``, as diffusers' ``nn.GroupNorm``.
    """

    def __init__(self, num_groups: int, channels: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, act: Optional[str] = None, add=None):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, act, add)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 and cast back (layers.py:126)."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
