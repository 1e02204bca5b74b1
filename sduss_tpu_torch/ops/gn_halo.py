"""Fused per-image GroupNorm + SiLU + halo write on the patch batch
(counterpart of sduss_tpu/ops/gn_halo.py).

Layout: NCHW.  The port's UNet runs channels-first, so the patch batch is
``(P, C, s, s)`` and the op writes ``(P, C, s+2, s+2)``, the exact input of
the following 3x3 convolution at padding 0 (the JAX op's NHWC layout,
permuted).

Two phases, as in the JAX op:

1. ``moments`` (plain PyTorch): per-image mean and variance of each group
   across that image's patches, from ``(P, G)`` partial sums combined per
   image in a fixed order (the JAX op's ``segment_sum``); the variance is
   clamped at 0.
2. ``gn_silu_halo``: the wrapper of the hand-written CUDA kernel
   ``csrc/gn_halo.cu`` (kernel K4, replacing the Pallas kernel
   ``gn_halo.py::_kernel``): fold the moments and the affine into one FMA
   per (image, channel), apply SiLU, and write the centre plus the
   neighbours' normalized edge cells, all in one launch.
   ``gn_silu_halo_reference`` is its plain version (normalize -> SiLU ->
   ``haloed``).  The wrapper takes the plain version only for tensors on
   the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sduss_tpu_torch.ops import _build
from sduss_tpu_torch.ops.patching import haloed

_ACTS = {"silu": 1, None: 0}


def group_sums(x, image_id, n_images: int, groups: int):
    """Per-image (E[x], E[x^2]) of each group across the image's patches:
    ``(I, G)`` float32 each.  x: (P, C, s, s).  An image slot with no patch
    gets zeros.

    The ``(P, G)`` partial sums are combined per image by a one-hot
    ``(I, P) @ (P, 2G)`` float32 product: a fixed summation order, so the
    result is the same on every call (``index_add_`` on CUDA adds with
    atomics in varying order)."""
    pp = x.shape[0]
    xf = x.float().reshape(pp, groups, -1)
    parts = torch.cat([xf.sum(dim=2), (xf * xf).sum(dim=2)], dim=1)
    slots = torch.arange(n_images, device=x.device)
    onehot = (image_id.long()[None, :] == slots[:, None]).float()
    sums = onehot @ parts
    cnt = torch.clamp(onehot.sum(dim=1) * xf.shape[2], min=1.0)[:, None]
    return sums[:, :groups] / cnt, sums[:, groups:] / cnt


def moments(x, image_id, n_images: int, groups: int):
    """Per-image (mean, VARIANCE) of each group across the image's patches:
    ``(I, G)`` float32 each, the variance clamped at 0 (``_moments``)."""
    mean, mean_sq = group_sums(x, image_id, n_images, groups)
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def gn_silu_halo_reference(x, image_id, neighbors, mean, rstd, weight, bias,
                           act: Optional[str] = "silu"):
    """Plain version: ``(x - mean) * rstd * weight + bias`` per image and
    group in float32, SiLU, cast to x's dtype, then ``haloed``."""
    if act not in _ACTS:
        raise ValueError(act)
    pp, c, s, _ = x.shape
    g = mean.shape[1]
    idx = image_id.long()
    xf = x.float().reshape(pp, g, c // g, s, s)
    m = mean[idx].reshape(pp, g, 1, 1, 1)
    r = rstd[idx].reshape(pp, g, 1, 1, 1)
    y = ((xf - m) * r).reshape(pp, c, s, s)
    y = y * weight.float().reshape(1, c, 1, 1) + bias.float().reshape(1, c, 1, 1)
    if act == "silu":
        y = F.silu(y)
    return haloed(y.to(x.dtype), neighbors)


def check_inputs(x, image_id, neighbors, mean, rstd, weight, bias) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take."""
    if x.dim() != 4 or x.shape[2] != x.shape[3] or x.shape[2] < 1:
        raise ValueError(f"x must be (P, C, s, s), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x is {x.dtype}; the kernel takes torch.bfloat16")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous (NCHW)")
    pp, c = x.shape[:2]
    if x.numel() >= 2**31 or pp * c * (x.shape[2] + 2) ** 2 >= 2**31:
        raise ValueError("patch batch too large for the kernel's int32 sizes")
    for name, t, shape in (("image_id", image_id, (pp,)),
                           ("neighbors", neighbors, (pp, 8))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if mean.dim() != 2 or mean.shape != rstd.shape or c % mean.shape[1]:
        raise ValueError(f"mean/rstd must be (I, G) with C % G == 0, got "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}, C={c}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight/bias must be ({c},)")
    for name, t in (("image_id", image_id), ("neighbors", neighbors),
                    ("mean", mean), ("rstd", rstd), ("weight", weight),
                    ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device ({x.device})")
    if weight.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16 \
            or not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"weight/bias must be contiguous bfloat16 (the "
                         f"model's dtype), got {weight.dtype}, {bias.dtype}")


def gn_silu_halo(x, image_id, neighbors, mean, rstd, weight, bias,
                 act: Optional[str] = "silu"):
    """Normalized, activated, haloed patch batch: (P, C, s, s) ->
    (P, C, s+2, s+2), NCHW.

    ``image_id`` (P,) and ``neighbors`` (P, 8) int32; ``mean`` / ``rstd``
    (I, G) float32 per image and group; ``weight`` / ``bias`` (C,),
    bfloat16 on the card.  CPU tensors: :func:`gn_silu_halo_reference`.
    Anything else goes to the CUDA kernel, one launch that also folds the
    moments and the affine: inputs it does not take raise ``ValueError``, a
    failed launch raises ``RuntimeError``.  Each launch adds one to
    ``gn_silu_halo.launches``.
    """
    if act not in _ACTS:
        raise ValueError(act)
    if x.device.type == "cpu":
        return gn_silu_halo_reference(x, image_id, neighbors, mean, rstd,
                                      weight, bias, act)
    check_inputs(x, image_id, neighbors, mean, rstd, weight, bias)
    pp, c, s, _ = x.shape
    lib = _build.load_library()
    out = torch.empty((pp, c, s + 2, s + 2), dtype=x.dtype, device=x.device)
    with _build.stream_for(x.device) as stream:
        err = lib.sduss_gn_silu_halo(
            x.data_ptr(), image_id.data_ptr(), neighbors.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), pp, c, s, mean.shape[1], _ACTS[act], stream)
    _build.check(lib, err, "gn_silu_halo launch")
    _build.count(gn_silu_halo)
    return out


gn_silu_halo.launches = 0


def gn_silu_haloed(x, weight, bias, image_id, neighbors, n_images: int,
                   groups: int, eps: float, act: Optional[str] = "silu"):
    """Public op (the JAX ``gn_silu_haloed``): per-image moments, then the
    fused normalize/act/halo.  x: (P, C, s, s) NCHW -> (P, C, s+2, s+2)."""
    x = x.contiguous()
    mean, var = moments(x, image_id, n_images, groups)
    return gn_silu_halo(x, image_id, neighbors, mean, torch.rsqrt(var + eps),
                        weight, bias, act)
