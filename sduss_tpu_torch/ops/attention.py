"""Attention dispatch (counterpart of sduss_tpu/ops/attention.py).

``masked_attention`` routes every attention with a key mask — the patch
path's grouped self-attention — to the masked flash kernel
(:func:`sduss_tpu_torch.ops.flash.flash_mha_masked`, K2b/K3a), each
unmasked attention with a long key axis — every dense SDXL self-attention
— to the flash kernel K1 (:func:`sduss_tpu_torch.ops.flash.flash_mha_fused`),
and keeps short-KV cross-attention over the 77 text tokens on the plain
path, as the JAX dispatcher does (attention.py:135-140).  The JAX gates (``Lq >= 1024``,
``Lk >= 512``, a 6 MiB K row) are TPU VMEM and grid-overhead choices: the
CUDA kernel streams K/V tiles and takes any length, so the only gate is
the key length that separates self- from cross-attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sduss_tpu_torch.models import layers as L
from sduss_tpu_torch.ops.flash import flash_mha_fused, flash_mha_masked

# Keys at least this long go to K1.  Text conditioning has 77 tokens; the
# shortest SDXL self-attention (512^2, level 2) has 256.
FLASH_MIN_KV = 128


def _dense_masked(q, k, v, num_heads: int, kv_token_mask, scale: float):
    """Plain attention with an optional ``(B, Lk)`` boolean key mask."""
    mask = None if kv_token_mask is None else kv_token_mask[:, None, None, :]
    return L.attention(q, k, v, num_heads, mask=mask, scale=scale)


def masked_attention(q, k, v, num_heads: int, kv_token_mask=None,
                     scale: Optional[float] = None):
    """MHA over ``(B, L, D)`` with an optional ``(B, Lk)`` boolean key mask.

    Masked calls go to the masked flash kernel at any key length (the CUDA
    kernel streams key tiles and skips masked ones); a batch row with no
    valid key gives zeros.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    if kv_token_mask is not None:
        return flash_mha_masked(q, k, v, kv_token_mask, num_heads, scale)
    if k.shape[1] >= FLASH_MIN_KV:
        return flash_mha_fused(q, k, v, num_heads, scale)
    return _dense_masked(q, k, v, num_heads, None, scale)
