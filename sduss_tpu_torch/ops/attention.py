"""Attention dispatch (counterpart of sduss_tpu/ops/attention.py).

``masked_attention`` sends every attention to a hand-written kernel:

* a key mask (the patch path's grouped self-attention, the SD3 token
  path's padded tokens) -> the masked flash kernel
  (:func:`sduss_tpu_torch.ops.flash.flash_mha_masked`, K2b/K3a);
* unmasked, a long key axis and a K row of at most 6 MiB (every SDXL
  self-attention; SD3 at 512^2) -> K1
  (:func:`sduss_tpu_torch.ops.flash.flash_mha_fused`);
* unmasked, a long key axis and a wider K row (SD3's joint and dual
  attention at 768^2 and 1024^2: D = 1536) -> K2a/K3b
  (:func:`sduss_tpu_torch.ops.flash.flash_mha`);
* unmasked over fewer than ``FLASH_MIN_KV`` keys (text cross-attention
  over 77 tokens, direct or with per-patch K/V on the patch path; SD-1.5's
  64-key mid block at 512^2) -> K5
  (:func:`sduss_tpu_torch.ops.flash.flash_cross_short`).

The JAX dispatcher keeps short-KV attention dense (attention.py:135-140)
because on a v5e its Pallas kernel was slower than XLA's dense attention;
on the H100 the plain route is 4-16x slower than K5, so the port routes it
to K5.  The 6 MiB K-row gate is a routing choice kept from the reference
(on the TPU it bounds K1's whole-row VMEM residency), not a limit of the
CUDA kernels, which stream K/V tiles and take any length: it keeps each
port kernel running where its TPU kernel runs.  The JAX length gates
(``Lq >= 1024``, ``Lk >= 512``) are TPU grid-overhead choices; the port
sends every attention with at least ``FLASH_MIN_KV`` keys to a flash
kernel.  On the CPU each wrapper runs its plain version.
"""

from __future__ import annotations

import math
from typing import Optional


from sduss_tpu_torch.ops.flash import (flash_cross_short, flash_mha,
                                       flash_mha_fused, flash_mha_masked)

# Keys at least this long go to a flash kernel, shorter ones to K5.  Text
# conditioning has 77 tokens; the shortest SDXL self-attention (512^2,
# level 2) has 256.
FLASH_MIN_KV = 128
# Unmasked attention whose K row (Lk x D bf16 values) is wider than this
# goes to flash_mha instead of K1 (the JAX gate, attention.py:128-130).
K1_MAX_K_ROW_BYTES = 6 * 2**20


def masked_attention(q, k, v, num_heads: int, kv_token_mask=None,
                     scale: Optional[float] = None):
    """MHA over ``(B, L, D)`` with an optional ``(B, Lk)`` boolean key mask.

    Masked calls go to the masked flash kernel at any key length (the CUDA
    kernel streams key tiles and skips masked ones); a batch row with no
    valid key gives zeros.  Unmasked calls route as the module docstring
    says.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    if kv_token_mask is not None:
        return flash_mha_masked(q, k, v, kv_token_mask, num_heads, scale)
    if k.shape[1] < FLASH_MIN_KV:
        return flash_cross_short(q, k, v, num_heads, scale)
    if k.shape[1] * q.shape[-1] * 2 <= K1_MAX_K_ROW_BYTES:
        return flash_mha_fused(q, k, v, num_heads, scale)
    return flash_mha(q, k, v, num_heads, scale)
