"""Model-layout flash attention (counterpart of sduss_tpu/ops/flash.py
``flash_mha_fused``, ``flash_mha`` and ``flash_cross_short``).

Three wrappers of the hand-written CUDA kernel ``csrc/flash_fused.cu``:

* ``flash_mha_fused`` — kernel K1, replacing the Pallas kernel
  ``_mha_fused_kernel`` (unmasked self-attention);
* ``flash_mha`` — kernel K2a/K3b, replacing ``_mha_kernel_2pass_nobias``,
  ``_mha_kernel`` and the ``kv_len`` form of ``_mha_kernel_2pass``
  (unmasked attention over the first ``kv_len`` keys: SD3's joint and dual
  attention, whose K rows are too wide for K1's gate); with ``kv_mask`` it
  hands over to ``flash_mha_masked``, as the JAX function does;
* ``flash_mha_masked`` — kernel K2b/K3a, replacing ``_mha_kernel_2pass`` and
  ``_mha_kernel_masked`` (attention under a per-key validity mask, the
  mixed-resolution paths' grouped and padded-token attention);

and one of ``csrc/flash_cross.cu``:

* ``flash_cross_short`` — kernel K5, replacing ``_cross_short_kernel``
  (unmasked attention over at most 256 keys): ``ops/attention.py`` routes
  every unmasked attention over fewer than 128 keys to it, text
  cross-attention above all.  The JAX dispatcher keeps that attention
  dense (attention.py:135-140) after a v5e measurement; on the H100 the
  plain route is 4-16x slower than K5.

The kernels take head dims 40, 64, 80 and 160 (SD-1.5's 40/80/160 at 8
heads; SDXL's and SD3's 64); any other raises ``ValueError``.  Each
wrapper has a plain PyTorch version beside it (``*_reference``).  A wrapper
takes the plain version only for tensors on the CPU; a CUDA tensor launches
the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import math

import torch

from sduss_tpu_torch.ops import _build

HEAD_DIMS = (40, 64, 80, 160)  # the kernels' template instantiations
CROSS_MAX_KV = 256  # keys flash_cross_short holds whole in shared memory
_LOG2E = 1.0 / math.log(2.0)


def flash_mha_fused_reference(q, k, v, num_heads: int, scale: float):
    """Plain version: per-head float32 ``softmax(q k^T * scale) v``.

    q: ``(B, Lq, D)``; k, v: ``(B, Lk, D)``; head h at columns
    ``[h*hd, (h+1)*hd)``.  Returns q's dtype.
    """
    b, lq, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, hd).transpose(1, 2).float()

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(logits, dim=-1), heads(v))
    return out.transpose(1, 2).reshape(b, lq, d).to(q.dtype)


def flash_mha_reference(q, k, v, num_heads: int, scale: float,
                        kv_mask=None, kv_len=None):
    """Plain version of :func:`flash_mha`: per-head float32 attention over
    the first ``kv_len`` keys (all by default), or under ``kv_mask`` (see
    :func:`flash_mha_masked_reference`).  Returns q's dtype."""
    if kv_mask is not None:
        return flash_mha_masked_reference(q, k, v, kv_mask, num_heads, scale)
    n = _kv_len(k, kv_mask, kv_len)
    return flash_mha_fused_reference(q, k[:, :n], v[:, :n], num_heads, scale)


def flash_mha_masked_reference(q, k, v, kv_mask, num_heads: int,
                               scale: float):
    """Plain version of the masked kernel: per-head float32 attention over
    the keys where ``kv_mask`` (``(B, Lk)`` bool) is set.

    A batch row with no valid key has no softmax; its output is defined as
    zeros (the kernel's value).  The JAX kernels return a uniform average
    there, and such rows (padded image slots) are discarded downstream.
    Returns q's dtype.
    """
    b, lq, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, hd).transpose(1, 2).float()

    valid = kv_mask.bool()[:, None, None, :]
    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)  # masked keys: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, heads(v)) / torch.where(denom > 0, denom,
                                                  torch.ones_like(denom))
    return out.transpose(1, 2).reshape(b, lq, d).to(q.dtype)


def check_inputs(q, k, v, num_heads: int) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_mha_fused expects (B, L, D) tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    d = q.shape[2]
    if num_heads < 1 or d % num_heads or d // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {d}/{num_heads} unsupported: the kernels "
                         f"take head dims {HEAD_DIMS}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("tensors too large for the kernel's int32 sizes")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             f"torch.bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one CUDA device "
                         f"({q.device}, {k.device}, {v.device})")


def flash_mha_fused(q, k, v, num_heads: int, scale: float):
    """Self-attention over ``(B, L, D)`` with no head transposes.

    CPU tensors: :func:`flash_mha_fused_reference`.  Anything else goes to
    the CUDA kernel: inputs it does not take raise ``ValueError``, a failed
    launch raises ``RuntimeError``.  Each launch adds one to
    ``flash_mha_fused.launches``.
    """
    if q.device.type == "cpu":
        return flash_mha_fused_reference(q, k, v, num_heads, scale)
    check_inputs(q, k, v, num_heads)
    lib = _build.load_library()
    b, lq, d = q.shape
    out = torch.empty_like(q)
    with _build.stream_for(q.device) as stream:
        err = lib.sduss_flash_mha_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, k.shape[1], d, num_heads, float(scale) * _LOG2E, stream)
    _build.check(lib, err, "flash_mha_fused launch")
    _build.count(flash_mha_fused)
    return out


flash_mha_fused.launches = 0


def _kv_len(k, kv_mask, kv_len) -> int:
    """The static count of real keys (``Lk`` when not given)."""
    if kv_len is None:
        return k.shape[1]
    if kv_mask is not None:
        raise ValueError("kv_mask and kv_len are mutually exclusive")
    kv_len = int(kv_len)
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, Lk = {k.shape[1]}]")
    return kv_len


def flash_mha(q, k, v, num_heads: int, scale: float, kv_mask=None,
              kv_len=None):
    """Attention over ``(B, L, D)``: the JAX ``flash_mha`` contract without
    its TPU tiling knobs.

    ``kv_len`` (static, default ``Lk``): only the first ``kv_len`` keys take
    part; the rest may hold anything.  ``kv_mask`` (``(B, Lk)`` bool): the
    per-key form, served by :func:`flash_mha_masked` (and counted there).
    CPU tensors: :func:`flash_mha_reference`.  Anything else goes to the
    CUDA kernel: inputs it does not take raise ``ValueError``, a failed
    launch raises ``RuntimeError``.  Each unmasked launch adds one to
    ``flash_mha.launches``.
    """
    n = _kv_len(k, kv_mask, kv_len)
    if kv_mask is not None:
        return flash_mha_masked(q, k, v, kv_mask, num_heads, scale)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, num_heads, scale, kv_len=n)
    check_inputs(q, k, v, num_heads)
    lib = _build.load_library()
    b, lq, d = q.shape
    out = torch.empty_like(q)
    with _build.stream_for(q.device) as stream:
        err = lib.sduss_flash_mha(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, k.shape[1], n, d, num_heads, float(scale) * _LOG2E, stream)
    _build.check(lib, err, "flash_mha launch")
    _build.count(flash_mha)
    return out


flash_mha.launches = 0


def check_mask(kv_mask, k) -> None:
    """Raise ``ValueError`` for a key mask the masked kernel does not take."""
    if kv_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"kv_mask is {kv_mask.dtype}; the kernel takes "
                         f"torch.bool or torch.uint8")
    if tuple(kv_mask.shape) != (k.shape[0], k.shape[1]):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != (B, Lk) "
                         f"{(k.shape[0], k.shape[1])}")
    if not kv_mask.is_contiguous():
        raise ValueError("kv_mask is not contiguous")
    if kv_mask.device != k.device:
        raise ValueError(f"kv_mask on {kv_mask.device}, keys on {k.device}")


def flash_mha_masked(q, k, v, kv_mask, num_heads: int, scale: float):
    """Attention over ``(B, L, D)`` under a ``(B, Lk)`` key mask (True =
    the key takes part); rows of a batch row with no valid key are zeros.

    CPU tensors: :func:`flash_mha_masked_reference`.  Anything else goes to
    the CUDA kernel: inputs it does not take raise ``ValueError``, a failed
    launch raises ``RuntimeError``.  Each launch adds one to
    ``flash_mha_masked.launches``.
    """
    if q.device.type == "cpu":
        return flash_mha_masked_reference(q, k, v, kv_mask, num_heads, scale)
    check_inputs(q, k, v, num_heads)
    check_mask(kv_mask, k)
    lib = _build.load_library()
    b, lq, d = q.shape
    out = torch.empty_like(q)
    with _build.stream_for(q.device) as stream:
        err = lib.sduss_flash_mha_masked(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, lq, k.shape[1], d, num_heads,
            float(scale) * _LOG2E, stream)
    _build.check(lib, err, "flash_mha_masked launch")
    _build.count(flash_mha_masked)
    return out


flash_mha_masked.launches = 0


def flash_cross_short_reference(q, k, v, num_heads: int, scale: float):
    """Plain version of K5: per-head float32 ``softmax(q k^T * scale) v``
    over all (at most 256) keys, the function of
    :func:`flash_mha_fused_reference`.  Returns q's dtype."""
    return flash_mha_fused_reference(q, k, v, num_heads, scale)


def flash_cross_short(q, k, v, num_heads: int, scale: float):
    """Attention over a short key sequence (text cross-attention): q
    ``(B, Lq, D)``, k/v ``(B, Lk, D)`` with ``Lk <= 256``.

    A key sequence over 256 raises ``ValueError`` on any device.  CPU
    tensors: :func:`flash_cross_short_reference`, at any head dim (the tiny
    test models route here too); anything else goes to the CUDA kernel
    (``csrc/flash_cross.cu``): inputs it does not take, an unsupported head
    dim among them, raise ``ValueError``, a failed launch raises
    ``RuntimeError``.  Each launch adds one to
    ``flash_cross_short.launches``.
    """
    if k.dim() == 3 and k.shape[1] > CROSS_MAX_KV:
        raise ValueError(f"flash_cross_short holds at most {CROSS_MAX_KV} "
                         f"keys, got {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_cross_short_reference(q, k, v, num_heads, scale)
    check_inputs(q, k, v, num_heads)
    lib = _build.load_library()
    b, lq, d = q.shape
    out = torch.empty_like(q)
    with _build.stream_for(q.device) as stream:
        err = lib.sduss_flash_cross_short(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, lq, k.shape[1], d, num_heads, float(scale) * _LOG2E, stream)
    _build.check(lib, err, "flash_cross_short launch")
    _build.count(flash_cross_short)
    return out


flash_cross_short.launches = 0
