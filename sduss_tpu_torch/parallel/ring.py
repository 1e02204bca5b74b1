"""Ring attention: exact sequence-parallel attention over a shard group
(counterpart of sduss_tpu/parallel/ring.py).

Each shard holds the queries of its sequence rows and the K/V rows it
started with; the K/V rotate around the ``sp`` ring by ``ppermute`` while
each shard folds every block into its queries' partial attention with
online-softmax statistics.  After ``n - 1`` rotations every shard has
attended to the whole sequence: exact, with no stale rows and no
full-sequence K/V held anywhere.  Plain PyTorch math (float32 logits and
statistics, the JAX module's), run inside ``ShardGroup.run``;
``parallel/displaced.py``'s ``MMDiTShardContext`` takes it with
``kv_mode="ring"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _partial_dense(q, k, v, num_heads: int, scale: float):
    """Attention of ``q`` over one K/V block, unnormalised (ring.py:25-47).

    q ``(B, Lq, D)``; k/v ``(B, Lk, D)``.  Returns ``o (B, H, Lq, hd) =
    sum_j p_ij v_j`` with ``p = exp(s - m)``, the row max ``m (B, H, Lq)``
    and ``l (B, H, Lq) = sum_j p_ij``, float32."""
    b, lq, dm = q.shape
    lk = k.shape[1]
    hd = dm // num_heads
    qh = q.reshape(b, lq, num_heads, hd).transpose(1, 2).float()
    kh = k.reshape(b, lk, num_heads, hd).transpose(1, 2).float()
    vh = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two unnormalised partials."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def finalize_partial(o, m, l, dtype):
    """Normalise a partial -> ``(B, Lq, H * hd)`` in ``dtype``."""
    inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)[..., None]
    out = (o * inv).to(dtype)
    b, h, lq, hd = out.shape
    return out.transpose(1, 2).reshape(b, lq, h * hd)


def combine_partials(o1, m1, l1, o2, m2, l2, dtype):
    """Merge two partials and normalise."""
    return finalize_partial(*_merge(o1, m1, l1, o2, m2, l2), dtype)


def ring_attention(q, k, v, num_heads: int, group, axis: str = "sp",
                   scale: Optional[float] = None, return_stats: bool = False):
    """Exact multi-head attention with the K/V rows sharded over ``group``'s
    ``axis`` (call inside ``ShardGroup.run``).  ``q`` (B, Lq, D) are this
    shard's queries, ``k``/``v`` (B, Lk_local, D) its K/V rows.  With
    ``return_stats`` the unnormalised ``(o, m, l)`` come back, so that the
    caller can fold in more keys (the MMDiT's replicated context) before
    normalising."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    n = group.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    o, m, l = _partial_dense(q, k, v, num_heads, scale)
    for _ in range(n - 1):
        k, v = group.ppermute((k, v), axis, perm)
        o, m, l = _merge(o, m, l, *_partial_dense(q, k, v, num_heads, scale))
    if return_stats:
        return o, m, l
    return finalize_partial(o, m, l, q.dtype)
