"""PatchContext: the patch-batch versions of the UNet's spatial ops
(counterpart of sduss_tpu/ops/patch_ctx.py).

The UNet (models/unet.py) hands every convolution, group norm, attention
and upsample to a ``PatchContext`` when its input is a mixed-resolution
patch batch (``ctx`` argument).  Activations are NCHW ``(P, C, s, s)``,
the port's layout; token runs are ``(P, s*s, C)``.

  conv            3x3 on the haloed patch at padding 0 (stride 1 or 2)
  group_norm      per-image statistics across the image's patches
  gn_silu_conv    GroupNorm + SiLU written into the conv's haloed input by
                  kernel K4 (ops/gn_halo.py), then the conv at padding 0
  self_attention  patches gathered into per-image groups per resolution
                  class, one masked attention per class (kernel K2b/K3a)
  cross_attention per-image text K/V gathered to the patches, or to a
                  subset of patch rows (kernel K5)

Patched equals dense per image to float tolerance
(tests/test_torch_patch_unet.py).

``PatchShardContext`` runs the same ops on one shard's contiguous range of
the patch rows, when a replica's ``sp`` axis splits the patch batch
(``parallel/sharding.py``): the halo reads ghost patches from the other
shards (one ``all_gather`` of the rows the others need, then K4 or the
plain halo at the shard's patch count plus its ghosts), per-image moments
are local sums ``psum``-ed over ``sp`` in rank order, self-attention runs
the shard's own queries against every patch's K/V (one ``all_gather``),
and cross-attention takes its patches' images' text K/V.  The gates read
the global batch through ``rows_all`` and ``gate_view`` (the whole
batch's index arrays); on a ``PatchContext`` both are the identity.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sduss_tpu_torch.models.layers import conv_apply
from sduss_tpu_torch.ops.attention import masked_attention
from sduss_tpu_torch.ops.gn_halo import (gn_silu_halo, gn_silu_haloed,
                                         group_sums)
from sduss_tpu_torch.ops.patching import (PatchMeta, compact_submeta,
                                          gate_images, haloed, shard_meta,
                                          shard_ranges)


class PatchContext:
    """Bound to one PatchMeta; its index arrays live on ``device`` (int64
    for indexing, int32 copies for the kernels, bool masks).

    Gathers clip the -1 slots of ``group_gather`` / ``class_gather`` to
    patch 0, as the JAX context does: a padded slot carries patch 0's data,
    and the key mask keeps it out of every softmax.  ``class_slots`` keeps
    the -1 marks (``(ipc, g*g)`` per class), which the image gate reads;
    ``patch_valid`` marks the real patches (bucket pads are False).
    """

    def __init__(self, meta: PatchMeta, device):
        def dev(a, dtype):
            return torch.from_numpy(a).to(device=device, dtype=dtype)

        self.meta = meta
        self.image_id = dev(meta.image_id, torch.long)
        self.image_id32 = dev(meta.image_id, torch.int32)
        self.neighbors32 = dev(meta.neighbors, torch.int32)
        self.group_gather = dev(meta.group_gather.clip(0), torch.long)
        self.patch_pos = dev(meta.patch_pos, torch.long)
        self.kv_mask = dev(meta.kv_mask, torch.bool)
        self.class_gather = [dev(a.clip(0), torch.long)
                             for a in meta.class_gather]
        self.class_pos = [dev(a, torch.long) for a in meta.class_pos]
        self.class_member = [dev(a, torch.bool) for a in meta.class_member]
        self.class_kv = [dev(a, torch.bool) for a in meta.class_kv]
        self.class_slots = [dev(a.reshape(ipc, g * g), torch.long)
                            for a, (g, ipc) in zip(meta.class_gather,
                                                   meta.class_info)]
        self.patch_valid = dev(meta.kv_mask.reshape(-1)[meta.patch_pos],
                               torch.bool)
        # (i_pad, p_pad) float32 one-hot of image_id: per-image sums as a
        # product, in a fixed order (``index_add_`` adds with atomics on
        # CUDA, in varying order)
        self.image_onehot = (self.image_id[None, :] == torch.arange(
            meta.i_pad, device=device)[:, None]).float()
        self._real_rows = {}

    # -- the gates' view (the identity on one device) -----------------------

    local_range = None  # the whole batch

    def gate_view(self):
        """The context holding the whole batch's index arrays."""
        return self

    def rows_all(self, t: torch.Tensor) -> torch.Tensor:
        """Every patch row of a per-row tensor (here: the tensor)."""
        return t

    def compact_context(self, fraction: float, even: bool):
        """``(context, caps)`` of the image gate's sub-composition."""
        return compact_context(self.meta.patch_cells, self.meta.class_info,
                               fraction, even, self.image_id.device)

    def take_rows(self, h, rows):
        """The rows ``rows`` of ``h`` that this context computes, and the
        indices to hand cross-attention (two-level compact rows)."""
        return h[rows], rows

    def put_rows(self, h, rows, hs):
        """``h`` with its rows ``rows`` replaced by :meth:`take_rows`'
        computed ``hs``."""
        return h.index_copy(0, rows, hs)

    def select_rows(self, h, rows):
        """``h[rows]``, every selected row (the pair's output)."""
        return h[rows]

    def write_rows(self, t, rows, vals) -> None:
        """``t[rows] = vals`` in place, for the rows ``rows`` (distinct,
        global) that this context holds (``vals`` one per selected row)."""
        t.index_copy_(0, rows, vals.to(t.dtype))

    def real_rows(self, caps):
        """Rows of the image gate's sub-batch that hold real images, or
        None when all do: per class, the first ``min(caps[ci], real
        images)`` selected slots (real slots outrank the -inf pads).  The
        sub-batch is class-major, ``caps[ci] * g*g`` rows a class."""
        if caps not in self._real_rows:
            rows, off = [], 0
            for (g, _), n_img, cap in zip(self.meta.class_info,
                                          gate_images(self.meta, caps), caps):
                rows.append(np.arange(off, off + n_img * g * g))
                off += cap * g * g
            rows = np.concatenate(rows)
            self._real_rows[caps] = (
                None if len(rows) == off else
                torch.from_numpy(rows).to(self.image_id.device))
        return self._real_rows[caps]

    # -- time embedding -----------------------------------------------------

    def broadcast_to_patches(self, img_rows: torch.Tensor) -> torch.Tensor:
        """(I_pad, ...) per-image rows -> (P_pad, ...) per-patch rows."""
        return img_rows[self.image_id]

    per_patch = broadcast_to_patches  # the JAX name for per-image scalars

    # -- convs --------------------------------------------------------------

    def conv(self, conv, x, stride: int = 1) -> torch.Tensor:
        """``conv`` (an ``nn.Conv2d``) on the patch batch: 1x1 as is, 3x3 on
        the haloed patch at padding 0."""
        k = conv.weight.shape[-1]
        if k == 1:
            return conv(x)
        if k != 3:
            raise NotImplementedError(f"patch conv kernel {k}")
        return conv_apply(conv, haloed(x, self.neighbors32), stride)

    def upsample_2x(self, x) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")

    def gn_silu_halo(self, norm, x) -> torch.Tensor:
        """(P, C, s, s) -> (P, C, s+2, s+2): per-image GroupNorm + SiLU + the
        1-cell halo ring, by kernel K4 on the card."""
        return gn_silu_haloed(x, norm.weight, norm.bias, self.image_id32,
                              self.neighbors32, self.meta.i_pad,
                              norm.num_groups, norm.eps, "silu")

    def gn_silu_conv(self, norm, conv, x) -> torch.Tensor:
        """GroupNorm + SiLU written into the conv's haloed input."""
        if conv.weight.shape[-1] == 1:
            return conv(self.group_norm(norm, x, act="silu"))
        return conv_apply(conv, self.gn_silu_halo(norm, x))

    # -- group norm ---------------------------------------------------------

    def group_norm(self, norm, x, act=None) -> torch.Tensor:
        """Per-image statistics across the image's patches, float32.

        The variance is NOT clamped at 0 here, as in the JAX context's
        group_norm (unlike the fused op's moments)."""
        pp, c, s, _ = x.shape
        g = norm.num_groups
        mean, mean_sq = group_sums(x, self.image_id, self.meta.i_pad, g)
        var = mean_sq - mean * mean
        xf = x.float().reshape(pp, g, c // g * s * s)
        m = mean[self.image_id][:, :, None]
        r = torch.rsqrt(var + norm.eps)[self.image_id][:, :, None]
        y = ((xf - m) * r).reshape(pp, c, s, s)
        y = y * norm.weight.float().reshape(1, c, 1, 1) \
            + norm.bias.float().reshape(1, c, 1, 1)
        if act == "silu":
            y = F.silu(y)
        elif act is not None:
            raise ValueError(act)
        return y.to(x.dtype)

    # -- attention ----------------------------------------------------------

    def self_attention(self, attn, h) -> torch.Tensor:
        """h: (P, s^2, C) patch token runs -> full-image attention.

        Patches are gathered into per-resolution-class image groups
        ``(I_c, g^2 s^2, C)`` — one masked attention per class — and the
        token runs scattered back.  A single class uses the one-group
        layout (``group_gather`` / ``kv_mask``)."""
        q, k, v = attn.to_q(h), attn.to_k(h), attn.to_v(h)
        pp, s2, c = q.shape
        m = self.meta

        if len(m.class_info) <= 1:
            def group(x):
                return x[self.group_gather].reshape(m.i_pad, m.max_pp * s2, c)

            mask = self.kv_mask.repeat_interleave(s2, dim=1)
            out = masked_attention(group(q), group(k), group(v), attn.heads,
                                   mask)
            return out.reshape(m.i_pad * m.max_pp, s2, c)[self.patch_pos]

        out = torch.zeros_like(q)
        for ci, (g, ipc) in enumerate(m.class_info):
            gather = self.class_gather[ci]

            def group(x, gather=gather, ipc=ipc, g=g):
                return x[gather].reshape(ipc, g * g * s2, c)

            mask = self.class_kv[ci].repeat_interleave(s2, dim=1)
            o = masked_attention(group(q), group(k), group(v), attn.heads,
                                 mask)
            rows = o.reshape(ipc * g * g, s2, c)[self.class_pos[ci]]
            out = torch.where(self.class_member[ci][:, None, None], rows, out)
        return out

    def cross_attention(self, attn, h, ehs, rows=None) -> torch.Tensor:
        """h: (P, s^2, C); ehs: (I_pad, L, D) per-image text context.

        ``rows``: ``h`` holds only these patch rows (the two-level compact
        rows, ``CacheConfig.patch_fraction``), whose images' K/V they
        take."""
        image_id = self.image_id if rows is None else self.image_id[rows]
        k = attn.to_k(ehs)[image_id]
        v = attn.to_v(ehs)[image_id]
        return masked_attention(attn.to_q(h), k, v, attn.heads)


class PatchShardContext:
    """Shard ``rank``'s range ``[lo, hi)`` of a patch batch over a group's
    ``axis`` (its ops run on the shard's thread, inside ``ShardGroup.run``;
    it holds index tensors only, so one context serves every forward of
    its composition).  Each op gives the one-device context's rows ``[lo,
    hi)``; a shard with no rows still takes part in every collective."""

    row_reducer = None  # a row is a patch: the gates' row means are local

    def __init__(self, meta: PatchMeta, group, rank: int, axis: str = "sp"):
        self.meta = meta
        self.group = group
        self.axis = axis
        self.rank = rank
        n = group.axis_size(axis)
        sm = shard_meta(meta, n)[group.axis_index(axis, rank)]
        dev = group.device(rank)
        self.device = dev

        def t(a, dtype=torch.long):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.n_loc = sm.n_loc
        self.local_range = (sm.lo, sm.hi)
        self.image_id_ext32 = t(sm.image_id, torch.int32)
        self.image_id = self.image_id_ext32[:sm.n_loc].long()
        self.neighbors_ext32 = t(sm.neighbors, torch.int32)
        self.neighbors32 = self.neighbors_ext32[:sm.n_loc]
        self.send = t(sm.send[group.axis_index(axis, rank)])
        self.ghost_pos = t(sm.ghost_pos)
        self.attn = [(t(kv), t(q.clip(0)), t(op), t(mem, torch.bool),
                      t(meta.class_kv[ci][slots], torch.bool), len(slots), lq)
                     for ci, (slots, kv, q, op, mem, lq) in enumerate(sm.attn)]
        self.image_patches = t(sm.image_patches, torch.float32)
        self.image_onehot = (self.image_id[None, :] == torch.arange(
            meta.i_pad, device=dev)[:, None]).float()
        self._full = None
        self._subs = {}

    # -- the gates' view ------------------------------------------------------

    def gate_view(self) -> PatchContext:
        """The whole batch's index arrays, on this shard's device."""
        if self._full is None:
            self._full = PatchContext(self.meta, self.device)
        return self._full

    def rows_all(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's rows of a per-row tensor, in batch order."""
        return self.group.all_gather(t.contiguous(), self.axis, 0)

    def real_rows(self, caps):
        return self.gate_view().real_rows(caps)

    def compact_context(self, fraction: float, even: bool):
        key = (fraction, even)
        if key not in self._subs:
            sub, caps = compact_submeta(self.meta.patch_cells,
                                        self.meta.class_info, fraction, even)
            self._subs[key] = (PatchShardContext(sub, self.group, self.rank,
                                                 self.axis), caps)
        return self._subs[key]

    def _share(self, k: int):
        """This shard's range of ``k`` selected positions."""
        return shard_ranges(k, self.group.axis_size(self.axis))[
            self.group.axis_index(self.axis, self.rank)]

    def take_rows(self, h, rows):
        """This shard's share of the selected rows ``rows`` (global indices
        into the batch, every shard's alike), gathered from every shard's
        ``h``; with their indices for cross-attention."""
        a, b = self._share(rows.shape[0])
        return self.rows_all(h)[rows[a:b]], rows[a:b]

    def positions(self, rows):
        """For each of this shard's rows, its position in ``rows``
        (distinct global indices), or -1."""
        pos = torch.full((self.meta.p_pad,), -1, dtype=torch.long,
                         device=rows.device)
        pos.index_copy_(0, rows, torch.arange(rows.shape[0],
                                              device=rows.device))
        lo, hi = self.local_range
        return pos[lo:hi]

    def _placed(self, h, rows, vals):
        """``h`` with the rows of ``rows`` that lie in this shard replaced
        by their ``vals`` (one per selected row), a new tensor."""
        pos = self.positions(rows)
        keep = (pos >= 0).reshape((-1,) + (1,) * (h.dim() - 1))
        return torch.where(keep, vals[pos.clamp(min=0)].to(h.dtype), h)

    def put_rows(self, h, rows, hs):
        """``h`` with the rows of ``rows`` that lie in this shard replaced
        by the values every shard computed (``hs`` its share)."""
        return self._placed(h, rows, self.group.all_gather(
            hs.contiguous(), self.axis, 0))

    def write_rows(self, t, rows, vals) -> None:
        t.copy_(self._placed(t, rows, vals))

    def select_rows(self, h, rows):
        return self.rows_all(h)[rows]

    # -- the seam ------------------------------------------------------------

    def broadcast_to_patches(self, img_rows: torch.Tensor) -> torch.Tensor:
        return img_rows[self.image_id]

    per_patch = broadcast_to_patches

    def _with_ghosts(self, x):
        """``x`` (own rows) followed by its ghost patches."""
        buf = self.group.all_gather(x[self.send].contiguous(), self.axis, 0)
        return torch.cat([x, buf[self.ghost_pos]])

    def conv(self, conv, x, stride: int = 1) -> torch.Tensor:
        k = conv.weight.shape[-1]
        if k == 1:
            return conv(x)
        if k != 3:
            raise NotImplementedError(f"patch conv kernel {k}")
        return conv_apply(conv, haloed(x, self.neighbors32,
                                       src=self._with_ghosts(x)), stride)

    def upsample_2x(self, x) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")

    def _sums(self, x, groups: int):
        """Per-image ``(E[x], E[x^2])`` of each group over every shard's
        patches: the local one-hot product, ``psum`` over the axis."""
        pp, c, s, _ = x.shape  # pp may be 0: a shard may hold no patch
        xf = x.float().reshape(pp, groups, c // groups * s * s)
        parts = torch.cat([xf.sum(dim=2), (xf * xf).sum(dim=2)], dim=1)
        sums = self.group.psum(self.image_onehot @ parts, self.axis)
        cnt = torch.clamp(self.image_patches * xf.shape[2], min=1.0)[:, None]
        return sums[:, :groups] / cnt, sums[:, groups:] / cnt

    def gn_silu_halo(self, norm, x) -> torch.Tensor:
        """K4 over the shard's patches and its ghosts (the ghosts' own
        halo rows are not kept)."""
        mean, mean_sq = self._sums(x, norm.num_groups)
        rstd = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0)
                           + norm.eps)
        ext = self._with_ghosts(x.contiguous())
        if ext.shape[0] == 0:
            s = x.shape[-1]
            return x.new_zeros((0, x.shape[1], s + 2, s + 2))
        out = gn_silu_halo(ext, self.image_id_ext32, self.neighbors_ext32,
                           mean, rstd, norm.weight, norm.bias, "silu")
        return out[:self.n_loc]

    def gn_silu_conv(self, norm, conv, x) -> torch.Tensor:
        if conv.weight.shape[-1] == 1:
            return conv(self.group_norm(norm, x, act="silu"))
        return conv_apply(conv, self.gn_silu_halo(norm, x))

    def group_norm(self, norm, x, act=None) -> torch.Tensor:
        pp, c, s, _ = x.shape
        g = norm.num_groups
        mean, mean_sq = self._sums(x, g)
        var = mean_sq - mean * mean
        xf = x.float().reshape(pp, g, c // g * s * s)
        m = mean[self.image_id][:, :, None]
        r = torch.rsqrt(var + norm.eps)[self.image_id][:, :, None]
        y = ((xf - m) * r).reshape(pp, c, s, s)
        y = y * norm.weight.float().reshape(1, c, 1, 1) \
            + norm.bias.float().reshape(1, c, 1, 1)
        if act == "silu":
            y = F.silu(y)
        elif act is not None:
            raise ValueError(act)
        return y.to(x.dtype)

    def self_attention(self, attn, h) -> torch.Tensor:
        """The shard's own query patches against the K/V of every patch of
        their images (``all_gather`` over the axis), one masked attention
        per resolution class."""
        q, k, v = attn.to_q(h), attn.to_k(h), attn.to_v(h)
        pp, s2, c = q.shape
        k_all, v_all = self.group.all_gather((k.contiguous(),
                                              v.contiguous()), self.axis, 0)
        out = torch.zeros_like(q)
        for kv_gather, q_gather, out_pos, member, kv_mask, n_img, lq in \
                self.attn:
            if n_img == 0:
                continue
            lk = kv_gather.shape[0] // n_img
            o = masked_attention(
                q[q_gather].reshape(n_img, lq * s2, c),
                k_all[kv_gather].reshape(n_img, lk * s2, c),
                v_all[kv_gather].reshape(n_img, lk * s2, c), attn.heads,
                kv_mask.repeat_interleave(s2, dim=1))
            rows = o.reshape(n_img * lq, s2, c)[out_pos]
            out = torch.where(member[:, None, None], rows, out)
        return out

    def cross_attention(self, attn, h, ehs, rows=None) -> torch.Tensor:
        """``rows``: global batch indices of ``h``'s rows (two-level compact
        rows), whose images' K/V they take."""
        image_id = (self.image_id if rows is None
                    else self.gate_view().image_id[rows])
        if h.shape[0] == 0:
            return attn.to_q(h)
        k = attn.to_k(ehs)[image_id]
        v = attn.to_v(ehs)[image_id]
        return masked_attention(attn.to_q(h), k, v, attn.heads)


@functools.lru_cache(maxsize=32)
def compact_context(patch_cells: int, class_info, fraction: float,
                    even: bool, device: torch.device):
    """``(PatchContext, caps)`` of ``compact_submeta``'s sub-composition,
    built once per sub-meta and device: its index tensors stay on the
    device from one gated step to the next."""
    sub, caps = compact_submeta(patch_cells, class_info, fraction, even)
    return PatchContext(sub, device), caps
