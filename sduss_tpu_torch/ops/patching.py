"""Mixed-resolution patch batching: layouts and index metadata (counterpart
of sduss_tpu/ops/patching.py).

Latents of different resolutions are cut into fixed ``patch_cells`` x
``patch_cells`` patches and concatenated on the batch axis, so one UNet
forward serves a 512/768/1024 mixture.  The metadata is built on the host
in numpy, per batch composition (the per-image patch-grid sides), exactly
as the JAX package builds it, so both packages form the same patch batch
row for row:

  image_id     (P,)    patch -> image slot
  neighbors    (P, 8)  patch -> [up, down, left, right, ul, ur, dl, dr], -1 = edge
  group_gather (I*max_pp,)  group row -> patch index (-1 = padded slot)
  patch_pos    (P,)    patch -> flat group row (image_id * max_pp + position)
  kv_mask      (I, max_pp)  which group slots hold real patches

plus per-resolution-class copies of the grouping arrays.  ``P`` is padded to
a patch-count bucket and ``I`` to an image-count bucket; padded patches
belong to a dummy image slot, so they never touch a real image's
statistics.  The index arrays go to the device once per step
(``ops/patch_ctx.py``).  The JAX package's native C++ layout code gives
the same arrays; the port builds them in Python.  ``compact_submeta``
gives the canonical sub-composition that the deep cache's image gate
recomputes on a shallow step.  ``shard_meta`` cuts a patch batch into
contiguous row ranges, one a shard of a replica's ``sp`` axis, and gives
each shard what its ops need from the others: its ghost patches (the
neighbours its halo reads from another shard's range) and the per-class
layout of its own attention queries.

Tensor helpers: ``split_latent`` / ``merge_patches`` keep the JAX layout
(NHWC latents and patches); ``haloed`` works on NCHW patch activations,
the layout the port's UNet runs in.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PatchMeta:
    """Metadata for one (padded) patch batch composition."""

    patch_cells: int            # latent cells per patch side (256px / 8 = 32)
    grids: Tuple[int, ...]      # per real image: patches per side
    n_patches: int              # real patches
    n_images: int               # real images
    p_pad: int                  # padded patch count
    i_pad: int                  # padded image count
    max_pp: int                 # max patches per image (padded slot width)

    image_id: np.ndarray        # (p_pad,) int32
    neighbors: np.ndarray       # (p_pad, 8) int32
    group_gather: np.ndarray    # (i_pad * max_pp,) int32
    patch_pos: np.ndarray       # (p_pad,) int32
    kv_mask: np.ndarray         # (i_pad, max_pp) bool

    # Per-resolution-class grouped attention: one entry per distinct
    # patch-grid side g, largest class first:
    #   class_info    ((g, i_pad_class), ...)
    #   class_gather  (i_pad_class * g*g,) -> patch    -- -1 = padded slot
    #   class_pos     (p_pad,) -> row in class group   -- 0 for non-members
    #   class_member  (p_pad,) bool
    #   class_kv      (i_pad_class, g*g) bool
    class_info: Tuple[Tuple[int, int], ...] = ()
    class_gather: Tuple[np.ndarray, ...] = ()
    class_pos: Tuple[np.ndarray, ...] = ()
    class_member: Tuple[np.ndarray, ...] = ()
    class_kv: Tuple[np.ndarray, ...] = ()

    @property
    def compile_key(self) -> Tuple:
        """The composition's static shape: what the deep x compact hybrid's
        composition-store signature keys on (JAX ``PatchMeta.compile_key``).
        Two compositions with one key have the same buckets, slot width and
        class layout."""
        return (self.patch_cells, self.p_pad, self.i_pad, self.max_pp,
                self.class_info)


def _bucket(value: int, buckets: Sequence[int]) -> int:
    """Round up to a bucket; values beyond the largest bucket stay exact.

    Counts inside patch metadata legitimately exceed the admission buckets:
    the dummy image slot adds one on a full-ceiling batch, and CFG doubling
    doubles a class's slot count."""
    for b in buckets:
        if value <= b:
            return b
    return value


def _class_arrays(slot_grid: dict, image_id: np.ndarray, patch_pos: np.ndarray,
                  max_pp: int, image_buckets: Sequence[int]):
    """Per-resolution-class grouped-attention index arrays.

    ``slot_grid``: image slot -> patch-grid side g (real slots only).
    Patches of pad slots are members of no class (discarded at merge).
    """
    pos_in_img = patch_pos - image_id * max_pp
    classes = sorted({g for g in slot_grid.values()}, reverse=True)
    info, gathers, poss, members, kvs = [], [], [], [], []
    for g in classes:
        slots = [s for s, gg in slot_grid.items() if gg == g]
        ipc = _bucket(len(slots), image_buckets)
        local = {s: i for i, s in enumerate(slots)}
        member = np.isin(image_id, slots)
        member &= pos_in_img < g * g
        local_img = np.asarray([local.get(s, 0) for s in range(image_id.max() + 1)],
                               np.int32)
        cpos = np.where(member, local_img[image_id] * g * g + pos_in_img, 0)
        gather = np.full((ipc * g * g,), -1, np.int32)
        gather[cpos[member]] = np.nonzero(member)[0].astype(np.int32)
        kv = np.zeros((ipc, g * g), bool)
        kv.reshape(-1)[cpos[member]] = True
        info.append((g, ipc))
        gathers.append(gather)
        poss.append(cpos.astype(np.int32))
        members.append(member)
        kvs.append(kv)
    return (tuple(info), tuple(gathers), tuple(poss), tuple(members),
            tuple(kvs))


@functools.lru_cache(maxsize=256)
def build_meta(grids: Tuple[int, ...], patch_cells: int,
               patch_buckets: Tuple[int, ...],
               image_buckets: Tuple[int, ...]) -> PatchMeta:
    """Build metadata for a composition given as per-image patch-grid sides."""
    n_images = len(grids)
    n_patches = int(sum(g * g for g in grids))
    p_pad = _bucket(n_patches, patch_buckets)
    # Reserve a dummy image slot when patch padding exists so padded patches
    # never pollute a real image's statistics.
    need_dummy = p_pad > n_patches
    i_pad = _bucket(n_images + (1 if need_dummy else 0), image_buckets)
    max_pp = max(g * g for g in grids)

    image_id = np.full((p_pad,), i_pad - 1, np.int32)
    neighbors = np.full((p_pad, 8), -1, np.int32)
    patch_pos = np.zeros((p_pad,), np.int32)
    group_gather = np.full((i_pad * max_pp,), -1, np.int32)
    kv_mask = np.zeros((i_pad, max_pp), bool)

    base = 0
    for img, g in enumerate(grids):
        for i in range(g):
            for j in range(g):
                p = base + i * g + j
                image_id[p] = img
                pos = i * g + j
                patch_pos[p] = img * max_pp + pos
                group_gather[img * max_pp + pos] = p
                kv_mask[img, pos] = True

                def nb(di, dj):
                    ii, jj = i + di, j + dj
                    if 0 <= ii < g and 0 <= jj < g:
                        return base + ii * g + jj
                    return -1

                neighbors[p] = [nb(-1, 0), nb(1, 0), nb(0, -1), nb(0, 1),
                                nb(-1, -1), nb(-1, 1), nb(1, -1), nb(1, 1)]
        base += g * g

    # Padded patches point at the dummy image's first group slot (their
    # attention output is garbage but isolated).
    if need_dummy:
        patch_pos[n_patches:] = (i_pad - 1) * max_pp

    slot_grid = {i: g for i, g in enumerate(grids)}
    ci, cg, cp, cm, ck = _class_arrays(slot_grid, image_id, patch_pos,
                                       max_pp, image_buckets)
    return PatchMeta(
        patch_cells=patch_cells, grids=grids, n_patches=n_patches,
        n_images=n_images, p_pad=p_pad, i_pad=i_pad, max_pp=max_pp,
        image_id=image_id, neighbors=neighbors, group_gather=group_gather,
        patch_pos=patch_pos, kv_mask=kv_mask, class_info=ci,
        class_gather=cg, class_pos=cp, class_member=cm, class_kv=ck)


@functools.lru_cache(maxsize=256)
def compact_submeta(patch_cells: int,
                    class_info: Tuple[Tuple[int, int], ...],
                    fraction: float, even: bool = False):
    """The sub-composition of image-granular compact recompute.

    Each gated step recomputes the ``round(ipc * fraction)`` most-drifted
    images of every resolution class (at least one), gathered with all
    their patches, so that per-image group norm, halos and grouped
    attention are exact on the sub-batch.  ``even`` (the deep x compact
    hybrid on the CFG-doubled meta) raises each capacity to even, at most
    ``ipc``, so that symmetrised pair scores select both halves of an image
    together.  The grids are class-major (largest class first), the order
    in which the gate concatenates its per-class gathers, and the buckets
    fit exactly: the sub-batch has no padding of its own.

    Returns ``(sub_meta, caps)``, ``caps[ci]`` the image capacity of class
    ``ci``; the same arguments return the same objects.
    """
    caps = [max(1, int(round(ipc * fraction))) for (_, ipc) in class_info]
    if even:
        caps = [min(ipc, c + (c % 2)) for (_, ipc), c in zip(class_info, caps)]
    grids = []
    for (g, _), c in zip(class_info, caps):
        grids += [g] * c
    n_p = sum(g * g for g in grids)
    sub = build_meta(tuple(grids), patch_cells, (n_p,), (len(grids),))
    return sub, tuple(caps)


def gate_images(meta: PatchMeta, caps: Sequence[int]) -> List[int]:
    """Per class of ``meta``, the real images that an image gate of
    capacities ``caps`` recomputes: ``min(caps[ci], real images)``, since
    real slots outrank the pads."""
    return [min(cap, int(kv[:, 0].sum()))
            for kv, cap in zip(meta.class_kv, caps)]


@functools.lru_cache(maxsize=256)
def double_meta(grids: Tuple[int, ...], patch_cells: int,
                patch_buckets: Tuple[int, ...],
                image_buckets: Tuple[int, ...]) -> PatchMeta:
    """Metadata for the CFG-doubled batch: [uncond block | cond block].

    Patch p and p + p_pad belong to image slots i and i + i_pad.
    """
    m = build_meta(grids, patch_cells, patch_buckets, image_buckets)
    off_p, off_i = m.p_pad, m.i_pad
    image_id = np.concatenate([m.image_id, m.image_id + off_i])
    neighbors = np.concatenate([
        m.neighbors,
        np.where(m.neighbors >= 0, m.neighbors + off_p, -1)])
    patch_pos = np.concatenate([m.patch_pos, m.patch_pos + off_i * m.max_pp])
    group_gather = np.concatenate([
        m.group_gather,
        np.where(m.group_gather >= 0, m.group_gather + off_p, -1)])
    kv_mask = np.concatenate([m.kv_mask, m.kv_mask])
    slot_grid = {i: g for i, g in enumerate(grids)}
    slot_grid.update({off_i + i: g for i, g in enumerate(grids)})
    ci, cg, cp, cm, ck = _class_arrays(slot_grid, image_id, patch_pos,
                                       m.max_pp, image_buckets)
    return PatchMeta(
        patch_cells=m.patch_cells, grids=m.grids + m.grids,
        n_patches=2 * m.n_patches,
        n_images=2 * m.n_images, p_pad=2 * m.p_pad, i_pad=2 * m.i_pad,
        max_pp=m.max_pp, image_id=image_id, neighbors=neighbors,
        group_gather=group_gather, patch_pos=patch_pos, kv_mask=kv_mask,
        class_info=ci, class_gather=cg, class_pos=cp, class_member=cm,
        class_kv=ck)


# ---------------------------------------------------------------------------
# A patch batch over the shards of an sp group.
# ---------------------------------------------------------------------------


def shard_ranges(n: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """``parts`` contiguous ``[lo, hi)`` ranges of ``n`` rows in order; the
    first ``n % parts`` take one row more."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (1 if i < r else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    """One shard's rows ``[lo, hi)`` of a patch batch (host arrays).

    The shard's extended rows are its own ``n_loc = hi - lo`` patches, then
    its ghosts: the patches of other shards that its halo reads.  Each
    shard sends ``send[q]`` of its rows (shard ``q``'s, relative to its
    ``lo``); the shards' sends, gathered in shard order, hold every ghost,
    ``ghost_pos`` giving each ghost's row there.

    ``attn`` holds, per resolution class, the layout of the shard's own
    queries: ``(img_slots, kv_gather, q_gather, out_pos, member, lq)``:
    the class slots of the images with a patch here, the global patch rows
    of those images' keys, the queries grouped ``lq`` patches an image
    (``-1`` = pad), each own patch's row in the grouped output, and which
    own patches belong to the class."""

    lo: int
    hi: int
    image_id: np.ndarray            # (n_loc + n_ghost,) int32
    neighbors: np.ndarray           # (n_loc + n_ghost, 8) int32, extended rows
    send: Tuple[np.ndarray, ...]    # per shard: rows (relative) it sends
    ghost_pos: np.ndarray           # (n_ghost,) rows in the gathered sends
    image_patches: np.ndarray       # (i_pad,) float32: patches an image
    attn: Tuple[tuple, ...]

    @property
    def n_loc(self) -> int:
        return self.hi - self.lo


_SHARD_METAS: dict = {}


def shard_meta(meta: PatchMeta, parts: int) -> Tuple[ShardMeta, ...]:
    """``meta``'s batch over ``parts`` shards in contiguous row ranges
    (:func:`shard_ranges` of ``p_pad``), one ``ShardMeta`` a shard; built
    once per meta object (``build_meta`` returns one object per
    composition) and shard count."""
    key = (id(meta), parts)
    hit = _SHARD_METAS.get(key)
    if hit is not None and hit[0] is meta:
        return hit[1]
    ranges = shard_ranges(meta.p_pad, parts)
    owner = np.zeros((meta.p_pad,), np.int64)
    for q, (lo, hi) in enumerate(ranges):
        owner[lo:hi] = q
    needs = []
    for lo, hi in ranges:
        nb = meta.neighbors[lo:hi]
        far = np.unique(nb[nb >= 0])
        needs.append(far[(far < lo) | (far >= hi)])
    send = []
    for q, (lo, hi) in enumerate(ranges):
        rows = [n[(n >= lo) & (n < hi)] for r, n in enumerate(needs) if r != q]
        rows = np.unique(np.concatenate(rows)) if rows else np.zeros(0, int)
        send.append((rows - lo).astype(np.int64))
    offsets = np.cumsum([0] + [len(s) for s in send])
    image_patches = np.bincount(meta.image_id, minlength=meta.i_pad).astype(
        np.float32)
    out = []
    for (lo, hi), need in zip(ranges, needs):
        n_loc = hi - lo
        ext = np.concatenate([np.arange(lo, hi), need]).astype(np.int64)
        local = {int(g): i for i, g in enumerate(ext)}
        nb = np.full((len(ext), 8), -1, np.int32)
        for i in range(n_loc):
            for k, g in enumerate(meta.neighbors[lo + i]):
                if g >= 0:
                    nb[i, k] = local[int(g)]
        ghost_pos = np.asarray(
            [offsets[owner[g]] + int(np.searchsorted(
                send[owner[g]], g - ranges[owner[g]][0])) for g in need],
            np.int64)
        attn = []
        for (g, ipc), member, cpos, cgather in zip(
                meta.class_info, meta.class_member, meta.class_pos,
                meta.class_gather):
            own = [p for p in range(lo, hi) if member[p]]
            slots = sorted({int(cpos[p]) // (g * g) for p in own})
            per = {s: [p for p in own if int(cpos[p]) // (g * g) == s]
                   for s in slots}
            lq = max((len(v) for v in per.values()), default=0)
            q_gather = np.full((len(slots) * lq,), -1, np.int64)
            out_pos = np.zeros((n_loc,), np.int64)
            for j, s in enumerate(slots):
                for k, p in enumerate(per[s]):
                    q_gather[j * lq + k] = p - lo
                    out_pos[p - lo] = j * lq + k
            kv_gather = cgather.reshape(ipc, g * g)[slots].reshape(-1)
            attn.append((np.asarray(slots, np.int64), kv_gather.astype(
                np.int64), q_gather, out_pos, member[lo:hi].copy(), lq))
        out.append(ShardMeta(
            lo=lo, hi=hi, image_id=meta.image_id[ext].astype(np.int32),
            neighbors=nb, send=tuple(send), ghost_pos=ghost_pos,
            image_patches=image_patches, attn=tuple(attn)))
    out = tuple(out)
    if len(_SHARD_METAS) >= 256:
        _SHARD_METAS.pop(next(iter(_SHARD_METAS)))
    _SHARD_METAS[key] = (meta, out)
    return out


# ---------------------------------------------------------------------------
# Latent <-> patch-batch reshapes.
# ---------------------------------------------------------------------------


def split_latent(lat: torch.Tensor, patch_cells: int) -> torch.Tensor:
    """(1, h, h, C) NHWC -> (g*g, s, s, C) raster-ordered patches."""
    if lat.shape[0] != 1:
        raise ValueError(f"split_latent takes one image, got batch "
                         f"{lat.shape[0]}")
    _, h, w, c = lat.shape
    s = patch_cells
    g = h // s
    x = lat[0].reshape(g, s, g, s, c)
    return x.permute(0, 2, 1, 3, 4).reshape(g * g, s, s, c)


def merge_patches(patches: torch.Tensor, grid: int) -> torch.Tensor:
    """(g*g, s, s, C) -> (1, g*s, g*s, C)."""
    n, s, _, c = patches.shape
    x = patches.reshape(grid, grid, s, s, c).permute(0, 2, 1, 3, 4)
    return x.reshape(1, grid * s, grid * s, c)


def haloed(x: torch.Tensor, neighbors: torch.Tensor,
           src: torch.Tensor = None) -> torch.Tensor:
    """Add a 1-cell halo from the 8 neighbour patches, NCHW:
    (P, C, s, s) -> (P, C, s+2, s+2), zero where a neighbour is -1.

    ``neighbors``: (P, 8) integer tensor on x's device, rows of ``src``
    (``x`` by default; a shard's own patches then its ghosts).  Only the
    edge rows and columns of the neighbours are gathered.
    """
    s = x.shape[-1]
    src = x if src is None else src

    def take(k, rows, cols):
        idx = neighbors[:, k].long()
        part = src[:, :, rows, cols][idx.clamp(min=0)]
        valid = (idx >= 0).reshape(-1, 1, 1, 1)
        return torch.where(valid, part, torch.zeros_like(part))

    last, first, all_ = slice(s - 1, s), slice(0, 1), slice(None)
    up = take(0, last, all_)
    down = take(1, first, all_)
    left = take(2, all_, last)
    right = take(3, all_, first)
    ul = take(4, last, last)
    ur = take(5, last, first)
    dl = take(6, first, last)
    dr = take(7, first, first)

    top = torch.cat([ul, up, ur], dim=3)        # (P, C, 1, s+2)
    mid = torch.cat([left, x, right], dim=3)    # (P, C, s, s+2)
    bot = torch.cat([dl, down, dr], dim=3)      # (P, C, 1, s+2)
    return torch.cat([top, mid, bot], dim=2)
