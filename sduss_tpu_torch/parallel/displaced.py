"""Displaced patch parallelism: latent rows sharded over a group's ``sp``
axis (counterpart of sduss_tpu/parallel/displaced.py).

Each shard holds a horizontal row slice of the latent and runs the
denoiser on it inside ``ShardGroup.run``; the model's ``ctx`` seam hands
the ops that cross rows to a context with explicit collectives:

* ``ShardContext`` (the UNet families, NCHW ``(B, C, H/n, W)``):
  - 3x3 convolutions: one halo row from each neighbour in one rendezvous
    (zeros at the image border), stride 1 and 2 (stride 2 takes only the
    top row); exact;
  - group norm: local sums, ``psum`` over ``sp``; exact;
  - self-attention: the K/V of every row, fresh by ``all_gather`` (sync,
    exact), or, in stale mode, this shard's fresh rows spliced into the
    previous step's full K/V while the fresh gather is kept for the next
    step (DistriFuser's displaced step);
  - cross-attention: the text K/V are per image, replicated; local;
  - the cache gates' per-row drift means: local float32 sums, ``psum``
    over ``sp`` in rank order, divided by the global count
    (``row_reducer``), so that every shard selects the same rows.
* ``MMDiTShardContext`` (SD3): latent token rows sharded, the context
  tokens replicated; joint and dual attention gather the latent K/V
  (``kv_mode="gather"``: sync or stale splice, as above) or rotate them
  around the ring (``"ring"``: exact, ``parallel/ring.py``); the position
  grid's rows come from the global crop (``pos_embed_rows``).  On the
  padded-token path it holds this shard's token mask and every shard's
  (``key_mask``), which keeps padded keys out of every softmax, reduces
  the row gates' means like ``ShardContext`` and gives the fine token
  gate the whole row's scores (``tokens_all``) and a share of its
  selection (``share``).

The stale K/V live in ``kv_state``: the UNet's keyed by attention module,
the MMDiT's by call order within a forward (one counter per forward, as
JAX's per-program counter).  A context is built per shard and step;
``new_kv_state`` collects what the next step reads.

``DisplacedPatchRunner`` drives whole trajectories offline (the serving
path is ``pipelines/base.py _denoise_group_displaced``), optionally
threading a token cache's rows, split over ``sp`` on their token axis.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sduss_tpu_torch.models.layers import conv_apply
from sduss_tpu_torch.ops.attention import masked_attention
from sduss_tpu_torch.ops.patching import shard_ranges
from sduss_tpu_torch.parallel.ring import (_partial_dense, combine_partials,
                                           finalize_partial, ring_attention)


class ShardContext:
    """The UNet's ctx seam on H-sharded ``(B, C, H/n, W)`` activations.

    ``kv_state``: the previous step's full K/V per attention module
    (``{module: {"k", "v"}}``); with ``stale`` the self-attentions splice
    into it; ``new_kv_state`` collects this step's gathered K/V."""

    def __init__(self, group, axis: str = "sp", stale: bool = False,
                 kv_state: Optional[Dict] = None):
        self.group = group
        self.axis = axis
        self.stale = stale
        self.kv_state = kv_state or {}
        self.new_kv_state: Dict = {}

    def _n(self) -> int:
        return self.group.axis_size(self.axis)

    # -- the cache gates' row reductions -------------------------------------

    @property
    def row_reducer(self):
        return self

    def psum_rows(self, sums):
        """Per-row float32 sums over every shard, added in rank order."""
        return self.group.psum(sums, self.axis)

    def row_count(self, local: int) -> int:
        """Elements of a row over every shard (the rows split evenly)."""
        return local * self._n()

    def _halo(self, x, down: bool = True):
        """``(row above, row below)``: the last row of the shard above and
        the first row of the one below, zeros at the image's edges, in one
        rendezvous (``down=False``: the row above alone)."""
        n = self._n()
        above = [(i, i + 1) for i in range(n - 1)]
        if not down:
            return self.group.ppermute(x[:, :, -1:].contiguous(), self.axis,
                                       above), None
        below = [(i, i - 1) for i in range(1, n)]
        return self.group.ppermute(
            (x[:, :, -1:].contiguous(), x[:, :, :1].contiguous()), self.axis,
            (above, below))

    # -- the ctx seam --------------------------------------------------------

    def broadcast_to_patches(self, temb):
        return temb  # the batch axis is not sharded

    per_patch = broadcast_to_patches

    def conv(self, conv, x, stride: int = 1):
        k = conv.weight.shape[-1]
        if k == 1:
            return conv(x)
        if k != 3:
            raise NotImplementedError(f"sharded conv kernel {k}")
        if stride == 1:
            up, down = self._halo(x)
            return conv_apply(conv, torch.cat([up, x, down], dim=2), 1,
                              (0, 1))
        # stride 2: output row r reads local rows 2r-1 .. 2r+1, so only the
        # row above is needed (the local height is even)
        up, _ = self._halo(x, down=False)
        return conv_apply(conv, torch.cat([up, x], dim=2), 2, (0, 1))

    def upsample_2x(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")

    def gn_silu_conv(self, norm, conv, x):
        return self.conv(conv, self.group_norm(norm, x, act="silu"))

    def group_norm(self, norm, x, act=None):
        """Exact per-image moments across the shards: local float32 sums,
        ``psum`` over ``sp`` (the variance unclamped, as JAX's)."""
        b, c, h, w = x.shape
        g = norm.num_groups
        xf = x.float().reshape(b, g, -1)
        s1, s2 = self.group.psum((xf.sum(dim=2), (xf * xf).sum(dim=2)),
                                 self.axis)
        cnt = float(h * w * (c // g) * self._n())
        mean = s1 / cnt
        var = s2 / cnt - mean * mean
        y = (xf - mean[..., None]) * torch.rsqrt(var[..., None] + norm.eps)
        y = y.reshape(b, c, h, w) * norm.weight.float().reshape(1, c, 1, 1) \
            + norm.bias.float().reshape(1, c, 1, 1)
        if act == "silu":
            y = F.silu(y)
        elif act is not None:
            raise ValueError(act)
        return y.to(x.dtype)

    def self_attention(self, attn, h):
        """h: ``(B, S_local, C)``, this shard's token rows of the image.
        ``to_out`` is applied by the caller (``models/unet.py``)."""
        q, k, v = attn.to_q(h), attn.to_k(h), attn.to_v(h)
        s_loc = k.shape[1]
        prev = self.kv_state.get(attn) if self.stale else None
        if prev is not None:
            off = self.group.axis_index(self.axis) * s_loc
            k_full = prev["k"].to(k.dtype, copy=True)
            v_full = prev["v"].to(v.dtype, copy=True)
            k_full[:, off:off + s_loc] = k
            v_full[:, off:off + s_loc] = v
            fresh = self.group.all_gather((k, v), self.axis, 1)
        else:
            k_full, v_full = fresh = self.group.all_gather((k, v), self.axis,
                                                            1)
        self.new_kv_state[attn] = {"k": fresh[0], "v": fresh[1]}
        return masked_attention(q, k_full, v_full, attn.heads)

    def cross_attention(self, attn, h, ehs, rows=None):
        return masked_attention(attn.to_q(h), attn.to_k(ehs), attn.to_v(ehs),
                                attn.heads)


class MMDiTShardContext:
    """Sequence-sharded MMDiT context: latent token rows over ``sp``, the
    context tokens replicated (displaced.py:162-265)."""

    def __init__(self, group, axis: str = "sp", stale: bool = False,
                 kv_state: Optional[Dict] = None, kv_mode: str = "gather",
                 token_mask=None, key_mask=None):
        if kv_mode not in ("gather", "ring"):
            raise ValueError(f"kv_mode must be gather|ring, got {kv_mode!r}")
        self.group = group
        self.axis = axis
        self.stale = stale
        self.kv_state = kv_state or {}
        self.new_kv_state: Dict = {}
        self.kv_mode = kv_mode
        self._layer = 0
        # the padded-token path: this shard's (B, S/n) mask and the whole
        # (B, S) one, whose False keys every attention masks out
        self.token_mask = token_mask
        self.key_mask = key_mask
        self.row_reducer = self if token_mask is not None else None

    # -- the padded-token path -----------------------------------------------

    psum_rows = ShardContext.psum_rows

    def row_count(self, local: int) -> int:
        return local * self.group.axis_size(self.axis)

    def gather(self, idx):
        """The context of the batch rows ``idx`` (a compact gate's
        sub-batch)."""
        return MMDiTShardContext(self.group, self.axis,
                                 token_mask=self.token_mask[idx],
                                 key_mask=self.key_mask[idx])

    def tokens_all(self, t):
        """``(B, S/n, ...)`` per-token rows of every shard, ``(B, S, ...)``
        in token order."""
        return self.group.all_gather(t.contiguous(), self.axis, 1)

    def token_offset(self) -> int:
        return self.group.axis_index(self.axis) * self.token_mask.shape[1]

    def share(self, k: int):
        """This shard's ``[a, b)`` of ``k`` selected positions."""
        return shard_ranges(k, self.group.axis_size(self.axis))[
            self.group.axis_index(self.axis)]

    def put_tokens(self, t, sel, vals) -> None:
        """``t[b, j] = vals[b, j]`` in place for the selected tokens ``j``
        of ``sel`` (B, k; global) that lie in this shard (``t`` and
        ``vals`` this shard's tokens)."""
        lo = self.token_offset()
        picked = torch.zeros(self.key_mask.shape, dtype=torch.bool,
                             device=t.device).scatter_(1, sel, True)
        picked = picked[:, lo:lo + t.shape[1]]
        picked = picked.reshape(picked.shape + (1,) * (t.dim() - 2))
        t.copy_(torch.where(picked, vals.to(t.dtype), t))

    def pos_embed_rows(self, model, hp_local: int, wp: int):
        """This shard's rows of the global position crop, ``(hp_local * wp,
        dim)`` float32, kept on the model per shard and shape."""
        n = self.group.axis_size(self.axis)
        idx = self.group.axis_index(self.axis)
        dev = self.group.device()
        key = ("rows", n, idx, hp_local, wp, str(dev))
        if key not in model._pos_dev:
            full = model.pos_grid(hp_local * n, wp).reshape(
                hp_local * n, wp, -1)
            rows = np.ascontiguousarray(
                full[idx * hp_local:(idx + 1) * hp_local])
            model._pos_dev[key] = torch.from_numpy(rows).reshape(
                hp_local * wp, -1).to(dev)
        return model._pos_dev[key]

    def _gather_or_splice(self, key, k_loc, v_loc):
        """The full latent K/V ``(B, S_lat, H, hd)``: gathered (sync) or this
        shard's rows spliced into the stale ones."""
        prev = self.kv_state.get(key) if self.stale else None
        if prev is not None:
            s_loc = k_loc.shape[1]
            off = self.group.axis_index(self.axis) * s_loc
            k_full = prev["k"].to(k_loc.dtype, copy=True)
            v_full = prev["v"].to(v_loc.dtype, copy=True)
            k_full[:, off:off + s_loc] = k_loc
            v_full[:, off:off + s_loc] = v_loc
            fresh = self.group.all_gather((k_loc, v_loc), self.axis, 1)
        else:
            k_full, v_full = fresh = self.group.all_gather(
                (k_loc, v_loc), self.axis, 1)
        self.new_kv_state[key] = {"k": fresh[0], "v": fresh[1]}
        return k_full, v_full

    def mmdit_attention(self, q, k, v, s_lat: int, kv_full: bool = False):
        """``(B, S, H, hd)`` joint or latent-only attention; the leading
        ``s_lat`` keys are this shard's latent rows (every shard's, with
        ``kv_full``), any more the replicated context."""
        key = self._layer
        self._layer += 1
        b, s, nh, hd = q.shape
        # joint iff the keys carry context rows (the queries may be a
        # gated subset of the latent rows)
        joint = k.shape[1] > s_lat
        k_lat, v_lat = k[:, :s_lat], v[:, :s_lat]
        q2 = q.reshape(b, s, nh * hd)
        if self.kv_mode == "ring" and not self.stale:
            o, m, l = ring_attention(
                q2, k_lat.reshape(b, s_lat, nh * hd),
                v_lat.reshape(b, s_lat, nh * hd), nh, self.group, self.axis,
                return_stats=True)
            if not joint:
                return finalize_partial(o, m, l, q.dtype)
            s_ctx = k.shape[1] - s_lat
            o2, m2, l2 = _partial_dense(
                q2, k[:, s_lat:].reshape(b, s_ctx, nh * hd),
                v[:, s_lat:].reshape(b, s_ctx, nh * hd), nh,
                1.0 / math.sqrt(hd))
            return combine_partials(o, m, l, o2, m2, l2, q.dtype)
        if kv_full:
            k_full, v_full = k_lat, v_lat
        else:
            k_full, v_full = self._gather_or_splice(key, k_lat, v_lat)
        mask = self.key_mask
        if joint:
            k_full = torch.cat([k_full, k[:, s_lat:]], dim=1)
            v_full = torch.cat([v_full, v[:, s_lat:]], dim=1)
            if mask is not None:
                mask = torch.cat([mask, mask.new_ones(
                    (b, k.shape[1] - s_lat))], dim=1)
        lk = k_full.shape[1]
        return masked_attention(q2, k_full.reshape(b, lk, nh * hd),
                                v_full.reshape(b, lk, nh * hd), nh,
                                kv_token_mask=mask)


def shard_rows(x, group, axis: str = "sp", dim: int = 1, rank=None,
               ranges=None, copy: bool = False):
    """This shard's slice of ``x`` along ``dim``, on the shard's device:
    an equal share (``x.shape[dim]`` must divide by the axis size), or
    with ``ranges`` the axis index's ``[lo, hi)``; ``dim`` None: the whole
    of ``x``.  ``copy``: a new tensor even where the slice already is one
    on that device."""
    i = group.axis_index(axis, rank)
    if dim is None:
        part = x
    elif ranges is not None:
        lo, hi = ranges[i]
        part = x.narrow(dim, lo, hi - lo)
    else:
        n = group.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} rows do not split over "
                             f"{axis}={n}")
        m = x.shape[dim] // n
        part = x.narrow(dim, i * m, m)
    return part.to(group.device(rank), copy=copy).contiguous()


def gather_rows(outs, group, dim: int, device):
    """The lead shards' row slices (one per sp index, tp index 0)
    concatenated along ``dim`` on ``device``."""
    return torch.cat([outs[r].to(device) for r in group.lead_ranks()],
                     dim=dim)


class DisplacedPatchRunner:
    """Drives a denoiser under displaced patch parallelism on a group
    (displaced.py:267-380).

    ``model_fn(x, t, ctx)`` is the family's forward on a CFG-doubled batch
    (``model_fn(x, t, ctx, cache_state) -> (out, cache_state)`` with a
    cache); latents ``(B, H, W, C)`` are whole on the caller's device and
    each shard steps its rows.  ``ctx_cls`` picks the seam:
    ``ShardContext`` (UNet) or ``MMDiTShardContext`` (SD3)."""

    def __init__(self, model_fn: Callable, group, sampler,
                 warmup_steps: int = 4, axis: str = "sp", ctx_cls=None):
        self.model_fn = model_fn
        self.group = group
        self.sampler = sampler
        self.warmup_steps = warmup_steps
        self.axis = axis
        self.n = group.axis_size(axis)
        self.ctx_cls = ctx_cls or ShardContext

    def denoise(self, latents, table, guidance: float, cache_state=None):
        """A whole trajectory of one batch ``(B, H, W, C)``.  ``cache_state``:
        a token cache's rows (``(rows, S, ...)``, the GLOBAL token axis 1),
        split over ``sp`` so that each shard's fine gate ranks its own
        tokens; returns ``(latents, cache_state)`` then."""
        group = self.group
        b = latents.shape[0]
        dev = latents.device
        cached = cache_state is not None
        kv: Dict[int, Dict] = {}
        local_cache: Dict[int, dict] = {}
        for i in range(table.num_steps):
            stale = i >= self.warmup_steps and bool(kv)
            t = torch.full((b,), table.current_timestep(),
                           dtype=torch.float32)
            c0 = float(table.coeffs[table.step, 0])
            c1 = float(table.coeffs[table.step, 1])

            def local_step(rank, stale=stale, t=t, c0=c0, c1=c1):
                sdev = group.device(rank)
                x = shard_rows(latents, group, self.axis, 1, rank)
                ctx = self.ctx_cls(group, self.axis, stale=stale,
                                   kv_state=kv.get(rank))
                cc0 = torch.full((b,), c0, dtype=torch.float32, device=sdev)
                cc1 = torch.full((b,), c1, dtype=torch.float32, device=sdev)
                x_in = self.sampler.scale_model_input(
                    torch.cat([x, x]), torch.cat([cc0, cc0]))
                t2 = torch.cat([t, t]).to(sdev)
                new_cache = None
                if cached:
                    st = local_cache.get(rank)
                    if st is None:
                        st = _split_tokens(cache_state, group, self.axis,
                                           rank)
                    out, new_cache = self.model_fn(x_in, t2, ctx, st)
                else:
                    out = self.model_fn(x_in, t2, ctx)
                uncond, text = out.chunk(2, dim=0)
                eps = uncond + guidance * (text - uncond)
                return (self.sampler.step(x, eps, cc0, cc1),
                        ctx.new_kv_state, new_cache)

            outs = group.run(local_step)
            latents = gather_rows([o[0] for o in outs], group, 1, dev)
            kv = {r: o[1] for r, o in enumerate(outs)}
            if cached:
                local_cache = {r: o[2] for r, o in enumerate(outs)}
            table.advance()
        if not cached:
            return latents
        return latents, _gather_tokens(local_cache, group, dev)


def _split_tokens(tree, group, axis: str, rank: int):
    """A token cache's rows, this shard's tokens (axis 1 of every tensor
    with one)."""
    if isinstance(tree, dict):
        return {k: _split_tokens(v, group, axis, rank)
                for k, v in tree.items()}
    if tree.dim() < 2:
        return tree.to(group.device(rank), copy=True)
    return shard_rows(tree, group, axis, 1, rank).clone()


def _gather_tokens(per_rank: dict, group, device):
    """Inverse of :func:`_split_tokens` over the lead shards."""
    lead = group.lead_ranks()

    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        if trees[0].dim() < 2:
            return trees[0].to(device)
        return torch.cat([t.to(device) for t in trees], dim=1)

    return walk([per_rank[r] for r in lead])
