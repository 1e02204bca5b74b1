"""UNet2DConditionModel (counterpart of sduss_tpu/models/unet.py).

The port carries the JAX ``apply``'s dense path (``ctx=None``) and its
mixed-resolution patch path (``ctx`` a ``PatchContext``, ops/patch_ctx.py),
for linear transformer projections (SDXL) and 1x1-conv ones (SD-1.5).  Both
take the deep cache's modes (``deep_mode`` full / shallow at
``deep_boundary``; partial on the dense path) and, with them, the deep x
compact hybrid's gating (``cache`` a ``cache.manager.BlockCache``): CFG
pairs of rows on the dense path, whole images per resolution class on the
patch path.  Without a deep mode a ``cache`` gates every pair of
``cache_layout`` by its ``CacheConfig.mode``: "block" recomputes every
row and splices cached outputs where the drift is small, "compact"
recomputes the most-drifted image rows (dense) or whole images per
resolution class, and with ``patch_fraction < 1`` only their most-drifted
patch rows' transformer tail (patch path).  With a ``ctx`` every 3x3
convolution, group norm, self/cross-attention and upsample goes through the
context, as the JAX ``_gn`` / ``_gn_silu_conv`` / ``_conv`` /
``_self_attention`` / ``_cross_attention`` / ``_upsample_2x`` seam does.
Module names follow diffusers', so ``state_dict()`` keys are the
diffusers keys and ``models/convert.py`` maps them to and from the JAX
parameter tree.  The public forward takes and returns NHWC latents; inside,
activations are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sduss_tpu_torch.models import layers as L
from sduss_tpu_torch.ops.attention import masked_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # True at index i => down block i has cross-attention transformers.
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    # Transformer depth per level (SDXL: (1, 2, 10) on its 3 levels).
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    # SDXL text_time conditioning: (addition_time_embed_dim, pooled_dim, num_time_ids)
    addition_embed: Optional[Tuple[int, int, int]] = None
    use_linear_projection: bool = False
    sample_size: int = 64

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_UNET = UNetConfig()
SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_has_attn=(False, True, True),
    transformer_layers=(0, 2, 10),
    num_heads=(5, 10, 20),
    cross_attention_dim=2048,
    addition_embed=(256, 1280, 6),
    use_linear_projection=True,
    sample_size=128,
)
TINY_UNET = UNetConfig(
    block_out_channels=(32, 64),
    down_block_has_attn=(True, False),
    layers_per_block=1,
    transformer_layers=(1, 0),
    num_heads=(2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
    sample_size=16,
)
TINY_SDXL_UNET = UNetConfig(
    block_out_channels=(32, 64),
    down_block_has_attn=(False, True),
    layers_per_block=1,
    transformer_layers=(0, 1),
    num_heads=(2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
    addition_embed=(32, 48, 6),
    use_linear_projection=True,
    sample_size=16,
)

# 3-level tiny proxy with SDXL's level structure (no attention at level 0)
# and 4-level tiny proxy with SD-1.5's (cross-attention at levels 0-2, none
# at the deepest; conv projections): the deep-cache tests need three and
# four levels to hold boundaries 1 and 2 (JAX unet.py TINY3_SDXL_UNET,
# TINY4_SD15_UNET).
TINY3_SDXL_UNET = UNetConfig(
    block_out_channels=(32, 64, 128),
    down_block_has_attn=(False, True, True),
    layers_per_block=1,
    transformer_layers=(0, 1, 2),
    num_heads=(2, 2, 4),
    cross_attention_dim=32,
    norm_num_groups=8,
    addition_embed=(32, 48, 6),
    use_linear_projection=True,
    sample_size=16,
)
TINY4_SD15_UNET = UNetConfig(
    block_out_channels=(16, 24, 32, 32),
    down_block_has_attn=(True, True, True, False),
    layers_per_block=1,
    transformer_layers=(1, 1, 1, 0),
    num_heads=(2, 2, 2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
    addition_embed=(32, 48, 6),
    use_linear_projection=False,
    sample_size=32,
)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(_silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = L.GroupNorm(groups, in_ch, 1e-5)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = L.GroupNorm(groups, out_ch, 1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, temb, ctx=None):
        t = self.time_emb_proj(_silu(temb))
        if ctx is None:
            # the time-embedding add runs inside norm2 (K6 on the card)
            h = self.conv1(self.norm1(x, act="silu"))
            h = self.conv2(self.norm2(h, act="silu", add=t))
        else:
            h = ctx.gn_silu_conv(self.norm1, self.conv1, x)
            h = h + t[:, :, None, None].to(h.dtype)
            h = ctx.gn_silu_conv(self.norm2, self.conv2, h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """``to_q/to_k/to_v`` (no bias) + ``to_out.0``; diffusers' Attention."""

    def __init__(self, query_dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim),
                                     nn.Identity()])

    def forward(self, h, context=None, ctx=None, rows=None):
        """``rows`` (patch batch only): ``h`` holds just these patch rows,
        whose images' text K/V the cross-attention takes."""
        if ctx is not None:  # patch batch: grouped self / gathered cross
            out = (ctx.self_attention(self, h) if context is None
                   else ctx.cross_attention(self, h, context, rows=rows))
            return self.to_out[0](out)
        kv = h if context is None else context
        # self-attention routes to kernel K1, 77-token cross-attention to K5
        out = masked_attention(self.to_q(h), self.to_k(kv), self.to_v(kv),
                               self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        return L.geglu(x, self.proj.weight, self.proj.bias)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = L.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = L.LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads)
        self.norm3 = L.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, h, ehs, ctx=None, tok_sel=None):
        """h: (N, S, C) tokens; ehs: (N, 77, context_dim) text context (per
        image, ``(I_pad, 77, D)``, with a patch ``ctx``).

        ``tok_sel`` (patch path, two-level compact rows): self-attention
        over every row, then cross-attention and the feed-forward on the
        selected rows only, written back so that the next block's
        self-attention sees them; the other rows serve only as keys."""
        h = h + self.attn1(self.norm1(h), ctx=ctx)
        if tok_sel is None:
            h = h + self.attn2(self.norm2(h), ehs, ctx=ctx)
            return h + self.ff(self.norm3(h))
        # the context's share of the selected rows (all of them on one
        # device; on a shard of an sp group its part of the selection)
        hs, rows = ctx.take_rows(h, tok_sel)
        hs = hs + self.attn2(self.norm2(hs), ehs, ctx=ctx, rows=rows)
        hs = hs + self.ff(self.norm3(hs))
        return ctx.put_rows(h, tok_sel, hs)


class Transformer2DModel(nn.Module):
    """Spatial transformer, with linear projections (SDXL) or 1x1-conv ones
    (SD-1.5, diffusers' ``(C, C, 1, 1)`` weights).  A 1x1 conv is a linear
    map over the channels, so both kinds run as one on the tokens (the JAX
    ``_transformer_apply`` convolves the map before flattening it: the same
    function), dense and patched alike."""

    def __init__(self, channels: int, context_dim: int, heads: int,
                 depth: int, groups: int, use_linear: bool = True):
        super().__init__()
        self.norm = L.GroupNorm(groups, channels, 1e-6)

        def proj():
            return (nn.Linear(channels, channels) if use_linear
                    else nn.Conv2d(channels, channels, 1))

        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads)
             for _ in range(depth)])
        self.proj_out = proj()

    @staticmethod
    def _project(layer, h):
        return F.linear(h, layer.weight.reshape(layer.weight.shape[0], -1),
                        layer.bias)

    def forward(self, x, ehs, ctx=None, tok_sel=None):
        """``tok_sel``: the blocks' two-level rows (see
        ``BasicTransformerBlock``); the output holds only those rows."""
        n, c, hh, ww = x.shape
        h = self.norm(x) if ctx is None else ctx.group_norm(self.norm, x)
        h = self._project(self.proj_in, h.permute(0, 2, 3, 1).reshape(
            n, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, ehs, ctx=ctx, tok_sel=tok_sel)
        if tok_sel is not None:
            h, x = ctx.select_rows(h, tok_sel), ctx.select_rows(x, tok_sel)
            n = h.shape[0]
        h = self._project(self.proj_out, h)
        return h.reshape(n, hh, ww, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x, ctx=None):
        return self.conv(x) if ctx is None else ctx.conv(self.conv, x, stride=2)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, ctx=None):
        if ctx is None:
            return self.conv(L.nearest_upsample_2x(x))
        return ctx.conv(self.conv, ctx.upsample_2x(x))


class UNetBlock(nn.Module):
    """One down/up level: resnets, optional transformers, optional resampler."""

    def __init__(self, resnets, attentions, down: Optional[nn.Module] = None,
                 up: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        bo = cfg.block_out_channels
        n_levels = len(bo)
        temb = cfg.time_embed_dim
        g = cfg.norm_num_groups

        def transformer(ch, lvl, depth):
            return Transformer2DModel(ch, cfg.cross_attention_dim,
                                      cfg.num_heads[lvl], depth, g,
                                      cfg.use_linear_projection)

        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(bo[0], temb)
        if cfg.addition_embed is not None:
            add_dim, pooled_dim, num_ids = cfg.addition_embed
            self.add_embedding = TimestepEmbedding(
                pooled_dim + add_dim * num_ids, temb)

        down = []
        out_ch = bo[0]
        for i in range(n_levels):
            in_ch, out_ch = out_ch, bo[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(in_ch if j == 0 else out_ch,
                                             out_ch, temb, g))
                if cfg.down_block_has_attn[i]:
                    attns.append(transformer(out_ch, i,
                                             cfg.transformer_layers[i]))
            down.append(UNetBlock(
                resnets, attns,
                down=Downsample2D(out_ch) if i < n_levels - 1 else None))
        self.down_blocks = nn.ModuleList(down)

        mid = bo[-1]
        self.mid_block = UNetBlock(
            [ResnetBlock2D(mid, mid, temb, g), ResnetBlock2D(mid, mid, temb, g)],
            [transformer(mid, n_levels - 1,
                         max(cfg.transformer_layers[-1], 1))])

        up = []
        rev = list(reversed(bo))
        for i in range(n_levels):
            lvl = n_levels - 1 - i
            prev_out = mid if i == 0 else rev[i - 1]
            out_ch = rev[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                res_in = prev_out if j == 0 else out_ch
                # skips pop in reverse: the last one comes from a level up
                skip_ch = bo[max(lvl - 1, 0)] \
                    if j == cfg.layers_per_block else bo[lvl]
                resnets.append(ResnetBlock2D(res_in + skip_ch, out_ch, temb, g))
                if cfg.down_block_has_attn[lvl]:
                    attns.append(transformer(out_ch, lvl,
                                             cfg.transformer_layers[lvl]))
            up.append(UNetBlock(
                resnets, attns,
                up=Upsample2D(out_ch) if i < n_levels - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = L.GroupNorm(g, bo[0], 1e-5)
        self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)

    def time_embed(self, timesteps, added_cond=None, dtype=torch.float32):
        """(B,) timesteps (+ SDXL added conditioning) -> (B, time_embed_dim)."""
        cfg = self.cfg
        te = L.timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(te.to(dtype))
        if cfg.addition_embed is not None:
            add_dim = cfg.addition_embed[0]
            time_ids = added_cond["time_ids"]  # (B, num_ids)
            b = time_ids.shape[0]
            tid = L.timestep_embedding(time_ids.reshape(-1), add_dim)
            add_in = torch.cat([added_cond["text_embeds"].to(dtype),
                                tid.reshape(b, -1).to(dtype)], dim=-1)
            emb = emb + self.add_embedding(add_in)
        return emb


    # -- the caches' gated pairs ----------------------------------------------

    def cache_layout(self, cells: int, min_level: int = 1) -> dict:
        """Gated-pair layout of the block and compact caches: every resnet
        (+ transformer) pair and the mid block at levels >= ``min_level``,
        ``key -> (s, c_in, c_out)``, ``s`` the pair's side on a ``cells``
        wide latent or patch and ``c_in`` counting an up pair's skip
        concat."""
        cfg = self.cfg
        bo = cfg.block_out_channels
        n_levels = len(bo)
        layout = {}
        out_ch = bo[0]
        for i in range(n_levels):
            in_ch, out_ch = out_ch, bo[i]
            if i < min_level:
                continue
            for j in range(cfg.layers_per_block):
                layout[f"down{i}.{j}"] = (cells >> i, in_ch if j == 0
                                          else out_ch, out_ch)
        if n_levels - 1 >= min_level:
            layout["mid"] = (cells >> (n_levels - 1), bo[-1], bo[-1])
        rev = list(reversed(bo))
        for i in range(n_levels):
            lvl = n_levels - 1 - i
            if lvl < min_level:
                continue
            prev_out = bo[-1] if i == 0 else rev[i - 1]
            for j in range(cfg.layers_per_block + 1):
                res_in = prev_out if j == 0 else rev[i]
                skip_ch = bo[max(lvl - 1, 0)] \
                    if j == cfg.layers_per_block else bo[lvl]
                layout[f"up{i}.{j}"] = (cells >> lvl, res_in + skip_ch, rev[i])
        return layout

    def shallow_cache_layout(self, cells: int,
                             boundary: Optional[int] = None) -> dict:
        """Gated-pair layout of the deep x compact hybrid: the resnet (+
        transformer) pairs a shallow step runs (down levels < boundary, up
        blocks of level < boundary; no mid), ``key -> (s, c_in, c_out)``
        with ``c_in`` counting an up pair's skip concat."""
        cfg = self.cfg
        bo = cfg.block_out_channels
        n_levels = len(bo)
        if boundary is None:
            boundary = n_levels - 1
        layout = {}
        out_ch = bo[0]
        for i in range(min(boundary, n_levels)):
            in_ch, out_ch = out_ch, bo[i]
            for j in range(cfg.layers_per_block):
                layout[f"down{i}.{j}"] = (cells >> i, in_ch if j == 0
                                          else out_ch, out_ch)
        rev = list(reversed(bo))
        for i in range(n_levels - boundary, n_levels):
            lvl = n_levels - 1 - i
            prev_out = bo[-1] if i == 0 else rev[i - 1]
            for j in range(cfg.layers_per_block + 1):
                res_in = prev_out if j == 0 else rev[i]
                skip_ch = bo[max(lvl - 1, 0)] \
                    if j == cfg.layers_per_block else bo[lvl]
                layout[f"up{i}.{j}"] = (cells >> lvl, res_in + skip_ch, rev[i])
        return layout

    @staticmethod
    def _pair(blk, j):
        """Resnet ``j`` of a block and its transformer (if the level has
        one) as the ``(x, temb, ehs)`` body a gated pair computes; with
        ``tok_sel`` it returns only those rows (a transformer runs its
        tail on them alone)."""
        res = blk.resnets[j]
        attn = blk.attentions[j] if len(blk.attentions) else None

        def body(x, temb, ehs, ctx=None, tok_sel=None):
            y = res(x, temb, ctx=ctx)
            if attn is not None:
                return attn(y, ehs, ctx=ctx, tok_sel=tok_sel)
            return y if tok_sel is None else ctx.select_rows(y, tok_sel)
        return body

    def _mid(self, h, temb, ehs, ctx=None, tok_sel=None):
        """The mid block; with ``tok_sel`` computed in full (its last conv
        needs every patch's halo) and those rows returned."""
        mid = self.mid_block
        h = mid.resnets[0](h, temb, ctx=ctx)
        h = mid.attentions[0](h, ehs, ctx=ctx)
        h = mid.resnets[1](h, temb, ctx=ctx)
        return h if tok_sel is None else ctx.select_rows(h, tok_sel)

    def _deep_tail(self, h, temb, ehs, boundary: int, ctx=None):
        """The ops a full pass runs between the partial capture point (the
        input of the level-(boundary-1) downsample) and the deep-feature
        capture (the output of up block ``n_levels - boundary - 1``, after
        its upsample): down levels >= boundary, mid and the deep up blocks,
        dense and ungated.  Rows are independent on the dense path, so on
        a gathered row subset each row equals the full pass's.  ``ctx``: a
        row-sharded context (``parallel/displaced.py ShardContext``), or
        None."""
        n_levels = len(self.cfg.block_out_channels)
        h = self.down_blocks[boundary - 1].downsamplers[0](h, ctx=ctx)
        dskips = [h]
        for blk in self.down_blocks[boundary:]:
            for j in range(len(blk.resnets)):
                h = self._pair(blk, j)(h, temb, ehs, ctx)
                dskips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, ctx=ctx)
                dskips.append(h)
        h = self._mid(h, temb, ehs, ctx=ctx)
        for blk in self.up_blocks[:n_levels - boundary]:
            for j in range(len(blk.resnets)):
                h = self._pair(blk, j)(torch.cat([h, dskips.pop()], dim=1),
                                       temb, ehs, ctx)
            h = blk.upsamplers[0](h, ctx=ctx)
        assert not dskips
        return h

    def forward(self, sample, timesteps, encoder_hidden_states,
                added_cond=None, ctx=None, cache=None, cache_state=None,
                deep_mode: Optional[str] = None, deep_state=None,
                deep_boundary: Optional[int] = None, row_valid=None,
                deep_sel=None, compact_sync: bool = False):
        """sample: (B, H, W, C) NHWC; timesteps: (B,); ehs: (B, 77, D).

        With a patch ``ctx``: sample is the ``(P, s, s, C)`` patch batch and
        timesteps / ehs / added_cond are per image (``I_pad`` rows), spread
        to the patches through the context.  Returns the model output in
        the sample's layout, like the JAX apply.

        ``deep_mode``, the deep cache's temporal reuse of the levels >=
        ``deep_boundary`` (default: the deepest level + mid), on dense and
        patch batches (``partial`` dense only):

        - ``"full"``: compute everything and also return the deep feature,
          ``h`` entering up block ``n_levels - boundary`` (after the
          previous block's upsample conv), NCHW;
        - ``"shallow"``: skip the down levels >= boundary, the
          level-(boundary-1) downsample, mid and the deep up blocks, and
          resume from ``deep_state``;
        - ``"partial"``: the shallow spine for every row plus the deep tail
          for the request rows ``deep_sel`` (int64, both CFG halves: rows
          ``i`` and ``i + B/2``), whose fresh features are written into
          ``deep_state`` in place.

        With a mode it returns ``(out, deep_feature)``; with the hybrid's
        ``cache`` and ``cache_state`` as well (``cache.config.
        deep_compact_fraction`` set) ``(out, deep_feature, cache_state)``:
        full steps write every gated pair's rows through.  Dense shallow
        and partial steps gate the pairs by CFG pairs (``row_valid`` marks
        real rows); patched shallow steps gate whole images per resolution
        class (``gate_compact_images`` with symmetrised CFG-pair scores and
        even capacities), each pair running on the sub-composition's
        context.

        Without a mode, ``cache`` and ``cache_state`` (rows of
        ``cache_layout``) gate each pair by ``cache.config.mode`` and it
        returns ``(out, cache_state)``:

        - ``"block"``: ``cache.gate`` computes every row and keeps the
          cached output where the drift score says reuse (the pipeline
          passes a cache in this mode only on the patch path);
        - ``"compact"``, dense: ``gate_compact`` recomputes the
          ``max(1, round(B * compact_fraction))`` most-drifted rows
          (``row_valid`` marks real rows), every row under
          ``compact_sync``, the anchoring step of fresh rows;
        - ``"compact"``, patched: ``gate_compact_images`` recomputes whole
          images in the non-even sub-composition of ``compact_fraction``
          and, at ``patch_fraction < 1``, runs the transformer tail of
          only the most-drifted patch rows there (``tok_sel``).

        A pair whose key is not in ``cache_state`` (a level below
        ``min_level``) is computed plainly.  The gates update each pair's
        state dict in place, where the JAX apply returns a new state: the
        old and the new rows are never held together.
        """
        hybrid = (deep_mode is not None and cache is not None
                  and cache.config.deep_compact_fraction is not None)
        # a patch batch's context (one device's or a shard's), or None /
        # a row-sharded context on the dense path
        patched = ctx is not None and hasattr(ctx, "meta")
        if deep_mode == "partial":
            if patched or (cache is not None and not hybrid):
                raise ValueError("deep_mode='partial' is dense-path only; "
                                 "the only composing cache is the deep x "
                                 "compact hybrid")
            if deep_sel is None or deep_state is None:
                raise ValueError("deep_mode='partial' needs deep_sel + "
                                 "deep_state")
        if deep_mode is not None and cache is not None and not hybrid:
            raise ValueError("deep_mode and cache are mutually exclusive "
                             "(set CacheConfig.deep_compact_fraction for "
                             "the hybrid, which returns all three)")
        n_levels = len(self.cfg.block_out_channels)
        boundary = deep_boundary if deep_boundary is not None else n_levels - 1
        temb = temb_img = self.time_embed(timesteps, added_cond,
                                          dtype=sample.dtype)
        t_norm = timesteps.float() / 1000.0
        if ctx is not None:
            temb = ctx.broadcast_to_patches(temb)
            t_norm = ctx.per_patch(t_norm)
        # the gates' row reductions over the shards of a row-sharded batch
        reducer = getattr(ctx, "row_reducer", None)
        ehs = encoder_hidden_states
        caching = cache is not None and cache_state is not None
        cc = cache.config if caching else None
        # the row regime of a gated pair: "write" (the hybrid's full step),
        # "rows" (dense top-K rows), "images" (patched whole images) or
        # "block" (every row, spliced)
        if not caching:
            regime = None
        elif hybrid:
            regime = ("write" if deep_mode == "full"
                      else "images" if patched else "rows")
        elif cc.mode == "compact":
            regime = "images" if patched else "rows"
        else:
            regime = "block"
        if regime == "rows":
            frac = cc.deep_compact_fraction if hybrid else cc.compact_fraction
            n_active = max(1, round(sample.shape[0] * frac))
            if compact_sync and not hybrid:
                n_active = sample.shape[0]  # anchor every fresh row
        two_level = False
        if regime == "images":
            # the gated images' canonical sub-composition: pair-coherent
            # (even) capacities on the CFG-doubled meta under the hybrid
            sub_ctx, caps = ctx.compact_context(
                cc.deep_compact_fraction if hybrid else cc.compact_fraction,
                hybrid)
            # per-patch rows of the sub-batch by their global patch index
            patch_image = ctx.gate_view().image_id
            two_level = not hybrid and cc.patch_fraction < 1.0

        def gated(key, x, body):
            st = cache_state.get(key) if caching else None
            if st is None:  # cache off, or a pair outside the layout
                return body(x, temb, ehs, ctx)
            if regime == "write":  # full step: recompute, re-anchor the rows
                y = body(x, temb, ehs, ctx)
                cache.write_through(st, x, y)
                return y
            if regime == "block":
                y, _, _ = cache.gate(key, x, t_norm, st,
                                     lambda xx: body(xx, temb, ehs, ctx),
                                     reducer=reducer)
                return y
            if regime == "images":
                if two_level:
                    def fn(x_s, gidx, imgs, sel):
                        return body(x_s, temb_img[patch_image[gidx]],
                                    ehs[imgs], sub_ctx, tok_sel=sel)
                else:
                    def fn(x_s, gidx, imgs):
                        return body(x_s, temb_img[patch_image[gidx]],
                                    ehs[imgs], sub_ctx)
                y, _, _ = cache.gate_compact_images(
                    key, x, t_norm, st, fn, ctx, caps,
                    cfg_pair_offset=ctx.meta.i_pad // 2 if hybrid else None,
                    two_level=two_level, sub_range=sub_ctx.local_range)
                return y

            def fn(x_c, idx):
                return body(x_c, temb[idx], ehs[idx], ctx)

            if hybrid and cc.deep_compact_pairwise:
                y, _, _ = cache.gate_compact_pairs(
                    key, x, t_norm, st, fn,
                    cache.pair_cap(x.shape[0] // 2, frac), row_valid=row_valid,
                    reducer=reducer)
            else:
                y, _, _ = cache.gate_compact(key, x, t_norm, st, fn, n_active,
                                             row_valid=row_valid,
                                             reducer=reducer)
            return y

        shallow = deep_mode in ("shallow", "partial")
        x = sample.permute(0, 3, 1, 2).contiguous()
        h = self.conv_in(x) if ctx is None else ctx.conv(self.conv_in, x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            if shallow and i >= boundary:
                break
            for j in range(len(blk.resnets)):
                h = gated(f"down{i}.{j}", h, self._pair(blk, j))
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                if shallow and i == boundary - 1:
                    break  # this downsample feeds only the deep tail
                h = blk.downsamplers[0](h, ctx=ctx)
                skips.append(h)

        deep_feature = None
        if deep_mode == "partial":
            half = h.shape[0] // 2
            sel2 = torch.cat([deep_sel, deep_sel + half])
            tail = self._deep_tail(h[sel2], temb[sel2], ehs[sel2], boundary,
                                   ctx)
            # the pipeline pads deep_sel with copies of a selected row; the
            # copies carry equal values, so the order of their writes does
            # not matter
            deep_state.index_copy_(0, sel2, tail.to(deep_state.dtype))
            deep_feature = deep_state
            h = deep_state.to(h.dtype)
        elif shallow:
            h = deep_state.to(h.dtype)
            deep_feature = deep_state
        else:
            h = gated("mid", h, self._mid)

        first_shallow_up = n_levels - boundary
        for i, blk in enumerate(self.up_blocks):
            if shallow and i < first_shallow_up:
                continue
            if deep_mode == "full" and i == first_shallow_up:
                deep_feature = h
            for j in range(len(blk.resnets)):
                h = gated(f"up{i}.{j}", torch.cat([h, skips.pop()], dim=1),
                          self._pair(blk, j))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, ctx=ctx)
        if ctx is None:
            h = self.conv_out(self.conv_norm_out(h, act="silu"))
        else:
            h = ctx.gn_silu_conv(self.conv_norm_out, self.conv_out, h)
        out = h.permute(0, 2, 3, 1).contiguous()
        if deep_mode is None:
            return (out, cache_state) if caching else out
        if caching:
            return out, deep_feature, cache_state
        return out, deep_feature
