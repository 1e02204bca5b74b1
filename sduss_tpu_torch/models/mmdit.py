"""SD3 MMDiT, ``SD3Transformer2DModel`` (counterpart of
sduss_tpu/models/mmdit.py), for SD-3.5-medium.

Joint latent + text attention blocks with AdaLayerNorm-Zero modulation, a
2x2 patch embedding with a center-cropped 2D sin-cos position grid,
per-head qk RMS norm and dual self-attention in the first 13 layers.  Two
forwards, as in the JAX model: ``forward`` (dense, one resolution per
call) and ``apply_tokens`` (the mixed-resolution path: per-request latent
tokens right-padded to a shared length and masked in attention through
``MMDiTMaskCtx``), both through one trunk that also runs the JAX model's
caches: the span-skip deep cache (``deep_mode``/``deep_span``/
``deep_state``) and the per-block token caches of ``cache/manager.py``
(mode "block", request-granular "compact" and the per-token fine gate
with its stale K/V rows).

Every attention goes through ``ops.attention.masked_attention``: at
SD-3.5-medium's width (D = 1536) the unmasked joint and dual attention of
768^2 and 1024^2 images reach ``flash_mha`` (K2a/K3b), those of 512^2 K1,
and the token path's masked attention the masked kernel.  Module names
follow diffusers', so ``state_dict()`` keys are the checkpoint's and
``models/convert.py`` maps them to and from the JAX parameter tree.
Latents are NHWC at the public seams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sduss_tpu_torch.cache.manager import WHOLE_TOKENS, token_split
from sduss_tpu_torch.models import layers as L
from sduss_tpu_torch.ops.attention import masked_attention


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096  # T5 feature width
    pooled_projection_dim: int = 2048  # CLIP-L + CLIP-G pooled concat
    pos_embed_max_size: int = 384
    qk_norm: bool = True
    dual_attention_layers: Tuple[int, ...] = tuple(range(13))
    sample_size: int = 128
    pos_embed_base_size: int = 64

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim


SD35_MEDIUM = MMDiTConfig()
TINY_MMDIT = MMDiTConfig(
    in_channels=4, out_channels=4, num_layers=2, num_heads=2, head_dim=16,
    joint_attention_dim=32, pooled_projection_dim=32, pos_embed_max_size=32,
    dual_attention_layers=(0,), sample_size=8, pos_embed_base_size=8,
)


def sincos_2d_pos_embed(dim: int, grid_size: int, base_size: int) -> np.ndarray:
    """2D sin-cos position embedding, (grid_size*grid_size, dim), float32.

    The JAX package's function (mmdit.py:56-73): diffusers'
    get_2d_sincos_pos_embed with interpolation_scale=1, grid coordinates
    scaled by base_size/grid_size, computed in float64.
    """
    pos = np.arange(grid_size, dtype=np.float64) / (grid_size / base_size)
    grid = np.meshgrid(pos, pos)  # [x(w), y(h)] each (H, W)

    def _1d(d, p):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", p.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = _1d(dim // 2, grid[1])
    emb_w = _1d(dim // 2, grid[0])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _silu_f32(x):
    return F.silu(x.float()).to(x.dtype)


def _layer_norm(x, eps: float = 1e-6):
    """LayerNorm without affine, in float32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _modulate(xn, shift, scale):
    return xn * (1 + scale[:, None]) + shift[:, None]


class RMSNorm(nn.Module):
    """Per-head qk RMS norm (eps 1e-6); state-dict key ``weight``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return L.rms_norm(x, self.weight, 1e-6)


class AdaLayerNormProj(nn.Module):
    """``norm1``/``norm1_context``/``norm_out``: only the modulation
    projection has weights (diffusers' ``.linear``)."""

    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = nn.Linear(dim, out)


class JointAttention(nn.Module):
    def __init__(self, cfg: MMDiTConfig, joint: bool, last_block: bool = False):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.to_q = nn.Linear(d, d)
        self.to_k = nn.Linear(d, d)
        self.to_v = nn.Linear(d, d)
        self.to_out = nn.ModuleList([nn.Linear(d, d), nn.Identity()])
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.head_dim)
            self.norm_k = RMSNorm(cfg.head_dim)
        if joint:
            self.add_q_proj = nn.Linear(d, d)
            self.add_k_proj = nn.Linear(d, d)
            self.add_v_proj = nn.Linear(d, d)
            if cfg.qk_norm:
                self.norm_added_q = RMSNorm(cfg.head_dim)
                self.norm_added_k = RMSNorm(cfg.head_dim)
            if not last_block:
                self.to_add_out = nn.Linear(d, d)

    def _heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.cfg.num_heads, self.cfg.head_dim)

    def q(self, x, prefix: str = ""):
        """Projected, per-head qk-normed ``(B, S, H, hd)`` queries."""
        q = self._heads((self.add_q_proj if prefix else self.to_q)(x))
        return getattr(self, f"norm_{prefix}q")(q) if self.cfg.qk_norm else q

    def kv(self, x, prefix: str = ""):
        """Projected ``(B, S, H, hd)`` keys (qk-normed) and values."""
        pk, pv = ((self.add_k_proj, self.add_v_proj) if prefix
                  else (self.to_k, self.to_v))
        k = self._heads(pk(x))
        if self.cfg.qk_norm:
            k = getattr(self, f"norm_{prefix}k")(k)
        return k, self._heads(pv(x))

    def qkv(self, x, prefix: str = ""):
        return (self.q(x, prefix),) + self.kv(x, prefix)


class GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return L.gelu_tanh(self.proj(x))


class FeedForward(nn.Module):
    """tanh-GELU MLP; diffusers' ``ff.net.0.proj`` / ``ff.net.2`` names."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class JointTransformerBlock(nn.Module):
    # the suffix of the state keys this block writes its stale K/V rows to:
    # a tensor-parallel shard other than the first holds its own heads'
    # rows under ``k@j``/``v@j`` (parallel/sharding.py)
    kv_suffix = ""

    def __init__(self, cfg: MMDiTConfig, last: bool, dual: bool):
        super().__init__()
        d = cfg.dim
        self.cfg, self.last, self.dual = cfg, last, dual
        self.norm1 = AdaLayerNormProj(d, (9 if dual else 6) * d)
        self.norm1_context = AdaLayerNormProj(d, 2 * d if last else 6 * d)
        self.attn = JointAttention(cfg, joint=True, last_block=last)
        self.ff = FeedForward(d)
        if not last:
            self.ff_context = FeedForward(d)
        if dual:
            self.attn2 = JointAttention(cfg, joint=False)

    def forward(self, x, c, temb, ctx=None, tok_sel=None, kv_state=None,
                kv_stale: bool = False, kv_out=None):
        """One joint block (mmdit.py:214-370): ``x`` (B, S, D) latent
        tokens, ``c`` (B, Lc, D) context tokens.  Returns ``(x, c)``; the
        last block returns ``(x, None)``.

        ``tok_sel`` (B, k_t): the fine token gate's selection — attention
        queries and the FF run only on these latent tokens and their
        residual updates scatter back; K/V and the context stream stay
        full, so the attention context is exact.  ``kv_state``
        (``fine_stale_kv``): the merged-heads, post-qk-norm K/V rows
        (``k``, ``v``, ``k2``, ``v2``) of the previous step.  With
        ``kv_stale`` only the selected tokens run the norm, modulation
        and to_k/to_v, and their rows are written into ``kv_state``'s
        (in place when the dtypes agree) while the rest keep the previous
        step's; without it K/V are computed full.  Either way the rows
        used go into ``kv_out``.  Exact at a selection of every token.

        The selection runs through the context's token split
        (``cache/manager.py token_split``, the identity on one device): on
        a shard of the padded-token path ``tok_sel`` is global, the shard
        computes the queries, residual updates and FF of its share of it
        (``split.share``) from every shard's tokens (``split.tokens_all``),
        gathers every share's results and keeps the tokens of its range.
        Its K/V are computed over its own tokens and gathered in the
        attention, or (stale) every shard's previous rows with every
        share's fresh rows written in, of which its own go into
        ``kv_out``.  The context stream runs in full on every shard.
        """
        silu_t = _silu_f32(temb)
        mods = self.norm1.linear(silu_t).chunk(9 if self.dual else 6, dim=-1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:6]
        stale = kv_state is not None and tok_sel is not None and kv_stale
        split = WHOLE_TOKENS if tok_sel is None else token_split(ctx)
        # K/V that hold every shard's tokens skip the attention's gather
        kv_full = stale and split is not WHOLE_TOKENS
        lo, n_loc = split.token_offset(), x.shape[1]
        x_all = split.tokens_all(x)
        sel = None
        if tok_sel is not None:
            a, b = split.share(tok_sel.shape[1])
            sel = tok_sel[:, a:b]
        xs = _gather_tokens(x_all, sel)  # the tokens this block updates here
        xn_s = _layer_norm(xs)
        # without stale K/V, every token's normalised input for the K/V
        xn = None if stale else (xn_s if sel is None else _layer_norm(x))

        c_mod, cmods = self._context_in(c, silu_t)

        def latent_qkv(attn, shift, scale, names):
            xm_s = _modulate(xn_s, shift, scale)
            if stale:
                q, k_s, v_s = attn.qkv(xm_s)
                k, v = (attn._heads(_scatter_tokens(
                    split.tokens_all(kv_state[n]).to(x.dtype), tok_sel,
                    split.tokens_all(t)))
                    for n, t in zip(names, (k_s, v_s)))
                # this shard's rows (the whole, one device's)
                rows = (k[:, lo:lo + n_loc].contiguous(),
                        v[:, lo:lo + n_loc].contiguous())
            else:
                q = attn.q(xm_s)
                k, v = attn.kv(xm_s if sel is None
                               else _modulate(xn, shift, scale))
                rows = (k, v)
            if kv_state is not None and kv_out is not None:
                kv_out[names[0] + self.kv_suffix] = rows[0].flatten(2)
                kv_out[names[1] + self.kv_suffix] = rows[1].flatten(2)
            return q, k, v

        q, k, v = latent_qkv(self.attn, shift_msa, scale_msa, ("k", "v"))
        cq, ck, cv = self.attn.qkv(c_mod, "added_")
        s_q = q.shape[1]
        # joint sequence [latent ; context], split back at s_q
        attn_out = _attention(torch.cat([q, cq], dim=1),
                              torch.cat([k, ck], dim=1),
                              torch.cat([v, cv], dim=1), ctx, k.shape[1],
                              kv_full)
        x_attn, c_attn = attn_out[:, :s_q], attn_out[:, s_q:]
        xs = xs + gate_msa[:, None] * self.attn.to_out[0](x_attn)

        if self.dual:
            shift2, scale2, gate2 = mods[6:]
            q2, k2, v2 = latent_qkv(self.attn2, shift2, scale2, ("k2", "v2"))
            out2 = _attention(q2, k2, v2, ctx, k2.shape[1], kv_full)
            xs = xs + gate2[:, None] * self.attn2.to_out[0](out2)

        x_ff = _modulate(_layer_norm(xs), shift_mlp, scale_mlp)
        xs = xs + gate_mlp[:, None] * self.ff(x_ff)
        if sel is not None:
            # every share's tokens written into every shard's, this
            # shard's kept
            vals = split.tokens_all(xs).to(x.dtype)
            xs = x_all.scatter(1, tok_sel[..., None].expand_as(vals),
                               vals)[:, lo:lo + n_loc]
        return xs, self._context_out(c, c_attn, cmods)

    def _context_in(self, c, silu_t):
        """The context stream's modulated attention input, and its
        modulation chunks."""
        cmods = self.norm1_context.linear(silu_t)
        cn = _layer_norm(c)
        if self.last:
            # AdaLayerNormContinuous: [scale, shift] chunks
            c_scale, c_shift = cmods.chunk(2, dim=-1)
            return _modulate(cn, c_shift, c_scale), None
        cmods = cmods.chunk(6, dim=-1)
        return _modulate(cn, cmods[0], cmods[1]), cmods

    def _context_out(self, c, c_attn, cmods):
        """The context stream after the attention and its FF (None after
        the last block)."""
        if self.last:
            return None
        _, _, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = cmods
        c = c + c_gate_msa[:, None] * self.attn.to_add_out(c_attn)
        c_ff = _modulate(_layer_norm(c), c_shift_mlp, c_scale_mlp)
        return c + c_gate_mlp[:, None] * self.ff_context(c_ff)


def _gather_tokens(x, sel):
    """``x[b, sel[b]]`` for every row: ``(B, S, ...)`` -> ``(B, k, ...)``;
    ``sel`` None: ``x``."""
    if sel is None:
        return x
    idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(sel.shape + x.shape[2:]))


def _scatter_tokens(rows, sel, vals):
    """``rows`` with ``rows[b, sel[b]] = vals[b]`` (written in place)."""
    vals = vals.reshape(rows.shape[0], sel.shape[1], -1).to(rows.dtype)
    return rows.scatter_(1, sel[..., None].expand_as(vals), vals)


def _attention(q, k, v, ctx=None, s_lat: int = None, kv_full=False):
    """``(B, S, H, hd)`` heads -> ``(B, S, D)``; through the context when
    one is given (masked tokens, or sharded latent rows), which gets
    ``s_lat``, the count of leading latent keys (mmdit.py:194-212), and
    ``kv_full`` when they hold every shard's."""
    if kv_full:
        return ctx.mmdit_attention(q, k, v, s_lat, kv_full=True)
    if ctx is not None:
        return ctx.mmdit_attention(q, k, v,
                                   k.shape[1] if s_lat is None else s_lat)
    b, s, nh, hd = q.shape
    q, k, v = (t.reshape(b, t.shape[1], nh * hd) for t in (q, k, v))
    return masked_attention(q, k, v, nh)


class TimestepEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(_silu_f32(self.linear_1(x)))


class CombinedTimestepTextProjEmbeddings(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.timestep_embedder = TimestepEmbedder(256, cfg.dim)
        self.text_embedder = TimestepEmbedder(cfg.pooled_projection_dim, cfg.dim)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.dim, cfg.patch_size,
                              stride=cfg.patch_size)


class SD3Transformer2DModel(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(cfg)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList(
            [JointTransformerBlock(cfg, i == cfg.num_layers - 1,
                                   i in cfg.dual_attention_layers)
             for i in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormProj(d, 2 * d)
        self.proj_out = nn.Linear(d, cfg.patch_size**2 * cfg.out_channels)
        self._pos_full = None   # host table, built at first use
        self._pos_dev: Dict[tuple, torch.Tensor] = {}

    # -- embedding front -----------------------------------------------------

    def pos_grid(self, h_patches: int, w_patches: int) -> np.ndarray:
        """Center-cropped position grid (h*w, dim), float32 numpy
        (mmdit.py:149-155)."""
        cfg = self.cfg
        m = cfg.pos_embed_max_size
        if self._pos_full is None:
            self._pos_full = sincos_2d_pos_embed(
                cfg.dim, m, cfg.pos_embed_base_size).reshape(m, m, cfg.dim)
        top, left = (m - h_patches) // 2, (m - w_patches) // 2
        crop = self._pos_full[top:top + h_patches, left:left + w_patches]
        return crop.reshape(h_patches * w_patches, cfg.dim)

    def _pos(self, hp: int, wp: int, device, dtype):
        key = (hp, wp, str(device), dtype)
        if key not in self._pos_dev:
            self._pos_dev[key] = torch.from_numpy(
                np.ascontiguousarray(self.pos_grid(hp, wp))).to(device, dtype)
        return self._pos_dev[key]

    def embed_latents(self, latents, ctx=None):
        """``(B, H, W, C)`` latents -> ``(B, h*w, dim)`` tokens with the
        position grid added.  A context that holds a row slice of the
        latent (``pos_embed_rows``) gives the rows of the global grid."""
        x = self.pos_embed.proj(latents.permute(0, 3, 1, 2))
        b, d, hp, wp = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, hp * wp, d)
        if ctx is not None and hasattr(ctx, "pos_embed_rows"):
            pe = ctx.pos_embed_rows(self, hp, wp).to(x.device, x.dtype)
        else:
            pe = self._pos(hp, wp, x.device, x.dtype)
        return x + pe[None]

    def time_text_embed_fn(self, timesteps, pooled, dtype):
        tte = self.time_text_embed
        te = L.timestep_embedding(timesteps, 256).to(dtype)
        return (tte.timestep_embedder(te)
                + tte.text_embedder(pooled.to(dtype)))

    # -- trunk and head ------------------------------------------------------

    def trunk(self, x, c, temb, ctx=None, cache=None, cache_state=None,
              t_norm=None, row_valid=None, fine_kv_stale: bool = False,
              compact_sync: bool = False, deep_mode=None, deep_span=None,
              deep_state=None):
        """Joint blocks + head over token sequences (mmdit.py:409-572).

        ``cache``/``cache_state``: the per-block token caches over the
        latent stream, by ``cache.config.mode``: "block" (``gate``: every
        row computed, cached outputs kept where the drift is small),
        "compact" (``gate_compact``: the ``compact_fraction`` most-drifted
        rows of the batch recomputed, both streams cached; every row with
        ``compact_sync``, the step that anchors a fresh state) and, with
        ``patch_fraction < 1``, the per-token gate (``gate_tokens_fine``,
        its stale K/V with ``fine_kv_stale``).  ``cache_state`` is updated
        in place; ``row_valid`` marks real rows, ``t_norm`` is t / 1000.

        ``deep_mode`` "full"/"shallow" with ``deep_span`` (lo, hi): the
        span-skip deep cache.  A full pass runs every block and emits the
        span's residual delta ``{"dx": x_hi - x_lo}`` (plus the context
        ``"c"`` at ``hi`` when the span is interior); a shallow pass skips
        blocks ``lo <= i < hi`` and splices ``deep_state`` in at ``hi``
        (before the head when ``hi`` is the last).  The head always
        modulates with the current ``temb``.  Gated blocks outside the
        span run as usual; skipped ones leave their cache rows untouched.

        Returns the output tokens, and with ``deep_mode`` ``(tokens,
        deep_out)``: the fresh delta of a full pass, ``deep_state`` of a
        shallow one.
        """
        cfg = self.cfg
        deep = deep_mode is not None
        if deep:
            lo, hi = deep_span
            if not (0 <= lo < hi <= cfg.num_layers):
                raise ValueError(f"deep_span {deep_span} out of range for "
                                 f"{cfg.num_layers} blocks")
            if deep_mode == "shallow" and deep_state is None:
                raise ValueError("shallow deep_mode needs deep_state")
            x_lo, deep_out = None, deep_state
        caching = cache is not None and cache_state is not None
        mode = cache.config.mode if caching else None
        fine = mode == "compact" and cache.config.patch_fraction < 1.0
        # the gates' row reductions over the shards of the token axis
        reducer = getattr(ctx, "row_reducer", None)
        if fine:
            # per-token gate: each token is one 2x2 latent patch, ranked
            # over every shard's tokens
            key_mask = getattr(ctx, "key_mask", None)
            s_all = x.shape[1] if key_mask is None else key_mask.shape[1]
            k_t = max(1, round(s_all * cache.config.patch_fraction))
            token_valid = getattr(ctx, "token_mask", None)
        elif mode == "compact":
            n_active = (x.shape[0] if compact_sync else
                        max(1, round(x.shape[0] * cache.config.compact_fraction)))
        for i, blk in enumerate(self.transformer_blocks):
            if deep:
                if deep_mode == "full" and i == lo:
                    x_lo = x
                if i == hi:
                    if deep_mode == "full":
                        # a compact gate's c is its state's row: copy it
                        deep_out = {"dx": x - x_lo}
                        if hi < cfg.num_layers:
                            deep_out["c"] = c.clone() if caching else c
                    else:
                        x = x + deep_state["dx"].to(x.dtype)
                        if "c" in deep_state:
                            c = deep_state["c"].to(c.dtype)
                if deep_mode == "shallow" and lo <= i < hi:
                    continue
            key = f"block{i}"
            st = cache_state.get(key) if caching else None
            if st is None:
                x, c2 = blk(x, c, temb, ctx=ctx)
            elif fine:
                kv = {n: st.get(n + blk.kv_suffix, st[n])
                      for n in ("k", "v", "k2", "v2") if n in st}

                def block_fn(sel, blk=blk, x=x, c=c, st=st, kv=kv):
                    return blk(x, c, temb, ctx=ctx, tok_sel=sel,
                               kv_state=kv or None, kv_stale=fine_kv_stale,
                               kv_out=st)

                (x, c2), _, _ = cache.gate_tokens_fine(
                    key, x, t_norm, st, block_fn, k_t, token_valid=token_valid,
                    split=token_split(ctx))
            elif mode == "compact":
                def block_fn(x_c, idx, blk=blk, c=c):
                    y, c2 = blk(x_c, c[idx], temb[idx],
                                ctx=None if ctx is None else ctx.gather(idx))
                    return {"x": y, "c": c[idx] if c2 is None else c2}

                out, _, _ = cache.gate_compact(key, x, t_norm, st, block_fn,
                                               n_active, row_valid=row_valid,
                                               reducer=reducer)
                x, c2 = out["x"], out["c"]
            else:
                c_holder = [c]

                def block_fn(x_in, blk=blk, c_holder=c_holder):
                    y, c2 = blk(x_in, c_holder[0], temb, ctx=ctx)
                    c_holder[0] = c_holder[0] if c2 is None else c2
                    return y

                x, _, _ = cache.gate(key, x, t_norm, st, block_fn,
                                     reducer=reducer)
                c2 = c_holder[0]
            c = c if c2 is None else c2

        if deep and hi == cfg.num_layers:
            if deep_mode == "full":
                deep_out = {"dx": x - x_lo}
            else:
                x = x + deep_state["dx"].to(x.dtype)
        out = self.head(x, temb)
        return (out, deep_out) if deep else out

    def prelude(self, latents, timesteps, encoder_hidden_states,
                pooled_projections, ctx=None):
        """The embedding front (mmdit.py:374-385): latents, time and text ->
        ``(x tokens, c context, temb)``.  A stage pipeline's first stage
        runs it; the dense forward too."""
        x = self.embed_latents(latents, ctx=ctx)
        temb = self.time_text_embed_fn(timesteps, pooled_projections,
                                       latents.dtype)
        c = self.context_embedder(encoder_hidden_states.to(latents.dtype))
        return x, c, temb

    def trunk_blocks(self, x, c, temb, ctx=None):
        """Every joint block this module holds, plain (mmdit.py:387-399).
        The JAX function takes the span's global start index, because its
        blocks' roles (dual attention, the context-dropping last block)
        come from the index; the port's blocks carry their roles, so a
        stage module holding a span runs it as it is."""
        for blk in self.transformer_blocks:
            x, c2 = blk(x, c, temb, ctx=ctx)
            c = c if c2 is None else c2
        return x, c

    def head(self, x, temb):
        """Final AdaLN modulation ([scale, shift]) + projection."""
        scale, shift = self.norm_out.linear(_silu_f32(temb)).chunk(2, dim=-1)
        return self.proj_out(_modulate(_layer_norm(x), shift, scale))

    def unpatchify(self, x, hp: int, wp: int):
        """``(B, hp*wp, ps*ps*C)`` -> ``(B, H, W, C)``."""
        cfg = self.cfg
        ps = cfg.patch_size
        b = x.shape[0]
        x = x[:, :hp * wp].reshape(b, hp, wp, ps, ps, cfg.out_channels)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * ps, wp * ps,
                                                   cfg.out_channels)

    def forward(self, latents, timesteps, encoder_hidden_states,
                pooled_projections, cache=None, cache_state=None,
                fine_kv_stale: bool = False, deep_mode=None, deep_span=None,
                deep_state=None, ctx=None):
        """Dense forward: ``(B, H, W, C)`` latents -> velocity ``(B, H, W, C)``.

        ``timesteps`` ``(B,)``; ``encoder_hidden_states`` ``(B, L,
        joint_attention_dim)`` CLIP+T5 features; ``pooled_projections``
        ``(B, pooled_projection_dim)``.  The cache and deep arguments are
        :meth:`trunk`'s (mmdit.py:583-618); with ``deep_mode`` returns
        ``(velocity, deep_out)``.  ``ctx``: a sharded context
        (``parallel/displaced.py MMDiTShardContext``) when the latents are
        this shard's rows.
        """
        ps = self.cfg.patch_size
        hp, wp = latents.shape[1] // ps, latents.shape[2] // ps
        x, c, temb = self.prelude(latents, timesteps, encoder_hidden_states,
                                  pooled_projections, ctx=ctx)
        out = self.trunk(x, c, temb, ctx=ctx, cache=cache,
                         cache_state=cache_state,
                         t_norm=timesteps.float() / 1000.0,
                         fine_kv_stale=fine_kv_stale, deep_mode=deep_mode,
                         deep_span=deep_span, deep_state=deep_state)
        if deep_mode is not None:
            return self.unpatchify(out[0], hp, wp), out[1]
        return self.unpatchify(out, hp, wp)

    def token_cache_layout(self, seq: int) -> Dict[str, tuple]:
        """Cache-row layout of the token path: block key -> (seq, dim)."""
        return {f"block{i}": (seq, self.cfg.dim)
                for i in range(self.cfg.num_layers)}

    def apply_tokens(self, tokens, token_mask, timesteps,
                     encoder_hidden_states, pooled_projections, cache=None,
                     cache_state=None, row_valid=None,
                     fine_kv_stale: bool = False, compact_sync: bool = False,
                     deep_mode=None, deep_span=None, deep_state=None,
                     ctx=None):
        """Mixed-resolution forward over padded token rows
        (mmdit.py:625-653).

        tokens: ``(B, S_pad, dim)`` embedded latent tokens, right-padded per
        request; token_mask: ``(B, S_pad)`` bool, True at real tokens.
        Returns ``(B, S_pad, ps*ps*C)``; rows past a request's tokens are
        garbage that the caller slices off.  The cache and deep arguments
        are :meth:`trunk`'s; with ``deep_mode`` returns ``(tokens,
        deep_out)``.  ``ctx``: a token-sharded context
        (``parallel/displaced.py MMDiTShardContext`` with the masks) when
        ``tokens`` are this shard's columns; else the mask's own.
        """
        temb = self.time_text_embed_fn(timesteps, pooled_projections,
                                       tokens.dtype)
        c = self.context_embedder(encoder_hidden_states.to(tokens.dtype))
        if ctx is None:
            ctx = MMDiTMaskCtx(token_mask, c.shape[1])
        return self.trunk(tokens, c, temb, ctx=ctx,
                          cache=cache, cache_state=cache_state,
                          t_norm=timesteps.float() / 1000.0,
                          row_valid=row_valid, fine_kv_stale=fine_kv_stale,
                          compact_sync=compact_sync, deep_mode=deep_mode,
                          deep_span=deep_span, deep_state=deep_state)


class MMDiTMaskCtx:
    """Masked attention for padded mixed-resolution token rows
    (mmdit.py:656-686).

    Joint attention (latent + text keys) masks the padded latent keys;
    dual self-attention (latent keys only) masks the same rows.  Padded
    query rows give garbage that never reaches a real token (they are
    masked as keys) and is sliced off before unpatchify.
    """

    def __init__(self, token_mask, ctx_len: int):
        self.token_mask = token_mask.bool().contiguous()
        self.ctx_len = ctx_len
        b = token_mask.shape[0]
        self.joint_mask = torch.cat(
            [self.token_mask, self.token_mask.new_ones((b, ctx_len))], dim=1)

    def gather(self, idx):
        """The context of the rows ``idx`` (a compact gate's sub-batch)."""
        return MMDiTMaskCtx(self.token_mask[idx], self.ctx_len)

    def mmdit_attention(self, q, k, v, s_lat: int):
        """``(B, S, H, hd)`` heads -> ``(B, S, D)``; the padded latent keys
        masked (the joint mask when the keys carry the context)."""
        b, s, nh, hd = q.shape
        s_lat = self.token_mask.shape[1]
        kv_mask = (self.joint_mask if k.shape[1] == s_lat + self.ctx_len
                   else self.token_mask)
        return masked_attention(q.reshape(b, s, nh * hd),
                                k.reshape(b, k.shape[1], nh * hd),
                                v.reshape(b, v.shape[1], nh * hd), nh,
                                kv_token_mask=kv_mask)
