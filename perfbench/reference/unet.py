"""Plain float32 UNet2DConditionModel of SD-1.5 and SDXL-base.

Written from the published architecture (diffusers ``UNet2DConditionModel``
with ``CrossAttnDownBlock2D``/``DownBlock2D`` levels, GEGLU feed-forwards,
and SDXL's ``text_time`` added embedding).  Parameter names are diffusers'
state-dict keys, so one set of tensors serves this module and the program.
No kernel, cache or batching: the forward is one image's CFG pair, dense.

The deep cache's decomposition is explicit: the *spine* (the levels below
``boundary``), the *tail* (the boundary level's downsample, the deeper
levels, the mid block and the deep up blocks, whose output is the deep
feature) and the *up* levels below ``boundary``.  A full forward runs all
three; a cached one replaces the tail by a stored feature.  Every resnet
(+ transformer) pair passes through ``hook(key, x, body)``, so a caller can
reuse a pair's stored output instead of computing it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import ops


def _p(*shape):
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Lin(nn.Module):
    def __init__(self, i, o, bias=True):
        super().__init__()
        self.weight = _p(o, i)
        self.bias = _p(o) if bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, i, o, k, stride=1):
        super().__init__()
        self.weight = _p(o, i, k, k)
        self.bias = _p(o)
        self.stride = stride

    def forward(self, x):
        return ops.conv(x, self.weight, self.bias, self.stride)


class Norm(nn.Module):
    """GroupNorm (``groups`` set) or LayerNorm over the last axis."""

    def __init__(self, c, eps, groups=None):
        super().__init__()
        self.weight, self.bias = _p(c), _p(c)
        self.eps, self.groups = eps, groups

    def forward(self, x):
        if self.groups:
            return ops.group_norm(x, self.weight, self.bias, self.groups,
                                  self.eps)
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class TimeMLP(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.linear_1, self.linear_2 = Lin(i, o), Lin(o, o)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, i, o, temb, g):
        super().__init__()
        self.norm1, self.conv1 = Norm(i, 1e-5, g), Conv(i, o, 3)
        self.time_emb_proj = Lin(temb, o)
        self.norm2, self.conv2 = Norm(o, 1e-5, g), Conv(o, o, 3)
        self.conv_shortcut = Conv(i, o, 1) if i != o else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attn(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(ctx_dim, dim, bias=False)
        self.to_v = Lin(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def forward(self, h, ctx=None):
        kv = h if ctx is None else ctx
        o = ops.attention(self.to_q(h), self.to_k(kv), self.to_v(kv),
                          self.heads)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Lin(dim, 2 * inner)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Lin(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Block(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.norm1, self.attn1 = Norm(dim, 1e-5), Attn(dim, dim, heads)
        self.norm2, self.attn2 = Norm(dim, 1e-5), Attn(dim, ctx_dim, heads)
        self.norm3, self.ff = Norm(dim, 1e-5), FeedForward(dim)

    def forward(self, h, ehs):
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h), ehs)
        return h + self.ff(self.norm3(h))


class Transformer(nn.Module):
    def __init__(self, c, ctx_dim, heads, depth, g, linear):
        super().__init__()
        self.norm = Norm(c, 1e-6, g)
        self.linear = linear
        self.proj_in = Lin(c, c) if linear else Conv(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            [Block(c, ctx_dim, heads) for _ in range(depth)])
        self.proj_out = Lin(c, c) if linear else Conv(c, c, 1)

    def _proj(self, layer, h):
        return ops.linear(h, layer.weight.reshape(layer.weight.shape[0], -1),
                          layer.bias)

    def forward(self, x, ehs):
        n, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
        h = self._proj(self.proj_in, h)
        for blk in self.transformer_blocks:
            h = blk(h, ehs)
        h = self._proj(self.proj_out, h)
        return h.reshape(n, hh, ww, c).permute(0, 3, 1, 2) + x


class Level(nn.Module):
    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class Down2x(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Up2x(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet(nn.Module):
    """``cfg``: the ``unet`` group of a configuration file (diffusers'
    ``unet/config.json`` keys)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bo = list(cfg["block_out_channels"])
        n = len(bo)
        g = cfg["norm_num_groups"]
        temb = 4 * bo[0]
        heads = cfg["attention_head_dim"]
        heads = [heads] * n if isinstance(heads, int) else list(heads)
        depth = cfg["transformer_layers_per_block"]
        depth = [depth] * n if isinstance(depth, int) else list(depth)
        attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        ctx_dim = cfg["cross_attention_dim"]
        lin = cfg["use_linear_projection"]
        lpb = cfg["layers_per_block"]

        def tr(c, lvl):
            return Transformer(c, ctx_dim, heads[lvl], depth[lvl], g, lin)

        self.conv_in = Conv(cfg["in_channels"], bo[0], 3)
        self.time_embedding = TimeMLP(bo[0], temb)
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimeMLP(
                cfg["projection_class_embeddings_input_dim"], temb)
        downs, out = [], bo[0]
        for i in range(n):
            inp, out = out, bo[i]
            downs.append(Level(
                [Resnet(inp if j == 0 else out, out, temb, g)
                 for j in range(lpb)],
                [tr(out, i) for _ in range(lpb)] if attn[i] else [],
                down=Down2x(out) if i < n - 1 else None))
        self.down_blocks = nn.ModuleList(downs)
        mid_depth = max(depth[-1], 1)
        self.mid_block = Level(
            [Resnet(bo[-1], bo[-1], temb, g), Resnet(bo[-1], bo[-1], temb, g)],
            [Transformer(bo[-1], ctx_dim, heads[-1], mid_depth, g, lin)])
        ups, rev = [], bo[::-1]
        for i in range(n):
            lvl = n - 1 - i
            prev = bo[-1] if i == 0 else rev[i - 1]
            res = []
            for j in range(lpb + 1):
                skip = bo[max(lvl - 1, 0)] if j == lpb else bo[lvl]
                res.append(Resnet((prev if j == 0 else rev[i]) + skip, rev[i],
                                  temb, g))
            ups.append(Level(res, [tr(rev[i], lvl) for _ in range(lpb + 1)]
                             if attn[lvl] else [],
                             up=Up2x(rev[i]) if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = Norm(bo[0], 1e-5, g)
        self.conv_out = Conv(bo[0], cfg["out_channels"], 3)

    @property
    def n_levels(self) -> int:
        return len(self.cfg["block_out_channels"])

    def time_embed(self, t, added=None):
        emb = self.time_embedding(ops.timestep_embedding(
            t, self.cfg["block_out_channels"][0]))
        if hasattr(self, "add_embedding"):
            ids = added["time_ids"].float()
            b = ids.shape[0]
            tid = ops.timestep_embedding(ids.reshape(-1),
                                         self.cfg["addition_time_embed_dim"])
            emb = emb + self.add_embedding(torch.cat(
                [added["text_embeds"].float(), tid.reshape(b, -1)], dim=-1))
        return emb

    @staticmethod
    def _pair(level, j):
        res = level.resnets[j]
        att = level.attentions[j] if len(level.attentions) else None

        def body(x, temb, ehs):
            y = res(x, temb)
            return att(y, ehs) if att is not None else y
        return body

    def forward(self, sample, t, ehs, added=None, deep=None,
                boundary: Optional[int] = None,
                hook: Optional[Callable] = None):
        """``sample`` NHWC ``(B, h, w, C)``; returns ``(eps NHWC, deep
        feature NCHW)``.  ``deep`` None computes the tail; else the tail is
        skipped and ``deep`` is the feature."""
        n = self.n_levels
        bdy = n - 1 if boundary is None else boundary
        temb = self.time_embed(t, added)
        ehs = ehs.float()

        def pair(key, level, j, x):
            body = self._pair(level, j)
            fn = lambda xx: body(xx, temb, ehs)  # noqa: E731
            return fn(x) if hook is None else hook(key, x, fn)

        h = self.conv_in(sample.float().permute(0, 3, 1, 2))
        skips = [h]
        for i in range(bdy):
            blk = self.down_blocks[i]
            for j in range(len(blk.resnets)):
                h = pair(f"down{i}.{j}", blk, j, h)
                skips.append(h)
            if i < bdy - 1:
                h = blk.downsamplers[0](h)
                skips.append(h)
        if deep is None:
            deep = self.tail(h, temb, ehs, bdy)
        h = deep.float()
        for i in range(n - bdy, n):
            blk = self.up_blocks[i]
            for j in range(len(blk.resnets)):
                h = pair(f"up{i}.{j}", blk, j,
                         torch.cat([h, skips.pop()], dim=1))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1), deep

    def tail(self, h, temb, ehs, bdy: int):
        """The levels at and below the boundary: the deep feature."""
        n = self.n_levels
        h = self.down_blocks[bdy - 1].downsamplers[0](h)
        skips = [h]
        for blk in self.down_blocks[bdy:]:
            for j in range(len(blk.resnets)):
                h = self._pair(blk, j)(h, temb, ehs)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ehs),
                           temb)
        for blk in self.up_blocks[:n - bdy]:
            for j in range(len(blk.resnets)):
                h = self._pair(blk, j)(torch.cat([h, skips.pop()], dim=1),
                                       temb, ehs)
            h = blk.upsamplers[0](h)
        return h
