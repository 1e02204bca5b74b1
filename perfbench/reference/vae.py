"""Plain float32 AutoencoderKL decoder (diffusers' keys ``decoder.*`` and
``post_quant_conv.*``) and the uint8 image it serves."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import ops
from perfbench.reference.unet import Conv, Lin, Norm, Up2x


class Res(nn.Module):
    def __init__(self, i, o, g):
        super().__init__()
        self.norm1, self.conv1 = Norm(i, 1e-6, g), Conv(i, o, 3)
        self.norm2, self.conv2 = Norm(o, 1e-6, g), Conv(o, o, 3)
        self.conv_shortcut = Conv(i, o, 1) if i != o else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttn(nn.Module):
    def __init__(self, c, g):
        super().__init__()
        self.group_norm = Norm(c, 1e-6, g)
        self.to_q, self.to_k, self.to_v = Lin(c, c), Lin(c, c), Lin(c, c)
        self.to_out = nn.ModuleList([Lin(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = ops.attention(self.to_q(y), self.to_k(y), self.to_v(y), 1,
                          block=1024)
        return x + self.to_out[0](y).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs, g = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        rev, lpb = chs[::-1], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["latent_channels"], chs[-1], 3)
        mid = nn.Module()
        mid.resnets = nn.ModuleList([Res(chs[-1], chs[-1], g),
                                     Res(chs[-1], chs[-1], g)])
        mid.attentions = nn.ModuleList([MidAttn(chs[-1], g)])
        self.mid_block = mid
        ups = []
        for i in range(len(chs)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [Res(rev[max(i - 1, 0)] if j == 0 else rev[i], rev[i], g)
                 for j in range(lpb + 1)])
            if i < len(chs) - 1:
                blk.upsamplers = nn.ModuleList([Up2x(rev[i])])
            ups.append(blk)
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = Norm(chs[0], 1e-6, g)
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3)

    def forward(self, z):
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](self.conv_in(z))))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        c = cfg["latent_channels"]
        self.post_quant_conv = Conv(c, c, 1)

    def decode(self, latents):
        """Scaled NHWC latents -> float images in [0, 255] before rounding."""
        z = latents.float() / self.cfg["scaling_factor"]
        img = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        return (img * 255.0).permute(0, 2, 3, 1)
