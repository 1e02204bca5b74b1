"""AutoencoderKL decoder (counterpart of sduss_tpu/models/vae.py ``decode``
and ``decode_tiled``).

Only the decode half is ported: serving runs text-to-image, and the
encoder (img2img) comes with a later slice.  ``decode_tiled`` is the SD3
serving decode (the JAX pipeline tiles every SD3 decode past 64 latent
cells), so the port runs the same tiles and blends them the same way.
Module names follow diffusers' AutoencoderKL, so ``state_dict()`` keys are
the checkpoint's ``decoder.*`` and ``post_quant_conv.*`` keys.  Takes NHWC
latents, returns NHWC images.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from sduss_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    # SDXL's VAE overflows in half precision: decode in float32.
    force_upcast: bool = False
    use_quant_conv: bool = True


SD15_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025, force_upcast=True)
# SD3's 16-channel VAE ships without the 1x1 (post_)quant convs
SD3_VAE = VAEConfig(latent_channels=16, scaling_factor=1.5305,
                    shift_factor=0.0609, use_quant_conv=False)
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8)


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = L.GroupNorm(groups, in_ch, 1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = L.GroupNorm(groups, out_ch, 1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(self.norm1(x, act="silu"))
        h = self.conv2(self.norm2(h, act="silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head mid-block self-attention over all spatial positions."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = L.GroupNorm(groups, ch, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        # plain torch (the JAX package computes it outside any Pallas
        # kernel); row blocking bounds the 16k-token f32 score matrix
        y = L.attention_blocked(self.to_q(y), self.to_k(y), self.to_v(y), 1)
        y = self.to_out[0](y).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + y


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups),
                                      VAEResnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(L.nearest_upsample_2x(x))


class UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, groups: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnet(in_ch if j == 0 else out_ch, out_ch, groups)
             for j in range(n)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_num_groups
        rev = list(reversed(chs))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chs[-1], 3, padding=1)
        self.mid_block = MidBlock(chs[-1], g)
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1, g,
                     i < len(chs) - 1) for i in range(len(chs))])
        self.conv_norm_out = L.GroupNorm(g, chs[0], 1e-6)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h, act="silu"))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                             cfg.latent_channels, 1)

    def _scale_in(self, latents):
        """Unscale NHWC latents into the module's parameter dtype."""
        cfg = self.cfg
        z = latents.float() / cfg.scaling_factor + cfg.shift_factor
        return z.to(self.decoder.conv_in.weight.dtype)

    def _decode_core(self, z):
        """Unscaled NHWC latents -> NHWC images."""
        z = z.permute(0, 3, 1, 2).contiguous()
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z).permute(0, 2, 3, 1)

    def decode(self, latents):
        """Scaled NHWC latents ``(B, h, w, C)`` -> NHWC images in [-1, 1].

        Computes in the module's parameter dtype (``ModelConfig.vae_dtype``:
        bf16 on the card and float32 on the CPU unless set).
        """
        return self._decode_core(self._scale_in(latents))

    def decode_tiled(self, latents, tile: int = 64, overlap: int = 16,
                     strips=None):
        """Spatially tiled decode, the contract of :meth:`decode`
        (vae.py:234-308): overlapping latent tiles, each decoded alone and
        blended with a linear ramp over the overlap, normalized by the
        summed weight.  Full-width row strips when a strip of ``tile^2``
        cells spans the width (every SD3 serving size), square 2D tiles
        otherwise.  Returns float32 images.
        """
        b, h, w, _ = latents.shape
        if h <= tile and w <= tile:
            return self.decode(latents)
        z = self._scale_in(latents)
        s = 2 ** (len(self.cfg.block_out_channels) - 1)  # pixels per cell
        if strips is None:
            strips = w <= (tile * tile) // 8 and (tile * tile) // w < h
        if strips:
            if w > (tile * tile) // 8:
                raise ValueError(
                    f"strips=True needs latent width <= tile^2/8 "
                    f"({(tile * tile) // 8} cells at tile={tile}); got w={w}")
            tile_h, tile_w = max(8, min((tile * tile) // w, h)), w
            ov_h, ov_w = min(overlap, tile_h // 4), 0
        else:
            tile_h = tile_w = min(tile, h, w)
            ov_h = ov_w = min(overlap, tile_h // 2)

        def positions(extent, t, ov):
            if extent <= t:
                return [0]
            n = -(-(extent - ov) // (t - ov))  # ceil
            return [int(round(p)) for p in np.linspace(0, extent - t, n)]

        def ramp1d(t, ov):
            ramp_len = max(ov * s, 1)
            axis = np.arange(t * s, dtype=np.float32)
            return np.minimum(1.0, np.minimum((axis + 1) / ramp_len,
                                              (t * s - axis) / ramp_len))

        dev = latents.device
        wgt = torch.from_numpy(np.outer(ramp1d(tile_h, ov_h), ramp1d(
            tile_w, ov_w))[None, :, :, None].astype(np.float32)).to(dev)
        out_sum = torch.zeros((b, h * s, w * s, self.cfg.out_channels),
                              dtype=torch.float32, device=dev)
        wgt_sum = torch.zeros((1, h * s, w * s, 1), dtype=torch.float32,
                              device=dev)
        for py in positions(h, tile_h, ov_h):
            for px in positions(w, tile_w, ov_w):
                img = self._decode_core(z[:, py:py + tile_h, px:px + tile_w])
                oy, ox = py * s, px * s
                oy2, ox2 = oy + tile_h * s, ox + tile_w * s
                out_sum[:, oy:oy2, ox:ox2] += img.float() * wgt
                wgt_sum[:, oy:oy2, ox:ox2] += wgt
        return out_sum / wgt_sum
