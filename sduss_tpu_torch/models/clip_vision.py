"""CLIP vision encoder (counterpart of sduss_tpu/models/clip_vision.py).

The image tower of CLIP-score evaluation and of the safety checker.
Module names follow transformers' ``CLIPVisionModelWithProjection``
(``vision_model.*`` with its ``pre_layrnorm`` spelling, and
``visual_projection``), so ``state_dict()`` keys are the checkpoint's.
Its encoder layers are the text encoder's (``clip.CLIPEncoderLayer``),
unmasked; attention is the plain ``layers.attention``, as the JAX tower
runs XLA's plain attention and no Pallas kernel.  Pixels are NCHW inside.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from sduss_tpu_torch.models import layers as L
from sduss_tpu_torch.models.clip import CLIPEncoder
from sduss_tpu_torch.models.registry import fan_in_init


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_L14 = CLIPVisionConfig()
TINY_CLIP_VISION = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, projection_dim=64)

# CLIP preprocessing constants (openai/clip-vit-large-patch14 processor).
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_weights(m: int, n: int, device) -> torch.Tensor:
    """``(m, n)`` weights of ``jax.image.resize(method="bilinear")`` along
    one axis of ``m`` pixels resized to ``n``: JAX's
    ``compute_weight_mat`` (scale n/m, no translation, antialias), in
    float32 as JAX computes it.  Half-pixel centres; the triangle kernel
    is widened by m/n when shrinking (antialias), each output column
    normalised to sum 1."""
    inv_scale = 1.0 / torch.tensor(n / m, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None]) \
        .abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1,
                                               cfg.hidden_size)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = L.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = L.LayerNorm(cfg.hidden_size,
                                          eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size,
                                           cfg.projection_dim, bias=False)

    @torch.no_grad()
    def init_random_(self, gen: torch.Generator) -> None:
        """Random weights from ``gen`` in place: ``fan_in_init``, and
        N(0, 0.02) for the class embedding."""
        fan_in_init(self, gen)
        self.vision_model.embeddings.class_embedding.normal_(
            0.0, 0.02, generator=gen)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, image_size, image_size) normalised
        float32 pixels: a bilinear resize straight to the target square,
        as in JAX (the CLIP processor's resize-shortest and centre crop
        reduce to it for square inputs).  An axis already at the target
        size is left as it is, as ``jax.image.resize`` leaves it."""
        s = self.cfg.image_size
        x = images.float() / 255.0
        _, h, w, _ = x.shape
        if h != s:
            x = torch.einsum("bhwc,hi->biwc", x, _resize_weights(h, s, x.device))
        if w != s:
            x = torch.einsum("bhwc,wj->bhjc", x, _resize_weights(w, s, x.device))
        mean = torch.tensor(_MEAN, device=x.device)
        std = torch.tensor(_STD, device=x.device)
        return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()

    def forward(self, pixel_values: torch.Tensor) -> dict:
        """pixel_values: (B, 3, image_size, image_size) preprocessed.

        Returns the JAX model's dict: ``pooled`` (the post-LayerNorm CLS
        token) and ``image_embeds`` (its projection).
        """
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major
        cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight[None, :x.shape[1]]
        x = vm.pre_layrnorm(x)
        for lyr in vm.encoder.layers:
            x = lyr(x, None)
        pooled = vm.post_layernorm(x[:, 0])
        return {"pooled": pooled, "image_embeds": self.visual_projection(pooled)}
