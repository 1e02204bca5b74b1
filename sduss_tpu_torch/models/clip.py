"""CLIP text encoder (counterpart of sduss_tpu/models/clip.py).

Module names follow transformers' ``CLIPTextModel`` /
``CLIPTextModelWithProjection``, so ``state_dict()`` keys are the
checkpoint's keys.  Serves SDXL's and SD3's CLIP-L (quick_gelu; SD3's with
a 768 projection head) and OpenCLIP bigG (exact gelu, projection head).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from sduss_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP bigG)
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    # Non-None => CLIPTextModelWithProjection (SDXL text_encoder_2).
    projection_dim: Optional[int] = None


CLIP_L = CLIPTextConfig()
CLIP_G = CLIPTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
    hidden_act="gelu", projection_dim=1280,
)
CLIP_L_PROJ = dataclasses.replace(CLIP_L, projection_dim=768)  # SD3 text_encoder
TINY_CLIP = CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                           intermediate_size=128, projection_dim=64)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, h, mask):
        out = L.attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                          self.heads, mask=mask)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = L.quick_gelu if cfg.hidden_act == "quick_gelu" else L.gelu
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = L.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size,
                                             cfg.projection_dim, bias=False)

    def forward(self, input_ids, output_hidden_states: bool = False):
        """Encode token ids ``(B, 77)``; returns the JAX model's dict:
        ``last_hidden_state`` (post final LayerNorm), ``pooled`` (EOS token,
        projected when the config has a head) and, with
        ``output_hidden_states``, ``hidden_states`` (``[-2]`` is the SDXL
        penultimate feature)."""
        cfg = self.cfg
        tm = self.text_model
        b, seq = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding.weight[None, :seq]
        causal = torch.ones(seq, seq, dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        hidden_states = [x] if output_hidden_states else None
        for lyr in tm.encoder.layers:
            x = lyr(x, causal)
            if output_hidden_states:
                hidden_states.append(x)
        last = tm.final_layer_norm(x)

        # EOS pooling: first occurrence of the EOS id, else the last position.
        is_eos = input_ids == cfg.eos_token_id
        eos_pos = torch.where(is_eos.any(dim=-1),
                              is_eos.int().argmax(dim=-1),
                              torch.full_like(input_ids[:, 0], seq - 1))
        pooled = last[torch.arange(b, device=last.device), eos_pos]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        out = {"last_hidden_state": last, "pooled": pooled}
        if output_hidden_states:
            out["hidden_states"] = hidden_states
        return out
