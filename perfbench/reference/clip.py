"""Plain float32 CLIP text encoders (CLIP-L, OpenCLIP bigG) and the
tokenizer that weight-less serving uses.

Parameter names are transformers' ``CLIPTextModel`` keys.  Pooling takes
the first EOS id of the published vocabulary (49407), or the last position
where the ids hold none: the rule of the system this repository ports,
which its stand-in tokenizer (hashed words, EOS 2) never meets, so every
pooled feature here is the last position's.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import ops
from perfbench.reference.unet import Lin, Norm, _p


def tokenize(texts, vocab_size: int, length: int = 77) -> np.ndarray:
    """BOS 0, each word's crc32 id in ``[3, vocab)``, EOS 2, pad 1."""
    out = []
    for t in texts:
        toks = [0] + [3 + (zlib.crc32(w.encode()) % (vocab_size - 4))
                      for w in t.split()][: length - 2] + [2]
        out.append(toks + [1] * (length - len(toks)))
    return np.asarray(out, np.int64)


class Embeddings(nn.Module):
    def __init__(self, vocab, dim, pos):
        super().__init__()
        self.token_embedding = nn.Module()
        self.token_embedding.weight = _p(vocab, dim)
        self.position_embedding = nn.Module()
        self.position_embedding.weight = _p(pos, dim)


class SelfAttn(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Lin(dim, dim), Lin(dim, dim)
        self.v_proj, self.out_proj = Lin(dim, dim), Lin(dim, dim)

    def forward(self, x):
        o = ops.attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                          self.heads, causal=True)
        return self.out_proj(o)


class MLP(nn.Module):
    def __init__(self, dim, inner, act):
        super().__init__()
        self.fc1, self.fc2 = Lin(dim, inner), Lin(inner, dim)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return self.fc2(h)


class Layer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_size"]
        self.layer_norm1 = Norm(d, 1e-5)
        self.self_attn = SelfAttn(d, cfg["num_attention_heads"])
        self.layer_norm2 = Norm(d, 1e-5)
        self.mlp = MLP(d, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d = cfg["hidden_size"]
        tm = nn.Module()
        tm.embeddings = Embeddings(cfg["vocab_size"], d,
                                   cfg["max_position_embeddings"])
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [Layer(cfg) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = Norm(d, 1e-5)
        self.text_model = tm
        if cfg.get("projection_dim"):
            self.text_projection = Lin(d, cfg["projection_dim"], bias=False)

    def forward(self, ids: torch.Tensor, penultimate: bool):
        """``(features, pooled)``: the penultimate layer's output or the
        final normed one, and the pooled (projected) feature."""
        tm = self.text_model
        emb = tm.embeddings
        x = emb.token_embedding.weight.float()[ids] \
            + emb.position_embedding.weight.float()[None, :ids.shape[1]]
        prev = x
        for layer in tm.encoder.layers:
            prev, x = x, layer(x)
        last = tm.final_layer_norm(x)
        eos = ids == 49407
        pos = torch.where(eos.any(-1), eos.int().argmax(-1),
                          torch.full_like(ids[:, 0], ids.shape[1] - 1))
        pooled = last[torch.arange(ids.shape[0], device=ids.device), pos]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return (prev if penultimate else last), pooled
