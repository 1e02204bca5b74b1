"""T5 v1.1 encoder (counterpart of sduss_tpu/models/t5.py), SD3's third
text encoder.

RMS-norm pre-normalization, bias-free linears, one relative position bias
(from the first layer) shared by every layer, unscaled attention and a
gated tanh-GELU feed-forward.  Module names follow transformers'
``T5EncoderModel``, so ``state_dict()`` keys are the checkpoint's keys
(``shared``, ``encoder.block.{i}.layer.{0,1}...``).  Attention stays plain
PyTorch, as the JAX model's ``L.attention`` is plain XLA: no Pallas kernel
serves it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from sduss_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


T5_XXL = T5Config()
TINY_T5 = T5Config(vocab_size=1000, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative position bucketing (host numpy, int64),
    the JAX package's function (t5.py:38-52)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class RMSNorm(nn.Module):
    """T5's scale-only RMS norm; state-dict key ``weight``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return L.rms_norm(x, self.weight, self.eps)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads = cfg.num_heads
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, h, bias):
        # unscaled dot products: T5 folds the scale into its init
        out = L.attention(self.q(h), self.k(h), self.v(h), self.heads,
                          scale=1.0, bias=bias)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(L.gelu_tanh(self.wi_0(h)) * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, bias):
        sa, ff = self.layer
        x = x + sa.SelfAttention(sa.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)


class T5EncoderModel(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def position_bias(self, seq_len: int):
        """``(1, H, S, S)`` additive bias shared by every layer."""
        cfg = self.cfg
        ctx = np.arange(seq_len)
        buckets = _relative_position_bucket(
            ctx[None, :] - ctx[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(table.device)
        return table[idx].permute(2, 0, 1)[None]

    def forward(self, input_ids, attention_mask=None):
        """``(B, S)`` ids -> ``(B, S, d_model)`` features after the final
        RMS norm.  ``attention_mask`` ``(B, S)``: keys at 0 get
        ``finfo(float32).min`` added to their logits, as in the JAX model."""
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1]).float()
        if attention_mask is not None:
            big_neg = torch.finfo(torch.float32).min
            keep = (attention_mask > 0)[:, None, None, :]
            bias = bias + torch.where(keep, 0.0, big_neg)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
