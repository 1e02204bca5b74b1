"""The work of the reference UNet's parts at one resolution, counted once
per (configuration, resolution) from the model's shapes.

``torch.utils.flop_counter.FlopCounterMode`` runs the reference forward
on meta tensors (no memory, no arithmetic) for one image's CFG pair, and
every call of the reference attention is logged with its shapes.  The
parts are those of the deep cache: the fixed ops a step always runs
(``fixed``: the input and output convolutions, the time embeddings, the
spine's downsamples), each gated pair by its key, and the ``tail`` whose
output is the deep feature.  A mode's file in this directory adds up the
parts that its step computed; nothing is read from a kernel's launch.

Attention work per call, for a bf16 kernel: 4 Lq Lk D operations per row
(QK^T and PV), and Q, K, V and O each read or written once (2 bytes a
value).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import models, ops

PEAK_FLOPS = 989e12       # H100 SXM, bf16 dense (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3


def attn_bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for an attention call: the
    larger of its operations at the bf16 peak and its bytes at the memory
    rate (``chip_smoke.py bound``)."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


class _Log:
    def __init__(self):
        self.key = "fixed"
        self.attn: Dict[str, List[Tuple[float, float]]] = {}

    def attention(self, q, k, v, heads, causal=False, block=4096):
        b, lq, d = q.shape
        lk = k.shape[1]
        fl = 4.0 * b * lq * lk * d
        nb = 2.0 * b * (2 * lq * d + 2 * lk * d)
        self.attn.setdefault(self.key, []).append((fl, nb))
        return _REAL_ATTENTION(q, k, v, heads, causal, block)


_REAL_ATTENTION = ops.attention


def _count(fn, log: _Log) -> float:
    ops.attention = log.attention
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())
    finally:
        ops.attention = _REAL_ATTENTION


@functools.lru_cache(maxsize=None)
def _unet_table(cfg_json: str, res: int, boundary) -> dict:
    cfg = json.loads(cfg_json)
    unet = models.build(cfg)["unet"]
    u = cfg["unet"]
    hw = res // 8
    dev = "meta"
    x = torch.empty(2, hw, hw, u["in_channels"], device=dev)
    t = torch.empty(2, device=dev)
    ehs = torch.empty(2, 77, u["cross_attention_dim"], device=dev)
    added = None
    if u.get("addition_embed_type") == "text_time":
        pooled = (u["projection_class_embeddings_input_dim"]
                  - 6 * u["addition_time_embed_dim"])
        added = {"text_embeds": torch.empty(2, pooled, device=dev),
                 "time_ids": torch.empty(2, 6, device=dev)}
    pairs: Dict[str, float] = {}
    log = _Log()

    def hook(key, xx, fn):
        prev = log.key
        log.key = key
        with FlopCounterMode(display=False) as fc:
            y = fn(xx)
        pairs[key] = float(fc.get_total_flops())
        log.key = prev
        return y

    full = _count(lambda: unet(x, t, ehs, added, boundary=boundary,
                               hook=hook), log)
    log.key = "fixed"
    feat = {}

    def run_full():
        feat["deep"] = unet(x, t, ehs, added, boundary=boundary)[1]

    _count(run_full, _Log())
    log_s = _Log()

    def keyed(key, xx, fn):
        log_s.key = key
        y = fn(xx)
        log_s.key = "fixed"
        return y

    shallow = _count(lambda: unet(x, t, ehs, added, deep=feat["deep"],
                                  boundary=boundary, hook=keyed), log_s)
    fixed = shallow - sum(pairs.values())
    # the full forward logs the tail's calls beside the fixed parts' ones
    tail_calls = log.attn.get("fixed", [])[len(log_s.attn.get("fixed", [])):]
    return {"fixed": fixed, "pairs": pairs, "tail": full - shallow,
            "full": full,
            "attn": {"fixed": log_s.attn.get("fixed", []),
                     "tail": tail_calls,
                     **{k: v for k, v in log.attn.items() if k != "fixed"}}}


def unet(cfg: dict, res: int, boundary) -> dict:
    """The part table of ``cfg``'s UNet at ``res`` (one CFG pair)."""
    return _unet_table(json.dumps(cfg, sort_keys=True), int(res), boundary)


@functools.lru_cache(maxsize=None)
def _decode(cfg_json: str, res: int) -> float:
    cfg = json.loads(cfg_json)
    vae = models.build(cfg)["vae"]
    z = torch.empty(1, res // 8, res // 8, cfg["vae"]["latent_channels"],
                    device="meta")
    return _count(lambda: vae.decode(z), _Log())


def decode(cfg: dict, res: int) -> float:
    """Operations of one image's VAE decode."""
    return _decode(json.dumps(cfg, sort_keys=True), int(res))


@functools.lru_cache(maxsize=None)
def _text(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    mods = models.build(cfg)
    total = 0.0
    for name in models.TEXT_ENCODERS:
        if name in mods:
            ids = torch.zeros(2, 77, dtype=torch.long, device="meta")
            total += _count(lambda m=mods[name]: m(ids, True), _Log())
    return total


def text(cfg: dict) -> float:
    """Operations of one request's text encoding (prompt and negative)."""
    return _text(json.dumps(cfg, sort_keys=True))
