"""Pipeline-stage parallelism for the MMDiT trunk (counterpart of
sduss_tpu/parallel/pipeline.py).

Stage ``s`` holds a contiguous span of the joint blocks on its own device
(stage 0 also the embedding prelude, the last stage the head).  A forward
splits the CFG-doubled batch into microbatches; each microbatch flows
stage 0 -> S-1, its activations copied between the stages' devices.
There is no hand-written schedule: CUDA launches are asynchronous, so a
stage working on microbatch m overlaps the previous stage on m + 1 when
the stages sit on different cards, as JAX's asynchronous dispatch gives.
The numbers are the single-device forward's: the same modules run the
same ops, only their placement differs.

The Engine does not route through it (``pp > 1`` is refused at Engine
build): it is the class for a trunk that must never be resident in one
place, whose stages stream their weights from ``stage_params_fn``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn

from sduss_tpu_torch.models.mmdit import SD3Transformer2DModel

_PRELUDE = ("pos_embed", "time_text_embed", "context_embedder")
_HEAD = ("norm_out", "proj_out")


def split_spans(n_blocks: int, n_stages: int) -> List[tuple]:
    """Balanced contiguous ``[lo, hi)`` spans, sizes differing by at most
    one, the larger first (pipeline.py:38-50)."""
    if not 1 <= n_stages <= n_blocks:
        raise ValueError(f"need 1 <= n_stages <= {n_blocks}, got {n_stages}")
    big = n_blocks - n_stages * (n_blocks // n_stages)
    sizes = [n_blocks // n_stages + (1 if i < big else 0)
             for i in range(n_stages)]
    bounds = [0]
    for sz in sizes:
        bounds.append(bounds[-1] + sz)
    return [(bounds[i], bounds[i + 1]) for i in range(n_stages)]


def _stage_module(cfg, lo: int, hi: int, first: bool, last: bool):
    """An ``SD3Transformer2DModel`` holding blocks ``[lo, hi)`` (plus the
    prelude on the first stage, the head on the last), on the meta
    device."""
    with torch.device("meta"):
        full = SD3Transformer2DModel(cfg)
    full.transformer_blocks = nn.ModuleList(
        list(full.transformer_blocks)[lo:hi])
    for name in (() if first else _PRELUDE) + (() if last else _HEAD):
        delattr(full, name)
    return full


def _stage_keys(name: str, lo: int, hi: int, first: bool, last: bool):
    """The full model's state-dict key ``name`` as the stage's, or None when
    the stage does not hold it."""
    if name.startswith("transformer_blocks."):
        i = int(name.split(".")[1])
        if not lo <= i < hi:
            return None
        rest = name.split(".", 2)[2]
        return f"transformer_blocks.{i - lo}.{rest}"
    top = name.split(".")[0]
    if (top in _PRELUDE and first) or (top in _HEAD and last):
        return name
    return None


class MMDiTStagePipeline:
    """GPipe-style pipeline over the MMDiT for one denoise forward
    (pipeline.py:53-156).

    ``devices``: one per stage, in stage order.  ``n_micro``: microbatches
    per forward, by default ``min(batch, n_stages)``.  Pass the whole
    ``model`` (a stage on the model's device shares its tensors, one
    elsewhere gets copies), or ``stage_params_fn(stage, lo, hi)``
    returning that stage's state dict in the full model's names (the
    span's ``transformer_blocks.{i}.*``, plus the prelude's tensors on
    stage 0 and the head's on the last), which may stream it from
    storage: the trunk is then never resident in one place."""

    def __init__(self, model: Optional[SD3Transformer2DModel] = None,
                 devices: Sequence = (), n_micro: Optional[int] = None,
                 stage_params_fn: Optional[Callable] = None, cfg=None,
                 dtype=None):
        if (model is None) == (stage_params_fn is None):
            raise ValueError("pass exactly one of model / stage_params_fn")
        self.cfg = model.cfg if model is not None else cfg
        self.devices = [torch.device(d) for d in devices]
        self.n_stages = len(self.devices)
        self.n_micro = n_micro
        self.spans = split_spans(self.cfg.num_layers, self.n_stages)
        self.stages = []
        for s, (lo, hi) in enumerate(self.spans):
            first, last = s == 0, s == self.n_stages - 1
            stage = _stage_module(self.cfg, lo, hi, first, last)
            if model is not None:
                sd = model.state_dict()
                dt = next(model.parameters()).dtype
            else:
                sd = stage_params_fn(s, lo, hi)
                dt = dtype or next(iter(sd.values())).dtype
            own = {}
            for name, t in sd.items():
                key = _stage_keys(name, lo, hi, first, last)
                if key is not None:
                    # the model's own tensor where it already lies there
                    own[key] = t.to(self.devices[s], dt)
            stage.load_state_dict(own, strict=True, assign=True)
            if model is not None:
                stage._pos_full = model._pos_full
            self.stages.append(stage.requires_grad_(False).eval())

    @torch.inference_mode()
    def __call__(self, latents, timesteps, encoder_hidden_states,
                 pooled_projections):
        """``(B, H, W, C)`` -> ``(B, H, W, C)`` velocity, microbatched
        through the stages; the result on the first stage's device."""
        ps = self.cfg.patch_size
        b, hh, ww, _ = latents.shape
        hp, wp = hh // ps, ww // ps
        n_micro = max(1, min(self.n_micro or min(b, self.n_stages), b))
        idx = [round(i * b / n_micro) for i in range(n_micro + 1)]
        outs = []
        for i in range(n_micro):
            lo, hi = idx[i], idx[i + 1]
            if lo == hi:
                continue
            d0 = self.devices[0]
            args = [a[lo:hi].to(d0) for a in (latents, timesteps,
                                               encoder_hidden_states,
                                               pooled_projections)]
            first = self.stages[0]
            x, c, temb = first.prelude(*args)
            for s, stage in enumerate(self.stages):
                if s:
                    dev = self.devices[s]
                    x, c, temb = (a.to(dev) for a in (x, c, temb))
                x, c = stage.trunk_blocks(x, c, temb)
            outs.append(self.stages[-1].head(x, temb).to(d0))
        tokens = torch.cat(outs) if len(outs) > 1 else outs[0]
        return self.stages[0].unpatchify(tokens, hp, wp)
