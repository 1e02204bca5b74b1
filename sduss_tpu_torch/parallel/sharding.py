"""Tensor-parallel sharding of the denoisers (counterpart of
sduss_tpu/parallel/sharding.py).

The JAX package states tensor parallelism as name rules on the parameter
tree and lets GSPMD insert the collectives.  The port reads the same
rules in torch's layout and diffusers' names and builds, per shard, a
module that holds only that shard's slice (:func:`shard_module`):

* column-parallel (the out dim, dim 0 of a Linear ``(out, in)`` weight,
  and its bias): ``to_q``, ``to_k``, ``to_v``, the feed-forwards' first
  linears (``ff.net.0.proj``, SD3's ``ff``/``ff_context`` too), SD3's
  ``add_{q,k,v}_proj`` and the resnets' ``time_emb_proj``.  A GEGLU
  projection shards its value half and its gate half each, so that the
  split stays local;
* row-parallel (the in dim, dim 1): ``to_out.0``, ``to_add_out`` and the
  feed-forwards' second linears (``ff.net.2``): the local product, a
  ``psum`` over ``tp``, then the bias, once (:class:`RowParallelLinear`);
* each resnet's conv pair: ``conv1`` shards its output channels (OIHW dim
  0), ``conv2`` its input channels (dim 1, :class:`RowParallelConv2d`),
  and the GroupNorm between them runs on the local channels with
  ``groups / tp`` groups, exact because a group never straddles shards;
* everything else is replicated.

Guards: JAX shards a resnet pair where ``cout % tp == 0``; the port also
needs ``groups % tp == 0`` for the local GroupNorm (true of every shipped
configuration).  An attention whose heads do not divide by ``tp`` is left
replicated (JAX's divisibility guard for convs, applied to attention): the
same numbers, no refusal.  SDXL's 10-head level at ``tp=4`` is the case.

Attention runs on ``heads / tp`` local heads, so the attention kernels run
at the local head count; SD3's per-head qk RMS norms carry one
``head_dim`` weight shared by every head, so they go with their heads
unchanged.  The residual stream stays replicated, bitwise equal on every
shard (``psum`` adds in rank order).

:class:`ShardedDenoiser` is the denoiser a replica over a ``ShardGroup``
serves from: called on the pipeline's thread it runs every shard's
forward (tp alone) and returns shard 0's; called on a shard thread (the
sp step, ``pipelines/base.py``) it runs that shard's module.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# keyword arguments a forward updates in place: each shard but the first
# works on its own copy
PRIVATE = ("cache_state", "deep_state")


class ColumnParallelLinear(nn.Linear):
    """A Linear holding one shard's rows of the out dim (and of the bias):
    its output is the shard's slice of the features."""


class RowParallelLinear(nn.Linear):
    """A Linear holding one shard's columns of the in dim: the local
    product, summed over ``tp`` in float32, then the bias, once."""

    group = None

    def forward(self, x):
        y = self.group.psum(F.linear(x, self.weight).float(), "tp")
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class ColumnParallelConv2d(nn.Conv2d):
    """A Conv2d holding one shard's output channels (and their bias)."""


class RowParallelConv2d(nn.Conv2d):
    """A Conv2d holding one shard's input channels: the local convolution,
    summed over ``tp`` in float32, then the bias, once."""

    group = None

    def conv_at(self, x, stride: int = 1, padding=0):
        y = F.conv2d(x, self.weight, None, stride=stride, padding=padding)
        y = self.group.psum(y.float(), "tp")
        if self.bias is not None:
            y = y + self.bias.float().reshape(1, -1, 1, 1)
        return y.to(x.dtype)

    def _conv_forward(self, x, weight, bias):
        return self.conv_at(x, self.stride, self.padding)


def _heads_of(module) -> Optional[int]:
    """The head count of an attention module (UNet ``Attention``: ``heads``;
    MMDiT ``JointAttention``: ``cfg.num_heads``); None otherwise."""
    if hasattr(module, "heads"):
        return module.heads
    cfg = getattr(module, "cfg", None)
    if cfg is not None and hasattr(module, "to_q"):
        return cfg.num_heads
    return None


def param_rules(model: nn.Module, tp: int) -> Dict[str, tuple]:
    """``{parameter name: (kind, dim)}`` of every parameter ``shard_module``
    slices: kind "column" (dim 0), "row" (dim 1), "geglu" (dim 0, each
    half), "norm" (dim 0, a GroupNorm on local channels).  Absent names
    are replicated."""
    rules: Dict[str, tuple] = {}
    if tp <= 1:
        return rules
    mods = dict(model.named_modules())
    for name, mod in mods.items():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 1)[0] if "." in name else ""
        # attention projections: guarded by the attention's head count
        if leaf in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                    "add_v_proj", "to_add_out") or name.endswith("to_out.0"):
            owner = parent[:-len(".to_out")] if name.endswith("to_out.0") \
                else parent
            heads = _heads_of(mods.get(owner))
            if heads is None or heads % tp:
                continue
            kind = "row" if leaf in ("0", "to_add_out") else "column"
            _linear_rules(rules, name, mod, kind)
        elif name.endswith("net.0.proj"):  # a feed-forward's first linear
            geglu = type(mods[parent]).__name__ == "GEGLU"
            if mod.out_features % ((2 if geglu else 1) * tp) == 0:
                _linear_rules(rules, name, mod, "geglu" if geglu else "column")
        elif name.endswith("net.2") and isinstance(mod, nn.Linear):
            if f"{name[:-1]}0.proj.weight" in rules:  # its first is sharded
                _linear_rules(rules, name, mod, "row")
        elif leaf == "conv1" and isinstance(mod, nn.Conv2d):
            res = mods[parent]
            g = res.norm2.num_groups
            if mod.out_channels % tp == 0 and g % tp == 0:
                rules[f"{name}.weight"] = ("column", 0)
                if mod.bias is not None:
                    rules[f"{name}.bias"] = ("column", 0)
                _linear_rules(rules, f"{parent}.time_emb_proj",
                              res.time_emb_proj, "column")
                rules[f"{parent}.norm2.weight"] = ("norm", 0)
                rules[f"{parent}.norm2.bias"] = ("norm", 0)
                rules[f"{parent}.conv2.weight"] = ("row", 1)
    return rules


def _linear_rules(rules, name, mod, kind) -> None:
    dim = 1 if kind == "row" else 0
    rules[f"{name}.weight"] = (kind, dim)
    if mod.bias is not None and kind != "row":
        rules[f"{name}.bias"] = (kind, 0)


def _slice(t: torch.Tensor, kind: str, dim: int, j: int, tp: int):
    """Shard ``j`` of ``tp`` of ``t`` under a rule."""
    if kind == "geglu":  # [value; gate], each half by tp
        half = t.shape[0] // 2
        n = half // tp
        return torch.cat([t[j * n:(j + 1) * n],
                          t[half + j * n:half + (j + 1) * n]])
    n = t.shape[dim] // tp
    return t.narrow(dim, j * n, n)


def shard_module(model: nn.Module, group, rank: int) -> nn.Module:
    """Shard ``rank``'s module: ``model``'s structure, the sliced
    parameters of :func:`param_rules` at its tp index, and every other
    parameter shared with ``model`` on the same device (copied to another).
    Row-parallel layers reduce over ``group``'s ``tp`` axis; attention runs
    at the local head count.  A slice along dim 0 on the model's device is
    a view of the model's tensor."""
    tp = group.tp
    j = group.axis_index("tp", rank)
    dev = group.device(rank)
    rules = param_rules(model, tp)
    memo = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    for m in model.modules():  # host tables (the MMDiT's position grid)
        memo.update((id(v), v) for v in vars(m).values()
                    if isinstance(v, np.ndarray))
    shard = copy.deepcopy(model, memo)
    for name, mod in shard.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            rule = rules.get(f"{name}.{pname}" if name else pname)
            if rule is None and p.device == dev:
                continue  # shared with the model
            t = p.detach()
            if rule is not None:
                t = _slice(t, rule[0], rule[1], j, tp)
                if rule[1] != 0:
                    t = t.contiguous()
            mod._parameters[pname] = nn.Parameter(t.to(dev),
                                                  requires_grad=False)
        for bname, b in list(mod._buffers.items()):
            if b is not None and b.device != dev:
                mod._buffers[bname] = b.to(dev)
    mods = dict(shard.named_modules())
    for name, mod in mods.items():
        if f"{name}.weight" not in rules:
            continue
        kind = rules[f"{name}.weight"][0]
        if isinstance(mod, nn.Linear):
            mod.__class__ = (RowParallelLinear if kind == "row"
                             else ColumnParallelLinear)
            mod.out_features, mod.in_features = mod.weight.shape
        elif isinstance(mod, nn.Conv2d):
            mod.__class__ = (RowParallelConv2d if kind == "row"
                             else ColumnParallelConv2d)
            mod.out_channels, mod.in_channels = mod.weight.shape[:2]
        elif kind == "norm":
            mod.num_groups //= tp
        if kind == "row":
            mod.group = group
    for name, mod in mods.items():
        if f"{name}.to_q.weight" in rules:  # a sharded attention
            if hasattr(mod, "heads"):
                mod.heads //= tp
            else:
                mod.cfg = dataclasses.replace(
                    mod.cfg, num_heads=mod.cfg.num_heads // tp)
        if hasattr(mod, "kv_suffix"):  # an MMDiT block's stale K/V rows
            mod.kv_suffix = f"@{j}" if j else ""
    if hasattr(shard, "_pos_dev"):
        shard._pos_dev = {}
    return shard.eval()


def _to(obj, dev: torch.device, contexts: dict):
    """``obj`` with its tensors on ``dev`` (dicts, lists and tuples walked;
    a patch context rebuilt there from its ``meta``; anything else as it
    is).  ``contexts`` holds the contexts rebuilt for one forward's
    arguments, so that a context passed twice is rebuilt once: it is made
    anew for every forward (the caller's context is new every step, and
    an identity kept across forwards would outlive the object it names)."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev, contexts) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, dev, contexts) for v in obj)
    meta = getattr(obj, "meta", None)
    if meta is not None and hasattr(obj, "image_id") \
            and obj.image_id.device != dev:
        if id(obj) not in contexts:
            contexts[id(obj)] = type(obj)(meta, dev)
        return contexts[id(obj)]
    return obj


def _private(obj, dev: torch.device):
    """A copy of a state tree on ``dev``: new dicts, new tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev, copy=True)
    if isinstance(obj, dict):
        return {k: _private(v, dev) for k, v in obj.items()}
    return obj


class ShardedDenoiser:
    """A replica's denoiser over ``group``: one :func:`shard_module` per
    shard, ``model`` (the whole module, on the lead device) for every
    attribute but the forwards (layouts, the MMDiT's embedding and
    unpatchify).

    Called on the pipeline's thread (tp alone), a forward runs on every
    shard: rank 0 takes the arguments as they are, every other shard a
    copy on its device, with its own copy of the state a forward updates
    in place (``cache_state``, ``deep_state``); shard 0's result is
    returned and its updates are the state's.  The K/V rows of SD3's
    fine stale-K/V gate hold each shard's heads: a shard's own rows
    (keys ending ``@j``) are written back into the state.  Called on a
    shard thread, a forward runs that shard's module on the arguments it
    gets.  With ``keep_outputs`` every shard's result stays in
    ``last_outputs``."""

    def __init__(self, model: nn.Module, group):
        self.model = model
        self.group = group
        self.shards = [shard_module(model, group, r)
                       for r in range(group.size)]
        self.keep_outputs = False
        self.last_outputs = None

    def __getattr__(self, name):
        return getattr(self.__dict__["model"], name)

    def __call__(self, *args, **kwargs):
        return self._forward("__call__", args, kwargs)

    def apply_tokens(self, *args, **kwargs):
        return self._forward("apply_tokens", args, kwargs)

    def _forward(self, method: str, args, kwargs):
        group = self.group
        rank = group.rank()
        if rank is not None:
            return getattr(self.shards[rank], method)(*args, **kwargs)
        if group.sp > 1:
            raise RuntimeError("an sp group's forward runs inside the "
                               "pipeline's sharded step, on the shard "
                               "threads")
        kws: dict = {}

        def fn(r):
            dev = group.device(r)
            if r == 0:
                a, kw = args, kwargs
            else:
                contexts: dict = {}  # args and kwargs alive throughout
                a = _to(args, dev, contexts)
                kw = {k: (_private(v, dev) if k in PRIVATE
                          else _to(v, dev, contexts))
                      for k, v in kwargs.items()}
            kws[r] = kw
            return getattr(self.shards[r], method)(*a, **kw)

        outs = group.run(fn)
        state = kwargs.get("cache_state")
        if state:
            for r in range(1, group.size):
                for key, st in kws[r]["cache_state"].items():
                    if not isinstance(st, dict):
                        continue
                    for k, v in st.items():
                        if k.endswith(f"@{r}"):
                            state[key][k] = v
        if self.keep_outputs:
            self.last_outputs = outs
        return outs[0]

    def param_tensors(self):
        """Every shard's parameters and buffers."""
        for m in self.shards:
            yield from m.parameters()
            yield from m.buffers()
