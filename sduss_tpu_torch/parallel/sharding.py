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
serves from.  Called on the pipeline's thread under tp alone it runs every
shard's forward and returns shard 0's.  With ``sp > 1`` every forward the
pipeline makes goes through one route (:meth:`ShardedDenoiser._sp_forward`),
whatever step made it: the inputs are split over ``sp`` (latent rows on the
dense path, contiguous ranges of patch rows on the patch path, token
columns on SD3's token path), each shard gets its context
(``parallel/displaced.py ShardContext`` / ``MMDiTShardContext``,
``ops/patch_ctx.py PatchShardContext``), the shards run the forward, and
the model output (and a UNet's deep feature) is gathered on the lead
device, where the sampler update and the bookkeeping stay.  The state a
forward updates in place (the caches' rows, SD3's span delta, the stale
K/V rows) lives on the shards between steps as :class:`ShardedTensor`
leaves of the caller's own state dicts, split like the activations it
caches; :func:`tmap` runs the pipeline's row carry-over and predictions on
every shard's part.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sduss_tpu_torch.ops.patch_ctx import PatchContext, PatchShardContext
from sduss_tpu_torch.ops.patching import shard_ranges
from sduss_tpu_torch.parallel.displaced import (MMDiTShardContext,
                                                ShardContext, gather_rows,
                                                shard_rows)

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


class ShardedTensor:
    """A state tensor of a replica over an sp group, kept as one part per
    shard (rank order, on the shard's device; None where a shard holds no
    such tensor), between the forwards that update it.  A part is the
    shard's slice of the whole (or a copy of it, for a tensor every shard
    holds whole); tp peers hold equal parts."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    def __repr__(self) -> str:
        shapes = [None if p is None else tuple(p.shape) for p in self.parts]
        return f"ShardedTensor({shapes})"


def tmap(fn, *trees):
    """``fn`` over the leaves of matching trees (tensors, ``ShardedTensor``
    leaves, dicts of them): a ``ShardedTensor`` leaf maps shard by shard
    (the other arguments' part of the same shard, or the argument itself),
    into a ``ShardedTensor``."""
    x0 = trees[0]
    if isinstance(x0, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in x0}
    if isinstance(x0, ShardedTensor):
        return ShardedTensor([
            None if p is None else fn(*(
                t.parts[r] if isinstance(t, ShardedTensor) else t
                for t in trees))
            for r, p in enumerate(x0.parts)])
    return fn(*trees)


def parts_of(tree):
    """Every tensor of a state tree, each shard's part of a
    ``ShardedTensor`` leaf included."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, ShardedTensor):
        yield from (p for p in tree.parts if p is not None)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from parts_of(v)


class SpStep:
    """What the pipeline's dense sp step (``pipelines/base.py
    _denoise_group_displaced``) passes as ``ctx``: stale K/V or a fresh
    gather, each rank's previous K/V (``kv``); the forward leaves each
    rank's new K/V in ``new_kv``."""

    def __init__(self, stale: bool = False, kv: Optional[dict] = None):
        self.stale = stale
        self.kv = kv or {}
        self.new_kv: Dict[int, dict] = {}


def _state_dim(kind: str, path: tuple, t: torch.Tensor):
    """The axis a state tensor splits on, like the activations it caches:
    the UNet's dense rows ``(R, C, s, s)`` on their height, a patch batch's
    rows on the patch axis, MMDiT token rows ``(R, S, ...)`` on the token
    axis (the context stream ``"c"`` whole); per-row vectors whole."""
    if kind == "patch":
        return 0
    if kind == "tokens":
        return None if path[-1] == "c" or t.dim() < 2 else 1
    return 2 if t.dim() == 4 else None


def _shard_leaves(tree: dict, split, n: int, kind: str, path=()) -> None:
    """Turn the plain tensor leaves of a caller's state tree into
    ``ShardedTensor`` leaves over ``n`` ranks, in place (once: later
    forwards find them); ``split(t, dim, rank)`` is a rank's part."""
    for k, v in list(tree.items()):
        if isinstance(v, dict):
            _shard_leaves(v, split, n, kind, path + (k,))
        elif isinstance(v, torch.Tensor):
            dim = _state_dim(kind, path + (k,), v)
            tree[k] = ShardedTensor([split(v, dim, r) for r in range(n)])


def _rank_tree(tree: dict, rank: int) -> dict:
    """Rank ``rank``'s state: new dicts over its parts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _rank_tree(v, rank)
        elif v.parts[rank] is not None:
            out[k] = v.parts[rank]
    return out


def _merge_back(tree: dict, ranks: List[dict]) -> None:
    """Write the ranks' updated states back into the caller's ``tree`` (its
    dicts kept): a key every rank dropped goes, any other leaf becomes the
    ranks' parts."""
    keys = list(dict.fromkeys(k for t in ranks for k in t))
    for k in [k for k in tree if k not in keys]:
        del tree[k]
    for k in keys:
        vals = [t.get(k) for t in ranks]
        if any(isinstance(v, dict) for v in vals):
            sub = tree.get(k)
            if not isinstance(sub, dict):
                sub = tree[k] = {}
            _merge_back(sub, [v if isinstance(v, dict) else {} for v in vals])
        else:
            tree[k] = ShardedTensor(vals)


def _sharded_tree(trees: List):
    """The ranks' output trees (SD3's span delta) as one tree of
    ``ShardedTensor`` leaves."""
    if isinstance(trees[0], dict):
        return {k: _sharded_tree([t[k] for t in trees]) for k in trees[0]}
    return ShardedTensor(trees)


def _split_tree(tree, split, kind: str, rank: int, path=()):
    """Rank ``rank``'s part of an input tree (a ``ShardedTensor`` leaf's
    part, a plain tensor split by ``_state_dim``)."""
    if isinstance(tree, dict):
        return {k: _split_tree(v, split, kind, rank, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return tree.parts[rank]
    return split(tree, _state_dim(kind, path, tree), rank)


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
        # each shard's patch-batch context of the latest compositions
        # (index tensors only): {(id(meta), rank): (meta, context)}
        self._patch_ctxs: collections.OrderedDict = collections.OrderedDict()

    def _patch_ctx(self, meta, rank: int):
        key = (id(meta), rank)
        hit = self._patch_ctxs.get(key)
        if hit is None or hit[0] is not meta:
            hit = (meta, PatchShardContext(meta, self.group, rank))
            self._patch_ctxs[key] = hit
            while len(self._patch_ctxs) > 8 * self.group.size:
                self._patch_ctxs.popitem(last=False)
        return hit[1]

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
            return self._sp_forward(method, args, kwargs)
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

    def _sp_forward(self, method: str, args, kwargs):
        """One forward over the sp x tp group (module docstring): the split
        follows the call's layout, ``apply_tokens`` (SD3's token path: token
        columns), a ``PatchContext`` (the patch batch: contiguous ranges of
        patch rows) or else the dense latents' rows, with ``ctx`` None (a
        sync step) or an :class:`SpStep`."""
        group = self.group
        lead = group.device(0)
        ctx = kwargs.get("ctx")
        args = list(args)
        ranges = None
        if method == "apply_tokens":
            kind = "tokens"
            mask = args[1].bool()
        elif isinstance(ctx, PatchContext):
            kind = "patch"
            ranges = shard_ranges(ctx.meta.p_pad, group.sp)
        else:
            kind = "rows"
            if ctx is not None and not isinstance(ctx, SpStep):
                raise TypeError(f"an sp forward takes no {type(ctx).__name__}")

        def split(t, dim, r):
            """Rank ``r``'s part of ``t`` split on ``dim``, a new tensor."""
            return shard_rows(t, group, "sp", dim, r, ranges=ranges,
                              copy=True)

        state = kwargs.get("cache_state")
        if state is not None:
            _shard_leaves(state, split, group.size, kind)
        mmdit = hasattr(self.model, "apply_tokens")

        def fn(r):
            dev = group.device(r)
            a = [None] + list(_to(args[1:], dev, {}))
            kw = {k: _to(v, dev, {}) for k, v in kwargs.items()
                  if k not in ("ctx", "cache_state", "deep_state")}
            if kind == "tokens":
                a[0] = split(args[0], 1, r)
                a[1] = split(mask, 1, r)
                kw["ctx"] = MMDiTShardContext(group, token_mask=a[1],
                                              key_mask=mask.to(dev))
            elif kind == "patch":
                a[0] = split(args[0], 0, r)
                kw["ctx"] = self._patch_ctx(ctx.meta, r)
            else:
                a[0] = split(args[0], 1, r)
                seam = ctx if ctx is not None else SpStep()
                kw["ctx"] = (MMDiTShardContext if mmdit else ShardContext)(
                    group, "sp", stale=seam.stale,
                    kv_state=seam.kv.get(r))
            deep = kwargs.get("deep_state")
            if deep is not None:
                kw["deep_state"] = (
                    _split_tree(deep, split, kind, r) if kind == "tokens"
                    else split(deep, 0 if kind == "patch" else 2, r))
            if state is not None:
                kw["cache_state"] = _rank_tree(state, r)
            return getattr(self.shards[r], method)(*a, **kw), kw

        outs = group.run(fn)
        if state is not None:
            _merge_back(state, [kw["cache_state"] for _, kw in outs])
        if isinstance(ctx, SpStep):
            ctx.new_kv = {r: kw["ctx"].new_kv_state
                          for r, (_, kw) in enumerate(outs)}
        if self.keep_outputs:
            self.last_outputs = [o for o, _ in outs]
        res = [o for o, _ in outs]
        out_dim = {"tokens": 1, "patch": 0, "rows": 1}[kind]
        if not isinstance(res[0], tuple):
            return gather_rows(res, group, out_dim, lead)
        joined = [gather_rows([o[0] for o in res], group, out_dim, lead)]
        for i in range(1, len(res[0])):
            items = [o[i] for o in res]
            if state is not None and items[0] is outs[0][1]["cache_state"]:
                joined.append(state)
            elif kind == "tokens":  # SD3's span delta: stays on the shards
                joined.append(_sharded_tree(items))
            else:  # a UNet's deep feature (NCHW)
                joined.append(gather_rows(items, group,
                                          0 if kind == "patch" else 2, lead))
        return tuple(joined)

    def param_tensors(self):
        """Every shard's parameters and buffers."""
        for m in self.shards:
            yield from m.parameters()
            yield from m.buffers()
