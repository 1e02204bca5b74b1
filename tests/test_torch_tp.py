"""Tensor parallelism in the port against the JAX package on CPU.

- The sharding rule table (``parallel/sharding.py param_rules``) against
  JAX's ``unet_param_shardings`` on the tiny SD-1.5 and SDXL UNets and the
  tiny MMDiT at tp=2 and tp=4: each JAX spec marked on its leaf and
  carried through ``jax_to_torch_state_dict``, so both tables are read in
  torch's layout and diffusers' names.  They agree on every weight, except
  where the port's guard leaves an attention replicated because its heads
  do not divide by tp (the tiny models' 2 heads at tp=4).
- Each tiny model's forward under tp=2 and tp=4 (a ``ShardedDenoiser`` on a
  CPU ``ShardGroup``) against JAX's GSPMD tp forward on its virtual CPU
  devices and against the port's single-device forward, float32, RTOL
  2e-4 / ATOL 5e-4; every shard's output bitwise equal.
- A tp forward rebuilds the patch context for another device from its
  ``meta`` on every forward: contexts made and freed one after another
  (so that their ids repeat) each reach the second shard as their own.
- The port's ``test_engine_dp2_tp2``: two tp=2 replicas of the tiny SD-1.5
  (four CPU shards) against JAX's dp=2 x tp=2 engine on the same weights,
  requests and seeds: the same dp ranks, latents within RTOL/ATOL.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.config import ParallelConfig as JaxParallelConfig
from sduss_tpu.engine.engine import Engine as JaxEngine
from sduss_tpu.models import mmdit as jmmdit
from sduss_tpu.models import unet as junet
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.parallel.mesh import make_mesh
from sduss_tpu.parallel.sharding import place_params, unet_param_shardings
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.models import mmdit as tmmdit
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.parallel.group import ShardGroup
from sduss_tpu_torch.parallel.sharding import (ColumnParallelConv2d,
                                               RowParallelConv2d,
                                               RowParallelLinear,
                                               ShardedDenoiser, param_rules)
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_dp import ATOL, RTOL, _serve, port_config
from test_torch_models import np_params
from test_torch_sd15_slice import port_bundle
from test_torch_slice import _np_init, torch_threads  # noqa: F401

# (port module, JAX module, JAX config name, converter role)
MODELS = {
    "sd15": (tunet.UNet2DConditionModel, junet.UNet2DConditionModel,
             "TINY_UNET", "unet"),
    "sdxl": (tunet.UNet2DConditionModel, junet.UNet2DConditionModel,
             "TINY_SDXL_UNET", "unet"),
    "sd3": (tmmdit.SD3Transformer2DModel, jmmdit.SD3Transformer2DModel,
            "TINY_MMDIT", "transformer"),
}
CASES = [(m, tp) for m in MODELS for tp in (2, 4)]
IDS = [f"{m}-tp{tp}" for m, tp in CASES]


def models(name: str):
    """(JAX model, JAX params, the port's model carrying them)."""
    tcls, jcls, cfg_name, role = MODELS[name]
    jm = jcls(getattr(junet if role == "unet" else jmmdit, cfg_name))
    p = np_params(jm.init, 0)
    tm = tcls(getattr(tunet if role == "unet" else tmmdit, cfg_name))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        jax_to_torch_state_dict(role, p).items()},
                       strict=True)
    return jm, p, tm.eval()


@pytest.fixture(scope="module")
def model_cache():
    return {}


def get(model_cache, name):
    if name not in model_cache:
        model_cache[name] = models(name)
    return model_cache[name]


def jax_table(jm, p, tp: int, role: str) -> dict:
    """JAX's shardings in torch's layout: ``{weight name: sharded dim or
    None}``, each spec marked on its leaf (the leaf's index along the
    sharded axis, -1 where replicated) and converted like the weights."""
    specs = unet_param_shardings(p, make_mesh(tp=tp))

    def mark(leaf, sh):
        axes = [i for i, a in enumerate(sh.spec) if a == "tp"]
        if not axes:
            return np.full(leaf.shape, -1.0, np.float32)
        return np.indices(leaf.shape)[axes[0]].astype(np.float32)

    marks = jax.tree.map(mark, p, specs)
    out = {}
    for name, arr in jax_to_torch_state_dict(role, marks).items():
        if not name.endswith("weight") or arr.ndim < 2:
            continue
        if (arr == -1).all():
            out[name] = None
            continue
        varies = [d for d in range(arr.ndim)
                  if not (np.take(arr, [0], axis=d) == arr).all()]
        assert len(varies) == 1, name
        out[name] = varies[0]
    return out


@pytest.mark.parametrize("name,tp", CASES, ids=IDS)
def test_rule_table_matches_jax(model_cache, name, tp):
    jm, p, tm = get(model_cache, name)
    want = jax_table(jm, p, tp, MODELS[name][3])
    rules = param_rules(tm, tp)
    heads = {n: getattr(m, "heads", None) or m.cfg.num_heads
             for n, m in tm.named_modules()
             if hasattr(m, "to_q") and hasattr(m, "to_k")}
    guarded = set()
    for wname, jdim in want.items():
        rule = rules.get(wname)
        pdim = None if rule is None else rule[1]
        owner = next((a for a in heads if wname.startswith(a + ".")), None)
        if owner is not None and heads[owner] % tp and jdim is not None:
            assert pdim is None, wname  # the attention divisibility guard
            guarded.add(owner)
            continue
        assert pdim == jdim, (wname, pdim, jdim)
    assert guarded == {a for a, h in heads.items() if h % tp}
    # the port also slices the biases of column-parallel layers and the
    # GroupNorm between a resnet's sharded convs (GSPMD reshards them)
    for key, (kind, dim) in rules.items():
        if key.endswith("bias"):
            assert rules[key[:-4] + "weight"][0] == kind != "row"
        if kind == "norm":
            conv1 = key.rsplit(".", 2)[0] + ".conv1.weight"
            assert rules[conv1] == ("column", 0)


def inputs(name: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    if name == "sd3":
        cfg = jmmdit.TINY_MMDIT
        return (rng.standard_normal((2, 16, 16, cfg.in_channels)),
                np.array([500.0, 250.0]),
                rng.standard_normal((2, 9, cfg.joint_attention_dim)),
                rng.standard_normal((2, cfg.pooled_projection_dim))), {}
    cfg = getattr(junet, MODELS[name][2])
    args = (rng.standard_normal((2, 16, 16, 4)), np.array([500.0, 250.0]),
            rng.standard_normal((2, 7, cfg.cross_attention_dim)))
    kw = {}
    if cfg.addition_embed is not None:
        add_dim, pooled_dim, n_ids = cfg.addition_embed
        kw = {"added_cond": {
            "text_embeds": rng.standard_normal((2, pooled_dim)),
            "time_ids": rng.standard_normal((2, n_ids))}}
    return args, kw


def _f32(tree, fn):
    if isinstance(tree, dict):
        return {k: _f32(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v, fn) for v in tree]
    return fn(np.asarray(tree, np.float32))


@pytest.mark.parametrize("name,tp", CASES, ids=IDS)
def test_tp_forward_matches_jax(model_cache, name, tp):
    jm, p, tm = get(model_cache, name)
    args, kw = inputs(name)
    mesh = make_mesh(tp=tp)
    placed = place_params(p, unet_param_shardings(p, mesh))
    jout = np.asarray(jax.jit(jm.apply)(
        placed, *_f32(list(args), jax.numpy.asarray),
        **_f32(kw, jax.numpy.asarray)))
    group = ShardGroup(["cpu"] * tp, tp=tp)
    den = ShardedDenoiser(tm, group)
    den.keep_outputs = True
    targs = _f32(list(args), torch.from_numpy)
    tkw = _f32(kw, torch.from_numpy)
    with torch.inference_mode():
        got = den(*targs, **tkw)
        single = tm(*targs, **tkw)
    np.testing.assert_allclose(got.numpy(), jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert all(torch.equal(o, den.last_outputs[0])
               for o in den.last_outputs[1:])
    group.close()


def test_shard_modules(model_cache):
    """Row-parallel layers reduce over tp and hold a slice of the in dim;
    the attention runs at its local heads; a dim-0 slice is a view of the
    model's tensor and replicated weights are the model's own."""
    _, _, tm = get(model_cache, "sdxl")
    group = ShardGroup(["cpu"] * 2, tp=2)
    den = ShardedDenoiser(tm, group)
    for r, shard in enumerate(den.shards):
        res = shard.down_blocks[1].resnets[0]
        full = tm.down_blocks[1].resnets[0]
        assert isinstance(res.conv1, ColumnParallelConv2d)
        assert isinstance(res.conv2, RowParallelConv2d)
        assert res.conv1.weight.shape[0] == full.conv1.weight.shape[0] // 2
        assert res.conv1.weight.data_ptr() == full.conv1.weight[
            r * res.conv1.weight.shape[0]:].data_ptr()
        assert res.norm2.num_groups == full.norm2.num_groups // 2
        assert res.norm1.weight is full.norm1.weight
        blk = shard.down_blocks[1].attentions[0].transformer_blocks[0]
        assert blk.attn1.heads == 1 and isinstance(blk.attn1.to_out[0],
                                                   RowParallelLinear)
        assert blk.ff.net[0].proj.weight.shape[0] == \
            tm.down_blocks[1].attentions[0].transformer_blocks[0].ff.net[
                0].proj.weight.shape[0] // 2
    group.close()


class _Ctx:
    """A stand-in patch context: ``meta`` and an ``image_id`` tensor."""

    def __init__(self, meta, device):
        self.meta = meta
        self.image_id = torch.zeros(1, device=device)


class _Echo(torch.nn.Module):
    """Returns the meta of the context its shard was given, and where."""

    def forward(self, x, ctx=None):
        return ctx.meta, x.device, ctx.image_id.device


def test_contexts_rebuilt_per_forward():
    """A tp forward on two devices ('cpu' and 'meta'): the second shard
    gets a context rebuilt from each step's own, though each step's is
    freed before the next is made (so that their ids repeat)."""
    other = torch.device("meta")
    group = ShardGroup(["cpu", other], tp=2)
    den = ShardedDenoiser(_Echo(), group)
    den.keep_outputs = True
    try:
        for step in range(50):
            ctx = _Ctx(("composition", step), "cpu")
            den(torch.ones(1), ctx=ctx)
            assert den.last_outputs == [
                (ctx.meta, torch.device("cpu"), torch.device("cpu")),
                (ctx.meta, other, other)]
            del ctx
    finally:
        group.close()


@pytest.fixture(scope="module")
def jax_dp2_tp2():
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, use_patched=False, seed=3)
    config.parallel = JaxParallelConfig(dp=2, tp=2)
    config.scheduler.use_mixed_resolution = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        engine = JaxEngine(config)
    reqs, outs = _serve(engine, JaxRequest, JaxSamplingParams)
    return engine, reqs, outs


def test_engine_dp2_tp2(jax_dp2_tp2):
    jengine, jreqs, jouts = jax_dp2_tp2

    class _Pipe:
        engine = jengine

    config = port_config(dp=2)
    config.parallel.tp = 2
    engine = Engine(config, "cpu", bundle=port_bundle(_Pipe))
    assert [len(w.pipeline.devices) for w in engine.workers] == [2, 2]
    assert all(w.pipeline.group.tp == 2 for w in engine.workers)
    reqs, outs = _serve(engine, Request, SamplingParams)
    assert ({r.request_id: r.dp_rank for r in reqs}
            == {r.request_id: r.dp_rank for r in jreqs})
    assert sorted(outs) == sorted(jouts)
    for rid, out in outs.items():
        np.testing.assert_allclose(out.image, np.asarray(jouts[rid].image),
                                   rtol=RTOL, atol=ATOL)
