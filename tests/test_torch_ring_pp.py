"""Ring attention, the MMDiT stage pipeline and device meshes in the port
against the JAX package on CPU.

- ``ring_attention`` on a CPU ``ShardGroup`` against JAX's under
  ``shard_map`` (sp=4 on JAX's virtual CPU devices) and against plain
  attention over the whole sequence; its statistics folded with an extra
  key block (``combine_partials``) against JAX's.
- ``MMDiTShardContext`` with ``kv_mode="ring"``: a sync trajectory of the
  tiny MMDiT on two shards against JAX's and against the dense one.
- ``split_spans`` equal to JAX's; ``MMDiTStagePipeline`` (the whole model,
  or ``stage_params_fn`` streaming each stage's tensors) bitwise equal to
  the single-device forward of each microbatch for 1-3 stages and every
  microbatch split, and within tolerance of the whole batch's forward and
  of JAX's stage pipeline.
- ``make_mesh``'s layout equal to JAX's on the same device indices.
Float32, RTOL 2e-4 / ATOL 5e-4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sduss_tpu.models import mmdit as jmmdit
from sduss_tpu.parallel import displaced as jdisp
from sduss_tpu.parallel import mesh as jmesh
from sduss_tpu.parallel import pipeline as jpipeline
from sduss_tpu.parallel import ring as jring
from sduss_tpu_torch.models import layers as TL
from sduss_tpu_torch.parallel import displaced as tdisp
from sduss_tpu_torch.parallel import mesh as tmesh
from sduss_tpu_torch.parallel import pipeline as tpipeline
from sduss_tpu_torch.parallel import ring as tring
from sduss_tpu_torch.parallel.group import ShardGroup
from test_torch_dp import ATOL, RTOL
from test_torch_slice import torch_threads  # noqa: F401
from test_torch_sp import _runners
from test_torch_tp import get, model_cache  # noqa: F401

SEQ = P(None, "sp", None)


def _qkv(seed=0, b=2, s=32, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)).astype(np.float32)
            for _ in range(3)]


def _port_ring(q, k, v, n, heads, extra=None):
    """The port's ring attention on ``n`` CPU shards, the sequence split on
    its rows; with ``extra`` (k, v) the statistics take that block too."""
    group = ShardGroup(["cpu"] * n, sp=n)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))

    def local(rank):
        args = [tdisp.shard_rows(a, group, "sp", 1, rank)
                for a in (tq, tk, tv)]
        if extra is None:
            return tring.ring_attention(*args, heads, group)
        o, m, l = tring.ring_attention(*args, heads, group, return_stats=True)
        ek, ev = (torch.from_numpy(a) for a in extra)
        o2, m2, l2 = tring._partial_dense(args[0], ek, ev, heads,
                                          1.0 / np.sqrt(q.shape[-1] // heads))
        return tring.combine_partials(o, m, l, o2, m2, l2, torch.float32)

    out = tdisp.gather_rows(group.run(local), group, 1, "cpu")
    group.close()
    return out.numpy()


@pytest.mark.parametrize("n,heads", [(2, 4), (4, 2)])
def test_ring_matches_jax_and_dense(n, heads):
    q, k, v = _qkv()
    fn = shard_map(functools.partial(jring.ring_attention, num_heads=heads,
                                     axis_name="sp"),
                   mesh=jmesh.make_mesh(sp=n), in_specs=(SEQ, SEQ, SEQ),
                   out_specs=SEQ)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v))))
    got = _port_ring(q, k, v, n, heads)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    dense = TL.attention(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    np.testing.assert_allclose(got, dense.numpy(), rtol=RTOL, atol=ATOL)


def test_ring_stats_with_an_extra_block():
    q, k, v = _qkv(1)
    ek, ev = _qkv(2, s=9)[:2]
    heads, n = 4, 4

    def local(q, k, v, ek, ev):
        o, m, l = jring.ring_attention(q, k, v, heads, "sp",
                                       return_stats=True)
        o2, m2, l2 = jring._partial_dense(q, ek, ev, heads,
                                          1.0 / np.sqrt(32 // heads))
        return jring.combine_partials(o, m, l, o2, m2, l2, q.dtype)

    fn = shard_map(local, mesh=jmesh.make_mesh(sp=n),
                   in_specs=(SEQ, SEQ, SEQ, P(), P()), out_specs=SEQ)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v, ek, ev))))
    got = _port_ring(q, k, v, n, heads, extra=(ek, ev))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = TL.attention(torch.from_numpy(q),
                        torch.from_numpy(np.concatenate([k, ek], 1)),
                        torch.from_numpy(np.concatenate([v, ev], 1)), heads)
    np.testing.assert_allclose(got, full.numpy(), rtol=RTOL, atol=ATOL)


def test_mmdit_ring_context_matches_jax(model_cache, monkeypatch):
    """The ring seam of the tiny MMDiT (joint attention: the latent ring
    plus the replicated context folded in; dual attention: the ring
    alone), a sync trajectory of two shards."""
    monkeypatch.setattr(jdisp, "MMDiTShardContext", functools.partial(
        jdisp.MMDiTShardContext, kv_mode="ring"))
    monkeypatch.setattr(tdisp, "MMDiTShardContext", functools.partial(
        tdisp.MMDiTShardContext, kv_mode="ring"))
    run_jax, run_port, run_dense = _runners(model_cache, "sd3", 10**9, 2)
    got = run_port(3)
    np.testing.assert_allclose(got, run_jax(3), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, run_dense(3), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_blocks,n_stages", [
    (24, 4), (5, 2), (9, 6), (24, 7), (13, 5), (8, 3), (3, 3), (1, 1)])
def test_split_spans_equal_jax(n_blocks, n_stages):
    assert tpipeline.split_spans(n_blocks, n_stages) == \
        jpipeline.split_spans(n_blocks, n_stages)


def test_split_spans_refuses_like_jax():
    for args in ((4, 0), (4, 5)):
        with pytest.raises(ValueError) as port:
            tpipeline.split_spans(*args)
        with pytest.raises(ValueError) as want:
            jpipeline.split_spans(*args)
        assert str(port.value) == str(want.value)


def _stage_inputs(b=4, seed=0):
    rng = np.random.default_rng(seed)
    cfg = jmmdit.TINY_MMDIT
    return (rng.standard_normal((b, 16, 16, cfg.in_channels)).astype(
                np.float32),
            np.linspace(100.0, 900.0, b).astype(np.float32),
            rng.standard_normal((b, 10, cfg.joint_attention_dim)).astype(
                np.float32),
            rng.standard_normal((b, cfg.pooled_projection_dim)).astype(
                np.float32))


@pytest.mark.parametrize("stages,n_micro", [(1, None), (2, None), (2, 1),
                                             (2, 3), (3, 4)])
def test_stage_pipeline_equals_one_device(model_cache, stages, n_micro):
    """Bitwise the single-device forward of each microbatch (a GEMM of
    another height may sum in another order), within tolerance of the
    whole batch's."""
    jm, p, tm = get(model_cache, "sd3")
    args = [torch.from_numpy(a) for a in _stage_inputs()]
    n_stages = min(stages, tm.cfg.num_layers)
    pipe = tpipeline.MMDiTStagePipeline(tm, ["cpu"] * n_stages,
                                        n_micro=n_micro)
    assert pipe.spans == jpipeline.split_spans(tm.cfg.num_layers, n_stages)
    b = args[0].shape[0]
    n = max(1, min(n_micro or min(b, n_stages), b))
    idx = [round(i * b / n) for i in range(n + 1)]
    with torch.inference_mode():
        whole = tm(*args)
        want = torch.cat([tm(*(a[lo:hi] for a in args))
                          for lo, hi in zip(idx, idx[1:]) if lo < hi])
    got = pipe(*args)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)
    if n_stages > 1:
        # a stage on the model's device shares its tensors
        blk = pipe.stages[-1].transformer_blocks[0]
        assert blk.attn.to_q.weight.data_ptr() == tm.transformer_blocks[
            pipe.spans[-1][0]].attn.to_q.weight.data_ptr()
    jpipe = jpipeline.MMDiTStagePipeline(jm, p, jax.devices()[:n_stages],
                                         n_micro=n_micro)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpipe(*(jnp.asarray(a) for a in
                                        _stage_inputs()))),
        rtol=RTOL, atol=ATOL)


def test_stage_pipeline_streams_each_stage(model_cache):
    """``stage_params_fn`` hands each stage its own tensors only; the
    result is the single-device forward's."""
    _, _, tm = get(model_cache, "sd3")
    full = tm.state_dict()
    asked = []

    def stage_params(stage, lo, hi):
        asked.append((stage, lo, hi))
        keep = [k for k in full if not k.startswith("transformer_blocks.")
                or lo <= int(k.split(".")[1]) < hi]
        return {k: full[k].clone() for k in keep}

    pipe = tpipeline.MMDiTStagePipeline(devices=["cpu", "cpu"],
                                        stage_params_fn=stage_params,
                                        cfg=tm.cfg, n_micro=1)
    assert asked == [(0, 0, 1), (1, 1, 2)]
    assert not hasattr(pipe.stages[1], "pos_embed")
    assert not hasattr(pipe.stages[0], "proj_out")
    args = [torch.from_numpy(a) for a in _stage_inputs(2, 3)]
    with torch.inference_mode():
        assert torch.equal(pipe(*args), tm(*args))
    with pytest.raises(ValueError, match="exactly one"):
        tpipeline.MMDiTStagePipeline(tm, ["cpu"], stage_params_fn=stage_params)


@pytest.mark.parametrize("dp,tp,sp,pp", [(1, 4, 1, 1), (2, 2, 2, 1),
                                         (1, 1, 8, 1), (2, 1, 2, 2),
                                         (1, 2, 2, 2)])
def test_mesh_layout_equals_jax(dp, tp, sp, pp):
    jdevs = jax.devices()
    want = jmesh.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, devices=jdevs)
    got = tmesh.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, devices=[
        torch.device("cpu", d.id) for d in jdevs])
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.index)(got.devices)
    np.testing.assert_array_equal(ids, np.vectorize(lambda d: d.id)(
        want.devices))
    if pp > 1:
        stages = [torch.nn.Linear(2, 2) for _ in range(pp)]
        placed = tmesh.pp_stage_params(stages, got)
        assert len(placed) == pp
        with pytest.raises(ValueError, match="stages for pp"):
            tmesh.pp_stage_params(stages[:1], got)
    with pytest.raises(ValueError, match="need"):
        tmesh.make_mesh(dp=dp * 9, tp=tp, sp=sp, pp=pp,
                        devices=["cpu"] * 8)
