"""The port's dp replicas against the JAX package on CPU.

- ``build_placements``: every replica ``cpu`` on the CPU; ``cuda:0..dp-1``
  by default and a repeated explicit index on the card (card counts
  stubbed here); too few cards raise "need n devices".
- ``GreedyDispatch``/``RoundRobinDispatch`` assign the same replicas as
  JAX's on random loads; an unknown policy raises JAX's error.
- A tiny float32 SD-1.5 ``Engine`` at dp=2 (the port's replicas on the
  CPU, JAX's on two of its 8 virtual CPU devices), with the same weights,
  requests and seeds, admitted in two waves: the same ``dp_rank`` per
  request and final latents within RTOL 2e-4 / ATOL 5e-4.  Each replica
  writes ``schedule_rank{r}.csv``; aborts reach every replica.
- Replicas on one device share one bundle; ``ModelBundle.replicate``
  copies the weights (another storage, the same latents).
- Prewarm's capacity gate counts what the first replica holds on the
  device before it admits the second replica's buckets.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.config import ParallelConfig as JaxParallelConfig
from sduss_tpu.dispatcher import GreedyDispatch as JaxGreedy
from sduss_tpu.dispatcher import RoundRobinDispatch as JaxRoundRobin
from sduss_tpu.dispatcher import get_dispatch_policy as jax_get_policy
from sduss_tpu.engine.engine import Engine as JaxEngine
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.dispatcher import (GreedyDispatch, RoundRobinDispatch,
                                        get_dispatch_policy)
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.parallel.replica import build_placements
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_sd15_slice import port_bundle
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
# two waves: the second is dispatched on the loads the first left
WAVES = [[128, 64], [64, 64]]
STEPS = 3


def _requests(cls, params_cls, wave: int, res_list):
    return [cls(f"w{wave}-{i}", params_cls(
        prompt=f"a cat number {wave} {i}", resolution=res,
        num_inference_steps=STEPS, seed=10 * wave + i, output_type="latent"))
        for i, res in enumerate(res_list)]


def _serve(engine, cls, params_cls):
    """Admit the two waves a step apart; run to the end.  Returns the
    requests and the outputs by id."""
    reqs, outs = [], {}
    for wave, res_list in enumerate(WAVES):
        batch = _requests(cls, params_cls, wave, res_list)
        reqs += batch
        engine.add_requests(batch)
        for o in engine.step():
            outs[o.request_id] = o
    while engine.has_unfinished_requests():
        for o in engine.step():
            outs[o.request_id] = o
    return reqs, outs


@pytest.fixture(scope="module")
def jax_dp2():
    config = JaxConfig()
    config.model = JaxModelConfig(model="sd15", dtype="float32",
                                  test_tiny=True, use_patched=False, seed=3)
    config.parallel = JaxParallelConfig(dp=2)
    config.scheduler.use_mixed_resolution = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        engine = JaxEngine(config)
    reqs, outs = _serve(engine, JaxRequest, JaxSamplingParams)
    return engine, reqs, outs


@pytest.fixture(scope="module")
def bundle(jax_dp2):
    class _Pipe:  # port_bundle reads jpipe.engine.workers[0]
        engine = jax_dp2[0]
    return port_bundle(_Pipe)


def port_config(dp: int = 2):
    config = default_config(dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.parallel.dp = dp
    return config


def test_placements(monkeypatch):
    """Each replica's device list: one device a replica here; a replica
    over an sp x tp group takes sp * tp entries (test_torch_multihost.py
    holds those against JAX's)."""
    assert build_placements(3, base="cpu") == [[torch.device("cpu")]] * 3
    assert build_placements(1, sp=2, base="cpu") == [[torch.device("cpu")]
                                                     * 2]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert build_placements(2) == [[d] for d in cuda]
    assert build_placements(1, base="cuda:1") == [cuda[1:]]
    assert build_placements(2, devices=[0, 0]) == [[cuda[0]]] * 2
    assert build_placements(2, devices=[1, 0, 1]) == [[d] for d in
                                                      cuda[::-1]]
    with pytest.raises(ValueError, match="need 3 devices"):
        build_placements(3)
    with pytest.raises(ValueError, match="need 2 devices"):
        build_placements(2, devices=[0])
    with pytest.raises(ValueError, match="outside"):
        build_placements(2, devices=[0, 2])


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_policies_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_rep = int(rng.integers(1, 5))
    res = rng.choice([256, 512, 768, 1024], size=int(rng.integers(1, 9)))
    reqs = [Request(f"r{i}", SamplingParams(prompt="", resolution=int(r)))
            for i, r in enumerate(res)]
    jreqs = [JaxRequest(f"r{i}", JaxSamplingParams(prompt="",
                                                   resolution=int(r)))
             for i, r in enumerate(res)]
    loads = [int(x) for x in rng.integers(0, 3, n_rep) * 512 * 512]
    assert GreedyDispatch().assign(reqs, loads) \
        == JaxGreedy().assign(jreqs, loads)
    rr, jrr = RoundRobinDispatch(), JaxRoundRobin()
    for _ in range(3):  # the cursor carries over calls
        assert rr.assign(reqs, loads) == jrr.assign(jreqs, loads)
    assert type(get_dispatch_policy("greedy")) is GreedyDispatch
    with pytest.raises(ValueError) as port_err:
        get_dispatch_policy("least_busy")
    with pytest.raises(ValueError) as jax_err:
        jax_get_policy("least_busy")
    assert str(port_err.value) == str(jax_err.value)


def test_dp2_engine_matches_jax(jax_dp2, bundle, tmp_path):
    jengine, jreqs, jouts = jax_dp2
    config = port_config()
    config.engine.collect_data = True
    config.engine.collect_dir = str(tmp_path)
    engine = Engine(config, "cpu", bundle=bundle)
    assert [w.rank for w in engine.workers] == [0, 1]
    assert engine.workers[0].pipeline.bundle is engine.workers[1].pipeline.bundle
    reqs, outs = _serve(engine, Request, SamplingParams)
    ranks = {r.request_id: r.dp_rank for r in reqs}
    assert ranks == {r.request_id: r.dp_rank for r in jreqs}
    # greedy on pending pixels: 128^2 to rank 0, then every 64^2 to rank 1
    assert ranks == {"w0-0": 0, "w0-1": 1, "w1-0": 1, "w1-1": 1}
    assert sorted(outs) == sorted(jouts)
    for rid, out in outs.items():
        want = np.asarray(jouts[rid].image)
        assert out.finished and out.image.shape == want.shape
        np.testing.assert_allclose(out.image, want, rtol=RTOL, atol=ATOL)
    assert engine.stats.summary("sd15")["finished"] == 4
    engine.dump_data()
    for r in (0, 1):
        assert (tmp_path / f"schedule_rank{r}.csv").read_text().count(
            "\n") == len(engine.workers[r].schedule_log) + 1


def test_aborts_and_unfinished_span_replicas(bundle):
    engine = Engine(port_config(), "cpu", bundle=bundle)
    for i in range(3):
        engine.add_request(f"a{i}", SamplingParams(
            prompt="a dog", resolution=64, num_inference_steps=50, seed=i,
            output_type="latent"))
    engine.step()
    assert [w.pending_pixels() for w in engine.workers] == [2 * 4096, 4096]
    engine.add_request("waiting", SamplingParams(prompt="x", resolution=64))
    outs = engine.abort_requests(["a1", "a2", "waiting"])
    assert sorted(o.request_id for o in outs) == ["a1", "a2", "waiting"]
    assert all(o.aborted for o in outs)
    assert engine.has_unfinished_requests()
    assert engine.workers[1].pending_pixels() == 0
    engine.abort_requests(["a0"])
    assert not engine.has_unfinished_requests()
    assert engine.stats.summary("sd15")["aborted"] == 4


def test_replicated_bundle_serves_the_same_latents(bundle):
    copy = bundle.replicate("cpu")
    for name, m in bundle.models.items():
        for (k, a), b in zip(m.state_dict().items(),
                             copy.models[name].state_dict().values()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    outs = []
    for b in (bundle, copy):
        engine = Engine(port_config(dp=1), "cpu", bundle=b)
        engine.add_request("x", SamplingParams(
            prompt="a fox", resolution=64, num_inference_steps=2, seed=4,
            output_type="latent"))
        while engine.has_unfinished_requests():
            outs += engine.step()
    assert np.array_equal(outs[0].image, outs[1].image)


def _gate_engine(bundle, dp: int):
    config = port_config(dp)
    config.scheduler.steps_per_dispatch = 4
    config.cache = CacheConfig.production("sd15", serving=True)
    config.engine.prewarm_hbm_margin = 0.0
    config.engine.async_prepare = False
    return Engine(config, "cpu", bundle=bundle)


@pytest.mark.parametrize("dp", [1, 2])
def test_capacity_gate_sees_the_other_replicas(bundle, dp, monkeypatch):
    """Room for bucket 2 once (its rows count twice under chunks): one
    replica admits bucket 2 and leaves ``max_batch_size`` as it was; with
    two on one device the first replica's step-set rows are held when the
    second one's gate runs, so it caps ``max_batch_size`` at 1."""
    engine = _gate_engine(bundle, dp)
    pipe = engine.workers[0].pipeline
    state2 = pipe.estimate_serving_state_bytes(64, 2)
    assert state2 > 0
    budget = pipe.device_param_bytes() + 2 * state2 + 1
    monkeypatch.setattr(engine, "_device_bytes", lambda device: budget)
    engine.prewarm(resolutions=(64,), buckets=(1, 2), steps=2)
    held = engine._held_bytes(torch.device("cpu"))
    assert held == pipe.device_param_bytes() + sum(
        w.pipeline._row_state_bytes() for w in engine.workers)
    assert engine.workers[0].pipeline._row_state_bytes() > 0
    assert engine.config.scheduler.max_batch_size == (12 if dp == 1 else 1)
    assert engine.stats.summary("sd15")["arrived"] == 0


def test_async_engine_serves_replicas_and_stats_rows(bundle):
    """``AsyncEngine`` over two replicas: both requests finish, one a
    replica, in one stats stream; /stats' rows (``device_stats``, read on
    the engine's thread) give each replica's load."""
    import asyncio

    from sduss_tpu_torch.engine.async_engine import AsyncEngine
    from sduss_tpu_torch.entrypoints.api_server import device_stats

    async def main():
        aengine = AsyncEngine(port_config(), engine=Engine(
            port_config(), "cpu", bundle=bundle))
        try:
            outs = await asyncio.gather(*(aengine.generate(SamplingParams(
                prompt="a cat", resolution=64, num_inference_steps=2,
                seed=i, output_type="latent")) for i in range(2)))
            rows = await aengine.call(device_stats)
        finally:
            await aengine.stop()
        return outs, rows, aengine.engine

    outs, rows, engine = asyncio.run(main())
    assert all(o.finished for o in outs)
    assert [w.iteration > 0 for w in engine.workers] == [True, True]
    assert engine.stats.summary("sd15")["finished"] == 2
    assert rows == [{"platform": "cpu", "dp_rank": r, "pending_pixels": 0,
                     "unfinished": 0, "state_bytes": 0} for r in (0, 1)]
