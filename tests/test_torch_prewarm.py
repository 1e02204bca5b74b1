"""``Engine.prewarm`` and the step-graph cache on the CPU (tiny SD-1.5,
64 px, float32).

- An Engine with ``steps_per_dispatch=4`` and ``engine.prewarm`` serves,
  after ``prewarm()``, the same final latents as per-step dispatch, and a
  spy on the pipeline shows the worker's 4-step chunks (cache-off and the
  serving preset ``production("sd15", serving=True)`` with a request
  admitted mid-flight under ESyMReD).
- The capacity gate caps ``max_batch_size`` at the last bucket whose
  state fits when ``torch.cuda.mem_get_info`` reports too little.
- Prewarm over several buckets keeps the row state, the composition
  stores' and the step sets' buffers together, within
  ``comp_state_bytes``, dropping the oldest idle sets; the capacity gate
  counts the row state held; ``release_serving_state`` drops every set
  holding rows.
- ``AsyncEngine`` calls ``prewarm`` when ``engine.prewarm`` is set.
- The graph cache's bookkeeping with stand-ins for the CUDA graph API: a
  capture takes its launches off the counters and every replay adds
  them; emulated graphs (a replay runs the captured step eagerly) serve a
  hybrid row-warmup run across composition changes exactly as eager
  steps do, capturing each step kind once, with the entries' rows living
  in one buffer per step set and no request holding a view of a buffer.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.async_engine import AsyncEngine
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.ops.flash import flash_mha_fused
from sduss_tpu_torch.pipelines import graphs as graphs_mod
from sduss_tpu_torch.request import SamplingParams
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4


@pytest.fixture(scope="module")
def bundle():
    b = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    b.init_random(seed=0)
    return b


def config_for(cache: str, spd: int):
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.scheduler.steps_per_dispatch = spd
    config.engine.prewarm = spd > 1
    config.engine.async_prepare = False
    config.engine.async_postprocess = False
    if cache == "serving":
        config.cache = CacheConfig.production("sd15", serving=True)
        config.scheduler.policy = "esymred"
        config.scheduler.slo_scale = 1e4
    return config


def serve(engine, steps_taken, steps: int = 12):
    """Two requests, a third once ``steps_taken()`` denoising steps have
    run (3: the serving preset's warmup, stepped one at a time under
    either dispatch); returns the final latents by request id."""
    for i in range(2):
        engine.add_request(f"r{i}", SamplingParams(
            prompt=f"p{i}", resolution=64, num_inference_steps=steps, seed=i,
            output_type="latent"))
    outs, admitted = [], False
    while engine.has_unfinished_requests():
        outs += engine.step()
        if not admitted and steps_taken() >= 3:
            engine.add_request("r2", SamplingParams(
                prompt="p2", resolution=64, num_inference_steps=steps,
                seed=2, output_type="latent"))
            admitted = True
    return {o.request_id: o.image for o in outs}


@pytest.mark.parametrize("cache", ["off", "serving"])
def test_prewarmed_chunks_serve_per_step_latents(cache, bundle):
    got = {}
    for spd in (1, 4):
        engine = Engine(config_for(cache, spd), "cpu", bundle=bundle)
        pipe = engine.workers[0].pipeline
        log, chunks = [], []
        step, chunk = pipe.denoise_step, pipe.denoise_chunk

        def spy_step(by_res, step=step, log=log):
            log.append(1)
            return step(by_res)

        def spy_chunk(by_res, k, chunk=chunk, log=log, chunks=chunks):
            ok = chunk(by_res, k)
            if ok:
                chunks.append(k)
                log.append(k)
            return ok

        if spd > 1:
            assert engine.prewarm(resolutions=(64,), buckets=(2, 4)) > 0
            assert engine.stats.summary()["arrived"] == 0
        pipe.denoise_step, pipe.denoise_chunk = spy_step, spy_chunk
        got[spd] = serve(engine, lambda log=log: sum(log))
        if spd > 1:
            assert 4 in chunks, chunks
    assert sorted(got[1]) == sorted(got[4]) == ["r0", "r1", "r2"]
    for rid in got[1]:
        np.testing.assert_allclose(got[4][rid], got[1][rid], rtol=RTOL,
                                   atol=ATOL)
        assert np.isfinite(got[4][rid]).all()


def test_capacity_gate_caps_max_batch_size(bundle, monkeypatch):
    config = config_for("serving", 4)
    config.engine.prewarm_hbm_margin = 0.0
    engine = Engine(config, "cpu", bundle=bundle)
    pipe = engine.workers[0].pipeline
    state2 = pipe.estimate_serving_state_bytes(64, 2)
    assert 0 < state2 < pipe.estimate_serving_state_bytes(64, 4)
    # room for bucket 2's rows twice (a composition's rows are copied
    # into its step set's buffer), not bucket 4's
    total = pipe.device_param_bytes() + 2 * state2 + 1
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (total, total))
    engine.workers[0].device = torch.device("cuda")  # the card's memory is read
    engine.prewarm(resolutions=(64,), buckets=(1, 2, 4), steps=2)
    assert config.scheduler.max_batch_size == 2


def test_prewarm_keeps_row_state_within_budget(bundle, monkeypatch):
    config = config_for("serving", 4)
    config.engine.prewarm_hbm_margin = 0.0
    engine = Engine(config, "cpu", bundle=bundle)
    pipe = engine.workers[0].pipeline
    unit = pipe.estimate_serving_state_bytes(64, 1)
    assert pipe.estimate_serving_state_bytes(64, 4) == 4 * unit
    # buckets 1, 2 and 4 leave 7 units of rows in their step sets
    budget = 5 * unit + 1
    config.cache.comp_state_bytes = budget
    engine.prewarm(resolutions=(64,), buckets=(1, 2, 4))
    held = pipe.graphs.row_states()
    assert pipe._row_state_bytes() == 4 * unit == sum(
        t.numel() * t.element_size() for tree in held
        for _, t in graphs_mod._leaves(tree))
    assert not pipe._comp_state and len(held) == 1
    # the gate counts the rows held: bucket 2 fits alone, not beside them
    total = pipe.device_param_bytes() + 2 * 2 * unit + 1
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (total, total))
    engine.workers[0].device = torch.device("cuda")
    assert not engine._bucket_fits(pipe, 64, 2)
    pipe.release_serving_state()
    assert pipe.graphs.row_states() == [] and pipe._row_state_bytes() == 0
    assert engine._bucket_fits(pipe, 64, 2)
    engine.workers[0].device = torch.device("cpu")
    out = serve(engine, lambda: 3, steps=8)
    assert sorted(out) == ["r0", "r1", "r2"]
    assert pipe._row_state_bytes() <= budget


@pytest.mark.parametrize("prewarm", [False, True])
def test_async_engine_calls_prewarm(prewarm, bundle, monkeypatch):
    calls = []
    monkeypatch.setattr(Engine, "prewarm", lambda self: calls.append(self))
    config = config_for("off", 1)
    config.engine.prewarm = prewarm
    engine = Engine(config, "cpu", bundle=bundle)
    AsyncEngine(config, engine=engine)
    assert calls == ([engine] if prewarm else [])


class _FakeGraph:
    def __init__(self, fn=None):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        if self.fn is not None:
            self.fn()


def test_capture_takes_launches_off_and_replays_add_them(monkeypatch):
    """With stand-ins for ``torch.cuda``'s graph API (the captured body
    runs once, like the capture's trace; a replay runs nothing), a kind's
    first run is eager plus a capture, later runs are replays, and the
    counters count two launches a run."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None, stream=None,
                        capture_error_mode=None: contextlib.nullcontext())
    g = graphs_mod.StepGraphs(torch.device("cpu"))
    g.live = True
    waited = []
    g.before_capture = lambda: waited.append(1)
    traced = []

    def step(bufs):
        traced.append(1)
        flash_mha_fused.launches += 2

    sset = g.step_set(("test",))
    n0 = flash_mha_fused.launches
    for _ in range(3):
        sset.run("full", step)
    assert flash_mha_fused.launches - n0 == 6
    assert len(traced) == 2  # the eager step and the capture's trace
    assert (g.captures, g.replays, g.held(), waited) == (1, 2, 1, [1])
    assert g.step_set(("test",)) is sset


def _rowwarm_run(bundle, emulate: bool, monkeypatch):
    """SD-1.5's serving preset at interval 4, three 64 px requests, a
    fourth admitted after 5 steps, chunks of 3 on the CPU; with
    ``emulate`` the step graphs are live and a replay runs the captured
    step.  Returns the latents, the pipeline and the step sets' row
    buffers seen by the entries."""
    config = config_for("serving", 3)
    config.cache = dataclasses.replace(config.cache, deep_interval=4,
                                       deep_warmup=1)
    engine = Engine(config, "cpu", bundle=bundle)
    pipe = engine.workers[0].pipeline
    if emulate:
        pipe.graphs.live = True
        monkeypatch.setattr(
            pipe.graphs, "capture",
            lambda fn: (pipe.graphs.__dict__.__setitem__(
                "captures", pipe.graphs.captures + 1), (_FakeGraph(fn),
                                                         (0,) * 5))[1])
    ptrs = set()
    chunk = pipe.denoise_chunk

    def spy(by_res, k):
        ok = chunk(by_res, k)
        if ok:
            ptrs.update(e["state"]["down0.0"]["inp"].data_ptr()
                        for e in pipe._comp_state.values()
                        if e["state"]["down0.0"]["inp"].shape[0] == 8)
            for s in pipe.graphs._sets.values():
                for r in (r for rs in by_res.values() for r in rs):
                    assert r.latents.data_ptr() != s.bufs["lat"].data_ptr()
        return ok

    pipe.denoise_chunk = spy
    for i in range(3):
        engine.add_request(f"r{i}", SamplingParams(
            prompt=f"p{i}", resolution=64, num_inference_steps=14, seed=i,
            output_type="latent"))
    outs = []
    for _ in range(5):
        outs += engine.step()
    engine.add_request("r3", SamplingParams(
        prompt="p3", resolution=64, num_inference_steps=14, seed=3,
        output_type="latent"))
    while engine.has_unfinished_requests():
        outs += engine.step()
    return {o.request_id: o.image for o in outs}, pipe, ptrs


def test_emulated_graphs_serve_like_eager_steps(bundle, monkeypatch):
    eager, _, _ = _rowwarm_run(bundle, False, monkeypatch)
    got, pipe, ptrs = _rowwarm_run(bundle, True, monkeypatch)
    g = pipe.graphs
    assert g.captures == g.held() > 0 and g.replays > 0
    # both compositions of bucket 4 ran their chunks on one row buffer
    assert len(ptrs) == 1
    assert sorted(got) == sorted(eager) == ["r0", "r1", "r2", "r3"]
    for rid in got:
        np.testing.assert_array_equal(got[rid], eager[rid])
