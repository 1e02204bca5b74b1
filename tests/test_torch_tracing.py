"""The port's recorder of spans and counters (``sduss_tpu_torch/tracing.py``)
and the operator's ``EngineStats.summary``, on the CPU (tiny SD-1.5, 64
px, float32).

- With ``engine.collect_data`` off nothing is recorded, ``span()`` returns
  the shared no-op, and spans, phases and counts allocate nothing.
- The recorder's own rules: phases end with their span, counts land on
  the ``stage.*`` span open on the thread, a full deque counts its drops.
- With it on, an engine under ``CacheConfig.production("sd15",
  serving=True)`` (ESyMReD, a request admitted mid-flight, so that partial
  steps run) records one ``engine.step`` an iteration with one
  ``worker.schedule`` and at most one ``stage.*`` under it; children lie
  inside their parents on their thread; the request ids of each
  ``stage.denoise`` are its batch's; its modes are ``pipe.step_modes``;
  the request-steps sum to requests x steps; the gate pairs are the
  ``cache.gate`` spans' times the real rows, the fresh ones what each
  gate's recorded capacity admits; and ``dump_data`` writes ``spans.csv``
  and ``counters.json``.  No test compares timings.
- The same counts on fused chunks (dense, with partial steps) and on the
  patch path's image gates (steps and a chunk), against the deep steps
  that ran and the gates' own capacities.
- ``EngineStats.summary``: an abort is a missed deadline, percentiles are
  nearest-rank.
"""

from __future__ import annotations

import collections
import csv
import json
import os
import sys
import threading
import tracemalloc

import pytest
import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.metrics import EngineStats, RequestRecord
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from test_torch_slice import torch_threads  # noqa: F401

STEPS = 12


@pytest.fixture(autouse=True)
def recorder_off_after():
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def bundle():
    b = ModelBundle("sd15", tiny=True, dtype=torch.float32, device="cpu")
    b.init_random(seed=0)
    return b


def serving_config(collect: bool, out_dir: str = "outputs"):
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    config.cache = CacheConfig.production("sd15", serving=True)
    config.scheduler.policy = "esymred"
    config.scheduler.slo_scale = 1e4
    config.engine.collect_data = collect
    config.engine.collect_dir = out_dir
    return config


def serve(engine, batches: list) -> list:
    """Two requests, a third once three denoising dispatches have run;
    ``batches`` gets each dispatch's request ids.  Returns the outputs."""
    pipe = engine.workers[0].pipeline
    step = pipe.denoise_step

    def spy(by_res):
        batches.append([r.request_id for res in sorted(by_res)
                        for r in by_res[res]])
        return step(by_res)

    pipe.denoise_step = spy
    for i in range(2):
        engine.add_request(f"r{i}", SamplingParams(
            prompt=f"p{i}", resolution=64, num_inference_steps=STEPS, seed=i,
            output_type="latent"))
    outs, admitted = [], False
    while engine.has_unfinished_requests():
        outs += engine.step()
        if not admitted and len(batches) >= 3:
            engine.add_request("r2", SamplingParams(
                prompt="p2", resolution=64, num_inference_steps=STEPS,
                seed=2, output_type="latent"))
            admitted = True
    return outs


def test_off_records_nothing_and_allocates_nothing(bundle):
    tracing.reset()
    tracing.enable(True)
    engine = Engine(serving_config(False), "cpu", bundle=bundle)
    assert not tracing.enabled()
    assert tracing.span("stage.denoise") is tracing.NOOP
    assert not tracing.span("engine.step", [])
    outs = serve(engine, [])
    assert sorted(o.request_id for o in outs) == ["r0", "r1", "r2"]
    assert tracing.spans() == []
    assert tracing.counters() == {"dropped": 0, "recorded": 0}
    assert engine.workers[0].schedule_log == []

    reqs = engine.workers[0].scheduler.pool

    def burst(n):
        for _ in range(n):
            with tracing.span("stage.denoise", reqs) as sp:
                if sp:
                    sp.set(rows=1)
                tracing.phase("denoise.forward")
                with tracing.span("cache.gate"):
                    tracing.count("pairs", 3)

    burst(100)
    tracemalloc.start()
    try:
        burst(100)
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[1]
        burst(10000)
        grown = tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()
    # 10,000 spans off: nothing per span (a byte a span would be 10 kB)
    assert grown < 2048, grown
    assert tracing.spans() == []


def test_phases_counts_and_drops(monkeypatch):
    tracing.reset()
    tracing.enable(True)
    tracing.phase("outside")  # no span open: nothing
    with tracing.span("stage.denoise") as st:
        tracing.phase("denoise.batch")
        tracing.phase("denoise.batch")  # the same phase goes on
        tracing.phase("denoise.forward")
        with tracing.span("cache.gate", key="up0.0"):
            tracing.count("pairs", 3)
        tracing.count("pairs", 2)
    tracing.count("pairs", 7)  # no stage span: the counter only
    recs = {r.name: r for r in tracing.spans()}
    assert list(recs) == ["denoise.batch", "cache.gate", "denoise.forward",
                          "stage.denoise"]
    sid = st.sid
    assert recs["denoise.batch"].parent == sid
    assert recs["denoise.forward"].parent == sid
    assert recs["cache.gate"].parent == recs["denoise.forward"].sid
    assert recs["cache.gate"].attrs == {"key": "up0.0"}
    assert recs["stage.denoise"].attrs == {"pairs": 5}
    assert recs["denoise.forward"].t1_ns == recs["stage.denoise"].t1_ns
    assert recs["denoise.batch"].t1_ns <= recs["denoise.forward"].t0_ns
    assert tracing.counters()["pairs"] == 12

    tracing.reset()
    monkeypatch.setattr(tracing, "MAX_SPANS", 4)
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=4))
    for i in range(6):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.spans()] == ["s2", "s3", "s4", "s5"]
    assert tracing.counters()["dropped"] == 2


def test_threads_record_their_own_nesting_and_every_count():
    """More threads than cores record nested spans and counts at once
    under a short switch interval: no span or count is lost, and every
    child's parent is the span its own thread had open."""
    tracing.reset()
    tracing.enable(True)
    n_threads, n_iter = 2 * (os.cpu_count() or 4), 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_iter):
            with tracing.span("stage.denoise"):
                tracing.phase("denoise.forward")
                with tracing.span("cache.gate"):
                    tracing.count("pairs", 1)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    recs = tracing.spans()
    assert len(recs) == 3 * n_threads * n_iter
    assert tracing.counters()["pairs"] == n_threads * n_iter
    by_sid = {r.sid: r for r in recs}
    assert len(by_sid) == len(recs)
    for r in recs:
        if r.name == "stage.denoise":
            assert r.parent == 0 and r.attrs == {"pairs": 1}
        else:
            p = by_sid[r.parent]
            assert p.thread == r.thread
            assert p.name == {"denoise.forward": "stage.denoise",
                              "cache.gate": "denoise.forward"}[r.name]


@pytest.fixture(scope="module")
def traced(bundle, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("collect"))
    tracing.reset()
    engine = Engine(serving_config(True, out_dir), "cpu", bundle=bundle)
    assert tracing.enabled()
    pipe = engine.workers[0].pipeline
    pipe.step_modes = []
    batches = []
    outs = serve(engine, batches)
    engine.dump_data()
    recs = tracing.spans()
    tracing.enable(False)
    tracing.reset()
    return engine, pipe, batches, outs, recs, out_dir


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_iterations_nest_in_engine_steps(traced):
    engine, _, _, _, recs, _ = traced
    by_sid = {r.sid: r for r in recs}

    def top(r):
        while r.parent:
            r = by_sid[r.parent]
        return r

    steps = _by_name(recs, "engine.step")
    under = collections.defaultdict(list)
    for r in recs:
        if r.name != "engine.step" and top(r).name == "engine.step":
            under[top(r).sid].append(r.name)
    assert len(steps) >= STEPS
    for s in steps:
        names = under[s.sid]
        assert names.count("worker.schedule") == 1, names
        assert sum(n.startswith("stage.") for n in names) <= 1, names
    # one engine.step per iteration of the schedule log
    log = engine.workers[0].schedule_log
    assert sum(1 for s in steps
               if any(n.startswith("stage.") for n in under[s.sid])) \
        == len(log)
    for r in recs:
        if r.parent:
            p = by_sid[r.parent]
            assert p.thread == r.thread
            assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns, (p, r)
    for name in ("engine.add", "worker.advance", "worker.throttle",
                 "stage.prepare", "prepare.encode", "prepare.latents",
                 "stage.decode", "decode.plan", "denoise.batch",
                 "denoise.decide", "denoise.forward", "denoise.update",
                 "cache.gate"):
        assert _by_name(recs, name), name


def test_denoise_spans_match_the_batches_and_modes(traced):
    _, pipe, batches, outs, recs, _ = traced
    den = _by_name(recs, "stage.denoise")
    assert [list(r.ids) for r in den] == batches
    assert all(r.attrs["rows"] == len(r.ids) for r in den)
    assert all(r.attrs["res"] == [64] for r in den)
    req_steps = collections.Counter()
    for r in den:
        for k, v in r.attrs.items():
            if k.startswith("mode."):
                req_steps[k[5:]] += v
        assert sum(v for k, v in r.attrs.items()
                   if k.startswith("mode.")) == r.attrs["rows"]
    # one step a dispatch on this path: the span's mode is the step's
    assert [r.attrs["mode"] for r in den] == pipe.step_modes
    assert sum(req_steps.values()) == len(outs) * STEPS
    assert req_steps["partial"] > 0 and req_steps["shallow"] > 0
    refreshed = sum(r.attrs.get("refreshed", 0) for r in den)
    assert 0 < refreshed < req_steps["partial"]
    check_pairs(recs, den, patched=False)


def check_pairs(recs, den, patched: bool) -> None:
    """Each gate under a ``stage.denoise`` scores the span's real pairs
    and recomputes as many of them as the capacity that it recorded
    admits; full steps gate nothing."""
    by_sid = {r.sid: r for r in recs}

    def stage_of(r):
        while r.parent:
            r = by_sid[r.parent]
            if r.name == "stage.denoise":
                return r.sid
        return None

    gates = collections.defaultdict(list)
    for r in recs:
        if r.name == "cache.gate":
            gates[stage_of(r)].append(r.attrs)
    for r in den:
        rows, mine = r.attrs["rows"], gates.get(r.sid, [])
        assert bool(mine) == (r.attrs.get("mode.full", 0) < sum(
            v for k, v in r.attrs.items() if k.startswith("mode.")))
        assert r.attrs.get("pairs", 0) == len(mine) * rows
        # a patched gate's capacity counts the images of both CFG halves
        fresh = sum(min(g["caps"][0], 2 * rows) // 2 if patched
                    else min(g["cap"], rows) for g in mine)
        assert r.attrs.get("pairs_fresh", 0) == fresh


# name: (patch path?, plan: "a<i>" admits request i, "s" one step, "c<k>"
# a k-step chunk, each dispatch under its own stage.denoise span)
PATHS = {
    "dense_chunks": (False, ["a0", "a1", "s", "s", "s", "s", "a2", "c4",
                             "c4"]),
    "patch_steps_and_chunk": (True, ["a0", "a1", "s", "s", "s", "s", "c4",
                                     "a2", "s", "s"]),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_step_and_pair_counts_on_chunks_and_the_patch_path(path, bundle):
    """The counts on ``stage.denoise`` of fused chunks (which replay their
    steps on the card, so that no gate runs on the host there) and of the
    patch path's image gates: the request-steps whose deep feature was
    recomputed equal those that the deep steps ran (every row of a full
    step, the distinct selected rows of a partial one), and the pairs
    follow the gates that ran here."""
    patched, plan = PATHS[path]
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = patched
    config.scheduler.patch_size = 64
    config.cache = CacheConfig.production("sd15", serving=True)
    pipe = build_pipeline(config, "cpu", bundle=bundle)
    by_res = {64: []}
    name = "_deep_step_mixed" if patched else "_deep_step"
    deep_step = getattr(pipe, name)
    ran = collections.Counter()

    def spy(mode, *args):
        ran[mode] += (len(set(args[-1].tolist())) if mode == "partial"
                      else len(by_res[64]))
        return deep_step(mode, *args)

    setattr(pipe, name, spy)
    tracing.reset()
    tracing.enable(True)
    chunks = []
    for op in plan:
        if op[0] == "a":
            r = Request(f"r{op[1:]}", SamplingParams(
                prompt=f"p{op[1:]}", resolution=64,
                num_inference_steps=STEPS, seed=int(op[1:])))
            pipe.prepare([r])
            r.stage = Stage.DENOISING
            by_res[64].append(r)
            continue
        with tracing.span("stage.denoise", by_res[64]) as sp:
            sp.set(rows=len(by_res[64]))
            if op[0] == "c":
                chunk = (pipe.denoise_chunk_mixed if patched
                         else pipe.denoise_chunk)
                chunks.append(chunk(by_res, int(op[1:])))
            elif patched:
                pipe.denoise_step_mixed(by_res)
            else:
                pipe.denoise_step(by_res)
    recs = tracing.spans()
    den = _by_name(recs, "stage.denoise")
    assert chunks and all(chunks)
    c = tracing.counters()
    assert c["mode.full"] + c.get("refreshed", 0) == ran["full"] + ran[
        "partial"]
    assert sum(v for k, v in c.items() if k.startswith("mode.")) == sum(
        len(r.ids) * (int(op[1:]) if op[0] == "c" else 1)
        for r, op in zip(den, [op for op in plan if op[0] != "a"]))
    assert (ran["partial"] > 0) == (not patched)
    assert c["pairs"] > c["pairs_fresh"] > 0
    check_pairs(recs, den, patched)


def test_dump_data_writes_spans_and_counters(traced):
    _, _, _, _, recs, out_dir = traced
    with open(f"{out_dir}/spans.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(recs)
    den = [r for r in rows if r["name"] == "stage.denoise"]
    assert den and all(json.loads(r["attrs"])["rows"]
                       == len(r["request_ids"].split(";")) for r in den)
    assert all(int(r["start_ns"]) <= int(r["end_ns"]) for r in rows)
    with open(f"{out_dir}/counters.json") as f:
        counters = json.load(f)
    assert counters["dropped"] == 0 and counters["recorded"] == len(recs)
    assert sum(v for k, v in counters.items()
               if k.startswith("mode.")) == 3 * STEPS
    for name in ("request_data.csv", "schedule_rank0.csv"):
        with open(f"{out_dir}/{name}") as f:
            assert f.readline()


def test_summary_counts_aborts_as_misses_with_nearest_rank_percentiles():
    stats = EngineStats()
    # sd15 at 512: 8 s at slo scale 5; one finished request misses it
    lat = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 9.0]
    for i, e2e in enumerate(lat):
        stats.records.append(RequestRecord(f"f{i}", 512, 100.0, 100.0 + e2e,
                                           100.5, False))
    for i in range(2):
        stats.records.append(RequestRecord(f"a{i}", 512, 100.0, 101.0,
                                           None, True))
    stats.arrived, stats.finished, stats.aborted = 10, 8, 2
    s = stats.summary("sd15", 5.0)
    assert s["finished"] == 8 and s["aborted"] == 2
    assert s["slo_attainment"] == pytest.approx(7 / 10)
    assert s["p50_latency_s"] == 4.0   # the 4th of 8 (int(p*n) took the 5th)
    assert s["p99_latency_s"] == 9.0
    assert s["avg_latency_s"] == pytest.approx(sum(lat) / 8)
    assert s["throughput_rps"] == pytest.approx(8 / 9.0)
    assert s["goodput_rps"] == pytest.approx(7 / 9.0)
    assert EngineStats().summary()["slo_attainment"] == 0.0
