"""The host-idle split (``lib/host_idle.py``) on synthetic kernels and
spans: each idle instant goes to the innermost span open on the engine
thread, the four parts sum to the idle share, the counts follow the
window rule, missing spans read None; and a tiny traced run on the CPU
reads the five metrics."""

import time
import types

import pytest
import torch

from perfbench import run as run_mod
from perfbench.lib import host_idle, spec
from perfbench.tests import tiny
from sduss_tpu_torch.tracing import SpanRecord

ENGINE = "engine-step_0"
# (name, start, end, sid, parent) on the engine thread, nested
SPANS = [("engine.step", 0, 99, 1, 0), ("worker.schedule", 5, 15, 2, 1),
         ("stage.denoise", 20, 80, 3, 1), ("denoise.forward", 30, 60, 4, 3),
         ("cache.gate", 40, 50, 5, 4), ("worker.throttle", 85, 95, 6, 1)]
KERNELS = [("k", 0, 3), ("k", 16, 18), ("k", 62, 84), ("k", 96, 100)]


def records(spans=SPANS, thread=ENGINE, attrs=None):
    return [SpanRecord(n, thread, a, b, sid, p, (), dict(attrs or {}))
            for n, a, b, sid, p in spans]


def fake_run(recs, kernels=KERNELS, w0=0, w1=100, off=0, monkeypatch=None):
    monkeypatch.setattr(host_idle, "_records", lambda: recs)
    tracer = types.SimpleNamespace(kernels=lambda: kernels, offset_ns=off)
    served = types.SimpleNamespace(w0=w0 / 1e9, w1=w1 / 1e9, tracer=tracer)
    return types.SimpleNamespace(served=served)


def test_innermost_span_takes_each_idle_instant():
    spans = [(a, b, n) for n, a, b, _, _ in SPANS]
    sp = host_idle.split(KERNELS, spans, 0, 100)
    # idle [3, 16): step 2, schedule 10, step 1; [18, 62): step 2,
    # stage self 10 + 2, forward 20, gate 10; [84, 96): step 1, throttle
    # 10, step 1
    assert sp["idle"] == 69
    assert (sp["engine"], sp["sched"], sp["stage"], sp["wait"]) \
        == (7, 10, 42, 10)
    assert sum(sp[p] for p in host_idle.PARTS) == sp["idle"]
    assert sp["by_name"] == {"engine.step": 7, "worker.schedule": 10,
                             "stage.denoise": 12, "denoise.forward": 20,
                             "cache.gate": 10, "worker.throttle": 10}
    # outside every span: the engine's, under no name
    sp = host_idle.split(KERNELS, spans, -10, 100)
    assert sp["engine"] == 17 and sp["by_name"]["(no span)"] == 10
    assert sp["gaps"][0] == (44, {"engine.step": 2, "stage.denoise": 12,
                                  "denoise.forward": 20, "cache.gate": 10})


def test_children_inherit_their_parts():
    assert host_idle.category("decode.readback", "stage") == "stage"
    assert host_idle.category("graph.capture", "engine") == "engine"
    assert host_idle.category("worker.wait", "stage") == "wait"
    assert host_idle.category("stage.decode", None) == "stage"
    assert host_idle.category("worker.advance", "engine") == "sched"


def test_shares_sum_to_the_idle_share_on_the_engine_thread(monkeypatch):
    other = records([("stage.decode", 0, 100, 9, 0)], thread="post-0_0")
    run = fake_run(records() + other, monkeypatch=monkeypatch, off=1000,
                   kernels=[(n, a + 1000, b + 1000) for n, a, b in KERNELS])
    parts = {p: host_idle.idle_share(run, p) for p in host_idle.PARTS}
    assert parts == pytest.approx({"engine": 7.0, "sched": 10.0,
                                   "stage": 42.0, "wait": 10.0})
    trace_sum = {"busy_s": 31e-9, "window_s": 100e-9}
    idle = spec.reader("idle_share.closed")(
        types.SimpleNamespace(trace=trace_sum))
    assert sum(parts.values()) == pytest.approx(idle)
    for name, part in (("idle_engine_share.closed", "engine"),
                       ("idle_sched_share.closed", "sched"),
                       ("idle_stage_share.closed", "stage")):
        assert spec.reader(name)(run) == pytest.approx(parts[part])
    assert run._host_idle is host_idle.of(run)  # reduced once


def test_counts_follow_the_window_rule(monkeypatch):
    def den(sid, end, **attrs):
        return SpanRecord("stage.denoise", ENGINE, end - 5, end, sid, 0, (),
                          attrs)

    recs = [den(1, 99, **{"mode.full": 100}),           # ends before w0
            den(2, 100, **{"mode.full": 2, "mode.shallow": 2,
                           "pairs": 10, "pairs_fresh": 3}),
            den(3, 150, **{"mode.partial": 4, "refreshed": 1,
                           "pairs": 10, "pairs_fresh": 3}),
            den(4, 200, **{"mode.full": 100})]          # ends at w1
    run = fake_run(recs, w0=100, w1=200, monkeypatch=monkeypatch)
    assert spec.reader("full_step_share.closed")(run) \
        == pytest.approx(3 / 8 * 100)
    assert spec.reader("fresh_pair_share.closed")(run) \
        == pytest.approx(30.0)
    # no engine.step in the window: no idle split, never 0
    assert host_idle.idle_share(run, "engine") is None


def test_missing_spans_read_none(monkeypatch):
    run = fake_run(None, monkeypatch=monkeypatch)
    for name in ("idle_engine_share", "idle_sched_share", "idle_stage_share",
                 "full_step_share", "fresh_pair_share"):
        assert spec.reader(f"{name}.closed")(run) is None
    run = fake_run(records(), monkeypatch=monkeypatch)
    assert host_idle.full_step_share(run) is None
    assert host_idle.fresh_pair_share(run) is None
    run = fake_run(records(), monkeypatch=monkeypatch)
    run.served.tracer = None  # an untraced run
    assert host_idle.idle_share(run, "stage") is None


def test_a_tiny_traced_run_reads_the_five_metrics():
    bench = spec.load_benchmark()
    names = ["idle_share.closed", "idle_engine_share.closed",
             "idle_sched_share.closed", "idle_stage_share.closed",
             "full_step_share.closed", "fresh_pair_share.closed"]
    cell = tiny.cell(steps=16)
    cell.per_layer = [m for m in bench["per_layer"] if m["name"] in names]
    out = run_mod.run_cell(cell, 7, 2.0, True, torch.device("cpu"),
                           time.perf_counter())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert sorted(m) == sorted(names)
    parts = sum(m[n] for n in names[1:4])
    assert parts <= m["idle_share.closed"] + 1e-6
    assert 0 < m["full_step_share.closed"] < 100
    assert 0 < m["fresh_pair_share.closed"] <= 100
