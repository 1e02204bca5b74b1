"""The port's serving worker and decode memory gates against the JAX
package's, on the CPU.

The worker: the stub-pipeline scenarios of tests/test_async_post.py and
tests/test_async_prepare.py run through the JAX ``Worker`` and the
port's with one stub whose stages are instant, except that a prepare or
decode on a pool thread waits until the script releases it (and the
script then waits for its future), so each run is deterministic.  Both
workers must give the same sequence of scheduled (stage, request ids),
finish each request at the same iteration, return the same aborts, and
run each prepare and decode on the same kind of thread (the loop's or a
pool's).

The gates: ``post_overlap_ok`` and ``_decode_capacity_chunk`` of a tiny
sd15 pipeline of each package (built, nothing compiled) at several
resolutions, group sizes, fallback memory limits and live state.  The JAX
bundle also holds the VAE's encoder, which the port never loads, so the
JAX pipeline's parameter bytes are taken from the port's for the decision
comparison; the bytes themselves are compared role by role.
"""

from __future__ import annotations

import concurrent.futures
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.engine.worker import Worker as JaxWorker
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import Config, ModelConfig
from sduss_tpu_torch.engine.worker import Worker
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams, Stage
from test_torch_slice import _np_init, torch_threads  # noqa: F401

PACKAGES = {
    "jax": (JaxConfig, JaxModelConfig, JaxWorker, JaxRequest,
            JaxSamplingParams),
    "torch": (Config, ModelConfig, Worker, Request, SamplingParams),
}


class _Bundle:
    family = "sd15"


class StubPipeline:
    """Instant stages for both workers (the JAX one calls ``postprocess``
    on its pool thread, the port's ``plan_postprocess`` on the loop and
    the returned decode on its pool thread).  A prepare or decode off the
    loop thread waits for ``release(stage, rid)`` of each of its
    requests; one on the loop thread never waits."""

    def __init__(self, overlap_ok=True, fail_decode=False):
        self.bundle = _Bundle()
        self.device = torch.device("cpu")  # the port's worker runs on it
        self.loop_thread = threading.get_ident()
        self.overlap_ok = overlap_ok
        self.fail_decode = fail_decode
        self.gates = {}
        self.calls = []  # (stage, ids, "loop" | "pool")
        self.evicted = []

    def gate(self, stage, rid) -> threading.Event:
        return self.gates.setdefault((stage, rid), threading.Event())

    def _run(self, stage, reqs):
        ids = tuple(r.request_id for r in reqs)
        on_loop = threading.get_ident() == self.loop_thread
        self.calls.append((stage, ids, "loop" if on_loop else "pool"))
        if not on_loop:
            for rid in ids:
                assert self.gate(stage, rid).wait(10), (stage, rid)

    def prepare(self, requests):
        self._run("prepare", requests)
        for r in requests:
            r.remain_steps = r.params.num_inference_steps
            r.latents = np.zeros((1, 4, 4, 4), np.float32)

    def denoise_step(self, by_res, allow_cold=True):
        for reqs in by_res.values():
            for r in reqs:
                r.remain_steps -= 1

    def post_overlap_ok(self, by_res):
        return self.overlap_ok

    def plan_postprocess(self, by_res):
        reqs = [r for group in by_res.values() for r in group]

        def decode():
            self._run("decode", reqs)
            if self.fail_decode:
                raise RuntimeError("decode failed")
            for r in reqs:
                r.output = np.zeros((4, 4, 3), np.uint8)

        return decode

    def postprocess(self, by_res):
        self.plan_postprocess(by_res)()

    def evict_finished_state(self, request_ids):
        self.evicted.append(sorted(request_ids))


def make_worker(pkg, async_prepare="auto", async_postprocess="auto",
                **stub):
    config_cls, model_cls, worker_cls, _, _ = PACKAGES[pkg]
    c = config_cls()
    c.model = model_cls(model="sd15", test_tiny=True)
    c.engine.async_prepare = async_prepare
    c.engine.async_postprocess = async_postprocess
    c.engine.max_inflight_steps = 0  # numpy latents: nothing to probe
    c.scheduler.use_mixed_resolution = False
    pipe = StubPipeline(**stub)
    return worker_cls(0, pipe, c), pipe


def drive(pkg, script, n_steps, **kw):
    """Run ``n_steps`` worker steps; ``script[i]`` holds the actions taken
    before step i: ("add", rid, steps), ("release", stage, rid) or
    ("abort", rid); after them it waits for the futures of the released
    requests.  Returns the trace,
    each request's finishing step, the stub's calls as a sorted list and
    the evictions."""
    worker, pipe = make_worker(pkg, **kw)
    _, _, _, req_cls, params_cls = PACKAGES[pkg]
    trace, finished_at = [], {}
    schedule = worker.scheduler.schedule

    def spy():
        batch = schedule()
        if batch is None or batch.empty:
            trace.append(None)
        else:
            trace.append((batch.stage.value,
                          tuple(r.request_id for r in batch.requests)))
        return batch

    worker.scheduler.schedule = spy
    for i in range(n_steps):
        released = set()
        for action in script.get(i, ()):
            if action[0] == "add":
                worker.add_requests([req_cls(action[1], params_cls(
                    prompt=action[1], resolution=128,
                    num_inference_steps=action[2]))])
            elif action[0] == "release":
                pipe.gate(action[1], action[2]).set()
                released.add(action[2])
            elif action[0] == "abort":
                out = worker.abort_requests([action[1]])
                trace.append(("abort", tuple(r.request_id for r in out)))
        futs = [f for f, reqs in list(worker._preparing) + list(worker._posting)
                if released & {r.request_id for r in reqs}]
        concurrent.futures.wait(futs, timeout=10)
        assert all(f.done() for f in futs)
        for r in worker.step():
            finished_at[r.request_id] = (i, r.stage.value)
    # nothing may be left in flight or unfinished
    assert not worker._preparing and not worker._posting
    assert not worker.has_unfinished()
    return {"trace": trace, "finished_at": finished_at,
            "calls": sorted(pipe.calls), "evicted": pipe.evicted}


# (script, steps, worker and stub options)
SCENARIOS = {
    # async_postprocess "auto": a's decode runs on the pool while b denoises
    "decode_overlaps_denoise": (
        {0: [("add", "a", 1), ("add", "b", 4)],
         5: [("release", "decode", "a")],
         8: [("release", "decode", "b")]}, 10, {}),
    # one background decode at a time: b's group decodes on the loop
    "second_group_decodes_on_loop": (
        {0: [("add", "a", 1), ("add", "b", 2)],
         7: [("release", "decode", "a")]}, 9, {}),
    "headroom_gate_forces_loop": (
        {0: [("add", "a", 1), ("add", "b", 2)]}, 6, {"overlap_ok": False}),
    "abort_mid_decode": (
        {0: [("add", "a", 1), ("add", "b", 3)],
         4: [("abort", "a")],
         5: [("release", "decode", "a")],
         8: [("release", "decode", "b")]}, 10, {}),
    "sync_stages": (
        {0: [("add", "a", 2), ("add", "b", 3)]}, 8,
        {"async_prepare": False, "async_postprocess": False}),
    # async_prepare=True: a denoises while b's prepare is in flight
    "prepare_overlaps_denoise": (
        {0: [("add", "a", 6)],
         1: [("add", "b", 2)],
         3: [("release", "prepare", "a")],
         8: [("release", "prepare", "b")],
         12: [("release", "decode", "a"), ("release", "decode", "b")]},
        20, {"async_prepare": True}),
    "abort_mid_prepare": (
        {0: [("add", "a", 4), ("add", "b", 2)],
         2: [("abort", "a")],
         3: [("release", "prepare", "a"), ("release", "prepare", "b")],
         7: [("release", "decode", "b")]}, 9, {"async_prepare": True}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_worker_matches_jax(name):
    script, n_steps, kw = SCENARIOS[name]
    want = drive("jax", script, n_steps, **kw)
    got = drive("torch", script, n_steps, **kw)
    assert got["trace"] == want["trace"]
    assert got["finished_at"] == want["finished_at"]
    assert got["calls"] == want["calls"]
    assert got["evicted"] == want["evicted"]
    # each scenario shows what it is named for
    labels = {(stage, ids): where for stage, ids, where in got["calls"]}
    if name == "decode_overlaps_denoise":
        assert labels[("decode", ("a",))] == labels[("decode", ("b",))] \
            == "pool"
        # b denoised while a's decode was in flight (steps 3-4)
        assert got["trace"][3:5] == [("denoising", ("b",))] * 2
        assert got["finished_at"]["a"][0] == 5
    elif name == "second_group_decodes_on_loop":
        assert labels[("decode", ("a",))] == "pool"
        assert labels[("decode", ("b",))] == "loop"
    elif name in ("headroom_gate_forces_loop", "sync_stages"):
        assert {where for *_, where in got["calls"]} == {"loop"}
    elif name == "abort_mid_decode":
        assert ("abort", ("a",)) in got["trace"]
        assert "a" not in got["finished_at"]
    elif name == "prepare_overlaps_denoise":
        assert labels[("prepare", ("b",))] == "pool"
        # a denoised while b's prepare was in flight
        i = got["trace"].index(("prepare", ("b",)))
        j = next(k for k, e in enumerate(got["trace"])
                 if e and e[0] == "denoising" and "b" in e[1])
        assert got["trace"][i:j].count(("denoising", ("a",))) >= 3
    elif name == "abort_mid_prepare":
        assert ("abort", ("a",)) in got["trace"]
        assert set(got["finished_at"]) == {"b"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_decode_exception_reaches_the_loop(pkg):
    """An exception on the decode thread is raised by the worker's step
    (the engine loop), not swallowed."""
    worker, pipe = make_worker(pkg, fail_decode=True)
    _, _, _, req_cls, params_cls = PACKAGES[pkg]
    worker.add_requests([req_cls("a", params_cls(
        prompt="a", resolution=128, num_inference_steps=1))])
    pipe.gate("decode", "a").set()
    with pytest.raises(RuntimeError, match="decode failed"):
        for _ in range(20):
            worker.step()


def test_auto_resolves_as_in_jax():
    """``"auto"``: a decode pool, no prepare pool (the port's encoders are
    on the device, as JAX's are unless ``encoders_on_host``); True turns
    each on."""
    for pkg in PACKAGES:
        worker, _ = make_worker(pkg)
        assert worker._post_pool is not None and worker._prepare_pool is None
        worker, _ = make_worker(pkg, async_prepare=True,
                                async_postprocess=False)
        assert worker._post_pool is None and worker._prepare_pool is not None


# -- the decode memory gates -------------------------------------------------


@pytest.fixture(scope="module")
def gate_pipes():
    jc = JaxConfig()
    jc.model = JaxModelConfig(model="sd15", dtype="float32", test_tiny=True,
                              use_patched=False, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jpipe = jax_build_pipeline(jc)
    c = Config()
    c.model = ModelConfig(model="sd15", dtype="float32", test_tiny=True)
    return jpipe, build_pipeline(c, "cpu")


def test_device_param_bytes_match_jax(gate_pipes):
    """The port holds the same parameters as the JAX bundle, less the VAE's
    encoder side (``encoder``, ``quant_conv``), which it never loads."""
    jpipe, tpipe = gate_pipes
    vae = jpipe.bundle.params["vae"]
    encoder = sum(leaf.nbytes for key in ("encoder", "quant_conv")
                  for leaf in jax.tree.leaves(vae[key]))
    assert tpipe.device_param_bytes() == jpipe.device_param_bytes() - encoder
    assert tpipe.device_param_bytes() == sum(
        p.numel() * p.element_size()
        for m in tpipe.bundle.models.values() for p in m.parameters())


@pytest.mark.parametrize("bpp", [768.0, 3073.0, 3585.0])
@pytest.mark.parametrize("live", [0, 3 << 20])
def test_decode_gates_match_jax(gate_pipes, live, bpp, monkeypatch):
    """At the same constants (the JAX default, and the port's for a
    float32 and a bf16 SDXL decode, measured on the card), parameter bytes
    and live state."""
    jpipe, tpipe = gate_pipes
    monkeypatch.setattr(jpipe, "device_param_bytes", tpipe.device_param_bytes)
    for pipe in (jpipe, tpipe):
        monkeypatch.setattr(pipe.config.engine, "decode_bytes_per_pixel", bpp)
    if live:
        # one live composition entry of ``live`` bytes in each package
        monkeypatch.setitem(jpipe.__dict__, "_comp_state", {
            "k": {"state": {"a": {"x": np.zeros(live // 4, np.float32)}}}})
        monkeypatch.setitem(tpipe.__dict__, "_comp_state", {
            "k": {"state": {"a": {"x": torch.zeros(live // 4)}},
                  "anchored": True}})
    ec = tpipe.config.engine
    base = (tpipe.device_param_bytes() + live + ec.prewarm_hbm_margin
            + ec.decode_hbm_margin)
    decisions = []
    for res in (64, 128, 256):
        per_img = ec.decode_bytes_per_pixel * res * res
        for frac in (0.5, 1.5, 2.5, 7.0):
            lim = base + frac * per_img
            for pipe in (jpipe, tpipe):
                monkeypatch.setattr(pipe.config.engine, "hbm_bytes_fallback",
                                    lim)
            for n in (1, 2, 3):
                by_res = {res: [None] * n}
                got = tpipe.post_overlap_ok(by_res)
                assert got == jpipe.post_overlap_ok(by_res), (res, frac, n)
                decisions.append(got)
            assert (tpipe._decode_capacity_chunk(res)
                    == jpipe._decode_capacity_chunk(res)), (res, frac)
    assert True in decisions and False in decisions


def test_capacity_chunk_sizes_the_decode_groups(gate_pipes, monkeypatch):
    """``postprocess`` caps its groups at ``_decode_capacity_chunk``: with
    room for one image a group, three requests decode one at a time."""
    _, tpipe = gate_pipes
    ec = tpipe.config.engine
    res = 64
    monkeypatch.setattr(ec, "hbm_bytes_fallback", tpipe.device_param_bytes()
                        + ec.decode_hbm_margin
                        + 1.5 * ec.decode_bytes_per_pixel * res * res)
    monkeypatch.setattr(tpipe.config.scheduler, "decode_batch", 4)
    assert tpipe._decode_capacity_chunk(res) == 1
    groups = []
    monkeypatch.setattr(tpipe, "_decode_group",
                        lambda reqs: groups.append(len(reqs)))
    reqs = []
    for i in range(3):
        r = Request(f"r{i}", SamplingParams(prompt="p", resolution=res))
        r.stage = Stage.POSTPROCESSING
        reqs.append(r)
    tpipe.postprocess({res: reqs})
    assert groups == [1, 1, 1]


def test_worker_threads_stress():
    """Twelve port workers, each with its prepare and decode threads
    (more threads than cores), run 30 requests each at a short switch
    interval, aborting every fifth on the way: every request leaves its
    worker exactly once, finished or aborted, and none is left behind."""
    def run(results, k):
        worker, pipe = make_worker("torch", async_prepare=True)
        for i in range(30):
            for stage in ("prepare", "decode"):
                pipe.gate(stage, f"r{i}").set()
        out, left = [], {f"r{i}" for i in range(30)}
        deadline = time.time() + 60
        for i in range(30):
            worker.add_requests([Request(f"r{i}", SamplingParams(
                prompt="p", resolution=128, num_inference_steps=1 + i % 4))])
            if i % 5 == 4:
                out += [(r.request_id, "aborted")
                        for r in worker.abort_requests([f"r{i - 2}"])]
            out += [(r.request_id, r.stage.value) for r in worker.step()]
        while worker.has_unfinished() and time.time() < deadline:
            out += [(r.request_id, r.stage.value) for r in worker.step()]
        results[k] = (out, left, worker.has_unfinished())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = {}
        threads = [threading.Thread(target=run, args=(results, k))
                   for k in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(results) == 12
    for out, left, unfinished in results.values():
        ids = [rid for rid, _ in out]
        assert sorted(ids) == sorted(left) and not unfinished
        assert {stage for _, stage in out} <= {"finished", "aborted"}
