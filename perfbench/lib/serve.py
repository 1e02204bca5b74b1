"""Drive the program for one run: build the engine of a cell, prewarm it,
send the cell's traffic through ``AsyncEngine.generate``, and hand back
what the client saw and what the probe recorded.

Every request passes PREPARE, its DENOISING steps and POSTPROCESSING in
the engine.  An open loop sends each request when it is due, whatever is
in flight, and times it from when it was due; a closed loop's clients
each send their next request when the last one returns (an open loop
serves ``sweep.py``; only closed-loop cells are judged, and only their
requests are sampled for the check).  After the window
closes, the run keeps the load on until every request due (open) or sent
(closed) in the window has returned, a minute at most; the rest are
aborted and count as failed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.lib import traffic as tr
from perfbench.lib import weights as wts
from perfbench.lib.probe import Probe
from perfbench.lib.trace import Tracer
from perfbench.lib.window import Record, slo_deadline_s
from perfbench.lib.spec import ROOT

DRAIN_S = 60.0


@dataclasses.dataclass
class Served:
    records: List[Record]
    w0: float
    w1: float
    setup_s: float
    lead_in_s: float
    peak_bytes: int
    probe: Probe
    tracer: Optional[Tracer]
    schedule_log: List[dict]
    clock_to_wall: float          # time.time() - perf_counter()
    tracked: List[str]
    items: Dict[str, tr.Item]
    engine_error: Optional[str] = None


def program_config(cell_cfg: dict, mix: dict, trace: bool, run_dir: str):
    """The program's ``Config`` for a cell: the family and dtype of the
    configuration file, the mix's policy, SLO, cache preset and scheduler
    knobs, the configuration's ESyMReD profile; every other knob keeps the
    program's default."""
    from sduss_tpu_torch.config import CacheConfig, Config, ModelConfig

    config = Config()
    config.model = ModelConfig(model=cell_cfg["family"],
                               dtype=cell_cfg["dtype"],
                               test_tiny=bool(cell_cfg.get("program_tiny")))
    sc = config.scheduler
    sc.policy = mix["policy"]
    sc.slo_scale = float(mix["slo"])
    if mix["policy"] == "esymred" and cell_cfg.get("esymred_profile"):
        with open(ROOT / cell_cfg["esymred_profile"]) as f:
            sc.stage_latency_overrides = json.load(f)
        sc.predictor_path = str(ROOT / cell_cfg["esymred_predictor"])
    for k, v in mix.get("scheduler", {}).items():
        if not hasattr(sc, k):
            raise KeyError(f"scheduler knob {k!r}")
        setattr(sc, k, tuple(v) if isinstance(v, list) else v)
    sc.__post_init__()
    if mix["cache"] == "production":
        config.cache = CacheConfig.production(cell_cfg["family"],
                                              serving=True)
    elif mix["cache"] != "off":
        raise ValueError(f"cache {mix['cache']!r}")
    config.engine.collect_data = trace
    config.engine.collect_dir = run_dir
    return config


def build_engine(cell_cfg: dict, config, seed: int, device):
    """The program's engine over weights the harness made from ``seed``
    (the reference's names; the program converts them itself)."""
    from sduss_tpu_torch.engine.engine import Engine
    from sduss_tpu_torch.models.registry import DTYPES, ModelBundle

    dtype = DTYPES[cell_cfg["dtype"]]
    tensors = wts.make(cell_cfg, seed, device, dtype)
    bundle = ModelBundle(cell_cfg["family"],
                         tiny=bool(cell_cfg.get("program_tiny")),
                         dtype=dtype, device=device,
                         vae_dtype=config.model.vae_dtype)
    bundle.load_state_dicts(tensors)
    del tensors
    return Engine(config, device, bundle=bundle)


@dataclasses.dataclass
class Session:
    """A built and prewarmed engine with the probe on its pipeline."""
    engine: object
    config: object
    probe: Probe
    setup_s: float


def setup(cell, seed: int, trace: bool, device, t_start: float,
          run_dir: str) -> Session:
    """Weights from the seed, the engine, its prewarm over the mix's
    resolutions (and compositions), the probe; ``setup_s`` runs from
    ``t_start`` (the process start) to here."""
    cfg, mix = cell.config, cell.traffic
    config = program_config(cfg, mix, trace, run_dir)
    engine = build_engine(cfg, config, seed, device)
    comps = [{int(k): int(v) for k, v in c.items()}
             for c in mix.get("prewarm_compositions", [])]
    engine.prewarm(resolutions=sorted(set(mix["resolutions"])),
                   compositions=comps)
    probe = Probe(engine.workers[0].pipeline, trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Session(engine, config, probe, time.perf_counter() - t_start)


def drive(session: Session, cell, seed: int, seconds: float, trace: bool,
          device, mix: Optional[dict] = None) -> Served:
    """One pass of the traffic (``mix``, default the cell's) through the
    session's engine."""
    from sduss_tpu_torch.engine.async_engine import AsyncEngine

    cfg, mix = cell.config, mix or cell.traffic
    items = tr.items(mix, seed, tr.horizon_items(mix, seconds))
    lead = float(mix["lead_in_s"])
    worker = session.engine.workers[0]
    worker.schedule_log.clear()
    out = asyncio.run(_drive(session.engine, session.config, AsyncEngine,
                             session.probe, items, mix, cfg["family"],
                             int(mix["slo"]), lead, seconds, seed, trace,
                             device))
    records, w0, w1, peak, tracer, tracked, err = out
    return Served(records, w0, w1, session.setup_s, lead, peak,
                  session.probe, tracer, list(worker.schedule_log),
                  time.time() - time.perf_counter(), tracked,
                  {f"r{it.index}": it for it in items}, err)


def serve(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, run_dir: str) -> Served:
    session = setup(cell, seed, trace, device, t_start, run_dir)
    served = drive(session, cell, seed, seconds, trace, device)
    session.probe.remove()
    return served


async def _drive(engine, config, AsyncEngine, probe, items, mix, family, slo,
                 lead, seconds, seed, trace, device):
    from sduss_tpu_torch.request import SamplingParams

    aengine = AsyncEngine(config, engine=engine)
    clock_wall = time.time() - time.perf_counter()
    start = time.perf_counter()
    w0, w1 = start + lead, start + lead + seconds
    records: Dict[int, Record] = {}
    state = {"stop": False, "err": None, "c0": None}
    tracer = Tracer(device.type) if trace else None
    tracked: List[str] = []
    open_loop = mix["loop"] == "open"
    offsets = set()
    if not open_loop:
        rng = np.random.default_rng([int(seed) % (1 << 63), 13])
        k = min(int(mix.get("sample", 4)), int(mix["clients"]))
        offsets = set(rng.choice(int(mix["clients"]), size=k,
                                 replace=False).tolist())

    async def send(it: tr.Item, due: float) -> None:
        rid = f"r{it.index}"
        params = SamplingParams(prompt=it.prompt, resolution=it.resolution,
                                num_inference_steps=it.steps, seed=it.seed)
        rec = Record(it.index, rid, it.resolution, due, time.perf_counter())
        records[it.index] = rec
        deadline = due + clock_wall + slo_deadline_s(family, it.resolution,
                                                     slo)
        try:
            res = await aengine.generate(params, request_id=rid,
                                         deadline=deadline)
            rec.done = time.perf_counter()
            rec.ok = (not res.aborted and res.error is None
                      and res.image is not None)
            rec.error = res.error or ("aborted" if res.aborted else None)
            if res.first_scheduled_time is not None:
                rec.first_scheduled = res.first_scheduled_time - clock_wall
        except Exception as e:  # noqa: BLE001 - the engine died: a failure
            rec.done = time.perf_counter()
            rec.error = f"{type(e).__name__}: {e}"
            state["err"] = state["err"] or rec.error

    async def one(it: tr.Item) -> None:
        due = start + it.due_s
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        if state["stop"]:
            return
        await send(it, due)

    async def client(c: int, queue) -> None:
        # the clients join one by one over the ramp, so that their
        # requests do not move through the batches in lockstep
        await asyncio.sleep(c * float(mix.get("client_ramp_s", 0.0))
                            / int(mix["clients"]))
        while not state["stop"]:
            if time.perf_counter() >= w1:
                return
            it = queue.pop(0)
            now = time.perf_counter()
            if now >= w0:
                if state["c0"] is None:
                    state["c0"] = it.index
                if it.index - state["c0"] in offsets:
                    tracked.append(f"r{it.index}")
                    probe.tracked.add(f"r{it.index}")
            await send(it, now)

    async def window() -> None:
        delay = w0 - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if tracer is not None:
            tracer.start()
        await asyncio.sleep(max(w1 - time.perf_counter(), 0.0))

    if open_loop:
        tasks = [asyncio.ensure_future(one(it)) for it in items]
    else:
        queue = list(items)
        tasks = [asyncio.ensure_future(client(c, queue))
                 for c in range(int(mix["clients"]))]
    await window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if tracer is not None:
        tracer.stop()

    def outstanding() -> List[Record]:
        return [r for r in records.values()
                if r.done is None and (w0 <= r.due < w1 if open_loop
                                       else w0 <= r.sent < w1)]

    def tracked_pending() -> bool:
        return any(records.get(int(t[1:])) is not None
                   and records[int(t[1:])].done is None for t in tracked)

    deadline = w1 + DRAIN_S
    while ((outstanding() or tracked_pending())
           and time.perf_counter() < deadline and state["err"] is None):
        await asyncio.sleep(0.05)
    state["stop"] = True
    given_up = time.perf_counter()
    for r in records.values():
        if r.done is None:
            r.given_up = given_up
            r.error = r.error or "never returned"
            await aengine.abort(r.request_id)
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    config.engine.collect_data = False  # the log stays in memory
    await aengine.stop()
    config.engine.collect_data = trace
    return (sorted(records.values(), key=lambda r: r.index), w0, w1, peak,
            tracer, tracked, state["err"])
