"""Serving engine on one CUDA device (counterpart of
sduss_tpu/engine/engine.py).

One replica (``dp=1``) on an explicit ``torch.device``: the engine holds
one ``Worker`` and hands it every waiting request (the JAX engine's
dispatch over replicas comes back with ``dp > 1``).  ``step()``,
``add_request()``, ``abort_requests()`` and ``has_unfinished_requests()``
keep the JAX engine's semantics; ``abort_requests`` also reaches requests
parked in PREPARING or DECODING while a worker thread runs their stage.
There is no compilation cache and no prewarm program matrix: eager PyTorch
compiles nothing ahead of a step (CUDA-graph capture is later work), so
``engine.prewarm`` raises.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional, Sequence, Set

import torch

from sduss_tpu_torch.config import Config
from sduss_tpu_torch.metrics import EngineStats
from sduss_tpu_torch.request import Request, RequestOutput, SamplingParams, Stage
from sduss_tpu_torch import configure_numerics
from sduss_tpu_torch.engine.worker import Worker
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline


def check_supported(config: Config) -> None:
    """Raise, when the Engine is built, for configurations whose code paths
    are not ported yet, naming the ROADMAP item that ports them.

    Every cache of the JAX package is served.  The UNet families (sd15,
    sdxl) run the deep cache (``mode="deep"``, with its adaptive refresh,
    prediction, row warmup and CFG-pair hybrid) on dense batches and, with
    ``use_mixed_resolution``, on the patch path, so each
    ``CacheConfig.production`` preset of those families runs as it is;
    mode "block" on the patch path (on the dense path it is cache-off, as
    in JAX), and mode "compact" on both paths, with two-level patch rows at
    ``patch_fraction < 1``.  SD3 serves the span-skip deep cache
    (``sd3_deep_span``, both ``production("sd3")`` presets) and the token
    caches, modes "block" and "compact" (the per-token fine gate at
    ``patch_fraction < 1``, with ``fine_stale_kv``), alone or together, on
    its token path.  As in JAX, an SD3 config with ``mode="deep"`` and no
    ``sd3_deep_span`` mints no cache at all, and the UNet families ignore
    ``sd3_deep_span``.  What is refused: ``engine.prewarm`` and
    ``steps_per_dispatch`` above 1 (item 3) and more than one device (item
    10)."""
    par, sc = config.parallel, config.scheduler
    if config.engine.prewarm:
        raise NotImplementedError(
            "engine.prewarm compiles the step programs ahead of serving; "
            "eager PyTorch has no program to compile (step capture with "
            "CUDA graphs is ROADMAP Queue 1 item 3)")
    if par.world_size != 1:
        raise NotImplementedError("multi-device serving is not ported "
                                  "(dp = tp = sp = pp = 1; ROADMAP Queue 1 "
                                  "item 10)")
    if sc.steps_per_dispatch != 1:
        raise NotImplementedError("fused multi-step dispatch is not ported "
                                  "(steps_per_dispatch=1; ROADMAP Queue 1 "
                                  "item 3)")


class Engine:
    def __init__(self, config: Config, device: torch.device | str,
                 bundle: Optional[ModelBundle] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "explicitly to run on the CPU")
        check_supported(config)
        configure_numerics()
        self.config = config
        pipe = build_pipeline(config, self.device, bundle=bundle)
        self.worker = Worker(0, pipe, config)
        self._waiting: List[Request] = []
        self._known: Set[str] = set()  # ids of unfinished requests
        self.stats = EngineStats()

    # -- request API ---------------------------------------------------------

    def add_requests(self, reqs: Sequence[Request]) -> None:
        for req in reqs:
            if req.request_id in self._known:
                raise ValueError(f"duplicate request id {req.request_id}")
            self._known.add(req.request_id)
            self._waiting.append(req)
            self.stats.on_arrival(req)

    def add_request(self, request_id: str, params: SamplingParams,
                    deadline: Optional[float] = None) -> Request:
        req = Request(request_id, params, deadline=deadline)
        self.add_requests([req])
        return req

    def abort_requests(self, request_ids: Sequence[str]) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        ids = set(request_ids)
        still_waiting = []
        for req in self._waiting:
            if req.request_id in ids:
                req.stage = Stage.ABORTED
                req.finish_time = time.time()
                self._known.discard(req.request_id)
                outs.append(RequestOutput.from_request(req))
                ids.discard(req.request_id)
            else:
                still_waiting.append(req)
        self._waiting = still_waiting
        for req in self.worker.abort_requests(list(ids)):
            self._known.discard(req.request_id)
            outs.append(RequestOutput.from_request(req))
        for out in outs:
            self.stats.on_finish(out)
        return outs

    def has_unfinished_requests(self) -> bool:
        return bool(self._waiting) or self.worker.has_unfinished()

    # -- main loop -----------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        """Hand waiting requests to the worker, run one iteration, collect
        finished outputs."""
        if self._waiting:
            self.worker.add_requests(self._waiting)
            self._waiting = []

        outputs: List[RequestOutput] = []
        for req in self.worker.step():
            self._known.discard(req.request_id)
            out = RequestOutput.from_request(req)
            self.stats.on_finish(out)
            outputs.append(out)
        return outputs

    # -- data collection -----------------------------------------------------

    def dump_data(self, out_dir: Optional[str] = None) -> None:
        """Write ``request_data.csv`` and ``schedule_rank{r}.csv`` (the
        worker's per-iteration schedule log) to ``out_dir``, by default
        ``engine.collect_dir``."""
        out_dir = out_dir or self.config.engine.collect_dir
        os.makedirs(out_dir, exist_ok=True)
        self.stats.dump_csv(os.path.join(out_dir, "request_data.csv"))
        log = self.worker.schedule_log
        if log:
            path = os.path.join(out_dir, f"schedule_rank{self.worker.rank}.csv")
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(log[0]))
                w.writeheader()
                w.writerows(log)
