"""Async serving front (counterpart of sduss_tpu/engine/async_engine.py).

Per-request streams over a background engine loop: the engine lives in
this process, and every call that mutates it (``add_request``, ``step``,
``abort_requests``) runs on one single-thread executor, so the asyncio
event loop (the HTTP handlers) stays responsive while the card computes
and no two Engine calls ever overlap.  The engine's ``dp`` replicas
(``ParallelConfig.dp``, ``--dp``) are stepped in turn by that one thread;
``EngineStats`` stays one stream over all of them, as in JAX.
"""

from __future__ import annotations

import asyncio
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.config import Config
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.request import RequestOutput, SamplingParams

logger = init_logger(__name__)


class AsyncEngineDeadError(RuntimeError):
    pass


class AsyncStream:
    """The output stream of one request."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._queue: asyncio.Queue = asyncio.Queue()
        self._finished = False

    def put(self, item) -> None:
        if not self._finished:
            self._queue.put_nowait(item)

    def finish(self) -> None:
        self._finished = True
        self._queue.put_nowait(StopAsyncIteration)

    def __aiter__(self) -> "AsyncStream":
        return self

    async def __anext__(self):
        item = await self._queue.get()
        if item is StopAsyncIteration:
            raise StopAsyncIteration
        if isinstance(item, Exception):
            raise item
        return item


class AsyncEngine:
    """``engine`` serves a prebuilt Engine (its bundle included); else one
    is built on ``device``, which defaults to ``"cuda"`` and raises without
    a GPU."""

    def __init__(self, config: Config, engine: Optional[Engine] = None,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.engine = engine or Engine(config, device)
        if config.engine.prewarm:
            # blocking by design: serving starts with the kernels built and
            # the step graphs captured (Engine.prewarm)
            self.engine.prewarm()
        self._streams: Dict[str, AsyncStream] = {}
        self._loop_task: Optional[asyncio.Task] = None
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="engine-step")
        self._dead: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run_loop())

    async def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):
                pass
            self._loop_task = None
        self._executor.shutdown(wait=False)
        if self.config.engine.collect_data:
            self.engine.dump_data()
        # the recorder follows the engine's lifetime; what it holds stays
        tracing.enable(False)

    @property
    def is_running(self) -> bool:
        return self._loop_task is not None and not self._loop_task.done()

    # -- request API ---------------------------------------------------------

    async def add_request(self, params: SamplingParams,
                          request_id: Optional[str] = None,
                          deadline: Optional[float] = None) -> AsyncStream:
        if self._dead is not None:
            raise AsyncEngineDeadError(str(self._dead))
        request_id = request_id or uuid.uuid4().hex
        stream = AsyncStream(request_id)
        self._streams[request_id] = stream
        # through the executor that runs step(): Engine.step swaps its
        # waiting list out non-atomically, so an append from this thread
        # during a step could be lost and its stream never finish
        await asyncio.get_running_loop().run_in_executor(
            self._executor, lambda: self.engine.add_request(
                request_id, params, deadline=deadline))
        self.start()
        return stream

    async def generate(self, params: SamplingParams,
                       request_id: Optional[str] = None,
                       deadline: Optional[float] = None) -> RequestOutput:
        """Submit a request and await its final output."""
        stream = await self.add_request(params, request_id, deadline)
        final: Optional[RequestOutput] = None
        async for out in stream:
            final = out
        if final is None:
            raise AsyncEngineDeadError("stream closed without output")
        return final

    async def call(self, fn, *args):
        """``fn(engine, *args)`` on the executor that runs every Engine
        call, so it never overlaps a step."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, self.engine, *args)

    async def abort(self, request_id: str) -> None:
        outs = await asyncio.get_running_loop().run_in_executor(
            self._executor, self.engine.abort_requests, [request_id])
        for out in outs:
            self._finish_stream(out)

    # -- loop ----------------------------------------------------------------

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                if not self.engine.has_unfinished_requests():
                    await asyncio.sleep(self.config.engine.poll_interval_s)
                    continue
                outputs = await loop.run_in_executor(self._executor,
                                                     self.engine.step)
                for out in outputs:
                    self._finish_stream(out)
                await asyncio.sleep(0)  # yield to the handlers
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # the engine died: fail every open stream
            logger.exception("engine loop died: %s", e)
            self._dead = e
            for stream in self._streams.values():
                stream.put(AsyncEngineDeadError(str(e)))
                stream.finish()
            self._streams.clear()
            raise

    def _finish_stream(self, out: RequestOutput) -> None:
        stream = self._streams.pop(out.request_id, None)
        if stream is not None:
            stream.put(out)
            stream.finish()
