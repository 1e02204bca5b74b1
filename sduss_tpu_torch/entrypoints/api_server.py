"""HTTP API server on the standard library (counterpart of
sduss_tpu/entrypoints/api_server.py, which serves the same surface with
aiohttp).

    python -m sduss_tpu_torch.entrypoints.api_server --model sdxl --device cuda

Endpoints:
  POST /generate  {"prompt": ..., "negative_prompt": ..., "resolution": ...,
                   "num_inference_steps": ..., "guidance_scale": ..., "seed": ...,
                   "deadline_s": ..., "request_id": ..., "return_image": ...}
                  -> {"request_id", "finished", "aborted", "latency_s",
                      "e2e_latency_s", "resolution", "nsfw_flagged",
                      "image_base64" (PNG), "error" (if any)}
  GET  /health    -> {"status": "ok"}
  GET  /stats     -> the engine's metrics summary (one stream over the
                     replicas) and "devices", a row per dp replica
  POST /abort     {"request_id": ...}
  POST /clear     -> drain, stop the engine and close the server

A missing or malformed field of /generate, or a body that is not JSON,
answers 400 with {"error": ...}; an unknown path 404, a known path with
another method 405, any other failure 500.  HTTP/1.1 over
``asyncio.start_server``: one request per connection, a
``Content-Length`` JSON body, JSON responses.  The PNG is written with
``zlib`` (8-bit RGB, filter 0), so neither aiohttp nor Pillow is needed.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import struct
import time
import zlib
from typing import Optional

import numpy as np
import torch

from sduss_tpu_torch.engine.arg_utils import add_engine_args, config_from_args
from sduss_tpu_torch.engine.async_engine import AsyncEngine
from sduss_tpu_torch.logger import init_logger
from sduss_tpu_torch.request import SamplingParams

logger = init_logger(__name__)

MAX_BODY_BYTES = 16 * 2**20
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error"}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _encode_png(image) -> Optional[str]:
    """An (H, W, 3) uint8 image as a base64 PNG: 8-bit RGB, no interlace,
    every scanline with filter 0, one zlib-compressed IDAT chunk."""
    if image is None:
        return None
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"PNG takes an (H, W, 3) uint8 image, got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * 3)],
                          axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    return base64.b64encode(png).decode()


def device_stats(engine) -> list:
    """One row per dp replica of ``engine`` (an ``Engine``): its lead
    device's memory in the JAX package's keys (``id``, ``platform``,
    ``bytes_in_use``, ``bytes_limit``, ``hbm_utilization``;
    ``{"platform": "cpu"}`` on the CPU), for a replica over an sp x tp
    group every device it spans (``devices``: card indices, or "cpu", one
    per shard) and its load (``dp_rank``, ``pending_pixels``,
    ``unfinished``) and the bytes of its composition state
    (``state_bytes``; ``shard_state_bytes`` per shard of a group).
    Replicas that share a card report that card's memory."""
    rows = []
    for worker in engine.workers:
        device = worker.device
        if device.type == "cuda":
            in_use = torch.cuda.memory_allocated(device)
            limit = torch.cuda.get_device_properties(device).total_memory
            row = {"id": device.index, "platform": "gpu",
                   "bytes_in_use": in_use, "bytes_limit": limit,
                   "hbm_utilization": round(in_use / limit, 4)}
        else:
            row = {"platform": "cpu"}
        shards = worker.pipeline.shard_state_bytes()
        row["state_bytes"] = sum(shards)
        if len(worker.pipeline.devices) > 1:
            row["devices"] = [d.index if d.type == "cuda" else d.type
                              for d in worker.pipeline.devices]
            row["shard_state_bytes"] = shards
        row.update(dp_rank=worker.rank, pending_pixels=worker.pending_pixels(),
                   unfinished=worker.scheduler.pool.unfinished())
        rows.append(row)
    return rows


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_request(reader: asyncio.StreamReader):
    """(method, path, body bytes) of one HTTP/1.1 request."""
    line = await reader.readline()
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise _HTTPError(400, f"bad request line {line[:80]!r}")
    method, target, _ = parts
    length = 0
    while True:
        header = await reader.readline()
        if header in (b"\r\n", b"\n", b""):
            break
        name, _, value = header.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                length = int(value.strip())
            except ValueError:
                raise _HTTPError(400, f"bad Content-Length {value.strip()!r}")
    if length < 0:
        raise _HTTPError(400, f"bad Content-Length {length}")
    if length > MAX_BODY_BYTES:
        raise _HTTPError(413, f"body of {length} bytes exceeds "
                              f"{MAX_BODY_BYTES}")
    body = await reader.readexactly(length) if length else b""
    return method, target.split("?", 1)[0], body


def _json_body(body: bytes) -> dict:
    try:
        data = json.loads(body or b"{}")
    except ValueError as e:
        raise _HTTPError(400, f"body is not JSON: {e}")
    if not isinstance(data, dict):
        raise _HTTPError(400, "body is not a JSON object")
    return data


class ApiServer:
    """The running server: ``port`` is the bound port; ``close()`` (from
    any thread) stops accepting and ends ``wait_closed()``."""

    def __init__(self, engine: AsyncEngine):
        self.engine = engine
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop = asyncio.get_running_loop()
        self._closed = asyncio.Event()
        self._stopped = False
        self._routes = {
            ("POST", "/generate"): self._generate,
            ("GET", "/health"): self._health,
            ("GET", "/stats"): self._stats,
            ("POST", "/abort"): self._abort,
            ("POST", "/clear"): self._clear,
        }

    async def _start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]

    def close(self) -> None:
        self._loop.call_soon_threadsafe(self._closed.set)

    async def wait_closed(self) -> None:
        """Wait for ``close()`` or /clear; then stop accepting, and stop
        the engine unless /clear already did."""
        await self._closed.wait()
        self._server.close()
        await self._server.wait_closed()
        await self._stop_engine()

    async def _stop_engine(self) -> None:
        if not self._stopped:
            self._stopped = True
            await self.engine.stop()

    # -- HTTP ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        after = None
        try:
            try:
                method, path, body = await _read_request(reader)
                handler = self._routes.get((method, path))
                if handler is None:
                    if any(p == path for _, p in self._routes):
                        raise _HTTPError(405, f"{method} not allowed on {path}")
                    raise _HTTPError(404, f"no route {path}")
                status, payload, after = await handler(body)
            except _HTTPError as e:
                status, payload = e.status, {"error": str(e)}
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except Exception as e:  # noqa: BLE001 — answer, keep serving
                logger.exception("request failed")
                status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            data = json.dumps(payload).encode()
            writer.write(
                f"HTTP/1.1 {status} {_REASONS[status]}\r\n"
                f"Content-Type: application/json; charset=utf-8\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: close\r\n\r\n".encode("latin-1") + data)
            await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass
        if after is not None:
            after()

    async def _generate(self, body: bytes):
        data = _json_body(body)
        try:
            params = SamplingParams(
                prompt=data["prompt"],
                negative_prompt=data.get("negative_prompt", ""),
                resolution=int(data.get("resolution", 512)),
                num_inference_steps=int(data.get("num_inference_steps", 50)),
                guidance_scale=data.get("guidance_scale"),
                seed=data.get("seed"),
            )
            deadline = None
            if data.get("deadline_s") is not None:
                deadline = time.time() + float(data["deadline_s"])
        except (KeyError, ValueError, TypeError) as e:
            raise _HTTPError(400, str(e))
        t0 = time.time()
        out = await self.engine.generate(
            params, request_id=data.get("request_id"), deadline=deadline)
        resp = {
            "request_id": out.request_id,
            "finished": out.finished,
            "aborted": out.aborted,
            "latency_s": time.time() - t0,
            "e2e_latency_s": out.e2e_latency_s,
            "resolution": out.resolution,
            "nsfw_flagged": out.nsfw_flagged,
        }
        if data.get("return_image", True):
            resp["image_base64"] = _encode_png(out.image)
        if out.error:
            resp["error"] = out.error
        return 200, resp, None

    async def _health(self, body: bytes):
        return 200, {"status": "ok"}, None

    async def _stats(self, body: bytes):
        cfg = self.engine.config
        out = self.engine.engine.stats.summary(cfg.model.family,
                                               cfg.scheduler.slo_scale)
        # on the engine's thread: the replicas' pools change during a step
        out["devices"] = await self.engine.call(device_stats)
        return 200, out, None

    async def _abort(self, body: bytes):
        await self.engine.abort(_json_body(body)["request_id"])
        return 200, {"status": "aborted"}, None

    async def _clear(self, body: bytes):
        while self.engine.engine.has_unfinished_requests():
            await asyncio.sleep(0.05)
        await self._stop_engine()
        # close once the response is written (the JAX server signals its
        # own process instead, which would end an in-process caller)
        return 200, {"status": "cleared"}, self.close


async def build_server(engine: AsyncEngine, host: str = "0.0.0.0",
                       port: int = 8000) -> ApiServer:
    """Bind the API on ``host``:``port`` (0: any free port) and start the
    engine loop; ``ApiServer.port`` is the bound port."""
    server = ApiServer(engine)
    await server._start(host, port)
    engine.start()
    return server


def main(argv=None) -> None:
    """Serve until /clear (or an interrupt) closes the server."""
    parser = argparse.ArgumentParser("sduss_tpu_torch api server")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    add_engine_args(parser)
    args = parser.parse_args(argv)
    engine = AsyncEngine(config_from_args(args), device=args.device)

    async def serve() -> None:
        server = await build_server(engine, args.host, args.port)
        logger.info("serving %s on %s:%d (%s)", args.model, args.host,
                    server.port, args.device)
        try:
            await server.wait_closed()
        finally:
            await server._stop_engine()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
