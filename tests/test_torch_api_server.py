"""The port's HTTP server, client, async engine and CLI against the JAX
package's, on the CPU.

Both servers run the tiny float32 ``sd15`` engine with the same weights
(the JAX bundle's, drawn with numpy and carried over by
``jax_to_torch_state_dict``) on one background event loop: the JAX
``build_app`` (aiohttp) through aiohttp's in-process test client, the
port's ``build_server`` on a localhost socket, reached with the port's
client (``urllib``).  The same request bodies go to both: equal status
codes and response keys, 400 cases included; latents (``output_type=
"latent"`` through ``AsyncEngine.generate``) within 1e-4 of max |JAX|;
images within one uint8 level; the port's PNG decoding (with Pillow) to
its ``RequestOutput.image`` bit for bit; equal ``/stats`` counts after an
abort.  Requests go to the JAX server one at a time, so it compiles one
program per stage.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from sduss_tpu.engine.arg_utils import add_engine_args as jax_add_engine_args
from sduss_tpu.engine.arg_utils import config_from_args as jax_config_from_args
from sduss_tpu.engine.async_engine import AsyncEngine as JaxAsyncEngine
from sduss_tpu.entrypoints.api_server import build_app
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.engine.arg_utils import add_engine_args, config_from_args
from sduss_tpu_torch.engine.async_engine import (AsyncEngine,
                                                 AsyncEngineDeadError)
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints import api_server, client
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.request import SamplingParams
from test_torch_sd15_slice import jax_pipeline, port_bundle
from test_torch_slice import torch_threads  # noqa: F401

RES, STEPS = 64, 2
BODY = {"prompt": "a red cat on a mat", "negative_prompt": "blurry",
        "resolution": RES, "num_inference_steps": STEPS, "seed": 11,
        "return_image": True}
# (method, path, body): the JAX and port answers must agree
CASES = [
    ("GET", "/health", None),
    ("POST", "/generate", {k: v for k, v in BODY.items() if k != "prompt"}),
    ("POST", "/generate", dict(BODY, resolution="big")),
    ("POST", "/generate", dict(BODY, num_inference_steps=[2])),
    ("POST", "/generate", dict(BODY, deadline_s="soon")),
    ("GET", "/generate", None),
    ("GET", "/no/such/path", None),
    ("POST", "/abort", {"request_id": "never-sent"}),
    ("POST", "/generate", dict(BODY, request_id="keys", return_image=False)),
    ("GET", "/stats", None),
]


def read_png(b64: str) -> np.ndarray:
    """A base64 PNG decoded by Pillow, a decoder independent of the
    port's."""
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


class Loop:
    """An event loop on a thread of its own; ``run`` waits for a
    coroutine's result."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()
        self.loop.close()


def port_config():
    config = default_config("sd15", dtype="float32", test_tiny=True)
    config.scheduler.use_mixed_resolution = False
    return config


@pytest.fixture(scope="module")
def jax_pipe():
    return jax_pipeline("euler")


@pytest.fixture(scope="module")
def bundle(jax_pipe):
    return port_bundle(jax_pipe)


@pytest.fixture(scope="module")
def servers(jax_pipe, bundle):
    """The JAX app and the port's server, both up on one loop."""
    from aiohttp.test_utils import TestClient, TestServer

    loop = Loop()
    jeng = JaxAsyncEngine(jax_pipe.config, engine=jax_pipe.engine)
    teng = AsyncEngine(port_config(), engine=Engine(port_config(), "cpu",
                                                    bundle=bundle))
    outs = []  # the port's RequestOutputs, in order
    generate = teng.generate

    async def spy(*args, **kwargs):
        out = await generate(*args, **kwargs)
        outs.append(out)
        return out

    teng.generate = spy

    async def up():
        jclient = TestClient(TestServer(build_app(jeng)))
        await jclient.start_server()
        jeng.start()
        return jclient, await api_server.build_server(teng, "127.0.0.1", 0)

    jclient, server = loop.run(up())
    yield {"loop": loop, "jax": jeng, "jclient": jclient, "port": teng,
           "server": server, "url": f"http://127.0.0.1:{server.port}",
           "outs": outs}

    async def down():
        await jclient.close()
        await jeng.stop()
        server.close()
        await server.wait_closed()

    loop.run(down())
    loop.close()
    assert not teng.is_running


def jax_call(s, method, path, body):
    """(status, JSON body or None) of the JAX app."""
    async def call():
        resp = await s["jclient"].request(method, path, json=body)
        try:
            return resp.status, await resp.json()
        except Exception:  # noqa: BLE001 — aiohttp's own text answers
            return resp.status, None
    return s["loop"].run(call())


def port_call(s, method, path, body):
    """(status, JSON body) of the port's server, over the socket."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(s["url"] + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def test_http_surface_matches_jax(servers):
    for method, path, body in CASES:
        want, jbody = jax_call(servers, method, path, body)
        got, tbody = port_call(servers, method, path, body)
        assert got == want, (method, path, body)
        if want == 400:
            assert set(tbody) == {"error"} and tbody["error"]
        elif jbody is not None:
            assert set(tbody) == set(jbody), (method, path)
            if path == "/generate":
                assert tbody["finished"] and not tbody["aborted"]
                assert tbody["request_id"] == jbody["request_id"] == "keys"
    # a device row per replica names the platform and the replica's load
    assert port_call(servers, "GET", "/stats", None)[1]["devices"] == [
        {"platform": "cpu", "dp_rank": 0, "pending_pixels": 0,
         "unfinished": 0, "state_bytes": 0}]


def test_latents_match_jax(servers):
    kw = dict(prompt=BODY["prompt"], negative_prompt=BODY["negative_prompt"],
              resolution=RES, num_inference_steps=STEPS, seed=5,
              output_type="latent")
    loop = servers["loop"]
    want = loop.run(servers["jax"].generate(JaxSamplingParams(**kw))).image
    got = loop.run(servers["port"].generate(SamplingParams(**kw))).image
    assert got.shape == want.shape == (RES // 8, RES // 8, 4)
    err = np.abs(got - np.asarray(want)).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def test_images_match_jax_and_png_is_exact(servers):
    _, jbody = jax_call(servers, "POST", "/generate", BODY)
    n = len(servers["outs"])
    tbody = client.post_json(servers["url"] + "/generate", BODY)
    want = read_png(jbody["image_base64"])
    got = read_png(tbody["image_base64"])
    out = servers["outs"][n]
    assert out.request_id == tbody["request_id"]
    assert got.dtype == np.uint8 and np.array_equal(got, out.image)
    assert got.shape == want.shape and got.std() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stats_after_abort_match_jax(servers):
    """A /generate aborted through /abort answers aborted, and /stats
    then counts the same arrivals, finishes and aborts in both."""
    body = dict(BODY, num_inference_steps=400, request_id="victim",
                return_image=False)

    async def jax_abort():
        task = asyncio.ensure_future(
            servers["jclient"].post("/generate", json=body))
        while "victim" not in servers["jax"]._streams:
            await asyncio.sleep(0.01)
        await servers["jclient"].post("/abort", json={"request_id": "victim"})
        return await (await task).json()

    jout = servers["loop"].run(jax_abort())
    result = {}
    th = threading.Thread(target=lambda: result.update(
        client.post_json(servers["url"] + "/generate", body)))
    th.start()
    deadline = time.time() + 60
    while "victim" not in servers["port"]._streams and time.time() < deadline:
        time.sleep(0.01)
    assert client.post_json(servers["url"] + "/abort",
                            {"request_id": "victim"}) == {"status": "aborted"}
    th.join(60)
    assert not th.is_alive()
    assert jout["aborted"] and result["aborted"] and not result["finished"]
    _, jstats = jax_call(servers, "GET", "/stats", None)
    _, tstats = port_call(servers, "GET", "/stats", None)
    keys = ("arrived", "finished", "aborted")
    assert {k: tstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert tstats["aborted"] == 1


def test_png_encoding_roundtrip():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    png = api_server._encode_png(img)
    assert np.array_equal(read_png(png), img)
    assert np.array_equal(client.decode_png(base64.b64decode(png)), img)
    assert api_server._encode_png(None) is None
    with pytest.raises(ValueError):
        api_server._encode_png(img.astype(np.float32))


# -- the async engine --------------------------------------------------------


def fresh(bundle, **engine):
    config = port_config()
    for k, v in engine.items():
        setattr(config.engine, k, v)
    return AsyncEngine(config, engine=Engine(config, "cpu", bundle=bundle))


def params(i=0, steps=STEPS):
    return SamplingParams(prompt=f"p{i}", resolution=RES,
                          num_inference_steps=steps, seed=i)


def test_async_engine_concurrent_requests(bundle):
    async def main():
        eng = fresh(bundle)
        try:
            outs = await asyncio.gather(*[eng.generate(params(i))
                                          for i in range(3)])
            assert all(o.finished and o.image.dtype == np.uint8
                       and o.image.ndim == 3 for o in outs)
            assert len({o.request_id for o in outs}) == 3
            assert eng.engine.stats.summary("sd15")["finished"] == 3
        finally:
            await eng.stop()

    asyncio.run(main())


def test_async_engine_serializes_adds_with_steps(bundle):
    """Every Engine call (add, step, abort) runs on the one executor
    thread, never on the event loop's."""
    async def main():
        eng = fresh(bundle)
        seen = []
        for name in ("add_request", "step", "abort_requests"):
            real = getattr(eng.engine, name)

            def spy(*a, _real=real, **k):
                seen.append(threading.current_thread().name)
                return _real(*a, **k)

            setattr(eng.engine, name, spy)
        try:
            assert (await eng.generate(params())).finished
            await eng.abort("nothing")
            assert seen and all(n.startswith("engine-step") for n in seen)
        finally:
            await eng.stop()

    asyncio.run(main())


def test_async_engine_abort_waiting_and_running(bundle):
    """A user abort finishes the stream aborted and counts in the stats,
    whether the request waits or denoises."""
    async def main():
        eng = fresh(bundle)
        try:
            waiting = await eng.add_request(params(steps=400), "waiting")
            await eng.abort("waiting")
            outs = [o async for o in waiting]
            assert len(outs) == 1 and outs[0].aborted
            running = await eng.add_request(params(steps=400), "running")
            while eng.engine.workers[0].iteration < 3:
                await asyncio.sleep(0.01)
            await eng.abort("running")
            outs = [o async for o in running]
            assert len(outs) == 1 and outs[0].aborted
            s = eng.engine.stats.summary("sd15")
            assert (s["arrived"], s["aborted"]) == (2, 2)
            assert not eng.engine.has_unfinished_requests()
        finally:
            await eng.stop()

    asyncio.run(main())


def test_async_engine_dead_engine_fails_streams(bundle, tmp_path):
    """An exception in Engine.step fails every open stream, later adds
    raise, and stop() still dumps the collected data."""
    async def main():
        eng = fresh(bundle, collect_data=True, collect_dir=str(tmp_path))

        def boom():
            raise RuntimeError("device lost")

        eng.engine.step = boom
        streams = [await eng.add_request(params(i)) for i in range(2)]
        for stream in streams:
            with pytest.raises(AsyncEngineDeadError, match="device lost"):
                async for _ in stream:
                    pass
        with pytest.raises(AsyncEngineDeadError):
            await eng.add_request(params())
        assert not eng.is_running
        await eng.stop()

    asyncio.run(main())
    assert (tmp_path / "request_data.csv").exists()


def test_clear_drains_and_closes(bundle):
    """/clear waits for the open request, stops the engine and closes the
    server in the caller's process; the server's thread then ends."""
    eng = fresh(bundle)
    box = {}
    ready = threading.Event()

    def serve():
        async def main():
            box["server"] = await api_server.build_server(eng, "127.0.0.1", 0)
            ready.set()
            await box["server"].wait_closed()
        asyncio.run(main())

    th = threading.Thread(target=serve)
    th.start()
    assert ready.wait(30)
    url = f"http://127.0.0.1:{box['server'].port}"
    result = {}
    gen = threading.Thread(target=lambda: result.update(
        client.generate(url, "a cat", RES, 4, want_image=True)))
    gen.start()
    while not eng.engine.has_unfinished_requests() and gen.is_alive():
        time.sleep(0.01)
    assert client.post_json(url + "/clear", {}) == {"status": "cleared"}
    gen.join(60)
    th.join(60)
    assert not gen.is_alive() and not th.is_alive()
    assert result["finished"] and result["image_base64"]
    assert not eng.is_running and not eng.engine.has_unfinished_requests()


# -- the CLI -----------------------------------------------------------------


ARGVS = [
    [],
    ["--model", "sdxl", "--dtype", "float32", "--seed", "4", "--test-tiny",
     "--no-patched", "--sampler", "ddim", "--policy", "esymred",
     "--max-batchsize", "4", "--no-mixed-resolution", "--slo", "2.5"],
    ["--use-cache", "--cache-mode", "deep", "--deep-interval", "3",
     "--deep-warmup", "2", "--deep-adaptive", "0.3", "--deep-max-interval",
     "9", "--deep-row-warmup", "--compact-fraction", "0.25",
     "--collect-data", "--prewarm", "--dp", "2", "--tp", "2", "--sp", "2",
     "--model-path", "/nonexistent"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_config_matches_jax(argv):
    """The same flags give the same Config as the JAX CLI; the port adds
    ``--device`` (default cuda), and its decode gate's bytes per pixel
    are the card's float32 SDXL decode's, not the JAX package's bf16
    ones."""
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_add_engine_args(jp)
    add_engine_args(tp)
    targs = tp.parse_args(argv)
    assert targs.device == "cuda"
    got = config_from_args(targs).to_dict()
    want = jax_config_from_args(jp.parse_args(argv)).to_dict()
    assert (got["engine"].pop("decode_bytes_per_pixel"),
            want["engine"].pop("decode_bytes_per_pixel")) == (3585.0, 768.0)
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--dp", "2"], ["--tp", "2"], ["--sp", "2"],
    ["--use-cache", "--cache-mode", "block"],
    ["--use-cache", "--cache-mode", "compact"],
    ["--prewarm"], ["--model-path", "/nonexistent/snapshot"],
])
def test_unported_flags_raise(flags):
    """A snapshot that is not there raises; ``--use-cache`` in modes
    "block" and "compact" serves (one mixed step of finite latents through
    the cache), and so do ``--prewarm`` (the engine it configures serves
    the same step), ``--dp 2`` (two replicas, one request each), ``--tp
    2`` and ``--sp 2`` (one replica over two shards, the patch batch split
    over them under sp)."""
    p = argparse.ArgumentParser()
    add_engine_args(p)
    config = config_from_args(p.parse_args(
        ["--test-tiny", "--dtype", "float32"] + flags))
    if ("--use-cache" in flags or "--prewarm" in flags or "--dp" in flags
            or "--tp" in flags or "--sp" in flags):
        assert config.engine.prewarm == ("--prewarm" in flags)
        config.scheduler.patch_size = 64
        engine = Engine(config, "cpu")
        for i, res in enumerate((64, 128)):  # a mixed batch
            engine.add_request(f"c{i}", SamplingParams(
                prompt="a cat", resolution=res, num_inference_steps=1,
                seed=i, output_type="latent"))
        outs = []
        while engine.has_unfinished_requests():
            outs += engine.step()
        if "--use-cache" in flags:
            assert engine.workers[0].pipeline._cache_obj is not None
        if "--dp" in flags:
            assert [w.iteration > 0 for w in engine.workers] == [True] * 2
        if "--tp" in flags:
            assert engine.workers[0].pipeline.group.tp == 2
        if "--sp" in flags:
            assert engine.workers[0].pipeline.group.sp == 2
        assert all(o.finished and np.isfinite(o.image).all() for o in outs)
        return
    error = FileNotFoundError if "--model-path" in flags \
        else NotImplementedError
    with pytest.raises(error):
        Engine(config, "cpu")


def test_main_and_async_engine_need_a_gpu_unless_told_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api_server.main(["--test-tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncEngine(port_config())
    # --device cpu serves; main returns once the server closes
    done = threading.Event()
    real = api_server.build_server

    async def build(engine, host, port):
        server = await real(engine, "127.0.0.1", 0)
        server.close()
        done.set()
        return server

    monkeypatch.setattr(api_server, "build_server", build)
    api_server.main(["--test-tiny", "--dtype", "float32", "--device", "cpu"])
    assert done.is_set()
