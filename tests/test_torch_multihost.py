"""Multi-host start-up and replica placement over sp x tp groups in the
port, against the JAX package on CPU.

- ``multihost.initialize``: two processes join one gloo world at an
  explicit ``tcp://`` coordinator and ``all_reduce`` a tensor (ranks 1 and
  2 sum to 3 on both).
- ``local_replica_devices`` slices a host's cards like JAX's
  ``local_replica_devices`` slices its local devices (8 cards, stubbed,
  against JAX's 8 virtual CPU devices).
- ``build_placements``: a replica owns ``sp * tp`` consecutive entries of
  the device list (repeats allowed), the same device indices as JAX's
  ``build_placements``; too few devices raise JAX's "need n devices".
- The Engine over groups: the capacity gate counts every shard's slices
  on a device; ``/stats`` lists a group replica's devices; ``pp > 1`` is
  refused naming ``MMDiTStagePipeline``.
- A group's collectives and the kernels' launch counter under
  contention: 16 shard threads, a shortened switch interval.
- Shards whose collectives differ (one returns while another calls one
  more, or calls one the other skips) and a shard that outlasts the
  turn timeout: the run raises within seconds; after differing
  collectives the group serves the next run, after a hung shard it
  refuses every later one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.parallel import multihost as jmultihost
from sduss_tpu.parallel.replica import build_placements as jax_placements
from sduss_tpu_torch.engine.engine import Engine, check_supported
from sduss_tpu_torch.entrypoints.api_server import device_stats
from sduss_tpu_torch.parallel import multihost
from sduss_tpu_torch.parallel.replica import build_placements
from test_torch_dp import port_config
from test_torch_slice import torch_threads  # noqa: F401
from test_torch_sp import bundle  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from sduss_tpu_torch.parallel.multihost import initialize
    initialize(sys.argv[1], 2, int(sys.argv[2]), backend="gloo",
               timeout_s=60)
    x = torch.full((3,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    print(f"rank {dist.get_rank()} of {dist.get_world_size()} sum "
          f"{x.tolist()}")
    dist.destroy_process_group()
""")


def test_two_process_all_reduce():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, f"127.0.0.1:{port}", str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"rank {rank} of 2 sum [3.0, 3.0, 3.0]" in out, out[-2000:]


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_local_replica_devices_match_jax(dp, monkeypatch):
    want = [[d.id for d in s] for s in jmultihost.local_replica_devices(dp)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got = [[d.index for d in s] for s in multihost.local_replica_devices(dp)]
    assert got == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert multihost.local_replica_devices(1) == [[torch.device("cpu")]]


@pytest.mark.parametrize("dp,sp,tp", [(1, 2, 1), (1, 1, 2), (2, 2, 2),
                                      (4, 1, 2), (1, 2, 4), (2, 4, 1)])
def test_placements_slice_like_jax(dp, sp, tp, monkeypatch):
    want = [list(p.mesh.devices.reshape(-1)) if p.mesh is not None
            else [p.device] for p in jax_placements(dp, sp, tp)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got = build_placements(dp, sp, tp)
    assert [[d.index for d in devs] for devs in got] == \
        [[d.id for d in devs] for devs in want]
    # an explicit list, repeats allowed: consecutive entries a replica
    devs = [0] * (dp * sp * tp)
    assert build_placements(dp, sp, tp, devices=devs) == \
        [[torch.device("cuda", 0)] * (sp * tp)] * dp
    with pytest.raises(ValueError, match="need"):
        build_placements(dp, sp, tp, devices=devs[:-1])
    assert build_placements(dp, sp, tp, base="cpu") == \
        [[torch.device("cpu")] * (sp * tp)] * dp


def test_engine_counts_every_shard(bundle):  # noqa: F811
    """tp=2 on the CPU: the capacity gate's held bytes count the bundle's
    storages once and each shard's own (row-parallel slices and GEGLU
    halves are copies, dim-0 slices views of the bundle's storages);
    /stats lists the replica's devices; pp is refused."""
    config = port_config(dp=1)
    config.parallel.tp = 2
    engine = Engine(config, "cpu", bundle=bundle)
    pipe = engine.workers[0].pipeline
    cpu = torch.device("cpu")

    def storages(tensors):
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}

    shard_only = storages(pipe.denoiser.param_tensors())
    bundle_bytes = storages(t for m in bundle.models.values()
                            for t in list(m.parameters())
                            + list(m.buffers()))
    extra = sum(v for k, v in shard_only.items() if k not in bundle_bytes)
    assert extra > 0
    assert engine._held_bytes(cpu) == sum(bundle_bytes.values()) + extra
    assert pipe.device_param_bytes() == engine._held_bytes(cpu)
    rows = device_stats(engine)
    assert rows[0]["devices"] == ["cpu", "cpu"]
    config.parallel.pp = 2
    with pytest.raises(NotImplementedError, match="MMDiTStagePipeline"):
        check_supported(config)
    assert jax.device_count() == 8 and np.isfinite(extra)


def test_group_collectives_under_contention():
    """16 shard threads (sp=4 x tp=4, more than this machine's cores) run
    200 rounds of psum, all_gather and ppermute with a shortened switch
    interval: every result is exact (a slot read before its writer
    deposited it, or overwritten before a peer read it, breaks a sum),
    and the kernels' launch counter, added to from every thread, loses no
    update."""
    from sduss_tpu_torch.ops import _build
    from sduss_tpu_torch.parallel.group import ShardGroup

    def counted():
        pass

    counted.launches = 0
    group = ShardGroup(["cpu"] * 16, sp=4, tp=4, timeout=60.0)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(rank):
            i, j = group.coords(rank)
            for step in range(200):
                x = torch.full((3,), float(rank * 1000 + step))
                s = group.psum(x, "tp")
                g = group.all_gather(x, "sp", 0)
                p = group.ppermute(x, "sp", [(k, (k + 1) % 4)
                                             for k in range(4)])
                want_s = sum(float((i * 4 + k) * 1000 + step)
                             for k in range(4))
                assert s.tolist() == [want_s] * 3
                assert g[::3].tolist() == [float((k * 4 + j) * 1000 + step)
                                           for k in range(4)]
                src = ((i - 1) % 4) * 4 + j
                assert p.tolist() == [float(src * 1000 + step)] * 3
                _build.count(counted)
            return rank

        assert group.run(body) == list(range(16))
    finally:
        sys.setswitchinterval(saved)
        group.close()
    assert counted.launches == 16 * 200


def _skips_last(group, rank):  # shard 1 makes one more collective
    group.psum(torch.ones(1), "sp")
    if rank == 1:
        group.psum(torch.ones(1), "sp")
    return rank


def _returns_first(group, rank):  # shard 0 makes none
    if rank != 0:
        group.all_gather(torch.ones(1), "sp", 0)
    return rank


def _other_collective(group, rank):  # shard 1 skips one of three
    group.psum(torch.ones(1), "sp")
    if rank != 1:
        group.ppermute(torch.ones(1), "sp", [(0, 1), (1, 2), (2, 0)])
    group.psum(torch.ones(1), "sp")
    return rank


def _sleeps(group, rank):  # shard 1 holds its turn past the timeout
    group.psum(torch.ones(1), "sp")
    if rank == 1:
        time.sleep(3.0)
    group.psum(torch.ones(1), "sp")
    return rank


@pytest.mark.parametrize("body,error,match", [
    (_skips_last, RuntimeError, "collectives differ"),
    (_returns_first, RuntimeError, "collectives differ"),
    (_other_collective, RuntimeError, "collectives differ"),
    (_sleeps, TimeoutError, "for its turn|in time"),
], ids=["one-more", "returns-first", "skips-one", "timeout"])
def test_group_raises_when_shards_diverge(body, error, match):
    from sduss_tpu_torch.parallel.group import ShardGroup

    group = ShardGroup(["cpu"] * 3, sp=3, timeout=0.5)
    try:
        t0 = time.perf_counter()
        with pytest.raises(error, match=match):
            group.run(lambda r: body(group, r))
        assert time.perf_counter() - t0 < 10.0
        if body is _sleeps:
            with pytest.raises(RuntimeError, match="unusable"):
                group.run(lambda r: r)
            return
        out = group.run(lambda r: group.psum(torch.ones(1) * r, "sp"))
        assert [float(o) for o in out] == [3.0] * 3
    finally:
        group.close()
