"""The port's stage profiler (``scheduler/profiler.py``) against the JAX
package's, on the CPU.

With ``step_latency`` and ``post_latency`` replaced by one deterministic
function of the mix in both packages, ``build_profile`` (the batch points,
the interpolation and the extrapolation past a batch that runs out of
memory), the mixes ``predictor_samples`` measures and the fitted predictor
weights equal JAX's (within 1e-12).  The JAX ``tests/test_profiler.py``
checks run on the tiny port at 64/128 px with 64 px patches: a positive
single step, a positive mixed step through the patch path, a profile that
loads into ``StageProfile``, and a predictor that survives a save/load.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from sduss_tpu.scheduler.profiler import Profiler as JaxProfiler
from sduss_tpu_torch.scheduler.predictor import LatencyPredictor
from sduss_tpu_torch.scheduler.profiler import Profiler
from sduss_tpu_torch.scheduler.profiles import StageProfile, get_profile
from test_torch_slice import torch_threads  # noqa: F401

RES = (256, 512, 768)


def fake_step(log):
    def step_latency(counts, iters=5):
        log.append((dict(counts), iters))
        return sum(c * (0.004 + 1e-3 * (r / 256) ** 2.3)
                   for r, c in counts.items()) + 0.0007 * len(counts)
    return step_latency


def fake_post(res, batch, iters=3):
    if res == 768 and batch == 8:  # the device's memory runs out
        raise torch.cuda.OutOfMemoryError("out of memory")
    return 0.003 + batch * 0.011 * (res / 256) ** 2 + 1e-4 * batch ** 1.5


def faked(prof):
    log = []
    prof.step_latency = fake_step(log)
    prof.post_latency = fake_post
    return prof, log


def test_products_equal_jax(tmp_path):
    jprof, jlog = faked(JaxProfiler("sd15", tiny=True, dtype="float32",
                                    resolutions=RES))
    tprof, tlog = faked(Profiler("sd15", tiny=True, dtype="float32",
                                 resolutions=RES, device="cpu"))
    want, got = jprof.build_profile(), tprof.build_profile()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert len(got["post_batch_latency"]["768"]) == 8
    StageProfile(**got)

    jprof.fit_predictor(str(tmp_path / "jax.npz"))
    tprof.fit_predictor(str(tmp_path / "port.npz"))
    assert tlog == jlog and len(tlog) == len(RES) + 9
    jw, tw = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(tw["resolutions"], jw["resolutions"])
    np.testing.assert_allclose(tw["weights"], jw["weights"], rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def prof():
    p = Profiler("sd15", tiny=True, dtype="float32", resolutions=(64, 128),
                 device="cpu")
    p.config.scheduler.patch_size = 64  # 64/128 px patch into 1 and 4
    return p


def test_step_latency_positive(prof):
    assert prof.step_latency({64: 1}, iters=2) > 0


def test_mixed_latency_through_the_patch_path(prof, monkeypatch):
    calls = []
    mixed = prof.pipe.denoise_step_mixed
    monkeypatch.setattr(prof.pipe, "denoise_step_mixed",
                        lambda by_res: calls.append(sorted(by_res))
                        or mixed(by_res))
    assert prof.step_latency({64: 1, 128: 1}, iters=2) > 0
    assert calls == [[64, 128]] * 4


def test_build_profile_and_fit(prof, tmp_path):
    profile = prof.build_profile(max_post_batch=2)
    assert set(profile["step_latency"]) == {"64", "128"}
    assert profile["standalone"]["denoising"]["64"] \
        == 50.0 * profile["step_latency"]["64"] > 0
    path = tmp_path / "profile.json"
    with open(path, "w") as f:
        json.dump(profile, f)
    with open(path) as f:
        sp = StageProfile(**json.load(f))
    assert sp.step_latency_s(64) == profile["step_latency"]["64"]
    assert sp.denoising_ddl_s(128) > 0
    assert sp.post_latency_s(128, 2) == profile["post_batch_latency"]["128"][1]


def test_predictor_fit_roundtrip(tmp_path):
    rows = [[1, 0], [0, 1], [1, 1], [2, 0], [2, 1]]
    ys = [0.01, 0.02, 0.028, 0.018, 0.036]
    pred = LatencyPredictor([256, 512], get_profile("sd15"))
    pred.fit(rows, ys)
    p = str(tmp_path / "pred.npz")
    pred.save(p)
    back = LatencyPredictor.load(p, get_profile("sd15"))
    for row, y in zip(rows, ys):
        assert abs(back.predict(row) - y) < 0.01
