"""The port's classifier training (``cache/train.py``) against the JAX
package's (CPU, float32).

- ``collect_traces`` on the tiny SD-1.5 patch path (2 x 128^2 + 64^2 at
  64 px patches, 4 steps) and on the tiny SD3 token path (64^2 + 128^2,
  4 steps), both packages on the same numpy weights, prompts and seeds:
  the same blocks, the same number of rows, and each row's ``rel_in``,
  ``t`` and ``rel_out`` within RTOL 2e-4 / ATOL 5e-4.
- ``fit_logistic`` and ``fit_classifiers`` on the same data give JAX's
  weights within 1e-6 (the port's copy of the numpy code), and the
  classifiers fitted on each package's own traces agree to 1e-6.
- ``python -m sduss_tpu_torch.cache.train --device cpu --tiny`` writes an
  npz that ``BlockCache`` loads, one ``(4,)`` classifier per gated pair.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sduss_tpu.cache import train as jtrain
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.cache import train
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_block_cache_slice import PLAN, make_bundles, requests
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
STEPS = 4


def assert_traces_equal(port: dict, want: dict):
    assert set(port) == set(want) and port
    for key in want:
        got, ref = np.asarray(port[key]), np.asarray(want[key])
        assert got.shape == ref.shape, key
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def traces_of(family, config_kw, plan, patch=None):
    jbundle, bundle = make_bundles(family)
    jconfig = JaxConfig()
    jconfig.model = JaxModelConfig(model=family, dtype="float32",
                                   test_tiny=True, seed=3, **config_kw)
    config = default_config(family, dtype="float32", test_tiny=True,
                            **config_kw)
    if patch:
        jconfig.scheduler.patch_size = config.scheduler.patch_size = patch
    want = jtrain.collect_traces(jax_build_pipeline(jconfig, bundle=jbundle),
                                 requests(JaxRequest, JaxSamplingParams, plan),
                                 steps=STEPS)
    pipe = build_pipeline(config, "cpu", bundle=bundle)
    got = train.collect_traces(pipe, requests(Request, SamplingParams, plan),
                               steps=STEPS)
    assert isinstance(pipe._cache_obj, train.TraceCache)
    assert pipe.config.cache.enabled and pipe.config.cache.mode == "block"
    return got, want


@pytest.fixture(scope="module")
def sd15_traces():
    return traces_of("sd15", {}, PLAN, patch=64)


class TestClassifierTraining:
    def test_fit_logistic_separable(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(400, 2))
        y = (x[:, 0] > 0.3).astype(np.float64)
        w = train.fit_logistic(x, y)
        pred = (x @ w[:-1] + w[-1]) > 0
        assert (pred == y.astype(bool)).mean() > 0.95
        np.testing.assert_allclose(w, jtrain.fit_logistic(x, y), rtol=1e-6,
                                   atol=1e-6)

    def test_collect_and_fit(self, sd15_traces, tmp_path):
        got, want = sd15_traces
        assert_traces_equal(got, want)
        # 3 traced steps x (8 + 8 + 2) doubled patch rows a block
        assert {len(v) for v in got.values()} == {3 * 18}
        out = train.fit_classifiers(got, 0.01, str(tmp_path / "clf.npz"))
        jout = jtrain.fit_classifiers(want, 0.01)
        same = train.fit_classifiers(want, 0.01)
        assert set(out) == set(jout) == set(got)
        loaded = np.load(tmp_path / "clf.npz")
        for k in jout:
            assert loaded[k].shape == (4,)
            np.testing.assert_allclose(same[k], jout[k], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(out[k], jout[k], rtol=1e-6, atol=1e-6)

    def test_trained_classifier_loads_into_cache(self, tmp_path):
        path = str(tmp_path / "clf.npz")
        np.savez(path, mid=np.asarray([10.0, 0.0, 0.0, -0.05]))
        cache = BlockCache(CacheConfig(classifier_path=path))
        np.testing.assert_array_equal(cache.classifiers["mid"],
                                      [10.0, 0.0, 0.0, -0.05])


class TestTraceTrainSD3:
    def test_collect_and_fit_token_classifiers(self):
        got, want = traces_of("sd3", dict(resolutions=(64, 128)),
                              [("t0", 64, 0), ("t1", 128, 1)])
        assert_traces_equal(got, want)
        assert all(k.startswith("block") for k in got)
        clf = train.fit_classifiers(got, reuse_threshold=0.01)
        jclf = jtrain.fit_classifiers(want, reuse_threshold=0.01)
        for k, w in clf.items():
            assert w.shape == (4,)
            np.testing.assert_allclose(w, jclf[k], rtol=1e-6, atol=1e-6)


def test_cli_writes_classifiers_the_cache_loads(tmp_path):
    out = str(tmp_path / "clf.npz")
    fitted = train.main(["--family", "sd15", "--tiny", "--dtype", "float32",
                         "--steps", "3", "--resolutions", "256",
                         "--device", "cpu", "--out", out])
    cache = BlockCache(CacheConfig(enabled=True, classifier_path=out))
    layout = tunet.UNet2DConditionModel.cache_layout(
        type("U", (), {"cfg": tunet.TINY_UNET})(), 32, 1)
    assert set(cache.classifiers) == set(fitted) == set(layout)
    assert all(w.shape == (4,) for w in cache.classifiers.values())


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--tiny"])
