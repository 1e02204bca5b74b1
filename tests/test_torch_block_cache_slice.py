"""The port's block and compact caches against the JAX package's, through
the pipelines' steps (CPU, float32).

Tiny SD-1.5 and tiny SDXL pipelines with the same numpy weights
(``jax_to_torch_state_dict``), prompts and seeds run 4 steps of
2 x 128^2 + 64^2 at 64 px patches (patch grids 2, 2, 1: the composition
of tests/test_cache.py's 512^2 + 256^2 at 256 px patches, one patched
step each) under:

- mode "block" with a relative-MSE threshold and with the committed
  classifiers ``exp/cache_classifiers_sd15_v5e.npz`` (their keys are the
  tiny SD-1.5's layout at ``min_level`` 1);
- mode "compact" at fraction 0.5 with ``min_level`` 1, at
  ``patch_fraction`` 1.0 (whole images) and 0.5 (two-level rows);
- mode "compact" on the dense path: 3 x 64^2 (bucket 4, a pad row) at
  fraction 0.5, the first step the anchoring one at full capacity.

Final latents must equal JAX's within RTOL 2e-4 / ATOL 5e-4; every
request's rows (the patch path) or the composition entry's rows (dense)
must hold the same ``hits`` exactly, which the selections of every gated
step decide, and the same ``inp``/``out`` (the port's NCHW rows
transposed) within the same tolerance.  The selections themselves are
held per gate call in tests/test_torch_block_cache.py.  Each JAX run
builds its own pipeline on the shared bundle: the JAX step program's key
holds no cache mode.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.config import Config as JaxConfig
from sduss_tpu.config import ModelConfig as JaxModelConfig
from sduss_tpu.models.loader import load_bundle
from sduss_tpu.models.registry import ModelBundle as JaxBundle
from sduss_tpu.pipelines import build_pipeline as jax_build_pipeline
from sduss_tpu.request import Request as JaxRequest
from sduss_tpu.request import SamplingParams as JaxSamplingParams
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.pipelines import build_pipeline
from sduss_tpu_torch.request import Request, SamplingParams
from test_torch_slice import _np_init, torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
PATCH = 64
STEPS = 4
PLAN = [("r0", 128, 0), ("r1", 128, 1), ("rx", 64, 7)]
DENSE_PLAN = [("d0", 64, 0), ("d1", 64, 1), ("d2", 64, 2)]
CLASSIFIERS = "exp/cache_classifiers_sd15_v5e.npz"
CASES = {
    "block": dict(enabled=True, mse_threshold=0.05, max_hits=2),
    "block-classifier": dict(enabled=True, classifier_path=CLASSIFIERS,
                             max_hits=2),
    "compact": dict(enabled=True, mode="compact", compact_fraction=0.5,
                    max_hits=2),
    "compact-two-level": dict(enabled=True, mode="compact",
                              compact_fraction=0.5, patch_fraction=0.5,
                              max_hits=3),
}


def make_bundles(family: str):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBundle, "init_random", _np_init)
        jbundle = load_bundle(family, tiny=True, seed=3)
    bundle = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
    bundle.load_state_dicts({
        role: jax_to_torch_state_dict(role, jax.tree.map(np.asarray, p))
        for role, p in jbundle.params.items()})
    return jbundle, bundle


def jax_pipeline(family, jbundle, cache: dict):
    config = JaxConfig()
    config.model = JaxModelConfig(model=family, dtype="float32",
                                  test_tiny=True, seed=3)
    config.scheduler.patch_size = PATCH
    config.cache = JaxCacheConfig(**cache)
    return jax_build_pipeline(config, bundle=jbundle)


def port_pipeline(family, bundle, cache: dict):
    config = default_config(family, dtype="float32", test_tiny=True)
    config.scheduler.patch_size = PATCH
    config.cache = CacheConfig(**cache)
    return build_pipeline(config, "cpu", bundle=bundle)


def requests(request_cls, params_cls, plan=PLAN):
    return [request_cls(rid, params_cls(
        prompt=f"a prompt for {rid}", negative_prompt="blurry",
        resolution=res, num_inference_steps=STEPS, seed=seed))
        for rid, res, seed in plan]


def by_res(reqs) -> dict:
    out = {}
    for r in reqs:
        out.setdefault(r.resolution, []).append(r)
    return out


def drive(pipe, reqs, mixed=True, prepare=True):
    if prepare:
        pipe.prepare(reqs)
    for _ in range(STEPS):
        (pipe.denoise_step_mixed if mixed else pipe.denoise_step)(
            by_res(reqs))
    return [np.asarray(r.latents, np.float32) for r in reqs]


def nhwc(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def assert_rows_equal(port_rows: dict, jax_rows: dict, what: str):
    """Same keys, hits exactly, inp/out within tolerance."""
    assert set(port_rows) == set(jax_rows), what
    for key in port_rows:
        p, j = port_rows[key], jax_rows[key]
        np.testing.assert_array_equal(p["hits"].numpy(), np.asarray(j["hits"]),
                                      err_msg=f"{what} {key} hits")
        for leaf in ("inp", "out"):
            np.testing.assert_allclose(nhwc(p[leaf]), np.asarray(j[leaf]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {key} {leaf}")


@pytest.fixture(scope="module")
def sd15():
    jbundle, bundle = make_bundles("sd15")
    prepared = requests(JaxRequest, JaxSamplingParams)
    jax_pipeline("sd15", jbundle, {}).prepare(prepared)
    return jbundle, bundle, prepared


@pytest.mark.parametrize("case", sorted(CASES))
def test_patch_path_equals_jax(sd15, case):
    jbundle, bundle, prepared = sd15
    jreqs = copy.deepcopy(prepared)
    want = drive(jax_pipeline("sd15", jbundle, CASES[case]), jreqs,
                 prepare=False)
    reqs = requests(Request, SamplingParams)
    got = drive(port_pipeline("sd15", bundle, CASES[case]), reqs)
    for g, w, (rid, _, _) in zip(got, want, PLAN):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=rid)
    hits = []
    for r, j in zip(reqs, jreqs):
        assert_rows_equal(r.cache_rows, j.cache_rows, f"{case} {r.request_id}")
        hits += [int(v["hits"].max()) for v in r.cache_rows.values()]
    # min_level 1: the level-0 pairs are computed plainly
    assert set(reqs[0].cache_rows) == {"down1.0", "mid", "up0.0", "up0.1"}
    if case != "block-classifier":
        assert max(hits) >= 1  # a row was reused at least once


def test_dense_compact_equals_jax(sd15):
    """Dense compact at 0.5 over a bucket with a pad row: the sync step
    anchors every row, then each gated pair recomputes 4 of its 8 rows."""
    jbundle, bundle, _ = sd15
    cache = CASES["compact"]
    jpipe = jax_pipeline("sd15", jbundle, cache)
    want = drive(jpipe, requests(JaxRequest, JaxSamplingParams, DENSE_PLAN),
                 mixed=False)
    pipe = port_pipeline("sd15", bundle, cache)
    got = drive(pipe, requests(Request, SamplingParams, DENSE_PLAN),
                mixed=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    (key, entry), = pipe._comp_state.items()
    (jkey, jentry), = jpipe._comp_state.items()
    assert key == jkey == ("unet_compact", 64, 4, ("d0", "d1", "d2"),
                           ("BlockCache", 1, 0.5))
    assert entry["anchored"] and jentry["anchored"]
    assert_rows_equal(entry["state"], jentry["state"], "dense compact")
    assert int(entry["state"]["mid"]["hits"].max()) >= 1


def test_sdxl_two_level_equals_jax():
    """SDXL's linear projections under the two-level rows."""
    jbundle, bundle = make_bundles("sdxl")
    cache = CASES["compact-two-level"]
    jreqs = requests(JaxRequest, JaxSamplingParams)
    want = drive(jax_pipeline("sdxl", jbundle, cache), jreqs)
    reqs = requests(Request, SamplingParams)
    got = drive(port_pipeline("sdxl", bundle, cache), reqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for r, j in zip(reqs, jreqs):
        assert_rows_equal(r.cache_rows, j.cache_rows, f"sdxl {r.request_id}")
