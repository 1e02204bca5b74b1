"""The port's UNet deep modes against the JAX package's (CPU, float32).

On the 3-level SDXL-shaped and the 4-level SD-1.5-shaped tiny UNets, at
deep boundaries 1 and 2, one batch of 4 CFG-paired requests (8 rows) with
the same numpy weights (``jax_to_torch_state_dict``) and inputs goes
through the JAX ``apply`` and the port's ``forward``:

- ``deep_mode="full"`` equals the plain forward and JAX's full pass, and
  its deep feature equals JAX's (the port's is NCHW, transposed here);
- ``"shallow"`` fed JAX's deep feature of an earlier timestep equals JAX's
  shallow pass;
- ``"partial"`` with every request selected equals the full pass; with a
  subset (padded with a duplicate, as the pipeline pads) its selected rows
  equal JAX's full pass and the others JAX's shallow pass, the property
  JAX's own partial pass has (tests/test_deep_partial.py);
- ``shallow_cache_layout`` equals JAX's dict.

Tolerance: RTOL 2e-4, ATOL 5e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sduss_tpu.models import unet as junet
from sduss_tpu_torch.models import unet as tunet
from sduss_tpu_torch.models.convert import jax_to_torch_state_dict
from test_torch_models import np_params
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
CONFIGS = {"sdxl3": (tunet.TINY3_SDXL_UNET, junet.TINY3_SDXL_UNET),
           "sd15_4": (tunet.TINY4_SD15_UNET, junet.TINY4_SD15_UNET)}
SUBSET = [1, 3, 3]  # request rows; the duplicate is the pipeline's padding


def nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2)


def torch_inputs(inp):
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
                else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in inp.items()}


def make_inputs(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b, hw = 8, cfg.sample_size
    _, pooled_dim, n_ids = cfg.addition_embed
    return {
        "sample": rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
        "t": np.full((b,), 500.0, np.float32),
        "ehs": (0.3 * rng.standard_normal(
            (b, 77, cfg.cross_attention_dim))).astype(np.float32),
        "added": {"text_embeds": (0.3 * rng.standard_normal(
                      (b, pooled_dim))).astype(np.float32),
                  "time_ids": np.full((b, n_ids), 64.0, np.float32)},
    }


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    tcfg, jcfg = CONFIGS[request.param]
    jmodel = junet.UNet2DConditionModel(jcfg)
    params = np_params(jmodel.init, 5)
    port = tunet.UNet2DConditionModel(tcfg)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          jax_to_torch_state_dict("unet", params).items()},
                         strict=True)
    return jmodel, params, port.eval(), make_inputs(jcfg, 1)


def jax_fn(jmodel, **static):
    """A jitted JAX ``apply`` with the deep mode and boundary bound."""
    def f(params, inp, **arrays):
        return jmodel.apply(params, inp["sample"], inp["t"], inp["ehs"],
                            added_cond=inp["added"], **static, **arrays)
    return jax.jit(f)


def port_apply(port, inp, **kw):
    ti = torch_inputs(inp)
    with torch.inference_mode():
        return port(ti["sample"], ti["t"], ti["ehs"], added_cond=ti["added"],
                    **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """At boundaries 1 and 2: JAX's full pass, the deep feature of an
    earlier timestep (the stale carry) from the same program, and the
    shallow pass fed with that carry."""
    jmodel, params, _, inp = models
    stale_inp = dict(inp, sample=inp["sample"] * 1.1, t=inp["t"] + 100.0)
    runs = {}
    for bdy in (1, 2):
        full_fn = jax_fn(jmodel, deep_mode="full", deep_boundary=bdy)
        full, feat = full_fn(params, inp)
        _, stale = full_fn(params, stale_inp)
        shallow, _ = jax_fn(jmodel, deep_mode="shallow", deep_boundary=bdy)(
            params, inp, deep_state=stale)
        runs[bdy] = {k: np.asarray(v) for k, v in dict(
            full=full, feat=feat, stale=stale, shallow=shallow).items()}
    return runs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_deep_tiny_configs_equal_jax(name):
    tcfg, jcfg = CONFIGS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("bdy", [1, 2])
def test_full_equals_plain_and_jax(models, jax_runs, bdy):
    _, _, port, inp = models
    plain = port_apply(port, inp)
    out, feat = port_apply(port, inp, deep_mode="full", deep_boundary=bdy)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    ref = jax_runs[bdy]
    np.testing.assert_allclose(out.numpy(), ref["full"], rtol=RTOL, atol=ATOL)
    assert feat.shape == nchw(ref["feat"]).shape
    np.testing.assert_allclose(feat.numpy(), nchw(ref["feat"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bdy", [1, 2])
def test_shallow_from_jax_feature_equals_jax(models, jax_runs, bdy):
    _, _, port, inp = models
    ref = jax_runs[bdy]
    stale = torch.from_numpy(nchw(ref["stale"]).copy())
    out, feat = port_apply(port, inp, deep_mode="shallow", deep_boundary=bdy,
                           deep_state=stale)
    assert feat is stale
    np.testing.assert_allclose(out.numpy(), ref["shallow"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bdy", [1, 2])
def test_partial_all_rows_equals_full(models, bdy):
    _, _, port, inp = models
    full, feat = port_apply(port, inp, deep_mode="full", deep_boundary=bdy)
    out, pfeat = port_apply(port, inp, deep_mode="partial", deep_boundary=bdy,
                            deep_state=torch.zeros_like(feat),
                            deep_sel=torch.arange(4))
    torch.testing.assert_close(out, full, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(pfeat, feat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bdy", [1, 2])
def test_partial_subset_equals_jax(models, jax_runs, bdy):
    """The selected requests' rows (both CFG halves) equal JAX's full pass
    and get its fresh features, written into the carry in place; the other
    rows equal JAX's shallow pass and keep the stale carry bit for bit."""
    _, _, port, inp = models
    ref = jax_runs[bdy]
    carry = torch.from_numpy(nchw(ref["stale"]).copy())
    out, pfeat = port_apply(port, inp, deep_mode="partial", deep_boundary=bdy,
                            deep_state=carry,
                            deep_sel=torch.tensor(SUBSET))
    assert pfeat is carry
    sel = [i for i in range(8) if i % 4 in SUBSET]
    rest = [i for i in range(8) if i % 4 not in SUBSET]
    np.testing.assert_allclose(out.numpy()[sel], ref["full"][sel], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy()[rest], ref["shallow"][rest],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pfeat.numpy()[sel], nchw(ref["feat"])[sel],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pfeat.numpy()[rest],
                                  nchw(ref["stale"])[rest])


@pytest.mark.parametrize("bdy", [None, 1, 2])
@pytest.mark.parametrize("cells", [16, 128])
def test_shallow_cache_layout_equals_jax(models, bdy, cells):
    jmodel, _, port, _ = models
    assert port.shallow_cache_layout(cells, bdy) == \
        jmodel.shallow_cache_layout(cells, bdy)


def test_invalid_deep_combinations_raise(models):
    _, _, port, inp = models
    with pytest.raises(ValueError, match="partial"):
        port_apply(port, inp, deep_mode="partial", deep_boundary=1)
