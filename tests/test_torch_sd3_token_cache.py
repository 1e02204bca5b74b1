"""The port's MMDiT token caches against the JAX package, on the CPU in
float32.

Module parity: the tiny MMDiT's ``apply_tokens`` (16 + 64 latent tokens
padded to 64 and a padded row) over three steps whose inputs drift by a
different amount per row, under each gate of ``cache/manager.py``:
``gate`` (mode "block"), ``gate_compact`` on the ``{"x", "c"}`` rows
(mode "compact", the first step anchoring at full capacity, with and
without ``compact_predict``) and ``gate_tokens_fine`` (``patch_fraction``
0.5) with and without stale K/V.  The selected rows and tokens of every
gate call must equal JAX's exactly, the outputs (on the real tokens of
the real rows) and the carried state within RTOL 2e-4 / ATOL 5e-4, both
sides eager on the same weights.  At fraction 1 each gate must give the
plain forward (the fine gate selects every token at 0.999).

Slice parity: the tiny SD3 pipeline of both packages (``denoise_step``:
a cached batch takes the token path even at one resolution) under each
mode, and the span cache over the fine gate with stale K/V: final
latents within 1e-3 of their scale, and the same trunk programs (sync,
stale, deep mode) in the same order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.cache.manager import BlockCache as JaxBlockCache
from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig

from test_torch_sd3_deep import (CFG, _args, _close, _latents_close, both,  # noqa: F401
                                 mmdit, run_slice, token_batch)
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
STEPS = 3

MODES = {
    "block": dict(mode="block", mse_threshold=0.02),
    "compact": dict(mode="compact", compact_fraction=0.5),
    "compact-predict": dict(mode="compact", compact_fraction=0.5,
                            compact_predict=0.5),
    "fine": dict(mode="compact", patch_fraction=0.5),
    "fine-stale-kv": dict(mode="compact", patch_fraction=0.5,
                          fine_stale_kv=True),
}


def _state0(cache, n_rows, seq, *, jax_side: bool, fine: bool, kv: bool,
            ctx_seq=None):
    """Fresh rows for every block, from the JAX or the port gate."""
    out = {}
    for i in range(CFG.num_layers):
        key = f"block{i}"
        pairs = (2 if i in CFG.dual_attention_layers else 1) if kv else 0
        dtype = jnp.float32 if jax_side else torch.float32
        if fine:
            out[key] = cache.init_token_rows_fine(key, n_rows, seq, CFG.dim,
                                                  dtype, kv_pairs=pairs)
        else:
            out[key] = cache.init_token_rows(key, n_rows, seq, CFG.dim, dtype,
                                             ctx_seq=ctx_seq)
    return out


def _spy(cache, name, record):
    """Record the selection of every call of ``cache.<name>``."""
    real = getattr(cache, name)
    field = {"gate": "fresh", "gate_compact": "idx",
             "gate_tokens_fine": "sel"}[name]

    def spy(*a, **kw):
        y, st, stats = real(*a, **kw)
        record.append(np.asarray(stats[field]))
        return y, st, stats

    setattr(cache, name, spy)


def _steps(batch):
    """Three steps of inputs: row r drifts by (r + 1) * 5% a step."""
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(batch["tokens"].shape).astype(np.float32)
    scale = np.asarray([0.05, 0.10, 0.15], np.float32)[:, None, None]
    for s in range(STEPS):
        step = dict(batch)
        step["tokens"] = batch["tokens"] + s * scale * noise
        step["t"] = batch["t"] - 60.0 * s
        yield s, step


def _gate_name(kw):
    if kw["mode"] == "block":
        return "gate"
    return "gate_tokens_fine" if kw.get("patch_fraction", 1.0) < 1.0 \
        else "gate_compact"


def _run_module(mmdit, batch, kw, jax_side: bool, record=None):
    """Three gated steps; returns each step's output and the final state."""
    p, model, jm = mmdit
    ccls, bcls = ((JaxCacheConfig, JaxBlockCache) if jax_side
                  else (CacheConfig, BlockCache))
    cache = bcls(ccls(enabled=True, max_hits=2, **kw))
    if record is not None:
        _spy(cache, _gate_name(kw), record)
    fine = kw.get("patch_fraction", 1.0) < 1.0
    compact = kw["mode"] == "compact" and not fine
    state = _state0(cache, 3, 64, jax_side=jax_side, fine=fine,
                    kv=kw.get("fine_stale_kv", False),
                    ctx_seq=batch["ehs"].shape[1] if compact else None)
    row_valid = np.asarray([True, True, False])
    outs = []
    for s, step in _steps(batch):
        extra = dict(cache=cache, cache_state=state,
                     fine_kv_stale=kw.get("fine_stale_kv", False) and s > 0,
                     compact_sync=compact and s == 0)
        if jax_side:
            out, state = jm.apply_tokens(p, *_args(step, False),
                                         row_valid=jnp.asarray(row_valid),
                                         **extra)
        else:
            with torch.no_grad():
                out = model.apply_tokens(*_args(step, True),
                                         row_valid=torch.from_numpy(row_valid),
                                         **extra)
        outs.append(out)
    return outs, state


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", list(MODES))
def test_gates_equal_jax(mmdit, token_batch, name):
    kw = MODES[name]
    jsel, tsel = [], []
    jouts, jstate = _run_module(mmdit, token_batch, kw, True, jsel)
    touts, tstate = _run_module(mmdit, token_batch, kw, False, tsel)
    assert len(tsel) == len(jsel) == STEPS * CFG.num_layers
    for t_, j in zip(tsel, jsel):
        np.testing.assert_array_equal(t_, j)
    lens = token_batch["lens"]
    for t_out, j_out in zip(touts, jouts):
        for i, n in enumerate(lens):
            _close(t_out[i, :n], np.asarray(j_out)[i, :n])
    tl, jl = dict(_leaves(tstate)), dict(_leaves(jstate))
    assert sorted(tl) == sorted(jl)
    for path, leaf in tl.items():
        if path.endswith("hits") or path.endswith("seen"):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jl[path]),
                                          err_msg=path)
        else:
            np.testing.assert_allclose(leaf.numpy()[:2], np.asarray(jl[path])[:2],
                                       rtol=RTOL, atol=ATOL, err_msg=path)
    # the gates selected something short of everything after the first step
    later = np.concatenate([np.asarray(x).ravel() for x in tsel[2:]])
    if name == "block":
        assert not later.all() and later.any()


@pytest.mark.parametrize("kw", [
    dict(mode="block", mse_threshold=-1.0),
    dict(mode="compact", compact_fraction=1.0),
    dict(mode="compact", patch_fraction=0.999),
    dict(mode="compact", patch_fraction=0.999, fine_stale_kv=True),
], ids=["block", "compact", "fine", "fine-stale-kv"])
def test_gates_exact_at_full_fraction(mmdit, token_batch, kw):
    """Every row (every token) recomputed every step: the gated trunk is
    the plain one."""
    model = mmdit[1]
    outs, _ = _run_module(mmdit, token_batch, kw, False)
    for (s, step), out in zip(_steps(token_batch), outs):
        with torch.no_grad():
            plain = model.apply_tokens(*_args(step, True))
        for i, n in enumerate(token_batch["lens"]):
            np.testing.assert_allclose(out[i, :n].numpy(), plain[i, :n].numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_gate_compact_without_state_runs_every_row():
    cache = BlockCache(CacheConfig(enabled=True, mode="compact"))
    x = torch.arange(12.0).reshape(3, 4)
    seen = []

    def fn(x_c, idx):
        seen.append(idx.tolist())
        return {"x": 2 * x_c, "c": x_c[:, :1]}

    y, st, stats = cache.gate_compact("block0", x, None, None, fn, 1)
    assert st is None and stats is None and seen == [[0, 1, 2]]
    assert torch.equal(y["x"], 2 * x) and torch.equal(y["c"], x[:, :1])


# -- the slice ----------------------------------------------------------------

SLICE = {
    "block": dict(mode="block", max_hits=2, mse_threshold=0.02),
    "compact": dict(mode="compact", compact_fraction=0.5, max_hits=2),
    "fine": dict(mode="compact", patch_fraction=0.5, max_hits=2),
    "fine-stale-kv": dict(mode="compact", patch_fraction=0.5, max_hits=2,
                          fine_stale_kv=True),
    "span-fine-stale-kv": dict(mode="compact", patch_fraction=0.5,
                               max_hits=2, fine_stale_kv=True,
                               sd3_deep_span=(1, 2), deep_interval=3,
                               deep_warmup=1),
}


@pytest.mark.parametrize("name", list(SLICE))
def test_token_cache_slice_equals_jax(both, name):
    jmodes, calls = [], {}
    jpipe = both[0]
    jit = jpipe._jit

    def spy(key, fn, donate=()):  # the trunk programs, in order
        if isinstance(key, tuple) and key[0] == "sd3_mixed":
            jmodes.append(key[3:])
        return jit(key, fn, donate)

    jpipe._jit = spy
    try:
        tmodes, _, lat, jlat, tpipe = run_slice(
            both, dict(enabled=True, **SLICE[name]), [64, 64, 128],
            trunk_calls=calls)
    finally:
        jpipe._jit = jit
    want = [(True, kw["compact_sync"], kw["fine_kv_stale"],
             kw.get("deep_mode")) for kw in calls["port"]]
    assert want == jmodes, (want, jmodes)
    _latents_close(lat, jlat)
    (entry,) = tpipe._sd3_state.values()
    assert entry["anchored"]
    assert entry["kv_ok"] == SLICE[name].get("fine_stale_kv", False)
