"""Kernels K1 (flash_mha_fused), K2a/K3b (flash_mha), K2b/K3a
(flash_mha_masked) and K5 (flash_cross_short) and the attention dispatch of
the port.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX Pallas kernels in interpret mode and against the JAX dense
path, at hd-64 cases like tests/test_flash.py's.  The masked version is
held against both JAX kernels it replaces: the two-pass kernel (K2b) and
the online-softmax kernel (``force_online=True``, K3a), on rows with at
least one valid key; a batch row with no valid key must be finite (zeros
in the port, a uniform average in JAX).  ``flash_mha`` without a mask is
held against each JAX kernel it replaces: the aligned two-pass kernel
(K2a), the two-pass kernel with a kv_len bias row (ragged keys, or
``kv_len < Lk`` with large garbage in the excluded keys) and the online
kernel (``force_online=True``, K3b).  SD-1.5's head dims 40/80/160 are held
against the JAX kernels like tests/test_flash.py holds them.  K5's plain
version is held against ``flash_cross_short(..., interpret=True)`` on the
cases of tests/test_flash.py, and the dispatcher's short-key route to K5
against the JAX dense path.  The CUDA kernels themselves are
held against the plain versions by tests/test_torch_cuda.py (on a card)
and by chip_smoke.py.  float32 tolerance: RTOL 2e-4, ATOL 5e-4.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.ops.attention import _dense_masked as jax_dense_masked
from sduss_tpu.ops.flash import flash_cross_short as jax_flash_cross_short
from sduss_tpu.ops.flash import flash_mha as jax_flash_mha
from sduss_tpu.ops.flash import flash_mha_fused as jax_flash_mha_fused
from sduss_tpu_torch.models import layers as tlayers
from sduss_tpu_torch.ops import _build
from sduss_tpu_torch.ops import attention as tattn
from sduss_tpu_torch.ops import flash as tflash
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
# the hd-64 cases of tests/test_flash.py::test_mha_fused_matches_dense
CASES = [(2, 512, 512, 4, 64), (2, 640, 250, 2, 64)]


def _mk(b, lq, lk, dm, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, dm)).astype(np.float32),
            rng.standard_normal((b, lk, dm)).astype(np.float32),
            rng.standard_normal((b, lk, dm)).astype(np.float32))


@pytest.mark.parametrize("b,lq,lk,heads,hd", CASES)
def test_plain_matches_jax_kernel_and_dense(b, lq, lk, heads, hd):
    q, k, v = _mk(b, lq, lk, heads * hd)
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_mha_fused(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads, scale).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = jax_flash_mha_fused(jq, jk, jv, heads, scale, block_q=256,
                                 interpret=True)
    dense = jax_dense_masked(jq, jk, jv, heads, None, scale)
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(dense), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hd", [40, 80, 160])
def test_plain_matches_jax_kernels_at_sd15_head_dims(hd):
    """SD-1.5's head dims (8 heads over 320/640/1280 channels): the plain
    version against ``flash_mha_fused`` and ``flash_mha`` in interpret mode
    (tests/test_flash.py's SD-1.5 cases, ragged key tiles)."""
    heads = 2
    q, k, v = _mk(2, 256, 200, heads * hd, seed=hd)
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_mha_fused(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads, scale).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    fused = jax_flash_mha_fused(jq, jk, jv, heads, scale, block_q=128,
                                interpret=True)
    two_pass = jax_flash_mha(jq, jk, jv, heads, scale, block_q=128,
                             block_kv=128, interpret=True)
    np.testing.assert_allclose(out, np.asarray(fused), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(two_pass), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hd", [40, 80, 160])
def test_masked_plain_matches_jax_at_sd15_head_dims(hd):
    """The masked plain version at SD-1.5's head dims against the JAX
    two-pass masked kernel, with a batch row that has no valid key."""
    q, k, v = _mk(3, 130, 260, 2 * hd, seed=hd + 1)
    mask = np.random.default_rng(hd).random((3, 260)) > 0.4
    mask[1] = False
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_mha_masked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(mask),
                                  2, scale).numpy()
    kernel = np.asarray(jax_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, scale,
        kv_mask=jnp.asarray(mask), block_q=128, block_kv=128, interpret=True))
    live = mask.any(axis=1)
    np.testing.assert_allclose(out[live], kernel[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[~live], 0.0)


# The edge cases of the CUDA kernels' K/V ring (64-key tiles, 2 or 3
# slots): one query row, one key, one tile more than the ring holds.  The
# card checks (tests/test_torch_cuda.py, chip_smoke.py) hold the kernels
# against these plain versions there.
RING_EDGES = [
    (1, 200, 64),    # Lq = 1
    (130, 1, 64),    # Lk = 1: one ragged key tile with one key
    (130, 129, 64),  # Lk = 64 * 2 + 1
    (130, 193, 64),  # Lk = 64 * 3 + 1
    (130, 129, 160),
    (130, 193, 160),
    (1, 1, 40),      # both at hd 40
]


@pytest.mark.parametrize("lq,lk,hd", RING_EDGES)
def test_plain_matches_jax_kernels_at_ring_edges(lq, lk, hd):
    """The unmasked plain version against JAX ``flash_mha_fused`` and
    ``flash_mha`` (interpret mode) at the ring's edge shapes."""
    heads = 2
    q, k, v = _mk(2, lq, lk, heads * hd, seed=lq + lk + hd)
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_mha_fused(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads, scale).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    fused = jax_flash_mha_fused(jq, jk, jv, heads, scale, block_q=128,
                                interpret=True)
    two_pass = jax_flash_mha(jq, jk, jv, heads, scale, block_q=128,
                             block_kv=128, interpret=True)
    np.testing.assert_allclose(out, np.asarray(fused), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(two_pass), rtol=RTOL, atol=ATOL)
    if lk == 1:  # softmax over one key: every row is that key's value
        np.testing.assert_allclose(out, np.broadcast_to(v, out.shape),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("online", [False, True])
def test_flash_mha_plain_kv_len_one(online):
    """``kv_len = 1`` of 129 keys (three tiles of 64): the plain version
    against the JAX kernels (two-pass with its bias row, and online), with
    large values past ``kv_len``; every row is the first key's value."""
    q, k, v = _mk(2, 100, 129, 128, seed=11)
    k[:, 1:], v[:, 1:] = 1e4, -1e4
    scale = 0.125
    out = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 2, scale, kv_len=1).numpy()
    kernel = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                           scale, kv_len=1, block_q=128, block_kv=128,
                           interpret=True, force_online=online)
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.broadcast_to(v[:, :1], out.shape),
                               rtol=RTOL, atol=ATOL)


def _ring_mask(pattern: str, b: int, lk: int) -> np.ndarray:
    """"last": only the last key of the last (ragged) tile is valid;
    "alt": keys are valid in alternate 64-key tiles only."""
    if pattern == "last":
        mask = np.zeros((b, lk), bool)
        mask[:, -1] = True
        return mask
    return np.broadcast_to((np.arange(lk) // 64) % 2 == 0, (b, lk)).copy()


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("hd", [40, 64])
@pytest.mark.parametrize("pattern", ["last", "alt"])
def test_masked_plain_matches_jax_at_ring_edges(pattern, hd, online):
    """The masked plain version against the JAX masked kernels (two-pass
    K2b and online K3a) on masks that leave the ring few or alternate
    tiles: 300 keys are four full tiles and a ragged one of 44."""
    q, k, v = _mk(2, 130, 300, 2 * hd, seed=hd + len(pattern))
    mask = _ring_mask(pattern, 2, 300)
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_mha_masked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(mask),
                                  2, scale).numpy()
    kernel = np.asarray(jax_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, scale,
        kv_mask=jnp.asarray(mask), block_q=128, block_kv=128, interpret=True,
        force_online=online))
    np.testing.assert_allclose(out, kernel, rtol=RTOL, atol=ATOL)
    if pattern == "last":
        np.testing.assert_allclose(out, np.broadcast_to(v[:, -1:], out.shape),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lq,lk,heads,hd", [
    (512, 77, 4, 64),    # text keys, ragged against the 16-key tiles
    (640, 128, 2, 64),   # aligned keys, ragged query tile
    (512, 77, 4, 40),    # SD-1.5 head dim
])
def test_cross_short_plain_matches_jax_kernel(lq, lk, heads, hd):
    """K5's plain version against the Pallas kernel in interpret mode and
    the JAX dense path (tests/test_flash.py's cases)."""
    q, k, v = _mk(3, lq, lk, heads * hd, seed=5)
    scale = 1.0 / math.sqrt(hd)
    out = tflash.flash_cross_short(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), heads, scale).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = jax_flash_cross_short(jq, jk, jv, heads, scale, block_q=256,
                                   interpret=True)
    dense = jax_dense_masked(jq, jk, jv, heads, None, scale)
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(dense), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lk,d,heads,match", [
    (257, 640, 8, "at most 256"),   # too many keys for the block
    (77, 768, 8, "head dim"),       # hd 96
    (77, 640, 3, "head dim"),       # D not a multiple of the heads
])
def test_cross_short_rejects(lk, d, heads, match):
    """What the kernel does not take raises before a launch (a meta tensor
    goes the way of a CUDA one, without a card): 257 keys on any device, a
    head dim outside 40/64/80/160 on the kernel's path."""
    q = torch.zeros(1, 64, d, device="meta")
    k = torch.zeros(1, lk, d, device="meta")
    with pytest.raises(ValueError, match=match):
        tflash.flash_cross_short(q, k, k, heads, 0.1)


def test_cross_short_cpu_takes_any_head_dim():
    """On the CPU K5's wrapper is its plain version at any head dim (the
    tiny test models' 16 and 32 route to it); 257 keys still raise."""
    q, k = torch.randn(2, 40, 48), torch.randn(2, 77, 48)
    out = tflash.flash_cross_short(q, k, k, 3, 0.25)
    np.testing.assert_allclose(
        out.numpy(), tlayers.attention(q, k, k, 3, scale=0.25).numpy(),
        rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="at most 256"):
        tflash.flash_cross_short(q, torch.randn(2, 257, 48),
                                 torch.randn(2, 257, 48), 3, 0.25)


def test_cross_short_is_not_routed(monkeypatch):
    """K5 is not routed what is not its function: a key mask goes to the
    masked kernel at any key length, 128 keys or more to K1."""
    def refuse(*args, **kwargs):
        raise AssertionError("the dispatcher routed to flash_cross_short")

    monkeypatch.setattr(tattn, "flash_cross_short", refuse)
    q, k = torch.randn(2, 256, 320), torch.randn(2, 77, 320)
    mask = torch.ones(2, 77, dtype=torch.bool)
    out = tattn.masked_attention(q, k, k, 8, kv_token_mask=mask)
    np.testing.assert_allclose(
        out.numpy(), tflash.flash_cross_short_reference(q, k, k, 8,
                                                        40 ** -0.5).numpy(),
        rtol=RTOL, atol=ATOL)
    long_k = torch.randn(2, tattn.FLASH_MIN_KV, 320)
    out = tattn.masked_attention(q, long_k, long_k, 8)
    np.testing.assert_allclose(
        out.numpy(), tflash.flash_mha_fused_reference(
            q, long_k, long_k, 8, 40 ** -0.5).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lk", [1, 77, 127])
def test_short_kv_routes_to_cross_short(monkeypatch, lk):
    """Unmasked attention over fewer than FLASH_MIN_KV keys (text
    cross-attention) goes to K5, and on the CPU gives the JAX dense
    path's values."""
    calls = []

    def spy(q, k, v, num_heads, scale):
        calls.append((tuple(k.shape), num_heads, scale))
        return tflash.flash_cross_short_reference(q, k, v, num_heads, scale)

    monkeypatch.setattr(tattn, "flash_cross_short", spy)
    q, k, v = _mk(2, 100, lk, 320, seed=lk)
    out = tattn.masked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 8)
    assert calls == [((2, lk, 320), 8, 40 ** -0.5)]
    ref = jax_dense_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 8,
                           None, 40 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_dense_masked_matches_jax(masked):
    """The plain attention layer (the CPU's reference for every kernel
    route, and the K-less route of CLIP and T5) with an optional key mask
    against the JAX dense path."""
    q, k, v = _mk(3, 40, 77, 128, seed=2)
    mask = np.random.default_rng(3).random((3, 77)) > 0.3 if masked else None
    ref = jax_dense_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                           None if mask is None else jnp.asarray(mask), 0.125)
    out = tlayers.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2,
        mask=None if mask is None else torch.from_numpy(mask)[:, None, None, :],
        scale=0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("b,lq,lk,heads,dead_row", [
    (3, 256, 256, 2, False),   # random mask, every row has a valid key
    (2, 200, 333, 2, False),   # Lk ragged against 128, Lq != Lk
    (3, 130, 260, 1, True),    # batch row 1 has no valid key at all
])
def test_masked_plain_matches_jax_kernels(b, lq, lk, heads, dead_row, online):
    q, k, v = _mk(b, lq, lk, heads * 64, seed=lk)
    mask = np.random.default_rng(lq).random((b, lk)) > 0.4
    mask[:, 0] = True
    if dead_row:
        mask[1] = False
    scale = 1.0 / math.sqrt(64)
    out = tflash.flash_mha_masked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(mask),
                                  heads, scale).numpy()
    kernel = np.asarray(jax_flash_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, scale,
        kv_mask=jnp.asarray(mask), block_q=128, block_kv=128, interpret=True,
        force_online=online))
    live = mask.any(axis=1)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[live], kernel[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[~live], 0.0)
    dense = jax_dense_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             heads, jnp.asarray(mask), scale)
    np.testing.assert_allclose(out[live], np.asarray(dense)[live], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("b,lq,lk,kv_len,heads,online", [
    (2, 256, 256, None, 2, False),  # aligned Lk: _mha_kernel_2pass_nobias (K2a)
    (2, 200, 333, None, 2, False),  # ragged Lk: _mha_kernel_2pass, kv_len bias
    (2, 256, 384, 300, 1, False),   # kv_len < Lk: bias row over the garbage
    (2, 200, 256, None, 2, True),   # online softmax: _mha_kernel (K3b)
    (3, 130, 384, 200, 2, True),    # online, kv_len < Lk
])
def test_flash_mha_plain_matches_jax_kernels(b, lq, lk, kv_len, heads, online):
    q, k, v = _mk(b, lq, lk, heads * 64, seed=lq + lk)
    if kv_len is not None:  # keys past kv_len must take no part
        k[:, kv_len:], v[:, kv_len:] = 1e4, -1e4
    scale = 1.0 / math.sqrt(64)
    out = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), heads, scale,
                           kv_len=kv_len).numpy()
    kernel = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           heads, scale, kv_len=kv_len, block_q=128,
                           block_kv=128, interpret=True, force_online=online)
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    n = lk if kv_len is None else kv_len
    dense = jax_dense_masked(jnp.asarray(q), jnp.asarray(k[:, :n]),
                             jnp.asarray(v[:, :n]), heads, None, scale)
    np.testing.assert_allclose(out, np.asarray(dense), rtol=RTOL, atol=ATOL)


def test_flash_mha_kv_mask_is_the_masked_kernel():
    q, k, v = (torch.from_numpy(a) for a in _mk(2, 100, 150, 128, seed=5))
    mask = torch.from_numpy(np.random.default_rng(6).random((2, 150)) > 0.5)
    np.testing.assert_array_equal(
        tflash.flash_mha_reference(q, k, v, 2, 0.125, kv_mask=mask).numpy(),
        tflash.flash_mha_masked_reference(q, k, v, mask, 2, 0.125).numpy())
    with pytest.raises(ValueError, match="mutually exclusive"):
        tflash.flash_mha(q, k, v, 2, 0.125, kv_mask=mask, kv_len=10)


@pytest.mark.parametrize("kv_len", [0, 151])
def test_flash_mha_rejects_kv_len_out_of_range(kv_len):
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 10, 150, 128, seed=7))
    with pytest.raises(ValueError, match="kv_len"):
        tflash.flash_mha(q, k, v, 2, 0.125, kv_len=kv_len)


def test_masked_plain_all_valid_equals_unmasked():
    q, k, v = (torch.from_numpy(a) for a in _mk(2, 100, 150, 128, seed=4))
    mask = torch.ones(2, 150, dtype=torch.bool)
    np.testing.assert_allclose(
        tflash.flash_mha_masked_reference(q, k, v, mask, 2, 0.125).numpy(),
        tflash.flash_mha_fused_reference(q, k, v, 2, 0.125).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lk,masked,to_k1", [
    (256, False, True),     # SDXL self-attention (shortest, 512^2 level 2)
    (4096, False, True),    # SDXL 1024^2 level 1 self-attention
    (77, False, False),     # text cross-attention: K5
    (256, True, False),     # key mask (patch path): the masked kernel
    (77, True, False),      # a key mask at any key length: masked kernel
])
def test_masked_attention_routing(monkeypatch, lk, masked, to_k1):
    calls, masked_calls, cross_calls = [], [], []

    def spy(q, k, v, num_heads, scale):
        calls.append((tuple(q.shape), tuple(k.shape), num_heads, scale))
        return tflash.flash_mha_fused_reference(q, k, v, num_heads, scale)

    def cross_spy(q, k, v, num_heads, scale):
        cross_calls.append((tuple(k.shape), num_heads, scale))
        return tflash.flash_cross_short_reference(q, k, v, num_heads, scale)

    def masked_spy(q, k, v, kv_mask, num_heads, scale):
        masked_calls.append((tuple(kv_mask.shape), num_heads, scale))
        return tflash.flash_mha_masked_reference(q, k, v, kv_mask, num_heads,
                                                 scale)

    monkeypatch.setattr(tattn, "flash_mha_fused", spy)
    monkeypatch.setattr(tattn, "flash_mha_masked", masked_spy)
    monkeypatch.setattr(tattn, "flash_cross_short", cross_spy)
    q = torch.randn(1, 8, 128)
    k = v = torch.randn(1, lk, 128)
    mask = torch.ones(1, lk, dtype=torch.bool) if masked else None
    out = tattn.masked_attention(q, k, v, 2, kv_token_mask=mask)
    assert out.shape == q.shape
    assert bool(calls) == to_k1
    assert masked_calls == ([((1, lk), 2, 1.0 / math.sqrt(64))] if masked
                            else [])
    short = not masked and lk < tattn.FLASH_MIN_KV
    assert cross_calls == ([((1, lk, 128), 2, 1.0 / math.sqrt(64))] if short
                           else [])
    if to_k1:
        assert calls[0][2:] == (2, 1.0 / math.sqrt(64))


@pytest.mark.parametrize("lk,d,route", [
    (4096, 640, "k1"),        # SDXL 1024^2 level 1: the widest SDXL K row, 5 MiB
    (1357, 1536, "k1"),       # SD3 512^2 joint attention: 4.0 MiB
    (2304, 1536, "flash_mha"),  # SD3 768^2 dual attention: 6.75 MiB
    (4429, 1536, "flash_mha"),  # SD3 1024^2 joint attention: 13 MiB
    (77, 1536, "k5"),         # short text keys: K5
])
def test_wide_key_rows_route_to_flash_mha(monkeypatch, lk, d, route):
    """The JAX K-row gate (attention.py:128-130): unmasked attention whose K
    row exceeds 6 MiB (bf16) goes to flash_mha (K2a), narrower rows to K1,
    fewer than FLASH_MIN_KV keys to K5."""
    calls = []

    def spy(name, ref):
        def fn(q, k, v, num_heads, scale, **kw):
            calls.append(name)
            return ref(q, k, v, num_heads, scale, **kw)
        return fn

    monkeypatch.setattr(tattn, "flash_mha_fused",
                        spy("k1", tflash.flash_mha_fused_reference))
    monkeypatch.setattr(tattn, "flash_mha",
                        spy("flash_mha", tflash.flash_mha_reference))
    monkeypatch.setattr(tattn, "flash_cross_short",
                        spy("k5", tflash.flash_cross_short_reference))
    q = torch.randn(1, 4, d)
    k = v = torch.randn(1, lk, d)
    out = tattn.masked_attention(q, k, v, d // 64)
    assert out.shape == q.shape
    assert calls == [route]


def test_cpu_wrapper_never_loads_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = (tflash.flash_mha_fused.launches, tflash.flash_mha_masked.launches)
    q = torch.randn(1, 256, 128, dtype=torch.bfloat16)
    out = tflash.flash_mha_fused(q, q, q, 2, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    out = tflash.flash_mha_masked(q, q, q, torch.ones(1, 256, dtype=torch.bool),
                                  2, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (tflash.flash_mha_fused.launches,
            tflash.flash_mha_masked.launches) == before


def test_cpu_flash_mha_never_loads_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = tflash.flash_mha.launches
    q = torch.randn(1, 256, 128, dtype=torch.bfloat16)
    out = tflash.flash_mha(q, q, q, 2, 0.125, kv_len=200)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert tflash.flash_mha.launches == before
    before = tflash.flash_cross_short.launches
    out = tflash.flash_cross_short(q, q[:, :77], q[:, :77], 2, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert tflash.flash_cross_short.launches == before


def test_ptxas_usage_names_the_flash_instantiations():
    """chip_smoke.py reads registers and spills per instantiation from the
    nvcc log: the mangled names (length-prefixed, after a file hash) come
    out as ``mha_fused_kernel<hd, masked>``."""
    log = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__941d3b32_"
        "14_flash_fused_cu_b31612f316mha_fused_kernelILi160ELb0EEEvPK13__nv_"
        "bfloat16S3_S3_PS1_PKhiiiif' for 'sm_90a'\n"
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 225 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8ae705e2_"
        "10_gn_halo_cu_5077393a14gn_halo_kernelILi8EEEvPK13__nv_bfloat16' "
        "for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 31 registers, used 1 barriers, 1280 bytes smem\n")
    assert _build.ptxas_usage(log) == [
        {"kernel": "mha_fused_kernel<160, false>", "registers": 225,
         "spill_stores": 0, "spill_loads": 0, "smem": 0},
        {"kernel": "gn_halo_kernel<8>", "registers": 31, "spill_stores": 4,
         "spill_loads": 8, "smem": 1280}]


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("args,match", [
    ((_bf16(1, 64, 96), _bf16(1, 64, 96), _bf16(1, 64, 96), 2), "head dim"),
    ((_bf16(1, 64, 128), _bf16(1, 64, 128), _bf16(1, 64, 128), 1), "head dim"),
    ((torch.zeros(1, 64, 128), torch.zeros(1, 64, 128),
      torch.zeros(1, 64, 128), 2), "bfloat16"),
    ((_bf16(1, 128, 64).transpose(1, 2), _bf16(1, 64, 128), _bf16(1, 64, 128),
      2), "contiguous"),
    ((_bf16(1, 64, 128), _bf16(1, 32, 128), _bf16(1, 64, 128), 2), "shape"),
    ((_bf16(1, 64, 128), _bf16(1, 64, 128), _bf16(1, 64, 128), 2), "CUDA"),
])
def test_check_inputs_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        tflash.check_inputs(*args)


@pytest.mark.parametrize("mask,match", [
    (torch.ones(1, 64, dtype=torch.int32), "torch.bool"),
    (torch.ones(1, 32, dtype=torch.bool), "shape"),
    (torch.ones(1, 128, dtype=torch.bool)[:, ::2], "contiguous"),
])
def test_check_mask_rejects(mask, match):
    with pytest.raises(ValueError, match=match):
        tflash.check_mask(mask, _bf16(1, 64, 128))
