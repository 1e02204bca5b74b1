"""The port's CUDA kernels on the card (skipped without one): K1, K2a/K3b
(flash_mha), the masked kernel K2b/K3a, K4 and K5 (flash_cross_short), the
attention kernels at head dims 64 and SD-1.5's 40/80/160, and the edge
cases of the flash template's K/V ring (one query row, one key, one tile
more than the ring, masks that leave it the last key or alternate tiles).

This file imports no jax, so it also runs where the JAX package is not
installed: on the GPU machine,

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Each kernel is held against its plain
PyTorch version (float32 math, rounded to bf16 once) on N(0, 1) bf16
inputs, relative to the output's scale: the max error within 2^-6 of
max |plain| (two bf16 ulps at the largest output: the output rounding plus
the kernel's bf16 P), and the relative RMS error within 5e-3 (bf16 rounding
gives ~2.4e-3 on an H100; a fault that scales rows by ~0.5% or more, such
as an unmasked padded key tile, adds its own size on top).  The masked
kernel is held to the same bounds over the rows with a valid key, and must
write zeros (finite) where a batch row has none.  K4 (gn_silu_halo) within
2^-7 of max |plain| (one bf16 ulp at the output scale: both compute in
float32 and round once), with exact zeros at image borders.  The patched
step's moments and the fused op give the same bits on two calls with the
same input.  The deep cache's row gate picks the same rows on the card as
on the CPU, ties included, the patch path's image gate the same images,
and a drift value reaches the host only once its event has completed.  A
postprocess on the worker's decode thread gives the same images, bit for
bit, as the same call on the main thread.  The block cache at threshold -1
serves cache-off's latents and launches.  A fused multi-step chunk run
from captured step graphs (dense, compact, the row warmup's hybrid partial
chunk, the patch path's hybrid and block cache, SD3's span with compact;
small denoisers at head dim 64) gives the same latents, bit for bit, as
the same chunks stepped eagerly, and the launch counters count the
replayed kernels.  K4 at a tensor-parallel shard's C / 2 channels matches
its plain version, and a small UNet on sp x tp shards of card 0 matches
its one-device forward (the tp shards bitwise equal, each shard
launching one device's kernels).  K6 (gn_dense, the dense GroupNorm) matches
its plain version within 2^-7 of max |plain| in bf16 (one bf16 ulp at the
output scale) and 1e-5 in float32, in its single-read (cluster) and
two-pass designs and on the scalar path, with and without the fused add,
and repeats bit for bit.
"""

from __future__ import annotations

import pytest
import torch

from sduss_tpu_torch.cache.manager import BlockCache, top_k_stable
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.engine.engine import Engine
from sduss_tpu_torch.entrypoints.offline import default_config
from sduss_tpu_torch.models.registry import ModelBundle
from sduss_tpu_torch.ops import attention as tattn
from sduss_tpu_torch.ops import flash as tflash
from sduss_tpu_torch.ops import gn_dense as tgd
from sduss_tpu_torch.ops import gn_halo as tgn
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.pipelines.base import _DriftScalar
from sduss_tpu_torch.request import Request, SamplingParams

K1_MAX_REL = 2.0 ** -6
K1_RMS_REL = 5e-3
K4_MAX_REL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def second_card():
    """``cuda:1``, for a dp replica on another card than the current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def _randn(gen, *shape, device):
    return torch.randn(*shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,d,heads", [
    (2, 1024, 1024, 1280, 20),  # SDXL level 2 at 1024^2
    (3, 1000, 777, 640, 10),    # ragged Lq and Lk, Lq != Lk
    (2, 1000, 65, 640, 10),     # last key tile 1 real key + 63 padded
    (1, 100, 64, 64, 1),        # one partial query tile, one key tile
    (2, 4096, 4096, 320, 8),    # SD-1.5 level 0 at 512^2, hd 40
    (2, 1000, 777, 640, 8),     # hd 80, ragged
    (2, 144, 144, 1280, 8),     # SD-1.5 mid block at 768^2, hd 160
    # edge cases of the K/V ring (2 or 3 slots of 64 keys)
    (2, 1, 1000, 640, 10),      # Lq = 1
    (2, 300, 1, 640, 10),       # Lk = 1
    (2, 500, 129, 640, 10),     # Lk = 64 * 2 + 1: one tile more than 2 slots
    (2, 500, 193, 640, 10),     # Lk = 64 * 3 + 1: one more than 3 slots
    (2, 500, 129, 1280, 8),     # the same at hd 160
    (2, 500, 193, 1280, 8),
])
def test_k1_matches_plain(cuda, b, lq, lk, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, b, lq, d, device=cuda)
    k, v = (_randn(gen, b, lk, d, device=cuda) for _ in range(2))
    before = tflash.flash_mha_fused.launches
    out = tflash.flash_mha_fused(q, k, v, heads, 0.125)
    ref = tflash.flash_mha_fused_reference(q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert tflash.flash_mha_fused.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_k1_scale_sign(cuda, scale):
    """A negative softmax scale (the kernel negates Q) and a zero one (every
    key weighs the same) against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (_randn(gen, 2, 300, 640, device=cuda) for _ in range(3))
    out = tflash.flash_mha_fused(q, k, v, 10, scale)
    ref = tflash.flash_mha_fused_reference(q, k, v, 10, scale)
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,kv_len", [
    (2, 2304, 2304, None),   # SD3 768^2 dual attention
    (2, 1000, 777, None),    # ragged Lq and Lk
    (2, 700, 900, 650),      # kv_len < Lk: keys past it hold 1e4
    (1, 100, 64, 1),         # one key
    (2, 300, 129, 1),        # one key of three tiles
])
def test_flash_mha_matches_plain(cuda, b, lq, lk, kv_len):
    """K2a/K3b at SD3.5-medium's width (24 heads x 64)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, b, lq, 1536, device=cuda)
    k, v = (_randn(gen, b, lk, 1536, device=cuda) for _ in range(2))
    if kv_len is not None:
        k[:, kv_len:], v[:, kv_len:] = 1e4, 1e4
    before = tflash.flash_mha.launches
    out = tflash.flash_mha(q, k, v, 24, 0.125, kv_len=kv_len)
    ref = tflash.flash_mha_reference(q, k, v, 24, 0.125, kv_len=kv_len)
    torch.cuda.synchronize()
    assert tflash.flash_mha.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL
    # an unmasked K row over 6 MiB routes here, a narrower long one to K1
    wide = lk * 1536 * 2 > 6 * 2**20
    n = tflash.flash_mha_fused.launches
    tattn.masked_attention(q, k, v, 24)
    assert tflash.flash_mha.launches == before + 1 + wide
    assert tflash.flash_mha_fused.launches == n + (not wide and lk >= 128)


@pytest.mark.cuda
def test_cuda_routing_never_falls_back(cuda):
    """Self-attention on CUDA launches K1; short-KV cross-attention K5;
    what a kernel cannot take raises instead of running the plain path."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, 2, 256, 640, device=cuda)
    text = _randn(gen, 2, 77, 640, device=cuda)
    n = tflash.flash_mha_fused.launches
    tattn.masked_attention(q, q, q, 10)
    assert tflash.flash_mha_fused.launches == n + 1
    c = tflash.flash_cross_short.launches
    tattn.masked_attention(q, text, text, 10)
    assert tflash.flash_mha_fused.launches == n + 1
    assert tflash.flash_cross_short.launches == c + 1
    with pytest.raises(ValueError, match="head dim"):
        tattn.masked_attention(q, text, text, 5)      # hd 128
    assert tflash.flash_cross_short.launches == c + 1
    with pytest.raises(ValueError, match="head dim"):
        tattn.masked_attention(q, q, q, 5)            # hd 128
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.masked_attention(q.float(), q.float(), q.float(), 10)
    m = tflash.flash_mha_masked.launches
    tattn.masked_attention(q, q, q, 10, kv_token_mask=torch.ones(
        2, 256, dtype=torch.bool, device=cuda))
    assert tflash.flash_mha_masked.launches == m + 1
    with pytest.raises(ValueError, match="kv_mask"):
        tattn.masked_attention(q, q, q, 10, kv_token_mask=torch.ones(
            2, 255, dtype=torch.bool, device=cuda))
    assert tflash.flash_mha_fused.launches == n + 1
    assert tflash.flash_mha_masked.launches == m + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,d,heads,dead_rows", [
    (4, 1024, 1024, 640, 10, (1, 3)),  # patch groups with padded slots
    (2, 576, 576, 1280, 20, ()),       # 768^2 class at level 2
    (3, 1000, 777, 640, 10, (2,)),     # ragged Lq and Lk
    (2, 300, 65, 64, 1, ()),           # last key tile 1 real key
    (3, 2304, 2304, 320, 8, (2,)),     # SD-1.5 patch group, hd 40
    (3, 1024, 1024, 640, 8, (0,)),     # hd 80
    (3, 144, 144, 1280, 8, (1,)),      # SD-1.5 mid-block group, hd 160
    (1, 64, 16448, 64, 1, ()),         # 257 key tiles: two chunks of the list
])
def test_masked_matches_plain(cuda, b, lq, lk, d, heads, dead_rows):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, b, lq, d, device=cuda)
    k, v = (_randn(gen, b, lk, d, device=cuda) for _ in range(2))
    mask = torch.rand(b, lk, generator=gen, device=cuda) > 0.3
    mask[:, :64] = False  # a whole key tile masked: skipped by the kernel
    mask[:, -1] = True
    for r in dead_rows:
        mask[r] = False
    before = tflash.flash_mha_masked.launches
    out = tflash.flash_mha_masked(q, k, v, mask, heads, 0.125)
    ref = tflash.flash_mha_masked_reference(q, k, v, mask, heads, 0.125)
    torch.cuda.synchronize()
    assert tflash.flash_mha_masked.launches == before + 1
    assert torch.isfinite(out).all()
    live = mask.any(dim=1)
    assert (out[~live] == 0).all()
    diff, ref = (out[live].float() - ref[live].float()), ref[live].float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "dual"])
@pytest.mark.parametrize("s_pad,k_t", [(1024, 517), (4096, 2047)])
def test_masked_fine_gate_shapes(cuda, kind, s_pad, k_t):
    """The fine token gate's attention: fewer queries than keys, ``Lq`` off
    the query tile.  Joint: the ``k_t`` selected latent tokens + 333 text
    queries against ``s_pad`` latent + 333 text keys; dual: ``k_t``
    against ``s_pad``.  Row 0 is a shorter request (its padded keys
    masked), row 1 full, row 2 a bucket pad row with no valid latent key
    (dual: no valid key at all, so its output is zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    ctx = 333 if kind == "joint" else 0
    b, d, heads = 3, 1536, 24
    q = _randn(gen, b, k_t + ctx, d, device=cuda)
    k, v = (_randn(gen, b, s_pad + ctx, d, device=cuda) for _ in range(2))
    mask = torch.zeros(b, s_pad + ctx, dtype=torch.bool, device=cuda)
    mask[0, :s_pad // 4] = True
    mask[1, :s_pad] = True
    mask[:, s_pad:] = True       # text keys always take part
    before = tflash.flash_mha_masked.launches
    out = tflash.flash_mha_masked(q, k, v, mask, heads, 0.125)
    ref = tflash.flash_mha_masked_reference(q, k, v, mask, heads, 0.125)
    torch.cuda.synchronize()
    assert tflash.flash_mha_masked.launches == before + 1
    assert out.shape == q.shape and torch.isfinite(out).all()
    live = mask.any(dim=1)
    assert live.tolist() == [True, True, kind == "joint"]
    assert (out[~live] == 0).all()
    diff, ref = (out[live].float() - ref[live].float()), ref[live].float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 64])
@pytest.mark.parametrize("pattern", ["last", "alt"])
def test_masked_ring_edges(cuda, pattern, hd):
    """The masked kernel walks only key tiles with a valid key: a mask
    whose one valid key is the last of the last (ragged) tile, and one
    valid only in alternate 64-key tiles."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, length, heads = 3, 1000, 8
    q, k, v = (_randn(gen, b, length, heads * hd, device=cuda)
               for _ in range(3))
    if pattern == "last":
        mask = torch.zeros(b, length, dtype=torch.bool, device=cuda)
        mask[:, -1] = True
    else:
        tile = torch.arange(length, device=cuda) // 64
        mask = (tile % 2 == 0).expand(b, length).contiguous()
    before = tflash.flash_mha_masked.launches
    out = tflash.flash_mha_masked(q, k, v, mask, heads, hd ** -0.5)
    ref = tflash.flash_mha_masked_reference(q, k, v, mask, heads, hd ** -0.5)
    torch.cuda.synchronize()
    assert tflash.flash_mha_masked.launches == before + 1
    assert torch.isfinite(out).all()
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL
    if pattern == "last":  # every row is the last key's value
        assert torch.equal(out, v[:, -1:].expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("grids,s,c", [
    ((3, 4), 32, 320), ((3, 4), 16, 640), ((3, 4), 8, 1280),
    ((1, 2, 3), 4, 1280),  # SD-1.5 level 3
    ((2, 1), 6, 64),   # a side with no specialised kernel
    ((2, 1), 3, 64),   # a side under 4: the ring's segments
])
def test_k4_matches_plain(cuda, grids, s, c):
    meta = tpatching.build_meta(grids, s, (4, 8, 16, 32), (2, 4))
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (1.5 * torch.randn(meta.p_pad, c, s, s, generator=gen, device=cuda)
         + 0.2).to(torch.bfloat16)
    image_id = torch.from_numpy(meta.image_id).to(cuda)
    neighbors = torch.from_numpy(meta.neighbors).to(cuda)
    mean, var = tgn.moments(x, image_id, meta.i_pad, 32)
    rstd = torch.rsqrt(var + 1e-5)
    # the GroupNorm affine in the model's dtype, as the kernel takes it
    w = torch.randn(c, generator=gen, device=cuda).to(torch.bfloat16)
    bias = torch.randn(c, generator=gen, device=cuda).to(torch.bfloat16)
    before = tgn.gn_silu_halo.launches
    out = tgn.gn_silu_halo(x, image_id, neighbors, mean, rstd, w, bias)
    ref = tgn.gn_silu_halo_reference(x, image_id, neighbors, mean, rstd, w,
                                     bias)
    torch.cuda.synchronize()
    assert tgn.gn_silu_halo.launches == before + 1
    assert out.shape == (meta.p_pad, c, s + 2, s + 2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= K4_MAX_REL * ref.float().abs().max().item()
    nb = neighbors
    for side, cells in ((0, out[nb[:, 0] < 0][:, :, 0, :]),
                        (1, out[nb[:, 1] < 0][:, :, -1, :]),
                        (2, out[nb[:, 2] < 0][:, :, :, 0]),
                        (3, out[nb[:, 3] < 0][:, :, :, -1])):
        assert (cells == 0).all(), side  # image borders are exactly 0


def _sdxl_mix_meta():
    """The CFG-doubled patch metadata of chip_smoke.py's SDXL mixed phase
    (768^2 + 3 x 1024^2 in the default configuration): 128 patches."""
    sc = default_config("sdxl").scheduler
    cells = sc.patch_size // 8
    grids = tuple(r // 8 // cells for r in (768, 1024, 1024, 1024))
    return tpatching.double_meta(grids, cells, tuple(sc.patch_buckets),
                                 tuple(sc.batch_buckets))


@pytest.mark.cuda
def test_k4_takes_bf16_affine_only(cuda):
    """K4 reads the GroupNorm weight and bias as bf16 (the model's dtype);
    a float32 affine raises instead of being converted."""
    meta = tpatching.build_meta((2,), 8, (4, 8), (2,))
    x = torch.zeros(meta.p_pad, 64, 8, 8, dtype=torch.bfloat16, device=cuda)
    image_id = torch.from_numpy(meta.image_id).to(cuda)
    neighbors = torch.from_numpy(meta.neighbors).to(cuda)
    stats = torch.zeros(meta.i_pad, 32, device=cuda)
    with pytest.raises(ValueError, match="weight/bias must be contiguous"):
        tgn.gn_silu_halo(x, image_id, neighbors, stats, stats,
                         torch.ones(64, device=cuda), torch.zeros(64,
                                                                   device=cuda))


@pytest.mark.cuda
def test_patched_moments_and_k4_repeat_bitwise(cuda):
    """The per-image moments combine the (P, G) partial sums in a fixed
    order, so two calls on the same (P 128, s 32, C 320) patch batch give
    the same bits, and so does the fused op."""
    meta = _sdxl_mix_meta()
    assert meta.p_pad == 128
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (1.5 * torch.randn(meta.p_pad, 320, 32, 32, generator=gen,
                           device=cuda) + 0.2).to(torch.bfloat16)
    image_id = torch.from_numpy(meta.image_id).to(cuda)
    neighbors = torch.from_numpy(meta.neighbors).to(cuda)
    w = torch.randn(320, generator=gen, device=cuda).to(torch.bfloat16)
    bias = torch.randn(320, generator=gen, device=cuda).to(torch.bfloat16)
    first = tgn.moments(x, image_id, meta.i_pad, 32)
    second = tgn.moments(x, image_id, meta.i_pad, 32)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    args = (x, w, bias, image_id, neighbors, meta.i_pad, 32, 1e-5)
    assert torch.equal(tgn.gn_silu_haloed(*args), tgn.gn_silu_haloed(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,d,heads", [
    (4, 1024, 77, 1280, 20),   # SDXL level-2 text cross-attention
    (4, 4096, 77, 640, 10),    # SDXL level 1, dense pair with CFG
    (128, 256, 77, 640, 10),   # SDXL patch path: per-patch K/V, level 1
    (128, 64, 77, 1280, 20),   # SDXL patch path, level 2
    # two-level compact rows on SDXL's serving mix: k_q = 36 patch rows
    (36, 256, 77, 640, 10),    # level 1
    (36, 64, 77, 1280, 20),    # level 2
    (4, 4096, 77, 320, 8),     # SD-1.5 level 0, hd 40
    (32, 1024, 77, 320, 8),    # SD-1.5 patch path, level 0
    (32, 64, 77, 1280, 8),     # SD-1.5 patch path, level 2, hd 160
    (4, 64, 64, 1280, 8),      # SD-1.5 512^2 mid block self-attention
    (2, 1000, 77, 640, 8),     # hd 80, ragged query tile
    (2, 1000, 256, 1280, 8),   # hd 160 at the most keys it holds: 2 chunks
    (2, 300, 129, 640, 10),    # a second chunk with one key
    (3, 100, 5, 640, 10),      # one short key tile
    (2, 50, 1, 320, 8),        # one key, hd 40
])
def test_k5_matches_plain(cuda, b, lq, lk, d, heads):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, b, lq, d, device=cuda)
    k, v = (_randn(gen, b, lk, d, device=cuda) for _ in range(2))
    scale = (d // heads) ** -0.5
    before = tflash.flash_cross_short.launches
    out = tflash.flash_cross_short(q, k, v, heads, scale)
    ref = tflash.flash_cross_short_reference(q, k, v, heads, scale)
    torch.cuda.synchronize()
    assert tflash.flash_cross_short.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL
    # routed: the dispatcher sends fewer than FLASH_MIN_KV keys to K5
    tattn.masked_attention(q, k, v, heads)
    assert tflash.flash_cross_short.launches == before + (
        2 if lk < tattn.FLASH_MIN_KV else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_k5_scale_sign(cuda, scale):
    """K5 folds a positive scale into its exponent; a negative one negates
    Q, and 0 weighs every key the same."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(gen, 2, 300, 640, device=cuda)
    k, v = (_randn(gen, 2, 77, 640, device=cuda) for _ in range(2))
    out = tflash.flash_cross_short(q, k, v, 10, scale)
    ref = tflash.flash_cross_short_reference(q, k, v, 10, scale)
    diff, ref = out.float() - ref.float(), ref.float()
    assert diff.abs().max().item() <= K1_MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= K1_RMS_REL


@pytest.mark.cuda
def test_top_k_stable_ties_on_card(cuda):
    """Forced rows tie at 1e6 (a 0.0625 float32 ulp): the lowest index
    first, as on the CPU and in jax.lax.top_k."""
    gen = torch.Generator().manual_seed(0)
    scores = 1e6 + torch.rand(4096, generator=gen) * 0.01
    scores[::7] = torch.rand(586, generator=gen)
    scores[5] = -torch.inf
    want = top_k_stable(scores, 1000)
    assert torch.equal(top_k_stable(scores.to(cuda), 1000).cpu(), want)
    assert want[:4].tolist() == [1, 2, 3, 4]


@pytest.mark.cuda
def test_hybrid_gate_on_card_matches_cpu(cuda):
    """gate_compact_pairs with compact_predict on the card (bf16 rows,
    in-place state updates) against the same call on the CPU."""
    cache = BlockCache(CacheConfig(compact_predict=0.5, max_hits=4))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 96, 32, 32, generator=gen).to(torch.bfloat16)
    w = torch.randn(96, 32, generator=gen).to(torch.bfloat16)
    state = cache.init_rows("k", 16, 32, 96, 32, torch.bfloat16)
    state["inp"] += (x * 0.9).to(torch.bfloat16)
    state["out"].normal_(generator=gen)
    state["hits"].copy_(torch.tensor([4, 0, 1, 2, 3, 0, 1, 4] * 2))
    state["seen"][::3] = True
    t = torch.rand(16, generator=gen)
    valid = torch.tensor([True] * 7 + [False] + [True] * 7 + [False])

    def body(x_c, idx):
        return torch.einsum("nchw,cd->ndhw", x_c, w.to(x_c.device))

    got = {}
    for dev in ("cpu", cuda):
        st = {k: v.clone().to(dev) for k, v in state.items()}
        y, st, stats = cache.gate_compact_pairs(
            "k", x.to(dev), t.to(dev), st, body, 3, row_valid=valid.to(dev))
        got[str(dev)] = (stats["idx"].cpu(), y.float().cpu(),
                         {k: v.float().cpu() for k, v in st.items()})
    (ci, cy, cs), (gi, gy, gs) = got["cpu"], got["cuda"]
    assert torch.equal(ci, gi)
    scale = cy.abs().max()
    assert (gy - cy).abs().max() <= 2 ** -6 * scale
    for k in cs:
        assert (gs[k] - cs[k]).abs().max() <= 2 ** -6 * cs[k].abs().max()


@pytest.mark.cuda
def test_image_gate_on_card_matches_cpu(cuda):
    """gate_compact_images on SDXL's serving mix (768^2 + 3 x 1024^2,
    CFG-doubled: 128 patch rows, the 1024^2 class with 2 pad slots) with
    pair-symmetrised scores: the same images and patches, output and hits
    on the card as on the CPU; the per-image sums are fixed-order."""
    from sduss_tpu_torch.ops.patch_ctx import PatchContext, compact_context

    sc = default_config("sdxl").scheduler
    cells = sc.patch_size // 8
    meta = tpatching.double_meta((3, 4, 4, 4), cells, tuple(sc.patch_buckets),
                                 tuple(sc.batch_buckets))
    cache = BlockCache(CacheConfig(max_hits=4, deep_compact_fraction=0.3))
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(meta.p_pad, 16, cells, cells, generator=gen).to(
        torch.bfloat16)
    scale = 0.05 * (1 + torch.from_numpy(meta.image_id).float())
    state = {"inp": (x.float() + scale.reshape(-1, 1, 1, 1) * torch.randn(
                 x.shape, generator=gen)).to(torch.bfloat16),
             "out": torch.zeros_like(x),
             "hits": torch.randint(0, 4, (meta.p_pad,), generator=gen,
                                   dtype=torch.int32)}
    t = torch.rand(meta.p_pad, generator=gen)
    got = {}
    for dev in ("cpu", cuda):
        ctx = PatchContext(meta, dev)
        _, caps = compact_context(cells, meta.class_info, 0.3, True,
                                  ctx.image_id.device)
        st = {k: v.clone().to(dev) for k, v in state.items()}
        y, st, stats = cache.gate_compact_images(
            "k", x.to(dev), t.to(dev), st, lambda x_s, g, i: x_s * 2, ctx,
            caps, cfg_pair_offset=meta.i_pad // 2, two_level=False)
        got[str(dev)] = [a.cpu() for a in (stats["gather"], stats["images"],
                                           y, st["hits"])]
    for a, b in zip(got["cpu"], got["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_drift_scalar_is_read_after_its_event(cuda):
    value = torch.full((1024, 1024), 0.25, device=cuda).square().mean()
    scalar = _DriftScalar(value)
    torch.cuda.synchronize()
    assert scalar.is_ready() and float(scalar) == 0.0625


@pytest.mark.cuda
def test_decode_thread_matches_main_thread(cuda):
    """The tiny SDXL bundle in bf16 (bf16 VAE): ``postprocess`` on the
    main thread and the worker's background decode
    (``plan_postprocess`` run on its decode pool) give the same images."""
    bundle = ModelBundle("sdxl", tiny=True, dtype=torch.bfloat16, device=cuda)
    bundle.init_random(seed=0)
    config = default_config("sdxl", dtype="bfloat16", test_tiny=True)
    engine = Engine(config, cuda, bundle=bundle)
    pipe, gen = engine.workers[0].pipeline, torch.Generator(cuda).manual_seed(3)
    assert engine.workers[0]._post_pool is not None

    def requests():
        reqs = {}
        for i, res in enumerate((64, 64, 128)):
            r = Request(f"r{i}", SamplingParams(prompt="p", resolution=res))
            r.latents = lat[i]
            reqs.setdefault(res, []).append(r)
        return reqs

    lat = [torch.randn((1, res // 8, res // 8, 4), generator=gen,
                       device=cuda, dtype=torch.bfloat16)
           for res in (64, 64, 128)]
    main = requests()
    pipe.postprocess(main)
    pooled = requests()
    engine.workers[0]._post_pool.submit(pipe.plan_postprocess(pooled)).result()
    for res in main:
        for a, b in zip(main[res], pooled[res]):
            assert a.output.dtype == b.output.dtype
            assert (a.output == b.output).all()


@pytest.mark.cuda
def test_vae_auto_is_bf16_for_sdxl_on_card(cuda):
    """``vae_dtype="auto"`` serves SDXL's force_upcast VAE in bf16 on the
    card (JAX ``_vae_dtype``: bf16 on the accelerator for every family);
    "float32" forces float32.  Both decodes give uint8 images within 3
    counts of each other on average."""
    import dataclasses

    bundle = ModelBundle("sdxl", tiny=True, dtype=torch.bfloat16, device=cuda)
    bundle.init_random(seed=0)
    # the tiny configs' VAE (both packages') has no force_upcast; SDXL's has
    vae = bundle.models["vae"]
    vae.cfg = dataclasses.replace(vae.cfg, force_upcast=True)
    assert all(p.dtype == torch.bfloat16
               for p in bundle.models["vae"].parameters())
    lat = torch.randn((2, 16, 16, 4), generator=torch.Generator(cuda)
                      .manual_seed(1), device=cuda)
    images = {}
    for mode in ("auto", "float32"):
        config = default_config("sdxl", dtype="bfloat16", test_tiny=True)
        config.model.vae_dtype = mode
        pipe = Engine(config, cuda, bundle=bundle).workers[0].pipeline
        assert pipe.bundle.param_dtype("vae") == (
            torch.bfloat16 if mode == "auto" else torch.float32)
        with torch.inference_mode():
            images[mode] = pipe._decode_fn(lat).cpu()
        assert images[mode].dtype == torch.uint8
    diff = (images["auto"].int() - images["float32"].int()).abs().float()
    assert diff.mean().item() < 3.0


@pytest.mark.cuda
def test_block_cache_at_threshold_minus_one_equals_cache_off(cuda):
    """Mode "block" at ``mse_threshold=-1`` recomputes every row: a small
    UNet with the kernels' head dim 64 (the tiny configs' 32 has no
    instantiation), bf16, two patched forwards of a 2 x 2 + 1 x 1 patch
    batch (CFG-doubled) from fresh rows, gives the plain forward's output
    within one bf16 ulp at its scale and launches the same kernels."""
    from sduss_tpu_torch.models import unet as tunet
    from sduss_tpu_torch.ops.patch_ctx import PatchContext

    cfg = tunet.UNetConfig(block_out_channels=(64, 128),
                           down_block_has_attn=(False, True),
                           layers_per_block=1, transformer_layers=(0, 1),
                           num_heads=(1, 2), cross_attention_dim=64,
                           use_linear_projection=True)
    torch.manual_seed(0)
    unet = tunet.UNet2DConditionModel(cfg).to(cuda, torch.bfloat16).eval()
    meta = tpatching.double_meta((2, 1), 8, (8, 16), (2, 4))
    ctx = PatchContext(meta, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    ehs = _randn(gen, meta.i_pad, 77, 64, device=cuda)
    cache = BlockCache(CacheConfig(enabled=True, mse_threshold=-1.0))
    state = {k: cache.init_rows(k, meta.p_pad, s, ci, co, torch.bfloat16,
                                cuda)
             for k, (s, ci, co) in unet.cache_layout(8, 1).items()}

    def counts():
        return (tflash.flash_mha_masked.launches, tgn.gn_silu_halo.launches,
                tflash.flash_cross_short.launches)

    for step in range(2):
        x = _randn(gen, meta.p_pad, 8, 8, 4, device=cuda)
        t = torch.full((meta.i_pad,), 900.0 - 300 * step, device=cuda)
        with torch.inference_mode():
            c0 = counts()
            plain = unet(x, t, ehs, ctx=ctx)
            c1 = counts()
            out, st = unet(x, t, ehs, ctx=ctx, cache=cache, cache_state=state)
            c2 = counts()
        torch.cuda.synchronize()
        assert st is state and all((v["hits"] == 0).all()
                                   for v in state.values())
        assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in
                                                   zip(c1, c2)]
        assert min(b - a for a, b in zip(c0, c1)) > 0
        err = (out.float() - plain.float()).abs().max().item()
        assert err <= 2.0 ** -7 * plain.float().abs().max().item()


def _hd64_bundle(family: str, cuda):
    """The tiny bundle of ``family`` with a denoiser at the kernels' head
    dim 64 (the tiny configs' 16/32 have no instantiation), bf16."""
    import dataclasses

    from sduss_tpu_torch.models import mmdit as tmmdit
    from sduss_tpu_torch.models import unet as tunet

    bundle = ModelBundle(family, tiny=True, dtype=torch.bfloat16, device=cuda)
    with torch.device("meta"):
        if family == "sd3":
            bundle.models["transformer"] = tmmdit.SD3Transformer2DModel(
                dataclasses.replace(tmmdit.TINY_MMDIT, head_dim=64))
        else:
            bundle.models["unet"] = tunet.UNet2DConditionModel(
                dataclasses.replace(tunet.TINY_UNET, block_out_channels=(64,
                                                                         128),
                                    down_block_has_attn=(True, True),
                                    transformer_layers=(1, 1),
                                    num_heads=(1, 2)))
    bundle.init_random(seed=0)
    return bundle


CHUNK_CASES = {
    # name: (family, mixed, cache, pre-steps, resolutions of the batch)
    "dense": ("sd15", False, None, 0, (64, 64)),
    "compact": ("sd15", False, dict(mode="compact", compact_fraction=0.5,
                                    min_level=0), 1, (64, 64, 64)),
    "hybrid_partial": ("sd15", False, dict(
        mode="deep", deep_interval=3, deep_warmup=1, deep_row_warmup=True,
        deep_compact_fraction=0.5, deep_compact_pairwise=True,
        deep_boundary=1, min_level=0), 2, (64, 64, 64)),
    "mixed_hybrid": ("sd15", True, dict(
        mode="deep", deep_interval=3, deep_warmup=0,
        deep_compact_fraction=0.5, deep_compact_pairwise=True,
        deep_boundary=1, min_level=0), 2, (64, 128)),
    "mixed_block": ("sd15", True, dict(mode="block", max_hits=2, min_level=0,
                                       mse_threshold=1e9), 1, (64, 128)),
    "sd3_span_compact": ("sd3", False, dict(
        mode="compact", compact_fraction=0.5, sd3_deep_span=(1, 2),
        deep_interval=3, deep_warmup=0), 2, (64, 64)),
}


def _chunk_rounds(cuda, bundle, case: str, live: bool, k: int = 4):
    """Two rounds of fresh requests, each ``pre`` per-step steps and one
    k-step chunk, on one pipeline whose step graphs are live (captured,
    then replayed) or not (every step eager); returns each round's final
    latents and kernel launches in the chunk."""
    from sduss_tpu_torch.pipelines import build_pipeline
    from sduss_tpu_torch.pipelines.graphs import COUNTED

    family, mixed, cache, pre, resolutions = CHUNK_CASES[case]
    config = default_config(family, dtype="bfloat16", test_tiny=True,
                            resolutions=(64, 128))
    config.scheduler.use_mixed_resolution = mixed
    config.scheduler.patch_size = 64
    if cache is not None:
        config.cache = CacheConfig(enabled=True, **cache)
    pipe = build_pipeline(config, cuda, bundle=bundle)
    pipe.graphs.live = live
    rounds = []
    for rnd in range(2):
        reqs = [Request(f"r{rnd}-{i}", SamplingParams(
            prompt=f"p{i}", resolution=res, num_inference_steps=pre + k,
            seed=i)) for i, res in enumerate(resolutions)]
        pipe.prepare(reqs)
        by_res = {}
        for r in reqs:
            by_res.setdefault(r.resolution, []).append(r)
        step = pipe.denoise_step_mixed if mixed else pipe.denoise_step
        chunk = pipe.denoise_chunk_mixed if mixed else pipe.denoise_chunk
        for _ in range(pre):
            step(by_res)
        if case == "hybrid_partial":
            reqs[0].deep_state = None  # as an admission: a partial step
        before = [f.launches for f in COUNTED]
        assert chunk(by_res, k)
        rounds.append(([r.latents.float().cpu() for r in reqs],
                       [f.launches - n for f, n in zip(COUNTED, before)]))
    return rounds, pipe.graphs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_graph_replay_equals_eager(cuda, case):
    """A chunk run from captured step graphs (the first round captures
    each step kind after its eager step, the second replays them all)
    gives the same latents, bit for bit, as the same chunks with every
    step eager on the card, and the launch counters count the replayed
    kernels exactly as the eager steps launch them."""
    bundle = _hd64_bundle(CHUNK_CASES[case][0], cuda)
    graphed, graphs = _chunk_rounds(cuda, bundle, case, live=True)
    eager, _ = _chunk_rounds(cuda, bundle, case, live=False)
    assert graphs.captures > 0 and graphs.replays > 0
    for (lat_g, n_g), (lat_e, n_e) in zip(graphed, eager):
        assert n_g == n_e and sum(n_g) > 0
        for a, b in zip(lat_g, lat_e):
            assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "mixed_hybrid"])
def test_chunk_graphs_on_second_card(second_card, case):
    """A dp replica's step graphs on ``cuda:1``, captured after a capture
    on ``cuda:0`` and while ``cuda:0`` is current: each pipeline captures
    on a stream of its own card, and the replays equal the eager steps
    bit for bit."""
    first = torch.device("cuda", 0)
    family = CHUNK_CASES[case][0]
    _chunk_rounds(first, _hd64_bundle(family, first), case, live=True)
    bundle = _hd64_bundle(family, second_card)
    with torch.cuda.device(0):
        graphed, graphs = _chunk_rounds(second_card, bundle, case, live=True)
        eager, _ = _chunk_rounds(second_card, bundle, case, live=False)
        assert torch.cuda.current_device() == 0
    assert graphs.captures > 0 and graphs.replays > 0
    for (lat_g, n_g), (lat_e, n_e) in zip(graphed, eager):
        assert n_g == n_e and sum(n_g) > 0
        for a, b in zip(lat_g, lat_e):
            assert torch.isfinite(a).all() and torch.equal(a, b)


def _second_card_case(kernel: str, dev):
    """(kernel output, plain output) on ``dev`` tensors at a serving shape."""
    gen = torch.Generator(device=dev).manual_seed(9)
    if kernel == "k4":
        meta = tpatching.build_meta((3, 4), 16, (4, 8, 16, 32), (2, 4))
        x = torch.randn(meta.p_pad, 640, 16, 16, generator=gen,
                        device=dev).to(torch.bfloat16)
        ids = torch.from_numpy(meta.image_id).to(dev)
        nbs = torch.from_numpy(meta.neighbors).to(dev)
        mean, var = tgn.moments(x, ids, meta.i_pad, 32)
        args = (x, ids, nbs, mean, torch.rsqrt(var + 1e-5),
                torch.randn(640, generator=gen, device=dev).to(torch.bfloat16),
                torch.randn(640, generator=gen, device=dev).to(torch.bfloat16))
        return tgn.gn_silu_halo(*args), tgn.gn_silu_halo_reference(*args)
    lk = 77 if kernel == "k5" else 1000
    q = _randn(gen, 2, 1000, 640, device=dev)
    k, v = (_randn(gen, 2, lk, 640, device=dev) for _ in range(2))
    if kernel == "masked":
        mask = torch.rand(2, lk, generator=gen, device=dev) > 0.3
        return (tflash.flash_mha_masked(q, k, v, mask, 10, 0.125),
                tflash.flash_mha_masked_reference(q, k, v, mask, 10, 0.125))
    fn, ref = {"k1": (tflash.flash_mha_fused, tflash.flash_mha_fused_reference),
               "flash_mha": (tflash.flash_mha, tflash.flash_mha_reference),
               "k5": (tflash.flash_cross_short,
                      tflash.flash_cross_short_reference)}[kernel]
    return fn(q, k, v, 10, 0.125), ref(q, k, v, 10, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "flash_mha", "masked", "k4", "k5"])
def test_kernels_on_second_card_while_first_is_current(second_card, kernel):
    """A dp replica on ``cuda:1`` stepped from a thread whose current
    device is ``cuda:0``: each kernel runs on the tensors' card (the
    wrappers make it current around the launch) and matches its plain
    version there, as on the first card."""
    with torch.cuda.device(0):
        out, ref = _second_card_case(kernel, second_card)
        torch.cuda.synchronize(second_card)
        assert torch.cuda.current_device() == 0
    assert out.device == second_card and torch.isfinite(out).all()
    bound = K4_MAX_REL if kernel == "k4" else K1_MAX_REL
    diff = (out.float() - ref.float()).abs().max().item()
    assert diff <= bound * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(32, 160), (16, 320), (8, 640)])
def test_k4_at_a_tp_shards_channels(cuda, s, c):
    """K4 on a tensor-parallel shard's norm2: SDXL's C / 2 channels over
    16 groups, against its plain version."""
    meta = tpatching.build_meta((3, 4), s, (4, 8, 16, 32), (2, 4))
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (1.5 * torch.randn(meta.p_pad, c, s, s, generator=gen, device=cuda)
         + 0.2).to(torch.bfloat16)
    image_id = torch.from_numpy(meta.image_id).to(cuda)
    neighbors = torch.from_numpy(meta.neighbors).to(cuda)
    mean, var = tgn.moments(x, image_id, meta.i_pad, 16)
    args = (x, image_id, neighbors, mean, torch.rsqrt(var + 1e-5),
            torch.randn(c, generator=gen, device=cuda).to(torch.bfloat16),
            torch.randn(c, generator=gen, device=cuda).to(torch.bfloat16))
    out = tgn.gn_silu_halo(*args)
    ref = tgn.gn_silu_halo_reference(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= K4_MAX_REL * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("sp,tp", [(1, 2), (2, 1), (2, 2)])
def test_group_forward_on_one_card(cuda, sp, tp):
    """The tiny SD-1.5 UNet (head dim 64) on a group of sp x tp shards all
    on card 0 (``ShardedDenoiser``, a ``ShardContext`` per shard under sp)
    against the same forward on one device: within 2^-7 of max |one|, the
    tp shards' outputs bitwise equal, and each shard launching the
    kernels one device's forward launches."""
    from sduss_tpu_torch.parallel.displaced import (ShardContext,
                                                    gather_rows, shard_rows)
    from sduss_tpu_torch.parallel.group import ShardGroup
    from sduss_tpu_torch.parallel.sharding import ShardedDenoiser

    bundle = _hd64_bundle("sd15", cuda)
    unet = bundle.models["unet"]
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _randn(gen, 4, 16, 16, 4, device=cuda)
    ehs = _randn(gen, 4, 77, unet.cfg.cross_attention_dim, device=cuda)
    t = torch.full((4,), 500.0, device=cuda)
    group = ShardGroup([cuda] * (sp * tp), sp=sp, tp=tp)
    den = ShardedDenoiser(unet, group)

    def counts():
        return (tflash.flash_mha_fused.launches,
                tflash.flash_cross_short.launches)

    with torch.inference_mode():
        c0 = counts()
        want = unet(x, t, ehs)
        c1 = counts()
        outs = group.run(lambda r: den(
            shard_rows(x, group, "sp", 1, r), t, ehs,
            ctx=ShardContext(group) if sp > 1 else None))
        c2 = counts()
    torch.cuda.synchronize()
    got = gather_rows(outs, group, 1, cuda)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()
    for i in range(sp):
        assert all(torch.equal(outs[i * tp], outs[i * tp + j])
                   for j in range(1, tp))
    assert [b - a for a, b in zip(c1, c2)] == [group.size * (b - a)
                                               for a, b in zip(c0, c1)]
    group.close()


K6_MAX_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _k6_case(cuda, shape, dtype, seed=14):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (1.5 * torch.randn(*shape, generator=gen, device=cuda) + 0.2).to(dtype)
    c = shape[1]
    w, b = (torch.randn(c, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    add = torch.randn(shape[0], c, generator=gen, device=cuda)
    return x, w, b, add


def _k6_close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all()
    assert err <= K6_MAX_REL[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [
    ((2, 320, 64, 64), 32), ((8, 1280, 8, 8), 32), ((1, 128, 256, 256), 32),
    ((3, 96, 5, 6), 32),   # H * W not a multiple of a vector: scalar path
    ((2, 64, 1, 1), 8), ((1, 48, 7, 3), 1),
    ((2, 64, 512, 512), 32),   # single read, 64 KB chunks of 16 blocks
    ((1, 128, 512, 512), 32),  # a 2 MB group: two passes, vector path
])
@pytest.mark.parametrize("act", ["silu", None])
def test_k6_matches_plain(cuda, shape, groups, dtype, act):
    x, w, b, add = _k6_case(cuda, shape, dtype)
    for a in (None, add):
        before = tgd.gn_dense.launches
        out = tgd.gn_dense(x, w, b, groups, 1e-5, act, a)
        torch.cuda.synchronize()
        assert tgd.gn_dense.launches == before + 1
        assert out.dtype == dtype and out.shape == x.shape
        _k6_close(out, tgd.group_norm_reference(x, w, b, groups, 1e-5, act,
                                                a), dtype)


@pytest.mark.cuda
def test_k6_unaligned_input_and_float32_affine(cuda):
    """A contiguous view that starts off 16 bytes takes the scalar path;
    a float32 affine on bf16 x reads as float32."""
    shape = (2, 64, 16, 16)
    x, w, b, add = _k6_case(cuda, shape, torch.bfloat16)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xu = flat[1:].view(shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    got = tgd.gn_dense(xu, w, b, 32, 1e-5, "silu", add)
    _k6_close(got, tgd.group_norm_reference(x, w, b, 32, 1e-5, "silu", add),
              torch.bfloat16)
    got = tgd.gn_dense(x, w.float(), b.float(), 32, 1e-5, "silu")
    _k6_close(got, tgd.group_norm_reference(x, w.float(), b.float(), 32,
                                            1e-5, "silu"), torch.bfloat16)


@pytest.mark.cuda
def test_k6_repeats_bitwise(cuda):
    """No atomics: two calls at a shape cut into many spans a group give
    the same bits."""
    x, w, b, add = _k6_case(cuda, (1, 256, 512, 512), torch.bfloat16)
    args = (x, w, b, 32, 1e-6, "silu", add)
    assert torch.equal(tgd.gn_dense(*args), tgd.gn_dense(*args))


@pytest.mark.cuda
def test_k6_single_read_repeats_bitwise(cuda):
    """The single read sums its cluster's partials in rank order: two
    calls at SDXL's level-0 shape (eight blocks a group) give the same
    bits."""
    shape = (8, 320, 128, 128)
    assert tgd.plan_cluster(8, 320, 128 * 128, 32, 2) == 8
    x, w, b, add = _k6_case(cuda, shape, torch.bfloat16)
    args = (x, w, b, 32, 1e-5, "silu", add.to(torch.bfloat16))
    assert torch.equal(tgd.gn_dense(*args), tgd.gn_dense(*args))


@pytest.mark.cuda
def test_k6_largest_group_with_add(cuda):
    """MAX_GROUP_CHANNELS channels in one group, with the add: the apply
    kernel's shared tables at their largest still launch."""
    top = tgd.MAX_GROUP_CHANNELS
    x, w, b, add = _k6_case(cuda, (2, top, 4, 4), torch.bfloat16)
    _k6_close(tgd.gn_dense(x, w, b, 1, 1e-5, "silu", add),
              tgd.group_norm_reference(x, w, b, 1, 1e-5, "silu", add),
              torch.bfloat16)


@pytest.mark.cuda
def test_stream_for_reads_the_current_stream(cuda):
    """The launches' stream is the device's current one, a side stream
    too."""
    from sduss_tpu_torch.ops import _build

    with _build.stream_for(torch.device(cuda)) as handle:
        assert handle == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(side), \
            _build.stream_for(torch.device(cuda)) as handle:
        assert handle == side.cuda_stream
