"""The dense GroupNorm op of the port (``ops/gn_dense.py``, kernel K6's
wrapper) on the CPU: the plain version it takes there, the fused
time-embedding add, the argument checks that guard the CUDA kernel, the
span and cluster planners and the divisor the kernel's channel index uses.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py; the plain version against the
JAX group_norm by tests/test_torch_layers.py.  Every comparison here is
bit for bit: the CPU path runs the same PyTorch code.
"""

from __future__ import annotations

import random

import pytest
import torch

from sduss_tpu_torch.models import layers as TL
from sduss_tpu_torch.models.unet import ResnetBlock2D, _silu
from sduss_tpu_torch.ops import gn_dense as K6

DTYPES = [torch.bfloat16, torch.float32]
# (rows, channels, side) of the serving paths that every launch must fill
# with at least 4 blocks an SM: SDXL's shallow 8-row and full 24-row
# level-0 batches (the 960-channel up-block input too) and levels 1-2,
# SD-1.5's 32-row 64^2 batches and level 3, the one-image 1024^2 and
# 512^2 decodes
CELL_SHAPES = [
    (8, 320, 128), (8, 960, 128), (24, 320, 128), (24, 960, 128),
    (8, 640, 64), (8, 1280, 32), (24, 2560, 32),
    (32, 320, 64), (32, 960, 64), (32, 1280, 16), (32, 2560, 8),
    (1, 512, 128), (1, 512, 256), (1, 512, 512), (1, 256, 1024),
    (1, 128, 1024), (1, 256, 512), (1, 128, 512),
]
MIN_BLOCKS = 528  # 4 blocks on each of an H100's 132 SMs


def _x(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (1.5 * torch.randn(*shape, generator=gen) + 0.3).to(dtype)


def _affine(c, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=gen).to(dtype),
            torch.randn(c, generator=gen).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("groups", [8, 32])
def test_cpu_path_is_the_plain_version(dtype, act, groups):
    x = _x((2, 64, 6, 5), dtype)
    w, b = _affine(64, dtype)
    got = TL.group_norm(x, w, b, groups, 1e-5, act)
    want = K6.group_norm_reference(x, w, b, groups, 1e-5, act)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(TL.GroupNorm(groups, 64, 1e-5).to(dtype)(x, act),
                       K6.group_norm_reference(x, torch.ones(64, dtype=dtype),
                                               torch.zeros(64, dtype=dtype),
                                               groups, 1e-5, act))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_add_equals_the_two_op_code(dtype, act):
    """``add=`` gives the bits of ``h + t[:, :, None, None].to(h.dtype)``
    followed by the norm; a float32 ``t`` is rounded to h's dtype first."""
    h = _x((3, 32, 4, 4), dtype)
    w, b = _affine(32, dtype)
    t = torch.randn(3, 32, generator=torch.Generator().manual_seed(5))
    for add in (t, t.to(dtype)):
        want = TL.group_norm(h + add[:, :, None, None].to(h.dtype), w, b, 8,
                             1e-5, act)
        assert torch.equal(TL.group_norm(h, w, b, 8, 1e-5, act, add=add), want)
        assert torch.equal(K6.gn_dense(h, w, b, 8, 1e-5, act, add), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_ch,out_ch", [(32, 32), (32, 64)])
def test_resnet_dense_forward_unchanged(dtype, in_ch, out_ch):
    """The dense ResnetBlock2D with the add inside norm2 gives the bits of
    the two-op forward it replaced."""
    torch.manual_seed(0)
    res = ResnetBlock2D(in_ch, out_ch, 48, 8).to(dtype)
    x = _x((2, in_ch, 8, 8), dtype, seed=3)
    temb = _x((2, 48), dtype, seed=4)
    with torch.no_grad():
        got = res(x, temb)
        h = res.conv1(res.norm1(x, act="silu"))
        h = h + res.time_emb_proj(_silu(temb))[:, :, None, None].to(h.dtype)
        h = res.conv2(res.norm2(h, act="silu"))
        sc = x if res.conv_shortcut is None else res.conv_shortcut(x)
    assert torch.equal(got, sc + h)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _raises(match, x, groups=8, add=None, weight=None, bias=None):
    c = x.shape[1]
    w = _meta((c,)) if weight is None else weight
    b = _meta((c,)) if bias is None else bias
    with pytest.raises(ValueError, match=match):
        K6.check_inputs(x, w, b, groups, add)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_checks_refuse_other_dtypes(dtype):
    _raises("the kernel takes bfloat16 or float32", _meta((2, 32, 4, 4),
                                                          dtype))


def test_checks_refuse_non_contiguous():
    _raises("not contiguous", _meta((2, 4, 4, 32)).permute(0, 3, 1, 2))


def test_checks_refuse_channels_not_a_multiple_of_groups():
    _raises("not a multiple of 8 groups", _meta((2, 36, 4, 4)))


def test_checks_refuse_2_31_elements():
    _raises("2\\^31 elements", _meta((1, 32, 2**16, 2**10)))


def test_checks_refuse_bad_affine_and_add():
    x = _meta((2, 32, 4, 4))
    _raises("weight must be", x, weight=_meta((16,)))
    _raises("bias must be", x, bias=_meta((32,), torch.float16))
    _raises("weight is torch.bfloat16, bias torch.float32", x,
            bias=_meta((32,), torch.float32))
    _raises("add must be", x, add=_meta((2, 32), torch.float32))
    _raises("add must be", x, add=_meta((1, 32)))
    _raises("channels a group", _meta((1, 8192, 1, 1)), groups=1)


def test_checks_take_groups_up_to_the_shared_tables_limit():
    """The apply kernel's tables (three floats a channel with the add, and
    8 bytes beside) fit 48 KB up to MAX_GROUP_CHANNELS; one more channel
    a group is refused."""
    top = K6.MAX_GROUP_CHANNELS
    assert 3 * 4 * top + 8 <= 48 * 1024
    x = _meta((2, 2 * top, 2, 2))
    # within the limit only the device check is left (meta is not CUDA)
    _raises("CUDA device", x, groups=2, add=_meta((2, 2 * top)))
    _raises("channels a group", _meta((2, top + 1, 2, 2)), groups=1)


def test_no_cpu_fallback_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's checks: one on
    no CUDA device raises rather than taking the plain version."""
    x = _meta((2, 32, 4, 4))
    w = _meta((32,))
    with pytest.raises(ValueError, match="CUDA device"):
        K6.gn_dense(x, w, w, 8, 1e-5, "silu")
    with pytest.raises(ValueError):
        K6.gn_dense(torch.zeros(2, 32, 4, 4), torch.ones(32),
                    torch.zeros(32), 8, act="gelu")


def _check_plan(n, c, hw, groups, itemsize):
    spans, span_len = K6.plan_spans(n, c, hw, groups, itemsize)
    length = c // groups * hw
    assert span_len % (16 // itemsize) == 0
    # spans [k * span_len, min((k + 1) * span_len, length)) tile the
    # group's run exactly once, none empty
    starts = [k * span_len for k in range(spans)]
    ends = [min(s + span_len, length) for s in starts]
    assert starts[0] == 0 and ends[-1] == length
    assert all(e > s for s, e in zip(starts, ends))
    assert all(a == b for a, b in zip(ends, starts[1:]))
    return n * groups * spans


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c,side", CELL_SHAPES)
def test_plan_fills_the_card_at_the_cells_shapes(n, c, side, itemsize):
    assert _check_plan(n, c, side * side, 32, itemsize) >= MIN_BLOCKS


def test_plan_covers_odd_shapes():
    rng = random.Random(0)
    for _ in range(500):
        groups = rng.choice([1, 2, 8, 16, 32])
        c = groups * rng.randint(1, 40)
        _check_plan(rng.randint(1, 40), c, rng.randint(1, 5000), groups,
                    rng.choice([2, 4]))


def _check_cluster(n, c, hw, groups, itemsize):
    """The single-read plan: a power of two up to MAX_CLUSTER blocks whose
    chunks (16-byte multiples within MAX_CHUNK_BYTES) cover the group; the
    launch's blocks, or 0 for two passes."""
    cs = K6.plan_cluster(n, c, hw, groups, itemsize)
    if not cs:
        return 0
    length = c // groups * hw
    vec = 16 // itemsize
    chunk = -(-(-(-length // cs)) // vec) * vec
    assert cs in (1, 2, 4, 8, 16)
    assert chunk * cs >= length and (cs == 1 or chunk * (cs // 2) < length)
    assert chunk * itemsize <= K6.MAX_CHUNK_BYTES
    return n * groups * cs


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,c,side", CELL_SHAPES)
def test_cluster_plan_at_the_cells_shapes(n, c, side, itemsize):
    """Every UNet shape of the cells takes the single read in bf16; a group
    over 1 MB, or a one-image launch of 32 groups, two passes; either
    launch fills the card."""
    hw = side * side
    blocks = _check_cluster(n, c, hw, 32, itemsize)
    group_bytes = c // 32 * hw * itemsize
    assert bool(blocks) == (group_bytes <= K6.MAX_CLUSTER
                            * K6.MAX_CHUNK_BYTES and n > 1)
    if itemsize == 2 and n > 1:  # the UNet's batches
        assert blocks >= K6.MIN_CLUSTER_BLOCKS
    if not blocks:
        spans, _ = K6.plan_spans(n, c, hw, 32, itemsize)
        blocks = n * 32 * spans
    assert blocks >= MIN_BLOCKS


def test_cluster_plan_covers_odd_shapes():
    rng = random.Random(2)
    for _ in range(500):
        groups = rng.choice([1, 2, 8, 16, 32])
        c = groups * rng.randint(1, 40)
        _check_cluster(rng.randint(1, 40), c, 8 * rng.randint(1, 5000),
                       groups, rng.choice([2, 4]))


def test_fast_divisor_divides_exactly():
    """The kernel's channel index, (umulhi(n, mul) + n) >> shift in 32-bit
    unsigned arithmetic, equals n // d over the int32 range."""
    rng = random.Random(1)
    mask = (1 << 32) - 1
    divisors = list(range(1, 1100)) + [4096, 16384, 65536, 2**20, 2**30,
                                       2**31 - 1, 2**30 + 1, 3 * 2**20 + 7]
    divisors += [rng.randrange(1, 2**31) for _ in range(500)]
    for d in divisors:
        mul, shift = K6.fast_divisor(d)
        assert 0 < mul < 2**32
        for n in (0, 1, d - 1, d, d + 1, 2 * d - 1, 2**31 - 1,
                  rng.randrange(0, 2**31), rng.randrange(0, min(64 * d,
                                                                2**31))):
            if 0 <= n < 2**31:
                q = ((((n * mul) >> 32) + n) & mask) >> shift
                assert q == n // d, (n, d)
