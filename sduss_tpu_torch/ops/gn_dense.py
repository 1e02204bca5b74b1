"""Dense GroupNorm (+SiLU) on NCHW tensors: kernel K6 (``csrc/gn_dense.cu``).

Every dense GroupNorm of the port goes through :func:`gn_dense`: the
UNet's ``ResnetBlock2D`` norms (norm2 with the time-embedding add fused),
``Transformer2DModel.norm`` and ``conv_norm_out``, and every GroupNorm of
the VAE decoder.  The patch batch's per-image norms (``ops/gn_halo.py``,
K4) and a group's sharded contexts keep their own.

K6 replaces no TPU kernel: the JAX ``group_norm`` (sduss_tpu/models/
layers.py) is plain jnp code that XLA fuses into about two passes.  Run
eagerly, the same code (:func:`group_norm_reference`) is some eighteen
launches and ~52 bytes of device memory an element, with float32 copies of
the whole tensor.  The work is bound by bytes: one read and one write,
4 bytes an element in bf16.  Each (n, group) run is contiguous.  Where a
run fits the shared memory of one thread-block cluster and the launch has
64 groups or more (every UNet shape; :func:`plan_cluster`), one launch
reads it once into shared memory, the cluster's blocks exchange their
float32 partial sums through distributed shared memory and each writes
its chunk from there: 4 bytes an element.  Larger runs and one-image
launches (the VAE decoder's) take two launches, (a) float32 partial sums
per span and (b) the fold of the moments and the affine into one FMA per
channel, SiLU and the store: ~6 bytes an element; :func:`plan_spans` cuts
the runs so that each launch fills the card.  Both use 16-byte loads
and stores and no atomics, so a call repeats bit for bit.

A CPU tensor takes :func:`group_norm_reference`; a CUDA tensor launches
the kernel or raises.  ``gn_dense.launches`` counts calls, as every other
wrapper's counter (a K6 call is one kernel launch or two).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from sduss_tpu_torch.ops import _build

_ACTS = {None: 0, "silu": 1}
_DTYPES = (torch.bfloat16, torch.float32)
# Blocks a launch aims at: 1056, two waves of the 528 512-thread blocks an
# H100 holds at once (measured on one: fewer blocks a launch, such as one
# wave, stream slower); a span never shorter than MIN_SPAN elements (whole
# groups shorter than that take one block each).
TARGET_BLOCKS = 1056
MIN_SPAN = 8192
# The single-read design: a cluster of at most MAX_CLUSTER blocks a group,
# each block a chunk of at most MAX_CHUNK_BYTES; the fewest blocks (a
# power of two) whose chunks hold CHUNK_BYTES and whose launch has
# MIN_CLUSTER_BLOCKS (measured on an H100 at the UNet's bf16 shapes over
# 1-16 blocks a cluster and 256-1024 threads a block: this rule's pick was
# the fastest or within 6% of it).  A launch that cannot reach
# MIN_CLUSTER_BLOCKS (under 64 groups: a one-image decode) takes two
# passes, which measured faster there.
CHUNK_BYTES = 40 * 1024
MAX_CHUNK_BYTES = 64 * 1024
MAX_CLUSTER = 16
MIN_CLUSTER_BLOCKS = 1024
# The apply kernel's shared tables hold three floats a channel of a group
# (with the add) beside 8 bytes of its own: at most 48 KB, so 2048
# channels (the models' largest group is 80).
MAX_GROUP_CHANNELS = 2048
_VEC_BYTES = 16


def group_norm_reference(x, weight, bias, num_groups: int, eps: float = 1e-5,
                         act: Optional[str] = None, add=None):
    """GroupNorm over an ``(N, C, ...)`` tensor with float32 moments.

    The moments are E[x] and E[x^2] - E[x]^2, clamped at 0, exactly as the
    JAX group_norm and the fused patch kernel compute them (layers.py:90-119),
    not torch's two-pass variance; ``act="silu"`` fuses the activation.
    ``add`` (N, C), cast to x's dtype, is added to x first (x's dtype).
    """
    if add is not None:
        x = x + add.to(x.dtype).reshape(*add.shape, *[1] * (x.dim() - 2))
    n, c = x.shape[:2]
    g = num_groups
    xg = x.reshape(n, g, c // g, -1).float()
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(2, 3), keepdim=True) - mean * mean,
                      min=0.0)
    a = torch.rsqrt(var + eps) * weight.float().reshape(1, g, c // g, 1)
    b = bias.float().reshape(1, g, c // g, 1) - mean * a
    y = xg * a + b
    if act == "silu":
        y = F.silu(y)
    elif act is not None:
        raise ValueError(act)
    return y.reshape(x.shape).to(x.dtype)


def plan_spans(n: int, c: int, hw: int, groups: int, itemsize: int) -> tuple:
    """(spans a group, elements a span) for an ``(n, c, hw)`` tensor: every
    (n, g) run of ``(c / groups) * hw`` elements is cut into ``spans``
    spans of ``span_len`` elements (the last may be shorter, none empty),
    ``span_len`` a multiple of 16 bytes' elements, so that ``n * groups *
    spans`` blocks reach about TARGET_BLOCKS where the runs are long
    enough."""
    length = c // groups * hw
    vec = _VEC_BYTES // itemsize
    want = -(-TARGET_BLOCKS // (n * groups))
    spans = max(1, min(want, -(-length // MIN_SPAN)))
    span_len = -(-length // spans)
    span_len = -(-span_len // vec) * vec
    return -(-length // span_len), span_len


def plan_cluster(n: int, c: int, hw: int, groups: int, itemsize: int) -> int:
    """Blocks a cluster for the single-read design, 0 for two passes: the
    fewest, a power of two up to MAX_CLUSTER, whose chunks of
    ``ceil(length / blocks)`` elements (rounded up to 16 bytes) hold at most
    CHUNK_BYTES and whose launch has at least MIN_CLUSTER_BLOCKS; 0 where
    the chunk still exceeds MAX_CHUNK_BYTES (a group over ~1 MB) or the
    launch has fewer blocks."""
    length = c // groups * hw
    vec = _VEC_BYTES // itemsize
    cs = 1
    while cs < MAX_CLUSTER and (-(-length // cs) * itemsize > CHUNK_BYTES
                                or n * groups * cs < MIN_CLUSTER_BLOCKS):
        cs *= 2
    chunk = -(-length // cs)
    chunk = -(-chunk // vec) * vec
    if chunk * itemsize > MAX_CHUNK_BYTES or n * groups * cs < \
            MIN_CLUSTER_BLOCKS:
        return 0
    return cs


def fast_divisor(d: int) -> tuple:
    """(mul, shift) with ``(umulhi(n, mul) + n) >> shift == n // d`` for
    every 0 <= n < 2^31 (32-bit unsigned arithmetic), 1 <= d < 2^31."""
    shift = (d - 1).bit_length()  # the least s with 2^s >= d
    mul = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return mul, shift


@functools.lru_cache(maxsize=1024)
def _launch_plan(n: int, c: int, hw: int, groups: int, itemsize: int):
    """(spans, span_len, mul, shift, cluster) of a shape, computed once."""
    return (plan_spans(n, c, hw, groups, itemsize) + fast_divisor(hw)
            + (plan_cluster(n, c, hw, groups, itemsize),))


def check_inputs(x, weight, bias, num_groups: int, add=None) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"x is {x.dtype}; the kernel takes bfloat16 or "
                         f"float32")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N, C, ...) tensor, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous (NCHW)")
    n, c = x.shape[:2]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"C={c} is not a multiple of {num_groups} groups")
    if c // num_groups > MAX_GROUP_CHANNELS:
        raise ValueError(f"{c // num_groups} channels a group; the kernel "
                         f"takes at most {MAX_GROUP_CHANNELS}")
    if x.numel() // n >= 2**31:
        raise ValueError("a sample of 2^31 elements or more: too large for "
                         "the kernel's int32 offsets")
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.dtype not in _DTYPES \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16 or float32 "
                             f"({c},), got {t.dtype} {tuple(t.shape)}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"weight is {weight.dtype}, bias {bias.dtype}")
    if add is not None and (tuple(add.shape) != (n, c) or add.dtype != x.dtype
                            or not add.is_contiguous()):
        raise ValueError(f"add must be contiguous ({n}, {c}) {x.dtype}, got "
                         f"{add.dtype} {tuple(add.shape)}")
    for name, t in (("weight", weight), ("bias", bias), ("add", add)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device ({x.device})")


def gn_dense(x, weight, bias, num_groups: int, eps: float = 1e-5,
             act: Optional[str] = None, add=None):
    """GroupNorm (+ ``act``) of a contiguous ``(N, C, ...)`` tensor in its
    dtype; ``add`` (N, C) is added to x first, rounded to x's dtype (the
    ResnetBlock's ``h + temb[:, :, None, None].to(h.dtype)``).

    CPU tensors: :func:`group_norm_reference`.  Anything else goes to the
    CUDA kernel, one launch (single read) or two (two passes) by the shape:
    inputs it does not take raise ``ValueError``, a failed launch raises
    ``RuntimeError``.  Each call adds one to ``gn_dense.launches``.
    """
    if act not in _ACTS:
        raise ValueError(act)
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, num_groups, eps, act,
                                    add)
    if add is not None and add.dtype != x.dtype:
        add = add.to(x.dtype)
    check_inputs(x, weight, bias, num_groups, add)
    n, c = x.shape[:2]
    hw = x.numel() // (n * c)
    spans, span_len, mul, shift, cluster = _launch_plan(
        n, c, hw, num_groups, x.element_size())
    out = torch.empty_like(x)
    vec = (x.data_ptr() % _VEC_BYTES == 0 and out.data_ptr() % _VEC_BYTES == 0
           and hw % (_VEC_BYTES // x.element_size()) == 0)
    lib = _build.load_library()
    head = (x.data_ptr(), None if add is None else add.data_ptr(),
            weight.data_ptr(), bias.data_ptr(),
            int(weight.dtype == torch.float32))
    x_f32 = int(x.dtype == torch.float32)
    with _build.stream_for(x.device) as stream:
        if vec and cluster:
            err = lib.sduss_gn_dense_cluster(
                *head, out.data_ptr(), n, c, hw, num_groups, cluster, x_f32,
                _ACTS[act], eps, mul, shift, stream)
        else:
            part = torch.empty(2 * n * num_groups * spans,
                               dtype=torch.float32, device=x.device)
            err = lib.sduss_gn_dense(
                *head, part.data_ptr(), out.data_ptr(), n, c, hw, num_groups,
                spans, span_len, x_f32, int(vec), _ACTS[act], eps, mul, shift,
                stream)
    _build.check(lib, err, "gn_dense launch")
    _build.count(gn_dense)
    return out


gn_dense.launches = 0
