"""The patch path's image gate of the deep x compact hybrid against the JAX
package's (CPU, float32): ``compact_submeta``, the patch context's gate
inputs and ``BlockCache.gate_compact_images``.

- ``compact_submeta`` gives the same capacities, grids, buckets and index
  arrays as JAX's for several class layouts, with ``even`` on and off, and
  the same objects for the same arguments; ``PatchMeta.compile_key``
  equals JAX's.
- ``PatchContext.patch_valid`` and the unclipped ``class_slots`` equal the
  JAX context's ``patch_valid`` and ``class_gather``.
- ``gate_compact_images`` takes the same seeded patch rows, state and
  block body in both packages (the port's rows NCHW, JAX's NHWC) on the
  CFG-doubled meta of a mixed composition and must select the same patch
  rows and images, in the same order, and give the same output and new
  state: with CFG-pair scores, with bucket pad patches, with class pad
  slots and capacity past a class's real images (their rows dropped),
  with every row fresh (ties, the lowest index first) and without the pair
  offset.  Indices and hits exactly, tensors at RTOL 2e-4 / ATOL 5e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.cache.manager import BlockCache as JaxBlockCache
from sduss_tpu.config import CacheConfig as JaxCacheConfig
from sduss_tpu.ops import patching as jpatching
from sduss_tpu.ops.patch_ctx import PatchContext as JaxPatchContext
from sduss_tpu.ops.patch_ctx import ctx_arrays
from sduss_tpu_torch.cache.manager import BlockCache
from sduss_tpu_torch.config import CacheConfig
from sduss_tpu_torch.ops import patching as tpatching
from sduss_tpu_torch.ops.patch_ctx import PatchContext, compact_context
from test_torch_slice import torch_threads  # noqa: F401

RTOL = 2e-4
ATOL = 5e-4
MAX_HITS = 4
CELLS, C_IN, C_OUT = 4, 6, 5
PATCH_BUCKETS = (4, 8, 12, 16, 20, 24, 32)
IMAGE_BUCKETS = (1, 2, 4, 8)


@pytest.mark.parametrize("class_info", [
    ((2, 4), (1, 2)),            # 2 x 128^2 + 64^2, CFG-doubled
    ((4, 8), (3, 2)),            # SDXL's serving mix: 3 x 1024^2 + 768^2
    ((3, 4), (2, 4), (1, 2)),    # SD-1.5's: 768^2 + 2 x 512^2 + 256^2
    ((2, 1),),
])
@pytest.mark.parametrize("fraction", [0.3, 0.5, 1.0])
@pytest.mark.parametrize("even", [False, True])
def test_compact_submeta_matches_jax(class_info, fraction, even):
    sub, caps = tpatching.compact_submeta(CELLS, class_info, fraction, even)
    jsub, jcaps = jpatching.compact_submeta(CELLS, class_info, fraction, even)
    assert caps == jcaps
    assert tpatching.compact_submeta(CELLS, class_info, fraction, even)[0] \
        is sub
    assert sub.compile_key == jsub.compile_key
    for f in ("grids", "n_patches", "n_images", "p_pad", "i_pad", "max_pp",
              "class_info"):
        assert getattr(sub, f) == getattr(jsub, f), f
    for f in ("image_id", "neighbors", "group_gather", "patch_pos",
              "kv_mask"):
        np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f))
    for f in ("class_gather", "class_pos", "class_member", "class_kv"):
        for a, b in zip(getattr(sub, f), getattr(jsub, f)):
            np.testing.assert_array_equal(a, b)
    if even:
        assert all(c % 2 == 0 or c == ipc
                   for c, (_, ipc) in zip(caps, class_info))


def metas(grids):
    args = (tuple(grids), CELLS, PATCH_BUCKETS, IMAGE_BUCKETS)
    return tpatching.double_meta(*args), jpatching.double_meta(*args)


@pytest.mark.parametrize("grids", [(2, 1), (2, 2, 2, 1), (3, 2, 2, 1)])
def test_context_gate_inputs_match_jax(grids):
    meta, jmeta = metas(grids)
    assert meta.compile_key == jmeta.compile_key
    ctx, arrays = PatchContext(meta, "cpu"), ctx_arrays(jmeta)
    np.testing.assert_array_equal(ctx.patch_valid.numpy(),
                                  np.asarray(arrays["patch_valid"]))
    for ci, (g, ipc) in enumerate(meta.class_info):
        np.testing.assert_array_equal(
            ctx.class_slots[ci].numpy().reshape(-1),
            np.asarray(arrays[f"class_gather_{ci}"]))
    onehot = ctx.image_onehot.numpy()
    assert onehot.shape == (meta.i_pad, meta.p_pad)
    np.testing.assert_array_equal(onehot.argmax(0), meta.image_id)


def make_case(meta, seed: int, fresh: bool, predict: bool = False):
    rng = np.random.default_rng(seed)
    p = meta.p_pad
    x = rng.standard_normal((p, C_IN, CELLS, CELLS)).astype(np.float32)
    state = {
        "inp": (x + rng.uniform(0.05, 1.0, (p, 1, 1, 1))
                * rng.standard_normal(x.shape)).astype(np.float32),
        "out": rng.standard_normal(
            (p, C_OUT, CELLS, CELLS)).astype(np.float32),
        "hits": rng.integers(0, MAX_HITS, p).astype(np.int32),
    }
    if fresh:
        state["inp"][:] = 0.0
        state["out"][:] = 0.0
        state["hits"][:] = MAX_HITS
    if predict:
        state["slope"] = np.zeros_like(state["out"])
        state["seen"] = np.zeros((p,), bool)
    w = rng.standard_normal((C_IN, C_OUT)).astype(np.float32)
    side_patch = rng.standard_normal((p,)).astype(np.float32)
    side_img = rng.standard_normal((meta.i_pad,)).astype(np.float32)
    t_norm = rng.uniform(0, 1, p).astype(np.float32)
    return x, state, w, side_patch, side_img, t_norm


def nhwc(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 3, 1)


def run_both(grids, fraction, seed, fresh=False, pair=True, predict=False):
    meta, jmeta = metas(grids)
    x, state, w, sp, si, t_norm = make_case(meta, seed, fresh, predict)
    cc = dict(max_hits=MAX_HITS, deep_compact_fraction=fraction)
    sub_ctx, caps = compact_context(CELLS, meta.class_info, fraction, True,
                                    torch.device("cpu"))
    sub_img = sub_ctx.meta.image_id  # sub-batch patch -> sub-batch image
    offset = meta.i_pad // 2 if pair else None

    # the pair body: per-row math, a per-patch side input gathered by patch
    # and a per-image one by image, spread over the sub-batch's patches
    def port_body(x_s, gidx, imgs):
        y = torch.einsum("nchw,cd->ndhw", x_s, torch.from_numpy(w))
        side = torch.from_numpy(sp)[gidx] + torch.from_numpy(si)[imgs][sub_img]
        return torch.tanh(y) + side.reshape(-1, 1, 1, 1)

    def jax_body(x_s, gidx, imgs):
        y = jnp.einsum("nhwc,cd->nhwd", x_s, jnp.asarray(w))
        side = jnp.asarray(sp)[gidx] + jnp.asarray(si)[imgs][sub_img]
        return jnp.tanh(y) + side.reshape(-1, 1, 1, 1)

    pstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    py, pst, pstats = BlockCache(CacheConfig(**cc)).gate_compact_images(
        "k", torch.from_numpy(x), torch.from_numpy(t_norm), pstate, port_body,
        PatchContext(meta, "cpu"), caps, cfg_pair_offset=offset,
        two_level=False)
    jstate = {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v)
              for k, v in state.items()}
    jcache = JaxBlockCache(JaxCacheConfig(**cc))
    jy, jst, jstats = jax.jit(lambda x, t, st: jcache.gate_compact_images(
        "k", x, t, st, jax_body, JaxPatchContext(jmeta), caps,
        cfg_pair_offset=offset, two_level=False))(
        jnp.asarray(nhwc(x)), jnp.asarray(t_norm), jstate)
    assert pst is pstate
    np.testing.assert_array_equal(pstats["gather"].numpy(),
                                  np.asarray(jstats["gather"]))
    np.testing.assert_array_equal(pstats["images"].numpy(),
                                  np.asarray(jstats["images"]))
    np.testing.assert_allclose(nhwc(py.numpy()), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    assert set(pst) == set(jst) == {"inp", "out", "hits"}
    np.testing.assert_array_equal(pst["hits"].numpy(), np.asarray(jst["hits"]))
    for leaf in ("inp", "out"):
        np.testing.assert_allclose(nhwc(pst[leaf].numpy()),
                                   np.asarray(jst[leaf]), rtol=RTOL,
                                   atol=ATOL)
    return meta, caps, pstats, pst


@pytest.mark.parametrize("grids,fraction,seed", [
    ((2, 2, 1), 0.5, 1),       # bucket pad patches (9 -> 12)
    ((2, 2, 2, 1), 0.5, 2),    # class pad slots (6 real of 8)
    ((3, 2, 2, 1), 0.3, 3),    # three classes, one image of 3 x 3
])
def test_gate_compact_images_matches_jax(grids, fraction, seed):
    meta, caps, stats, state = run_both(grids, fraction, seed)
    # both halves of each selected image recompute: the pair scores are
    # symmetric and every capacity here is even
    imgs = stats["images"].tolist()
    half = meta.i_pad // 2
    assert sorted(imgs) == sorted({i % half for i in imgs}
                                  | {i % half + half for i in imgs})
    assert (state["hits"].numpy() == 0).sum() == len(stats["gather"])


def test_gate_surplus_capacity_writes_nowhere():
    """Fraction 1 gives the 2 x 2 class capacity 8 for 6 real images: two
    pad slots are selected, and their rows are dropped."""
    meta, caps, stats, state = run_both((2, 2, 2, 1), 1.0, 4)
    assert caps[0] == meta.class_info[0][1] == 8
    assert (stats["gather"].numpy() < 0).sum() == 2 * 4  # 2 slots x 4
    valid = meta.kv_mask.reshape(-1)[meta.patch_pos]
    hits = state["hits"].numpy()
    assert (hits[valid] == 0).all() and (hits[~valid] > 0).all()


def test_gate_fresh_state_ties_take_the_lowest_index():
    """A fresh state scores every patch ``1e6 + rel - threshold``: all
    images tie, and each class takes its lowest slots, as jax.lax.top_k."""
    meta, caps, stats, _ = run_both((2, 2, 2, 1), 0.5, 5, fresh=True)
    ctx = PatchContext(meta, "cpu")
    first = ctx.image_id[ctx.class_slots[0][:caps[0], 0]]
    assert stats["images"][:caps[0]].tolist() == first.tolist()


@pytest.mark.parametrize("predict", [False, True])
def test_gate_without_pair_offset_matches_jax(predict):
    """Without the pair offset the halves rank apart; a ``slope``/``seen``
    state comes back without them, as JAX returns it."""
    run_both((2, 2, 1), 0.5, 6, pair=False, predict=predict)


def test_two_level_rows_are_not_ported():
    """Two-level rows (``patch_fraction`` 0.5) serve through the gate: the
    body gets the ``k_q`` selected rows of the sub-batch and returns them,
    and only those rows are written (tests/test_torch_block_cache.py holds
    them against JAX)."""
    meta, _ = metas((2, 1))
    x, state, *_ = make_case(meta, 7, False)
    cache = BlockCache(CacheConfig(patch_fraction=0.5))
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    hits = state["hits"].clone()
    got = {}

    def body(x_s, gidx, imgs, sel):
        got["p_sub"], got["k_q"] = x_s.shape[0], sel.shape[0]
        return x_s[sel][:, :C_OUT] * 2.0

    y, st, stats = cache.gate_compact_images(
        "k", torch.from_numpy(x), torch.zeros(meta.p_pad), state, body,
        PatchContext(meta, "cpu"), (2, 2))
    assert got["k_q"] == max(1, round(got["p_sub"] * 0.5))
    written = stats["gather"][stats["tok_sel"]]
    assert (st["hits"][written] == 0).all()
    rest = torch.ones(meta.p_pad, dtype=torch.bool)
    rest[written] = False
    assert torch.equal(st["hits"][rest], hits[rest] + 1)
    torch.testing.assert_close(y[written], 2.0 * torch.from_numpy(
        x)[written][:, :C_OUT])
