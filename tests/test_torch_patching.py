"""The port's patch metadata and patch reshapes against the JAX package's.

``build_meta`` / ``double_meta`` must give the same arrays as JAX for every
composition (the two packages then form the same patch batch row for row);
``split_latent`` / ``merge_patches`` / ``haloed`` must move the same values
(exact: they only copy).  The port's ``haloed`` is NCHW, JAX's NHWC.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sduss_tpu.ops import patching as jpatching
from sduss_tpu_torch.ops import patching as tpatching
from test_torch_slice import torch_threads  # noqa: F401

PATCH_BUCKETS = (4, 8, 16, 32, 64)
IMAGE_BUCKETS = (2, 4, 8, 16)

# (grids, cells, patch buckets, image buckets)
COMPOSITIONS = [
    ((2,), 8, PATCH_BUCKETS, IMAGE_BUCKETS),
    ((2, 4), 8, PATCH_BUCKETS, IMAGE_BUCKETS),
    ((2, 2, 4), 8, PATCH_BUCKETS, IMAGE_BUCKETS),
    # full-ceiling overflow: dummy slot past the image buckets, and the
    # doubled 5-slot class past buckets[-1] (tests/test_patching.py:174)
    ((1, 2), 16, (4, 8, 16, 32), (1, 2)),
    ((2, 2, 2, 2, 2, 1, 1, 1), 16, (4, 8, 16, 32, 64), (2, 4, 8)),
    # padded class: 3 images of one class padded to an image bucket of 4
    ((3, 4, 4, 4), 32, (4, 8, 16, 20, 24, 32, 40, 48, 64),
     (1, 2, 4, 8, 12)),
]


def _assert_meta_equal(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        elif f.name.startswith("class_") and f.name != "class_info":
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("doubled", [False, True])
@pytest.mark.parametrize("grids,cells,pb,ib", COMPOSITIONS)
def test_meta_equals_jax(grids, cells, pb, ib, doubled):
    fn = "double_meta" if doubled else "build_meta"
    _assert_meta_equal(getattr(tpatching, fn)(grids, cells, pb, ib),
                       getattr(jpatching, fn)(grids, cells, pb, ib))


def test_padded_class_reaches_masked_rows():
    """The chip-size mixed composition (768^2 + 3 x 1024^2 at 32-cell
    patches): the doubled 1024^2 class has 6 real of 8 slots, so two group
    rows have no valid key."""
    m = tpatching.double_meta((3, 4, 4, 4), 32,
                              (4, 8, 16, 20, 24, 32, 40, 48, 64, 80, 96,
                               128), (1, 2, 4, 8, 12, 16, 24, 32))
    assert m.class_info == ((4, 8), (3, 2))
    assert (~m.class_kv[0].any(axis=1)).sum() == 2
    assert m.class_kv[1].all()


def test_split_merge_equal_jax():
    img = np.random.default_rng(1).standard_normal((1, 24, 24, 5)).astype(
        np.float32)
    tp = tpatching.split_latent(torch.from_numpy(img), 8)
    jp = jpatching.split_latent(jnp.asarray(img), 8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = tpatching.merge_patches(tp, 3)
    np.testing.assert_array_equal(back.numpy(), img)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpatching.merge_patches(jp, 3)))
    with pytest.raises(ValueError, match="one image"):
        tpatching.split_latent(torch.zeros(2, 8, 8, 4), 8)


@pytest.mark.parametrize("grids", [(2,), (2, 3)])
def test_haloed_equals_jax(grids):
    m = tpatching.build_meta(grids, 4, PATCH_BUCKETS, IMAGE_BUCKETS)
    x = np.random.default_rng(2).standard_normal(
        (m.p_pad, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jpatching.haloed(jnp.asarray(x),
                                       jnp.asarray(m.neighbors)))
    got = tpatching.haloed(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(m.neighbors))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
