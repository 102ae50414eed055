"""Port parity: ops/transform.py and core/geometry.parse_page_geometry
against the JAX package.

Every transform is a slice, flip, pad or concatenation, so each is held
to equality with the JAX function, on a batch of 2 x 24x32x4 and on one
24x32x3 image, with crops and extents that overlap the edge or lie
wholly outside it.  ``trim_bounds`` compares in float64 in both packages
(numpy there, tensors here): its box is held to equality, with and
without alpha and fuzz."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core import geometry as jgeo
from imagemagick_tpu.ops import transform as jt
from imagemagick_tpu_torch.core import geometry as tgeo
from imagemagick_tpu_torch.ops import transform as tt


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _equal(got, want):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


SHAPES = [(2, 24, 32, 4), (24, 32, 3)]
BG = (0.2, 0.4, 0.6, 0.8)

CALLS = [
    ("crop", (5, 7, 10, 12)), ("crop", (-5, -7, 20, 30)),
    ("crop", (25, 18, 20, 16)), ("crop", (-3, 4, 40, 10)),
    ("crop", (100, 100, 5, 6)), ("crop", (-40, 0, 8, 8)),
    ("chop", (5, 7, 10, 8)), ("chop", (-4, -2, 10, 8)),
    ("chop", (30, 20, 10, 10)), ("excerpt", (3, 4, 10, 9)),
    ("excerpt", (20, 10, 30, 30)), ("extent", (-5, -3, 44, 36)),
    ("extent", (5, 3, 20, 14)), ("extent", (-50, 0, 20, 20)),
    ("extent", (40, 40, 6, 6)), ("flip", ()), ("flop", ()),
    ("roll", (5, -3)), ("roll", (-40, 27)), ("shave", (3, 2)),
    ("shave", (0, 5)), ("splice", (5, 4, 3, 2)), ("splice", (0, 24, 0, 3)),
    ("transpose", ()), ("transverse", ()), ("rotate90", ()),
    ("rotate180", ()), ("rotate270", ()),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,args", CALLS,
                         ids=[f"{n}{a}" for n, a in CALLS])
def test_transform_equals_jax(name, args, shape):
    x = _img(shape)
    _equal(getattr(tt, name)(torch.from_numpy(x), *args),
           getattr(jt, name)(jnp.asarray(x), *args))


@pytest.mark.parametrize("name,args", [
    ("crop", (5, 7, 10, 12)), ("crop", (-5, -7, 20, 30)),
    ("crop", (100, 100, 5, 6)), ("extent", (-5, -3, 44, 36)),
    ("extent", (40, 40, 6, 6)), ("splice", (5, 4, 3, 2))])
def test_transform_with_background_equals_jax(name, args):
    x = _img((2, 24, 32, 4), 1)
    _equal(getattr(tt, name)(torch.from_numpy(x), *args, background=BG),
           getattr(jt, name)(jnp.asarray(x), *args, background=BG))


def test_crop_partly_outside_pads_zeros_with_a_background():
    """The JAX crop fills a region wholly outside the canvas with the
    background but pads one partly outside with zeros (``jnp.pad``'s
    constant mode without ``constant_values``); the port pads as it
    does."""
    x = _img((24, 32, 3), 2)
    got = tt.crop(torch.from_numpy(x), -5, -7, 20, 30, background=BG)
    assert torch.all(got[:7] == 0.0) and torch.all(got[:, :5] == 0.0)
    out = tt.crop(torch.from_numpy(x), 100, 100, 5, 6, background=BG)
    assert torch.all(out == torch.tensor(BG[:3]))


@pytest.mark.parametrize("o", range(0, 10))
def test_auto_orient_equals_jax(o):
    x = _img((2, 24, 32, 3), 3)
    _equal(tt.auto_orient(torch.from_numpy(x), o),
           jt.auto_orient(jnp.asarray(x), o))


def _bordered(c, seed, alpha_mode=None):
    """A page with a flat border and content inside it."""
    rng = np.random.default_rng(seed)
    x = np.ones((30, 40, c), np.float32) * 0.9
    x[6:21, 9:33] = rng.uniform(0, 1, (15, 24, c))
    x[6, 9] = 0.0
    if alpha_mode == "opaque":
        x[..., -1] = 1.0
    elif alpha_mode == "transparent":
        x[..., -1] = 0.0
        x[8:18, 12:25, -1] = rng.uniform(0.3, 1.0, (10, 13))
    return x


TRIMS = [(1, None), (3, None), (2, "opaque"), (4, "opaque"),
         (4, "transparent"), (2, "transparent")]


@pytest.mark.parametrize("fuzz", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("c,alpha", TRIMS, ids=str)
def test_trim_bounds_equal_jax(c, alpha, fuzz):
    x = _bordered(c, 4, alpha)
    got = tt.trim_bounds(torch.from_numpy(x), fuzz)
    assert got == jt.trim_bounds(jnp.asarray(x), fuzz)
    assert all(type(v) is int for v in got)
    _equal(tt.trim(torch.from_numpy(x), fuzz), jt.trim(jnp.asarray(x), fuzz))


def test_trim_of_a_batch_takes_image_0s_box():
    a = _bordered(3, 5)
    b = np.zeros_like(a)
    x = np.stack([a, b])
    assert tt.trim_bounds(torch.from_numpy(x)) == \
        jt.trim_bounds(jnp.asarray(x)) == tt.trim_bounds(torch.from_numpy(a))
    _equal(tt.trim(torch.from_numpy(x)), jt.trim(jnp.asarray(x)))


@pytest.mark.parametrize("x", [np.full((12, 10, 3), 0.5, np.float32),
                               _img((12, 10, 4), 6)], ids=["flat", "noise"])
def test_trim_of_flat_and_full_images_equals_jax(x):
    assert tt.trim_bounds(torch.from_numpy(x)) == \
        jt.trim_bounds(jnp.asarray(x))


# the geometry strings of the JAX package's tests (-crop, -extract,
# -region, montage's -geometry), and the crop grammar's other forms
PAGE_GEOMETRIES = [
    "20x16+2+2", "60x50+2+3", "30x20+0+0", "8x6+2+2", "10x10+0+0",
    "20x20+2+2", "4x4+0+0", "50%", "50%x25%+3+4", "x20", "30x", "+5+7",
    "-5-7", "100x100-10+20", "3x2@", "30x20!", "0x0", "200%", "12x8-3-4",
]


@pytest.mark.parametrize("geometry", PAGE_GEOMETRIES)
def test_parse_page_geometry_equal(geometry):
    for w, h in ((768, 512), (64, 96), (7, 5)):
        assert tgeo.parse_page_geometry(geometry, w, h) == \
            jgeo.parse_page_geometry(geometry, w, h)
