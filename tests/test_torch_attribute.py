"""Port parity: ops/attribute.py against the JAX module.

Every function is held to the JAX one exactly: the box comes from the
port's ``trim_bounds`` (float64 comparisons), depth, type and the hulls
are float64 numpy on the host in both, and ``set_image_type`` coerces by
the ported grayscale, normalize, bilevel and the same native octree
library, bit for bit.  The exception is a palette of anything but one
RGB frame, which both packages make by k-means (256 colours, 8
iterations): the port sums its clusters in float64, the JAX function in
float32 inside a fused scan, so a cluster mean may differ by an ulp and
a label may flip on it.  On RGBA those stay ulps (at most 0.1 % of the
pixels further than 1e-5 apart).  On a 48x64 gray frame 256 clusters
hold about 12 pixels each on one axis: a flipped label moves a mean by
about 1e-4 and the next iterations carry it on (4 % of the pixels end
up to 0.004 apart), so that case is held by its quantization error, the
mean |out - in|, within 1e-5 of the JAX one's, and by its colour count.
Inputs come from a numpy seed, at most 96x128."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.ops import attribute as ta

ja = importlib.import_module("imagemagick_tpu.ops.attribute")


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _kinds():
    """Images of every type: truecolor, palette, grayscale, bilevel, with
    and without alpha, and 16-bit content."""
    x = _img((96, 128, 3), 1)
    pal = (np.round(x * 3) / 3).astype(np.float32)
    gray = np.repeat(x[..., :1], 3, -1)
    bilevel = (gray > 0.5).astype(np.float32)
    deep = (np.round(x * 65535) / 65535).astype(np.float32)
    a = _img((96, 128, 1), 2)
    return {
        "truecolor": x, "palette": pal, "gray3": gray, "bilevel3": bilevel,
        "gray1": x[..., :1], "bilevel1": bilevel[..., :1],
        "deep": deep, "palette4": np.concatenate([pal, a], -1),
        "truecolor4": np.concatenate([x, a], -1),
        "levels16": (np.round(x * 15) / 15).astype(np.float32),
        "levels4": (np.round(x * 3) / 3).astype(np.float32)[..., :1],
    }


KINDS = _kinds()


@pytest.mark.parametrize("name", sorted(KINDS))
@pytest.mark.parametrize("has_alpha", [False, True])
def test_image_type_equals_jax(name, has_alpha):
    x = KINDS[name]
    assert ta.image_type(torch.from_numpy(x), has_alpha) == \
        ja.image_type(jnp.asarray(x), has_alpha)


@pytest.mark.parametrize("name", sorted(KINDS))
@pytest.mark.parametrize("max_depth", [16, 8])
def test_image_depth_equals_jax(name, max_depth):
    x = KINDS[name]
    assert ta.image_depth(torch.from_numpy(x), max_depth) == \
        ja.image_depth(jnp.asarray(x), max_depth)


TARGETS = ["bilevel", "grayscale", "palette", "truecolor", "truecolormatte",
           "grayscalealpha", "Palette", "optimize"]


@pytest.mark.parametrize("target,name", [
    (t, n) for t in TARGETS for n in ("truecolor", "gray1", "truecolor4",
                                      "palette")
    if not (t.lower() == "palette" and n in ("gray1", "truecolor4"))])
def test_set_image_type_equals_jax(target, name):
    x = KINDS[name][:48, :64]
    got = ta.set_image_type(torch.from_numpy(x), target, x.shape[-1] == 4)
    want = np.asarray(ja.set_image_type(jnp.asarray(x), target,
                                        x.shape[-1] == 4))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["truecolor4", "gray1"])
def test_set_image_type_palette_by_kmeans_matches_jax(name):
    x = KINDS[name][:48, :64]
    alpha = x.shape[-1] == 4
    got = ta.set_image_type(torch.from_numpy(x), "palette", alpha).numpy()
    want = np.asarray(ja.set_image_type(jnp.asarray(x), "palette", alpha))
    assert got.shape == want.shape
    apart = (np.abs(got - want) > 1e-5).any(-1).mean()
    if name == "truecolor4":
        assert apart <= 1e-3
    else:
        assert abs(np.abs(got - x).mean() - np.abs(want - x).mean()) <= 1e-5
        assert len(np.unique(got)) <= 256


def test_set_image_type_palette_on_a_batch_takes_kmeans():
    """A batch is not one RGB frame: both packages quantize it by
    k-means (256 colours, 8 iterations), whose palettes agree within
    1e-5 (the port sums its clusters in float64)."""
    x = KINDS["palette"][:24, :32]
    b = np.stack([x, x[::-1]])
    got = ta.set_image_type(torch.from_numpy(b), "palette").numpy()
    want = np.asarray(ja.set_image_type(jnp.asarray(b), "palette"))
    assert got.shape == want.shape
    assert ((np.abs(got - want) > 1e-5).any(-1)).mean() <= 1e-3


def _shapes():
    out = []
    x = np.zeros((48, 64, 3), np.float32)
    x[10:30, 12:40] = 0.8
    x[35, 50] = 1.0
    out.append(x)
    y = np.ones((40, 56, 1), np.float32)
    for i in range(12):
        y[5 + i, 10 + 2 * i: 14 + 2 * i] = 0.1
    out.append(y)
    z = np.zeros((32, 32, 4), np.float32)
    z[8:9, 3:29] = 0.5           # a line: a degenerate hull
    out.append(z)
    out.append(np.zeros((16, 16, 3), np.float32))   # nothing: no hull
    out.append(_img((40, 48, 3), 3))
    return out


@pytest.mark.parametrize("idx", range(5))
def test_hulls_and_boxes_equal_jax(idx):
    x = _shapes()[idx]
    t, j = torch.from_numpy(x), jnp.asarray(x)
    assert ta.convex_hull(t) == ja.convex_hull(j)
    assert ta.minimum_bounding_box(t) == ja.minimum_bounding_box(j)
    for fuzz in (0.0, 0.05):
        assert ta.bounding_box(t, fuzz) == ja.bounding_box(j, fuzz)


def test_monotone_chain_equals_jax():
    pts = np.random.default_rng(4).integers(0, 50, (200, 2)).astype(
        np.float64)
    np.testing.assert_array_equal(ta._monotone_chain(pts),
                                  ja._monotone_chain(pts))
