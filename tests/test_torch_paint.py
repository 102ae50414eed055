"""Port parity: ops/paint.py against the JAX package.

The masks of opaque and transparent paint and the flood fill are held to
equality with the JAX functions (the fuzz test is the JAX function's
channel mean, summed in channel order times the reciprocal of the
count).  The port's flood fill tests its fixpoint once every
``_CHECK_EVERY`` steps: it is held equal at iteration caps around that
stride.  Oil paint counts bins in integers, a strip of rows at a time:
equal with one strip and with many.  The gradient canvas is equal (its
radial distance takes a correctly rounded square root, as XLA's is; the
CPU's float32 ``torch.sqrt`` is not).  The JAX ``floodfill`` raises on a
batch without a target color; the port floods each image from its own
seed pixel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import paint as jp
from imagemagick_tpu_torch.ops import paint as tp


def _img(shape, seed=0, levels=None):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    return x


def _equal(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (24, 32, 4), (9, 5, 1)],
                         ids=str)
@pytest.mark.parametrize("fuzz,invert", [(0.0, False), (0.3, False),
                                         (0.3, True), (0.6, False)])
def test_opaque_paint_equals_jax(shape, fuzz, invert):
    x = _img(shape, 1, levels=4)
    t, f = [0.5, 0.5, 0.5, 1.0], [1.0, 0.0, 0.0, 0.25]
    _equal(tp.opaque_paint(torch.from_numpy(x), t, f, fuzz, invert),
           jp.opaque_paint(jnp.asarray(x), t, f, fuzz, invert))


@pytest.mark.parametrize("shape", [(2, 24, 32, 4), (24, 32, 2)], ids=str)
@pytest.mark.parametrize("fuzz,invert,alpha", [(0.0, False, 0.0),
                                               (0.3, True, 0.0),
                                               (0.4, False, 0.5)])
def test_transparent_paint_equals_jax(shape, fuzz, invert, alpha):
    x = _img(shape, 2, levels=4)
    t = [0.5, 0.5, 0.5]
    _equal(tp.transparent_paint(torch.from_numpy(x), t, alpha, fuzz, invert),
           jp.transparent_paint(jnp.asarray(x), t, alpha, fuzz, invert))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fuzz", [0.0, 0.35, 0.5])
@pytest.mark.parametrize("xy", [(3, 4), (0, 0), (31, 23)], ids=str)
def test_floodfill_from_the_seed_pixel_equals_jax(seed, fuzz, xy):
    x = _img((24, 32, 3), seed, levels=3)
    _equal(tp.floodfill(torch.from_numpy(x), *xy, [1, 0, 0], fuzz),
           jp.floodfill(jnp.asarray(x), *xy, [1, 0, 0], fuzz))


@pytest.mark.parametrize("max_iters", [1, 5, 31, 32, 33, 64, 65, None])
def test_floodfill_caps_equal_jax(max_iters):
    """A spiral corridor needs ~200 steps: the caps stop it midway, at and
    around the fixpoint test's stride."""
    x = np.zeros((21, 21, 3), np.float32)
    x[::2, :, :] = 1.0
    for r in range(1, 21, 4):
        x[r, -1] = 1.0
    for r in range(3, 21, 4):
        x[r, 0] = 1.0
    _equal(tp.floodfill(torch.from_numpy(x), 0, 0, [0, 0, 1], 0.0,
                        max_iters=max_iters),
           jp.floodfill(jnp.asarray(x), 0, 0, [0, 0, 1], 0.0,
                        max_iters=max_iters))


def test_floodfill_with_a_target_color_on_a_batch_equals_jax():
    x = _img((3, 24, 32, 3), 4, levels=3)
    _equal(tp.floodfill(torch.from_numpy(x), 3, 4, [0, 1, 0], 0.4,
                        target_color=[0.5, 0.5, 0.5]),
           jp.floodfill(jnp.asarray(x), 3, 4, [0, 1, 0], 0.4,
                        target_color=[0.5, 0.5, 0.5]))


def test_jax_batch_floodfill_raises_the_port_fills_each_image():
    """The JAX function indexes the batch's seed pixels as one color and
    raises; the port floods each image from its own seed pixel, as the
    JAX function floods that image alone."""
    x = _img((3, 24, 32, 3), 5, levels=3)
    with pytest.raises(ValueError):
        jp.floodfill(jnp.asarray(x), 3, 4, [1, 0, 0], 0.3)
    got = tp.floodfill(torch.from_numpy(x), 3, 4, [1, 0, 0], 0.3)
    for i in range(3):
        _equal(got[i], jp.floodfill(jnp.asarray(x[i]), 3, 4, [1, 0, 0], 0.3))


@pytest.mark.parametrize("shape", [(2, 20, 24, 3), (20, 24, 1),
                                   (16, 18, 4)], ids=str)
@pytest.mark.parametrize("radius", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("levels", [None, 6])
def test_oil_paint_equals_jax(shape, radius, levels):
    x = _img(shape, 6, levels=levels)
    _equal(tp.oil_paint(torch.from_numpy(x), radius),
           jp.oil_paint(jnp.asarray(x), radius))


def test_oil_paint_in_strips_equals_jax(monkeypatch):
    """A count table of a few rows: many strips, the same output."""
    x = _img((2, 21, 17, 3), 7, levels=5)
    monkeypatch.setattr(tp, "_OIL_CELLS", 2 * 17 * 256 * 3)
    _equal(tp.oil_paint(torch.from_numpy(x), 2.0),
           jp.oil_paint(jnp.asarray(x), 2.0))


@pytest.mark.parametrize("kind,angle", [("linear", 0.0), ("linear", 30.0),
                                        ("linear", 90.0), ("linear", 225.0),
                                        ("radial", 0.0)])
@pytest.mark.parametrize("hw", [(17, 23), (1, 9), (32, 32)], ids=str)
def test_gradient_image_equals_jax(kind, angle, hw):
    args = (*hw, [1, 0, 0, 1], [0, 0.5, 1, 0.5], kind, angle)
    _equal(tp.gradient_image(*args, device="cpu"),
           jp.gradient_image(*args))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_gradient_image_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.gradient_image(4, 4, [0, 0, 0], [1, 1, 1])
