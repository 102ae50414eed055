"""Port parity: ops/decorate.py against the JAX package.

Border, frame and raise are pads, slices and shading masks; the frame's
bevel canvas is the JAX function's own numpy canvas.  Each is held to
equality with the JAX function, on a batch of 2 x 24x32x4 and on one
24x32x3 image, for bevels wider than the frame, zero bevels and sunken
raises."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import decorate as jd
from imagemagick_tpu_torch.ops import decorate as td


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _equal(got, want):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


SHAPES = [(2, 24, 32, 4), (24, 32, 3), (5, 7, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("args", [(3, 2), (0, 4), (6, 0),
                                  (1, 1, (0.1, 0.2, 0.3, 0.4))], ids=str)
def test_border_equals_jax(shape, args):
    x = _img(shape)
    _equal(td.border(torch.from_numpy(x), *args),
           jd.border(jnp.asarray(x), *args))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("args", [
    (6, 6, 2, 2), (7, 5, 2, 3), (12, 12, 3, 3), (3, 3, 2, 2), (2, 5, 4, 4),
    (8, 4, 0, 0), (5, 8, 1, 6), (6, 6, 2, 2, (0.2, 0.5, 0.9, 1.0)),
    (10, 2, 3, 1, (1.0, 1.0, 1.0, 1.0))], ids=str)
def test_frame_equals_jax(shape, args):
    x = _img(shape, 1)
    w, h, ob, ib = args[:4]
    kw = {"matte_color": args[4]} if len(args) > 4 else {}
    _equal(td.frame(torch.from_numpy(x), w, h, ob, ib, **kw),
           jd.frame(jnp.asarray(x), w, h, ob, ib, **kw))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("args", [(6, 6, True), (6, 4, False), (1, 9, True),
                                  (20, 20, True), (0, 3, False)], ids=str)
def test_raise_equals_jax(shape, args):
    x = _img(shape, 2)
    _equal(td.raise_image(torch.from_numpy(x), *args),
           jd.raise_image(jnp.asarray(x), *args))


def test_frame_keeps_the_dtype_and_device():
    x = torch.from_numpy(_img((2, 9, 11, 3), 3))
    out = td.frame(x, 4, 3, 1, 1)
    assert out.device == x.device and out.dtype == x.dtype
    assert tuple(out.shape) == (2, 15, 19, 3)
    assert torch.equal(out[:, 3:12, 4:15], x)
