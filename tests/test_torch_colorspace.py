"""Port parity: imagemagick_tpu_torch.ops.colorspace against the JAX package.

Float32 on both sides; the JAX package's pow is a split-exponent
exp2/log2 form and the port's is torch.pow, so atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import colorspace as jcs
from imagemagick_tpu_torch.ops import colorspace as tcs


def _color(channels, seed=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (2, 9, 11, channels)).astype(np.float32)


@pytest.mark.parametrize("src,dst", [
    ("srgb", "gray"), ("srgb", "linear_gray"), ("gray", "srgb"),
    ("linear_gray", "srgb"), ("srgb", "rgb"), ("rgb", "srgb"),
    ("scrgb", "srgb"), ("gray", "linear_gray"), ("srgb", "srgb"),
])
def test_convert_matches(src, dst):
    x = _color(1 if "gray" in src else 3)
    ref = np.asarray(jcs.convert(jnp.asarray(x), src, dst))
    got = tcs.convert(torch.from_numpy(x), src, dst).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_rec709_luma_equal():
    assert tcs.REC709_LUMA == jcs.REC709_LUMA


@pytest.mark.parametrize("key", ["lab", "hsl", "cmyk", "xyz", "ycbcr"])
def test_unported_colorspace_raises(key):
    x = torch.from_numpy(_color(3))
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.convert(x, "srgb", key)
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.convert(x, key, "srgb")


def test_unknown_colorspace_raises_value_error():
    with pytest.raises(ValueError):
        tcs.convert(torch.from_numpy(_color(3)), "srgb", "no-such-space")
