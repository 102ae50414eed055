"""Port parity: imagemagick_tpu_torch.ops.colorspace against the JAX package.

Float32 on both sides; the JAX package's pow is a split-exponent
exp2/log2 form and the port's is torch.pow, so atol 1e-6 for the gray and
linear spaces.  XYZ and Lab go through that pow twice and through a cube
root (torch.pow against jnp.cbrt); the JAX split-exponent pow alone is
about 1e-5 off float64 there, so atol 5e-5."""

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


def test_cie_constants_equal():
    assert (tcs.CIE_EPSILON, tcs.CIE_K, tcs.D65) == \
        (jcs.CIE_EPSILON, jcs.CIE_K, jcs.D65)
    assert np.array_equal(tcs._RGB2XYZ, np.asarray(jcs._RGB2XYZ))
    assert np.array_equal(tcs._XYZ2RGB, np.asarray(jcs._XYZ2RGB))


def _cie_inputs(space, kind):
    """(2, 9, 11, 3) values in ``space``: uniform, near black, or out of
    the sRGB gamut (saturated Lab a/b, XYZ off the white axis)."""
    rng = np.random.default_rng(16)
    shape = (2, 9, 11, 3)
    if kind == "uniform":
        return rng.uniform(0, 1, shape).astype(np.float32)
    if kind == "near_black":
        x = rng.uniform(0, 0.02, shape)
        x[0, 0, :3] = [[0, 0, 0], [1e-6, 0, 2e-5], [0.0031, 0.0404, 0.004]]
        return x.astype(np.float32)
    x = rng.uniform(0, 1, shape)
    if space == "lab":           # a, b far from the neutral 0.5
        x[..., 1:] = rng.choice([0.02, 0.1, 0.9, 0.98], shape[:-1] + (2,))
    else:                        # X or Z much larger than Y
        x[..., 0] = rng.uniform(0.5, 1.0, shape[:-1])
        x[..., 1] = rng.uniform(0.0, 0.1, shape[:-1])
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "near_black", "out_of_gamut"])
@pytest.mark.parametrize("src,dst", [
    ("srgb", "lab"), ("lab", "srgb"), ("srgb", "xyz"), ("xyz", "srgb"),
    ("lab", "xyz"),
])
def test_convert_cie_matches(src, dst, kind):
    x = _cie_inputs(src, kind)
    ref = np.asarray(jcs.convert(jnp.asarray(x), src, dst))
    got = tcs.convert(torch.from_numpy(x), src, dst).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=5e-5)
    if kind == "out_of_gamut" and dst == "srgb":
        # these inputs reach negative linear RGB, which the reference
        # lifts before encoding
        xyz = torch.from_numpy(x)
        if src == "lab":
            xyz = tcs.lab_raw_to_xyz(torch.stack(
                [100.0 * xyz[..., 0], 255.0 * (xyz[..., 1] - 0.5),
                 255.0 * (xyz[..., 2] - 0.5)], dim=-1))
        lin = tcs._mat3(xyz, tcs._XYZ2RGB)
        assert float((lin.amin(dim=-1) < 0).float().mean()) > 0.2
        assert got.min() >= -1e-6


@pytest.mark.parametrize("key", ["luv", "hsl", "cmyk", "oklab", "ycbcr"])
def test_unported_colorspace_raises(key):
    x = torch.from_numpy(_color(3))
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.convert(x, "srgb", key)
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.convert(x, key, "srgb")


def test_unknown_colorspace_raises_value_error():
    with pytest.raises(ValueError):
        tcs.convert(torch.from_numpy(_color(3)), "srgb", "no-such-space")
