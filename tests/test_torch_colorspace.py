"""Port parity: imagemagick_tpu_torch.ops.colorspace against the JAX package.

Float32 on both sides; the JAX package's pow is a split-exponent
exp2/log2 form and the port's is torch.pow, so atol 1e-6 for the gray and
linear spaces.  XYZ and Lab go through that pow twice and through a cube
root (torch.pow against jnp.cbrt); the JAX split-exponent pow alone is
about 1e-5 off float64 there, so atol 5e-5.

Every one of the 41 keys, in both directions (``_KEY_TOL``): the
matrix, offset and piecewise-linear spaces without a transcendental
function (the YCbCr family, OHTA, CMY, PhotoYCC, the hue sextant spaces)
run the same float32 operations in the same order, to one float32 ulp
near 1 (2.5e-7); the spaces through the sRGB transfer, a cube root,
atan2 or a log (CIE, OkLab, CMYK, Cineon log, the RGB working spaces,
HSI) to 1e-5 of the value (rtol and atol); Jzazbz's PQ curve raises to
the powers 134 and 1/0.159, so 2e-5.  A hue channel is compared
circularly (h and h +- 1 are one hue); at near-gray pixels atan2 of a
chroma of a few ulps is ill-conditioned, so the LCh hues take 1e-4."""

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


_EXACT = 2.5e-7
_POW = 1e-5
_KEY_TOL = {k: _EXACT for k in (
    "srgb", "undefined", "transparent", "cmy", "gray", "hsl", "hsv", "hsb",
    "hwb", "hcl", "hclp", "ycbcr", "ypbpr", "rec601ycbcr", "rec709ycbcr",
    "yiq", "yuv", "ydbdr", "ohta", "ycc")}
_KEY_TOL.update({k: _POW for k in (
    "rgb", "scrgb", "linear_gray", "xyz", "lab", "lch", "lchab", "luv",
    "lchuv", "xyy", "lms", "cat02lms", "oklab", "oklch", "log", "cmyk",
    "adobe98", "displayp3", "prophoto", "hsi")})
_KEY_TOL["jzazbz"] = 2e-5
# the hue channel of each hue space, and its tolerance where it is not
# the space's own
_HUE = {"hsl": 0, "hsv": 0, "hsb": 0, "hwb": 0, "hsi": 0, "hcl": 0,
        "hclp": 0, "lchab": 2, "lch": 2, "lchuv": 2, "oklch": 2}
_HUE_TOL = {"lchab": 1e-4, "lch": 1e-4, "lchuv": 1e-4}


def _channels(key):
    return 4 if key == "cmyk" else 1 if key in ("gray", "linear_gray") \
        else 3


def _srgb_samples(seed=21):
    """(2, 9, 11, 3) sRGB: uniform, plus black, white, a gray, the
    primaries and secondaries (hue 0 and its wrap near 1)."""
    x = np.random.default_rng(seed).uniform(0, 1, (2, 9, 11, 3))
    x[0, 0, :10] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                    [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                    [1, 0, 1e-4]]
    return x.astype(np.float32)


def _assert_key_close(key, got, ref, hue=False):
    """``got`` within the key's tolerance of ``ref``; with ``hue`` the
    values are in the key's space and its hue is compared circularly."""
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    tol = _KEY_TOL[key]
    d = np.abs(np.nan_to_num(got) - np.nan_to_num(ref))
    if hue and key in _HUE:
        hc = _HUE[key]
        dh = d[..., hc] % 1.0
        d[..., hc] = np.minimum(dh, 1.0 - dh)
        assert d[..., hc].max() <= _HUE_TOL.get(key, tol), key
        d[..., hc] = 0.0
    assert np.all(d <= tol + tol * np.abs(np.nan_to_num(ref))), \
        (key, d.max())


def test_supported_colorspaces_equal():
    assert tcs.supported_colorspaces() == jcs.supported_colorspaces()
    assert len(tcs.supported_colorspaces()) == 41


@pytest.mark.parametrize("key", jcs.supported_colorspaces())
def test_from_srgb_matches(key):
    x = _srgb_samples()
    ref = np.asarray(jcs.convert(jnp.asarray(x), "srgb", key))
    got = tcs.convert(torch.from_numpy(x), "srgb", key).numpy()
    assert got.shape[-1] == _channels(key)
    _assert_key_close(key, got, ref, hue=True)


@pytest.mark.parametrize("key", jcs.supported_colorspaces())
def test_to_srgb_matches(key):
    """Values the JAX package makes from sRGB, and uniform values of
    the key's channels (out of gamut for many keys)."""
    x = _srgb_samples()
    fwd = np.array(jcs.convert(jnp.asarray(x), "srgb", key))
    uni = np.random.default_rng(22).uniform(
        0, 1, fwd.shape).astype(np.float32)
    for v in (fwd, uni):
        ref = np.asarray(jcs.convert(jnp.asarray(v), key, "srgb"))
        got = tcs.convert(torch.from_numpy(v), key, "srgb").numpy()
        assert got.shape == v.shape[:-1] + (3,)
        _assert_key_close(key, got, ref)


def test_ycc_table_is_a_copy():
    from imagemagick_tpu.ops._ycc_map import YCC_MAP as jmap
    from imagemagick_tpu_torch.ops._ycc_map import YCC_MAP as tmap

    assert tmap == jmap and len(tmap) == 1389


def test_hue_wraps_at_both_ends():
    """Hues just above 0 and just below 1 are neighbours: both decode
    to nearly pure red in every sextant space."""
    h = np.array([[1e-6, 1.0, 0.5], [1.0 - 1e-6, 1.0, 0.5]], np.float32)
    for key in ("hsl", "hsv", "hsb"):
        got = tcs.convert(torch.from_numpy(h), key, "srgb").numpy()
        ref = np.asarray(jcs.convert(jnp.asarray(h), key, "srgb"))
        np.testing.assert_allclose(got, ref, atol=_EXACT)
        assert np.abs(got[0] - got[1]).max() < 1e-4


def test_unknown_colorspace_raises_value_error():
    with pytest.raises(ValueError):
        tcs.convert(torch.from_numpy(_color(3)), "srgb", "no-such-space")
