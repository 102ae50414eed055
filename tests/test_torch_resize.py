"""Port parity: imagemagick_tpu_torch.ops.resize against the JAX package.

The filter tables and weight matrices are numpy copies, so they must be
bit-equal; the resample runs in float32 on both sides (atol 1e-5, about
ten float32 roundings of values in [0, 1]).  ``sample`` and ``magnify``
gather and select pixels, and ``interpolative_resize``'s weights
(``_interp_weights``) are float64 numpy copies: those are held to
equality; its mesh and separable interpolations are float32 sums of at
most 16 products in another order (atol 1e-6).  With alpha the blended
methods divide the colors by the interpolated alpha, which catrom's
negative lobes can bring near 0, so there the alpha and the colors
multiplied back by it are held to 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import resize as jrz
from imagemagick_tpu_torch.ops import resize as trz

SIZE_PAIRS = [(64, 24), (37, 50), (100, 100)]


def test_supported_filters_equal():
    assert trz.supported_filters() == jrz.supported_filters()


@pytest.mark.parametrize("filt", jrz.supported_filters())
def test_axis_weights_and_matrix_bit_equal(filt):
    for n_in, n_out in SIZE_PAIRS:
        js, jw, jn = jrz._axis_weights(n_in, n_out, filt, 1.0)
        ts, tw, tn = trz._axis_weights(n_in, n_out, filt, 1.0)
        assert jn == tn
        assert np.array_equal(js, ts) and np.array_equal(jw, tw)
        assert np.array_equal(jrz.resize_matrix(n_in, n_out, filt),
                              trz.resize_matrix(n_in, n_out, filt))


@pytest.mark.parametrize("height,width,filt,alpha", [
    (24, 32, "lanczos", False),
    (60, 80, "mitchell", False),      # upscale
    (20, 56, "undefined", False),     # default filter, one axis kept
    (17, 23, "triangle", True),       # alpha-weighted resample
])
def test_resize_matches(height, width, filt, alpha):
    rng = np.random.default_rng(3)
    c = 4 if alpha else 3
    x = rng.uniform(0, 1, (2, 40, 56, c)).astype(np.float32)
    ref = np.asarray(jrz.resize(jnp.asarray(x), height, width, filt,
                                has_alpha=alpha))
    got = trz.resize(torch.from_numpy(x), height, width, filt,
                     has_alpha=alpha).numpy()
    assert got.shape == ref.shape == (2, height, width, c)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resize_windowed_gather_matches(monkeypatch):
    """The gather branch taken above the dense-matrix size bound."""
    monkeypatch.setattr(jrz, "_DENSE_LIMIT", 0)
    monkeypatch.setattr(trz, "_DENSE_LIMIT", 0)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    ref = np.asarray(jrz.resize(jnp.asarray(x), 19, 30, "lanczos"))
    got = trz.resize(torch.from_numpy(x), 19, 30, "lanczos").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# odd sizes, both directions, and 60 -> 15 (an exact integer product,
# where the 0.5 - 1e-9 offset floors down)
SAMPLE_SIZES = [(17, 29), (60, 80), (37, 106), (15, 13), (1, 1)]


def _img(shape, seed=7):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("height,width", SAMPLE_SIZES)
def test_sample_matches(height, width):
    x = _img((2, 60, 53, 3))
    ref = np.asarray(jrz.sample(jnp.asarray(x), height, width))
    got = trz.sample(torch.from_numpy(x), height, width).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("height,width", [(17, 29), (60, 80), (37, 106)])
def test_scale_matches(height, width):
    x = _img((2, 37, 53, 3))
    ref = np.asarray(jrz.scale(jnp.asarray(x), height, width))
    got = trz.scale(torch.from_numpy(x), height, width).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("shape,height,width,alpha", [
    ((2, 37, 53, 3), 17, 29, False),   # the final resize alone
    ((1, 90, 70, 3), 25, 20, False),   # box to 2x first
    ((1, 110, 130, 3), 21, 25, False),  # point-sample to 4x, box to 2x
    ((1, 90, 70, 4), 25, 20, True),
])
def test_thumbnail_matches(shape, height, width, alpha):
    x = _img(shape)
    ref = np.asarray(jrz.thumbnail(jnp.asarray(x), height, width,
                                   has_alpha=alpha))
    got = trz.thumbnail(torch.from_numpy(x), height, width,
                        has_alpha=alpha).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 21, 19, 3), (1, 1, 5, 1),
                                   (9, 1, 2)])
def test_magnify_matches(shape):
    """Pixels from three levels, so neighbours are often equal and every
    EPX rule fires."""
    x = (np.random.default_rng(8).integers(0, 3, shape) / 2).astype(
        np.float32)
    ref = np.asarray(jrz.magnify(jnp.asarray(x)))
    got = trz.magnify(torch.from_numpy(x)).numpy()
    assert got.shape == shape[:-3] + (2 * shape[-3], 2 * shape[-2],
                                      shape[-1])
    assert np.array_equal(got, ref)


INTERP_METHODS = ["integer", "nearest", "point", "average", "average4",
                  "average9", "average16", "blend", "catrom", "spline",
                  "bilinear"]


@pytest.mark.parametrize("method", INTERP_METHODS)
def test_interp_weights_equal(method):
    t = np.linspace(-1.3, 20.7, 41)
    ref = np.asarray(jrz._interp_weights(t, 19, method))
    got = trz._interp_weights(t, 19, method)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("method", INTERP_METHODS + ["mesh"])
@pytest.mark.parametrize("channels", [3, 4])
def test_interpolative_resize_matches(method, channels):
    x = _img((2, 23, 31, channels))
    for height, width in ((13, 45), (37, 19)):
        ref = np.asarray(jrz.interpolative_resize(jnp.asarray(x), height,
                                                  width, method))
        got = trz.interpolative_resize(torch.from_numpy(x), height, width,
                                       method).numpy()
        assert got.shape == ref.shape == (2, height, width, channels)
        if channels == 4 and method in ("bilinear", "blend", "catrom",
                                        "spline"):
            got = np.concatenate([got[..., :3] * got[..., 3:],
                                  got[..., 3:]], -1)
            ref = np.concatenate([ref[..., :3] * ref[..., 3:],
                                  ref[..., 3:]], -1)
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_mesh_sample_matches_on_gray_and_ties():
    """Mesh interpolation of one channel (its luma is the channel), at
    a 3x scale where the triangle tie-breaks fall exactly on thirds."""
    x = _img((1, 8, 9, 1))
    yy, xx = np.mgrid[0:24, 0:27].astype(np.float64)
    u, v = (xx + 0.5) / 3 - 0.5, (yy + 0.5) / 3 - 0.5
    ref = np.asarray(jrz._mesh_sample(jnp.asarray(x), u, v))
    got = trz._mesh_sample(torch.from_numpy(x), u, v).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    same = trz.interpolative_resize(torch.from_numpy(x), 8, 9).numpy()
    assert np.array_equal(same, x)
