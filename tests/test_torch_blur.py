"""Port parity: imagemagick_tpu_torch.ops.blur against the JAX package.

Kernel widths and tables are numpy copies (equal).  Blurs run in float32
on both sides: atol 1e-5 for whole ops (clip included), 1e-6 for the
separable passes alone (at most 33 taps summed in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import blur as jbl
from imagemagick_tpu_torch.ops import blur as tbl
from imagemagick_tpu_torch.ops import gpu_kernels as gk


@pytest.mark.parametrize("radius,sigma", [
    (0.0, 0.5), (0.0, 1.0), (0.0, 2.0), (0.0, 3.7), (1.5, 1.0), (0.0, 0.0),
])
def test_kernel_widths_and_tables_equal(radius, sigma):
    assert tbl.optimal_kernel_width_1d(radius, sigma) == \
        jbl.optimal_kernel_width_1d(radius, sigma)
    assert tbl.optimal_kernel_width_2d(radius, sigma) == \
        jbl.optimal_kernel_width_2d(radius, sigma)
    assert np.array_equal(tbl.gaussian_kernel_1d(radius, sigma),
                          jbl.gaussian_kernel_1d(radius, sigma))


def _image(shape, seed=5):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("op", ["gaussian_blur", "blur"])
@pytest.mark.parametrize("sigma,shape", [
    (1.0, (2, 24, 32, 3)),
    (2.0, (2, 24, 32, 3)),
    (2.0, (24, 32, 1)),       # unbatched
    (8.0, (1, 40, 48, 3)),    # over 33 taps: the plain two-pass path
])
def test_blur_ops_match(op, sigma, shape):
    x = _image(shape)
    ref = np.asarray(getattr(jbl, op)(jnp.asarray(x), 0.0, sigma))
    got = getattr(tbl, op)(torch.from_numpy(x), 0.0, sigma).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("ntaps,sigma", [(3, 0.6), (15, 2.0), (33, 5.0)])
def test_separable_blur_plain_matches_depthwise_passes(ntaps, sigma):
    """K3's plain version == the JAX package's CPU path of
    `_separable_conv` (the two `_depthwise_conv` passes)."""
    j = ntaps // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    x = _image((2, 37, 45, 3))
    ref = jbl._depthwise_conv(jnp.asarray(x), k.reshape(1, -1), "edge")
    ref = np.asarray(jbl._depthwise_conv(ref, k.reshape(-1, 1), "edge"))
    got = gk._separable_blur_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the CPU wrapper takes the plain version and launches nothing
    before = dict(gk.LAUNCHES)
    np.testing.assert_array_equal(
        gk.separable_blur(torch.from_numpy(x), k).numpy(), got)
    assert gk.LAUNCHES == before


@pytest.mark.parametrize("vp", ["edge", "mirror", "tile", "black"])
def test_convolve_matches(vp):
    kern = np.array([[0.0, 1.0, 0.0], [1.0, 4.0, 1.0], [0.0, 1.0, 0.0]])
    x = _image((2, 20, 26, 3))
    ref = np.asarray(jbl.convolve(jnp.asarray(x), kern, 0.01, True, vp))
    got = tbl.convolve(torch.from_numpy(x), kern, 0.01, True, vp).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("threshold", [0.05, 0.0])
@pytest.mark.parametrize("radius,sigma,gain,shape", [
    (0.0, 1.0, 1.0, (2, 24, 32, 3)),
    (0.0, 0.5, 0.7, (24, 32, 1)),       # unbatched
    (2.0, 1.5, 2.0, (1, 40, 48, 3)),
])
def test_unsharp_mask_matches(threshold, radius, sigma, gain, shape):
    """UnsharpMaskImage with the reference's threshold semantics.  Pixels
    whose |2 diff| lies within 1e-5 of the threshold are left out: the
    two sides' blurs differ in the last bits and may pick either branch."""
    x = _image(shape, seed=17)
    ref = np.asarray(jbl.unsharp_mask(jnp.asarray(x), radius, sigma, gain,
                                      threshold))
    got = tbl.unsharp_mask(torch.from_numpy(x), radius, sigma, gain,
                           threshold).numpy()
    assert got.shape == ref.shape
    diff = x - tbl.blur(torch.from_numpy(x), radius, sigma).numpy()
    keep = np.abs(np.abs(2.0 * diff) - threshold) > 1e-5
    assert keep.mean() > 0.9
    if threshold:
        assert (np.abs(2.0 * diff) < threshold).any()
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)


def test_image_unsharp_mask_runs_k3_plain():
    """``Image.unsharp_mask`` blurs through `_separable_conv` (K3 on a
    card); on the CPU its wrapper takes the plain version."""
    from imagemagick_tpu.core.image import Image as JImage
    from imagemagick_tpu_torch import Image

    x = _image((2, 20, 26, 3), seed=18)
    before = dict(gk.LAUNCHES)
    got = Image(torch.from_numpy(x)).unsharp_mask(0.0, 1.0).to_numpy()
    ref = np.asarray(JImage(jnp.asarray(x)).unsharp_mask(0.0, 1.0).data)
    diff = x - tbl.blur(torch.from_numpy(x), 0.0, 1.0).numpy()
    keep = np.abs(np.abs(2.0 * diff) - 0.05) > 1e-5
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)
    assert gk.LAUNCHES == before
