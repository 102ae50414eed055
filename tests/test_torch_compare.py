"""Port parity: ops/compare.py against the JAX module.

Every metric is a float32 reduction whose summation order differs between
XLA and PyTorch: each is held to the JAX value within 1e-6 relative (and
1e-7 absolute, for metrics near 0 such as mse); dssim = (1 - ssim) / 2
is held through the ssim it is taken from, 1 - 2 dssim, at 1e-6
relative.  ``ae`` is a count and equal; the difference image of
``compare_images`` is elementwise and equal bit for bit; the similarity
search finds the same offset, on a template whose best offset is unique.
Inputs come from a numpy seed: pairs of 2 images of at most 96x128."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.ops import compare as tcm

jcm = importlib.import_module("imagemagick_tpu.ops.compare")

RTOL, ATOL = 1e-6, 1e-7


def _pair(shape, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1)
    return a, b.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


PAIRS = [((2, 48, 64, 3), 0.05), ((96, 128, 3), 0.02), ((2, 40, 56, 1), 0.1),
         ((64, 80, 4), 0.03), ((2, 48, 64, 3), 0.0)]
BATCH_METRICS = sorted(set(tcm._METRICS) - {"phash"})


@pytest.mark.parametrize("metric", BATCH_METRICS)
@pytest.mark.parametrize("shape,noise", PAIRS, ids=str)
def test_metric_matches_jax(metric, shape, noise):
    a, b = _pair(shape, 1, noise)
    got = tcm.get_distortion(torch.from_numpy(a), torch.from_numpy(b), metric)
    want = jcm.get_distortion(jnp.asarray(a), jnp.asarray(b), metric)
    assert got.dtype == torch.float32 and got.dim() == 0
    if metric == "ae":
        assert float(got) == float(want)
    elif metric == "dssim":
        _close(1.0 - 2.0 * float(got), 1.0 - 2.0 * float(want))
    else:
        _close(got, want)


@pytest.mark.parametrize("shape,noise", [((96, 128, 3), 0.02),
                                         ((48, 64, 4), 0.1),
                                         ((48, 64, 3), 0.0)], ids=str)
def test_phash_matches_jax(shape, noise):
    """PHASH runs its float64 pipeline on the host in both packages."""
    a, b = _pair(shape, 2, noise)
    _close(tcm.get_distortion(torch.from_numpy(a), torch.from_numpy(b),
                              "phash"),
           jcm.get_distortion(jnp.asarray(a), jnp.asarray(b), "phash"))


@pytest.mark.parametrize("fuzz", [0.0, 0.05, 0.2])
def test_absolute_error_fuzz_matches_jax(fuzz):
    a, b = _pair((2, 48, 64, 3), 3)
    assert float(tcm.absolute_error(torch.from_numpy(a), torch.from_numpy(b),
                                    fuzz)) == \
        float(jcm.absolute_error(jnp.asarray(a), jnp.asarray(b), fuzz))


def test_mean_error_per_pixel_and_psnr_db_match_jax():
    a, b = _pair((2, 48, 64, 3), 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for g, w in zip(tcm.mean_error_per_pixel(ta, tb),
                    jcm.mean_error_per_pixel(ja, jb)):
        _close(g, w)
    _close(tcm.psnr_db(ta, tb), jcm.psnr_db(ja, jb))
    _close(tcm.psnr_db(ta, ta), jcm.psnr_db(ja, ja))


@pytest.mark.parametrize("metric", ["rmse", "ae", "ssim"])
@pytest.mark.parametrize("fuzz", [0.0, 0.1])
def test_compare_images_matches_jax(metric, fuzz):
    a, b = _pair((2, 48, 64, 3), 5)
    vis, dist = tcm.compare_images(torch.from_numpy(a), torch.from_numpy(b),
                                   metric, fuzz=fuzz)
    jvis, jdist = jcm.compare_images(jnp.asarray(a), jnp.asarray(b), metric,
                                     fuzz=fuzz)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    _close(dist, jdist)


def test_compare_images_highlight_on_gray():
    a, b = _pair((40, 56, 1), 6)
    vis, _ = tcm.compare_images(torch.from_numpy(a), torch.from_numpy(b),
                                highlight=(0.0, 1.0, 0.0))
    jvis, _ = jcm.compare_images(jnp.asarray(a), jnp.asarray(b),
                                 highlight=(0.0, 1.0, 0.0))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))


@pytest.mark.parametrize("shape,offset,tsize", [
    ((96, 128, 3), (17, 41), (24, 32)), ((64, 80, 3), (0, 0), (16, 16)),
    ((80, 96, 1), (50, 60), (20, 30))])
def test_similarity_image_finds_the_template(shape, offset, tsize):
    """A crop of a random image, found where it was cut: the port's
    offset equals the JAX one and the true one, and the correlation
    surfaces agree within float32 FFT rounding."""
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    (y0, x0), (th, tw) = offset, tsize
    tpl = x[y0:y0 + th, x0:x0 + tw]
    (y, xx), corr = tcm.similarity_image(torch.from_numpy(x),
                                         torch.from_numpy(tpl))
    (jy, jx), jcorr = jcm.similarity_image(jnp.asarray(x), jnp.asarray(tpl))
    assert (y, xx) == (int(jy), int(jx)) == (y0, x0)
    jc = np.asarray(jcorr)
    np.testing.assert_allclose(corr.numpy(), jc,
                               atol=1e-5 * np.abs(jc).max())


def test_similarity_image_takes_one_image():
    with pytest.raises(ValueError, match="one"):
        tcm.similarity_image(torch.zeros(2, 8, 8, 3), torch.zeros(4, 4, 3))


def test_metric_registry_as_the_jax_test_checks_it():
    """tests/test_compare.py's case: all 14 metrics dispatch and are
    finite; MEPP is the raw quantum-unit |d| sum; PHASH of equal images
    is about 0."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((32, 32, 3)).astype(np.float32))
    b = torch.clamp(a + 0.01, 0, 1)
    assert sorted(tcm._METRICS) == sorted(jcm._METRICS)
    for m in ("ae", "fuzz", "mae", "mepp", "mse", "ncc", "pae", "psnr",
              "phash", "rmse", "ssim", "dssim", "phase", "dpc"):
        assert np.isfinite(float(tcm.get_distortion(a, b, m))), m
    raw = float(tcm.get_distortion(a, b, "mepp"))
    assert abs(raw / (32 * 32 * 3 * 65535.0) - 0.01) < 1e-3, raw
    assert float(tcm.get_distortion(a, a, "phash")) < 1e-6


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="unknown metric"):
        tcm.get_distortion(torch.zeros(4, 4, 3), torch.zeros(4, 4, 3), "mad")
