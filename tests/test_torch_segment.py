"""Port parity: ops/segment.py against the JAX package.

The scale-space analysis is the port's own copy of the JAX module's host
code: its extrema maps are held equal to the JAX ones.  ``segment`` is
held to equality (its histograms, box tests and nearest-center
assignment are integer or exact float32 work; cluster sums are exact
integers in the port), on gray blobs, two-color images, noise, an alpha
image, a gray image, a batch (whose histograms span every image, as in
the JAX function), in HSL and YCbCr, and with the pixel passes cut into
small chunks; in Lab within 1e-7 (the colorspace module's conversion
back, an ulp from XLA's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import segment as js
from imagemagick_tpu_torch.ops import segment as ts


def _blob_image(levels, h=64, w=66, noise=0.01, seed=0):
    """Gray blobs at the given levels, equal areas, mild noise."""
    rng = np.random.default_rng(seed)
    cols = np.array_split(np.arange(w), len(levels))
    img = np.zeros((h, w, 3), np.float32)
    for lv, cc in zip(levels, cols):
        img[:, cc, :] = lv
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def _two_colors(seed=3):
    rng = np.random.default_rng(seed)
    img = np.zeros((64, 64, 3), np.float32)
    img[:, :32] = (0.8, 0.15, 0.15)
    img[:, 32:] = (0.1, 0.2, 0.75)
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape) \
        .astype(np.float32)


def _equal(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("smooth", [0.0, 1.0, 1.5, 3.0])
def test_optimal_tau_equals_jax(seed, smooth):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        np.clip(rng.normal(60 + 20 * seed, 5 + seed, 4000), 0, 255),
        np.clip(rng.normal(190, 5, 3000), 0, 255),
        rng.uniform(0, 255, 500)]).astype(np.int64)
    hist = np.bincount(vals, minlength=256)[:256]
    np.testing.assert_array_equal(ts.optimal_tau(hist, smooth),
                                  js.optimal_tau(hist, smooth))
    assert ts._regions(ts.optimal_tau(hist, smooth)) == \
        js._regions(js.optimal_tau(hist, smooth))


IMAGES = {
    "three-blobs": lambda: _blob_image([0.1, 0.5, 0.9]),
    "five-blobs": lambda: _blob_image([0.05, 0.3, 0.5, 0.7, 0.95], 40, 70,
                                      0.03, 1),
    "two-colors": _two_colors,
    "noise": lambda: _noise((32, 40, 3), 2),
    "rgba": lambda: np.concatenate([_two_colors(4), _noise((64, 64, 1), 5)],
                                   -1),
    "gray": lambda: _blob_image([0.2, 0.8], 30, 30)[..., :1],
    "batch": lambda: np.stack([_blob_image([0.1, 0.5, 0.9], 32, 30),
                               _two_colors(6)[:32, :30]]),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("ct,sm", [(1.0, 1.5), (0.5, 1.0), (5.0, 0.0),
                                   (20.0, 3.0)], ids=str)
def test_segment_equals_jax(name, ct, sm):
    x = IMAGES[name]()
    _equal(ts.segment(torch.from_numpy(x), cluster_threshold=ct,
                      smooth_threshold=sm),
           js.segment(jnp.asarray(x), cluster_threshold=ct,
                      smooth_threshold=sm))


@pytest.mark.parametrize("space", ["hsl", "ycbcr", "lab"])
def test_segment_in_another_colorspace_equals_jax(space):
    """Equal clusters; the conversions back from Lab are ``ops/colorspace``'s
    float32 powers, within 1e-7 of XLA's."""
    x = _two_colors(7)
    got = ts.segment(torch.from_numpy(x), space)
    want = np.asarray(js.segment(jnp.asarray(x), space))
    if space == "lab":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    else:
        _equal(got, want)


def test_segment_in_chunks_equals_jax(monkeypatch):
    """(pixel, cluster) chunks of a few pixels: the same assignment."""
    x = _blob_image([0.05, 0.3, 0.5, 0.7, 0.95], 40, 70, 0.03, 8)
    monkeypatch.setattr(ts, "_CELLS", 97)
    _equal(ts.segment(torch.from_numpy(x)), js.segment(jnp.asarray(x)))


def test_number_of_clusters_equals_jax():
    x = _blob_image([0.1, 0.5, 0.9])
    assert ts.number_of_clusters(torch.from_numpy(x)) == \
        js.number_of_clusters(jnp.asarray(x))
