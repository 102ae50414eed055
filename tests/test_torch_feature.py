"""Port parity: ops/feature.py against the JAX package.

Canny is held to equality: with the port's own blur (on the CPU its
float32 sums give the JAX blur's values on these inputs), and from the
JAX blur's output through ``canny_from_smooth`` (so that a blur ulp,
were one to flip a decision, shows as the only cause).  Its thresholds
span the batch, as in the JAX function.  The Hough accumulator is held
image by image (the JAX function raises on a batch) to every vote
counted and at most 1e-4 of them one bin over: its theta table's
cosines are XLA's float32 ones, the port's numpy's rounded to float32,
an ulp apart on 7 of 180 thetas; HoughLineImage's segments are equal (float64
votes, integer counts); mean shift equal; the GLCM counts equal to a
numpy count, and its metrics equal to the JAX ones but for the entropy,
within 1e-6 relative (XLA's float32 log against numpy's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import blur as jb
from imagemagick_tpu.ops import enhance as je
from imagemagick_tpu.ops import feature as jf
from imagemagick_tpu_torch.ops import feature as tf


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _scene(h, w, seed=0):
    """Smooth shapes with hard edges and some noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x = 0.3 + 0.2 * np.sin(yy / 7.0) * np.cos(xx / 9.0)
    x[h // 4:h // 2, w // 5:w // 2] = 0.9
    x[(yy - h * 0.7) ** 2 + (xx - w * 0.7) ** 2 < (h / 6) ** 2] = 0.05
    x = x + 0.02 * rng.standard_normal((h, w))
    return np.clip(np.stack([x, x * 0.8, 1 - x], -1), 0, 1).astype(np.float32)


def _equal(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


CANNY = [((0.0, 1.0), (0.1, 0.3)), ((0.0, 2.0), (0.05, 0.2)),
         ((1.0, 0.5), (0.2, 0.6)), ((0.0, 1.0), (0.1, 0.3, 0))]


@pytest.mark.parametrize("shape", [(40, 56), (2, 40, 56), (33, 20)], ids=str)
@pytest.mark.parametrize("rs,th", CANNY, ids=str)
def test_canny_equals_jax(shape, rs, th):
    x = _scene(*shape[-2:], 1)
    if len(shape) == 3:
        x = np.stack([x, np.clip(x * 0.1, 0, 1)])
    _equal(tf.canny_edge(torch.from_numpy(x), *rs, *th),
           jf.canny_edge(jnp.asarray(x), *rs, *th))


@pytest.mark.parametrize("seed", range(3))
def test_canny_from_the_jax_blur_equals_jax(seed):
    x = _scene(40, 56, seed)
    smooth = np.asarray(jb.blur(je.grayscale(jnp.asarray(x)), 0.0, 1.0))
    got = tf.canny_from_smooth(torch.from_numpy(smooth[..., 0]))
    _equal(got.to(torch.float32)[..., None],
           jf.canny_edge(jnp.asarray(x)))


def test_canny_of_one_channel_and_noise_equals_jax():
    x = _img((30, 40, 1), 2)
    _equal(tf.canny_edge(torch.from_numpy(x)),
           jf.canny_edge(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(24, 32), (40, 56), (64, 48)], ids=str)
@pytest.mark.parametrize("n_theta,n_rho", [(180, 256), (90, 64)])
def test_hough_accumulator_equals_jax(shape, n_theta, n_rho):
    e = (_img(shape + (1,), 3) > 0.6).astype(np.float32)
    _hough_close(tf.hough_accumulator(torch.from_numpy(e), n_theta, n_rho),
                 jf.hough_accumulator(jnp.asarray(e), n_theta, n_rho))


def _hough_close(got, want):
    """Every vote counted; at most 1e-4 of them one bin over (XLA's
    float32 cosine of a theta differs from numpy's rounded one by an ulp,
    and a rho on a bin edge moves)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() / 2 <= 1e-4 * want.sum()


def test_jax_hough_accumulator_raises_on_a_batch():
    """The JAX function stacks the batch's images into one accumulator
    index and raises; the port accumulates each image on its own."""
    e = (_img((2, 24, 32, 1), 4) > 0.6).astype(np.float32)
    with pytest.raises((ValueError, TypeError, IndexError)):
        jf.hough_accumulator(jnp.asarray(e))
    got = tf.hough_accumulator(torch.from_numpy(e))
    assert tuple(got.shape) == (2, 256, 180)
    for i in range(2):
        _hough_close(got[i], jf.hough_accumulator(jnp.asarray(e[i])))


def _lines(h, w, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((h, w, 1), np.float32)
    x[h // 3, :] = 1.0
    x[:, w // 4] = 1.0
    d = np.arange(min(h, w))
    x[d, d] = 1.0
    return np.clip(x + (rng.uniform(0, 1, x.shape) > 0.97), 0, 1) \
        .astype(np.float32)


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (48, 48)], ids=str)
@pytest.mark.parametrize("win,thr", [((5, 5), 10), ((9, 9), 20),
                                     ((3, 7), 0), ((5, 5), 40)], ids=str)
def test_hough_line_segments_equal_jax(hw, win, thr):
    x = _lines(*hw, 5)
    got = tf.hough_line_segments(torch.from_numpy(x), *win, thr)
    want = jf.hough_line_segments(jnp.asarray(x), *win, thr)
    assert got == want
    rgb = np.repeat(x, 3, -1)
    assert tf.hough_line_segments(torch.from_numpy(rgb), *win, thr) == \
        jf.hough_line_segments(jnp.asarray(rgb), *win, thr)


def test_hough_line_segments_of_a_batch_are_each_image_s():
    x = np.stack([_lines(40, 56, 6), _lines(40, 56, 7)])
    got = tf.hough_line_segments(torch.from_numpy(x), 5, 5, 10)
    assert got == [jf.hough_line_segments(jnp.asarray(x[i]), 5, 5, 10)
                   for i in range(2)]


def test_hough_lines_equal_jax():
    x = _lines(40, 56, 8)
    assert tf.hough_lines(torch.from_numpy(x), threshold=10) == \
        jf.hough_lines(jnp.asarray(x), threshold=10)


@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (20, 24, 4), (16, 20, 1)],
                         ids=str)
@pytest.mark.parametrize("args", [(7, 7, 0.1), (5, 5, 0.2), (3, 5, 0.3),
                                  (5, 5, 0.2, 3), (5, 5, 0.2, 40)], ids=str)
def test_mean_shift_equals_jax(shape, args):
    x = _img(shape, 9)
    _equal(tf.mean_shift(torch.from_numpy(x), *args),
           jf.mean_shift(jnp.asarray(x), *args))


def test_mean_shift_of_a_scene_equals_jax():
    x = _scene(40, 48, 10)
    _equal(tf.mean_shift(torch.from_numpy(x), 7, 7, 0.1),
           jf.mean_shift(jnp.asarray(x), 7, 7, 0.1))


@pytest.mark.parametrize("offset", [(0, 1), (1, 0), (2, 3), (1, 1)], ids=str)
@pytest.mark.parametrize("levels", [16, 8])
def test_glcm_counts_are_exact(offset, levels):
    x = _img((2, 20, 24, 3), 11)
    gray = np.asarray(je.grayscale(jnp.asarray(x)))[..., 0]
    q = np.clip((gray * (levels - 1) + 0.5).astype(np.int32), 0, levels - 1)
    dy, dx = offset
    a = q[:, :q.shape[1] - dy, :q.shape[2] - dx].reshape(-1)
    b = q[:, dy:, dx:].reshape(-1)
    want = np.zeros((levels, levels), np.int64)
    np.add.at(want, (a, b), 1)
    got = tf.glcm_counts(torch.from_numpy(x), levels, offset)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("offset", [(0, 1), (1, 0), (2, 3)], ids=str)
def test_glcm_features_equal_jax(seed, offset):
    x = _scene(40, 56, seed) if seed % 2 else _img((2, 30, 20, 3), seed)
    got = tf.glcm_features(torch.from_numpy(x), 16, offset)
    want = jf.glcm_features(jnp.asarray(x), 16, offset)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        if k == "entropy":
            np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-6)
        else:
            assert np.float32(got[k].item()) == np.float32(v), k
