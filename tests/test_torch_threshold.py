"""Port parity: the threshold module against the JAX package, bit-exact.

The JAX package finds the auto-threshold bins in float32, the port in
exact integer sums and float64; on these inputs no two bins' scores lie
close enough for that to pick another bin.  The port takes a bin's value
as XLA compiles ``argmax / 255``, so every value, and every pixel of
every thresholded image, is equal.  The ordered dither, the adaptive
(local mean) and the color thresholds are equal too.  The random
threshold's values come from torch's generator, not JAX's PRNG, so it is
held to its definition instead: equal to ``bilevel`` when low == high,
the same output for the same seed, and a count of pixels above within
five standard deviations of its binomial expectation."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagemagick_tpu.ops import threshold as jth
from imagemagick_tpu_torch.ops import threshold as tth

METHODS = ["otsu", "kapur", "triangle"]
KINDS = ["8bit", "document", "bimodal", "uniform"]


def _batch(kind, seed, shape=(3, 41, 37, 1)):
    rng = np.random.default_rng(seed)
    if kind == "8bit":
        x = rng.integers(0, 256, shape) / 255.0
    elif kind == "document":        # mostly white, dark strokes, 8-bit
        x = np.where(rng.random(shape) < 0.8, 0.95, 0.15)
        x = np.round(np.clip(x + rng.normal(0, 0.08, shape), 0, 1) * 255
                     ) / 255.0
    elif kind == "bimodal":         # continuous, two classes per image
        lo = rng.uniform(0.1, 0.4, shape[:1] + (1, 1, 1))
        x = np.where(rng.random(shape) < 0.6, lo, lo + 0.45)
        x = np.clip(x + rng.normal(0, 0.07, shape), 0, 1)
    else:                           # continuous uniform
        x = rng.random(shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("channels", [1, 3])
def test_auto_threshold_values_per_image(method, kind, channels):
    seed = 100 * METHODS.index(method) + 10 * KINDS.index(kind) + channels
    x = _batch(kind, seed, (3, 41, 37, channels))
    fn = getattr(jth, f"{method}_threshold_value")
    ref = np.asarray(jax.lax.map(fn, jnp.asarray(x)))
    got = tth.auto_threshold_values(torch.from_numpy(x), method)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("method", METHODS)
def test_threshold_value_of_one_image(method):
    x = _batch("bimodal", 4)[0]
    jfn = jax.jit(getattr(jth, f"{method}_threshold_value"))
    tfn = getattr(tth, f"{method}_threshold_value")
    got = tfn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(x)))
    assert tth.auto_threshold_values(torch.from_numpy(x), method).shape == ()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["8bit", "document", "bimodal"])
def test_auto_threshold_bit_exact(method, kind):
    x = _batch(kind, 21, (2, 30, 50, 3))
    ref = np.asarray(jth.auto_threshold(jnp.asarray(x), method))
    got = tth.auto_threshold(torch.from_numpy(x), method)
    assert got.shape == (2, 30, 50, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_auto_threshold_is_per_image():
    """A dark and a bright page get their own thresholds, not one value
    from the batch's shared histogram."""
    x = _batch("bimodal", 8, (2, 40, 40, 1))
    x[1] = np.clip(x[1] + 0.3, 0, 1)
    per_image = tth.auto_threshold_values(torch.from_numpy(x), "otsu")
    shared = tth.otsu_threshold_value(torch.from_numpy(x))
    assert float(per_image[0]) != float(per_image[1])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jth.otsu_threshold_value)(x)), shared.numpy())
    for n in range(2):
        np.testing.assert_array_equal(
            per_image[n].numpy(),
            tth.otsu_threshold_value(torch.from_numpy(x[n])).numpy())


def _otsu_bin_f64(hist):
    """Otsu's bin from a float64 between-class variance, first maximum."""
    p = hist / hist.sum()
    omega = np.cumsum(p)
    mu = np.cumsum(p * np.arange(256))
    denom = omega * (1.0 - omega)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = np.where(denom > 1e-12,
                           (mu[-1] * omega - mu) ** 2 / denom, 0.0)
    return int(np.argmax(sigma_b))


def test_otsu_is_the_float64_otsu_first_maximum_on_ties():
    """Histograms with runs of empty bins give runs of equal variances:
    the exact integer sums keep them equal, so the first bin of the run
    wins, as in a float64 Otsu."""
    rng = np.random.default_rng(2)
    hist = np.zeros((6, 256))
    for n in range(6):
        used = rng.choice(256, size=4 + 6 * n, replace=False)
        hist[n, used] = rng.integers(1, 5000, used.size)
    got = tth._otsu(torch.from_numpy(hist.astype(np.float32))).numpy()
    want = [_otsu_bin_f64(h) for h in hist]
    np.testing.assert_array_equal(np.round(got * 255).astype(int), want)
    np.testing.assert_array_equal(
        got, tth._bin_value(torch.tensor(want)).numpy())


def test_bin_value_is_the_compiled_jax_value():
    """Compiled, ``argmax / 255`` is a product with float32(1/255), one
    ulp above j/255 for 126 of the 256 bins; eager JAX divides."""
    idx = np.arange(256, dtype=np.int32)
    compiled = np.asarray(
        jax.jit(lambda i: i.astype(jnp.float32) / 255)(idx))
    got = tth._bin_value(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, compiled)
    divided = idx.astype(np.float32) / np.float32(255)
    assert int((got != divided).sum()) == 126 and bool((got >= divided).all())


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("threshold", [0.5, 128 / 255.0])
def test_bilevel(channels, threshold):
    x = _batch("8bit", channels, (2, 17, 19, channels))
    ref = np.asarray(jth.bilevel(jnp.asarray(x), threshold))
    got = tth.bilevel(torch.from_numpy(x), threshold)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_bilevel_per_image_thresholds():
    x = _batch("8bit", 9, (3, 11, 13, 1))
    t = np.array([0.2, 0.5, 0.8], np.float32)
    got = tth.bilevel(torch.from_numpy(x),
                      torch.from_numpy(t).view(3, 1, 1, 1))
    for n in range(3):
        np.testing.assert_array_equal(
            got[n].numpy(), np.asarray(jth.bilevel(jnp.asarray(x[n]), t[n])))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_point_ops(channels):
    x = _batch("uniform", 30 + channels, (2, 13, 17, channels))
    x[0, 0, :4, 0] = [1e-9, -1e-9, 0.0, -0.2]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jth.black_threshold(jx, 0.4), tth.black_threshold(tx, 0.4)),
        (jth.white_threshold(jx, 0.6), tth.white_threshold(tx, 0.6)),
        (jth.range_threshold(jx, 0.2, 0.4, 0.6, 0.8),
         tth.range_threshold(tx, 0.2, 0.4, 0.6, 0.8)),
        (jth.clamp(jx * 1.4 - 0.2), tth.clamp(tx * 1.4 - 0.2)),
        (jth.perceptible(jx - 0.5, 0.05), tth.perceptible(tx - 0.5, 0.05)),
        (jth.perceptible(jx), tth.perceptible(tx)),
    ]
    for ref, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        tth.auto_threshold(torch.zeros((4, 4, 1)), "no-such-method")


def test_threshold_maps_are_a_copy():
    assert tth._THRESHOLD_MAPS == jth._THRESHOLD_MAPS
    assert tth.threshold_map_names() == jth.threshold_map_names()


@pytest.mark.parametrize("name", jth.threshold_map_names())
def test_ordered_dither_exact(name):
    x = np.random.default_rng(30).uniform(0, 1, (2, 19, 23, 3)).astype(
        np.float32)
    x[0, 0, :4, 0] = [0.0, 1.0, -0.2, 1.3]
    for levels in (2, 3, 7, 1, 0):
        ref = np.asarray(jth.ordered_dither(jnp.asarray(x), name, levels))
        got = tth.ordered_dither(torch.from_numpy(x), name, levels).numpy()
        assert np.array_equal(got, ref), (name, levels)


def test_ordered_dither_unknown_map_raises():
    with pytest.raises(ValueError):
        tth.ordered_dither(torch.zeros(4, 4, 1), "o9x9")


@pytest.mark.parametrize("width,height,bias", [(3, 3, 0.0), (5, 7, 0.02),
                                               (15, 15, -0.05)])
def test_adaptive_threshold_exact(width, height, bias):
    x = _batch("bimodal", 31, (2, 29, 31, 3))
    ref = np.asarray(jth.adaptive_threshold(jnp.asarray(x), width, height,
                                            bias))
    got = tth.adaptive_threshold(torch.from_numpy(x), width, height,
                                 bias).numpy()
    assert np.array_equal(got, ref)


def test_color_threshold_exact():
    x = _batch("uniform", 32, (2, 13, 17, 3))
    for start, stop in (((0.2, 0.1, 0.3), (0.8, 0.9, 0.7)),
                        ((0.5,), (1.0,))):
        ref = np.asarray(jth.color_threshold(jnp.asarray(x), start, stop))
        got = tth.color_threshold(torch.from_numpy(x), start, stop).numpy()
        assert got.shape == x.shape[:-1] + (1,)
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("t", [0.0, 0.3, 128 / 255.0, 1.0])
def test_random_threshold_with_low_equal_high_is_bilevel(t):
    x = _batch("8bit", 33, (2, 17, 19, 1))
    got = tth.random_threshold(torch.from_numpy(x), t, t)
    assert torch.equal(got, tth.bilevel(torch.from_numpy(x), t))


def test_random_threshold_repeats_for_one_seed():
    x = torch.from_numpy(_batch("uniform", 34, (2, 17, 19, 3)))
    a = tth.random_threshold(x, 0.2, 0.8,
                             torch.Generator().manual_seed(5))
    b = tth.random_threshold(x, 0.2, 0.8,
                             torch.Generator().manual_seed(5))
    c = tth.random_threshold(x, 0.2, 0.8,
                             torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # without a generator: a new one seeded with 0, so one run repeats
    assert torch.equal(tth.random_threshold(x, 0.2, 0.8),
                       tth.random_threshold(x, 0.2, 0.8,
                                            torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (0.2, 0.8), (0.45, 0.55)])
def test_random_threshold_fraction_within_binomial_bound(low, high):
    """A pixel of value v goes white with p = clip((v-low)/(high-low),
    0, 1): the count of white values lies within five standard
    deviations of its expectation."""
    x = _batch("uniform", 35, (4, 64, 64, 3)).astype(np.float64)
    got = tth.random_threshold(torch.from_numpy(x.astype(np.float32)), low,
                               high).numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    p = np.clip((x - low) / (high - low), 0.0, 1.0)
    mean, sd = p.sum(), np.sqrt((p * (1 - p)).sum())
    assert abs(got.sum() - mean) <= 5.0 * sd + 1.0
