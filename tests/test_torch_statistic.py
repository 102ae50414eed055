"""Port parity: imagemagick_tpu_torch.ops.statistic against the JAX package.

Seeded inputs through both packages.  Rank filters select, so the min,
max, median, gradient, non-peak, mode and contrast statistics are held to
1e-6 (a median of an even window averages two selected values, as
``jnp.median`` does); the mean, RMS and standard deviation are float32
sums in other orders (1e-6).  ``evaluate`` is per-pixel math (rtol and
atol 1e-6, NaN and inf where both give them); its noise operators draw
from a torch.Generator, so they are held by their moments and by seed
equality.  Global statistics are float32 reductions in other orders
(rtol 1e-5, skewness and kurtosis 1e-4); moments and the perceptual hash
in float64 on the host as the JAX function computes them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import statistic as js
from imagemagick_tpu_torch.ops import statistic as ts


def _image(shape, seed=0, levels=None):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    return x


# every name ``statistic`` and ``evaluate`` take
STATISTICS = ("mean", "minimum", "min", "maximum", "max", "median",
              "gradient", "rootmeansquare", "rms", "standarddeviation",
              "stddev", "nonpeak", "mode", "contrast")
NOISE_OPERATORS = ("gaussiannoise", "impulsenoise", "uniformnoise",
                   "laplaciannoise", "poissonnoise", "multiplicativenoise")
EVALUATE_OPERATORS = (
    "abs", "add", "sum", "addmodulus", "and", "or", "xor", "cosine", "cos",
    "divide", "exponential", "exp", "leftshift", "rightshift", "log", "max",
    "min", "mean", "median", "multiply", "pow", "rootmeansquare", "rms",
    "sine", "sin", "subtract", "set", "thresholdblack", "thresholdwhite",
    "threshold", "inverselog") + NOISE_OPERATORS
WINDOWS = [(3, 3), (2, 2), (4, 3), (1, 5), (5, 5)]


@pytest.mark.parametrize("stat", STATISTICS)
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_statistic_matches(stat, window):
    """On continuous pixels and on 9-level pixels (ties in every window:
    the mode's first maximum and the non-peak's equal extremes)."""
    for x in (_image((2, 20, 26, 3), 1), _image((2, 20, 26, 3), 2, 8),
              _image((17, 23, 1), 3, 4)):
        ref = np.asarray(js.statistic(jnp.asarray(x), stat, *window))
        got = ts.statistic(torch.from_numpy(x), stat, *window).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=stat)


@pytest.mark.parametrize("vp", ["edge", "mirror", "tile", "black",
                                "white"])
@pytest.mark.parametrize("stat", ["median", "mean", "max", "mode"])
def test_statistic_virtual_pixels_match(stat, vp):
    x = _image((2, 15, 19, 3), 4)
    ref = np.asarray(js.statistic(jnp.asarray(x), stat, 3, 4, vp))
    got = ts.statistic(torch.from_numpy(x), stat, 3, 4, vp).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_even_median_averages_the_middle_pair():
    """A 2x2 window has no middle value: both sides average the second
    and third (torch.median would return the second)."""
    x = _image((6, 7, 1), 5)
    got = ts.statistic(torch.from_numpy(x), "median", 2, 2).numpy()
    ref = np.asarray(js.statistic(jnp.asarray(x), "median", 2, 2))
    np.testing.assert_allclose(got, ref, atol=1e-7)
    stack = ts._window_stack(torch.from_numpy(x), 2, 2)
    assert not torch.equal(torch.from_numpy(got),
                           torch.median(stack, dim=0).values)


def test_mode_counts_without_a_one_hot():
    """The mode of 64 levels, ties to the lowest level, from the window's
    own levels: equal to a one-hot count on a large window of ties."""
    x = _image((2, 9, 11, 2), 6, 5)
    stack = ts._window_stack(torch.from_numpy(x), 5, 5)
    q = (stack * 63 + 0.5).to(torch.int64).clamp(0, 63)
    counts = torch.nn.functional.one_hot(q, 64).sum(0)
    want = torch.argmax(counts, dim=-1).to(torch.float32) / 63.0
    got = ts.statistic(torch.from_numpy(x), "mode", 5, 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [1, 2])
def test_median_filter_matches(radius):
    x = _image((2, 14, 18, 3), 7)
    ref = np.asarray(js.median_filter(jnp.asarray(x), radius))
    got = ts.median_filter(torch.from_numpy(x), radius).numpy()
    assert np.array_equal(got, ref)


VALUES = [0.0, 3.0, 1000.0, 32768.0, -2.5, 2.0, 0.5, 65535.0]


@pytest.mark.parametrize("op", [o for o in EVALUATE_OPERATORS
                                if o not in NOISE_OPERATORS])
def test_evaluate_matches(op):
    x = _image((2, 11, 13, 3), 8)
    x[0, 0, :4, 0] = (0.0, 1.0, 1e-13, 0.5)
    for v in VALUES:
        try:
            ref = np.asarray(js.evaluate(jnp.asarray(x), op, v))
        except OverflowError:
            with pytest.raises(OverflowError):
                ts.evaluate(torch.from_numpy(x), op, v)
            continue
        got = ts.evaluate(torch.from_numpy(x), op, v).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=f"{op} {v}")


def test_evaluate_rejects_unknown_operators():
    x = torch.zeros(2, 2, 1)
    with pytest.raises(ValueError, match="unknown evaluate operator"):
        ts.evaluate(x, "no-such-op", 1.0)


# (operator, value): each noise operator at a value where its noise
# is large against float32 rounding
NOISE = [("gaussiannoise", 0.5), ("uniformnoise", 0.5),
         ("laplaciannoise", 0.5), ("multiplicativenoise", 0.5),
         ("impulsenoise", 4.0), ("poissonnoise", 2.0)]


@pytest.mark.parametrize("op,v", NOISE)
def test_noise_operators_by_moments_and_seed(op, v):
    """The same seed draws the same noise, another seed other noise, no
    generator a generator seeded 0; the JAX and port outputs have the
    same mean and spread about the input (within 5 standard errors).
    The JAX function draws only from its default key: given one, its
    ``key or PRNGKey(0)`` raises (a key is an array of two words)."""
    x = np.full((64, 64, 3), 0.4, np.float32)
    t = torch.from_numpy(x)
    a = ts.evaluate(t, op, v, torch.Generator().manual_seed(1))
    b = ts.evaluate(t, op, v, torch.Generator().manual_seed(1))
    c = ts.evaluate(t, op, v, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ts.evaluate(t, op, v),
                       ts.evaluate(t, op, v, torch.Generator().manual_seed(0)))
    import jax

    with pytest.raises(ValueError, match="truth value"):
        js.evaluate(jnp.asarray(x), op, v, jax.random.PRNGKey(3))
    ref = np.asarray(js.evaluate(jnp.asarray(x), op, v)).astype(np.float64)
    got = a.numpy().astype(np.float64)
    n = got.size
    for stat in (np.mean, lambda d: np.mean((d - 0.4) ** 2)):
        g, r = stat(got), stat(ref)
        se = np.sqrt(np.var(got) / n + np.var(ref) / n) + \
            np.sqrt(np.var((got - 0.4) ** 2) / n + np.var((ref - 0.4) ** 2)
                    / n)
        assert abs(g - r) <= 5 * se + 1e-7, (op, g, r, se)


@pytest.mark.parametrize("op", ["mean", "max", "min", "sum", "add",
                                "median", "multiply", "and", "or", "xor",
                                "rms"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_evaluate_images_matches(op, n):
    """Over stacks of odd and even length (the median of an even stack
    averages its middle pair)."""
    x = _image((n, 6, 7, 3), 9)
    ref = np.asarray(js.evaluate_images(jnp.asarray(x), op))
    got = ts.evaluate_images(torch.from_numpy(x), op).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    with pytest.raises(ValueError):
        ts.evaluate_images(torch.from_numpy(x), "no-such-op")


@pytest.mark.parametrize("func,params", [
    ("polynomial", [3, -2, 0.5, 0.1, 2, 1]), ("polynomial", [0.5]),
    ("polynomial", []), ("sinusoid", [3, 90, 0.4, 0.5]),
    ("sinusoid", [2]), ("arcsin", [1, 0.5, 1, 0.5]), ("arcsin", [0.5]),
    ("arctan", [5, 0.5, 1, 0.5]), ("arctan", [])])
def test_function_matches(func, params):
    x = _image((2, 11, 13, 3), 10)
    ref = np.asarray(js.function(jnp.asarray(x), func, params))
    got = ts.function(torch.from_numpy(x), func, params).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_polynomial_images_matches():
    xs = [_image((9, 10, 3), s) for s in (11, 12, 13)]
    for terms in ([(0.5, 2), (0.3, 1.5), (0.2, 3)], [(1.0, 0.5)],
                  [(2.0, -1), (-0.5, 2.0)]):
        ref = np.asarray(js.polynomial_images(
            [jnp.asarray(x) for x in xs], terms))
        got = ts.polynomial_images([torch.from_numpy(x) for x in xs],
                                   terms).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(20, 26, 3), (2, 20, 26, 3), (15, 9, 1)])
def test_get_statistics_matches(shape):
    x = _image(shape, 14)
    x[..., :5, :5, 0] = 0.25                # a flat patch
    ref = js.get_statistics(jnp.asarray(x))
    got = ts.get_statistics(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        tol = 1e-4 if k in ("skewness", "kurtosis") else 1e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    flat = np.full((6, 7, 2), 0.5, np.float32)
    got = ts.get_statistics(torch.from_numpy(flat))
    assert float(got["skewness"].abs().max()) == 0.0
    assert float(got["kurtosis"].abs().max()) == 0.0


@pytest.mark.parametrize("shape", [(20, 26, 3), (2, 20, 26, 3)])
def test_get_moments_matches(shape):
    x = _image(shape, 15)
    ref = js.get_moments(jnp.asarray(x))
    got = ts.get_moments(torch.from_numpy(x))
    scale = np.abs(np.asarray(ref["invariants"])).max()
    np.testing.assert_allclose(got["invariants"].numpy(),
                               np.asarray(ref["invariants"]),
                               atol=1e-5 * scale)
    for g, r in zip(got["centroid"], ref["centroid"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)
    np.testing.assert_allclose(got["m00"].numpy(), np.asarray(ref["m00"]),
                               rtol=1e-5)
    ref64 = js.get_moments(x.astype(np.float64), xp=np)
    got64 = ts.get_moments(x.astype(np.float64), xp=np)
    assert np.array_equal(got64["invariants"], ref64["invariants"])


def test_perceptual_hash_matches():
    a, b = _image((20, 26, 3), 16), _image((20, 26, 3), 17)
    ref = np.asarray(js.perceptual_hash(jnp.asarray(a)))
    got = ts.perceptual_hash(torch.from_numpy(a))
    assert got.shape == (2, 8, 3) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    # the float32 sum of 48 squared differences, in another order
    np.testing.assert_allclose(
        float(ts.phash_distance(torch.from_numpy(a), torch.from_numpy(b))),
        float(js.phash_distance(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
