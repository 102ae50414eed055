"""Port parity: ops/shear.py against the JAX package.

``x_shear``, ``y_shear``, ``shear`` and ``deskew`` are held within 1e-5
of the JAX functions but at most 0.1 % of the pixels (a bilinear floor
or an EWA bin moved by an ulp); they come out equal here.  The skew
angles are held to equality: ``deskew_angle_reference`` sums integers
(int64 tensors here, numpy there) and ``deskew_angle`` sums 0/1 values
in float64, exact in any order."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import shear as js
from imagemagick_tpu_torch.ops import distort as td
from imagemagick_tpu_torch.ops import shear as ts

TOL = 1e-5
SELECT_SHARE = 1e-3


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def assert_close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - want).reshape(-1, got.shape[-1])
    n_off = int((d > tol).any(-1).sum())
    assert n_off <= SELECT_SHARE * d.shape[0], (n_off, float(d.max()))


@pytest.mark.parametrize("deg", [20.0, -15.0, 45.0, 0.0])
@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (24, 32, 4)], ids=str)
def test_axis_shears_match_jax(deg, shape):
    x = _img(shape, 1)
    for bg in (None, (0.1, 0.2, 0.3, 1.0)):
        assert_close(ts.x_shear(torch.from_numpy(x), deg, bg),
                     js.x_shear(jnp.asarray(x), deg, bg))
        assert_close(ts.y_shear(torch.from_numpy(x), deg, bg),
                     js.y_shear(jnp.asarray(x), deg, bg))


@pytest.mark.parametrize("xdeg,ydeg", [(20, 10), (-30, 0), (0, 25),
                                       (45, -45), (370, 0), (0, 0)])
@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (24, 32, 1)], ids=str)
def test_shear_matches_jax(xdeg, ydeg, shape):
    x = _img(shape, 2)
    bg = (0.5,) * shape[-1]
    assert_close(ts.shear(torch.from_numpy(x), xdeg, ydeg, bg),
                 js.shear(jnp.asarray(x), xdeg, ydeg, bg))
    assert_close(ts.shear(torch.from_numpy(x), xdeg, ydeg),
                 js.shear(jnp.asarray(x), xdeg, ydeg))


def _page(h, w, c, angle, seed):
    """Lines of dark 'text' on white, rotated by ``angle`` degrees with
    the port's rotate (white background)."""
    rng = np.random.default_rng(seed)
    page = np.ones((h, w, c), np.float32)
    for r in range(8, h - 10, 9):
        x0 = int(rng.integers(5, 25))
        x1 = int(rng.integers(w - 30, w - 5))
        page[r:r + 3, x0:x1] = rng.uniform(0.0, 0.2, (3, x1 - x0, c))
    return td.rotate(torch.from_numpy(page), angle, (1.0,) * c).numpy()


@pytest.mark.parametrize("angle,c,w", [(3.0, 3, 200), (-2.0, 1, 170),
                                       (0.0, 3, 96), (5.0, 4, 130),
                                       (-7.5, 3, 257)])
def test_deskew_angles_equal_jax(angle, c, w):
    page = _page(100, w, c, angle, int(w))
    P, J = torch.from_numpy(page), jnp.asarray(page)
    for thr in (0.4, 0.25):
        assert ts.deskew_angle_reference(P, thr) == \
            js.deskew_angle_reference(J, thr)
    assert ts.deskew_angle(P) == js.deskew_angle(J)
    assert ts.deskew_angle(P, 0.3, 5.0) == js.deskew_angle(J, 0.3, 5.0)


def test_deskew_of_a_blank_page_is_0():
    blank = np.ones((40, 64, 3), np.float32)
    assert ts.deskew_angle_reference(torch.from_numpy(blank)) == \
        js.deskew_angle_reference(jnp.asarray(blank)) == 0.0


@pytest.mark.parametrize("angle,c", [(3.0, 3), (-2.0, 1)])
def test_deskew_matches_jax(angle, c):
    page = _page(80, 120, c, angle, 5)
    for bg in (None, (0.8,) * c):
        assert_close(ts.deskew(torch.from_numpy(page), 0.4, bg),
                     js.deskew(jnp.asarray(page), 0.4, bg))


def test_radon_projection_equals_jax():
    rng = np.random.default_rng(6)
    for rows, width in ((7, 8), (33, 16), (5, 64), (3, 1)):
        mat = rng.integers(0, 9, (rows, width)).astype(np.int64)
        for sign in (-1, 1):
            want = np.zeros(2 * width - 1, np.int64)
            js._radon_projection(mat, sign, want)
            got = torch.zeros(2 * width - 1, dtype=torch.int64)
            ts._radon_projection(torch.from_numpy(mat), sign, got)
            np.testing.assert_array_equal(got.numpy(), want)


def test_projection_variance_equals_jax():
    binary = (_img((30, 150), 7) < 0.3).astype(np.float64)
    for angle in (-10.0, -0.5, 0.0, 3.25, 10.0):
        assert float(ts._projection_variance(torch.from_numpy(binary),
                                             angle)) == \
            js._projection_variance(binary, angle)
    assert math.isclose(0.0, float(ts._projection_variance(
        torch.zeros(4, 9, dtype=torch.float64), 2.0)))
