"""Port parity: ops/distort.py's ``distort`` methods against the JAX
package, each with bestfit off and on, on 2 x 48x64 images.

Bound: every output value within 1e-5 of the JAX one, except at pixels
where a selection differs between the packages (an EWA bin, a scan
bound's ceil or floor, a bilinear floor moved by an ulp of a
transcendental): those are counted and must be at most 0.1 % of the
pixels.  The host geometry (control-point fits, per-pixel ellipses,
the polar family's maps) is the JAX module's float64 numpy code; the
per-pixel EWA sums a bucket's taps in blocks, in another order than the
JAX loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import distort as jd
from imagemagick_tpu_torch.ops import distort as td

TOL = 1e-5
SELECT_SHARE = 1e-3


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def assert_close(got, want, tol=TOL):
    """Within ``tol`` but for at most 0.1 % of the pixels."""
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - want)
    px = d.reshape(-1, d.shape[-1])
    n_off = int((px > tol).any(-1).sum())
    assert n_off <= SELECT_SHARE * px.shape[0], (n_off, float(d.max()))


QUAD = [0, 0, 3, 2, 63, 0, 60, 5, 0, 47, 2, 44, 63, 47, 58, 40]
METHODS = [
    ("srt", [30]), ("srt", [0.8, 20]), ("srt", [20, 15, 25]),
    ("srt", [20, 15, 1.2, 25]), ("srt", [20, 15, 1.2, 0.9, 25]),
    ("srt", [20, 15, 1.1, -10, 30, 20]),
    ("srt", [20, 15, 1.1, 0.9, -10, 30, 20]),
    ("affine", [0, 0, 2, 3, 60, 0, 55, 5, 0, 40, 4, 38]),
    ("perspective", QUAD),
    ("perspective", [0, 0, 10, 20, 63, 0, 50, 20, 0, 47, 0, 47,
                     63, 47, 63, 47]),
    ("affineprojection", [0.9, 0.1, -0.1, 0.9, 3, 2]),
    ("perspectiveprojection", [1.0, 0.1, 2, 0.05, 1.0, 1, 0.001, 0.002]),
    ("rigidaffine", [0, 0, 2, 3, 60, 0, 58, 8, 0, 40, -3, 38]),
    ("bilinearforward", QUAD), ("bilinear", QUAD),
    ("bilinearreverse", QUAD),
    ("polynomial", [2] + QUAD + [30, 20, 32, 21, 10, 30, 12, 33]),
    ("shepards", [10, 10, 12, 13, 40, 30, 38, 28]),
    ("resize", [32, 24]), ("arc", [60]), ("arc", [90, 45, 30, 8]),
    ("polar", [20]), ("polar", [30, 5, 30, 20, -90, 90]),
    ("depolar", [20]), ("depolar", [-1]), ("barrel", [0.05, 0.0, 0.0]),
    ("barrel", [0.1, -0.05, 0.02, 0.93, 30, 20]),
    ("barrelinverse", [0.05, 0.0, 0.0]), ("cylinder2plane", [60]),
    ("plane2cylinder", [60]),
]


@pytest.mark.parametrize("bestfit", [False, True])
@pytest.mark.parametrize("method,args", METHODS,
                         ids=[f"{m}{a[:3]}" for m, a in METHODS])
def test_distort_matches_jax(method, args, bestfit):
    x = _img((2, 48, 64, 3))
    assert_close(td.distort(torch.from_numpy(x), method, args,
                            bestfit=bestfit),
                 jd.distort(jnp.asarray(x), method, args, bestfit=bestfit))


@pytest.mark.parametrize("method,args,sampler", [
    ("srt", [20], "bilinear"), ("affine", METHODS[7][1], "bilinear"),
    ("perspective", QUAD, "bilinear"), ("polynomial", METHODS[16][1], "ewa"),
    ("polynomial", [1.5] + QUAD, "bilinear")])
def test_distort_samplers_match_jax(method, args, sampler):
    x = _img((2, 48, 64, 3), 1)
    for bestfit in (False, True):
        assert_close(td.distort(torch.from_numpy(x), method, args,
                                sampler=sampler, bestfit=bestfit),
                     jd.distort(jnp.asarray(x), method, args,
                                sampler=sampler, bestfit=bestfit))


def test_singular_affine_raises_as_in_jax():
    x = torch.zeros(4, 4, 3)
    with pytest.raises(ValueError, match="singular"):
        td.affine_transform(x, (1, 2, 2, 4, 0, 0))
    with pytest.raises(ValueError, match="singular"):
        jd.affine_transform(jnp.zeros((4, 4, 3)), (1, 2, 2, 4, 0, 0))


@pytest.mark.parametrize("method,args", [
    ("arc", [0]), ("polar", [1, 2, 3]), ("polar", [-5]),
    ("barrel", [0.1, 0.2]), ("cylinder2plane", [170]), ("nosuch", [])])
def test_bad_arguments_raise_as_in_jax(method, args):
    x = np.zeros((8, 10, 3), np.float32)
    with pytest.raises(ValueError):
        jd.distort(jnp.asarray(x), method, args)
    with pytest.raises(ValueError):
        td.distort(torch.from_numpy(x), method, args)
