"""Port parity: imagemagick_tpu_torch.ops.resize against the JAX package.

The filter tables and weight matrices are numpy copies, so they must be
bit-equal; the resample runs in float32 on both sides (atol 1e-5, about
ten float32 roundings of values in [0, 1])."""

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
