"""Port parity: the histogram module and K4's plain version against the
JAX package, exact (counts are integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import histogram as jh
from imagemagick_tpu.ops.pallas_kernels import pallas_histogram256
from imagemagick_tpu_torch.ops import gpu_kernels as gk
from imagemagick_tpu_torch.ops import histogram as th


def _hdri_vector():
    """The JAX K4 test's 5*256*512 + 333 values (a tail past the last
    program) with out-of-range values, huge values and NaN mixed in."""
    rng = np.random.default_rng(9)
    vals = rng.random(5 * 256 * 512 + 333).astype(np.float32)
    vals[::97] = -0.25
    vals[1::101] = 1.75
    vals[2::103] = 1e9
    vals[3::107] = -1e9
    vals[4::109] = np.nan
    return vals


def test_k4_plain_matches_jax_pallas_interpret():
    vals = _hdri_vector()
    ref = np.asarray(pallas_histogram256(jnp.asarray(vals), interpret=True))
    got = gk.histogram256(torch.from_numpy(vals)[None])
    assert got.shape == (1, 256) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_k4_plain_matches_jax_histogram_off_pallas():
    vals = _hdri_vector()
    ref = np.asarray(jh._histogram_fixed(jnp.asarray(vals), 256))
    np.testing.assert_array_equal(gk.histogram256_plain(
        torch.from_numpy(vals)[None])[0].numpy(), ref)
    np.testing.assert_array_equal(
        th._histogram_fixed(torch.from_numpy(vals), 256).numpy(), ref)


def test_k4_plain_rows_are_independent():
    rng = np.random.default_rng(3)
    rows = rng.random((4, 3001)).astype(np.float32)
    rows[1] = np.round(rows[1] * 255) / 255        # on the bin centres
    rows[2] = (np.arange(3001) % 256 + 0.5) / 255   # on the bin edges
    rows[3] = 1.0
    got = gk.histogram256_plain(torch.from_numpy(rows)).numpy()
    for r in range(4):
        ref = np.asarray(jh._histogram_fixed(jnp.asarray(rows[r]), 256))
        np.testing.assert_array_equal(got[r], ref)
    assert got.sum(axis=1).tolist() == [3001.0] * 4


@pytest.mark.parametrize("bins", [3, 16, 64, 100, 256, 1024])
def test_histogram_fixed_bins(bins):
    rng = np.random.default_rng(bins)
    vals = rng.uniform(-0.1, 1.1, (37, 41)).astype(np.float32)
    ref = np.asarray(jh._histogram_fixed(jnp.asarray(vals), bins))
    got = th._histogram_fixed(torch.from_numpy(vals), bins)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_histogram_fixed_batched():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 256, (6, 999)).astype(np.int32)
    ref = np.asarray(jh._histogram_fixed_batched(jnp.asarray(idx), 256))
    got = th._histogram_fixed_batched(torch.from_numpy(idx), 256)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_channel_histogram(channels):
    rng = np.random.default_rng(channels)
    img = rng.random((33, 47, channels)).astype(np.float32)
    for bins in (256, 64):
        ref = np.asarray(jh.channel_histogram(jnp.asarray(img), bins))
        got = th.channel_histogram(torch.from_numpy(img), bins).numpy()
        assert got.shape == (bins, channels)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels,bits", [(1, 8), (3, 8), (4, 8), (3, 4),
                                           (4, 16)])
def test_number_colors(channels, bits):
    rng = np.random.default_rng(7)
    img = (rng.integers(0, 6, (20, 30, channels)) / 5.0).astype(np.float32)
    img[0, 0], img[0, 1], img[0, 2] = -0.5, 1.5, np.nan   # clip to 0 / top
    ref = int(jh.number_colors(jnp.asarray(img), bits))
    got = th.number_colors(torch.from_numpy(img), bits)
    assert int(got) == ref
    assert th.is_palette_image(torch.from_numpy(img)) == \
        jh.is_palette_image(jnp.asarray(img))


def test_pack_colors_wraps_like_uint32():
    rng = np.random.default_rng(8)
    img = rng.uniform(-0.2, 1.2, (9, 11, 4)).astype(np.float32)
    ref = np.asarray(jh._pack_colors(jnp.asarray(img), 16)).astype(np.int64)
    got = th._pack_colors(torch.from_numpy(img), 16).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_unique_colors_and_get_histogram(channels):
    rng = np.random.default_rng(11)
    img = (rng.integers(0, 4, (12, 13, channels)) * 85 / 255.0
           ).astype(np.float32)
    jc, jn = jh.unique_colors(jnp.asarray(img))
    tc, tn = th.unique_colors(torch.from_numpy(img))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    assert th.get_histogram(torch.from_numpy(img), 7) == \
        jh.get_histogram(jnp.asarray(img), 7)


@pytest.mark.parametrize("channels", [1, 3])
def test_histogram_image(channels):
    rng = np.random.default_rng(12)
    img = rng.random((25, 31, channels)).astype(np.float32)
    ref = np.asarray(jh.histogram_image(jnp.asarray(img), 50, 64))
    got = th.histogram_image(torch.from_numpy(img), 50, 64).numpy()
    np.testing.assert_array_equal(got, ref)
