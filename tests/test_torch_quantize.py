"""Port parity: ops/quantize.py against the JAX module.

Tolerances: ``posterize`` (every dither), ``remap``, ``_hilbert_order``,
``ordered_posterize``, ``unique_colors_count``, ``compress_colormap`` and
``kmeans_reference``'s host path are equal bit for bit (the native
library is the same source built with the same flags; the rest is
elementwise or float64 numpy copied).  ``kmeans`` sums its clusters in
float64 where the JAX function sums them by a float32 matmul: palettes
within 1e-5, labels apart counted and at most 0.1 % of the pixels.  The seeds equal the JAX function's: the indices of
``jnp.linspace`` at 96x128, 512x768, 1080x1920 and 8 x 1080x1920 pixels,
and the sorted order and the seed colours at 96x128 and 1080x1920.
Inputs come from a numpy seed, at most 96x128 in batches of 2, but the
seed indices and one 1088x1024 frame for ``kmeans_reference``'s device
path."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch import native as tn
from imagemagick_tpu_torch.ops import channel as tc
from imagemagick_tpu_torch.ops import quantize as tq

jq = importlib.import_module("imagemagick_tpu.ops.quantize")


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _smooth(shape, seed=0):
    """Gradients with texture: clusters that k-means can find."""
    rng = np.random.default_rng(seed)
    h, w, c = shape[-3:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 9.0)[..., None] * np.cos(
        xx[..., None] / 13.0 + np.arange(c))
    img = base + 0.03 * rng.standard_normal(shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dither", [False, True, "riemersma", "fs",
                                    "floydsteinberg", "ordered"])
@pytest.mark.parametrize("levels", [2, 4, 8])
@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (96, 128, 3),
                                   (48, 64, 1), (40, 56, 4)], ids=str)
def test_posterize_equals_jax(dither, levels, shape):
    x = _img(shape, levels)
    _eq(tq.posterize(torch.from_numpy(x), levels, dither),
        jq.posterize(jnp.asarray(x), levels, dither))


@pytest.mark.parametrize("levels,shape", [(1, (24, 32, 3)),
                                          (4, (24, 32, 5))])
def test_posterize_rounds_what_the_walks_refuse(levels, shape):
    """One level or five channels: the native walks refuse them, and
    both packages round."""
    x = _img(shape, 3)
    _eq(tq.posterize(torch.from_numpy(x), levels, True),
        jq.posterize(jnp.asarray(x), levels, True))


@pytest.mark.parametrize("n", [96 * 128, 512 * 768, 1080 * 1920,
                               8 * 1080 * 1920])
@pytest.mark.parametrize("k", [16, 64, 256])
def test_seed_indices_equal_jax_linspace(n, k):
    got = tq._seed_indices(n, k)
    want = np.asarray(jnp.linspace(0, n - 1, k).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)
    # torch.linspace rounds otherwise at these sizes
    if k > 16 and n > 96 * 128:
        lin = torch.linspace(0, n - 1, k).to(torch.int64).numpy()
        assert not np.array_equal(lin, want)


@pytest.mark.parametrize("shape,k", [((96, 128, 3), 16),
                                     ((1080, 1920, 3), 64)])
def test_seed_colors_equal_jax(shape, k):
    """The stable argsort of the channel mean and the seed colours it
    picks: checkers and flat regions tie on luma."""
    x = np.round(_img(shape, 4) * 16) / 16
    x[: shape[0] // 2, : shape[1] // 3] = 0.5
    x = x.astype(np.float32)
    flat = x.reshape(-1, 3)
    order = torch.argsort(tc.channel_mean(torch.from_numpy(flat)),
                          stable=True).numpy()
    jorder = np.asarray(jnp.argsort(jnp.mean(jnp.asarray(flat), axis=-1)))
    np.testing.assert_array_equal(order, jorder)
    take = tq._seed_indices(flat.shape[0], k)
    np.testing.assert_array_equal(flat[order[take]], flat[jorder[take]])


def _labels_apart(got, want) -> int:
    return int((np.asarray(got) != np.asarray(want)).sum())


@pytest.mark.parametrize("k,iters", [(4, 10), (8, 20), (16, 20), (3, 0)])
@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (96, 128, 3),
                                   (48, 64, 1)], ids=str)
def test_kmeans_matches_jax(k, iters, shape):
    x = _smooth(shape, k)
    pal, lab = tq.kmeans(torch.from_numpy(x), k, iters)
    jpal, jlab = jq.kmeans(jnp.asarray(x), k, iters)
    np.testing.assert_allclose(pal.numpy(), np.asarray(jpal), atol=1e-5)
    assert tuple(lab.shape) == shape[:-1]
    assert _labels_apart(lab, jlab) <= 1e-3 * lab.numel()
    got = tq.kmeans_quantize(torch.from_numpy(x), k, iters)
    want = np.asarray(jq.kmeans_quantize(jnp.asarray(x), k, iters))
    assert ((np.abs(got.numpy() - want) > 1e-5).any(-1)).mean() <= 1e-3


def test_kmeans_palette_as_the_jax_test_checks_it(checker_rgb):
    """tests/test_analysis_ops.py's case: 4 colours, 10 iterations."""
    pal, labels = tq.kmeans(torch.from_numpy(checker_rgb), 4, max_iters=10)
    assert tuple(pal.shape) == (4, 3)
    out = pal.numpy()[labels.numpy()]
    assert np.mean(np.abs(out - checker_rgb)) < 0.15


@pytest.mark.parametrize("k,iters,tol", [(4, 300, 1e-4), (8, 300, 1e-4),
                                         (16, 5, 1e-4), (8, 300, 10.0)])
@pytest.mark.parametrize("shape", [(96, 128, 3), (48, 64, 4), (48, 64, 1)],
                         ids=str)
def test_kmeans_reference_host_path_equals_jax(k, iters, tol, shape):
    x = _smooth(shape, 5)
    stats = {}
    got = tq.kmeans_reference(torch.from_numpy(x), k, iters, tol,
                              stats=stats)
    _eq(got, jq.kmeans_reference(jnp.asarray(x), k, iters, tol))
    assert stats["route"] == "host" and 1 <= stats["iterations"] <= iters


def test_kmeans_reference_seed_palette_equals_jax():
    x = _smooth((48, 64, 3), 6)
    seed = _img((5, 3), 7)
    _eq(tq.kmeans_reference(torch.from_numpy(x), 5, seed_palette=seed),
        jq.kmeans_reference(jnp.asarray(x), 5, seed_palette=seed))


def test_kmeans_reference_device_path_matches_jax():
    """Above 1 << 20 pixels both iterate on the device: the JAX function
    by float32 matmuls, the port elementwise with float64 sums.  The
    pixels apart are counted: at most 0.1 %."""
    x = _smooth((1088, 1024, 3), 8)
    stats = {}
    got = tq.kmeans_reference(torch.from_numpy(x), 4, 6, stats=stats)
    want = np.asarray(jq.kmeans_reference(jnp.asarray(x), 4, 6))
    assert stats["route"] == "device"
    apart = (np.abs(got.numpy() - want) > 1e-5).any(-1)
    assert apart.mean() <= 1e-3, apart.sum()
    np.testing.assert_allclose(got.numpy()[~apart], want[~apart], atol=1e-5)


def test_kmeans_device_and_host_iterations_agree():
    """The device iteration, run here on a small frame, reaches the host
    path's labels and centres (float64 there, float32 distances here);
    a near-tie may settle one iteration apart."""
    x = _smooth((48, 64, 3), 9).reshape(-1, 3)
    seed = x[[0, 500, 1500, 3000]].astype(np.float64)
    hc, hl, hit = tq._kmeans_host(x.astype(np.float64), seed, 300, 1e-4)
    dc, dl, dit = tq._kmeans_device(torch.from_numpy(x),
                                    torch.from_numpy(seed).float(), 300,
                                    1e-4)
    assert abs(hit - dit) <= 1
    assert _labels_apart(dl, hl) <= 1e-3 * len(hl)
    np.testing.assert_allclose(dc.numpy(), hc, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_remap_equals_jax(channels):
    x = _img((2, 40, 56, channels), 10)
    pal = _img((7, channels), 11)
    _eq(tq.remap(torch.from_numpy(x), torch.from_numpy(pal)),
        jq.remap(jnp.asarray(x), jnp.asarray(pal)))


def test_remap_with_dither_raises_naming_its_entry():
    """Once a gap, now the JAX function: remap under a dither is the
    Floyd-Steinberg walk (more cases in test_torch_palette_walk.py)."""
    x = _img((4, 4, 3), 12)
    pal = _img((2, 3), 13)
    _eq(tq.remap(torch.from_numpy(x), torch.from_numpy(pal), dither=True),
        jq.remap(jnp.asarray(x), jnp.asarray(pal), dither=True))


@pytest.mark.parametrize("order", [0, 1, 2, 3, 5])
def test_hilbert_order_equals_jax(order):
    np.testing.assert_array_equal(tq._hilbert_order(order),
                                  jq._hilbert_order(order))


@pytest.mark.parametrize("levels,map_name", [(2, "o8x8"), (4, "o4x4"),
                                             (3, "h6x6a")])
def test_ordered_posterize_equals_jax(levels, map_name):
    x = _img((2, 40, 56, 3), 12)
    _eq(tq.ordered_posterize(torch.from_numpy(x), levels, map_name),
        jq.ordered_posterize(jnp.asarray(x), levels, map_name))


@pytest.mark.parametrize("shape,q,bits", [
    ((2, 48, 64, 3), None, 8), ((96, 128, 3), 4, 8), ((48, 64, 1), 8, 8),
    ((48, 64, 4), 3, 8), ((96, 128, 3), None, 5), ((8, 8, 3), 1, 8)],
    ids=str)
def test_unique_colors_count_equals_jax(shape, q, bits):
    x = _img(shape, 13)
    if q is not None:
        x = (np.round(x * q) / q).astype(np.float32)
    got = tq.unique_colors_count(torch.from_numpy(x), bits)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(jq.unique_colors_count(jnp.asarray(x), bits))


def test_compress_colormap_equals_jax():
    pal = _img((9, 3), 14)
    lab = np.array([[0, 4, 4], [8, 0, 2]], np.int32)
    p, l = tq.compress_colormap(torch.from_numpy(pal), torch.from_numpy(lab))
    jp, jl = jq.compress_colormap(jnp.asarray(pal), jnp.asarray(lab))
    _eq(p, jp)
    _eq(l, jl)


def test_a_failed_library_raises_instead_of_rounding(monkeypatch):
    """The JAX function rounds when its library is missing; the port's
    library must build, and a dithered posterize raises without it."""
    lib = tn._Library("riemersma", "riemersma.cpp", ("false",), (),
                      tn._bind_riemersma)
    monkeypatch.setattr(tn, "_RIEMERSMA", lib)
    monkeypatch.setattr(tn, "_OUT", tn._OUT)
    with pytest.raises(RuntimeError, match="riemersma.cpp did not build"):
        tq.posterize(torch.from_numpy(_img((8, 8, 3))), 4, True)
    assert tq.posterize(torch.from_numpy(_img((8, 8, 3))), 4, False) \
        .shape == (8, 8, 3)


def test_kmeans_reference_seeds_a_batch_as_one_tall_frame():
    """The octree library takes one frame: the JAX function hands it the
    4-D batch, which it refuses, and silently seeds from ``kmeans``
    instead; the port seeds a batch as one tall frame, so a batch gives
    the tall frame's result."""
    x = _smooth((2, 48, 64, 3), 12)
    tall = x.reshape(96, 64, 3)
    got = tq.kmeans_reference(torch.from_numpy(x), 6)
    want = tq.kmeans_reference(torch.from_numpy(tall), 6)
    np.testing.assert_array_equal(got.numpy().reshape(96, 64, 3),
                                  want.numpy())
    jgot = np.asarray(jq.kmeans_reference(jnp.asarray(x), 6))
    jtall = np.asarray(jq.kmeans_reference(jnp.asarray(tall), 6))
    np.testing.assert_array_equal(want.numpy(), jtall)
    assert not np.array_equal(jgot.reshape(96, 64, 3), jtall)
