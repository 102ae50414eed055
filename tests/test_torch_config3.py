"""Config #3 (-auto-threshold otsu -> open/close square:1 -> edge 1):
the port's two routes and K5's plain version against the JAX package.

Every stage yields exact 0/1 values, so every comparison is bit for bit.
The JAX K5 runs in interpret mode.  Three faults of the JAX package stay
visible here: its K5 thresholds with ``>=`` where the op chain uses ``>``;
its K5 pads the bottom border once for the tile before a last tile of
fewer than 5 rows; and its benchmark's fused route takes one Otsu value
for the whole batch where ``auto_threshold`` takes one per image."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagemagick_tpu.models import pipelines as jpl
from imagemagick_tpu.ops import pallas_kernels as jpk
from imagemagick_tpu.ops import threshold as jth
import imagemagick_tpu_torch as it
from imagemagick_tpu_torch.models import pipelines as tpl
from imagemagick_tpu_torch.ops import gpu_kernels as gk
from imagemagick_tpu_torch.ops import threshold as tth

BORDERS = (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:])


def _pages(n, h, w, seed):
    """8-bit document-like pages: light paper, dark strokes of 1-3 pixels,
    some of them along every border and through every corner."""
    rng = np.random.default_rng(seed)
    pages = np.full((n, h, w), 232.0)
    for page in pages:
        for _ in range(10):
            r, c = rng.integers(0, h), rng.integers(0, w)
            t = rng.integers(1, 4)
            if rng.random() < 0.5:
                page[r:r + t, c:c + rng.integers(5, w)] = 40.0
            else:
                page[r:r + rng.integers(5, h), c:c + t] = 40.0
        page[0, : w // 2] = page[-1, w // 3:] = 40.0
        page[: h // 2, 0] = page[h // 3:, -1] = 40.0
        page[1:3, -6:] = page[-3:, :5] = 40.0
    pages += rng.normal(0.0, 14.0, pages.shape)
    u8 = np.clip(np.round(pages), 0, 255).astype(np.uint8)
    return (u8[..., None] / 255.0).astype(np.float32)


def _uniform(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_pages_touch_every_border():
    x = _pages(2, 64, 72, 0)[..., 0]
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert (x[sl] < 0.5).any(axis=-1).all()


@pytest.mark.parametrize("shape,seed", [((3, 64, 72), 1), ((2, 45, 33), 2),
                                        ((1, 100, 17), 3)])
def test_k5_plain_matches_jax_op_chain_on_pages(shape, seed):
    x = _pages(*shape, seed)
    t = tth.auto_threshold_values(torch.from_numpy(x), "otsu")
    got = gk.fused_bilevel_morph_edge(torch.from_numpy(x), t).numpy()
    assert got.shape == x.shape
    ref_chain = np.asarray(jpl.document_binarize()(jnp.asarray(x)))
    ref_k5 = np.stack([np.asarray(jpk._morph_edge_reference(
        jnp.asarray(x[n, ..., 0]), float(t[n])))[..., None]
        for n in range(shape[0])])
    for ref in (ref_chain, ref_k5):
        np.testing.assert_array_equal(got, ref)
        for sl in BORDERS:
            np.testing.assert_array_equal(got[sl], ref[sl])
    assert 0.0 < got.mean() < 0.5          # edges found, not all on or off


@pytest.mark.parametrize("shape,thresholds", [
    ((2, 77, 61, 1), (0.6, 0.6)), ((2, 70, 40, 1), (0.35, 0.55)),
    ((1, 40, 96, 1), (0.5,)), ((3, 9, 5, 1), (0.4, 0.5, 0.6)),
])
def test_k5_plain_matches_jax_k5_interpret(shape, thresholds):
    x = _uniform(shape, sum(shape))
    got = gk.fused_bilevel_morph_edge(torch.from_numpy(x),
                                      torch.tensor(thresholds)).numpy()
    for n, t in enumerate(thresholds):
        ref = jpk.fused_bilevel_morph_edge(jnp.asarray(x[n:n + 1]), t, TO=32,
                                           interpret=True)
        np.testing.assert_array_equal(got[n:n + 1], np.asarray(ref))


def test_k5_scalar_threshold_and_layouts():
    x = _uniform((2, 30, 41, 1), 4)
    four = gk.fused_bilevel_morph_edge(torch.from_numpy(x), 0.5)
    three = gk.fused_bilevel_morph_edge(torch.from_numpy(x[..., 0]), 0.5)
    assert four.shape == (2, 30, 41, 1) and three.shape == (2, 30, 41)
    np.testing.assert_array_equal(four[..., 0].numpy(), three.numpy())
    with pytest.raises(ValueError):
        gk.fused_bilevel_morph_edge(torch.zeros((2, 8, 8, 3)), 0.5)
    with pytest.raises(ValueError):
        gk.fused_bilevel_morph_edge(torch.zeros((2, 8, 8)),
                                    torch.tensor([0.1, 0.2, 0.3]))


def test_jax_k5_wrong_when_the_last_tile_is_short():
    """The JAX K5 fixes the bottom border per stage only in the last row
    tile; when that tile holds fewer rows than the 5-row halo, the tile
    before it reads a border padded once.  The port's K5 clamps every
    stage's reads to the image and agrees with the op chain."""
    x = _uniform((1, 33, 96, 1), 130)
    jax_k5 = np.asarray(jpk.fused_bilevel_morph_edge(
        jnp.asarray(x), 0.5, TO=32, interpret=True))
    jax_chain = np.asarray(jpk._morph_edge_reference(
        jnp.asarray(x[..., 0]), 0.5))[..., None]
    assert int((jax_k5 != jax_chain).sum()) > 0
    port = gk.fused_bilevel_morph_edge(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(port, jax_chain)


def test_jax_k5_differs_on_8bit_input():
    """Fault 1 of the JAX package: its K5 thresholds with ``>=``.  On 8-bit
    pixels equal to the Otsu value it disagrees with its own op chain;
    the port's K5 compares with ``>`` and agrees.  (Compiled, the Otsu
    value is bin * float32(1/255), which equals the 8-bit pixel value for
    this image's bin, 128.)"""
    u8 = np.random.default_rng(1).integers(0, 256, (1, 96, 80, 1))
    x = (u8 / 255.0).astype(np.float32)
    t = tth.auto_threshold_values(torch.from_numpy(x), "otsu")
    t0 = float(t[0])
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jax.lax.map(jth.otsu_threshold_value,
                                          jnp.asarray(x))))
    assert int((x == np.float32(t0)).sum()) > 0    # pixels on the threshold
    jax_k5 = np.asarray(jpk.fused_bilevel_morph_edge(
        jnp.asarray(x), t0, TO=32, interpret=True))
    jax_chain = np.asarray(jpk._morph_edge_reference(
        jnp.asarray(x[..., 0]), t0))[..., None]
    port = gk.fused_bilevel_morph_edge(torch.from_numpy(x), t).numpy()
    assert int((jax_k5 != jax_chain).sum()) > 0
    np.testing.assert_array_equal(port, jax_chain)


def test_jax_benchmark_takes_one_otsu_value_per_batch():
    """Fault 2 of the JAX package: ``benchmarks.py``'s fused route
    thresholds the batch at one Otsu value; ``document_binarize`` (and
    both routes of the port) at one per image."""
    x = _pages(2, 48, 40, 5)
    x[1] *= 0.6
    per_image = np.asarray(jax.lax.map(jth.otsu_threshold_value,
                                       jnp.asarray(x)))
    batch = float(jax.jit(jth.otsu_threshold_value)(x))
    assert batch not in per_image.tolist()
    np.testing.assert_array_equal(
        tth.auto_threshold_values(torch.from_numpy(x), "otsu").numpy(),
        per_image)


@pytest.mark.parametrize("kind", ["pages", "uniform", "rgb"])
def test_config3_slice_matches_jax_document_binarize(kind):
    """The whole slice: the op route (``document_binarize``) and the fused
    route (per-image Otsu values into K5) against the JAX pipeline."""
    if kind == "pages":
        x = _pages(3, 56, 64, 6)
    elif kind == "uniform":
        x = _uniform((3, 56, 64, 1), 7)
    else:
        x = _uniform((2, 40, 52, 3), 8)
    before = dict(gk.LAUNCHES)
    ref = np.asarray(jpl.document_binarize()(jnp.asarray(x)))
    batch = torch.from_numpy(x)
    ops = tpl.document_binarize()(batch)
    np.testing.assert_array_equal(ops.numpy(), ref)
    if x.shape[-1] == 1:
        fused = gk.fused_bilevel_morph_edge(
            batch, tth.auto_threshold_values(batch, "otsu"))
        np.testing.assert_array_equal(fused.numpy(), ref)
    # on CPU tensors every wrapper takes its plain version
    assert gk.LAUNCHES == before


def test_pipelines_table():
    assert set(tpl.PIPELINES) == {"thumbnail_gray", "blur_unsharp_lab",
                                  "document_binarize", "fft_wiener"}
    assert set(tpl.PIPELINES) == set(jpl.PIPELINES)
    assert all(tpl.PIPELINES[k] is getattr(tpl, k) for k in tpl.PIPELINES)


def test_image_pixels_go_to_the_requested_device(monkeypatch):
    arr = _uniform((6, 5, 3), 9)
    img = it.Image(arr, device="cpu")
    assert img.data.device.type == "cpu" and img.data.dtype == torch.float32
    np.testing.assert_array_equal(img.to_numpy(), arr)
    t = torch.from_numpy(arr)
    assert it.Image(t).data is t                   # a tensor keeps its device
    u8 = (arr * 255).astype(np.uint8)
    assert it.Image.from_uint8(u8, device="cpu").data.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        it.Image(arr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        it.Image.from_uint8(u8)


@pytest.mark.parametrize("channels", [1, 3])
def test_empty_batch_matches_jax(monkeypatch, channels):
    """An empty batch on the card path gives what the JAX functions give:
    an empty result of the batch's shape, and no threshold at all (the
    JAX package takes the values inside ``auto_threshold``)."""
    from imagemagick_tpu_torch import _build

    def no_library():
        raise AssertionError("an empty batch reached a kernel")

    monkeypatch.setattr(gk, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "load", no_library)
    x = np.zeros((0, 16, 16, channels), np.float32)
    for jfn, tfn in ((lambda a: jth.auto_threshold(a, "otsu"),
                      lambda a: tth.auto_threshold(a, "otsu")),
                     (jpl.document_binarize(), tpl.document_binarize())):
        want = np.asarray(jfn(jnp.asarray(x)))
        got = tfn(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
    assert tuple(tth.auto_threshold_values(torch.from_numpy(x)).shape) == (0,)
