"""Port parity: imagemagick_tpu_torch.ops.enhance against the JAX package.

The same seeded numpy images go through each JAX function and its port,
on the CPU, in float32.  Tolerances:

* point ops without a transcendental function (negate, brightness-
  contrast, the stretches, the LUTs, enhance's gated mean) and the
  65536-bin histogram ops (exact integer counts, the same bins): 2.5e-7,
  one float32 ulp near 1;
* pow, exp and log (gamma, level, sigmoidal contrast, auto-gamma, the
  sinusoid of contrast, modulate through HSL/HSB/HWB): 1e-6, where torch
  and XLA round the function or a float32 mean in another order;
* through Lab (modulate in LCh, white balance, the Lab round trip of
  clahe and clahe_reference): 2e-5, the JAX package's split-exponent pow
  against torch.pow (``test_torch_colorspace.py``).

CLAHE bins the L channel: where JAX's and the port's L of a pixel fall on
either side of a bin edge (a float32 ulp apart), that tile's LUT differs,
and so does every pixel that blends it.  ``test_clahe_matches`` holds
the two within 2e-5 everywhere else and checks that every larger
difference lies within the blend reach of such a pixel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import colorspace as jcs
from imagemagick_tpu.ops import enhance as jen
from imagemagick_tpu_torch.ops import enhance as ten

EXACT, FUNC, LAB = 2.5e-7, 1e-6, 2e-5


def _img(shape=(21, 26, 3), seed=50):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _both(name, *arrays, **kw):
    ref = np.asarray(getattr(jen, name)(*[jnp.asarray(a) for a in arrays],
                                        **kw))
    got = getattr(ten, name)(*[torch.from_numpy(a) for a in arrays], **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape
    return got, ref


RGB, RGBA, GRAY = _img(), _img((21, 26, 4), 51), _img((21, 26, 1), 52)
# 8-bit levels, so histogram bins hold many pixels
LEVELS = (np.round(_img(seed=53) * 40) / 40).astype(np.float32)

CASES = [
    ("gamma", (RGB,), dict(value=1.7), FUNC),
    ("gamma", (RGB,), dict(value=1.0), EXACT),
    ("level", (RGB,), dict(black_point=0.1, white_point=0.8, gamma_=1.3),
     FUNC),
    ("level", (RGBA,), dict(black_point=0.2, white_point=0.2), EXACT),
    ("levelize", (RGB,), dict(black_point=0.1, white_point=0.8,
                              gamma_=1.3), FUNC),
    ("negate", (RGB,), {}, EXACT),
    ("negate", (LEVELS,), dict(grayscale_only=True), EXACT),
    ("sigmoidal_contrast", (RGB,), dict(contrast=3.0, midpoint=0.5), FUNC),
    ("sigmoidal_contrast", (RGB,), dict(sharpen=False, contrast=5.0,
                                        midpoint=0.3), FUNC),
    ("sigmoidal_contrast", (RGB,), dict(contrast=0.0), EXACT),
    ("brightness_contrast", (RGB,), dict(brightness=10, contrast=-20),
     EXACT),
    ("brightness_contrast", (RGB,), dict(brightness=-10, contrast=30),
     EXACT),
    ("modulate", (RGB,), dict(brightness=90, saturation=120, hue=150),
     FUNC),
    ("modulate", (RGB,), dict(saturation=120, hue=60, colorspace="hsb"),
     FUNC),
    ("modulate", (RGB,), dict(brightness=110, saturation=80,
                              colorspace="hwb"), FUNC),
    ("modulate", (RGB,), dict(brightness=110, saturation=80, hue=130,
                              colorspace="lch"), LAB),
    ("grayscale", (RGB,), dict(method="rec601luminance"), FUNC),
    ("equalize", (RGB,), {}, EXACT),
    ("equalize", (LEVELS,), dict(bins=256), EXACT),
    ("equalize", (np.full((9, 9, 1), 0.5, np.float32),), {}, EXACT),
    ("contrast_stretch", (RGB,), dict(black_point=0.05, white_point=0.1),
     EXACT),
    ("contrast_stretch", (LEVELS,), dict(black_point=0.02), EXACT),
    ("normalize", (RGB,), {}, EXACT),
    ("normalize", (GRAY,), {}, EXACT),
    ("auto_level", (RGB,), {}, EXACT),
    ("auto_level", (RGBA,), dict(per_channel=True), EXACT),
    ("auto_gamma", (RGB,), {}, FUNC),
    ("auto_gamma", (RGBA,), dict(per_channel=True), FUNC),
    ("linear_stretch", (RGB,), dict(black_point=0.02, white_point=0.05),
     EXACT),
    ("linear_stretch", (LEVELS,), {}, EXACT),
    ("clut", (RGB, _img((5, 7, 3), 54)), {}, EXACT),
    ("clut", (RGB, _img((5, 7, 3), 54)), dict(method="integer"), EXACT),
    ("clut", (RGB, _img((5, 7, 3), 54)), dict(method="nearest"), EXACT),
    ("clut", (RGBA, _img((1, 9, 4), 55)), dict(lut_alpha=True,
                                               has_alpha=True), EXACT),
    ("clut", (RGBA, _img((6, 1, 3), 56)), dict(has_alpha=True), EXACT),
    ("hald_clut", (RGBA, _img((8, 8, 3), 57)), {}, EXACT),
    ("color_decision_list", (RGBA,), dict(
        slope=(1.1, 0.9, 1.0), offset=(0.01, 0.0, -0.02),
        power=(1.2, 1.0, 0.8), saturation=0.9), FUNC),
    ("white_balance", (RGB,), {}, LAB),
    ("white_balance", (RGBA,), {}, LAB),
    ("enhance", (RGB,), {}, EXACT),
    ("enhance", (LEVELS,), {}, EXACT),
    ("enhance", (GRAY,), {}, EXACT),
    ("enhance", (RGBA,), {}, EXACT),
    ("contrast", (RGB,), {}, FUNC),
    ("contrast", (RGB,), dict(sharpen=False), FUNC),
    ("contrast", (GRAY,), {}, FUNC),
    ("local_contrast", (_img((40, 520, 3), 58),), dict(radius=10,
                                                        strength=40), FUNC),
    ("local_contrast", (RGB,), {}, FUNC),
]


@pytest.mark.parametrize("name,arrays,kw,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_matches_jax(name, arrays, kw, tol):
    got, ref = _both(name, *arrays, **kw)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_every_public_function_is_ported():
    """gamma through local_contrast: the JAX module's public functions."""
    import inspect

    names = {n for n, f in inspect.getmembers(jen, inspect.isfunction)
             if not n.startswith("_") and f.__module__ == jen.__name__}
    assert len(names) == 23
    assert names <= {n for n in dir(ten) if not n.startswith("_")}
    assert names - {"grayscale"} <= {c[0] for c in CASES} | {
        "clahe", "clahe_reference"}


def _bin_flips(x, bins):
    """Pixels whose L bin differs between JAX's Lab and the port's."""
    from imagemagick_tpu_torch.ops import colorspace as tcs

    lj = np.asarray(jcs.convert(jnp.asarray(x[..., :3]), "srgb", "lab"))
    lt = tcs.convert(torch.from_numpy(x[..., :3]), "srgb", "lab").numpy()
    bj = np.clip((lj[..., 0] * (bins - 1) + 0.5).astype(np.int32), 0,
                 bins - 1)
    bt = np.clip((lt[..., 0] * (bins - 1) + 0.5).astype(np.int32), 0,
                 bins - 1)
    return bj != bt


@pytest.mark.parametrize("shape,kw", [
    ((33, 47, 3), dict(tiles_x=4, tiles_y=3, bins=64, clip_limit=2.5)),
    ((33, 47, 4), {}),
    ((2, 24, 30, 3), dict(tiles_x=3, tiles_y=2, bins=128, clip_limit=0)),
])
def test_clahe_matches(shape, kw):
    x = _img(shape, 59)
    got, ref = _both("clahe", x, **kw)
    bins = kw.get("bins") or 128
    h, w = shape[-3], shape[-2]
    th = -(-h // (kw.get("tiles_y") or 8))
    tw = -(-w // (kw.get("tiles_x") or 8))
    flips = _bin_flips(x, bins)
    # a flipped pixel changes its tile's LUT, which blocks up to a tile
    # and a half away blend
    reach = np.zeros(flips.shape, bool)
    for idx in np.argwhere(flips):
        *lead, y, xx = idx
        reach[tuple(lead)][max(y - 2 * th, 0):y + 2 * th + 1,
                           max(xx - 2 * tw, 0):xx + 2 * tw + 1] = True
    off = np.abs(got - ref).max(-1) > LAB
    assert not np.any(off & ~reach)


@pytest.mark.parametrize("kw", [
    dict(tile_width=8, tile_height=7, bins=128, clip_limit=3.0),
    dict(tile_width=0, tile_height=0, bins=64, clip_limit=2.0),
    dict(tile_width=10, tile_height=10, bins=300, clip_limit=1.0),
])
def test_clahe_reference_matches(kw):
    """The integer pipeline runs on the same float64 numpy on both sides;
    only the Lab round trip of the a and b channels differs."""
    x = _img((37, 45, 4), 60)
    got, ref = _both("clahe_reference", x, **kw)
    np.testing.assert_allclose(got, ref, atol=LAB)


def test_clahe_reference_helpers_are_copies():
    rng = np.random.default_rng(61)
    q = rng.uniform(0, 65535, (5, 7, 3))
    assert np.array_equal(ten._decode_gamma_ref(q / 65535.0),
                          jen._decode_gamma_ref(q / 65535.0))
    assert np.array_equal(ten._srgb_quantum_to_lab_L_exact(q),
                          jen._srgb_quantum_to_lab_L_exact(q))
    hist = rng.integers(0, 40, (6, 32))
    assert np.array_equal(ten._clahe_clip_histograms(hist, 9),
                          jen._clahe_clip_histograms(hist, 9))


def test_histogram_ops_do_not_reach_k4(monkeypatch):
    """65536 and 128 bins: torch.bincount, never kernel K4."""
    from imagemagick_tpu_torch.ops import gpu_kernels

    def no_k4(*a, **k):
        raise AssertionError("K4 reached")

    monkeypatch.setattr(gpu_kernels, "histogram256", no_k4)
    x = torch.from_numpy(RGB)
    for fn in (ten.equalize, ten.normalize, ten.linear_stretch, ten.clahe):
        fn(x)
