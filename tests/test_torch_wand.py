"""Port parity: the MagickWand API (``wand/api.py``) against the JAX wand.

Each case builds a JAX wand and a port wand (``device="cpu"``) over the
same numpy image made from a seed, calls one method with the same
arguments on both, and compares what comes back and the images the wands
then hold: shapes, colorspace and alpha, and pixels within the bound of
the op's own parity test, stated per case (``torch_wand_pairs``: EXACT,
FUNC, LAB, RESAMPLE).  The tagged methods (``resize_image``,
``blur_image``, ``gaussian_blur_image``) take the fused route in the
port, K1's plain version on a CPU tensor, where the JAX wand's dispatch
declines on the CPU and runs the op: FUSED holds the two routes at >= 60
dB (as ``tests/test_torch_cli.py`` does), and a spy on
``dispatch.COUNTS`` shows that the fused route ran.

Methods that draw random numbers (noise, spread, random threshold,
sketch) take the JAX key in the JAX wand and a torch generator in the
port's, so their images are held by shape and by the size of the change
they make.  The spectra of ``forward_fourier_transform_image`` are held as
``tests/test_torch_fourier.py`` holds them: through the complex value that
magnitude and phase encode, within 1e-5 of max|F|.
"""

import inspect
import io as _io
import re

import numpy as np
import pytest
import torch

from imagemagick_tpu.wand import api as ja
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.ops import dispatch as tdsp
from imagemagick_tpu_torch.wand import api as ta

from torch_wand_pairs import (EXACT, FUNC, FUSED, LAB, RESAMPLE, SPEC_REL,
                              _arrays, _assert_same, _db, _img, _pair, _side)


A = _img()
POINTS = [(5, 5, (1.0, 0.0, 0.0, 1.0)), (50, 10, (0.0, 1.0, 0.0, 1.0)),
          (20, 40, (0.0, 0.0, 1.0, 0.5))]

# (method, arguments, bound): every operator method of the JAX wand that
# takes no other wand, with the arguments of tests/test_wand.py and
# tests/test_wandtest.py and a few more
OPS = [
    ("resize_image", (40, 30), FUSED),
    ("resize_image", (40, 30, "lanczos"), FUSED),
    ("resize_image", (100, 80), RESAMPLE),   # dispatch takes no upscale
    ("resize_image", (40, 30, "undefined", 1.5), RESAMPLE),
    ("adaptive_resize_image", (38, 28), FUSED),
    ("scale_image", (36, 26), EXACT),
    ("sample_image", (34, 24), EXACT),
    ("thumbnail_image", (32, 22), RESAMPLE),
    ("magnify_image", (), EXACT),
    ("minify_image", (), EXACT),
    ("transform_image", ("60x44+2+2", "30x22"), FUSED),
    ("transform_image", ("20x16+2+2", "30x20"), RESAMPLE),
    ("liquid_rescale_image", (50, 40), RESAMPLE),
    ("sparse_color_image", ("shepards", POINTS), RESAMPLE),
    ("crop_image", (20, 16, 2, 2), EXACT),
    ("crop_image_geometry", ("20x16+3+1",), EXACT),
    ("chop_image", (2, 2, 0, 0), EXACT),
    ("extent_image", (80, 60, -5, -6), EXACT),
    ("flip_image", (), EXACT),
    ("flop_image", (), EXACT),
    ("roll_image", (5, 3), EXACT),
    ("shave_image", (2, 3), EXACT),
    ("splice_image", (2, 2, 1, 1), EXACT),
    ("trim_image", (0.0,), EXACT),
    ("transpose_image", (), EXACT),
    ("transverse_image", (), EXACT),
    ("rotate_image", ("white", 5.0), RESAMPLE),
    ("rotate_image", ("red", 90.0), EXACT),
    ("auto_orient_image", (), EXACT),
    ("shear_image", ("white", 10.0, 5.0), RESAMPLE),
    ("deskew_image", (0.4,), RESAMPLE),
    ("distort_image", ("srt", [0.9, 10]), RESAMPLE),
    ("distort_image", ("srt", [0.9, 10], True), RESAMPLE),
    ("affine_transform_image", ([1, 0.1, 0, 1, 2, 3],), RESAMPLE),
    ("blur_image", (0.0, 0.6), FUSED),
    ("blur_image", (0.0, 1.5), FUSED),
    ("blur_image", (0.0, 0.0), EXACT),
    ("gaussian_blur_image", (0.0, 1.5), FUSED),
    ("gaussian_blur_image", (0.0, 0.6), FUSED),
    ("adaptive_blur_image", (0.0, 0.6), EXACT),
    ("adaptive_sharpen_image", (0.0, 0.6), EXACT),
    ("sharpen_image", (0.0, 0.6), EXACT),
    ("unsharp_mask_image", (0.0, 1.0, 1.0, 0.0), EXACT),
    ("unsharp_mask_image", (0.0, 0.6, 1.0, 0.02), EXACT),
    ("motion_blur_image", (0.0, 0.6, 10.0), EXACT),
    ("rotational_blur_image", (2.0,), EXACT),
    ("selective_blur_image", (0.0, 1.0, 0.1), EXACT),
    ("bilateral_blur_image", (5, 5, 0.75), EXACT),
    ("kuwahara_image", (1.0, 0.5), EXACT),
    ("despeckle_image", (), EXACT),
    ("edge_image", (1.0,), EXACT),
    ("emboss_image", (0.0, 0.6), EXACT),
    ("shade_image", (True, 30.0, 30.0), RESAMPLE),
    ("convolve_image", ([[0, 1, 0], [1, -4, 1], [0, 1, 0]],), EXACT),
    ("morphology_image", ("dilate", 1, "square:1"), EXACT),
    ("morphology_image", ("close", 2, "diamond"), EXACT),
    ("statistic_image", ("median", 3, 3), EXACT),
    ("local_contrast_image", (3.0, 12.5), EXACT),
    ("wavelet_denoise_image", (0.05, 0.0), EXACT),
    ("transform_image_colorspace", ("lab",), FUNC),
    ("transform_image_colorspace", ("hsl",), EXACT),
    ("transform_image_colorspace", ("gray",), EXACT),
    ("set_image_colorspace", ("gray",), EXACT),
    ("negate_image", (False,), EXACT),
    ("negate_image", (True,), EXACT),
    ("gamma_image", (1.2,), FUNC),
    ("level_image", (0.05, 1.0, 0.95), EXACT),
    ("levelize_image", (0.1, 1.0, 0.9), EXACT),
    ("auto_level_image", (), EXACT),
    ("auto_gamma_image", (), FUNC),
    ("normalize_image", (), EXACT),
    ("equalize_image", (), EXACT),
    ("contrast_stretch_image", (0.02, 0.98), EXACT),
    ("linear_stretch_image", (0.02, 0.98), EXACT),
    ("sigmoidal_contrast_image", (True, 3.0, 0.5), FUNC),
    ("brightness_contrast_image", (5.0, 5.0), EXACT),
    ("modulate_image", (110, 90, 100), EXACT),
    ("contrast_image", (True,), FUNC),
    ("clahe_image", (8, 8, 0, 0), LAB),
    ("clahe_image", (16, 16, 128, 3.0), LAB),
    ("white_balance_image", (), LAB),
    ("enhance_image", (), EXACT),
    ("color_decision_list_image", ("",), EXACT),
    ("grayscale_image", (), EXACT),
    ("sepia_tone_image", (0.8,), RESAMPLE),
    ("solarize_image", (0.6,), EXACT),
    ("blue_shift_image", (1.1,), EXACT),
    ("colorize_image", ("blue", 0.1), EXACT),
    ("tint_image", ("red", 0.2), EXACT),
    ("color_matrix_image", ([[0.5, 0.3, 0.2], [0.1, 0.8, 0.1],
                             [0.2, 0.2, 0.6]],), EXACT),
    ("vignette_image", (0.0, 10.0, 0, 0), RESAMPLE),
    ("charcoal_image", (0.0, 0.6), EXACT),
    ("swirl_image", (30.0,), RESAMPLE),
    ("implode_image", (0.2,), RESAMPLE),
    ("wave_image", (2.0, 30.0), RESAMPLE),
    ("oil_paint_image", (1.0,), EXACT),
    ("threshold_image", (0.5,), EXACT),
    ("black_threshold_image", ("gray25",), EXACT),
    ("white_threshold_image", ("gray75",), EXACT),
    ("auto_threshold_image", ("otsu",), EXACT),
    ("auto_threshold_image", ("kapur",), EXACT),
    ("adaptive_threshold_image", (8, 8, 0.0), EXACT),
    ("ordered_dither_image", ("o4x4",), EXACT),
    ("range_threshold_image", (0.0, 0.1, 0.9, 1.0), EXACT),
    ("clamp_image", (), EXACT),
    ("posterize_image", (4, False), EXACT),
    ("posterize_image", (4, True), EXACT),
    ("quantize_image", (16,), EXACT),
    ("quantize_image", (8, "srgb", 0, True), EXACT),
    ("kmeans_image", (8, 5, 0.01), RESAMPLE),
    ("evaluate_image", ("multiply", 0.5), EXACT),
    ("evaluate_image", ("add", 0.1), EXACT),
    ("function_image", ("polynomial", [2, -1, 0.5]), EXACT),
    ("separate_image_channel", ("r",), EXACT),
    ("separate_image", ("g",), EXACT),
    ("set_image_alpha_channel", ("set",), EXACT),
    ("set_image_alpha_channel", ("extract",), EXACT),
    ("floodfill_paint_image", ("red", 0.1, "white", 5, 5), EXACT),
    ("opaque_paint_image", ("white", "red", 0.3), EXACT),
    ("transparent_paint_image", ("white", 0.0, 0.3), EXACT),
    ("border_image", ("gray", 2, 3), EXACT),
    ("frame_image", ("gray", 6, 6, 2, 2), EXACT),
    ("raise_image", (6, 6, 0, 0, True), EXACT),
    ("shadow_image", (80, 2.0, 2, 2), EXACT),
    ("polaroid_image", (None, "", 5.0), EXACT),
    ("encipher_image", ("pw",), EXACT),
    ("decipher_image", ("pw",), EXACT),
    ("canny_edge_image", (0.0, 1.0, 0.1, 0.3), EXACT),
    ("mean_shift_image", (7, 7, 0.1), EXACT),
    ("segment_image", (), EXACT),
    ("set_image_alpha", (0.8,), EXACT),
    ("set_image_matte", (True,), EXACT),
    ("set_image_extent", (80, 50), EXACT),
    ("set_image_color", ("beige",), EXACT),
    ("set_image_pixel_color", (3, 2, "red"), EXACT),
    ("set_image_pixel_color", (0, 0, "srgba(10,20,30,0.5)"), EXACT),
    ("cycle_colormap_image", (10,), EXACT),
    ("set_image_type", ("grayscale",), EXACT),
    ("set_image_type", ("bilevel",), EXACT),
    ("set_image_type", ("truecoloralpha",), EXACT),
    ("set_image_depth", (8,), EXACT),
    ("color_threshold_image", ("gray20", "gray80"), EXACT),
    ("threshold_image_channel", ("green", 0.5), EXACT),
    ("interpolative_resize_image", (40, 30), RESAMPLE),
    ("interpolative_resize_image", (40, 30, "nearest"), EXACT),
    ("resample_image", (144, 144), RESAMPLE),
    ("level_image_colors", ("gray10", "gray90"), EXACT),
    ("level_image_colors", ("gray10", "gray90", True), EXACT),
    ("import_image_pixels", (0, 0, 4, 4, "RGB",
                             np.zeros((4, 4, 3), np.uint8)), EXACT),
    ("import_image_pixels", (3, 2, 5, 2, "BGR",
                             np.linspace(0, 1, 30, dtype=np.float32)),
     EXACT),
    ("strip_image", (), EXACT),
    ("remove_image", (), EXACT),
    ("destroy_image", (), EXACT),
    ("profile_image", ("x-test", b"abc"), EXACT),
]


@pytest.mark.parametrize("name,args,tol", OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(OPS)])
def test_operator_matches_jax(name, args, tol):
    j, t = _pair(A)
    before = tdsp.COUNTS["fused"]
    rj = getattr(j, name)(*args)
    rt = getattr(t, name)(*args)
    assert (rj is None) == (rt is None)
    if len(j.images):
        assert t.current.data.device.type == "cpu"
    _assert_same(j, t, tol)
    if tol == FUSED:
        assert tdsp.COUNTS["fused"] > before


def test_wand_resize_took_the_fused_route():
    """The port's resize reaches K1 (its plain version here) once an image
    through ``try_fused_chain``; JAX's dispatch declines on the CPU, so
    its wand ran the op: the two routes agree at >= 60 dB."""
    frames = [_img(96, 128, seed=s) for s in (1, 2, 3)]
    j, t = _pair(*frames)
    before = dict(tdsp.COUNTS)
    t.resize_image(80, 60)
    t.gaussian_blur_image(0.0, 2.0)
    assert tdsp.COUNTS["fused"] - before["fused"] == 6
    assert tdsp.COUNTS["op"] == before["op"]
    j.resize_image(80, 60)
    j.gaussian_blur_image(0.0, 2.0)
    _assert_same(j, t, FUSED)
    # a non-opaque alpha declines the fused offer: the op runs
    ja_, ta_ = _pair(_img(96, 128, c=4), alpha=True)
    before = tdsp.COUNTS["fused"]
    ta_.blur_image(0.0, 1.0)
    ja_.blur_image(0.0, 1.0)
    assert tdsp.COUNTS["fused"] == before
    _assert_same(ja_, ta_, EXACT)


@pytest.mark.parametrize("name,args", [
    ("add_noise_image", ("gaussian", 0.2)),
    ("add_noise_image", ("uniform", 1.0)),
    ("spread_image", (1.0,)),
    ("random_threshold_image", (0.3, 0.7)),
    ("sketch_image", (0.0, 0.5, 0.0)),
    ("evaluate_image", ("gaussian-noise", 0.1)),
])
def test_random_operator_matches_jax_in_shape_and_size(name, args):
    """Different draws: the same shapes and specs, and a mean change from
    the input within a fifth of the JAX wand's."""
    j, t = _pair(A)
    getattr(j, name)(*args)
    getattr(t, name)(*args)
    (x,), (y,) = _arrays(j), _arrays(t)
    assert x.shape == y.shape and np.isfinite(y).all()
    assert (j.current.colorspace, j.current.alpha) == \
        (t.current.colorspace, t.current.alpha)
    dj = float(np.abs(x - A).mean()) if x.shape == A.shape else float(x.std())
    dt = float(np.abs(y - A).mean()) if y.shape == A.shape else float(y.std())
    assert abs(dt - dj) <= 0.2 * dj


def _wand_arg(arr):
    return lambda side: _side(arr, side)


S = _img(16, 20, seed=3)
B = _img(seed=11)
CLUT = np.linspace(0, 1, 48, dtype=np.float32).reshape(1, 16, 3)[..., ::-1]
HALD = _img(8, 8, seed=5)

# methods that take another wand: (method, args with wands as factories,
# bound)
WAND_OPS = [
    ("clut_image", (_wand_arg(CLUT.copy()),), EXACT),
    ("hald_clut_image", (_wand_arg(HALD),), EXACT),
    ("composite_image", (_wand_arg(S), "over", 4, 4), EXACT),
    ("composite_image", (_wand_arg(S), "multiply", 40, 30), EXACT),
    ("composite_image_gravity", (_wand_arg(S), "over", "center"), EXACT),
    ("remap_image", (_wand_arg(S), False), EXACT),
    ("remap_image", (_wand_arg(S), True), EXACT),
    ("remap_image", (_wand_arg(S), "floydsteinberg"), EXACT),
    ("set_image_mask", (_wand_arg(S[..., :1].copy()),), EXACT),
    ("stegano_image", (_wand_arg(S), 0), EXACT),
    ("stereo_image", (_wand_arg(B),), EXACT),
    ("texture_image", (_wand_arg(S),), EXACT),
    ("compare_images", (_wand_arg(B), "rmse"), EXACT),
    ("get_image_distortion", (_wand_arg(B), "psnr"), EXACT),
    ("get_image_distortions", (_wand_arg(B), "mae"), RESAMPLE),
    ("similarity_image", (_wand_arg(A[10:26, 20:40].copy()),), EXACT),
]


def _returns_match(rj, rt, tol):
    if isinstance(rj, ja.MagickWand):
        _assert_same(rj, rt, tol)
    elif isinstance(rj, tuple) and rj and isinstance(rj[0], ja.MagickWand):
        _assert_same(rj[0], rt[0], tol)
        assert rt[1] == pytest.approx(rj[1], rel=RESAMPLE, abs=RESAMPLE)
    elif isinstance(rj, (list, tuple)):
        assert np.allclose(rt, rj, rtol=RESAMPLE, atol=RESAMPLE)
    elif isinstance(rj, float):
        assert rt == pytest.approx(rj, rel=RESAMPLE)
    else:
        assert rj == rt


@pytest.mark.parametrize("name,args,tol", WAND_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(WAND_OPS)])
def test_operator_with_a_wand_matches_jax(name, args, tol):
    j, t = _pair(A)
    rj = getattr(j, name)(*[a("j") if callable(a) else a for a in args])
    rt = getattr(t, name)(*[a("t") if callable(a) else a for a in args])
    _returns_match(rj, rt, tol)
    _assert_same(j, t, tol)


# list methods over two frames: what they return and what the wand holds
LIST_OPS = [
    ("append_images", (True,), EXACT),
    ("append_images", (False,), EXACT),
    ("smush_images", (False, 2), EXACT),
    ("coalesce_images", (), EXACT),
    ("deconstruct_images", (), EXACT),
    ("deconstruct_images_wand", (), EXACT),
    ("optimize_image_layers", (), EXACT),
    ("merge_image_layers", ("flatten",), EXACT),
    ("merge_image_layers", ("mosaic",), EXACT),
    ("flatten_images", (), EXACT),
    ("montage_image", (), RESAMPLE),
    ("evaluate_images", ("mean",), EXACT),
    ("evaluate_images", ("max",), EXACT),
    ("morph_images", (2,), EXACT),
    ("polynomial_image", ([0.5, 1.0, 0.5, 1.0],), EXACT),
    ("complex_images", ("magnitude-phase",), RESAMPLE),
    ("compare_images_layers", (), EXACT),
    ("optimize_image_transparency", (), EXACT),
    ("quantize_images", (8,), EXACT),
    ("preview_images", ("gamma",), RESAMPLE),
    ("fx_image", ("u*0.5+v*0.25",), EXACT),
    ("combine_images", (), EXACT),
    ("channel_fx_image", ("red=>blue",), EXACT),
    ("unique_image_colors", (), EXACT),
    ("get_image_region", (8, 6, 2, 2), EXACT),
    ("composite_layers", (_wand_arg(S), "over", 2, 2), EXACT),
]


@pytest.mark.parametrize("name,args,tol", LIST_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LIST_OPS)])
def test_list_method_matches_jax(name, args, tol):
    j, t = _pair(A, B)
    rj = getattr(j, name)(*[a("j") if callable(a) else a for a in args])
    rt = getattr(t, name)(*[a("t") if callable(a) else a for a in args])
    _returns_match(rj, rt, tol)
    _assert_same(j, t, tol)
    assert j.iterator == t.iterator


def _polar(mag, phase):
    return np.asarray(mag) * np.exp(2j * np.pi * (np.asarray(phase) - 0.5))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_fourier_transform_methods_match_jax():
    j, t = _pair(A)
    pj, pt = j.forward_fourier_transform_image(), \
        t.forward_fourier_transform_image()
    (mj, phj), (mt, pht) = _arrays(pj), _arrays(pt)
    assert _rel(_polar(mt, pht), _polar(mj, phj)) <= SPEC_REL
    assert pj.iterator == pt.iterator == 1
    mag_j, ph_j = ja.MagickWand(), ja.MagickWand()
    mag_j.add_image(pj.images[0])
    ph_j.add_image(pj.images[1])
    mag_t, ph_t = ta.MagickWand("cpu"), ta.MagickWand("cpu")
    mag_t.add_image(pt.images[0])
    ph_t.add_image(pt.images[1])
    mag_j.inverse_fourier_transform_image(ph_j)
    mag_t.inverse_fourier_transform_image(ph_t)
    assert _db(_arrays(mag_t)[0], _arrays(mag_j)[0]) >= 120.0
    assert _db(_arrays(mag_t)[0], A) >= 100.0


# methods that return values: compared as values
VALUE_OPS = [
    ("get_image_histogram", ()),
    ("get_image_colors", ()),
    ("get_image_range", ()),
    ("export_image_pixels", (1, 2, 5, 4, "RGBA", "char")),
    ("export_image_pixels", (0, 0, 5, 4, "IAK", "double")),
    ("export_image_pixels", (2, 1, 3, 3, "BGR", "short")),
    ("export_image_pixels", (2, 1, 3, 3, "RGB")),
    ("get_image_total_ink_density", ()),
    ("signature", ()),
    ("get_image_signature", ()),
    ("get_image_length", ()),
    ("get_image_type", ()),
    ("identify_image_type", ()),
    ("identify_image", (False,)),
    ("connected_components_image", ()),
    ("hough_line_image", (5, 5, 10)),
    ("query_font_metrics", (None, "Hi")),
    ("get_image_width", ()),
    ("get_image_height", ()),
    ("get_image_colorspace", ()),
    ("get_image_alpha_channel", ()),
    ("get_image_depth", ()),
    ("get_image_format", ()),
    ("get_number_images", ()),
    ("get_image_page", ()),
    ("get_image_delay", ()),
    ("get_image_orientation", ()),
    ("get_image_resolution", ()),
    ("get_image_iterations", ()),
]


def _value_match(rj, rt):
    if isinstance(rj, dict):
        assert set(rj) == set(rt)
        for k in rj:
            _value_match(rj[k], rt[k])
    elif isinstance(rj, (list, tuple)):
        assert len(rj) == len(rt)
        for a, b in zip(rj, rt):
            _value_match(a, b)
    elif isinstance(rj, np.ndarray):
        assert rj.dtype == rt.dtype
        np.testing.assert_array_equal(rt, rj)
    else:
        assert rt == rj


@pytest.mark.parametrize("name,args", VALUE_OPS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(VALUE_OPS)])
def test_value_method_matches_jax(name, args):
    j, t = _pair(A)
    _value_match(getattr(j, name)(*args), getattr(t, name)(*args))


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
NUM_REL, NUM_ABS = 1e-5, 5e-5     # tests/test_torch_io.py's bounds


def test_verbose_identify_matches_jax():
    """The verbose text as ``tests/test_torch_io.py`` holds it: the same
    words, numbers within its bounds (float64 statistics against the JAX
    package's float32 ones), the version line naming each package."""
    j, t = _pair(A)
    gl = t.identify_image(True).splitlines()
    wl = j.identify_image(True).splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if g.startswith("  Version:"):
            assert "imagemagick_tpu_torch" in g
            continue
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
            assert float(a) == pytest.approx(float(b), rel=NUM_REL,
                                             abs=NUM_ABS), (g, w)


def test_statistics_methods_match_jax():
    """get_image_statistics, mean, kurtosis and features: float32 sums in
    another order, within the op tests' 1e-5."""
    j, t = _pair(A)
    sj, st = j.get_image_statistics(), t.get_image_statistics()
    assert set(sj) == set(st)
    for k in sj:
        assert isinstance(st[k], np.ndarray)
        np.testing.assert_allclose(st[k], sj[k], rtol=RESAMPLE,
                                   atol=RESAMPLE)
    for name in ("get_image_mean", "get_image_kurtosis"):
        assert getattr(t, name)() == pytest.approx(getattr(j, name)(),
                                                   rel=RESAMPLE)
    fj, ft = j.get_image_features(1), t.get_image_features(1)
    assert set(fj) == set(ft)
    for k in fj:
        assert float(ft[k]) == pytest.approx(float(fj[k]), rel=1e-4)


def test_pixel_color_round_trip_matches_jax():
    j, t = _pair(A)
    pj, pt = j.get_image_pixel_color(3, 4), t.get_image_pixel_color(3, 4)
    assert isinstance(pt, ta.PixelWand)
    assert pt.get_color() == pj.get_color()
    pt.red, pj.red = 0.25, 0.25
    j.set_image_pixel_color(3, 4, pj)
    t.set_image_pixel_color(3, 4, pt)
    _assert_same(j, t, EXACT)
    assert t.get_image_pixel_color(3, 4).get_color_string() == \
        j.get_image_pixel_color(3, 4).get_color_string()


def test_io_members_match_jax(tmp_path):
    j, t = _pair(A)
    assert t.get_image_blob("ppm") == j.get_image_blob("ppm")
    j.add_image(j.current)
    t.add_image(t.current)
    assert t.get_images_blob("gif") == j.get_images_blob("gif")
    for side, w in (("j", j), ("t", t)):
        (tmp_path / side).mkdir()
        w.write_image(str(tmp_path / side / "a.ppm"))
        w.write_images(str(tmp_path / side / "b.gif"))
        w.write_images(str(tmp_path / side / "c.pgm"), adjoin=False)
        buf = _io.BytesIO()
        w.write_image_file(buf, "ppm")
        assert buf.getvalue() == w.get_image_blob("ppm")
        buf = _io.BytesIO()
        w.write_images_file(buf, "gif")
        assert buf.getvalue() == w.get_images_blob("gif")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    blob = j.get_image_blob("png")
    rj, rt = ja.MagickWand(), ta.MagickWand("cpu")
    for w in (rj, rt):
        w.read_image_blob(blob)
        w.ping_image_blob(blob, "png")
        w.read_image_file(_io.BytesIO(blob))
        w.read_image(str(tmp_path / "j" / "a.ppm"))
        w.ping_image(str(tmp_path / "j" / "a.ppm"))
        w.read_image("rose:")
        w.new_image(5, 3, "lime")
        w.new_image(4, 2, ta.PixelWand("srgba(0,0,255,0.5)")
                    if w is rt else ja.PixelWand("srgba(0,0,255,0.5)"))
        w.constitute_image(3, 2, "RGBA", np.linspace(0, 1, 24))
        w.set_size(6, 4)
        w.read_image("gradient:red-blue")
        w.set_size(8, 4)
        w.read_image(str(tmp_path / "j" / "c.pgm"))
    assert all(im.data.device.type == "cpu" for im in rt.images)
    _assert_same(rj, rt, EXACT)
    assert rt.iterator == rj.iterator


def test_settings_and_properties_match_jax():
    """The wand's and the image's settings: each setter then its getter
    on both wands, and the values they return."""
    j, t = _pair(A)
    calls = [
        ("set_image_property", ("comment", "c1")),
        ("get_image_property", ("comment",)),
        ("get_image_properties", ("c*",)),
        ("delete_image_property", ("comment",)),
        ("get_image_property", ("comment",)),
        ("set_image_profile", ("icc", b"\x00\x01")),
        ("get_image_profile", ("icc",)),
        ("get_image_profiles", ("*",)),
        ("remove_image_profile", ("icc",)),
        ("set_image_format", ("png",)),
        ("get_image_format", ()),
        ("set_image_page", (64, 48, 1, 2)),
        ("get_image_page", ()),
        ("reset_image_page", ()),
        ("get_image_page", ()),
        ("set_image_delay", (7,)),
        ("get_image_delay", ()),
        ("set_image_orientation", (6,)),
        ("get_image_orientation", ()),
        ("set_image_resolution", (150, 120)),
        ("get_image_resolution", ()),
        ("set_image_gravity", ("center",)),
        ("get_image_gravity", ()),
        ("set_gravity", ("east",)),
        ("get_gravity", ()),
        ("set_font", ("Helvetica",)),
        ("get_font", ()),
        ("comment_image", ("hi",)),
        ("label_image", ("rose",)),
        ("set_image_channel_mask", (7,)),
        ("set_image_channel_mask", (3,)),
        ("set_image_iterations", (4,)),
        ("set_image_compression_quality", (80,)),
        ("get_compression_quality", ()),
        ("set_image_virtual_pixel_method", ("mirror",)),
        ("get_image_virtual_pixel_method", ()),
        ("set_image_red_primary", (0.6, 0.3)),
        ("get_image_red_primary", ()),
        ("get_image_green_primary", ()),
        ("get_image_blue_primary", ()),
        ("get_image_white_point", ()),
        ("get_image_gamma", ()),
        ("get_image_fuzz", ()),
        ("get_image_filter", ()),
        ("get_image_scene", ()),
        ("get_image_ticks_per_second", ()),
        ("get_image_filename", ()),
        ("get_image_compose", ()),
        ("set_antialias", (False,)),
        ("get_antialias", ()),
        ("set_colorspace", ("LAB",)),
        ("get_colorspace", ()),
        ("set_resolution", (90.0,)),
        ("get_resolution", ()),
        ("set_size", (12, 34)),
        ("get_size", ()),
        ("set_page", (64, 64, 1, 2)),
        ("get_page", ()),
        ("set_sampling_factors", ([2, 1, 1],)),
        ("get_sampling_factors", ()),
        ("set_option", ("jpeg:size", "128x128")),
        ("get_option", ("jpeg:size",)),
        ("get_options", ()),
        ("delete_option", ("jpeg:size",)),
        ("get_options", ()),
        ("set_image_artifact", ("compose:args", "40")),
        ("get_image_artifact", ("compose:args",)),
        ("get_image_artifacts", ()),
        ("delete_image_artifact", ("compose:args",)),
        ("set_depth", (16,)),
        ("set_extract", ("8x8+0+0",)),
        ("set_passphrase", ("pw",)),
        ("set_seed", (42,)),
        ("set_type", ("truecolor",)),
        ("get_type", ()),
        ("set_size_offset", (3,)),
        ("get_size_offset", ()),
        ("get_resource", ("memory",)),
        ("get_resource_limit", ("area",)),
        ("get_version", ()),
        ("get_quantum_depth", ()),
        ("get_quantum_range", ()),
        ("get_release_date", ()),
        ("has_next_image", ()),
        ("has_previous_image", ()),
        ("next_image", ()),
        ("previous_image", ()),
        ("set_first_iterator", ()),
        ("set_last_iterator", ()),
        ("reset_iterator", ()),
    ]
    for name, args in calls:
        rj, rt = getattr(j, name)(*args), getattr(t, name)(*args)
        if name == "get_version":
            assert rt == (rj[0].replace("imagemagick_tpu",
                                        "imagemagick_tpu_torch"), rj[1])
        else:
            assert rt == rj, name
    assert j.settings == t.settings
    assert {k: v for k, v in j.current.properties.items()} == \
        t.current.properties
    for w in (j, t):
        w.set_background_color("wheat")
    assert t.get_background_color().get_color() == \
        j.get_background_color().get_color()
    assert t.get_home_url() == j.get_home_url()
    assert t.get_package_name() == "imagemagick_tpu_torch"
    assert "imagemagick_tpu_torch" in t.get_copyright()


def test_image_attribute_pairs_match_jax():
    j, t = _pair(A)
    pairs = [("compose", "multiply"), ("compression", "zip"),
             ("dispose", "background"), ("endian", "lsb"),
             ("filter", "catrom"), ("interlace_scheme", "plane"),
             ("interpolate_method", "bicubic"),
             ("rendering_intent", "relative"), ("units", "pixelsperinch"),
             ("virtual_pixel_method", "mirror"), ("filename", "x.png"),
             ("scene", 3), ("ticks_per_second", 60), ("gamma", 0.6),
             ("fuzz", 0.01)]
    for key, val in pairs:
        assert getattr(t, f"set_image_{key}")(val) == \
            getattr(j, f"set_image_{key}")(val)
        assert getattr(t, f"get_image_{key}")() == \
            getattr(j, f"get_image_{key}")()
    for key in ("background", "border", "matte"):
        for color in ("wheat", "srgba(1,2,3,0.5)"):
            getattr(j, f"set_image_{key}_color")(ja.PixelWand(color))
            getattr(t, f"set_image_{key}_color")(ta.PixelWand(color))
            assert getattr(t, f"get_image_{key}_color")().get_color() == \
                getattr(j, f"get_image_{key}_color")().get_color()
        getattr(j, f"set_image_{key}_color")("wheat")
        getattr(t, f"set_image_{key}_color")("wheat")
    for prim in ("red", "green", "blue"):
        getattr(j, f"set_image_{prim}_primary")(0.6, 0.3)
        getattr(t, f"set_image_{prim}_primary")(0.6, 0.3)
    j.set_image_white_point(0.31, 0.32)
    t.set_image_white_point(0.31, 0.32)
    assert j.current.properties == t.current.properties


def test_drawing_wand_matches_jax():
    """The same MVG text on both, and the same pixels drawn from it."""
    dj, dt = ja.DrawingWand(), ta.DrawingWand()
    for d, pw in ((dj, ja.PixelWand), (dt, ta.PixelWand)):
        d.set_fill_color("red")
        d.set_stroke_color(pw("navy"))
        d.set_stroke_width(2)
        d.push()
        d.translate(3, 2)
        d.rectangle(4, 4, 12, 12)
        d.pop()
        d.circle(30, 20, 40, 20)
        d.ellipse(50, 30, 8, 5)
        d.polygon([(0, 0), (20, 5), (10, 30)])
        d.line(0, 40, 60, 44)
        d.path_start()
        d.path_move_to_absolute(40, 40)
        d.path_line_to_relative(10, -5)
        d.path_curve_to_absolute(50, 30, 55, 35, 60, 45)
        d.path_close()
        d.path_finish()
        d.set_fill_opacity(0.5)
        d.round_rectangle(20, 30, 36, 44, 3, 3)
    assert dt.get_mvg() == dj.get_mvg()
    assert dt.get_fill_color().get_color() == dj.get_fill_color().get_color()
    j, t = _pair(A)
    j.draw_image(dj)
    t.draw_image(dt)
    _assert_same(j, t, EXACT)
    j.draw_image("fill blue circle 10,10 14,10")
    t.draw_image("fill blue circle 10,10 14,10")
    _assert_same(j, t, EXACT)
    cj, ct = dj.clone(), dt.clone()
    assert ct.get_vector_graphics() == cj.get_vector_graphics()
    for d in (cj, ct):
        d.clear()
        d.set_vector_graphics("circle 10,10 14,10")
        d.annotation(2, 3, "it's")
        d.alpha(1, 1, "point")
        d.set_font_resolution(72, 72)
    assert ct.get_mvg() == cj.get_mvg()
    assert ct.get_font_resolution() == cj.get_font_resolution()
    assert ct.get_type_metrics("Hi") == cj.get_type_metrics("Hi")


def test_annotate_matches_jax():
    j, t = _pair(A)
    for w, dw in ((j, ja.DrawingWand()), (t, ta.DrawingWand())):
        dw.set_font_size(14)
        dw.set_fill_color("blue")
        dw.set_text_direction("right-to-left")
        w.annotate_image(dw, 2, 16, 0, "Hi")
        w.annotate_image(None, 5, 40, 0, "ab")
    _assert_same(j, t, EXACT)
    assert t.query_font_metrics(ta.DrawingWand(), "Hey") == \
        j.query_font_metrics(ja.DrawingWand(), "Hey")
    dw = ta.DrawingWand()
    dw.set_font_size(20)
    assert ta.magick_query_multiline_font_metrics(t, dw, "a\nbc") == \
        ja.magick_query_multiline_font_metrics(j, dw, "a\nbc")


def test_views_and_iterators_match_jax():
    j, t = _pair(A)
    vj, vt = ja.WandView(j, 2, 3, 16, 10), ta.WandView(t, 2, 3, 16, 10)
    assert vt.get_extent() == vj.get_extent()
    np.testing.assert_array_equal(vt.get().numpy(), np.asarray(vj.get()))
    vj.update(lambda r: r * 0.5)
    vt.update(lambda r: r * 0.5)
    _assert_same(j, t, EXACT)
    oj, ot = ja.new_wand_view_extent(j, 20, 20, 16, 10), \
        ta.new_wand_view_extent(t, 20, 20, 16, 10)
    vj.transfer(oj, lambda a, b: a + b)
    vt.transfer(ot, lambda a, b: a + b)
    _assert_same(j, t, EXACT)
    seen = []
    assert vt.get_iterator(lambda r: seen.append(r.shape))
    assert seen == [(10, 16, 3)]
    assert vt.clone().get_extent() == vt.get_extent()
    assert ta.clone_wand_view(vt).get_wand() is t
    assert ta.is_wand_view(ta.new_wand_view(t))
    ij, it = ja.PixelIterator(j, 1, 2, 5, 3), ta.PixelIterator(t, 1, 2, 5, 3)
    for itr in (ij, it):
        for row in itr:
            for p in row:
                p.red = 1.0
                p.blue = 0.25
            itr.sync_iterator()
    _assert_same(j, t, EXACT)
    for itr in (ij, it):
        itr.set_last_iterator_row()
        itr.get_previous_row()
        itr.set_iterator_row(1)
    assert it.get_iterator_row() == ij.get_iterator_row()
    assert [p.get_color() for p in it.get_next_row()] == \
        [p.get_color() for p in ij.get_next_row()]
    assert it.clone().get_iterator_row() == ij.clone().get_iterator_row()


def test_pixel_wand_matches_jax():
    for color in ("rgb(255,128,0)", "cyan", "srgba(10,20,30,0.25)",
                  "gray50", (0.2, 0.4, 0.6), (0.5,), (0.1, 0.2, 0.3, 0.4)):
        pj, pt = ja.PixelWand(color), ta.PixelWand(color)
        for name in ("get_color", "get_color_string",
                     "get_color_as_normalized_string", "get_hsl",
                     "get_cyan", "get_magenta", "get_yellow", "get_black",
                     "get_red_quantum", "get_alpha_quantum",
                     "get_black_quantum", "get_pixel", "get_quantum_pixel"):
            assert getattr(pt, name)() == getattr(pj, name)(), (color, name)
        for name, arg in (("set_black", 0.5), ("set_cyan", 0.25),
                          ("set_hsl", (0.3, 0.5, 0.4)),
                          ("set_green_quantum", 1000.0),
                          ("set_yellow_quantum", 30000.0),
                          ("set_quantum_pixel", (1.0, 2.0, 3.0, 65535.0))):
            args = arg if isinstance(arg, tuple) and name == "set_hsl" \
                else (arg,)
            getattr(pj, name)(*args)
            getattr(pt, name)(*args)
            assert pt.get_color() == pj.get_color(), (color, name)
    a, b = ta.new_pixel_wand("white"), ja.new_pixel_wand("white")
    assert ta.is_pixel_wand_similar(a, ta.clone_pixel_wand(a), 0.0)
    assert len(ta.new_pixel_wands(3)) == len(ja.new_pixel_wands(3))
    assert [w.get_color() for w in ta.clone_pixel_wands([a])] == \
        [w.get_color() for w in ja.clone_pixel_wands([b])]


def test_module_functions_match_jax():
    for name in ("magick_wand_genesis", "magick_wand_terminus",
                 "magick_relinquish_memory"):
        assert getattr(ta, name)() == getattr(ja, name)()
    assert ta.magick_query_fonts("*") == ja.magick_query_fonts("*")
    assert ta.magick_query_configure_options("*") == \
        ja.magick_query_configure_options("*")
    for key in ja.magick_query_configure_options("*"):
        got = ta.magick_query_configure_option(key)
        if key in ("VERSION", "FEATURES"):
            assert "TPU" not in got and "XLA" not in got
        else:
            assert got == ja.magick_query_configure_option(key)
    assert "imagemagick_tpu_torch" in ta.magick_query_configure_option(
        "version")
    with pytest.raises(KeyError):
        ta.magick_query_configure_option("nosuch")
    w = ta.new_magick_wand(device="cpu")
    w.new_image(3, 2, "lime")
    assert ta.is_magick_wand(w) and not ta.is_magick_wand(42)
    assert ta.clone_magick_wand(w).images == w.images
    assert ta.destroy_magick_wand(w) is None
    w2 = ta.new_magick_wand_from_image(w)
    assert w2.device == w.current.data.device and w2.images == [w.current]
    ta.clear_magick_wand(w2)
    assert len(w2) == 0 and w2.iterator == -1


def test_query_formats_equals_the_jax_query_but_for_the_recorded_names():
    """``magick_query_formats`` reads the lists that ``-list format``
    prints; it differs from the JAX query only by the names the port's
    lists add or drop for the JAX list's recorded faults."""
    from torch_format_faults import RECORDED_FORMATS

    got = set(ta.magick_query_formats("*"))
    want = set(ja.magick_query_formats("*"))
    assert got - want <= RECORDED_FORMATS
    assert want - got <= RECORDED_FORMATS
    assert got - RECORDED_FORMATS == want - RECORDED_FORMATS
    assert ta.magick_query_formats("PN*") == ja.magick_query_formats("PN*")


def _public_members(module):
    """Every public name the module defines, and each class's public
    methods and properties, as ``name`` and ``Class.member``."""
    out = set()
    for name, obj in vars(module).items():
        if name.startswith("_") or \
                getattr(obj, "__module__", None) != module.__name__:
            continue
        out.add(name)
        if inspect.isclass(obj):
            for member, _ in inspect.getmembers(obj):
                if not member.startswith("_"):
                    out.add(f"{name}.{member}")
    return out


def test_every_public_name_of_the_jax_wand_has_a_port_counterpart():
    jax_names = _public_members(ja)
    port_names = _public_members(ta)
    assert len(jax_names) > 600
    assert not jax_names - port_names, sorted(jax_names - port_names)
    from imagemagick_tpu import wand as jw
    from imagemagick_tpu_torch import wand as tw

    assert tw.__all__ == jw.__all__


# -- aliasing: no method writes into a tensor someone else holds ------------

@pytest.mark.parametrize("edit,changes", [
    (lambda w: w.set_image_pixel_color(1, 2, "red"), True),
    (lambda w: w.import_image_pixels(0, 0, 2, 2, "RGB",
                                     np.ones((2, 2, 3), np.float32)), True),
    (lambda w: ta.WandView(w, 0, 0, 4, 4).update(lambda r: r.mul_(0.0)),
     True),
    (lambda w: ta.WandView(w, 0, 0, 4, 4).get().zero_(), False),
    (lambda w: w.threshold_image_channel("red", 0.5), True),
    (lambda w: w.set_image_color("red"), True),
    (lambda w: w.cycle_colormap_image(30), True),
    (lambda w: w.level_image_colors("gray10", "gray90"), True),
], ids=["pixel_color", "import_pixels", "view_update", "view_get",
        "threshold_channel", "image_color", "cycle_colormap",
        "level_colors"])
def test_a_write_on_a_clone_leaves_the_original_and_the_caller_alone(
        edit, changes):
    arr = _img(12, 16, seed=9)
    keep = arr.copy()
    w = ta.MagickWand("cpu")
    w.add_image(TImage(arr, device="cpu"))     # may share arr's buffer
    base = w.current.data.clone()
    c = w.clone()
    edit(c)
    assert torch.equal(c.current.data, base) != changes
    assert torch.equal(w.current.data, base)
    np.testing.assert_array_equal(arr, keep)


def test_pixel_iterator_sync_leaves_the_original_alone():
    arr = _img(12, 16, seed=9)
    keep = arr.copy()
    w = ta.MagickWand("cpu")
    w.add_image(TImage(arr, device="cpu"))
    c = w.clone()
    it = ta.PixelIterator(c, 0, 0, 4, 2)
    for row in it:
        for p in row:
            p.red = 1.0
        it.sync_iterator()
    first = c.current.data
    kept = first.clone()
    # a later sync leaves the image an earlier one made alone
    it.reset()
    row = it.get_next_row()
    for p in row:
        p.green = 0.125
    it.sync_iterator()
    assert torch.equal(first, kept)
    assert float(c.current.data[0, 0, 1]) == 0.125
    assert float(c.current.data[1, 0, 0]) == 1.0
    np.testing.assert_array_equal(arr, keep)
    np.testing.assert_array_equal(w.current.data.numpy(), keep)


def test_reads_land_on_the_wand_device_and_images_keep_theirs():
    w = ta.new_magick_wand(device="cpu")
    w.read_image("rose:")
    w.new_image(4, 4, "red")
    w.read_image_blob(w.get_image_blob("png"))
    assert {im.data.device.type for im in w.images} == {"cpu"}
    assert w.device == torch.device("cpu")
    assert ta.MagickWand().device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ta.MagickWand().read_image("rose:")


# -- faults of the JAX wand that the port does not copy ---------------------

def test_jax_colormap_color_raises_on_every_image():
    """``get_image_colormap_color`` hands numpy the pair (colors, counts)
    of ``unique_colors`` (``wand/api.py:1883``), which raises; the port
    takes the colors."""
    j, t = _pair(A)
    with pytest.raises(ValueError, match="inhomogeneous"):
        j.get_image_colormap_color(0)
    colors, _ = __import__("imagemagick_tpu_torch.ops.histogram",
                           fromlist=["x"]).unique_colors(t.current.data)
    for i in (0, 2, 10 ** 6):
        got = t.get_image_colormap_color(i).get_color()
        k = min(i, len(colors) - 1)
        assert got[:3] == tuple(float(v) for v in colors[k][:3])


@pytest.mark.parametrize("name,args", [
    ("liquid_rescale_image", (20, 20)),
    ("floodfill_paint_image", ("red", 0.1, "white", 3, 3)),
])
def test_jax_wand_raises_on_a_batch_where_the_port_does_not(name, args):
    """The JAX ops under these methods raise on a batch (``distort.py:
    1277-1284``, ``paint.py:68``); the port's ops take each image."""
    batch = np.stack([_img(20, 24, seed=s) for s in (1, 2)])
    j, t = _pair(batch)
    with pytest.raises((TypeError, ValueError)):
        getattr(j, name)(*args)
    getattr(t, name)(*args)
    for k in range(2):
        one = _pair(batch[k])[1]
        getattr(one, name)(*args)
        np.testing.assert_array_equal(t.current.data[k].numpy(),
                                      one.current.data.numpy())


def test_jax_channel_fx_clamps_a_missing_channel_the_port_raises():
    j, t = _pair(A)
    out = j.channel_fx_image("k=>red")
    np.testing.assert_array_equal(np.asarray(out.current.data)[..., 0],
                                  A[..., 2])
    with pytest.raises(ValueError, match="not in a 3-channel"):
        t.channel_fx_image("k=>red")


def test_the_wand_and_the_top_level_import_no_jax():
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import imagemagick_tpu_torch as imt\n"
            "from imagemagick_tpu_torch.wand import api, cpp_support\n"
            "assert imt.__version__ == '0.1.0'\n"
            "assert callable(imt.read) and callable(imt.write)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'imagemagick_tpu' or "
            "m.startswith('imagemagick_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_top_level_read_write_match_jax(tmp_path):
    import imagemagick_tpu as jimt
    import imagemagick_tpu_torch as timt

    assert timt.__version__ == jimt.__version__
    assert timt.__all__ == jimt.__all__
    for s in ("64x48+3+2", "50%", "10x20!"):
        assert repr(timt.parse_geometry(s)) == repr(jimt.parse_geometry(s))
        assert timt.parse_meta_geometry(s, 64, 48) == \
            jimt.parse_meta_geometry(s, 64, 48)
    t = timt.read("rose:", device="cpu")
    j = jimt.read("rose:")
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    timt.write(t, str(tmp_path / "t.ppm"))
    jimt.write(j, str(tmp_path / "j.ppm"))
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
    g = timt.read("gradient:red-blue", device="cpu", size="8x6")
    assert g.data.shape == (6, 8, 3) and g.data.device.type == "cpu"


RGBA = _img(c=4)
ALPHA_OPS = [
    # a non-opaque alpha declines the fused offer: both wands run the op
    ("resize_image", (40, 30), RESAMPLE),
    ("thumbnail_image", (32, 22), RESAMPLE),
    ("blur_image", (0.0, 1.0), EXACT),
    ("gaussian_blur_image", (0.0, 1.0), EXACT),
    ("negate_image", (), EXACT),
    ("set_image_alpha_channel", ("remove",), EXACT),
    ("set_image_alpha_channel", ("off",), EXACT),
    ("set_image_alpha_channel", ("extract",), EXACT),
    ("transparent_paint_image", ("white", 0.0, 0.3), EXACT),
    ("shadow_image", (80, 2.0, 2, 2), EXACT),
    ("level_image", (0.1, 1.0, 0.9), EXACT),
    ("transform_image_colorspace", ("gray",), EXACT),
    ("grayscale_image", (), EXACT),
    ("trim_image", (), EXACT),
    ("rotate_image", ("none", 10.0), EXACT),
    ("extent_image", (80, 60, -5, -6), EXACT),
    ("border_image", ("red", 2, 2), EXACT),
    ("sepia_tone_image", (0.8,), RESAMPLE),
    ("quantize_image", (16,), EXACT),
    ("composite_image", (_wand_arg(S), "over", 4, 4), EXACT),
    ("draw_image", ("fill red circle 20,20 30,20",), EXACT),
]


@pytest.mark.parametrize("name,args,tol", ALPHA_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(ALPHA_OPS)])
def test_operator_on_an_alpha_image_matches_jax(name, args, tol):
    j, t = _pair(RGBA, alpha=True)
    before = tdsp.COUNTS["fused"]
    getattr(j, name)(*[a("j") if callable(a) else a for a in args])
    getattr(t, name)(*[a("t") if callable(a) else a for a in args])
    assert tdsp.COUNTS["fused"] == before
    _assert_same(j, t, tol)


BATCH = np.stack([_img(20, 24, seed=s) for s in (1, 2)])
BATCH_OPS = [
    # dispatch takes a frame, not a batch: both wands run the op
    ("resize_image", (16, 12), RESAMPLE),
    ("gaussian_blur_image", (0.0, 1.0), EXACT),
    ("negate_image", (), EXACT),
    ("auto_threshold_image", ("otsu",), EXACT),
    ("quantize_image", (8,), RESAMPLE),        # k-means on a batch
    ("remap_image", (_wand_arg(_img(4, 4, seed=3)), True), EXACT),
    ("remap_image", (_wand_arg(_img(4, 4, seed=3)), False), EXACT),
    ("remap_image", (_wand_arg(_img(4, 4, seed=3)), "riemersma"), EXACT),
    ("flip_image", (), EXACT),
    ("crop_image", (10, 8, 2, 3), EXACT),
]


@pytest.mark.parametrize("name,args,tol", BATCH_OPS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(BATCH_OPS)])
def test_operator_on_a_batch_matches_jax(name, args, tol):
    """A 4-D image: ``remap_image`` under a dither runs the
    Floyd-Steinberg walk over the batch (the palette-walk kernel on a
    card, its plain version here), bit for bit the JAX walk."""
    j, t = _pair(BATCH)
    getattr(j, name)(*[a("j") if callable(a) else a for a in args])
    getattr(t, name)(*[a("t") if callable(a) else a for a in args])
    _assert_same(j, t, tol)
