"""wandtest.c-style walk of the port's MagickWand surface, step by step
against the JAX wand.

Mirrors ``tests/test_wandtest.py``: a long sequence of wand methods on the
built-in ``rose:``.  Here each step runs on a JAX wand and a port wand
(``device="cpu"``) that hold the same pixels, and the two results are held
to the bound of the op's own parity test (``torch_wand_pairs``).  Before
the next step the port wand takes copies of the JAX wand's images, so that
every step starts from equal inputs and a difference does not carry into
the steps after it.  ``test_zz_surface_count`` keeps the count of
distinct port methods exercised at >= 250, as the JAX file does.
"""

import dataclasses
import io as _io

import numpy as np
import pytest

from imagemagick_tpu.wand import api as ja
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
from imagemagick_tpu_torch.wand.api import (DrawingWand, MagickWand,
                                            PixelIterator, PixelWand,
                                            WandView, new_magick_wand)

from torch_wand_pairs import (EXACT, FUNC, FUSED, KUWAHARA, LAB, RESAMPLE,
                              _arrays, _assert_same, assert_kuwahara)

CALLED = set()


def call(obj, name, *args, **kw):
    CALLED.add(f"{type(obj).__name__}.{name}")
    return getattr(obj, name)(*args, **kw)


def _rose_pair():
    j, t = ja.new_magick_wand(), new_magick_wand("cpu")
    j.read_image("rose:")
    t.read_image("rose:")
    _assert_same(j, t, EXACT)
    return j, t


def _sync(j, t):
    """The port wand takes copies of the JAX wand's images and iterator."""
    t.images = [TImage(np.array(x), TSpec(**dataclasses.asdict(im.spec)),
                       dict(im.properties), dict(im.profiles), im.page,
                       im.delay, device="cpu")
                for x, im in zip(_arrays(j), j.images)]
    t.iterator = j.iterator


def _walk(j, t, seq):
    for name, args, tol in seq:
        before = t.current.data
        getattr(j, name)(*args)
        call(t, name, *args)
        if tol == KUWAHARA:
            assert_kuwahara(before, j, t, *args)
        else:
            _assert_same(j, t, tol)
        _sync(j, t)


# the JAX walk's sequence (tests/test_wandtest.py), each step with its bound
SEQ = [
    ("resize_image", (40, 30), FUSED),
    ("adaptive_resize_image", (38, 28), RESAMPLE),   # W * C < 128: the op
    ("scale_image", (36, 26), EXACT), ("sample_image", (34, 24), EXACT),
    ("thumbnail_image", (32, 22), RESAMPLE),
    ("liquid_rescale_image", (30, 22), RESAMPLE),
    ("crop_image", (20, 16, 2, 2), EXACT), ("chop_image", (2, 2, 0, 0), EXACT),
    ("extent_image", (24, 20, 0, 0), EXACT), ("shave_image", (1, 1), EXACT),
    ("splice_image", (2, 2, 1, 1), EXACT), ("roll_image", (2, 2), EXACT),
    ("flip_image", (), EXACT), ("flop_image", (), EXACT),
    ("transpose_image", (), EXACT), ("transverse_image", (), EXACT),
    ("rotate_image", ("white", 5.0), RESAMPLE),
    ("shear_image", ("white", 2.0, 2.0), RESAMPLE),
    ("deskew_image", (0.4,), RESAMPLE), ("trim_image", (0.0,), EXACT),
    ("blur_image", (0.0, 0.6), RESAMPLE),
    ("gaussian_blur_image", (0.0, 0.6), RESAMPLE),
    ("adaptive_blur_image", (0.0, 0.6), EXACT),
    ("motion_blur_image", (0.0, 0.6, 10.0), EXACT),
    ("rotational_blur_image", (2.0,), EXACT),
    ("sharpen_image", (0.0, 0.6), EXACT),
    ("adaptive_sharpen_image", (0.0, 0.6), EXACT),
    ("unsharp_mask_image", (0.0, 0.6, 1.0, 0.02), EXACT),
    ("emboss_image", (0.0, 0.6), EXACT),
    ("shade_image", (True, 30.0, 30.0), RESAMPLE),
    ("edge_image", (1.0,), EXACT), ("charcoal_image", (0.0, 0.6), EXACT),
    ("despeckle_image", (), EXACT), ("enhance_image", (), EXACT),
    ("kuwahara_image", (1.0, 0.5), KUWAHARA),
    ("negate_image", (False,), EXACT), ("auto_gamma_image", (), FUNC),
    ("auto_level_image", (), EXACT), ("normalize_image", (), EXACT),
    ("equalize_image", (), EXACT), ("gamma_image", (1.2,), FUNC),
    ("level_image", (0.05, 1.0, 0.95), EXACT),
    ("levelize_image", (0.0, 1.0, 1.0), EXACT),
    ("brightness_contrast_image", (5.0, 5.0), EXACT),
    ("modulate_image", (100.0, 95.0, 100.0), EXACT),
    ("sigmoidal_contrast_image", (True, 3.0, 0.5), FUNC),
    ("contrast_image", (True,), FUNC),
    ("contrast_stretch_image", (0.02, 0.98), EXACT),
    ("linear_stretch_image", (0.02, 0.98), EXACT),
    ("clahe_image", (8, 8, 0, 0), LAB), ("white_balance_image", (), LAB),
    ("solarize_image", (0.6,), EXACT), ("sepia_tone_image", (0.8,), RESAMPLE),
    ("blue_shift_image", (1.1,), EXACT), ("tint_image", ("red", 0.2), EXACT),
    ("colorize_image", ("blue", 0.1), EXACT),
    ("vignette_image", (0.0, 10.0, 0, 0), RESAMPLE),
    ("implode_image", (0.2,), RESAMPLE), ("swirl_image", (30.0,), RESAMPLE),
    ("wave_image", (2.0, 30.0), RESAMPLE),
    ("oil_paint_image", (1.0,), EXACT),
    ("blur_image", (0.0, 0.4), RESAMPLE),
    ("posterize_image", (8, False), EXACT),
    ("threshold_image", (0.5,), EXACT),
]

SEQ2 = [
    ("black_threshold_image", ("gray25",), EXACT),
    ("white_threshold_image", ("gray75",), EXACT),
    ("ordered_dither_image", ("o4x4",), EXACT),
    ("adaptive_threshold_image", (8, 8, 0.0), EXACT),
    ("auto_threshold_image", ("otsu",), EXACT),
    ("range_threshold_image", (0.0, 0.1, 0.9, 1.0), EXACT),
    ("clamp_image", (), EXACT), ("quantize_image", (16,), EXACT),
    ("posterize_image", (4, True), EXACT),
    ("kmeans_image", (8, 5, 0.01), RESAMPLE),
    ("cycle_colormap_image", (10,), EXACT),
    ("transform_image_colorspace", ("lab",), FUNC),
    ("transform_image_colorspace", ("srgb",), FUNC),
    ("separate_image_channel", ("r",), EXACT),
]


def test_image_ops_sequence():
    """The long op walk (wandtest.c's main body analog), step by step."""
    _walk(*_rose_pair(), SEQ)
    _walk(*_rose_pair(), SEQ2)
    j, t = _rose_pair()
    for name, args in [
        ("get_image_width", ()), ("get_image_height", ()),
        ("get_image_depth", ()), ("get_image_colors", ()),
        ("get_image_colorspace", ()), ("get_image_format", ()),
        ("get_image_signature", ()), ("get_image_histogram", ()),
        ("get_image_type", ()), ("identify_image_type", ()),
        ("get_image_length", ()), ("get_image_page", ()),
        ("identify_image", (False,)),
    ]:
        assert call(t, name, *args) == getattr(j, name)(*args), name
    for name in ("get_image_mean", "get_image_kurtosis"):
        assert call(t, name) == pytest.approx(getattr(j, name)(),
                                              rel=RESAMPLE)
    assert call(t, "get_image_pixel_color", 1, 1).get_color() == \
        j.get_image_pixel_color(1, 1).get_color()
    _assert_same(j.get_image_region(8, 8, 0, 0),
                 call(t, "get_image_region", 8, 8, 0, 0), EXACT)
    feats = call(t, "get_image_features", 1)
    for k, v in j.get_image_features(1).items():
        assert float(feats[k]) == pytest.approx(float(v), rel=1e-4)


def test_pixelwand_surface():
    p, q = PixelWand("navy"), ja.PixelWand("navy")
    for name, args in [("get_color", ()), ("get_color_string", ()),
                       ("set_color", ("red",)), ("get_color", ())]:
        assert call(p, name, *args) == getattr(q, name)(*args)
    for ch in ("red", "green", "blue", "alpha"):
        CALLED.add(f"PixelWand.{ch}")
        setattr(p, ch, 0.5)
        assert getattr(p, ch) == 0.5
    names = [n for n in dir(ja.PixelWand) if not n.startswith("_") and
             callable(getattr(ja.PixelWand, n)) and
             (n.startswith("get_") or n in ("clone", "clear",
                                            "clear_exception"))]
    for name in names:
        got, want = call(p, name), getattr(q, name)()
        if name == "clone":
            got, want = got.get_color(), want.get_color()
        elif name == "clear":
            got, want = p.get_color(), q.get_color()
        assert got == want, name
        if name == "clear":
            for w in (p, q):
                w.set_color("srgba(10,200,30,0.5)")


def test_wand_lifecycle():
    j, t = _rose_pair()
    w = call(t, "clone")
    v = j.clone()
    for name, args in [
        ("reset_iterator", ()), ("set_first_iterator", ()),
        ("set_last_iterator", ()), ("next_image", ()),
        ("previous_image", ()), ("has_next_image", ()),
        ("has_previous_image", ()),
    ]:
        assert call(w, name, *args) == getattr(v, name)(*args)
    assert len(w) == len(v) == 1
    assert call(w, "get_image_blob", "png") == v.get_image_blob("png")
    assert call(w, "get_images_blob", "gif") == v.get_images_blob("gif")
    buf = _io.BytesIO()
    call(w, "write_image_file", buf, "png")
    w2, v2 = MagickWand("cpu"), ja.MagickWand()
    for name, args in [("read_image_blob", (buf.getvalue(),)),
                       ("ping_image_blob", (buf.getvalue(),))]:
        call(w2, name, *args)
        getattr(v2, name)(*args)
    buf.seek(0)
    call(w2, "read_image_file", buf)
    buf.seek(0)
    v2.read_image_file(buf)
    _assert_same(v2, w2, EXACT)
    call(w2, "destroy_image")
    v2.destroy_image()
    _assert_same(v2, w2, EXACT)
    call(w2, "clear")
    assert len(w2) == 0


def test_attribute_pairs():
    j, t = _rose_pair()
    pairs = [
        ("compose", "multiply"), ("compression", "zip"),
        ("dispose", "background"), ("endian", "lsb"), ("filter", "catrom"),
        ("interlace_scheme", "plane"), ("interpolate_method", "bicubic"),
        ("rendering_intent", "relative"), ("units", "pixelsperinch"),
        ("virtual_pixel_method", "mirror"), ("filename", "x.png"),
        ("scene", 3), ("ticks_per_second", 60), ("gamma", 0.6),
        ("fuzz", 0.01),
    ]
    for key, val in pairs:
        call(t, f"set_image_{key}", val)
        getattr(j, f"set_image_{key}")(val)
        assert call(t, f"get_image_{key}") == getattr(j, f"get_image_{key}")()
    for key in ("background", "border", "matte"):
        call(t, f"set_image_{key}_color", "wheat")
        assert isinstance(call(t, f"get_image_{key}_color"), PixelWand)
    for prim in ("red", "green", "blue"):
        call(t, f"set_image_{prim}_primary", 0.6, 0.3)
        assert call(t, f"get_image_{prim}_primary")[0] == pytest.approx(0.6)
    call(t, "set_image_white_point", 0.31, 0.32)
    call(t, "get_image_white_point")
    steps = [("set_image_alpha", (0.8,), EXACT),
             ("set_image_matte", (True,), EXACT),
             ("set_image_extent", (80, 50), EXACT),
             ("set_image_color", ("beige",), EXACT),
             ("set_image_pixel_color", (0, 0, "red"), EXACT),
             ("set_image_type", ("grayscale",), EXACT),
             ("set_image_colorspace", ("gray",), EXACT)]
    _walk(j, t, steps)
    for name, args in [("comment_image", ("hi",)), ("label_image", ("rose",)),
                       ("set_image_channel_mask", (7,)),
                       ("set_image_progress_monitor", (lambda *a: True,))]:
        call(t, name, *args)
        getattr(j, name)(*args)
    assert t.current.properties == j.current.properties


def test_list_and_multiframe_ops():
    def two():
        j, t = _rose_pair()
        h, wd = j.current.height, j.current.width
        for w in (j, t):
            w.settings["size"] = f"{wd}x{h}"
            w.read_image("gradient:red-blue")
            del w.settings["size"]
        _assert_same(j, t, EXACT)
        return j, t

    j, t = two()
    CALLED.add("MagickWand.read_image")
    for name, args in [
        ("coalesce_images", ()), ("deconstruct_images", ()),
        ("compare_images_layers", ()), ("morph_images", (1,)),
        ("append_images", (False,)), ("smush_images", (False, 2)),
        ("evaluate_images", ("mean",)),
    ]:
        _assert_same(getattr(j, name)(*args), call(t, name, *args), EXACT)
    j, t = _rose_pair()
    for w in (j, t):
        w.read_image("rose:")
    _assert_same(j.polynomial_image([0.5, 1.0, 0.5, 1.0]),
                 call(t, "polynomial_image", [0.5, 1.0, 0.5, 1.0]), EXACT)
    j, t = _rose_pair()
    for w in (j, t):
        w.read_image("rose:")
    _assert_same(j.complex_images("magnitude-phase"),
                 call(t, "complex_images", "magnitude-phase"), RESAMPLE)
    j4, t4 = _rose_pair()
    _assert_same(j4.preview_images("gamma"),
                 call(t4, "preview_images", "gamma"), RESAMPLE)
    j5, t5 = _rose_pair()
    srcj, srct = ja.MagickWand(), MagickWand("cpu")
    for w, src in ((j5, srcj), (t5, srct)):
        w.read_image("xc:gray50")
        src.read_image("xc:red")
    _assert_same(j5, t5, EXACT)
    for name, args in [("composite_layers", ("over", 0, 0)),
                       ("composite_image_gravity", ("over", "center"))]:
        getattr(j5, name)(srcj, *args)
        call(t5, name, srct, *args)
        _assert_same(j5, t5, EXACT)
    for name, args in [("optimize_image_transparency", ()),
                       ("quantize_images", (8,))]:
        getattr(j5, name)(*args)
        call(t5, name, *args)
        _assert_same(j5, t5, EXACT)
    refj, reft = _rose_pair()
    assert call(t4, "get_image_distortions", reft, "rmse") == \
        pytest.approx(j4.get_image_distortions(refj, "rmse"), abs=1e-6)


def test_drawingwand_surface():
    d, e = DrawingWand(), ja.DrawingWand()
    ops = [
        ("set_fill_color", ("red",)), ("get_fill_color", ()),
        ("set_stroke_color", ("blue",)), ("get_stroke_color", ()),
        ("set_stroke_width", (2,)), ("get_stroke_width", ()),
        ("set_fill_opacity", (0.9,)), ("get_fill_opacity", ()),
        ("set_stroke_opacity", (0.8,)), ("get_stroke_opacity", ()),
        ("set_fill_rule", ("evenodd",)), ("get_fill_rule", ()),
        ("set_font", ("Helvetica",)), ("get_font", ()),
        ("set_font_size", (14,)), ("get_font_size", ()),
        ("set_font_family", ("sans",)), ("get_font_family", ()),
        ("set_font_stretch", ("condensed",)), ("get_font_stretch", ()),
        ("set_font_style", ("italic",)), ("get_font_style", ()),
        ("set_font_weight", (700,)), ("get_font_weight", ()),
        ("set_gravity", ("center",)), ("get_gravity", ()),
        ("set_opacity", (0.95,)), ("get_opacity", ()),
        ("set_border_color", ("gray",)), ("get_border_color", ()),
        ("set_clip_path", ("p1",)), ("get_clip_path", ()),
        ("set_clip_rule", ("nonzero",)), ("get_clip_rule", ()),
        ("set_clip_units", ("userspace",)), ("get_clip_units", ()),
        ("set_stroke_antialias", (True,)), ("get_stroke_antialias", ()),
        ("set_stroke_dash_array", ([2, 1],)), ("get_stroke_dash_array", ()),
        ("set_stroke_dash_offset", (1.0,)), ("get_stroke_dash_offset", ()),
        ("set_stroke_line_cap", ("round",)), ("get_stroke_line_cap", ()),
        ("set_stroke_line_join", ("bevel",)), ("get_stroke_line_join", ()),
        ("set_stroke_miter_limit", (4,)), ("get_stroke_miter_limit", ()),
        ("set_text_alignment", ("center",)), ("get_text_alignment", ()),
        ("set_text_antialias", (True,)), ("get_text_antialias", ()),
        ("set_text_decoration", ("underline",)), ("get_text_decoration", ()),
        ("set_text_direction", ("left-to-right",)),
        ("get_text_direction", ()),
        ("set_text_encoding", ("UTF-8",)), ("get_text_encoding", ()),
        ("set_text_interline_spacing", (1.0,)),
        ("get_text_interline_spacing", ()),
        ("set_text_interword_spacing", (1.0,)),
        ("get_text_interword_spacing", ()),
        ("set_text_kerning", (0.5,)), ("get_text_kerning", ()),
        ("set_text_under_color", ("yellow",)), ("get_text_under_color", ()),
        ("set_density", ("90",)), ("get_density", ()),
        ("set_viewbox", (0, 0, 100, 100)),
        ("push", ()), ("translate", (5, 5)), ("rotate", (10,)),
        ("scale", (1.1, 1.1)), ("skew_x", (2,)), ("skew_y", (2,)),
        ("affine", (1, 0, 0, 1, 0, 0)), ("pop", ()),
        ("push_defs", ()), ("pop_defs", ()),
        ("push_clip_path", ("c1",)), ("pop_clip_path", ()),
        ("push_pattern", ("pat", 0, 0, 8, 8)), ("pop_pattern", ()),
        ("set_fill_pattern_url", ("#pat",)),
        ("set_stroke_pattern_url", ("#pat",)),
        ("comment", ("scene",)),
        ("line", (0, 0, 10, 10)), ("rectangle", (1, 1, 8, 8)),
        ("round_rectangle", (1, 1, 9, 9, 2, 2)), ("circle", (5, 5, 8, 5)),
        ("ellipse", (5, 5, 4, 3)), ("arc", (0, 0, 10, 10, 0, 90)),
        ("polygon", ([(0, 0), (4, 0), (2, 3)],)),
        ("polyline", ([(0, 0), (4, 1), (8, 0)],)),
        ("bezier", ([(0, 0), (3, 5), (6, 0)],)),
        ("point", (3, 3)), ("text", (2, 8, "hi")),
        ("color", (1, 1, "point")), ("matte", (1, 1, "point")),
        ("composite", ("over", 0, 0, 4, 4, None)),
        ("path", ("M 0,0 L 4,4",)),
        ("path_start", ()), ("path_move_to_absolute", (0, 0)),
        ("path_move_to_relative", (1, 1)),
        ("path_line_to_absolute", (5, 5)), ("path_line_to_relative", (1, 0)),
        ("path_line_to_horizontal_absolute", (7,)),
        ("path_line_to_horizontal_relative", (1,)),
        ("path_line_to_vertical_absolute", (7,)),
        ("path_line_to_vertical_relative", (1,)),
        ("path_curve_to_absolute", (1, 1, 2, 2, 3, 3)),
        ("path_curve_to_relative", (1, 1, 2, 2, 3, 3)),
        ("path_curve_to_quadratic_bezier_absolute", (1, 1, 2, 2)),
        ("path_curve_to_quadratic_bezier_relative", (1, 1, 2, 2)),
        ("path_curve_to_smooth_absolute", (2, 2, 3, 3)),
        ("path_curve_to_smooth_relative", (2, 2, 3, 3)),
        ("path_curve_to_quadratic_bezier_smooth_absolute", (4, 4)),
        ("path_curve_to_quadratic_bezier_smooth_relative", (1, 1)),
        ("path_elliptic_arc_absolute", (3, 3, 0, 0, 1, 6, 6)),
        ("path_elliptic_arc_relative", (3, 3, 0, 0, 1, 1, 1)),
        ("path_close", ()), ("path_finish", ()),
        ("get_vector_graphics", ()), ("render", ()),
        ("get_exception", ()), ("get_exception_type", ()),
        ("clear_exception", ()), ("reset_vector_graphics", ()),
        ("rectangle", (2, 2, 9, 9)), ("path", ("M 1,1 L 5,5",)),
    ]
    for name, args in ops:
        got, want = call(d, name, *args), getattr(e, name)(*args)
        if isinstance(want, ja.PixelWand):
            got, want = got.get_color(), want.get_color()
        assert got == want, name
    assert call(d, "clone").get_mvg() == e.clone().get_mvg()
    mvg = d.get_mvg()
    CALLED.add("DrawingWand.get_mvg")
    assert mvg == e.get_mvg()
    assert "rectangle" in mvg and "path" in mvg
    # render through an image
    j, t = _rose_pair()
    j.draw_image(e)
    call(t, "draw_image", d)
    _assert_same(j, t, EXACT)
    for w in (d, e):
        w.clear()
        w.set_vector_graphics("circle 10,10 14,10")
    CALLED.update({"DrawingWand.clear", "DrawingWand.set_vector_graphics"})
    j.draw_image(e)
    t.draw_image(d)
    _assert_same(j, t, EXACT)


def test_views_and_iterators():
    j, t = _rose_pair()
    it, jt = PixelIterator(t), ja.PixelIterator(j)
    CALLED.add("PixelIterator.__init__")
    row, jrow = call(it, "get_next_row"), jt.get_next_row()
    assert [p.get_color() for p in row] == [p.get_color() for p in jrow]
    for name in ("reset", "set_first_iterator_row", "set_last_iterator_row",
                 "get_iterator_row", "get_current_iterator_row",
                 "get_previous_row", "clear", "get_exception",
                 "get_exception_type", "clear_exception"):
        got, want = call(it, name), getattr(jt, name)()
        if isinstance(want, list):
            got = [p.get_color() for p in got]
            want = [p.get_color() for p in want]
        assert got == want, name
    view, jview = WandView(t, 0, 0, 16, 16), ja.WandView(j, 0, 0, 16, 16)
    CALLED.add("WandView.__init__")
    call(view, "update", lambda region: region * 0.5)
    jview.update(lambda region: region * 0.5)
    _assert_same(j, t, EXACT)
    for name in ("get_extent", "get_exception"):
        assert call(view, name) == getattr(jview, name)()
    assert call(view, "get_wand") is t
    call(view, "update_iterator", lambda region: 1.0 - region)
    jview.update_iterator(lambda region: 1.0 - region)
    _assert_same(j, t, EXACT)


def test_property_methods():
    """magick-property.c exports: wand-level settings pairs."""
    j, t = _rose_pair()
    pairs = [
        ("antialias", True), ("colorspace", "lab"), ("compression", "zip"),
        ("filename", "f.png"), ("filter", "catrom"), ("format", "png"),
        ("interlace_scheme", "plane"), ("interpolate_method", "bicubic"),
        ("orientation", "topleft"), ("pointsize", 14.0),
        ("type", "truecolor"), ("size_offset", 3),
    ]
    for key, val in pairs:
        call(t, f"set_{key}", val)
        getattr(j, f"set_{key}")(val)
        assert call(t, f"get_{key}") == getattr(j, f"get_{key}")()
    for name, args in [("set_resolution", (90.0,)), ("get_resolution", ()),
                       ("set_size", (12, 34)), ("get_size", ()),
                       ("set_page", (64, 64, 1, 2)), ("get_page", ()),
                       ("set_sampling_factors", ([2, 1, 1],)),
                       ("get_sampling_factors", ()),
                       ("set_option", ("jpeg:size", "128x128")),
                       ("get_option", ("jpeg:size",)), ("get_options", ()),
                       ("delete_option", ("jpeg:size",)),
                       ("set_image_artifact", ("compose:args", "40")),
                       ("get_image_artifact", ("compose:args",)),
                       ("get_image_artifacts", ()),
                       ("delete_image_artifact", ("compose:args",)),
                       ("get_image_profiles", ()), ("set_depth", (16,)),
                       ("set_extract", ("8x8+0+0",)),
                       ("set_passphrase", ("pw",)), ("set_seed", (42,)),
                       ("get_resource", ("memory",)),
                       ("get_resource_limit", ("area",)),
                       ("get_quantum_depth", ()), ("get_quantum_range", ()),
                       ("get_release_date", ()), ("get_home_url", ())]:
        assert call(t, name, *args) == getattr(j, name)(*args), name
    assert t.settings == j.settings
    from imagemagick_tpu.core.resource import resources as jres
    from imagemagick_tpu_torch.core.resource import resources as tres

    keep = tres.get_limit("area"), jres.get_limit("area")
    try:
        call(t, "set_resource_limit", "area", "1GP")
        j.set_resource_limit("area", "1GP")
        assert tres.get_limit("area") == jres.get_limit("area") != keep[0]
    finally:
        tres.set_limit("area", keep[0])
        jres.set_limit("area", keep[1])
    for name in ("get_version", "get_copyright", "get_package_name"):
        assert "imagemagick_tpu_torch" in str(call(t, name))


def test_zz_surface_count():
    """>= 250 distinct wand-layer methods exercised across this module
    (its tests in one process, as ``--dist loadfile`` runs them, like the
    JAX file's)."""
    assert len(CALLED) >= 250, (len(CALLED), sorted(CALLED)[:20])
