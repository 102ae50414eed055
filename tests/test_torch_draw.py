"""Port parity: ops/draw.py against the JAX package.

The rasterizer runs in float64 on the image's device, each arithmetic
step its own op, so its coverage is the JAX function's numpy coverage:
every MVG program here is held within 1e-6 of the JAX ``draw`` (they
agree to the bit on these inputs), on an RGB and an RGBA canvas, and on
a batch against each image alone.  The fixtures follow the JAX package's
own tests (``test_draw_layers.py``, ``test_draw_strokes.py``,
``test_text_shaping.py``): every primitive family, both fill rules,
gradients, patterns, clip paths, dashes, caps, joins, the miter limit,
paint methods, text and the raqm direction.  The host geometry (the SVG
path parser, dashes, stroke outlines) is held equal; the rasterizer is
also held equal with its chunks cut small.  The exact-distance ellipse
is float32 Newton steps with the card's or the CPU's transcendentals:
within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import draw as jd
from imagemagick_tpu_torch.ops import draw as td

TOL = 1e-6


def _canvas(c=3, h=40, w=64, seed=None):
    if seed is None:
        return np.ones((h, w, c), np.float32)
    return np.random.default_rng(seed).uniform(0, 1, (h, w, c)) \
        .astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


STAR = "polygon 16,2 20,30 2,10 30,10 12,30"
MVGS = [
    "fill 'red' rectangle 8,8 24,24",
    "fill 'black' circle 16,16 16,24",
    "stroke 'blue' stroke-width 2 line 4,16 28,16",
    "fill 'black' line 4,16 28,20",
    f"fill 'black' fill-rule nonzero {STAR}",
    f"fill 'black' fill-rule evenodd {STAR}",
    "fill 'green' path 'M 4,4 L 28,4 L 28,28 L 4,28 Z'",
    "fill none stroke red stroke-width 1.5 bezier 4,30 16,2 28,30 40,10",
    "translate 10,5 scale 1.5,1.2 rotate 10 fill blue rectangle 2,2 14,10",
    "affine 1,0.2,0.1,1,3,2 fill navy polygon 5,5 30,8 20,30",
    "fill 'black' font-size 14 text 4,20 'Hi'",
    "push defs push gradient g1 linear 0,0 31,0 stop-color red 0 "
    "stop-color blue 1 pop gradient pop defs fill 'url(#g1)' "
    "rectangle 0,0 40,30",
    "push defs push gradient g2 radial 30,20 50,20 stop-color white "
    "stop-color yellow stop-color black pop gradient pop defs "
    "fill 'url(#g2)' stroke 'url(#g2)' stroke-width 3 circle 30,20 30,35",
    "push defs push pattern pat0 0 0 4 4 fill black rectangle 0,0 1,1 "
    "pop pattern pop defs fill 'url(#pat0)' rectangle 2,2 30,30",
    "stroke black stroke-width 3 fill none stroke-dasharray 8 6 "
    "line 4,20 60,20",
    "stroke black stroke-width 8 fill none stroke-linecap butt "
    "line 20,20 44,20",
    "stroke black stroke-width 8 fill none stroke-linecap square "
    "line 20,20 44,20",
    "stroke black stroke-width 8 fill none stroke-linecap round "
    "line 20,20 44,20",
    "stroke black stroke-width 8 fill none stroke-linejoin miter "
    "polyline 10,30 30,8 50,30",
    "stroke black stroke-width 8 fill none stroke-linejoin round "
    "polyline 10,30 30,8 50,30",
    "stroke black stroke-width 8 fill none stroke-linejoin bevel "
    "polyline 10,30 30,8 50,30",
    "stroke black stroke-width 6 fill none stroke-linejoin miter "
    "stroke-miterlimit 1.2 polyline 8,20 40,20 8,24",
    "push defs push clip-path clip1 push graphic-context "
    "rectangle 8,8 32,32 pop graphic-context pop clip-path pop defs "
    "clip-path url(#clip1) fill red rectangle 0,0 63,39 "
    "stroke blue stroke-width 3 fill none line 0,36 63,36",
    "push defs push clip-path c2 push graphic-context "
    "rectangle 0,0 10,10 pop graphic-context pop clip-path pop defs "
    "push graphic-context clip-path url(#c2) "
    "fill black rectangle 0,0 63,39 pop graphic-context "
    "fill black rectangle 30,30 34,34",
    "push defs push clip-path c3 circle 20,20 20,34 pop clip-path pop defs "
    "clip-path url(#c3) fill black font-size 18 text 2,26 'Clip'",
    "fill red stroke navy stroke-width 2 roundrectangle 5,5 50,30 8,6",
    "fill yellow stroke black ellipse 30,20 20,10 0,360",
    "fill none stroke black stroke-width 2 arc 5,5 55,35 30,270",
    "fill orange stroke black path 'M 10 10 C 20 0 40 0 50 10 S 60 30 40 35 "
    "Q 30 38 20 30 T 10 20 A 8 6 30 1 0 10 10 z'",
    "fill teal path 'm 5,5 h 20 v 10 h -20 z M 40 5 l 10 0 l -5 12 Z'",
    "fill red point 5,5 point 10,7",
    "fill red color 5,5 floodfill",
    "fill red color 5,5 filltoborder",
    "fill red color 5,5 replace",
    "fill blue color 5,5 reset",
    "fill green color 7,3 point",
    "stroke-dasharray 5 3 2 stroke-dashoffset 4 stroke green "
    "stroke-width 2 fill none polygon 5,5 50,8 40,35 8,30",
    "fill-opacity 0.5 stroke-opacity 0.7 fill red stroke blue "
    "stroke-width 4 circle 30,20 30,30",
    "stroke black stroke-width 0.5 fill none polyline 2,2 60,38 2,38",
    "push graphic-context fill red rectangle 2,2 20,20 pop graphic-context "
    "rectangle 30,2 50,20",
    "fill 'rgba(0,0,255,0.4)' stroke-dasharray none stroke black "
    "stroke-width 12 stroke-linejoin round stroke-linecap round "
    "polyline 8,30 24,8 40,30 56,8",
    "viewbox 0 0 64 40 fill black kerning 1 encoding UTF-8 rectangle 1,1 9,9",
]


@pytest.mark.parametrize("mvg", MVGS, ids=range(len(MVGS)))
@pytest.mark.parametrize("c,seed", [(3, None), (4, 1)])
def test_draw_equals_jax(mvg, c, seed):
    x = _canvas(c, seed=seed)
    _close(td.draw(torch.from_numpy(x), mvg),
           jd.draw(jnp.asarray(x), mvg))


@pytest.mark.parametrize("mvg", [
    "fill red matte 5,5 floodfill", "fill 'rgba(0,0,0,0.3)' matte 5,5 replace",
    "fill none alpha 5,5 reset", "fill red matte 5,5 point"])
def test_alpha_paint_methods_equal_jax(mvg):
    x = np.round(_canvas(4, seed=2) * 2) / 2
    _close(td.draw(torch.from_numpy(x), mvg, fuzz=0.1),
           jd.draw(jnp.asarray(x), mvg, fuzz=0.1))


@pytest.mark.parametrize("mvg", [MVGS[1], MVGS[14], MVGS[27], MVGS[31]],
                         ids=range(4))
def test_draw_on_a_batch_draws_each_image(mvg):
    x = np.stack([_canvas(3, seed=3), _canvas(3, seed=4)])
    got = td.draw(torch.from_numpy(x), mvg)
    for i in range(2):
        _close(got[i], jd.draw(jnp.asarray(x[i]), mvg))


@pytest.mark.parametrize("mvg", [MVGS[1], MVGS[19], MVGS[27], MVGS[28]],
                         ids=range(4))
def test_draw_in_small_chunks_equals_jax(monkeypatch, mvg):
    monkeypatch.setattr(td, "_CELLS", 64)
    monkeypatch.setattr(td, "_RAMP_CELLS", 64)
    x = _canvas(3)
    _close(td.draw(torch.from_numpy(x), mvg), jd.draw(jnp.asarray(x), mvg))


@pytest.mark.parametrize("rule", ["nonzero", "evenodd"])
@pytest.mark.parametrize("pts", [
    [(16, 2), (20, 30), (2, 10), (30, 10), (12, 30)],
    [(0.5, 0.5), (30.25, 3.75), (10.5, 25.5)],
    [(-5, -5), (70, 10), (20, 50)], [(3, 3), (3, 3)]], ids=range(4))
def test_polygon_coverage_equals_jax(rule, pts):
    _close(td.polygon_coverage(40, 64, pts, rule, device="cpu"),
           jd.polygon_coverage(40, 64, pts, rule))


@pytest.mark.parametrize("width", [0.5, 2.0, 3.0, 9.0])
@pytest.mark.parametrize("cap,join", [("butt", "miter"), ("round", "round"),
                                      ("square", "bevel"), ("round", "miter")])
@pytest.mark.parametrize("closed", [False, True])
def test_stroke_coverage_equals_jax(width, cap, join, closed):
    pts = [(8, 30), (24, 8), (40, 30), (56, 12)]
    _close(td.stroke_coverage(40, 64, pts, width, closed, cap, join,
                              device="cpu"),
           jd.stroke_coverage(40, 64, pts, width, closed, cap, join))


@pytest.mark.parametrize("d", [
    "M 4,4 L 28,4 L 28,28 L 4,28 Z",
    "m 10 10 c 5 -10 20 -10 25 0 s 10 20 -5 25 q -10 3 -15 -5 t -5 -10 z",
    "M 10 10 A 8 6 30 1 0 30 20 a 5 5 0 0 1 10 0 H 50 V 30 h -5 v -5 Z",
    "M 1 2 3 4 5 6 m 1 1 2 2 L 9e0 1e1"])
def test_parse_svg_path_equals_jax(d):
    assert td.parse_svg_path(d) == jd.parse_svg_path(d)


@pytest.mark.parametrize("dash,offset,closed", [
    ([8, 6], 0.0, False), ([5, 3, 2], 4.0, True), ([0, 0], 0.0, False),
    ([1], 2.5, False)])
def test_dash_polyline_equals_jax(dash, offset, closed):
    pts = [(4, 20), (60, 20), (60, 35), (10, 35)]
    assert td.dash_polyline(pts, dash, offset, closed) == \
        jd.dash_polyline(pts, dash, offset, closed)


def test_ellipse_coverage_and_exact_ellipse_equal_jax():
    _close(td.ellipse_coverage(40, 64, 30.3, 20.1, 20, 10, device="cpu"),
           jd.ellipse_coverage(40, 64, 30.3, 20.1, 20, 10))
    _close(td.ellipse_fill_stroke_alpha(40, 64, 30.3, 20.1, 20, 10, 1.5,
                                        device="cpu"),
           jd.ellipse_fill_stroke_alpha(40, 64, 30.3, 20.1, 20, 10, 1.5),
           tol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_coverage_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.polygon_coverage(4, 4, [(0, 0), (3, 0), (3, 3)])


@pytest.mark.parametrize("text,size,direction", [
    ("Hi", 14, None), ("Hello, world", 24, None), ("g_y|", 9.6, None),
    ("abc שלום def", 24, "right-to-left"),
    ("سلام", 32, None)])
def test_render_text_mask_equals_jax(text, size, direction):
    got, asc = td.render_text_mask(text, None, size, direction=direction)
    want, wasc = jd.render_text_mask(text, None, size, direction=direction)
    assert asc == wasc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gravity", ["northwest", "center", "southeast",
                                     "north", "west"])
def test_annotate_equals_jax(gravity):
    x = _canvas(3)
    _close(td.annotate(torch.from_numpy(x), "X", 2, 3, (0, 0, 0, 1), 10,
                       gravity=gravity),
           jd.annotate(jnp.asarray(x), "X", 2, 3, (0, 0, 0, 1), 10,
                       gravity=gravity))


def test_mvg_direction_keyword_equals_jax():
    x = _canvas(3, 40, 160)
    for d in ("left-to-right", "right-to-left"):
        mvg = f"direction {d} fill black font-size 18 text 4,26 " \
            "'abc שלום'"
        _close(td.draw(torch.from_numpy(x), mvg),
               jd.draw(jnp.asarray(x), mvg))


def test_type_metrics_and_font_equal_jax():
    assert td.get_type_metrics("Hello", size=16) == \
        jd.get_type_metrics("Hello", size=16)
    assert td.loaded_font(None, 16) in td._FONT_PATHS + ("PIL default",)
