"""Port parity: ``wand/cpp_support.py``, the helpers under the Magick++
layer, against the JAX module.

Every public function of the JAX module has a case: the same call on a
JAX wand and a port wand (``device="cpu"``) over the same seeded images
(``torch_wand_pairs``), then what comes back and the images the wands hold
are compared, within the bound of the op's own parity test (stated per
case: EXACT, FUNC, RESAMPLE), and a returned wand's images as well.
Numbers read back from the statistics are held as
``tests/test_torch_statistic.py`` holds them (1e-5 relative, 1e-4 for
skewness and kurtosis; the invariants within 1e-5 of their largest).
The sequence helpers keep the CPU: every wand they make is on the device
of the wand they were given, or on the ``device`` the caller names.
"""

import inspect

import numpy as np
import pytest
import torch

from imagemagick_tpu.wand import api as ja
from imagemagick_tpu.wand import cpp_support as jcs
from imagemagick_tpu_torch.wand import api as ta
from imagemagick_tpu_torch.wand import cpp_support as tcs

from torch_format_faults import RECORDED_FORMATS
from torch_wand_pairs import (EXACT, FUNC, RESAMPLE, _arrays, _assert_same,
                              _img, _pair)

A = _img()
B = _img(seed=11)
S = _img(16, 20, seed=3)
STAT_REL, MOMENT_REL, PHASH_EXACT = 1e-5, 1e-5, 0.0
SKEW_REL = 1e-4
SCORE_REL = 1e-4        # a float32 FFT correlation's peak in another order


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and inspect.isfunction(v)
            and v.__module__ == module.__name__}


def test_public_names_match_jax():
    assert _public(tcs) == _public(jcs)
    assert len(_public(jcs)) == 55


def _check_value(rj, rt, rel=0.0):
    """Equal values (numbers within ``rel`` where given); a wand or a list
    of wands compared image by image."""
    if isinstance(rj, ja.MagickWand):
        assert isinstance(rt, ta.MagickWand)
        assert rt.device.type == "cpu"
        _assert_same(rj, rt, EXACT)
    elif isinstance(rj, (list, tuple)):
        assert type(rj) is type(rt) and len(rj) == len(rt)
        for a, b in zip(rj, rt):
            _check_value(a, b, rel)
    elif isinstance(rj, float) and rel:
        assert rt == pytest.approx(rj, rel=rel, abs=rel)
    else:
        assert type(rt) is type(rj) and rt == rj


# (id, call(module, wand, other wand), bound for the images, bound for
# the values); the other wand holds S
CASES = [
    ("parse_color_rgba", lambda m, w, o: m.parse_color_rgba("DarkOrange"),
     EXACT, 0.0),
    ("parse_color_rgba_alpha",
     lambda m, w, o: m.parse_color_rgba("rgba(10,20,30,0.4)"), EXACT, 0.0),
    ("resolve_meta_geometry",
     lambda m, w, o: m.resolve_meta_geometry(w, "50%x25%+3+4"), EXACT, 0.0),
    ("resolve_meta_geometry_aspect",
     lambda m, w, o: m.resolve_meta_geometry(w, "30x30"), EXACT, 0.0),
    ("parse_geometry_raw",
     lambda m, w, o: m.parse_geometry_raw("120x80+5-7!"), EXACT, 0.0),
    ("gravity_offset",
     lambda m, w, o: [m.gravity_offset(g, 64, 48, 20, 16) for g in
                      ("northwest", "north", "northeast", "west", "center",
                       "east", "southwest", "south", "southeast",
                       "undefined", None)], EXACT, 0.0),
    ("composite_gravity",
     lambda m, w, o: m.composite_gravity(w, o, "over", "southeast"),
     EXACT, 0.0),
    ("extent_gravity",
     lambda m, w, o: m.extent_gravity(w, 80, 60, "center"), EXACT, 0.0),
    ("extent_gravity_background",
     lambda m, w, o: m.extent_gravity(w, 70, 52, "east", "navy"),
     EXACT, 0.0),
    ("annotate",
     lambda m, w, o: m.annotate(w, "Hi", "+2+2", "northwest", 10.0, None),
     EXACT, 0.0),
    ("annotate_gravity",
     lambda m, w, o: m.annotate(w, "ab", "", "south", 12.0, None),
     EXACT, 0.0),
    ("bounding_box", lambda m, w, o: m.bounding_box(w), EXACT, 0.0),
    ("export_rgba_f32",
     lambda m, w, o: m.export_rgba_f32(w, 1, 2, 7, 5), EXACT, 0.0),
    ("import_rgba_f32",
     lambda m, w, o: m.import_rgba_f32(
         w, 3, 4, 5, 2, np.linspace(0, 1, 40, dtype=np.float32).tobytes()),
     EXACT, 0.0),
    ("export_map_char",
     lambda m, w, o: m.export_map(w, "char", "BGR"), EXACT, 0.0),
    ("export_map_short",
     lambda m, w, o: m.export_map(w, "short", "RGBA"), EXACT, 0.0),
    ("export_map_double",
     lambda m, w, o: m.export_map(w, "double", "I"), EXACT, 0.0),
    ("import_map",
     lambda m, w, o: m.import_map(
         w, "char", "RGB",
         (np.arange(48 * 64 * 3) % 251).astype(np.uint8).tobytes()),
     EXACT, 0.0),
    ("compare_stats", lambda m, w, o: m.compare_stats(w, w.clone()),
     EXACT, 0.0),
    ("convolve",
     lambda m, w, o: m.convolve(w, 3, "0,1,0,1,-4,1,0,1,0"), EXACT, 0.0),
    ("color_matrix",
     lambda m, w, o: m.color_matrix(w, 3, "0.5,0.3,0.2,0.1,0.8,0.1,"
                                    "0.2,0.2,0.6"), EXACT, 0.0),
    ("distort",
     lambda m, w, o: m.distort(w, "srt", "0.9,10", False), RESAMPLE, 0.0),
    ("distort_bestfit",
     lambda m, w, o: m.distort(w, "srt", "0.9,10", True), RESAMPLE, 0.0),
    ("affine_transform",
     lambda m, w, o: m.affine_transform(w, "1,0.1,0,1,2,3"), RESAMPLE, 0.0),
    ("gamma_rgb", lambda m, w, o: m.gamma_rgb(w, 1.2, 0.8, 2.2), FUNC, 0.0),
    ("merge_layers_flatten",
     lambda m, w, o: m.merge_layers(w, "flatten"), EXACT, 0.0),
    ("merge_layers_mosaic",
     lambda m, w, o: m.merge_layers(w, "mosaic"), EXACT, 0.0),
    ("set_setting",
     lambda m, w, o: (m.set_setting(w, "size", "20x10"), w.settings),
     EXACT, 0.0),
    ("image_region_colors", lambda m, w, o: m.image_region_colors(w),
     EXACT, 0.0),
    ("stegano", lambda m, w, o: m.stegano(w, o, 0), EXACT, 0.0),
    ("stegano_offset", lambda m, w, o: m.stegano(w, o, 5), EXACT, 0.0),
    ("stereo", lambda m, w, o: m.stereo(w, w.clone()), EXACT, 0.0),
    ("texture", lambda m, w, o: m.texture(w, o), EXACT, 0.0),
    ("connected_components",
     lambda m, w, o: m.connected_components(w, 4), EXACT, 0.0),
    ("apply_channel_red",
     lambda m, w, o: m.apply_channel(w, "red", "negate_image", False),
     EXACT, 0.0),
    ("apply_channel_two",
     lambda m, w, o: m.apply_channel(w, "green,blue", "threshold_image",
                                     0.5), EXACT, 0.0),
    ("apply_channel_all",
     lambda m, w, o: m.apply_channel(w, "all", "negate_image", False),
     EXACT, 0.0),
    ("apply_channel_resize",
     lambda m, w, o: m.apply_channel(w, "red", "sample_image", 20, 10),
     EXACT, 0.0),
    ("erase", lambda m, w, o: (w.set_image_background_color("blue"),
                               m.erase(w))[1], EXACT, 0.0),
    ("is_opaque", lambda m, w, o: m.is_opaque(w), EXACT, 0.0),
    ("transparent_chroma",
     lambda m, w, o: m.transparent_chroma(w, "rgb(0,0,0)",
                                          "rgb(200,160,255)"), EXACT, 0.0),
    ("transparent_chroma_invert",
     lambda m, w, o: m.transparent_chroma(w, "rgb(100,0,0)", "white", 0.25,
                                          True), EXACT, 0.0),
    ("copy_pixels",
     lambda m, w, o: m.copy_pixels(w, o, "8x6+2+3", 40, 30), EXACT, 0.0),
    ("copy_pixels_whole",
     lambda m, w, o: m.copy_pixels(w, o, "", 55, 40), EXACT, 0.0),
    ("format_expression",
     lambda m, w, o: m.format_expression(w, "%wx%h %[colorspace]"),
     EXACT, 0.0),
    ("statistics", lambda m, w, o: m.statistics(w), EXACT, STAT_REL),
    ("moments", lambda m, w, o: m.moments(w), EXACT, None),
    ("perceptual_hash", lambda m, w, o: m.perceptual_hash(w), EXACT, 0.0),
    ("type_metrics", lambda m, w, o: m.type_metrics(w, "Hello"), EXACT, 0.0),
    ("type_metrics_multiline",
     lambda m, w, o: m.type_metrics(w, "Hi\nthere", True), EXACT, 0.0),
    ("identify_type", lambda m, w, o: m.identify_type(w), EXACT, 0.0),
    ("channel_count", lambda m, w, o: m.channel_count(w), EXACT, 0.0),
    ("sparse_color_flat",
     lambda m, w, o: m.sparse_color_flat(
         w, "shepards", [5, 5, 1, 0, 0, 50, 10, 0, 1, 0, 20, 40, 0, 0, 1]),
     RESAMPLE, 0.0),
]


@pytest.mark.parametrize("name,call,bound,rel", CASES,
                         ids=[c[0] for c in CASES])
def test_helper_matches_jax(name, call, bound, rel):
    j, t = _pair(A)
    oj, ot = _pair(S)
    rj, rt = call(jcs, j, oj), call(tcs, t, ot)
    if name == "moments":
        rows_j, rows_t = np.array([r[1:] for r in rj]), \
            np.array([r[1:] for r in rt])
        assert [r[0] for r in rt] == [r[0] for r in rj]
        np.testing.assert_allclose(rows_t[:, :3], rows_j[:, :3],
                                   rtol=MOMENT_REL)
        scale = np.abs(rows_j[:, 3:]).max()
        np.testing.assert_allclose(rows_t[:, 3:], rows_j[:, 3:],
                                   atol=MOMENT_REL * scale)
    elif name == "statistics":
        assert [r[0] for r in rt] == [r[0] for r in rj]
        for a, b in zip(rj, rt):
            np.testing.assert_allclose(b[1:6] + b[8:], a[1:6] + a[8:],
                                       rtol=STAT_REL, atol=STAT_REL)
            np.testing.assert_allclose(b[6:8], a[6:8], rtol=SKEW_REL,
                                       atol=SKEW_REL)
    else:
        _check_value(rj, rt, rel)
    _assert_same(j, t, bound)
    assert all(im.data.device.type == "cpu" for im in t.images)


def test_gamma_rgb_takes_the_power_in_float64():
    """gamma_rgb's samples are the float64 power of the float32 input and
    the JAX module's float32 exponent, rounded: what the card computes
    too, since float64 is correctly rounded on both."""
    _, t = _pair(A)
    tcs.gamma_rgb(t, 1.2, 0.8, 2.2)
    inv = 1.0 / np.asarray([1.2, 0.8, 2.2], np.float32)
    want = np.power(np.maximum(A, np.float32(1e-12)).astype(np.float64),
                    inv.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_arrays(t)[0], want)


def test_sub_image_search_matches_jax():
    """The best offset equal, its score within SCORE_REL."""
    hay = np.zeros((24, 32, 3), np.float32)
    patch = A[10:16, 20:28].copy()
    hay[9:15, 13:21] = patch
    j, t = _pair(hay)
    pj, pt = _pair(patch)
    (xj, yj, sj), (xt, yt, st) = jcs.sub_image_search(j, pj), \
        tcs.sub_image_search(t, pt)
    assert (xt, yt) == (xj, yj)
    assert st == pytest.approx(sj, rel=SCORE_REL)


def test_display_writes_the_same_sixel(monkeypatch, capfdbinary):
    """On 16 flat colours, where the sixel's k-means palette is the JAX
    one (``tests/test_torch_io_coders.py``)."""
    from test_torch_io_coders import _flat_colours

    monkeypatch.setenv("IMTPU_SIXEL", "1")
    j, t = _pair(_flat_colours(16, 13))
    jcs.display(j)
    out_j = capfdbinary.readouterr().out
    tcs.display(t)
    out_t = capfdbinary.readouterr().out
    assert out_j.startswith(b"\x1bP") and out_t == out_j


def test_display_is_silent_off_a_terminal(monkeypatch, capfdbinary):
    monkeypatch.delenv("IMTPU_SIXEL", raising=False)
    _, t = _pair(S)
    tcs.display(t)
    assert capfdbinary.readouterr().out == b""


def test_ping_matches_jax(tmp_path):
    j, t = _pair(A)
    path = str(tmp_path / "a.ppm")
    j.write_image(path)
    wj, wt = ja.MagickWand(), ta.MagickWand("cpu")
    jcs.ping(wj, path)
    tcs.ping(wt, path)
    assert (wt.get_image_width(), wt.get_image_height()) == \
        (wj.get_image_width(), wj.get_image_height()) == (64, 48)


def test_resource_limits_match_jax():
    from imagemagick_tpu.core.resource import resources as jr
    from imagemagick_tpu_torch.core.resource import resources as tr

    old_j, old_t = jr.get_limit("width"), tr.get_limit("width")
    try:
        jcs.set_resource_limit("width", 1 << 20)
        tcs.set_resource_limit("width", 1 << 20)
        assert tcs.get_resource_limit("width") == \
            jcs.get_resource_limit("width") == float(1 << 20)
        assert tcs.get_resource_limit("memory") == \
            jcs.get_resource_limit("memory")
    finally:
        jr.set_limit("width", old_j)
        tr.set_limit("width", old_t)


def test_coder_list_matches_jax_but_its_recorded_faults():
    """The same (format, readable, writable) rows but for the names the
    JAX lists get wrong (``tests/torch_format_faults.py``)."""
    def rows(m):
        return {r for r in m.coder_list() if r[0].upper()
                not in RECORDED_FORMATS}

    assert rows(tcs) == rows(jcs)
    assert ("png", True, True) in rows(tcs)


def _frames():
    return [(_img(12, 10, seed=s), _img(12, 10, seed=s)) for s in (1, 2, 3)]


def _seq_pairs():
    js, ts = [], []
    for a, _ in _frames():
        j, t = _pair(a)
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.mark.parametrize("name,args,bound", [
    ("seq_append", (False,), EXACT),
    ("seq_append", (True,), EXACT),
    ("seq_average", (), FUNC),    # evaluate_images' bound (1e-6)
    ("seq_flatten", (), EXACT),
    ("seq_mosaic", (), EXACT),
    ("seq_coalesce", (), EXACT),
    ("seq_deconstruct", (), EXACT),
    ("seq_morph", (1,), EXACT),
    ("seq_morph", (3,), EXACT),
    ("seq_montage", ("", "12x12+1+1"), RESAMPLE),
])
def test_sequence_helper_matches_jax_on_the_cpu(name, args, bound):
    js, ts = _seq_pairs()
    rj, rt = getattr(jcs, name)(js, *args), getattr(tcs, name)(ts, *args)
    if isinstance(rj, list):
        assert len(rt) == len(rj)
        pairs = list(zip(rj, rt))
    else:
        pairs = [(rj, rt)]
    for a, b in pairs:
        assert b.device.type == "cpu"
        assert all(im.data.device.type == "cpu" for im in b.images)
        _assert_same(a, b, bound)


def test_seq_split_and_read_write_keep_the_cpu(tmp_path):
    js, ts = _seq_pairs()
    path = str(tmp_path / "seq.miff")
    jcs.seq_write(js, path, True, 92)
    back_j = jcs.seq_read(path)
    tpath = str(tmp_path / "tseq.miff")
    tcs.seq_write(ts, tpath, True, 92)
    assert open(tpath, "rb").read() == open(path, "rb").read()
    back_t = tcs.seq_read(path, device="cpu")
    assert len(back_t) == len(back_j) == 3
    for a, b in zip(back_j, back_t):
        assert b.device.type == "cpu" and \
            b.current.data.device.type == "cpu"
        _assert_same(a, b, EXACT)
    merged_j, merged_t = jcs._gather(js), tcs._gather(ts)
    split_j, split_t = jcs.seq_split(merged_j), tcs.seq_split(merged_t)
    assert [w.device.type for w in split_t] == ["cpu"] * 3
    for a, b in zip(split_j, split_t):
        _assert_same(a, b, EXACT)
    assert tcs._gather([], device="cpu").device.type == "cpu"


def test_seq_read_defaults_to_the_card(tmp_path):
    """seq_read, with no wand to take a device from, lands on the card by
    default, as the library does: without one it raises, never reading
    onto the CPU."""
    _, t = _pair(S)
    path = str(tmp_path / "s.ppm")
    t.write_image(path)
    if torch.cuda.is_available():
        assert tcs.seq_read(path)[0].current.data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcs.seq_read(path)
