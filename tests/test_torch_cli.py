"""Port parity: the CLI's options against the JAX CLI.

The tags that ``process`` queues must equal the JAX CLI's for the same
arguments.  On the CPU the JAX CLI runs its chains as XLA ops, which clip
after every op, while the port's fused route (K1's plain version here)
clips once at the end: the route gate is >= 60 dB.  The JAX CLI jits
each chain, so XLA may contract a product and a sum into one rounding:
a value at a threshold or a histogram bin edge can move by an ulp, so a
0/1 output (the thresholds, the ordered dither) is held to at most 0.1 %
of its values differing, and a continuous one to the 60 dB gate.  The
random threshold's values come from torch's generator, not JAX's PRNG:
it is held to 0/1 values and a binomial bound instead."""

import importlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.core.color import parse_color
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
from imagemagick_tpu_torch.ops import dispatch as tdsp

jm = importlib.import_module("imagemagick_tpu.cli.main")
jcolor = importlib.import_module("imagemagick_tpu.core.color")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec


def _natural(h, w, seed=0, c=3):
    """Smooth gradient + modest texture + a hard-edged block."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 17.0)[..., None] * np.cos(
        xx[..., None] / 23.0 + np.arange(c))
    img = np.clip(base + 0.08 * rng.standard_normal((h, w, c)), 0.0, 1.0)
    img[h // 3:h // 2, w // 4:w // 2] = 0.95
    return img.astype(np.float32)


def _states(images, alpha=False):
    """A JAX and a port CLIState over the same images."""
    js, ts = jm.CLIState(), tm.CLIState()
    _add(js, ts, images, alpha)
    return js, ts


def _add(js, ts, images, alpha=False):
    for im in images:
        js.images.append(jm.LazyImage(JImage(
            jnp.asarray(im), JSpec(colorspace="srgb", alpha=alpha))))
        ts.images.append(tm.LazyImage(TImage(
            torch.from_numpy(im), TSpec(colorspace="srgb", alpha=alpha))))


def _tags(st):
    return [[t for _, _, t in li.pending] for li in st.images]


def _psnr(a, b):
    rms = np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 20.0 * np.log10(1.0 / max(rms, 1e-12))


ARGVS = [
    ["-resize", "256x256!"],
    ["-resize", "256x256!", "-gaussian-blur", "0x2", "-colorspace", "gray"],
    ["-resize", "50%"],
    ["-resize", "50%", "-colorspace", "gray"],
    ["-resize", "x128"],
    ["-resize", "x40", "-blur", "1x0.8", "-colorspace", "gray"],
    ["-resize", "32x32!", "-gaussian-blur", "0x2", "-colorspace", "gray"],
    ["-gaussian-blur", "0x1.5", "-resize", "48x48"],
    ["+resize", "40x30", "+gaussian-blur", "0x1"],
    ["-colorspace", "gray", "-resize", "32x24"],
    ["-colorspace", "srgb", "-gaussian-blur", "0x0"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
@pytest.mark.parametrize("alpha", [False, True])
def test_tags_equal_jax(argv, alpha):
    images = [_natural(64, 96, s, 4 if alpha else 3) for s in range(2)]
    js, ts = _states(images, alpha)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert [(li.height, li.width) for li in ts.images] == \
        [(li.height, li.width) for li in js.images]
    assert [repr(li.spec) for li in ts.images] == \
        [repr(li.spec) for li in js.images]


def test_tags_in_parentheses_equal_jax():
    """Options inside parentheses reach only the images read there."""
    js, ts = jm.CLIState(), tm.CLIState()
    jm.process(["("], js)
    tm.process(["("], ts)
    _add(js, ts, [_natural(64, 96, s) for s in range(2)])
    jm.process(["-resize", "48x48", ")"], js)
    tm.process(["-resize", "48x48", ")"], ts)
    _add(js, ts, [_natural(40, 56, 5)])
    jm.process(["-colorspace", "gray"], js)
    tm.process(["-colorspace", "gray"], ts)
    assert _tags(ts) == _tags(js)
    assert len(_tags(ts)[0]) == 2 and len(_tags(ts)[2]) == 1
    got = tm.materialize_all(ts.images)
    want = jm.materialize_all(js.images)
    for g, w in zip(got, want):
        assert tuple(g.data.shape) == tuple(w.data.shape)
        assert _psnr(g.data.numpy(), np.asarray(w.data)) >= 60.0


@pytest.mark.parametrize("argv", ARGVS[:8], ids=" ".join)
def test_materialize_all_matches_jax(argv):
    images = [_natural(64, 96, s) for s in range(3)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    got = tm.materialize_all(ts.images)
    want = jm.materialize_all(js.images)
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        assert tuple(g.data.shape) == tuple(w.data.shape)
        assert _psnr(g.data.numpy(), np.asarray(w.data)) >= 60.0


def test_grouped_batch_is_one_fused_call(monkeypatch):
    seen = []
    orig = tdsp.try_fused_batch_array
    monkeypatch.setattr(tdsp, "try_fused_batch_array",
                        lambda x, *a, **k: seen.append(tuple(x.shape))
                        or orig(x, *a, **k))
    ts = tm.CLIState()
    for s in range(4):
        ts.images.append(tm.LazyImage(TImage(torch.from_numpy(
            _natural(64, 96, s)), TSpec(colorspace="srgb"))))
    tm.process(ARGVS[6], ts)
    before = dict(tdsp.COUNTS)
    out = tm.materialize_all(ts.images)
    assert seen == [(4, 64, 96, 3)]
    assert tdsp.COUNTS == {"fused": before["fused"] + 1, "op": before["op"],
                           "sharded": before["sharded"]}
    assert all(tuple(o.data.shape) == (32, 32, 1) for o in out)
    assert all(o.spec.colorspace == "gray" for o in out)
    assert all(not li.pending for li in ts.images)


@pytest.mark.parametrize("n", [1, 3])
def test_declined_chain_counts_op(n):
    """W * C < 128: dispatch declines, the chain runs as PyTorch ops, once
    for a group of same-shape images and once for a single image."""
    images = [_natural(40, 30, s) for s in range(n)]
    js, ts = _states(images)
    jm.process(ARGVS[6], js)
    tm.process(ARGVS[6], ts)
    before = dict(tdsp.COUNTS)
    got = tm.materialize_all(ts.images)
    assert tdsp.COUNTS == {"fused": before["fused"], "op": before["op"] + 1,
                           "sharded": before["sharded"]}
    want = jm.materialize_all(js.images)
    for g, w in zip(got, want):
        assert tuple(g.data.shape) == tuple(w.data.shape) == (32, 32, 1)
        assert _psnr(g.data.numpy(), np.asarray(w.data)) >= 60.0


def test_materialize_carries_metadata():
    img = TImage(torch.from_numpy(_natural(64, 96)), TSpec(colorspace="srgb"),
                 properties={"comment": "x"}, profiles={"icc": b"\0"},
                 page=(96, 64, 1, 2), delay=7)
    for lazies in ([tm.LazyImage(img)], [tm.LazyImage(img),
                                         tm.LazyImage(img)]):
        st = tm.CLIState()
        st.images = lazies
        tm.process(["-resize", "50%", "-colorspace", "gray"], st)
        for out in tm.materialize_all(st.images):
            assert (out.properties, out.profiles, out.page, out.delay) == (
                {"comment": "x"}, {"icc": b"\0"}, (96, 64, 1, 2), 7)


@pytest.mark.parametrize("argv", [["-unknown-option"], ["+bogus", "x"],
                                  ["-region-x", "4x4"]])
def test_unknown_option_is_the_jax_error(argv, capsys):
    """An option neither CLI knows: ``process`` raises the JAX CLI's
    CLIError, ``unrecognized option '<tok>'``, and ``main`` prints it
    after ``tmagick: `` and returns 1, as the JAX ``main`` does."""
    st = tm.CLIState("cpu")
    st.images.append(tm.LazyImage(TImage(torch.zeros(8, 8, 3))))
    jst = jm.CLIState()
    jst.images.append(jm.LazyImage(JImage(jnp.zeros((8, 8, 3)))))
    with pytest.raises(tm.CLIError) as got:
        tm.process(argv, st)
    with pytest.raises(jm.CLIError) as want:
        jm.process(argv, jst)
    assert str(got.value) == str(want.value) == \
        f"unrecognized option {argv[0]!r}"
    assert tm.main(argv, device="cpu") == 1
    t_err = capsys.readouterr().err
    assert jm.main(argv) == 1
    assert t_err == capsys.readouterr().err == \
        f"tmagick: unrecognized option {argv[0]!r}\n"


@pytest.mark.parametrize("argv,what", [
    ([")"], "unbalanced"), (["-resize"], "requires an argument"),
    (["(", "-resize", "10x10"], "no images")])
def test_cli_errors(argv, what):
    st = tm.CLIState()
    st.images.append(tm.LazyImage(TImage(torch.zeros(8, 8, 3))))
    with pytest.raises(tm.CLIError, match=what):
        tm.process(argv, st)


COLORS = [
    "red", "White", " navy ", "rebeccapurple", "grey", "gray", "gray0",
    "gray50", "grey100", "gray150", "none", "transparent", "matte", "opaque",
    "freeze", "#fff", "#FFF8", "#7f7f7f", "#11223344", "#0000ffff0000",
    "#0000ffff0000ffff", "rgb(255,0,0)", "rgb(100%, 50%, 0%)",
    "rgba(10,20,30,0.5)", "rgba(10,20,30,128)", "srgb(1,2,3)",
    "srgba(1,2,3,0.25)", "hsl(120,50%,50%)", "hsla(300,100%,25%,0.3)",
    "hsb(60,100%,100%)", "hsv(200,40%,80%)", "hsba(10,20%,30%,0.4)",
    "gray(50%)", "graya(128,0.5)", "cmyk(0,0,0,0)", "cmyk(0.1,0.2,0.3,0.4)",
    "cmyka(10%,20%,30%,40%,0.5)", "rgb(300,0,0)",
]


@pytest.mark.parametrize("name", COLORS)
def test_parse_color_equals_jax(name):
    assert parse_color(name) == jcolor.parse_color(name)
    assert parse_color(name, 0.25) == jcolor.parse_color(name, 0.25)


@pytest.mark.parametrize("name", ["#12345", "notacolor", "gray1000x", None])
def test_parse_color_errors_equal_jax(name):
    with pytest.raises(ValueError):
        jcolor.parse_color(name)
    with pytest.raises(ValueError):
        parse_color(name)


def test_state_colors():
    st = tm.CLIState()
    assert st.bg() == (1.0, 1.0, 1.0, 1.0)
    assert st.fill() == (0.0, 0.0, 0.0, 1.0)


def test_jax_resize_binds_alpha_late():
    """The JAX ``-resize`` lambda reads the loop's ``alpha`` when it runs,
    so an RGBA image listed before an RGB one is resized as if it had no
    alpha; the port binds each image's own flag (premultiplied)."""
    from imagemagick_tpu_torch.ops import resize as trz

    jrz = importlib.import_module("imagemagick_tpu.ops.resize")
    rgba = _natural(64, 96, 0, 4)
    rgba[..., 3] = np.linspace(0.1, 1.0, 96, dtype=np.float32)
    rgb = _natural(64, 96, 1)
    js, ts = jm.CLIState(), tm.CLIState()
    _add(js, ts, [rgba], alpha=True)
    _add(js, ts, [rgb], alpha=False)
    jm.process(["-resize", "48x32!"], js)
    tm.process(["-resize", "48x32!"], ts)
    got = tm.materialize_all(ts.images)[0].data.numpy()
    jgot = np.asarray(jm.materialize_all(js.images)[0].data)
    x = torch.from_numpy(rgba)
    want = trz.resize(x, 32, 48, has_alpha=True).numpy()
    assert np.array_equal(got, want)
    jwant = np.asarray(jrz.resize(jnp.asarray(rgba), 32, 48, has_alpha=False))
    assert np.array_equal(jgot, jwant)
    assert _psnr(jgot, want) < 60.0


# every option of the tone slice, on 48x72 images (W * C >= 128, and a
# thumbnail to 32x32 keeps its tag there)
TONE_ARGVS = [
    ["-sample", "20x30"], ["-sample", "200%"], ["-scale", "50%"],
    ["-scale", "100x150!"], ["-thumbnail", "32x32"],
    ["-thumbnail", "10x10"], ["-adaptive-resize", "40x20"],
    ["-adaptive-resize", "150%"], ["-magnify"], ["-negate"], ["+negate"],
    ["-gamma", "1.7"], ["-gamma", "2.2,1,0.8"], ["-level", "10%,90%,1.2"],
    ["-level", "0.1"], ["-auto-level"], ["-auto-gamma"], ["-normalize"],
    ["-equalize"], ["-contrast-stretch", "2%x1%"],
    ["-contrast-stretch", "5%"], ["-linear-stretch", "2%x5%"],
    ["-sigmoidal-contrast", "3x50%"], ["+sigmoidal-contrast", "5x40%"],
    ["-brightness-contrast", "10x20"], ["-brightness-contrast", "-5"],
    ["-modulate", "100,120"], ["-modulate", "90,80,150"],
    ["-white-balance"], ["-enhance"], ["-clahe", "16x16+64+2"],
    ["-clahe", "25%"], ["-threshold", "50%"], ["-threshold", "0.3"],
    ["-black-threshold", "30%"], ["-white-threshold", "70%"],
    ["-auto-threshold", "otsu"], ["-auto-threshold", "triangle"],
    ["-ordered-dither", "o8x8"], ["-ordered-dither", "h4x4a,3"],
    ["-random-threshold", "20x80%"], ["-lat", "15x15-5%"], ["-lat", "5"],
    ["-clamp"], ["-colorspace", "hsl"], ["-colorspace", "cmyk"],
    ["-colorspace", "ycc"], ["-colorspace", "jzazbz"],
]
BINARY = ("-threshold", "-black-threshold", "-white-threshold",
          "-auto-threshold", "-ordered-dither", "-lat")
CHAIN_A = ["-thumbnail", "32x32", "-auto-level", "-modulate", "100,120",
           "-sigmoidal-contrast", "3x50%", "-gamma", "1.1"]
CHAIN_B = ["-scale", "50%", "-colorspace", "gray", "-normalize",
           "-auto-threshold", "otsu"]


def _assert_cli_close(argv, got, want):
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        g, w = g.data.numpy(), np.asarray(w.data)
        assert g.shape == w.shape and np.isfinite(g).all()
        if argv[0] in BINARY:
            assert np.mean(g != w) <= 1e-3, argv
        else:
            assert _psnr(g, w) >= 60.0, argv


@pytest.mark.parametrize("argv", TONE_ARGVS + [CHAIN_A, CHAIN_B],
                         ids=" ".join)
def test_tone_tags_equal_jax(argv):
    images = [_natural(48, 72, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert [repr(li.spec) for li in ts.images] == \
        [repr(li.spec) for li in js.images]
    if argv != ["-magnify"]:
        assert [(li.height, li.width) for li in ts.images] == \
            [(li.height, li.width) for li in js.images]


@pytest.mark.parametrize("argv", [a for a in TONE_ARGVS
                                  if a[0] != "-random-threshold"],
                         ids=" ".join)
def test_tone_outputs_match_jax(argv):
    images = [_natural(48, 72, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    _assert_cli_close(argv, tm.materialize_all(ts.images),
                      jm.materialize_all(js.images))


@pytest.mark.parametrize("argv", [CHAIN_A, CHAIN_B], ids=" ".join)
def test_chains_match_jax(argv):
    images = [_natural(48, 72, s) for s in range(3)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    _assert_cli_close(argv, tm.materialize_all(ts.images),
                      jm.materialize_all(js.images))


def test_thumbnail_chain_fuses_its_prefix_once(monkeypatch):
    """Chain (a): the thumbnail's tag over the group is ONE fused call;
    the untagged rest runs image by image (one ``op`` count each)."""
    seen = []
    orig = tdsp.try_fused_batch_array
    monkeypatch.setattr(tdsp, "try_fused_batch_array",
                        lambda x, *a, **k: seen.append(tuple(x.shape))
                        or orig(x, *a, **k))
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(48, 72, s) for s in range(4)])
    tm.process(list(CHAIN_A), ts)
    before = dict(tdsp.COUNTS)
    out = tm.materialize_all(ts.images)
    assert seen == [(4, 48, 72, 3)]
    assert tdsp.COUNTS == {"fused": before["fused"] + 1,
                           "op": before["op"] + 4,
                           "sharded": before["sharded"]}
    assert all(tuple(o.data.shape) == (21, 32, 3) for o in out)
    # each image's rest saw only its own pixels: auto-level stretched
    # every image to [0, 1] before the later ops
    single = tm.CLIState()
    _add(jm.CLIState(), single, [_natural(48, 72, 2)])
    tm.process(list(CHAIN_A), single)
    alone = tm.materialize_all(single.images)[0].data
    assert torch.allclose(out[2].data, alone, atol=1e-6)


def test_auto_threshold_is_one_histogram_launch_a_group(monkeypatch):
    """Chain (b): every image materialized (one fused call for the
    group's scale and gray mix), then one K4 call for the histograms of
    each group of same-shape images."""
    from imagemagick_tpu_torch.ops import gpu_kernels

    calls = []
    orig = gpu_kernels.histogram256
    monkeypatch.setattr(gpu_kernels, "histogram256",
                        lambda rows: calls.append(tuple(rows.shape))
                        or orig(rows))
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(48, 72, s) for s in range(3)] +
         [_natural(40, 64, 9)])
    before = dict(tdsp.COUNTS)
    tm.process(list(CHAIN_B), ts)
    assert tdsp.COUNTS["fused"] == before["fused"] + 2
    assert sorted(calls) == [(1, 20 * 32), (3, 24 * 36)]
    for li in ts.images:
        assert not li.pending and li.image.spec.colorspace == "gray"
        assert set(np.unique(li.image.data.numpy())) <= {0.0, 1.0}


def test_random_threshold_repeats_and_counts():
    x = _natural(48, 72, 4)
    outs = []
    for _ in range(2):
        ts = tm.CLIState()
        _add(jm.CLIState(), ts, [x])
        tm.process(["-random-threshold", "20x80%"], ts)
        outs.append(tm.materialize_all(ts.images)[0].data.numpy())
    assert np.array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) <= {0.0, 1.0}
    p = np.clip((x.astype(np.float64) - 0.2) / 0.6, 0.0, 1.0)
    assert abs(outs[0].sum() - p.sum()) <= 5 * np.sqrt(
        (p * (1 - p)).sum()) + 1


def test_jax_magnify_keeps_the_stale_shape():
    """The JAX CLI queues -magnify without its new shape, so a later
    -resize 50% there resizes to half the size before the magnify; the
    port tracks the doubled shape."""
    images = [_natural(48, 72, 0)]
    js, ts = _states(images)
    jm.process(["-magnify", "-resize", "50%"], js)
    tm.process(["-magnify", "-resize", "50%"], ts)
    assert (ts.images[0].height, ts.images[0].width) == (48, 72)
    assert (js.images[0].height, js.images[0].width) == (24, 36)
    assert tuple(tm.materialize_all(ts.images)[0].data.shape) == (48, 72, 3)
    assert tuple(np.asarray(jm.materialize_all(js.images)[0].data).shape) \
        == (24, 36, 3)


def test_clahe_keeps_the_device():
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(48, 72, 5)])
    tm.process(["-clahe", "16x16+64+2"], ts)
    out = ts.images[0].image.data
    assert out.device.type == "cpu" and out.shape == (48, 72, 3)


# blur's effects, the rank filters, evaluate and function, and the
# settings that reach them, on 48x72 images.  The JAX CLI jits each chain
# (XLA may contract a product and a sum into one rounding), so the values
# agree to float32 rounding but a selection from nearly equal values (an
# adaptive level, a Kuwahara quadrant, a median of nearly equal pixels)
# may differ: at most 0.1 % of the values may differ by more than 1e-5,
# and the whole output is held to the 60 dB gate.
EFFECT_ARGVS = [
    ["-sharpen", "0x1"], ["-sharpen", "2x0.8"],
    ["-unsharp", "0x1+1.5+0.02"], ["-unsharp", "2x1"], ["-edge", "1"],
    ["-edge", "2"], ["-adaptive-blur", "0x2"], ["-adaptive-sharpen", "0x1"],
    ["-motion-blur", "0x3+45"], ["-motion-blur", "2x1-30"],
    ["-rotational-blur", "10"], ["-bilateral-blur", "5x5"],
    ["-bilateral-blur", "4x3+10+1.5"], ["-kuwahara", "3"],
    ["-kuwahara", "2x1"], ["-despeckle"], ["-emboss", "1"],
    ["-shade", "30x30"], ["-shade", "120x45"],
    ["-selective-blur", "0x1+10%"], ["-selective-blur", "2x1"],
    ["-statistic", "median", "3x3"], ["-statistic", "mode", "2x2"],
    ["-statistic", "stddev", "5"], ["-statistic", "nonpeak", "3x2"],
    ["-median", "1"], ["-median", "2"],
    ["-evaluate", "add", "10%"], ["-evaluate", "multiply", "0.8"],
    ["-evaluate", "pow", "2"], ["-evaluate", "and", "32768"],
    ["-evaluate", "log", "500"],
    ["-function", "polynomial", "3,-2,0.5"],
    ["-function", "sinusoid", "3,90"], ["-function", "arctan", "5"],
    ["-virtual-pixel", "mirror", "-sharpen", "0x1"],
    ["-virtual-pixel", "tile", "-blur", "0x1"],
    ["-virtual-pixel", "black", "-gaussian-blur", "0x1", "-sharpen",
     "0x0.7"],
]
CHAIN_E = ["-resize", "32x32", "-sharpen", "0x1", "-adaptive-blur", "0x2",
           "-median", "1"]


def _assert_effects_close(argv, got, want):
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        g, w = g.data.numpy(), np.asarray(w.data)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.mean(np.abs(g - w) > 1e-5) <= 1e-3, argv
        assert _psnr(g, w) >= 60.0, argv


@pytest.mark.parametrize("argv", EFFECT_ARGVS + [CHAIN_E], ids=" ".join)
def test_effect_options_match_jax(argv):
    images = [_natural(48, 72, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert [(li.height, li.width) for li in ts.images] == \
        [(li.height, li.width) for li in js.images]
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings}
    _assert_effects_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


def test_effect_chain_fuses_its_resize_once(monkeypatch):
    """``-resize 32x32 -sharpen 0x1 -adaptive-blur 0x2 -median 1``: the
    resize's tag over the group is ONE fused call; the effects run image
    by image, each adaptive blur through one ``separable_blur`` call."""
    from imagemagick_tpu_torch.ops import gpu_kernels

    seen, blurs = [], []
    orig = tdsp.try_fused_batch_array
    monkeypatch.setattr(tdsp, "try_fused_batch_array",
                        lambda x, *a, **k: seen.append(tuple(x.shape))
                        or orig(x, *a, **k))
    orig_blur = gpu_kernels.separable_blur
    monkeypatch.setattr(gpu_kernels, "separable_blur",
                        lambda x, t: blurs.append(tuple(x.shape))
                        or orig_blur(x, t))
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(48, 72, s) for s in range(4)])
    tm.process(list(CHAIN_E), ts)
    assert [t for _, _, t in ts.images[0].pending][1:] == [None] * 3
    before = dict(tdsp.COUNTS)
    out = tm.materialize_all(ts.images)
    assert seen == [(4, 48, 72, 3)]
    assert tdsp.COUNTS == {"fused": before["fused"] + 1,
                           "op": before["op"] + 4,
                           "sharded": before["sharded"]}
    assert blurs == [(1, 21, 32, 3)] * 4
    assert all(tuple(o.data.shape) == (21, 32, 3) for o in out)


@pytest.mark.parametrize("argv", [
    ["-gravity", "southeast", "-compose", "dissolve", "-define",
     "compose:args=35", "-composite"],
    ["-composite"],
    ["-compose", "multiply", "-geometry", "+5+3", "-composite"],
    ["-gravity", "center", "-compose", "blend", "-define",
     "compose:args=30x60", "-composite"],
    ["-gravity", "north", "+gravity", "-compose", "screen", "+compose",
     "-geometry", "-4+2", "-composite"],
    ["-compose", "difference", "-define", "compose:args=1", "+define",
     "compose:args", "-composite"],
    ["-compose", "displace", "-define", "compose:args=10x5", "-composite"],
])
@pytest.mark.parametrize("alpha", [False, True])
def test_composite_option_matches_jax(argv, alpha):
    """The list operator over a canvas and a smaller overlay (a third
    image is dropped, as in the JAX CLI), under each setting."""
    c = 4 if alpha else 3
    images = [_natural(48, 72, 0, c), _natural(20, 30, 1, c),
              _natural(48, 72, 2, c)]
    js, ts = _states(images, alpha)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert ts.defines == js.defines
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings or k in ("compose",
                                                        "compose-geometry")}
    assert len(ts.images) == len(js.images) == 1
    got, want = ts.images[0].image, js.images[0].image
    assert repr(got.spec) == repr(want.spec)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=1e-6)


def test_settings_are_stored_as_the_jax_cli_stores_them():
    js, ts = _states([_natural(8, 8, 0)])
    argv = ["-virtual-pixel", "Mirror", "-gravity", "East", "-compose",
            "Multiply", "-geometry", "+1+2", "-define", "a:b=c=d",
            "-define", "x=1", "+define", "x", "+virtual-pixel", "tile"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert ts.defines == js.defines == {"a:b": "c=d"}
    for k in ("virtual-pixel", "gravity", "compose", "compose-geometry"):
        assert ts.settings[k] == js.settings[k]
    with pytest.raises(tm.CLIError, match="requires an argument"):
        tm.process(["-gravity"], ts)


def test_two_argument_options_take_two_tokens():
    js, ts = _states([_natural(24, 30, 0)])
    argv = ["-statistic", "gradient", "3x1", "-evaluate", "max", "20%",
            "-function", "polynomial", "1,0", "-median", "1"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert len(ts.images[0].pending) == len(js.images[0].pending) == 4
    _assert_effects_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))
    with pytest.raises(tm.CLIError, match="requires an argument"):
        tm.process(["-statistic", "median"], ts)


@pytest.mark.parametrize("argv", [["-spread", "2"],
                                  ["-evaluate", "gaussian-noise", "0.5"],
                                  ["-evaluate", "impulse-noise", "3"]])
def test_random_options_draw_from_a_generator_seeded_0(argv):
    """-spread and the noise operators of -evaluate draw from a generator
    seeded 0 (the JAX CLI from PRNGKey(0), another stream): the same
    output on every run and for every same-shape image, and -spread's
    output holds only its own image's pixels."""
    x = _natural(24, 30, 3)
    outs = []
    for _ in range(2):
        ts = tm.CLIState()
        _add(jm.CLIState(), ts, [x, x])
        tm.process(list(argv), ts)
        outs.append([o.data for o in tm.materialize_all(ts.images)])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][0], outs[0][1])
    js = jm.CLIState()
    _add(js, tm.CLIState(), [x])
    jm.process(list(argv), js)
    assert np.asarray(jm.materialize_all(js.images)[0].data).shape == x.shape
    if argv[0] == "-spread":
        got = outs[0][0].numpy().reshape(-1, 3)
        assert set(map(tuple, got)) <= set(map(tuple, x.reshape(-1, 3)))
        assert not np.array_equal(outs[0][0].numpy(), x)


# the geometry and distortion options, on 48x72 images (pages for -trim
# and -deskew).  The JAX CLI jits its lazy chains, so a transcendental may
# move a bilinear floor by an ulp: at most 0.1 % of the pixels may differ
# by more than 1e-5 (the distort bound); they come out equal here.
GEOMETRY_ARGVS = [
    ["-crop", "20x16+2+2"], ["-crop", "30x20"], ["-crop", "2x2@"],
    ["-crop", "3x2@"], ["-gravity", "center", "-crop", "30x20+1+1"],
    ["-crop", "100x100-10-10"], ["-chop", "10x5+3+2"],
    ["-gravity", "southeast", "-chop", "10x5"], ["-extent", "80x60"],
    ["-gravity", "center", "-extent", "40x30"],
    ["-background", "navy", "-extent", "90x50-5-5"], ["-shave", "3x2"],
    ["-shave", "4"], ["-splice", "4x3+10+5"],
    ["-background", "red", "-splice", "2x0+0+0"], ["-roll", "+5-3"],
    ["-roll", "-100+7"], ["-flip"], ["-flop"], ["-rotate", "30"],
    ["-rotate", "90>"], ["-rotate", "-12.5<"], ["-border", "3"],
    ["-bordercolor", "navy", "-border", "4x2"], ["-auto-orient"],
    ["-implode", "0.5"], ["-swirl", "60"], ["-distort", "SRT", "20"],
    ["+distort", "SRT", "0.8,20"], ["-distort", "Barrel", "0.05 0.0 0.0"],
    ["+distort", "Perspective", "0,0,3,2 71,0,68,5 0,47,2,44 71,47,66,40"],
    ["-distort", "Arc", "60"], ["-virtual-pixel", "black", "-distort",
                                "Polar", "20"],
    ["-virtual-pixel", "transparent", "-distort", "SRT", "20"],
    ["-sparse-color", "voronoi", "5,5,red 40,30,blue"],
    ["-sparse-color", "shepards", "5,5,red 40,30,blue 60,10,#00ff00"],
    ["-affine", "1,0.1,0,1,2,3", "-transform"], ["-transform"],
    ["-shear", "20x10"], ["-shear", "15"],
]
CLI_DISTORT = ["-resize", "40x30!", "-flop", "-background", "white",
               "-rotate", "12", "-gravity", "center", "-extent", "40x30",
               "-distort", "Barrel", "0.05 0.0 0.0", "-bordercolor", "navy",
               "-border", "4"]


def _assert_distort_close(argv, got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        g, w = g.data.numpy(), np.asarray(w.data)
        assert g.shape == w.shape and np.isfinite(g).all(), argv
        d = np.abs(g - w).reshape(-1, g.shape[-1])
        assert (d > 1e-5).any(-1).mean() <= 1e-3, argv


@pytest.mark.parametrize("argv", GEOMETRY_ARGVS + [CLI_DISTORT],
                         ids=" ".join)
def test_geometry_options_match_jax(argv):
    images = [_natural(48, 72, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert [(li.height, li.width) for li in ts.images] == \
        [(li.height, li.width) for li in js.images]
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings}
    _assert_distort_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


def _pages(n, h=60, w=88, border=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = np.ones((h, w, 3), np.float32)
        for r in range(border + 2, h - border - 4, 7):
            p[r:r + 3, border + 3:w - border - 3 - 2 * i] = rng.uniform(
                0.0, 0.2, (3, w - 2 * border - 6 - 2 * i, 3))
        out.append(p)
    return out


@pytest.mark.parametrize("argv", [["-trim"], ["-deskew", "40%"],
                                  ["-deskew", "40%", "-trim", "-shave",
                                   "2x2"],
                                  ["-liquid-rescale", "80x60"]],
                         ids=" ".join)
def test_page_options_match_jax(argv):
    """-trim and -deskew on pages with a white border (the second page
    rotated by 3 degrees first); -liquid-rescale carves each image."""
    from imagemagick_tpu_torch.ops import distort as tdst

    pages = _pages(2)
    pages[1] = tdst.rotate(torch.from_numpy(pages[1]), 3.0,
                           (1.0, 1.0, 1.0)).numpy()
    js, ts = _states(pages)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert [(li.height, li.width) for li in ts.images] == \
        [(li.height, li.width) for li in js.images]
    _assert_distort_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


def test_geometry_settings_are_stored_as_the_jax_cli_stores_them():
    js, ts = _states([_natural(8, 8, 0)])
    argv = ["-background", "navy", "-bordercolor", "#123456", "-affine",
            "1,0,0.2,1,0,0", "+background", "red"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    for k in ("background", "bordercolor", "affine"):
        assert ts.settings[k] == js.settings[k]
    assert ts.settings["background"] == "red"
    with pytest.raises(tm.CLIError, match="requires an argument"):
        tm.process(["-affine"], ts)


def test_auto_orient_reads_and_resets_the_exif_orientation():
    x = _natural(48, 72, 4)
    js, ts = jm.CLIState(), tm.CLIState()
    for o in (6, 3, 1, 8):
        js.images.append(jm.LazyImage(JImage(
            jnp.asarray(x), JSpec(colorspace="srgb"),
            properties={"exif:Orientation": str(o)})))
        ts.images.append(tm.LazyImage(TImage(
            torch.from_numpy(x), TSpec(colorspace="srgb"),
            properties={"exif:Orientation": str(o)})))
    jm.process(["-auto-orient"], js)
    tm.process(["-auto-orient"], ts)
    for t, j in zip(ts.images, js.images):
        assert t.image.properties["exif:Orientation"] == \
            j.image.properties["exif:Orientation"] == 1
        np.testing.assert_array_equal(t.image.data.numpy(),
                                      np.asarray(j.image.data))


def test_cli_distort_chain_fuses_its_resize_once(monkeypatch):
    """The chain's resize over the group is ONE fused call; -rotate,
    -distort and -border materialize through materialize_all."""
    seen = []
    orig = tdsp.try_fused_batch_array
    monkeypatch.setattr(tdsp, "try_fused_batch_array",
                        lambda x, *a, **k: seen.append(tuple(x.shape))
                        or orig(x, *a, **k))
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(48, 72, s) for s in range(4)])
    before = dict(tdsp.COUNTS)
    tm.process(list(CLI_DISTORT), ts)
    out = tm.materialize_all(ts.images)
    assert seen == [(4, 48, 72, 3)]
    assert tdsp.COUNTS["fused"] == before["fused"] + 1
    assert all(tuple(o.data.shape) == (38, 48, 3) for o in out)


@pytest.mark.parametrize("argv,swapped", [
    (["-transpose", "-resize", "50%"], (36, 24)),
    (["-transverse", "-extent", "50%x50%"], (36, 24)),
    (["-wave", "5x20", "-crop", "50%x50%"], (29, 36))])
def test_jax_cli_keeps_stale_shapes_after_shape_changes(argv, swapped):
    """The JAX CLI queues -transpose, -transverse and -wave without their
    new shapes, so a later geometry there is computed against the shape
    before them; the port pushes the new shape."""
    images = [_natural(48, 72, 0)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert (ts.images[0].height, ts.images[0].width) == swapped
    assert (js.images[0].height, js.images[0].width) != swapped
    assert tuple(tm.materialize_all(ts.images)[0].data.shape[:2]) == swapped


# the channel, list, quantizer and attribute options and the -channel,
# -metric, -dither and -quantize settings.  Each is held to the JAX CLI
# bit for bit but where a float32 reduction or transcendental differs by
# an ulp between XLA and PyTorch, or where the JAX CLI jits a chain of
# per-pixel ops and the port runs them eagerly (-fx, -compare's
# distortion, -morph's and the sequence reductions' sums, the tone ops
# and blurs under a mask: 1e-6), where K1 resizes (the fused route, >= 60
# dB as test_materialize_all_matches_jax holds it, and at most 0.1 % of
# the pixels further than 1e-5 apart), and where an option takes such
# values on to a selection (a threshold, the octree of -colors under
# -quantize or after a resize): at most 0.1 % of the pixels further than
# 1e-5 apart.
CHANNEL_ARGVS = [
    ["-channel", "R", "-negate"], ["-channel", "RG", "-gamma", "2"],
    ["-channel", "Red,Blue", "-threshold", "50%"],
    ["-channel", "All", "-negate"], ["-channel", "gb", "-level", "10%,90%"],
    ["-resize", "32x24", "-channel", "B", "-negate"],
    ["-channel", "R", "-resize", "32x24", "-gaussian-blur", "0x1"],
    ["-channel", "bogus", "-gaussian-blur", "0x1"],
    ["-channel", "G", "-blur", "0x1", "-flip"],
    ["-resize", "40x40!", "-channel", "B", "-transpose", "-flop"],
    ["-separate"], ["-channel", "R", "-separate"],
    ["-channel", "GB", "-separate", "-combine"], ["-separate", "-combine"],
    ["-alpha", "set"], ["-alpha", "off"], ["-alpha", "extract"],
    ["-alpha", "copy"], ["-alpha", "transparent"], ["-matte"], ["+matte"],
    ["-background", "navy", "-alpha", "set", "-alpha", "remove"],
    ["-alpha", "set", "-alpha", "opaque", "-alpha", "deactivate"],
    ["-channel-fx", "red<=>blue"], ["-channel-fx", "rgb=>bgr"],
    ["-channel-fx", "red=>green,blue=>red"],
    ["-posterize", "4"], ["+dither", "-posterize", "4"],
    ["-dither", "FloydSteinberg", "-posterize", "3"],
    ["-dither", "ordered", "-posterize", "4"],
    ["-dither", "none", "-posterize", "5"], ["-colors", "16"],
    ["+dither", "-colors", "8"], ["-dither", "fs", "-colors", "32"],
    ["-kmeans", "8"], ["-kmeans", "4x20+0.001"], ["-unique-colors"],
    ["-posterize", "3", "-unique-colors"], ["-type", "grayscale"],
    ["-type", "bilevel"], ["-type", "palette"], ["-type", "truecolor"],
    ["-separate", "-type", "truecolor"],
    ["-fx", "(u+v)/2"], ["-fx", "u.r*0.5+p[1,0]*0.5"], ["-fx", "i/w*v"],
    ["-morph", "2"], ["-evaluate-sequence", "mean"], ["-average"],
    ["-maximum"], ["-minimum"], ["-evaluate-sequence", "median"],
    ["-separate", "-average"],
]
CLI_CHAIN_A = ["-resize", "32x32", "-channel", "R", "-negate", "-channel",
               "All", "-channel-fx", "red<=>blue", "-alpha", "set",
               "-posterize", "8", "-type", "grayscale"]
CLI_CHAIN_B = [["-resize", "32x32", "-separate", "-combine", "-colors", "64"],
               ["-resize", "32x32", "-fx", "(u+v)/2"],
               ["-resize", "32x32", "-metric", "rmse", "-compare"]]
_ULP_OPTS = ("-fx", "-morph", "-evaluate-sequence", "-average", "-compare",
             "-gamma", "-level", "-gaussian-blur", "-blur")
_SELECT_OPTS = ("-quantize", "-threshold", "-resize")


def _assert_channel_close(argv, got, want, select=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        g, w = g.data.numpy(), np.asarray(w.data)
        assert g.shape == w.shape, argv
        if select or any(o in argv for o in _SELECT_OPTS):
            d = np.abs(g - w).reshape(-1, g.shape[-1])
            assert (d > 1e-5).any(-1).mean() <= 1e-3, argv
            assert _psnr(g, w) >= 60.0, argv
        elif any(o in argv for o in _ULP_OPTS):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("argv", CHANNEL_ARGVS + [CLI_CHAIN_A] + CLI_CHAIN_B,
                         ids=" ".join)
def test_channel_and_quantize_options_match_jax(argv, capsys):
    images = [_natural(40, 56, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    jerr = capsys.readouterr().err
    tm.process(list(argv), ts)
    terr = capsys.readouterr().err
    assert _tags(ts) == _tags(js)
    assert [(li.height, li.width) for li in ts.images] == \
        [(li.height, li.width) for li in js.images]
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings}
    if "-compare" in argv:      # the distortion printed on stderr
        np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)
    _assert_channel_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


@pytest.mark.parametrize("argv", [
    ["-alpha", "off"], ["-alpha", "remove"], ["-background", "red", "-alpha",
                                              "flatten"],
    ["-alpha", "extract"], ["-alpha", "copy"], ["-alpha", "opaque"],
    ["-channel", "A", "-negate"], ["-channel", "rgba", "-separate"],
    ["-posterize", "4"], ["-colors", "16"], ["-kmeans", "4"],
    ["-type", "palette"], ["-type", "grayscale"], ["-channel-fx", "a<=>r"],
    ["-average"], ["-morph", "1"]], ids=" ".join)
def test_channel_options_on_alpha_images_match_jax(argv):
    """RGBA images; -type palette takes k-means there (float64 cluster
    sums in the port): the selection rule."""
    images = [_natural(40, 56, s, 4) for s in range(2)]
    js, ts = _states(images, alpha=True)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    _assert_channel_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images),
                          select="palette" in argv)


@pytest.mark.parametrize("metric", ["ae", "mae", "mse", "rmse", "pae", "psnr",
                                    "ncc", "ssim", "dssim", "fuzz", "dpc",
                                    "phase", "mepp", "phash"])
def test_compare_option_prints_each_metric_as_jax(metric, capsys):
    images = [_natural(40, 56, 0), _natural(40, 56, 1)]
    js, ts = _states(images)
    jm.process(["-metric", metric, "-compare"], js)
    jerr = float(capsys.readouterr().err)
    tm.process(["-metric", metric, "-compare"], ts)
    terr = float(capsys.readouterr().err)
    tol = 1e-5 if metric == "dssim" else 1e-6
    np.testing.assert_allclose(terr, jerr, rtol=tol)
    assert len(ts.images) == 1
    np.testing.assert_array_equal(ts.images[0].image.data.numpy(),
                                  np.asarray(js.images[0].image.data))


def test_mixed_lists_are_normalized_as_jax():
    """-average over a gray, an RGB and an RGBA image: gray goes to RGB
    and an opaque alpha is added, as in the JAX CLI."""
    js, ts = jm.CLIState(), tm.CLIState()
    g = _natural(24, 32, 0, 1)
    c = _natural(24, 32, 1)
    a = _natural(24, 32, 2, 4)
    for st, mod, img_cls, spec_cls, conv in (
            (js, jm, JImage, JSpec, jnp.asarray),
            (ts, tm, TImage, TSpec, torch.from_numpy)):
        st.images.append(mod.LazyImage(img_cls(conv(g), spec_cls(
            colorspace="gray"))))
        st.images.append(mod.LazyImage(img_cls(conv(c), spec_cls(
            colorspace="srgb"))))
        st.images.append(mod.LazyImage(img_cls(conv(a), spec_cls(
            colorspace="srgb", alpha=True))))
    jm.process(["-average"], js)
    tm.process(["-average"], ts)
    _assert_channel_close(["-average"], tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


def test_quantize_setting_colors_in_another_space():
    """-quantize lab -colors 16: the octree runs on Lab values that the
    two packages convert an ulp apart, so a few pixels may fall in
    another cell (at most 0.1 %)."""
    images = [_natural(40, 56, s) for s in range(2)]
    argv = ["-quantize", "lab", "-colors", "16"]
    js, ts = _states(images)
    jm.process(argv, js)
    tm.process(argv, ts)
    assert ts.settings["quantize"] == js.settings["quantize"] == "lab"
    _assert_channel_close(argv, tm.materialize_all(ts.images),
                          jm.materialize_all(js.images))


def test_channel_settings_are_stored_as_the_jax_cli_stores_them():
    js, ts = _states([_natural(8, 8, 0)])
    argv = ["-channel", "RG", "-metric", "AE", "-dither", "FloydSteinberg",
            "-quantize", "YCbCr", "+dither", "-channel", "All"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    for k in ("channel", "metric", "dither", "quantize"):
        assert ts.settings[k] == js.settings[k]
    assert ts.settings["dither"] == "none"


@pytest.mark.parametrize("setting,nch,want", [
    ("default", 3, None), ("All", 4, None), ("R", 3, [0]),
    ("RGB", 4, [0, 1, 2]), ("Red,Blue", 3, [0, 2]), ("A", 4, [3]),
    ("alpha", 3, [2]), ("rgba", 3, [0, 1, 2]), ("cmyk", 4, [0, 1, 2, 3]),
    ("gray", 3, [1]), ("Red|Green", 3, [0, 1]), ("k", 3, None),
    ("bogus", 3, None)])
def test_channel_indices_equal_jax(setting, nch, want):
    assert tm._channel_indices(setting, nch) == \
        jm._channel_indices(setting, nch) == want


def test_remap_raises_naming_io_and_the_walks():
    """-remap/-map read their palette through io/ and run under every
    dither (the native octree library, test_torch_cli_files.py);
    ``quantize.remap(..., dither=True)``, which the JAX CLI reaches where
    a frame is not (H, W, C), is the Floyd-Steinberg walk: the JAX
    function's pixels, bit for bit (test_torch_palette_walk.py holds the
    walks on more cases)."""
    from imagemagick_tpu_torch.ops import quantize as tq

    jq = importlib.import_module("imagemagick_tpu.ops.quantize")
    x = np.random.default_rng(0).random((2, 6, 8, 3)).astype(np.float32)
    pal = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    for dither in (True, 1):
        got = tq.remap(torch.from_numpy(x), torch.from_numpy(pal), dither)
        want = np.asarray(jq.remap(jnp.asarray(x), jnp.asarray(pal), dither))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tq.remap(torch.from_numpy(x), torch.from_numpy(pal),
                          False).shape) == (2, 6, 8, 3)


def test_chain_a_fuses_its_resize_once(monkeypatch):
    """Chain A's resize over the group is ONE fused call; the masked
    negate, the channel swap, the alpha, the posterize and the type run
    image by image."""
    seen = []
    orig = tdsp.try_fused_batch_array
    monkeypatch.setattr(tdsp, "try_fused_batch_array",
                        lambda x, *a, **k: seen.append(tuple(x.shape))
                        or orig(x, *a, **k))
    ts = tm.CLIState()
    _add(jm.CLIState(), ts, [_natural(40, 56, s) for s in range(4)])
    tm.process(list(CLI_CHAIN_A), ts)
    out = tm.materialize_all(ts.images)
    assert seen == [(4, 40, 56, 3)]
    assert all(tuple(o.data.shape) == (23, 32, 1) for o in out)
    assert all(o.spec.colorspace == "gray" for o in out)


# -- paint, feature, vision, segment, draw and decorate ----------------------

PAINT_ARGVS = [
    ["-paint", "2"], ["-oil-paint", "1"],
    ["-fill", "red", "-fuzz", "20%", "-opaque", "gray50"],
    ["-fill", "red", "-fuzz", "20%", "+opaque", "gray50"],
    ["-fuzz", "15%", "-transparent", "white"],
    ["-fuzz", "15", "+transparent", "white"],
    ["-fill", "blue", "-fuzz", "30%", "-floodfill", "+3+4", "gray60"],
    ["-fill", "blue", "-fuzz", "30%", "-floodfill", "+3+4", ""],
    ["-canny", "0x1+10%+30%"], ["-resize", "50%", "-canny", "0x1+10%+30%"],
    ["-mean-shift", "5x5+10%"],
    ["-connected-components", "4"],
    ["-threshold", "50%", "-connected-components", "8"],
    ["-threshold", "50%", "-define", "connected-components:area-threshold=5",
     "-connected-components", "4"],
    ["-threshold", "50%", "-define", "connected-components:mean-color=true",
     "-connected-components", "4"],
    ["-threshold", "50%", "-fuzz", "10", "-connected-components", "4"],
    ["-segment", "1x1.5"], ["-segment", "0.5"],
    ["-canny", "0x1+10%+30%", "-hough-lines", "9x9+10"],
    ["-threshold", "50%", "-stroke", "red", "-strokewidth", "2",
     "-hough-lines", "5x5+20"],
    ["-fill", "red", "-stroke", "navy", "-strokewidth", "3", "-draw",
     "circle 20,20 20,30"],
    ["-fill", "green", "-draw", "rectangle 4,4 30,20"],
    ["-fill", "red", "-fuzz", "30%", "-draw", "color 3,3 floodfill"],
    ["-pointsize", "20", "-draw", "text 2,30 'Ab'"],
    ["-font", "DejaVu-Sans", "-draw", "text 2,20 'Ab'"],
    ["-pointsize", "14", "-fill", "black", "-annotate", "+5+20", "Hi"],
    ["-gravity", "center", "-fill", "black", "-font", "DejaVu-Sans",
     "-annotate", "+0+0", "Hi"],
    ["-direction", "right-to-left", "-annotate", "+2+12", "ab"],
    ["-frame", "6x6+2+2"], ["-mattecolor", "navy", "-frame", "8x5+3+1"],
    ["-raise", "5x4"], ["+raise", "5x4"],
]


@pytest.mark.parametrize("argv", PAINT_ARGVS, ids=" ".join)
def test_paint_vision_and_draw_options_match_jax(argv):
    """Each option and setting of the slice on 2 images: tags, shapes,
    settings, specs and pixels equal to the JAX CLI's."""
    images = [_natural(40, 56, s) for s in range(2)]
    js, ts = _states(images)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings}
    got, want = tm.materialize_all(ts.images), jm.materialize_all(js.images)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert repr(g.spec) == repr(w.spec)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def test_slice_settings_are_stored_as_the_jax_cli_stores_them():
    js, ts = _states([_natural(8, 8, 0)])
    argv = ["-fill", "red", "-fuzz", "12%", "-stroke", "blue",
            "-strokewidth", "3", "-pointsize", "30", "-font", "Sans",
            "-mattecolor", "navy", "-direction", "right-to-left",
            "+fill", "green"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    for k in ("fill", "fuzz", "stroke", "strokewidth", "pointsize", "font",
              "mattecolor", "direction"):
        assert ts.settings[k] == js.settings[k], k
    assert ts.settings["fill"] == "green"


def test_verbose_components_print_as_jax(capsys):
    argv = ["-threshold", "50%", "-define", "connected-components:verbose=true",
            "-connected-components", "4"]
    js, ts = _states([_natural(40, 56, 0)])
    jm.process(list(argv), js)
    jm.materialize_all(js.images)
    want = capsys.readouterr().out
    tm.process(list(argv), ts)
    tm.materialize_all(ts.images)
    assert capsys.readouterr().out == want
    assert want.count("srgb(") > 5


def test_features_print_as_jax(capsys):
    """Six metrics in the JAX CLI's format; equal values but the entropy,
    within 1e-6 relative (XLA's float32 log against numpy's)."""
    js, ts = _states([_natural(40, 56, s) for s in range(2)])
    jm.process(["-features", "1"], js)
    jm.materialize_all(js.images)
    want = capsys.readouterr().out.splitlines()
    tm.process(["-features", "1"], ts)
    tm.materialize_all(ts.images)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        gk, _, gv = g.partition(": ")
        wk, _, wv = w.partition(": ")
        assert gk == wk
        if "entropy" in gk:
            np.testing.assert_allclose(float(gv.strip("[]")),
                                       float(wv.strip("[]")), rtol=1e-6)
        else:
            assert gv == wv


def test_jax_ccl_fuzz_percent_raises_the_port_reads_a_percent():
    """The JAX -connected-components reads -fuzz with float(...)/100, so
    "10%" raises there; the port reads it with ``_percent`` as every
    other option does, "10%" and "10" alike."""
    argv = ["-threshold", "50%", "-fuzz", "10%", "-connected-components", "4"]
    js, ts = _states([_natural(24, 32, 0)])
    with pytest.raises(ValueError):
        jm.process(list(argv), js)
    tm.process(list(argv), ts)
    got = tm.materialize_all(ts.images)
    js2, ts2 = _states([_natural(24, 32, 0)])
    argv2 = ["-threshold", "50%", "-fuzz", "10", "-connected-components", "4"]
    jm.process(argv2, js2)
    tm.process(argv2, ts2)
    want = jm.materialize_all(js2.images)
    np.testing.assert_array_equal(got[0].data.numpy(),
                                  np.asarray(want[0].data))
    np.testing.assert_array_equal(tm.materialize_all(ts2.images)[0].data
                                  .numpy(), np.asarray(want[0].data))


def test_cli_vision_chain_fuses_its_resize_once(monkeypatch):
    """-resize 50% -canny ... -hough-lines: the group's resize in one
    fused call, then Canny and Hough image by image."""
    calls = []
    real = tdsp.try_fused_batch
    monkeypatch.setattr(tdsp, "try_fused_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    js, ts = _states([_natural(80, 112, s) for s in range(3)])
    argv = ["-resize", "50%", "-canny", "0x1+10%+30%", "-hough-lines",
            "9x9+10"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    got = tm.materialize_all(ts.images)
    assert len(calls) == 1
    for g, w in zip(got, jm.materialize_all(js.images)):
        assert tuple(g.data.shape) == tuple(np.asarray(w.data).shape)


# -- layers, montage, visual effects and the options that need no file ------

# each against the JAX CLI on the same 3 images of 40x56: tags, settings,
# list length, shapes, specs, pages, delays and pixels.  Pixels within
# 1e-5, the bound of the effects' own files (the JAX CLI jits each chain,
# and an ulp there moves a normalized or blurred value by about 1e-6; most
# come out equal), but for -integral, a float32 running sum in another
# order (rtol 1e-6), and the phase of -fft, which is held through the
# complex value it encodes (1e-5 of max|F|, as ``test_torch_fourier.py``
# holds it: where |F| is tiny its angle means nothing).
SLICE_ARGVS = [
    ["-charcoal", "1"], ["-charcoal", "2x0.5"], ["-wavelet-denoise", "5%"],
    ["-wavelet-denoise", "2000x0.2"], ["-sepia-tone", "80%"],
    ["-solarize", "50%"], ["-blue-shift", "1.5"],
    ["-fill", "red", "-tint", "60"], ["-fill", "gold", "-tint", "80x20+50"],
    ["-fill", "blue", "-colorize", "30,20,10"],
    ["-fill", "navy", "-colorize", "40%"],
    ["-color-matrix", "0.5 0.3 0.2 0.1 0.8 0.1 0.2 0.2 0.6"],
    ["-recolor", "1.2 0 0 0 0 0.1 0 0.9 0 0 0 0 0 0 1 0 0 0 0 0 0 1 0 0 "
     "0 0 0 0 1 0 0 0 0 0 0 1"],
    ["-vignette", "0x3+4+4"], ["-background", "navy", "-vignette", "0x2"],
    ["-vignette", "0x2+10+10%"], ["-noise", "1"], ["-noise", "2"],
    ["-shadow", "60x2+3+3"], ["-shadow"], ["-background", "red", "-shadow",
                                           "80x1"],
    ["-polaroid", "8"], ["+polaroid", "0"], ["-stegano", "0"],
    ["-stereo", "+3+2"], ["-stereo", "-2+0"],
    ["-morphology", "close", "disk:2"], ["-morphology", "erode:2",
                                         "square:1"],
    ["-virtual-pixel", "black", "-morphology", "dilate", "diamond:1"],
    ["-convolve", "1,2,1,2,4,2,1,2,1"], ["-fft"], ["+fft"],
    ["-fft", "-ift"], ["+fft", "+ift"], ["-complex", "multiply"],
    ["-complex", "add"], ["-clut"], ["-interpolate", "nearest", "-clut"],
    ["-hald-clut"], ["-cdl", "1.1,0.05,0.9:0.8"],
    ["-cdl", "1,1,1.2,0,0,0.1,1,0.9,1"], ["-level-colors", "navy,gold"],
    ["+level-colors", "navy,gold"], ["-level-colors", "white,black"],
    ["-levelize", "10%,90%,1.2"], ["-contrast"], ["+contrast"],
    ["-local-contrast", "5x30"], ["-grayscale", "rec601luma"],
    ["-grayscale", "average"], ["-monochrome"],
    ["-range-threshold", "10%,30%,60%,90%"],
    ["-color-threshold", "rgb(20,20,20)-rgb(200,220,240)"],
    ["-perceptible", "0.1"], ["-integral"], ["-sort-pixels"],
    ["-resample", "144"], ["-density", "144", "-resample", "72x36"],
    ["-filter", "box", "-resample", "100"],
    ["-interpolative-resize", "30x20"],
    ["-interpolate", "nearest", "-interpolative-resize", "50%"],
    ["-gaussian", "0x1.5"], ["-poly", "0.5,1 0.3,2 0.2,0.5"], ["-noop"],
    ["-orient", "right-top"], ["-duplicate", "2"], ["-insert", "0"],
    ["-cycle", "64"], ["-preview", "blur"], ["-preview", "hue"],
    ["-preview", "gamma"], ["-filter", "box", "-resize", "50%"],
    ["-filter", "triangle", "-resize", "30x20!"],
    ["-repage", "+5+3", "-coalesce"], ["-layers", "coalesce"],
    ["-layers", "optimize"], ["-layers", "optimize-transparency"],
    ["-layers", "remove-dups"], ["-layers", "remove-zero"],
    ["-layers", "compare-any"], ["-layers", "merge"],
    ["-layers", "trim-bounds"], ["-layers", "dispose"],
    ["-fuzz", "20%", "-layers", "optimize"], ["-deconstruct"],
    ["-repage", "+10+4", "-flatten"], ["-repage", "+10+4", "-mosaic"],
    ["-repage", "100x80+3-2!", "-mosaic"], ["+repage", "-flatten"],
    ["-append"], ["+append"], ["-gravity", "center", "-append"],
    ["-gravity", "south", "+append"], ["-smush", "2"], ["+smush", "-3"],
    ["-montage"], ["-tile", "2x2", "-geometry", "30x30+2+2", "-montage"],
    ["-label", "abc", "-montage"],
    ["-page", "+3+3", "-delay", "20", "-attenuate", "0.5", "-coalesce"],
    ["-shadow", "-flatten"],
    ["-clone", "0"], ["+clone"], ["-clone", "0-1", "-append"],
    ["(", "-clone", "1", "-negate", ")"], ["-delete", "0"], ["+delete"],
    ["-delete", "0,2"], ["-delete", "1-2"], ["-swap", "0,2"], ["+swap"],
    ["-reverse"], ["-set", "caption", "x"], ["-comment", "hello"],
    ["-set", "a", "b", "-comment", "c", "-strip"],
    ["-copy", "10x8+2+3", "+5+4"], ["-resize", "50%", "-clone", "1"],
]


def _assert_slice_close(argv, got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert repr(g.spec) == repr(w.spec), argv
        assert (g.page, g.delay, g.properties) == \
            (w.page, w.delay, w.properties), argv
        g, w = g.data.numpy(), np.asarray(w.data)
        assert g.shape == w.shape, argv
        if argv[0] == "-fft" and k % 2 and "-ift" not in argv:
            m = got[k - 1].data.numpy()
            polar = lambda mag, ph: mag * np.exp(2j * np.pi * (ph - 0.5))
            wm = np.asarray(want[k - 1].data)
            assert np.abs(polar(m, g) - polar(wm, w)).max() <= \
                1e-5 * np.abs(wm).max(), argv
        elif "-integral" in argv:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("argv", SLICE_ARGVS, ids=" ".join)
@pytest.mark.parametrize("alpha", [False, True])
def test_slice_options_match_jax(argv, alpha):
    """Every new option, list operator and setting on 3 images (RGB or
    RGBA, the last two holding the first's background with a moved
    block, so that the layer operators find boxes and duplicates)."""
    c = 4 if alpha else 3
    base = _natural(40, 56, 0, c)
    images = [base]
    for k in (1, 2):
        im = base.copy()
        im[4 * k:4 * k + 9, 6 * k:6 * k + 13] = _natural(9, 13, k, c)
        images.append(im)
    js, ts = _states(images, alpha)
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js)
    assert ts.settings == {k: v for k, v in js.settings.items()
                           if k in ts.settings}
    _assert_slice_close(argv, tm.materialize_all(ts.images),
                        jm.materialize_all(js.images))


def _delayed_states(delays, equal=True):
    """Three equal (or distinct) frames with the given delays, as Images
    of each package built by the caller (kept so the test can look at
    them afterwards)."""
    x = _natural(20, 28, 4)
    frames = [x if equal else _natural(20, 28, k) for k in range(3)]
    jimgs = [JImage(jnp.asarray(f), JSpec(colorspace="srgb"), None, None,
                    None, d) for f, d in zip(frames, delays)]
    timgs = [TImage(torch.from_numpy(f), TSpec(colorspace="srgb"), None,
                    None, None, d) for f, d in zip(frames, delays)]
    js, ts = jm.CLIState(), tm.CLIState()
    js.images = [jm.LazyImage(i) for i in jimgs]
    ts.images = [tm.LazyImage(i) for i in timgs]
    return js, ts, jimgs, timgs


@pytest.mark.parametrize("method", ["remove-dups", "remove-zero",
                                    "optimize", "coalesce"])
def test_layers_keep_delays_as_jax(method):
    js, ts, _, _ = _delayed_states([10, 0, 25], equal=method != "remove-dups")
    jm.process(["-layers", method], js)
    tm.process(["-layers", method], ts)
    _assert_slice_close(["-layers", method], tm.materialize_all(ts.images),
                        jm.materialize_all(js.images))


def test_jax_layers_remove_dups_changes_the_callers_delay():
    """The JAX -layers remove-dups adds the dropped frames' delays to the
    caller's own first Image; the port's list gets a new frame with the
    sum and the caller's Images keep their delays."""
    js, ts, jimgs, timgs = _delayed_states([10, 20, 30])
    jm.process(["-layers", "remove-dups"], js)
    tm.process(["-layers", "remove-dups"], ts)
    assert [li.image.delay for li in js.images] == [60]
    assert [li.image.delay for li in ts.images] == [60]
    assert [i.delay for i in jimgs] == [60, 20, 30]
    assert [i.delay for i in timgs] == [10, 20, 30]


def test_sketch_on_jax_variates_matches_jax(monkeypatch):
    """-sketch: the port's draw replaced by the JAX CLI's (PRNGKey(7) for
    each image), then the outputs held to the JAX CLI's (1e-5)."""
    import jax

    from imagemagick_tpu_torch.ops import visual_effects as tv

    def jax_draw(img, generator=None):
        h, w = img.shape[-3], img.shape[-2]
        v = jax.random.uniform(jax.random.PRNGKey(7), (2 * h, 2 * w, 1),
                               jnp.float32)
        return torch.from_numpy(np.array(v))

    monkeypatch.setattr(tv, "sketch_variates", jax_draw)
    for alpha in (False, True):
        images = [_natural(24, 30, s, 4 if alpha else 3) for s in range(2)]
        js, ts = _states(images, alpha)
        argv = ["-sketch", "0x1+30"]
        jm.process(list(argv), js)
        tm.process(list(argv), ts)
        for g, w in zip(tm.materialize_all(ts.images),
                        jm.materialize_all(js.images)):
            np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data),
                                       atol=1e-5)


@pytest.mark.parametrize("kind", ["gaussian", "uniform", "impulse",
                                  "laplacian", "poisson"])
def test_plus_noise_on_jax_variates_matches_jax(monkeypatch, kind):
    """+noise: the JAX CLI's clock fixed and the port's draw replaced by
    the variates the JAX key gives; the outputs equal within 1e-6."""
    import jax

    from imagemagick_tpu_torch.ops import visual_effects as tv

    monkeypatch.setattr(jm.time, "time_ns", lambda: 123456789)
    key = jax.random.PRNGKey(123456789 % (2 ** 31))

    def jax_draw(img, noise_type, attenuate=1.0, generator=None):
        x = jnp.asarray(img.numpy())
        if noise_type == "gaussian":
            k1, k2 = jax.random.split(key)
            vs = (jax.random.normal(k1, x.shape),
                  jax.random.normal(k2, x.shape))
        elif noise_type == "laplacian":
            vs = (jax.random.uniform(key, x.shape, minval=-0.4999,
                                     maxval=0.4999),)
        elif noise_type == "poisson":
            lam = jnp.maximum(x * 255.0 / jnp.maximum(attenuate, 1e-3), 1e-6)
            vs = (jax.random.poisson(key, lam).astype(x.dtype),)
        else:
            vs = (jax.random.uniform(key, x.shape),)
        return tuple(torch.from_numpy(np.array(v)) for v in vs)

    monkeypatch.setattr(tv, "noise_variates", jax_draw)
    js, ts = _states([_natural(24, 30, s) for s in range(2)])
    jm.process(["+noise", kind], js)
    tm.process(["+noise", kind], ts)
    for g, w in zip(tm.materialize_all(ts.images),
                    jm.materialize_all(js.images)):
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data),
                                   atol=1e-6)


def test_jax_plus_noise_is_unrepeatable_the_port_repeats(monkeypatch):
    """The JAX +noise seeds its key from the clock, so two runs differ;
    the port draws from a generator seeded 0, so they are equal."""
    ticks = itertools.count(1000, 7919)
    monkeypatch.setattr(jm.time, "time_ns", lambda: next(ticks))
    outs_j, outs_t = [], []
    for _ in range(2):
        js, ts = _states([_natural(24, 30, 0)])
        jm.process(["+noise", "gaussian"], js)
        tm.process(["+noise", "gaussian"], ts)
        outs_j.append(np.asarray(jm.materialize_all(js.images)[0].data))
        outs_t.append(tm.materialize_all(ts.images)[0].data)
    assert not np.array_equal(outs_j[0], outs_j[1])
    assert torch.equal(outs_t[0], outs_t[1])


def test_jax_plus_noise_ignores_attenuate_the_port_reads_it(monkeypatch):
    """-attenuate 0: the JAX CLI stores it under ``attenuate`` and its
    +noise reads ``noise-attenuate``, so the noise is added all the same;
    the port's +noise reads -attenuate, and a zero amplitude leaves the
    image as it was."""
    monkeypatch.setattr(jm.time, "time_ns", lambda: 42)
    x = _natural(24, 30, 0)
    outs = {}
    for argv in (["+noise", "uniform"],
                 ["-attenuate", "0", "+noise", "uniform"]):
        js, ts = _states([x])
        jm.process(list(argv), js)
        tm.process(list(argv), ts)
        outs[len(argv)] = (np.asarray(jm.materialize_all(js.images)[0].data),
                           tm.materialize_all(ts.images)[0].data.numpy())
    assert np.array_equal(outs[2][0], outs[4][0])
    assert not np.array_equal(outs[4][0], x)
    assert np.array_equal(outs[4][1], x)
    assert not np.array_equal(outs[2][1], x)


def test_layer_settings_are_stored_as_the_jax_cli_stores_them():
    js, ts = _states([_natural(8, 8, 0), _natural(8, 8, 1)])
    argv = ["-tile", "4x2", "-page", "+3+4", "-delay", "20",
            "-attenuate", "0.3", "-filter", "Lanczos", "-interpolate",
            "nearest", "-density", "300", "-label", "cat", "-repage",
            "64x48+2+1"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    for k in ("tile", "page", "delay", "attenuate", "filter", "interpolate",
              "density"):
        assert ts.settings[k] == js.settings[k], k
    for lt, lj in zip(ts.images, js.images):
        assert lt.image.properties == lj.image.properties == {"label": "cat"}
        assert lt.image.page == lj.image.page == (2, 1, 64, 48)
    for argv in (["+repage"], ["-repage", "+5+0"], ["-repage", "+1+1!"]):
        jm.process(list(argv), js)
        tm.process(list(argv), ts)
        assert [li.image.page for li in ts.images] == \
            [li.image.page for li in js.images]
    with pytest.raises(tm.CLIError, match="requires an argument"):
        tm.process(["-label"], ts)


def test_shadow_takes_its_argument_only_when_given():
    """-shadow's argument is optional: an option after it is not taken."""
    js, ts = _states([_natural(20, 24, 0)])
    argv = ["-shadow", "-blue-shift", "1.2"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    assert _tags(ts) == _tags(js) == [[None]]
    _assert_slice_close(argv, tm.materialize_all(ts.images),
                        jm.materialize_all(js.images))


def test_moments_print_as_jax(capsys):
    """The same names and numbers (float32 sums in another order: each
    value within 1e-4 relative)."""
    js, ts = _states([_natural(30, 40, s) for s in range(2)])
    jm.process(["-moments"], js)
    want = capsys.readouterr().out.splitlines()
    tm.process(["-moments"], ts)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        # a line is "  name: [values" or a continuation of the values
        gk, _, gv = g.rpartition(": ")
        wk, _, wv = w.rpartition(": ")
        assert gk == wk
        gn = np.array([float(v) for v in _NUMBER_RE_T.findall(gv)])
        wn = np.array([float(v) for v in _NUMBER_RE_T.findall(wv)])
        np.testing.assert_allclose(gn, wn, rtol=1e-4, atol=1e-6)


_NUMBER_RE_T = tm._NUMBER_RE


@pytest.mark.parametrize("argv,calls", [
    (["-resize", "50%", "-charcoal", "1", "-tile", "2x2", "-montage"], 1),
    (["-resize", "50%", "-polaroid", "5", "-background", "white",
      "-flatten"], 1),
    (["-resize", "50%", "-morphology", "close", "disk:2", "-level-colors",
      "navy,gold", "-fft"], 1),
])
def test_slice_chains_fuse_their_resize_once(monkeypatch, argv, calls):
    """A resize before the slice's list options runs as ONE fused call
    for the group (``materialize_all``); the rest image by image."""
    seen = []
    real = tdsp.try_fused_batch
    monkeypatch.setattr(tdsp, "try_fused_batch",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    js, ts = _states([_natural(40, 56, s) for s in range(3)])
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    got = tm.materialize_all(ts.images)
    assert len(seen) == calls
    want = jm.materialize_all(js.images)
    assert [tuple(g.data.shape) for g in got] == \
        [np.asarray(w.data).shape for w in want]


def test_jax_tint_reads_the_fill_late_the_port_binds_it():
    """The JAX -tint reads -fill when its chain runs, so a -fill set after
    it (before the list materializes) tints with the later color; the
    port binds the fill the option saw, as every other option does."""
    x = _natural(24, 30, 0)
    js, ts = _states([x])
    argv = ["-fill", "red", "-tint", "60", "-fill", "blue"]
    jm.process(list(argv), js)
    tm.process(list(argv), ts)
    late = jm.materialize_all(js.images)[0].data
    got = tm.materialize_all(ts.images)[0].data.numpy()
    js2, ts2 = _states([x])
    for st, mod in ((js2, jm), (ts2, tm)):
        mod.process(["-fill", "blue", "-tint", "60"], st)
    np.testing.assert_array_equal(np.asarray(late), np.asarray(
        jm.materialize_all(js2.images)[0].data))
    js3, _ = _states([x])
    jm.process(["-fill", "red", "-tint", "60"], js3)
    np.testing.assert_allclose(got, np.asarray(
        jm.materialize_all(js3.images)[0].data), atol=1e-6, rtol=0)
    assert not np.allclose(got, np.asarray(late), atol=1e-3)
