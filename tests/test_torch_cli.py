"""Port parity: the CLI's ``config1_cli`` subset against the JAX CLI.

The tags that ``process`` queues must equal the JAX CLI's for the same
arguments.  On the CPU the JAX CLI runs its chains as XLA ops, which clip
after every op, while the port's fused route (K1's plain version here)
clips once at the end: the route gate is >= 60 dB."""

import importlib

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
    assert tdsp.COUNTS == {"fused": before["fused"] + 1, "op": before["op"]}
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
    assert tdsp.COUNTS == {"fused": before["fused"], "op": before["op"] + 1}
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


@pytest.mark.parametrize("argv,entry", [
    (["in.png"], "'Host layers' (io/)"),
    (["-resize", "10x10", "out.jpg"], "'Host layers' (io/)"),
    (["-sample", "10x10"], "(ops/resize.py)"),
    (["-scale", "10x10"], "(ops/resize.py)"),
    (["-thumbnail", "10x10"], "(ops/resize.py)"),
    (["-sharpen", "0x1"], "'The other op families under ops/'"),
    (["-filter", "box"], "'The other op families under ops/'"),
    (["-unknown-option"], "'The rest of the modules that the slices"),
])
def test_unported_raise_naming_their_entries(argv, entry):
    st = tm.CLIState()
    st.images.append(tm.LazyImage(TImage(torch.zeros(8, 8, 3))))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1") as e:
        tm.process(argv, st)
    assert entry in str(e.value)


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
