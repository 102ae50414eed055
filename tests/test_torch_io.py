"""Port parity: io/ (the PIL bridge, PNM, raw samples, the pseudo formats,
mpr:, mask:, detect_format, identify) against the JAX package's io/.

Inputs are made from a seed with numpy and encoded with PIL.  Equal
pixels must give equal bytes, and equal bytes equal arrays, specs and
properties.  Both sides must take the same codec: the JPEG cases run
with both packages' native codecs (where both build) and with
neither (PIL's), and every PNG case turns both sides' native libpng off
(the JAX ``available()``, the port's ``png_available()``), as on a host
without libpng; ``tests/test_torch_io_coders.py`` holds the native PNG.
The identify text is held line by line: numbers within 1e-5 relative or
5e-5 absolute (float32 reductions in another order; the JAX skewness is
1.6e-5 off float64 here, the port's 1e-6), the rest exactly, but for the Version line, which names the
package.  Raw CMYK and YCbCr samples at depth 16 are held within one
level (the color conversion's float32 products in another order)."""

import importlib
import io as _io
import json
import os
import re
import struct
import sys

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.io import identify as tident

jio = importlib.import_module("imagemagick_tpu.io")
jident = importlib.import_module("imagemagick_tpu.io.identify")
jnat = importlib.import_module("imagemagick_tpu.native")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec
TSpec = importlib.import_module("imagemagick_tpu_torch.core.spec").ImageSpec

NUM_REL = 1e-5
NUM_ABS = 5e-5   # skewness and kurtosis: the JAX float32 third moment is
                 # 1.6e-5 off float64 on these images, the port's 1e-6


def _pixels(seed=0, h=24, w=32, c=3):
    """Smooth texture, flat blocks and a little noise, float32 in [0, 1],
    on the 8-bit grid (so a u8 codec round-trips it)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 5.0)[..., None] * np.cos(
        xx[..., None] / 7.0 + np.arange(c))
    img = np.clip(base + 0.05 * rng.standard_normal((h, w, c)), 0, 1)
    img[h // 3:h // 2, w // 4:w // 2] = 0.75
    return np.round(img * 255.0).astype(np.float32) / np.float32(255.0)


def _pair(arr, **spec):
    return (TImage(torch.from_numpy(arr.copy()), TSpec(**spec)),
            JImage(arr.copy(), JSpec(**spec)))


def _arr(img) -> np.ndarray:
    d = img.data
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _same_images(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_arr(g), _arr(w))
        assert (g.spec.colorspace, g.spec.alpha, g.spec.depth) == \
            (w.spec.colorspace, w.spec.alpha, w.spec.depth)
        assert g.properties == w.properties
        assert g.profiles == w.profiles
        assert g.delay == w.delay


@pytest.fixture
def no_png_native(monkeypatch):
    """The JAX side without its native libpng (and so without its native
    JPEG too), the port without its native JPEG and PNG codecs: both take
    PIL."""
    monkeypatch.setattr(jnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "png_available", lambda: False)


@pytest.fixture(params=["native", "pil"])
def jpeg_codec(request, monkeypatch):
    if request.param == "pil":
        monkeypatch.setattr(jnat, "available", lambda: False)
        monkeypatch.setattr(tnat, "available", lambda: False)
        monkeypatch.setattr(tnat, "png_available", lambda: False)
    elif not (tnat.available() and jnat.available()):
        pytest.skip("the native JPEG codecs do not build here")
    return request.param


# -- detect_format: the whole magic table ------------------------------------

def _magic_cases():
    cases = []
    for magic, fmt in jio._MAGIC:
        blob = magic + b"\0" * 64
        if fmt == "webp":
            blob = magic + b"\0\0\0\0WEBPVP8 " + b"\0" * 64
        cases.append(pytest.param(blob, id=f"{fmt}-{magic[:6]!r}"))
    extra = {
        "emf": b"\x01\0\0\0" + b"\0" * 36 + b" EMF" + b"\0" * 40,
        "ico": b"\0\0\x01\0\x02\0" + b"\0" * 40,
        "ico-bad-count": b"\0\0\x01\0\0\0" + b"\0" * 40,
        "avif": b"\0\0\0\x1cftypavif" + b"\0" * 40,
        "heic": b"\0\0\0\x1cftypheic" + b"\0" * 40,
        "jxl": b"\xff\x0a" + b"\0" * 40,
        "jxl-box": b"\x00\x00\x00\x0cJXL \r\n\x87\n" + b"\0" * 40,
        "ora": b"PK\x03\x04" + b"\0" * 26 + b"mimetypeimage/openraster",
        "ff": b"farbfeld" + b"\0" * 16,
        "exr": b"\x76\x2f\x31\x01" + b"\0" * 16,
        "hdr": b"#?RADIANCE\n" + b"\0" * 16,
        "xpm": b"  /* XPM */\nstatic char *x[] = {};",
        "xbm": b"#define x_width 8\nstatic char x_bits[] = {0};",
        "svg": b'<?xml version="1.0"?><svg width="4"/>',
        "pdf": b"%PDF-1.4\n",
        "ps": b"%!PS-Adobe-3.0\n",
        "dcm": b"\0" * 128 + b"DICM" + b"\0" * 16,
        "pwp": b"SFW95" + b"\0" * 16,
        "sfw": b"SFW94" + b"\0" * 16,
        "ttf": b"\x00\x01\x00\x00" + b"\0" * 600,
        "pdb": b"\0" * 60 + b"vIMGView" + b"\0" * 40,
        "xwd": struct.pack(">I", 120) + b"\0\0\0\x07" + b"\0" * 120,
        "nothing": b"\x13\x37" * 40,
    }
    cases += [pytest.param(b, id=k) for k, b in extra.items()]
    return cases


@pytest.mark.parametrize("blob", _magic_cases())
def test_detect_format_matches_jax(blob):
    assert tio.detect_format(blob) == jio.detect_format(blob)


@pytest.mark.parametrize("name", [
    "x.png", "png:x.out", "PNG:x", "gradient:red-blue", "mpr:one",
    "mask:m.png", "clip:c.tif", "miff:-", "url:http://h/x.png", "kernel:unity",
    "info:", "json:-", "c:/dir/x.png", "nosuch:x.png", "8bim:x", "mp4:v",
    "rgb:raw.bin", "ycbcr:x", "-", "label:a:b"])
def test_split_filename_matches_jax(name):
    assert tio._split_filename(name) == jio._split_filename(name)


# -- the PIL bridge ---------------------------------------------------------

# every format of the JAX bridge's table; those the port routes to another
# coder (ppm: pnm.py) or has not ported (xbm, heic) are held apart
PIL_FORMATS = sorted(set(jio.codecs._PIL_FORMATS) - {"ppm", "xbm", "heic"})


def _encode_pair(fmt, timgs, jimgs, **kw):
    """(port bytes, JAX bytes, or the exception each raised)."""
    out = []
    for mod, imgs in ((tio, timgs), (jio, jimgs)):
        try:
            out.append(mod.image_to_blob(imgs, fmt, **kw))
        except Exception as e:   # noqa: BLE001 — compared below
            out.append(e)
    return out


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("fmt", PIL_FORMATS)
def test_pil_formats_encode_and_decode_like_jax(no_png_native, fmt,
                                                channels):
    """Each PIL format that PIL here writes: equal bytes from equal pixels
    (at depth 8, and at depth 16 for PNG and TIFF's 8-bit fallback), and
    each side's decode of those bytes equal.  A format that PIL cannot
    write here fails in both."""
    spec = dict(colorspace="gray" if channels == 1 else "srgb",
                alpha=channels == 4, depth=8)
    t, j = _pair(_pixels(channels, c=channels), **spec)
    got, want = _encode_pair(fmt, [t], [j], quality=85)
    if isinstance(want, Exception):
        assert isinstance(got, Exception)
        return
    assert not isinstance(got, Exception), got
    assert got == want
    try:
        wimgs = jio.image_from_blob(want, fmt)
    except Exception as e:   # noqa: BLE001 — then the port must raise too
        # the same exception (each package has its own DelegateError)
        with pytest.raises(Exception) as raised:
            tio.image_from_blob(got, fmt, device="cpu")
        assert type(raised.value).__name__ in (type(e).__name__,
                                               "NotImplementedError")
        return
    _same_images(tio.image_from_blob(got, fmt, device="cpu"), wimgs)


@pytest.mark.parametrize("quality", [50, 85, 92])
@pytest.mark.parametrize("channels", [1, 3])
def test_jpeg_bytes_match_jax(jpeg_codec, quality, channels):
    spec = dict(colorspace="gray" if channels == 1 else "srgb", depth=8)
    t, j = _pair(_pixels(10 + channels, h=37, w=50, c=channels), **spec)
    got, want = _encode_pair("jpeg", [t], [j], quality=quality)
    assert got == want
    _same_images(tio.image_from_blob(got, "jpeg", device="cpu"),
                 jio.image_from_blob(want, "jpeg"))


def test_png_depth16_and_gray_reduction_match_jax(no_png_native):
    """16-bit gray PNGs, their 8-bit reduction, and an RGB image with
    equal channels stored as gray, as the JAX bridge writes them without
    libpng."""
    g16 = np.random.default_rng(3).integers(0, 65536, (9, 13, 1)) \
        .astype(np.float32) / np.float32(65535)
    for arr, spec in ((g16, dict(colorspace="gray", depth=16)),
                      (np.repeat(_pixels(4, c=1), 3, -1),
                       dict(colorspace="srgb", depth=8)),
                      (_pixels(5, c=1), dict(colorspace="gray", depth=16))):
        t, j = _pair(arr, **spec)
        got, want = _encode_pair("png", [t], [j])
        assert got == want
        _same_images(tio.image_from_blob(got, "png", device="cpu"),
                     jio.image_from_blob(want, "png"))


def test_animated_gif_and_multipage_tiff_match_jax(no_png_native):
    frames = [_pair(_pixels(20 + k), depth=8) for k in range(3)]
    for k, (t, j) in enumerate(frames):
        t.delay = j.delay = 5 + k
    for fmt in ("gif", "tiff"):
        got, want = _encode_pair(fmt, [t for t, _ in frames],
                                 [j for _, j in frames])
        assert got == want
        _same_images(tio.image_from_blob(got, fmt, device="cpu"),
                     jio.image_from_blob(want, fmt))


def test_icc_profile_and_density_properties_match_jax(no_png_native):
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    buf = _io.BytesIO()
    from PIL import Image as PImage

    PImage.fromarray((_pixels(8) * 255).astype(np.uint8)).save(
        buf, "PNG", icc_profile=icc, dpi=(300, 300))
    blob = buf.getvalue()
    got = tio.image_from_blob(blob, device="cpu")
    _same_images(got, jio.image_from_blob(blob))
    assert got[0].profiles["icc"] == icc
    buf = _io.BytesIO()
    PImage.fromarray((_pixels(9) * 255).astype(np.uint8)).save(
        buf, "JPEG", dpi=(150, 150))
    _same_images(tio.image_from_blob(buf.getvalue(), device="cpu"),
                 jio.image_from_blob(buf.getvalue()))


# -- PNM --------------------------------------------------------------------

def _pnm_blobs():
    rng = np.random.default_rng(11)
    h, w = 5, 7
    bits = rng.integers(0, 2, (h, w))
    g8 = rng.integers(0, 256, (h, w))
    rgb8 = rng.integers(0, 256, (h, w, 3))
    g16 = rng.integers(0, 65536, (h, w))
    rgba = rng.integers(0, 256, (h, w, 4))
    fl = rng.uniform(-0.5, 1.5, (h, w, 3)).astype("<f4")

    def ascii_(magic, vals, maxv=None):
        head = f"{magic}\n#comment\n{w} {h}\n" + \
            (f"{maxv}\n" if maxv else "")
        return (head + " ".join(str(int(v)) for v in vals.ravel())).encode()

    packed = np.packbits(bits.astype(np.uint8), axis=1).tobytes()
    return {
        "P1": ascii_("P1", bits),
        "P2": ascii_("P2", g8, 255),
        "P3": ascii_("P3", rgb8, 255),
        "P4": f"P4\n{w} {h}\n".encode() + packed,
        "P5": f"P5\n{w} {h}\n255\n".encode() + g8.astype(np.uint8).tobytes(),
        "P5-16": f"P5\n{w} {h}\n65535\n".encode() +
        g16.astype(">u2").tobytes(),
        "P6": f"P6 {w} {h} 255\n".encode() + rgb8.astype(np.uint8).tobytes(),
        "P7": (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 4\nMAXVAL 255\n"
               "TUPLTYPE RGB_ALPHA\nENDHDR\n").encode() +
        rgba.astype(np.uint8).tobytes(),
        "PF": f"PF\n{w} {h}\n-1.0\n".encode() + fl.tobytes(),
        "Pf": f"Pf\n{w} {h}\n-1.0\n".encode() + fl[..., 0].copy().tobytes(),
    }


@pytest.mark.parametrize("kind", sorted(_pnm_blobs()))
def test_pnm_decode_matches_jax(kind):
    blob = _pnm_blobs()[kind]
    _same_images(tio.image_from_blob(blob, device="cpu"),
                 jio.image_from_blob(blob))


def test_jax_ascii_pnm_comment_of_two_words_raises_the_port_skips_it():
    """A comment of several words in an ASCII PNM header: the JAX decoder
    drops only the tokens that start with '#' and raises on the next word;
    the port drops the comment to the end of its line."""
    blob = b"P2\n# made by a scanner\n3 2\n255\n0 1 2\n3 4 255\n"
    with pytest.raises(ValueError):
        jio.image_from_blob(blob)
    got = tio.image_from_blob(blob, device="cpu")[0]
    want = jio.image_from_blob(blob.replace(b"# made by a scanner", b"#x"))
    _same_images([got], want)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("fmt", ["ppm", "pgm", "pbm", "pnm", "pam", "pfm"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_pnm_encode_matches_jax(fmt, depth, channels):
    if fmt == "pam" and channels == 4:
        spec = dict(alpha=True)
    else:
        spec = dict(colorspace="gray" if channels == 1 else "srgb",
                    alpha=channels == 4)
    arr = np.random.default_rng(depth + channels).uniform(
        -0.1, 1.1, (6, 9, channels)).astype(np.float32)
    t, j = _pair(arr, **spec)
    got, want = _encode_pair(fmt, [t], [j], depth=depth)
    assert got == want


# -- raw samples ------------------------------------------------------------

RAW = ["gray", "rgb", "rgba", "bgr", "bgra", "cmyk", "ycbcr"]


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("fmt", RAW + ["uyvy", "raw"])
def test_raw_encode_matches_jax(fmt, depth):
    for c, alpha in ((1, False), (3, False), (4, True)):
        t, j = _pair(_pixels(30 + c, h=6, w=10, c=c),
                     colorspace="gray" if c == 1 else "srgb", alpha=alpha)
        got, want = _encode_pair(fmt, [t], [j], depth=depth)
        if fmt in ("cmyk", "ycbcr", "uyvy") and depth == 16:
            # the color conversion's float32 products in another order:
            # a 16-bit sample may round the other way
            a = np.frombuffer(got, ">u2").astype(int)
            b = np.frombuffer(want, ">u2").astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1
        else:
            assert got == want, (fmt, c)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("fmt", RAW + ["raw"])
def test_raw_read_matches_jax(tmp_path, fmt, depth):
    nch = {"gray": 1, "raw": 1, "rgb": 3, "bgr": 3, "ycbcr": 3}.get(fmt, 4)
    blob = np.random.default_rng(depth).integers(
        0, 256, 6 * 10 * nch * depth // 8, dtype=np.uint8).tobytes()
    path = str(tmp_path / f"x.{fmt}")
    with open(path, "wb") as f:
        f.write(blob)
    for name in (path, f"{fmt}:{path}"):
        _same_images(tio.read_images(name, size="10x6", device="cpu"),
                     jio.read_images(name, size="10x6"))


# -- the pseudo formats -----------------------------------------------------

PSEUDO = [
    ("xc:red", None), ("xc:#00ff0080", "5x3"), ("canvas:navy", "4x6"),
    ("xc:", None), ("gradient:", "7x9"), ("gradient:red-blue", "33x256"),
    ("gradient:white-#0000ff80", "13x1"), ("gradient:yellow", "5x1080"),
    ("radial-gradient:", "31x17"), ("radial-gradient:red-blue", "64x48"),
    ("plasma:", "40x30"), ("plasma:fractal", "17x8"),
    ("pattern:checkerboard", "70x50"), ("pattern:gray50", "6x4"),
    ("hald:4", None), ("hald:", None), ("logo:", None), ("rose:", None),
    ("wizard:", None), ("granite:", None), ("netscape:", None),
    ("null:", None), ("null:", "3x2"), ("label:Hello GPU", None),
    ("label:Wide", "80x30"), ("caption:a few words that wrap here", "60x")]


@pytest.mark.parametrize("name,size", PSEUDO)
def test_pseudo_formats_match_jax(name, size):
    settings = {"pointsize": "14", "fill": "navy", "background": "#eeeeee"}
    got = tio.read_images(name, size, dict(settings), device="cpu")
    want = jio.read_images(name, size, dict(settings))
    _same_images(got, want)


def _write_png(path, arr):
    from PIL import Image as PImage

    PImage.fromarray((arr * 255 + 0.5).astype(np.uint8).squeeze()).save(path)


@pytest.mark.parametrize("kind,size", [("tile", "50x40"), ("tile", None),
                                       ("histogram", None),
                                       ("histogram", "64x32"),
                                       ("thumbnail", "16x"),
                                       ("thumbnail", None)])
def test_file_pseudo_formats_match_jax(no_png_native, tmp_path, kind, size):
    path = str(tmp_path / "src.png")
    _write_png(path, _pixels(40, h=30, w=44))
    got = tio.read_images(f"{kind}:{path}", size, device="cpu")
    want = jio.read_images(f"{kind}:{path}", size)
    if kind == "thumbnail":   # a resize: float32 sums in another order
        np.testing.assert_allclose(_arr(got[0]), _arr(want[0]), atol=2e-6)
        return
    _same_images(got, want)


def test_vid_matches_jax(no_png_native, tmp_path):
    for k in range(3):
        _write_png(str(tmp_path / f"f{k}.png"), _pixels(50 + k, h=30, w=40))
    pattern = str(tmp_path / "f*.png")
    got = tio.read_images(f"vid:{pattern}", "24x", device="cpu")[0]
    want = jio.read_images(f"vid:{pattern}", "24x")[0]
    assert got.data.shape == tuple(want.data.shape)
    np.testing.assert_allclose(_arr(got), _arr(want), atol=2e-6)


def test_stegano_raises_naming_its_entry(no_png_native, tmp_path):
    """Once unported, now read: a stegano: extraction equal to the JAX
    one, and without -size the JAX reader's ValueError."""
    path = str(tmp_path / "host.png")
    _write_png(path, _pixels(59, h=12, w=15))
    _same_images(tio.read_images(f"stegano:{path}", "8x8", device="cpu"),
                 jio.read_images(f"stegano:{path}", "8x8"))
    with pytest.raises(ValueError, match="-size"):
        tio.read_images(f"stegano:{path}", device="cpu")


# -- mpr:, mask:, null:, clip: ----------------------------------------------

def test_mpr_round_trip():
    t, _ = _pair(_pixels(60))
    tio.write_image([t, t], "mpr:pair")
    back = tio.read_images("mpr:pair", device="cpu")
    assert len(back) == 2 and back[0] is t
    with pytest.raises(FileNotFoundError):
        tio.read_images("mpr:nosuch", device="cpu")


def test_mask_read_and_write_match_jax(no_png_native, tmp_path):
    path = str(tmp_path / "m.png")
    _write_png(path, _pixels(61))
    _same_images(tio.read_images(f"mask:{path}", device="cpu"),
                 jio.read_images(f"mask:{path}"))
    m = (_pixels(62, c=1)[..., 0] > 0.5).astype(np.float32)
    t, j = _pair(_pixels(63))
    t.properties["wand:mask"] = j.properties["wand:mask"] = m
    tio.write_image(t, "mask:" + str(tmp_path / "port.png"))
    jio.write_image(j, "mask:" + str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    with pytest.raises(ValueError, match="Mask"):
        tio.write_image(_pair(_pixels(0))[0], "mask:" + str(tmp_path / "n.png"))
    tio.write_image(t, "null:")


def test_clip_reads_the_8bim_path_like_jax(no_png_native, tmp_path):
    path = str(tmp_path / "c.png")
    _write_png(path, _pixels(64, h=30, w=40))
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_services import _clip_8bim

    t = tio.read_images(path, device="cpu")[0]
    j = jio.read_images(path)[0]
    t.profiles["8bim"] = j.profiles["8bim"] = _clip_8bim(40, 30)
    from imagemagick_tpu.io import coders_r4 as jc
    from imagemagick_tpu_torch.io import coders_r4 as tc

    _same_images(tc.read_clip([t]), jc.read_clip([j]))
    with pytest.raises(ValueError, match="ClipMask"):
        tc.read_clip([tio.read_images(path, device="cpu")[0]])


# -- write_image: names, adjoin, stdout -------------------------------------

def test_scene_names_and_adjoin(no_png_native, tmp_path):
    """Several PNGs: %d names and stem-N names as in the JAX writer.  For
    PNM, the JAX writer writes only the first image under a literal
    '%d' name and one image for an adjoin name; the port expands the %d
    and writes every image one after another."""
    imgs = [_pair(_pixels(70 + k), depth=8) for k in range(3)]
    for mod, side in ((tio, 0), (jio, 1)):
        d = tmp_path / f"s{side}"
        d.mkdir()
        mod.write_image([p[side] for p in imgs], str(d / "out-%02d.png"))
        mod.write_image([p[side] for p in imgs], str(d / "seq.jpg"))
    for name in ("out-00.png", "out-01.png", "out-02.png", "seq-0.jpg",
                 "seq-2.jpg"):
        assert (tmp_path / "s0" / name).read_bytes() == \
            (tmp_path / "s1" / name).read_bytes()
    gray = [_pair(_pixels(80 + k, c=1), colorspace="gray") for k in range(3)]
    tio.write_image([g[0] for g in gray], str(tmp_path / "p-%d.pbm"))
    jio.write_image([g[1] for g in gray], str(tmp_path / "p-%d.pbm"))
    for k in range(3):
        assert (tmp_path / f"p-{k}.pbm").read_bytes() == \
            jio.image_to_blob(gray[k][1], "pbm")
    assert (tmp_path / "p-%d.pbm").read_bytes() == \
        jio.image_to_blob(gray[0][1], "pbm")       # the JAX writer's
    tio.write_image([g[0] for g in gray], str(tmp_path / "all.pgm"))
    blob = (tmp_path / "all.pgm").read_bytes()
    assert blob == b"".join(jio.image_to_blob(g[1], "pgm") for g in gray)


def test_stdout_and_info_writes(monkeypatch, capsys):
    class Out:
        def __init__(self):
            self.buffer = _io.BytesIO()

    t, j = _pair(_pixels(90, h=4, w=5), depth=8)
    out = Out()
    monkeypatch.setattr(sys, "stdout", out)   # looked up at the call
    tio.write_image(t, "ppm:-")
    assert out.buffer.getvalue() == jio.image_to_blob(j, "ppm")
    monkeypatch.undo()
    tio.write_image(t, "txt:-")
    a = capsys.readouterr().out
    jio.write_image(j, "txt:-")
    assert a == capsys.readouterr().out and a.count("\n") == 21
    tio.write_image(t, "json:")
    payload = json.loads(capsys.readouterr().out)
    assert payload["image"]["geometry"]["width"] == 5


def test_stdin_read_matches_jax(monkeypatch, no_png_native):
    from PIL import Image as PImage

    buf = _io.BytesIO()
    PImage.fromarray((_pixels(91) * 255).astype(np.uint8)).save(buf, "PNG")

    class In:
        def __init__(self, data):
            self.buffer = _io.BytesIO(data)

    monkeypatch.setattr(sys, "stdin", In(buf.getvalue()))
    got = tio.read_images("-", device="cpu")
    monkeypatch.setattr(sys, "stdin", In(buf.getvalue()))
    _same_images(got, jio.read_images("-"))


def test_colorspace_converted_for_write_like_jax(no_png_native):
    t, j = _pair(_pixels(92), colorspace="lab", depth=8)
    got, want = _encode_pair("png", [t], [j])
    assert got == want


def test_svg_wrapper_matches_jax(no_png_native):
    t, j = _pair(_pixels(93), depth=8)
    got, want = _encode_pair("svg", [t], [j])
    assert got == want


# -- the last coders of io/, which raised before they were ported ----------

UNPORTED_BLOBS = {
    "wmf": b"\xd7\xcd\xc6\x9a" + b"\0" * 64,
    "hdr": b"#?RADIANCE\n" + b"\0" * 64,
    "emf": b"\x01\0\0\0" + b"\0" * 36 + b" EMF" + b"\0" * 40,
}


@pytest.mark.parametrize("kind", sorted(UNPORTED_BLOBS))
def test_unported_formats_raise_naming_their_entry(kind):
    """These blobs, once refused as unported, now give the JAX outcome:
    the same pixels, or the same exception class."""
    blob = UNPORTED_BLOBS[kind]
    try:
        want = jio.image_from_blob(blob)
    except Exception as exc:   # noqa: BLE001 — the JAX class is the point
        with pytest.raises(type(exc)):
            tio.image_from_blob(blob, device="cpu")
    else:
        _same_images(tio.image_from_blob(blob, device="cpu"), want)


# formats4's files cut short, which were here while formats4 was unported
TRUNCATED4_BLOBS = {
    "vips": b"\xb6\xa6\xf2\x08" + b"\0" * 64,
    "pgx": b"PG ML + 8 4 4\n" + b"\0" * 8,
    "cals": b"srcdocid: x" + b"\0" * 64,
    "tim2": b"TIM2" + b"\0" * 64,
    "wpg": b"\xff\x57\x50\x43" + b"\0" * 64,
    "ipl": b"iiii" + b"\0" * 64,
    "pes": b"#PES0001" + b"\0" * 64,
}


@pytest.mark.parametrize("kind", sorted(TRUNCATED4_BLOBS))
def test_truncated_formats4_blobs_raise_as_jax(kind):
    blob = TRUNCATED4_BLOBS[kind]
    with pytest.raises(Exception) as want:
        jio.image_from_blob(blob)
    with pytest.raises(want.type):
        tio.image_from_blob(blob, device="cpu")


@pytest.mark.parametrize("fmt", ["hdr", "strimg", "debug", "jbig", "exif",
                                 "matte", "icc", "xmp", "iptc", "dmr"])
def test_unported_writers_raise_naming_their_entry(fmt, tmp_path):
    """These writers, once refused as unported, now give the JAX bytes
    (DMR: its resource file, and the images read back)."""
    t, j = _pair(_pixels(94, c=4), colorspace="srgb", alpha=True)
    for im in (t, j):
        im.profiles.update({"exif": b"Exif\0\0II*\0", "icc": b"\0icc",
                            "xmp": b"<x/>", "iptc": b"\x1c\x02\x05\0\x01A"})
    if fmt == "dmr":
        for side, mod, im in (("t", tio, t), ("j", jio, j)):
            mod.write_image(im, "dmr:image/x", settings={
                "defines": {"dmr:path": str(tmp_path / side)}})
        res = "image/x/resource.miff"
        assert (tmp_path / "t" / res).read_bytes() == \
            (tmp_path / "j" / res).read_bytes()
        _same_images(tio.read_images("dmr:image/x", settings={"defines": {
            "dmr:path": str(tmp_path / "t")}}, device="cpu"),
            jio.read_images("dmr:image/x", settings={"defines": {
                "dmr:path": str(tmp_path / "j")}}))
        return
    if fmt == "jbig" and not tnat.jbig_available():
        with pytest.raises(ValueError, match="libjbig unavailable"):
            tio.image_to_blob(t, fmt)
        return
    assert tio.image_to_blob(t, fmt) == jio.image_to_blob(j, fmt)


def _tiff_rgb16(arr) -> bytes:
    """An uncompressed little-endian TIFF of 16-bit RGB samples, built by
    hand (Pillow does not write 48-bit RGB)."""
    h, w, _ = arr.shape
    data = arr.astype("<u2").tobytes()
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, None),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, None),
               (277, 3, 1, 3), (278, 3, 1, h), (279, 4, 1, len(data)),
               (284, 3, 1, 1)]
    bps_off = 8 + 2 + 12 * len(entries) + 4
    out = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        if tag == 258:
            field = struct.pack("<I", bps_off)
        elif tag == 273:
            field = struct.pack("<I", bps_off + 6)
        elif typ == 3:
            field = struct.pack("<HH", val, 0)
        else:
            field = struct.pack("<I", val)
        out += struct.pack("<HHI", tag, typ, cnt) + field
    return out + struct.pack("<I", 0) + struct.pack("<HHH", 16, 16, 16) + data


def test_deep_rgb_tiff_and_urls_raise():
    """A 48-bit RGB TIFF reads with the native deep reader, as in the JAX
    package (Pillow would narrow it to 8 bits), and a TIFF at depth 16
    writes with the native deep writer, both equal to JAX; a URL that
    names no file raises the JAX IOError."""
    blob = _tiff_rgb16(np.random.default_rng(0).integers(0, 65536, (4, 5, 3)))
    want = jio.image_from_blob(blob)
    assert want[0].spec.depth == 16
    _same_images(tio.image_from_blob(blob, device="cpu"), want)
    t, j = _pair(_pixels(95), colorspace="srgb", depth=16)
    assert tio.image_to_blob(t, "tiff", depth=16) == \
        jio.image_to_blob(j, "tiff", depth=16)
    for mod, kw in ((jio, {}), (tio, {"device": "cpu"})):
        with pytest.raises(IOError, match="url fetch failed"):
            mod.read_images("file:///nonexistent/x.png", **kw)


# -- identify ---------------------------------------------------------------

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _same_text(got: str, want: str):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if g.startswith("  Version:"):
            continue
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
            assert float(a) == pytest.approx(float(b), rel=NUM_REL,
                                             abs=NUM_ABS), (g, w)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("verbose", [False, True])
def test_describe_matches_jax(channels, verbose):
    spec = dict(colorspace="gray" if channels == 1 else "srgb",
                alpha=channels == 4, depth=8)
    t, j = _pair(_pixels(100 + channels, c=channels), **spec)
    for im in (t, j):
        im.properties.update({"format": "PNG", "comment": "hello",
                              "units": "PixelsPerInch",
                              "resolution": (72.0, 72.0)})
    _same_text(tident.describe(t, "a.png", verbose),
               jident.describe(j, "a.png", verbose))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_to_json_matches_jax(channels):
    spec = dict(colorspace="gray" if channels == 1 else "srgb",
                alpha=channels == 4)
    t, j = _pair(_pixels(110 + channels, c=channels), **spec)
    a = json.loads(tident.to_json(t, "x.png"))["image"]
    b = json.loads(jident.to_json(j, "x.png"))["image"]

    def walk(x, y, path=""):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, list):
            assert len(x) == len(y), path
            for k, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{k}")
        elif isinstance(x, float):
            assert x == pytest.approx(y, rel=NUM_REL, abs=NUM_ABS), path
        else:
            assert x == y, path

    walk(a, b)


def test_metadata_of_a_jpeg_blob_matches_jax(jpeg_codec):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_services import EXIF_ENTRIES, _jpeg_with_app1, _tiff_exif

    blob = _jpeg_with_app1(_tiff_exif(EXIF_ENTRIES))
    got = tio.image_from_blob(blob, device="cpu")
    _same_images(got, jio.image_from_blob(blob))
    assert got[0].properties["exif:Make"] == "Canon"
    assert got[0].properties["format"] == "JPEG"


def test_formats_lists_name_only_what_the_port_does():
    reads, writes = tio.supported_read_formats(), tio.supported_write_formats()
    for fmt in ("png", "jpeg", "ppm", "gray", "gradient", "mpr", "mask",
                "miff", "exr", "svg", "farbfeld", "xbm", "mpc", "dng"):
        assert fmt in reads
    for fmt in ("png", "jpeg", "pbm", "rgb", "info", "null", "mpr", "miff",
                "exr", "farbfeld", "xbm", "sixel", "ora", "kernel"):
        assert fmt in writes
    for fmt in ("dpx", "cin", "dcm", "xcf", "mat", "viff", "g4", "pict"):
        assert fmt in reads
    for fmt in ("dpx", "psd", "pdf", "mat", "viff", "g4", "pict", "sun"):
        assert fmt in writes
    for fmt in ("aai", "vips", "cals", "uyvy", "stegano"):
        assert fmt in reads
    for fmt in ("aai", "vips", "cals", "ps", "wpg"):
        assert fmt in writes
    for fmt in ("hdr", "wmf", "emf"):
        assert fmt in reads
    for fmt in ("hdr", "matte"):
        assert fmt in writes
    assert ("jbig" in reads) == ("jbig" in writes) == tnat.jbig_available()
    assert ("heic" in reads) == tnat.heif_available()
    assert ("jxl" in writes) == tnat.jxl_available()


def test_decode_goes_to_the_device_once(no_png_native, monkeypatch):
    """A decoded image is one host array moved once: a CUDA device without
    a card raises rather than leaving the pixels on the CPU."""
    from PIL import Image as PImage

    buf = _io.BytesIO()
    PImage.fromarray((_pixels(120) * 255).astype(np.uint8)).save(buf, "PNG")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tio.image_from_blob(buf.getvalue())
    moves = []
    real = torch.Tensor.to

    def spy(self, *a, **kw):
        moves.append(a)
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    img = tio.image_from_blob(buf.getvalue(), device="cpu")[0]
    assert len(moves) == 1 and img.data.dtype == torch.float32
