"""Port parity: the coders of io/'s second slice (MIFF, MPC, EXR, DNG,
farbfeld, XBM, XPM, sixel, SVG, ORA, KERNEL, PANGO, the delegates, and
native PNG, HEIF and JPEG XL through io/) against the JAX package.

Inputs are made from a numpy seed at tens of pixels a side.  Tolerances:
every encoder gives the JAX encoder's bytes from equal pixels (ORA with
zipfile's clock held still: its entries carry the time of writing); every
decoder gives the JAX decoder's float32 pixels, spec, properties,
profiles, page and delay, bit for bit, from equal bytes.  XPM and sixel
build their palettes with k-means, whose port sums clusters in float64
where the JAX one sums them by a float32 matmul: their inputs hold a few
flat colours, whose palettes round alike.  The DNG demosaic is held
within 1e-6 absolute (float32 convolutions that sum in another order),
the whole DNG decode within 1e-5 (and the sRGB transfer, torch.pow
against the JAX split-exponent pow, as ``tests/test_torch_colorspace.py``
holds it).  SVG and PANGO go through ``ops/draw.py``: within 1e-6, the
tolerance of ``tests/test_torch_draw.py``.  The delegates' programs are
not installed here: the tests hold their raises and policy refusals to
the JAX package's, and the command lines with ``_which`` and
``subprocess.run`` replaced."""

import importlib
import io as _io
import re
import struct
import subprocess
import time
import zipfile
import zlib

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.policy import (PolicyError, no_host_files,
                                               policy as tpolicy)
from imagemagick_tpu_torch.io import coders_r4 as tr4
from imagemagick_tpu_torch.io import delegates as tdel
from imagemagick_tpu_torch.io import dng as tdng
from imagemagick_tpu_torch.io import exr as texr
from imagemagick_tpu_torch.io import miff as tmiff
from imagemagick_tpu_torch.io import mpc as tmpc

jio = importlib.import_module("imagemagick_tpu.io")
jnat = importlib.import_module("imagemagick_tpu.native")
jmiff = importlib.import_module("imagemagick_tpu.io.miff")
jmpc = importlib.import_module("imagemagick_tpu.io.mpc")
jexr = importlib.import_module("imagemagick_tpu.io.exr")
jdng = importlib.import_module("imagemagick_tpu.io.dng")
jr4 = importlib.import_module("imagemagick_tpu.io.coders_r4")
jdel = importlib.import_module("imagemagick_tpu.io.delegates")
jpolicy = importlib.import_module("imagemagick_tpu.core.policy").policy
jm = importlib.import_module("imagemagick_tpu.cli.main")
tm = importlib.import_module("imagemagick_tpu_torch.cli.main")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec
TSpec = importlib.import_module("imagemagick_tpu_torch.core.spec").ImageSpec

DNG_TOL = 1e-5
DEMOSAIC_TOL = 1e-6
DRAW_TOL = 1e-6


def _pixels(seed=0, h=20, w=28, c=3):
    """Smooth texture, a flat block and noise, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 5.0)[..., None] * np.cos(
        xx[..., None] / 7.0 + np.arange(c))
    img = np.clip(base + 0.05 * rng.standard_normal((h, w, c)), 0, 1)
    img[h // 3:h // 2, w // 4:w // 2] = 0.75
    return img.astype(np.float32)


def _flat_colours(n, seed=0, h=16, w=32):
    """``n`` flat RGB colours, each on h*w/n pixels, so that k-means with
    ``n`` clusters seeds one center in each colour and keeps it: levels
    k/255 at least 8 apart in some channel, each far from a sixel
    percent's rounding edge (k*100/255 at least 0.2 from an integer)."""
    rng = np.random.default_rng(seed)
    ks = [k for k in range(0, 256, 8) if 0.2 <= (k * 100 / 255) % 1 <= 0.8]
    cols, sums = [], set()
    while len(cols) < n:
        col = tuple(int(v) for v in rng.choice(ks, 3))
        if col not in cols and sum(col) not in sums:
            cols.append(col)
            sums.add(sum(col))
    pal = np.asarray(cols, np.float32) / np.float32(255)
    idx = rng.permutation(np.arange(h * w) % n).reshape(h, w)
    return pal[idx]


def _spec(c, **kw):
    d = dict(colorspace="gray" if c <= 2 else "srgb", alpha=c in (2, 4))
    d.update(kw)
    return d


def _pair(arr, **spec):
    return (TImage(torch.from_numpy(arr.copy()), TSpec(**spec)),
            JImage(arr.copy(), JSpec(**spec)))


def _arr(img) -> np.ndarray:
    d = img.data
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _same_images(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.device == torch.device("cpu")
        if tol:
            np.testing.assert_allclose(_arr(g), _arr(w), rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(_arr(g), _arr(w))
        assert (g.spec.colorspace, g.spec.alpha, g.spec.depth) == \
            (w.spec.colorspace, w.spec.alpha, w.spec.depth)
        assert g.properties == w.properties
        assert g.profiles == w.profiles
        assert (g.page, g.delay) == (w.page, w.delay)


def _blob_pair(fmt, t, j, **kw):
    return tio.image_to_blob(t, fmt, **kw), jio.image_to_blob(j, fmt, **kw)


# -- MIFF ---------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "zip", "bzip"])
@pytest.mark.parametrize("depth", [8, 16, 32])
def test_miff_encode_and_decode_equal_jax(depth, compression):
    c = 4 if depth == 16 else 3
    t, j = _pair(_pixels(depth, c=c), **_spec(c))
    t.properties.update({"comment": "a frame", "label": "x"})
    j.properties.update({"comment": "a frame", "label": "x"})
    got = tmiff.encode([t], depth=depth, compression=compression)
    want = jmiff.encode([j], depth=depth, compression=compression)
    assert got == want
    # each package reads the other's bytes
    _same_images(tmiff.decode(want, device="cpu"), jmiff.decode(got))


def test_miff_frames_batches_and_io_dispatch_equal_jax():
    """Several frames (a list and a batch), through image_to_blob's
    default (zip, 8 or 16 bits by the depth) and image_from_blob."""
    a, b = _pixels(1, c=1), _pixels(2, c=1)
    ta, ja = _pair(a, **_spec(1, depth=16))
    tb, jb = _pair(b, **_spec(1))
    got = tio.image_to_blob([ta, tb], "miff")
    want = jio.image_to_blob([ja, jb], "miff")
    assert got == want
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))
    tbat, jbat = _pair(np.stack([a, b]), **_spec(1))
    assert tmiff.encode(tbat, 8, "zip") == jmiff.encode(jbat, 8, "zip")
    assert len(tmiff.decode(tmiff.encode(tbat, 8, "zip"), "cpu")) == 2


def _miff_head(extra: str) -> bytes:
    return (f"id=ImageMagick  version=1.0\n{extra}\n\x0c\n:\x1a").encode()


def _miff_variants():
    rng = np.random.default_rng(3)
    h, w = 6, 9
    cmap = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    idx = rng.integers(0, 5, (h, w), dtype=np.uint8)
    alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
    pseudo = _miff_head(
        f"class=PseudoClass colors=5 alpha=True columns={w} rows={h} "
        f"depth=8 colorspace=sRGB compression=None") + cmap.tobytes() + \
        np.stack([idx, alpha], -1).tobytes()
    # RLE packets: pixel samples then count-1, runs within rows
    px = rng.integers(0, 256, (h, 3, 3), dtype=np.uint8)
    runs = [2, 4, 3]
    rle = bytearray(_miff_head(
        f"class=DirectClass columns={w} rows={h} depth=8 colorspace=sRGB "
        f"compression=RLE"))
    for y in range(h):
        for k, n in enumerate(runs):
            rle += px[y, k].tobytes() + bytes([n - 1])
    # 16-bit floating-point quantums, a profile and a montage directory
    half = rng.random((h, w, 1)).astype(">f2")
    prof = b"\x01\x02profile-bytes"
    fp16 = _miff_head(
        f"class=DirectClass columns={w} rows={h} depth=16 colorspace=Gray "
        f"quantum:format=floating-point compression=None profile=icc "
        f"montage=4x4+0+0 date:create={{2024-01-01}} {{a comment}}") + \
        b"directory\x00" + struct.pack(">I", len(prof)) + prof + \
        half.tobytes()
    # version 0 zip: one stream, no length prefixes
    plain = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16).astype(">u2")
    zip0 = (f"id=ImageMagick\nclass=DirectClass columns={w} rows={h} "
            f"depth=16 colorspace=sRGB compression=Zip\n:\x1a").encode() + \
        zlib.compress(plain.tobytes())
    # 32-bit integer CMYK
    u32 = rng.integers(0, 2 ** 32, (h, w, 4), dtype=np.uint64) \
        .astype(">u4")
    cmyk = _miff_head(
        f"class=DirectClass columns={w} rows={h} depth=32 colorspace=CMYK "
        f"compression=None") + u32.tobytes()
    return {"pseudoclass": pseudo, "rle": bytes(rle), "float16": fp16,
            "zip-version0": zip0, "cmyk32": cmyk,
            "two-frames": pseudo + b"\n" + bytes(rle)}


@pytest.mark.parametrize("kind", sorted(_miff_variants()))
def test_miff_decoder_variants_equal_jax(kind):
    blob = _miff_variants()[kind]
    got = tio.image_from_blob(blob, device="cpu")
    _same_images(got, jio.image_from_blob(blob))
    assert got[0].properties["format"] == "MIFF"


def test_miff_bad_streams_raise_like_jax():
    for blob in (_miff_head("columns=2 rows=2 compression=LZMA"),
                 _miff_head("columns=2 rows=2 depth=8 compression=None")
                 + b"\0",
                 _miff_head("class=PseudoClass columns=2 rows=2")):
        with pytest.raises(ValueError) as want:
            jmiff.decode(blob)
        with pytest.raises(ValueError) as got:
            tmiff.decode(blob, "cpu")
        assert str(got.value) == str(want.value)


# -- MPC ----------------------------------------------------------------------

def test_mpc_files_equal_jax_and_read_back(tmp_path):
    t1, j1 = _pair(_pixels(5, c=4), **_spec(4, depth=16))
    t2, j2 = _pair(_pixels(6, h=7, w=5, c=1), **_spec(1))
    for t, j in ((t1, j1), (t2, j2)):
        for img in (t, j):
            img.properties.update({"label": "cache", "n": 3})
            img.page = (40, 30, 2, 1)
            img.delay = 7
    tio.write_image([t1, t2], str(tmp_path / "port.mpc"))
    jio.write_image([j1, j2], str(tmp_path / "jax.mpc"))
    assert (tmp_path / "port.mpc").read_bytes() == \
        (tmp_path / "jax.mpc").read_bytes()
    got = tio.read_images("mpc:" + str(tmp_path / "jax.mpc"), device="cpu")
    _same_images(got, jmpc.read_mpc(str(tmp_path / "port.mpc")))
    got[0].data[0, 0, 0] = 2.0     # the port's pixels are its own
    assert tmpc.read_mpc(str(tmp_path / "port.mpc"), "cpu")[0] \
        .data[0, 0, 0] != 2.0


def test_mpc_is_refused_without_host_files(tmp_path):
    t, _ = _pair(_pixels(7))
    path = str(tmp_path / "x.mpc")
    tio.write_image(t, path)
    with no_host_files():
        for call in (lambda: tio.write_image(t, path),
                     lambda: tio.write_image(t, "mpc:-"),
                     lambda: tio.read_images(path, device="cpu"),
                     lambda: tmpc.read_mpc(path, "cpu")):
            with pytest.raises(PolicyError, match="no file of the host"):
                call()


# -- EXR ----------------------------------------------------------------------

@pytest.mark.parametrize("half,compression,c", [
    (True, "zip", 3), (True, "zips", 4), (True, "none", 1),
    (False, "zip", 4), (False, "zips", 2), (False, "none", 3)])
def test_exr_encode_and_decode_equal_jax(half, compression, c):
    arr = _pixels(c, c=c) * 3.0 - 0.5          # HDR values pass as they are
    t, j = _pair(arr, **_spec(c))
    got = texr.encode(t, half=half, compression=compression)
    want = jexr.encode(j, half=half, compression=compression)
    assert got == want
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))


def test_exr_predictor_equals_jax_loops():
    rng = np.random.default_rng(8)
    for n in (0, 1, 2, 5, 64, 1001):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert texr._preprocess_block(raw) == jexr._preprocess_block(raw)
        assert texr._postprocess_block(raw) == jexr._postprocess_block(raw)


def test_exr_uint_channels_and_bad_streams_equal_jax():
    h, w = 3, 5
    vals = np.arange(h * w, dtype="<u4").reshape(h, w)
    chans = b"".join(n + b"\0" + struct.pack("<i", 0) + b"\0" * 4 +
                     struct.pack("<ii", 1, 1) for n in (b"Z",)) + b"\0"

    def attr(name, typ, payload):
        return name + b"\0" + typ + b"\0" + struct.pack("<I", len(payload)) \
            + payload

    head = struct.pack("<iI", 20000630, 2) + attr(b"channels", b"chlist",
                                                   chans) + \
        attr(b"compression", b"compression", b"\0") + \
        attr(b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)) \
        + b"\0"
    start = len(head) + 8 * h
    offs = b"".join(struct.pack("<q", start + y * (8 + 4 * w))
                    for y in range(h))
    body = b"".join(struct.pack("<iI", y, 4 * w) + vals[y].tobytes()
                    for y in range(h))
    blob = head + offs + body
    _same_images(tio.image_from_blob(blob, "exr", device="cpu"),
                 jio.image_from_blob(blob, "exr"))
    bad = bytearray(blob)
    bad[5] |= 0x02                             # multi-part flag (0x200)
    for data in (bytes(bad), b"\0" * 16):
        with pytest.raises(ValueError) as want:
            jexr.decode(data)
        with pytest.raises(ValueError) as got:
            texr.decode(data, "cpu")
        assert str(got.value) == str(want.value)


# -- farbfeld, XBM, XPM, sixel ----------------------------------------------

@pytest.mark.parametrize("c", [1, 3, 4])
def test_farbfeld_equals_jax(c):
    t, j = _pair(_pixels(9 + c, c=c), **_spec(c))
    got, want = _blob_pair("ff", t, j)
    assert got == want
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))


def test_xbm_equals_jax():
    t, j = _pair(_pixels(12, h=9, w=21), **_spec(3))
    got, want = _blob_pair("xbm", t, j)
    assert got == want
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))


@pytest.mark.parametrize("fmt,n", [("xpm", 64), ("sixel", 16)])
def test_xpm_and_sixel_encode_equal_jax(fmt, n):
    t, j = _pair(_flat_colours(n, 13), **_spec(3))
    got, want = _blob_pair(fmt, t, j)
    assert got == want
    if fmt == "xpm":
        _same_images(tio.image_from_blob(got, device="cpu"),
                     jio.image_from_blob(want))


def test_xpm_decode_with_transparency_and_names_equals_jax():
    text = b"""/* XPM */
static char *x[] = {
"4 3 4 2",
".. c None",
"ab c red",
"cd c #00FF0080",
"ee s foo c navy",
"..abcdee",
"eeee..ab",
"cdcdcdcd"
};"""
    _same_images(tio.image_from_blob(text, device="cpu"),
                 jio.image_from_blob(text))


# -- SVG and PANGO ------------------------------------------------------------

SVGS = {
    "shapes": b'''<svg xmlns="http://www.w3.org/2000/svg" width="48" height="36">
<style>.a { fill: #3366cc; stroke: black } #c { fill-opacity: 0.5 }</style>
<rect class="a" x="3" y="4" width="20" height="12" stroke-width="2"/>
<circle id="c" cx="34" cy="24" r="9" fill="red"/>
<ellipse cx="12" cy="28" rx="8" ry="4" style="fill:green"/>
<line x1="0" y1="35" x2="47" y2="20" stroke="navy" stroke-width="1.5"/>
<polygon points="30,2 44,6 40,14" fill="orange"/>
<polyline points="2,20 8,16 14,22" fill="none" stroke="purple"/>
</svg>''',
    "viewbox-path-use": b'''<svg width="40" height="40" viewBox="0 0 20 20">
<defs><path id="p" d="M2 2 L10 2 L6 9 Z" fill="teal"/></defs>
<use href="#p" x="6" y="8"/>
<g transform="translate(1,1) scale(1.2)">
<path d="M1 18 Q 5 10 9 18 T 17 18" stroke="black" fill="none"/></g>
</svg>''',
    "gradient": b'''<svg width="32" height="24">
<linearGradient id="g" x1="0%" y1="0%" x2="100%" y2="0%">
<stop offset="0" stop-color="white"/><stop offset="1" style="stop-color:blue"/>
</linearGradient>
<rect x="0" y="0" width="32" height="24" fill="url(#g)"/>
</svg>''',
}


@pytest.mark.parametrize("name", sorted(SVGS))
def test_svg_decode_matches_jax(name):
    got = tio.image_from_blob(SVGS[name], device="cpu")
    _same_images(got, jio.image_from_blob(SVGS[name]), tol=DRAW_TOL)


def test_svg_embedded_image_matches_jax(monkeypatch):
    """A data-URI <image> decodes through each side's codec (PIL on both:
    the JAX side without its native PNG) and is pasted over the raster."""
    import base64

    from PIL import Image as PImage

    monkeypatch.setattr(jnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "png_available", lambda: False)
    buf = _io.BytesIO()
    PImage.fromarray((_pixels(14, h=6, w=8) * 255).astype(np.uint8)) \
        .save(buf, "PNG")
    uri = base64.b64encode(buf.getvalue()).decode()
    svg = (f'<svg width="20" height="16"><rect x="0" y="0" width="20" '
           f'height="16" fill="gray"/><image x="3" y="2" width="8" '
           f'height="6" href="data:image/png;base64,{uri}"/></svg>').encode()
    _same_images(tio.image_from_blob(svg, device="cpu"),
                 jio.image_from_blob(svg), tol=DRAW_TOL)


@pytest.mark.parametrize("markup,size", [
    ("<b>bold</b> and <span foreground='red'>red</span> &amp; more", "90x"),
    ("<markup>plain &lt;text&gt;</markup>", None)])
def test_pango_matches_jax(markup, size):
    settings = {"pointsize": "12", "fill": "navy"}
    got = tio.read_images("pango:" + markup, size, dict(settings),
                          device="cpu")
    _same_images(got, jio.read_images("pango:" + markup, size,
                                      dict(settings)), tol=DRAW_TOL)


# -- ORA and KERNEL -----------------------------------------------------------

@pytest.fixture
def still_clock(monkeypatch):
    """zipfile stamps each entry with time.time(): hold it still."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("h,w,c", [(20, 28, 3), (300, 260, 4)])
def test_ora_encode_and_decode_equal_jax(still_clock, h, w, c):
    """Two layers; the 300x260 base takes the box-resized thumbnail."""
    ta, ja = _pair(_pixels(15, h=h, w=w, c=c), **_spec(c))
    tb, jb = _pair(_pixels(16, h=h, w=w, c=c), **_spec(c))
    got, want = _blob_pair("ora", [ta, tb], [ja, jb])
    assert got == want
    assert tio.detect_format(got) == jio.detect_format(want) == "ora"
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))


def test_ora_layer_stack_without_merged_image_equals_jax():
    buf = _io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr(zipfile.ZipInfo("mimetype"), b"image/openraster")
        for i in range(2):
            t, _ = _pair(_pixels(17 + i, h=12, w=10, c=4), **_spec(4))
            z.writestr(f"data/layer{i}.png", tio.image_to_blob(t, "png"))
        z.writestr("stack.xml", '<image><stack>'
                   '<layer src="data/layer0.png" x="2" y="3"/>'
                   '<layer src="data/layer1.png" x="0" y="0"/>'
                   '</stack></image>')
    blob = buf.getvalue()
    _same_images(tio.image_from_blob(blob, "ora", device="cpu"),
                 jio.image_from_blob(blob, "ora"))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_kernel_encode_and_read_back_equal_jax(c):
    arr = _pixels(18 + c, h=5, w=6, c=c)
    if c == 4:
        arr[1, 2, 3] = 0.2                     # a '-' tap
    t, j = _pair(arr, **_spec(c))
    got, want = _blob_pair("kernel", t, j)
    assert got == want
    _same_images(tio.image_from_blob(got, "kernel", device="cpu"),
                 jio.image_from_blob(want, "kernel"))


@pytest.mark.parametrize("spec", ["unity", "disk:2.5", "diamond:1",
                                  "3x3:1,-,2,0,1,-,3,2,1", "gaussian:1x1"])
def test_kernel_pseudo_equals_jax(spec):
    _same_images(tio.read_images("kernel:" + spec, device="cpu"),
                 jio.read_images("kernel:" + spec))


# -- DNG ----------------------------------------------------------------------

def _rggb(seed, h=16, w=20):
    return _pixels(seed, h=h, w=w, c=3)


@pytest.mark.parametrize("h,w", [(16, 20), (15, 21)])
def test_dng_encode_equals_jax_and_decodes_within_tol(h, w):
    t, j = _pair(_rggb(h, h, w), **_spec(3))
    got, want = _blob_pair("dng", t, j)
    assert got == want
    assert tdng.is_dng(got) and jdng.is_dng(got)
    assert tio.detect_format(got) == "tiff"
    for fmt in ("dng", "tiff"):       # a TIFF with DNGVersion decodes so
        _same_images(tio.image_from_blob(got, fmt, device="cpu"),
                     jio.image_from_blob(want, fmt), tol=DNG_TOL)


def _dng_with(pattern, neutral, black, white, bps=16, h=10, w=12, seed=3):
    """A little-endian uncompressed-CFA DNG with the given tags."""
    rng = np.random.default_rng(seed)
    dt = "<u2" if bps == 16 else "u1"
    cfa = rng.integers(0, 2 ** bps, (h, w)).astype(dt).tobytes()
    ents = [(254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [bps]),
            (259, 3, [1]), (262, 3, [32803]), (273, 4, [0]), (277, 3, [1]),
            (278, 4, [6]), (279, 4, [len(cfa)]), (33421, 3, [2, 2]),
            (33422, 1, pattern), (50706, 1, [1, 4, 0, 0]),
            (50714, 3, [black]), (50717, 3, [white])]
    if neutral:
        ents.append((50728, 5, neutral))
    ents.sort()
    size = {1: 1, 3: 2, 4: 4, 5: 8}
    fmt = {1: "B", 3: "H", 4: "I"}
    n = len(ents)
    data_off = 8 + 2 + 12 * n + 4
    extra = b""
    body = struct.pack("<H", n)
    for tag, typ, vals in ents:
        if typ == 5:
            packed = b"".join(struct.pack("<II", int(v * 1000), 1000)
                              for v in vals)
        else:
            packed = struct.pack("<" + fmt[typ] * len(vals), *vals)
        if tag == 273:                 # two strips of 6 rows
            packed = struct.pack("<II", 0, 0)
            vals = [0, 0]
        if len(packed) <= 4:
            raw = packed.ljust(4, b"\0")
        else:
            raw = struct.pack("<I", data_off + len(extra))
            extra += packed
        body += struct.pack("<HHI", tag, typ, len(vals)) + raw
    body += struct.pack("<I", 0)
    out = bytearray(b"II" + struct.pack("<HI", 42, 8) + body + extra)
    strip0 = len(out)
    half = 6 * w * (bps // 8)
    out += cfa
    # patch the strip offsets (the out-of-line pair of tag 273)
    pos = 10 + [t for t, _, _ in ents].index(273) * 12
    (ptr,) = struct.unpack_from("<I", out, pos + 8)
    struct.pack_into("<II", out, ptr, strip0, strip0 + half)
    return bytes(out)


@pytest.mark.parametrize("pattern,neutral,black,white,bps", [
    ([0, 1, 1, 2], [0.5, 1.0, 0.7], 0, 65535, 16),
    ([1, 0, 2, 1], None, 512, 60000, 16),
    ([2, 1, 1, 0], [0.9, 1.0, 0.4], 8, 250, 8)])
def test_dng_tags_decode_within_tol_of_jax(pattern, neutral, black, white,
                                           bps):
    blob = _dng_with(pattern, neutral, black, white, bps)
    _same_images(tio.image_from_blob(blob, device="cpu"),
                 jio.image_from_blob(blob), tol=DNG_TOL)


@pytest.mark.parametrize("pattern", [[0, 1, 1, 2], [1, 2, 0, 1]])
def test_demosaic_within_1e6_of_jax(pattern):
    rng = np.random.default_rng(4)
    cfa = rng.random((23, 30)).astype(np.float32)
    pat = np.asarray(pattern, np.int64).reshape(2, 2)
    wb = np.asarray([1.7, 1.0, 1.3], np.float32)
    got = tdng._demosaic_bilinear(cfa, pat, wb, "cpu")
    want = jdng._demosaic_bilinear(cfa, pat, wb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (23, 30, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DEMOSAIC_TOL)


def test_compressed_dng_raises_like_jax_without_dcraw(monkeypatch):
    blob = bytearray(_dng_with([0, 1, 1, 2], None, 0, 65535))
    pos = 10 + 4 * 12                       # tag 259, the fifth entry
    assert struct.unpack_from("<H", blob, pos)[0] == 259
    struct.pack_into("<H", blob, pos + 8, 7)    # JPEG compression
    monkeypatch.setattr(tdel, "_which", lambda *n: None)
    monkeypatch.setattr(jdel, "_which", lambda *n: None)
    with pytest.raises(ValueError) as want:
        jio.image_from_blob(bytes(blob), "dng")
    with pytest.raises(ValueError) as got:
        tio.image_from_blob(bytes(blob), "dng", device="cpu")
    assert str(got.value) == str(want.value)
    assert "compression 7" in str(got.value)


# -- detect_format ------------------------------------------------------------

def _new_magics():
    t, _ = _pair(_pixels(19), **_spec(3))
    return {
        "miff": tio.image_to_blob(t, "miff"),
        "ff": tio.image_to_blob(t, "ff"),
        "exr": tio.image_to_blob(t, "exr"),
        "xpm": b"  /* XPM */\nstatic",
        "xbm": b"#define a_width 2\nstatic char a_bits[] = {0};",
        "svg": b'<?xml version="1.0"?>\n<svg width="2"/>',
        "svg-bare": b"<svg/>",
        "pdf": b"%PDF-1.7\n",
        "ps": b"%!PS-Adobe-3.0\n",
        "jxl": b"\xff\x0a" + b"\0" * 16,
        "jxl-box": b"\x00\x00\x00\x0cJXL \r\n\x87\n" + b"\0" * 8,
        "heic": b"\0\0\0\x18ftypheic" + b"\0" * 16,
        "avif": b"\0\0\0\x18ftypavif" + b"\0" * 16,
        "dng": tio.image_to_blob(t, "dng"),
        "hdr": b"#?RADIANCE\nFORMAT",
        "ora": b"PK\x03\x04" + b"\0" * 26 + b"mimetypeimage/openraster",
    }


@pytest.mark.parametrize("kind", sorted(_new_magics()))
def test_detect_format_of_the_new_magics_equals_jax(kind):
    blob = _new_magics()[kind]
    assert tio.detect_format(blob) == jio.detect_format(blob)
    assert tio.detect_format(blob) is not None


# -- native PNG, HEIF and JPEG XL through io/ --------------------------------

def _need(flag: bool, what: str):
    if not flag:
        pytest.skip(f"{what} does not load here")


@pytest.mark.parametrize("c,depth", [(1, 8), (3, 8), (4, 16), (2, 16),
                                     (3, 16)])
def test_native_png_through_io_equals_jax(c, depth):
    _need(tnat.png_available() and jnat.available(), "libpng")
    arr = _pixels(20 + c, c=c)
    if c == 3 and depth == 16:
        arr = np.repeat(arr[..., :1], 3, -1)   # png.c's gray reduction
    t, j = _pair(arr, **_spec(c, depth=depth))
    got, want = _blob_pair("png", t, j)
    assert got == want
    _same_images(tio.image_from_blob(got, device="cpu"),
                 jio.image_from_blob(want))


@pytest.mark.parametrize("fmt", ["jxl", "heic"])
def test_heif_and_jxl_through_io_equal_jax(fmt):
    have = tnat.jxl_available() if fmt == "jxl" else tnat.heif_available()
    _need(have, "libjxl 0.7" if fmt == "jxl" else "libheif")
    t, j = _pair(_pixels(24), **_spec(3))
    try:
        want = jio.image_to_blob(j, fmt)
    except ValueError as e:           # no encoder plugin: both refuse
        with pytest.raises(ValueError, match="no .* encoder") as got:
            tio.image_to_blob(t, fmt)
        assert str(got.value) == str(e)
        return
    got = tio.image_to_blob(t, fmt)
    if fmt == "jxl":
        assert got == want
    _same_images(tio.image_from_blob(want, fmt, device="cpu"),
                 jio.image_from_blob(want, fmt))


# -- delegates ----------------------------------------------------------------

DELEGATE_CALLS = {
    "postscript": (lambda m, d: m.decode_postscript(d, "pdf"), b"%PDF-1.4"),
    "dot": (lambda m, d: m.decode_dot(d), b"digraph { a -> b }"),
    "pcl": (lambda m, d: m.decode_pcl(d), b"\x1bE"),
    "xps": (lambda m, d: m.decode_xps(d), b"PK\x03\x04"),
    "office": (lambda m, d: m.decode_office(d, "docx"), b"PK\x03\x04"),
    "dcraw": (lambda m, d: m.decode_dcraw(d, "dng"), b"II*\0"),
    "video": (lambda m, d: m.decode_video_frames("/nonexistent.mp4"), b""),
}


def _video(mod, imgs):
    r4 = tr4 if mod is tdel else jr4
    return r4.encode_video(imgs, "mp4")


@pytest.mark.parametrize("name", sorted(DELEGATE_CALLS) + ["video-write"])
def test_delegates_raise_like_jax_without_their_programs(name, monkeypatch):
    monkeypatch.setattr(tdel, "_which", lambda *n: None)
    monkeypatch.setattr(jdel, "_which", lambda *n: None)
    t, j = _pair(_pixels(25), **_spec(3))
    errs = []
    for mod, img in ((tdel, t), (jdel, j)):
        if name == "video-write":
            call = lambda m=mod, i=img: _video(m, [i])   # noqa: E731
        else:
            fn, data = DELEGATE_CALLS[name]
            call = lambda m=mod, f=fn, d=data: f(m, d)   # noqa: E731
        with pytest.raises(Exception) as e:
            call()
        errs.append(e.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__ == \
        "DelegateError"
    assert str(errs[0]) == str(errs[1])


def test_delegate_policy_and_no_host_files_refuse(monkeypatch):
    """The policy's delegate domain refuses on both sides with the same
    text; inside no_host_files the port refuses every delegate before it
    looks for the program."""
    monkeypatch.setattr(tdel, "_which", lambda *n: "/bin/true")
    saved = list(tpolicy.rules)
    for pol in (tpolicy, jpolicy):
        monkeypatch.setattr(pol, "rules", list(pol.rules))
        pol.set_policy("delegate", "gs", "none")
    errs = []
    for mod in (tdel, jdel):
        with pytest.raises(Exception) as e:
            mod.decode_postscript(b"%!PS", "ps")
        errs.append(e.value)
    assert str(errs[0]) == str(errs[1])
    assert type(errs[0]).__name__ == type(errs[1]).__name__ == "PolicyError"
    tpolicy.rules = saved
    t, _ = _pair(_pixels(26), **_spec(3))
    ran = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: ran.append(a))
    with no_host_files():
        for call in (lambda: tdel.decode_dot(b"digraph {}", "cpu"),
                     lambda: tdel.decode_pcl(b"x", device="cpu"),
                     lambda: tdel.decode_office(b"x", "odt", "cpu"),
                     lambda: tdel.decode_dcraw(b"x", "dng", "cpu"),
                     lambda: tdel.decode_video_frames("a.mp4", device="cpu"),
                     lambda: tr4.encode_video([t], "webm"),
                     lambda: tio.image_from_blob(b"%PDF-1.4", device="cpu"),
                     lambda: tio.image_to_blob(t, "mp4")):
            with pytest.raises(PolicyError, match="no program of the host"):
                call()
    assert ran == []


@pytest.mark.parametrize("name", ["postscript", "dot", "pcl", "office",
                                  "video-write"])
def test_delegate_command_lines_equal_jax(name, monkeypatch, tmp_path):
    """With the programs "installed" and subprocess.run recorded (it
    fails, so nothing is read back): the same argv on both sides, the
    temporary directory aside."""
    monkeypatch.setattr(tdel, "_which", lambda *n: f"/usr/bin/{n[0]}")
    monkeypatch.setattr(jdel, "_which", lambda *n: f"/usr/bin/{n[0]}")
    monkeypatch.setattr(tnat, "png_available", lambda: False)
    monkeypatch.setattr(jnat, "available", lambda: False)
    seen = []

    def run(cmd, **kw):
        seen.append((cmd, kw.get("input")))
        return subprocess.CompletedProcess(cmd, 1, b"", b"refused")

    monkeypatch.setattr(subprocess, "run", run)
    t, j = _pair(_pixels(27), **_spec(3))
    for mod, img in ((tdel, t), (jdel, j)):
        with pytest.raises(Exception, match="failed"):
            if name == "video-write":
                _video(mod, [img, img])
            else:
                DELEGATE_CALLS[name][0](mod, DELEGATE_CALLS[name][1])

    def norm(cmd):
        return [re.sub(r"tmp\w+", "TMP", a) for a in cmd]

    (tc, tin), (jc, jin) = seen
    assert norm(tc) == norm(jc) and tin == jin


def test_list_delegate_equals_jax(capsys, monkeypatch):
    for mod in (tdel, jdel):
        monkeypatch.setattr(mod, "_which",
                            lambda *n: "/usr/bin/x" if n[0] == "dot" else None)
    assert tm.main(["-list", "delegate"], device="cpu") == 0
    got = capsys.readouterr().out
    jm.main(["-list", "delegate"])
    assert got == capsys.readouterr().out
    assert "dot (graphviz dot/gv): available" in got


# -- files through the CLI ----------------------------------------------------

@pytest.mark.parametrize("chain,out", [
    (["-flip", "-negate"], "exr"), (["-flop"], "miff"),
    (["-auto-threshold", "otsu"], "pbm"), (["-rotate", "90"], "ff")])
def test_cli_reads_and_writes_the_new_formats_like_jax(tmp_path, chain, out):
    """main() from a 16-bit MIFF page to EXR, MIFF, PBM and farbfeld:
    the output files equal the JAX CLI's byte for byte."""
    t, j = _pair(_pixels(28, c=1), **_spec(1, depth=16))
    src = tmp_path / "page.miff"
    src.write_bytes(jio.image_to_blob(j, "miff"))
    assert tio.image_to_blob(t, "miff") == src.read_bytes()
    po, jo = tmp_path / f"port.{out}", tmp_path / f"jax.{out}"
    assert tm.main([str(src), *chain, str(po)], device="cpu") == 0
    assert jm.main([str(src), *chain, str(jo)]) == 0
    assert po.read_bytes() == jo.read_bytes()
