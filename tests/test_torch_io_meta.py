"""Port parity: io/coders_r4b.py (STRIMG, DEBUG, MATTE, META, DMR, WMF,
JBIG), io/emf.py, the Radiance HDR coder and ``url:`` reads against the
JAX package, through the modules, io/'s dispatch and the CLI.

Inputs are made from a numpy seed at a few pixels a side; metafiles are
record streams built by hand as tests/test_coders_r4b.py and
tests/test_emf.py build them.  Every encoder gives the JAX encoder's
bytes from equal pixels (HDR: the JAX package writes it through OpenCV,
the port through its own numpy coder); every decoder gives the JAX
decoder's float32 pixels, spec and properties, bit for bit, from equal
bytes, but for a metafile's stretched DIB, whose triangle resize is held
within DIB_TOL; a truncated or malformed file raises the JAX decoder's
exception class.  One fault of the JAX package is kept visible in a
``test_jax_*`` test: its HDR writer raises IndexError on a gray image
with alpha, which the port writes as gray."""

import importlib
import struct

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.policy import PolicyError, no_host_files
from imagemagick_tpu_torch.io import coders_r4b as t4b
from imagemagick_tpu_torch.io import emf as temf

jio = importlib.import_module("imagemagick_tpu.io")
j4b = importlib.import_module("imagemagick_tpu.io.coders_r4b")
jemf = importlib.import_module("imagemagick_tpu.io.emf")
jm = importlib.import_module("imagemagick_tpu.cli.main")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec
TSpec = importlib.import_module("imagemagick_tpu_torch.core.spec").ImageSpec
jnative = importlib.import_module("imagemagick_tpu.native")

# The JAX package's native libraries: (library, source, g++ flags before
# the source, after it, loader, loaded-library attribute, failure flag).
# Its loaders build in place (``g++ ... -o <library>``) and remember a
# failure for the life of the process; a test run builds them in every
# worker at once (tests/test_native_models.py asks for libminiio while
# it is imported), and a worker that loads another's half-written file
# writes PNGs through PIL, with other bytes, for the rest of the run.
_JAX_LIBS = (
    ("_SO_PATH", "_SRC", ["-O3"], ["-ljpeg", "-lpng"], "_load", "_lib",
     "_build_failed"),
    ("_HJ_SO", "_HJ_SRC", ["-O3"], ["-ldl"], "_hj_load", "_hj_lib",
     "_hj_failed"),
    ("_RZ_SO", "_RZ_SRC", ["-O2"], [], "_rz_load", "_rz_lib", "_rz_failed"),
    ("_JB_SO", "_JB_SRC", ["-O2"], ["-ljbig"], "jbig_load", "_jb_lib",
     "_jb_failed"),
)


def _steady_jax_native_libraries(attempts=3):
    """Build the JAX package's native libraries once, atomically (a
    temporary name, then ``os.replace``), under one ``fcntl`` lock that
    every test worker takes on their directory, and load each in this
    worker, clearing a failure that an in-place build of another worker
    left behind.  Runs when this file is collected: every worker collects
    it before it runs a test, so afterwards no JAX loader builds in place.
    A library that does not build here stays as its loader finds it."""
    import fcntl
    import os
    import subprocess
    import time

    fd = os.open(os.path.dirname(jnative.__file__), os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        for so_attr, src_attr, pre, post, load, lib, failed in _JAX_LIBS:
            so, src = getattr(jnative, so_attr), getattr(jnative, src_attr)
            for attempt in range(attempts):
                if getattr(jnative, lib) is not None:
                    break
                if attempt or not os.path.exists(so) or \
                        os.path.getmtime(so) < os.path.getmtime(src):
                    tmp = f"{so}.{os.getpid()}.tmp"
                    res = subprocess.run(
                        ["g++", *pre, "-fPIC", "-shared", src, *post, "-o",
                         tmp], capture_output=True, timeout=120)
                    if res.returncode != 0:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                        break
                    os.replace(tmp, so)
                setattr(jnative, failed, False)
                if getattr(jnative, load)() is None:
                    time.sleep(0.2)
    finally:
        os.close(fd)


_steady_jax_native_libraries()


def _pixels(seed=0, h=5, w=7, c=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, c)) * scale).astype(np.float32)


def _pair(arr, **spec):
    return (TImage(torch.from_numpy(arr.copy()), TSpec(**spec)),
            JImage(arr.copy(), JSpec(**spec)))


# a metafile's DIB goes through ops.resize ("triangle"), whose float32
# products the port sums in another order (tests/test_torch_resize.py
# holds the resize within 1e-5; here the DIBs land within an ulp of 1)
DIB_TOL = 1e-6


def _same(got, want, atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.device == torch.device("cpu")
        a, b = g.data.numpy(), np.asarray(w.data)
        assert a.dtype == b.dtype and a.shape == b.shape
        if atol:
            assert float(np.abs(a - b).max()) <= atol
        else:
            assert np.array_equal(a, b, equal_nan=True)
        assert g.spec.__dict__ == w.spec.__dict__
        assert g.properties == w.properties
        assert {k: bytes(v) for k, v in g.profiles.items()} == \
            {k: bytes(v) for k, v in w.profiles.items()}


def _same_or_raise(port_call, jax_call):
    """The port's call gives the JAX call's images, or raises its class."""
    try:
        want = jax_call()
    except Exception as exc:   # noqa: BLE001 — the JAX class is the point
        with pytest.raises(type(exc)):
            port_call()
    else:
        _same(port_call(), want)


# -- STRIMG, DEBUG, MATTE ----------------------------------------------------

@pytest.mark.parametrize("c", [1, 3])
def test_strimg_matches_jax(c):
    t, j = _pair(_pixels(1, 1, 9, c), colorspace="gray" if c == 1
                 else "srgb")
    assert t4b.encode_strimg(t) == j4b.encode_strimg(j)
    assert tio.image_to_blob(t, "strimg") == jio.image_to_blob(j, "strimg")
    for text in ("hello world", "", "ünïcode"):
        _same(tio.read_images(f"strimg:{text}", device="cpu"),
              jio.read_images(f"strimg:{text}"))
    _same(tio.image_from_blob(b"from a blob\n", "strimg", device="cpu"),
          jio.image_from_blob(b"from a blob\n", "strimg"))


DEBUG_IMAGES = [
    ("gray", 1, "gray", False), ("gray-alpha", 2, "gray", True),
    ("rgb", 3, "srgb", False), ("rgba", 4, "srgb", True),
    ("cmyk", 4, "cmyk", False), ("cmyka", 5, "cmyk", True)]


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("name,c,cs,alpha", DEBUG_IMAGES,
                         ids=[d[0] for d in DEBUG_IMAGES])
def test_debug_matches_jax(name, c, cs, alpha, depth):
    arr = _pixels(2, 3, 4, c)
    arr[0, 0] = 0.5                       # a fraction of a quantum
    arr[0, 1] = np.float32(7 / 65535)     # a Q16 level, float32 noise
    t, j = _pair(arr, colorspace=cs, alpha=alpha, depth=depth)
    assert t4b.encode_debug([t, t]) == j4b.encode_debug([j, j])
    if cs != "cmyk":
        assert tio.image_to_blob(t, "debug") == jio.image_to_blob(j, "debug")


@pytest.mark.parametrize("depth", [8, 16])
def test_matte_matches_jax(depth):
    t, j = _pair(_pixels(3, 4, 6, 4), colorspace="srgb", alpha=True,
                 depth=depth)
    got = tio.image_to_blob(t, "matte")
    assert got == jio.image_to_blob(j, "matte")
    _same(tio.image_from_blob(got, device="cpu"), jio.image_from_blob(got))
    t, j = _pair(_pixels(3, 4, 6, 3), colorspace="srgb")
    with pytest.raises(ValueError, match="ImageDoesNotHaveAnAlphaChannel"):
        j4b.encode_matte(j)
    with pytest.raises(ValueError, match="ImageDoesNotHaveAnAlphaChannel"):
        t4b.encode_matte(t)


# -- META --------------------------------------------------------------------

def _sample_8bim(mod):
    iptc = (b"\x1c\x02\x05" + struct.pack(">H", 4) + b"Rose" +
            b"\x1c\x02\x78" + struct.pack(">H", 9) + b'cap"&\x01\xe9n' +
            b"\x1c\x02\x19" + struct.pack(">H", 3) + b"key")
    return mod._build_8bim([(1028, "", iptc), (2000, "Path", b"\x01\x02abc"),
                            (1036, "", bytes(range(256)))])


META_BLOBS = {
    "exif": b"Exif\0\0MM\0*\0\0\0\x08\0\0",
    "app1": b"Exif\0\0II*\0\x08\0\0\0\0\0",
    "xmp": b"<?xpacket begin=''?><x:xmpmeta xmlns:x='adobe:ns:meta/'/>",
    "icc": bytes(range(128)) * 3,
    "icm": b"\0\0\x02\x0clcms" + bytes(40),
}


@pytest.mark.parametrize("fmt", sorted(t4b._META_PROFILE))
def test_meta_formats_match_jax(fmt, tmp_path):
    assert t4b._META_PROFILE == j4b._META_PROFILE
    bim = _sample_8bim(t4b)
    assert bim == _sample_8bim(j4b)
    blob = {"8bim": bim, "8bimtext": t4b.format_8bimtext(bim).encode(),
            "iptc": t4b.iptc_from_8bim(bim),
            "iptctext": t4b.format_iptctext(
                t4b.iptc_from_8bim(bim)).encode()}.get(fmt, META_BLOBS.get(
                    fmt))
    got = tio.image_from_blob(blob, fmt, device="cpu")
    want = jio.image_from_blob(blob, fmt)
    _same(got, want)
    path = tmp_path / f"in.{fmt}"
    path.write_bytes(blob)
    _same(tio.read_images(str(path), device="cpu"),
          jio.read_images(str(path)))
    # a prefix must start with a letter: "8bim:..." names a file in both
    _same_or_raise(lambda: tio.read_images(f"{fmt}:{path}", device="cpu"),
                   lambda: jio.read_images(f"{fmt}:{path}"))
    assert tio.image_to_blob(got[0], fmt) == jio.image_to_blob(want[0], fmt)
    # from an image that holds only the 8BIM profile: the text grammars
    # and IPTC come out of it, the others raise
    t, j = _pair(_pixels(4, 2, 2), colorspace="srgb")
    t.profiles["8bim"], j.profiles["8bim"] = bim, bim
    try:
        want_b = jio.image_to_blob(j, fmt)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            tio.image_to_blob(t, fmt)
    else:
        assert tio.image_to_blob(t, fmt) == want_b


def test_meta_grammars_match_jax():
    bim = _sample_8bim(t4b)
    iptc = t4b.iptc_from_8bim(bim)
    for name in ("format_8bimtext", "format_iptctext", "_format_escape"):
        arg = iptc if name == "format_iptctext" else bim
        assert getattr(t4b, name)(arg) == getattr(j4b, name)(arg)
    text = t4b.format_8bimtext(bim) + '2#25#Keyword="&lt;&gt;&#300;&bad;"\n'
    for name in ("parse_8bimtext", "parse_iptctext"):
        assert getattr(t4b, name)(text) == getattr(j4b, name)(text)
    assert list(t4b._iter_iptc(iptc + b"\x1c\x02\x05\x80\x00")) == \
        list(j4b._iter_iptc(iptc + b"\x1c\x02\x05\x80\x00"))
    assert t4b.iptc_from_8bim(b"no resources") is None
    t, j = _pair(_pixels(4, 2, 2), colorspace="srgb")
    t.profiles["8bim"] = j.profiles["8bim"] = t4b._build_8bim([(1028, "", b"")])
    for mod, im in ((j4b, j), (t4b, t)):
        with pytest.raises(ValueError, match="NoIPTCProfileAvailable"):
            mod.encode_meta(im, "iptc")


# -- DMR ---------------------------------------------------------------------

def _dmr_settings(root, passphrase=None):
    d = {"dmr:path": str(root)}
    if passphrase is not None:
        d["dmr:passphrase"] = passphrase
    return {"defines": d}


@pytest.mark.parametrize("passphrase", [None, "open sesame", "file"])
def test_dmr_round_trip_matches_jax(tmp_path, passphrase):
    if passphrase == "file":
        passphrase = str(tmp_path / "key.txt")
        (tmp_path / "key.txt").write_bytes(b"a key \x00 in a file")
    t, j = _pair(_pixels(5, 4, 5, 3), colorspace="srgb", depth=16)
    for side, mod, im in (("t", t4b, t), ("j", j4b, j)):
        mod.write_dmr([im, im], "image/tests/rose",
                      _dmr_settings(tmp_path / side, passphrase))
    blob = (tmp_path / "t/image/tests/rose/resource.miff").read_bytes()
    assert blob == (tmp_path / "j/image/tests/rose/resource.miff"
                    ).read_bytes()
    got = t4b.read_dmr("image/tests/rose",
                       _dmr_settings(tmp_path / "t", passphrase),
                       device="cpu")
    _same(got, j4b.read_dmr("image/tests/rose",
                            _dmr_settings(tmp_path / "j", passphrase)))
    assert len(got) == 2
    # through io/'s names
    tio.write_image(t, "dmr:image/io/one",
                    settings=_dmr_settings(tmp_path / "t", passphrase))
    _same(tio.read_images("dmr:image/io/one",
                          settings=_dmr_settings(tmp_path / "t", passphrase),
                          device="cpu"),
          jio.read_images("dmr:image/io/one",
                          settings=_dmr_settings(tmp_path / "t", passphrase)))
    if passphrase is not None:
        # the wrong passphrase deciphers to bytes no decoder takes
        for mod, kw in ((j4b, {}), (t4b, {"device": "cpu"})):
            with pytest.raises(ValueError):
                mod.read_dmr("image/tests/rose",
                             _dmr_settings(tmp_path / "t"), **kw)


def test_dmr_meta_escapes_and_magick_cache(tmp_path, monkeypatch):
    mi_t, mi_j = _pair(np.zeros((1, 1, 3), np.float32))
    mi_t.properties["dmr:meta"] = mi_j.properties["dmr:meta"] = "hello"
    st = _dmr_settings(tmp_path, "pp")
    t4b.write_dmr([mi_t], "meta/greeting", st)
    _same(t4b.read_dmr("meta/greeting", st, device="cpu"),
          j4b.read_dmr("meta/greeting", st))
    for iri in ("../outside", "image/../../x", "", "/./"):
        for mod, kw in ((j4b, {}), (t4b, {"device": "cpu"})):
            with pytest.raises(mod.DMRError):
                mod.read_dmr(iri, st, **kw)
    for mod, kw in ((j4b, {}), (t4b, {"device": "cpu"})):
        with pytest.raises(mod.DMRError, match="no such resource"):
            mod.read_dmr("image/none", st, **kw)
    # the repository root from $MAGICK_CACHE, and none at all
    monkeypatch.setenv("MAGICK_CACHE", str(tmp_path))
    _same(t4b.read_dmr("meta/greeting", {"dmr:passphrase": "pp"},
                       device="cpu"),
          j4b.read_dmr("meta/greeting", {"dmr:passphrase": "pp"}))
    monkeypatch.delenv("MAGICK_CACHE")
    for mod, kw in ((j4b, {}), (t4b, {"device": "cpu"})):
        with pytest.raises(mod.DMRError, match="no repository path"):
            mod.read_dmr("image/x", {}, **kw)


def test_dmr_through_the_cli_as_jax(tmp_path):
    from PIL import Image as PImage

    src = tmp_path / "in.png"
    PImage.fromarray((_pixels(6, 6, 8) * 255).astype(np.uint8)).save(src)
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        root = tmp_path / side
        assert main(["-define", f"dmr:path={root}", "-define",
                     "dmr:passphrase=xyz", str(src), str(src), "-flip",
                     "dmr:image/cli/batch"]) == 0
        assert main(["-define", f"dmr:path={root}", "-define",
                     "dmr:passphrase=xyz", "dmr:image/cli/batch",
                     str(tmp_path / f"{side}-%d.png")]) == 0
    for k in range(2):
        assert (tmp_path / f"t-{k}.png").read_bytes() == \
            (tmp_path / f"j-{k}.png").read_bytes()


# -- WMF ---------------------------------------------------------------------

def _wmf_rec(func, params, tail=b""):
    body = b"".join(struct.pack("<h", p) if -32768 <= p < 32768
                    else struct.pack("<H", p & 0xFFFF) for p in params)
    body += tail + b"\0" * (len(tail) & 1)
    return struct.pack("<IH", 3 + len(body) // 2, func) + body


def _dib(arr):
    """A BITMAPINFOHEADER and 24-bit bottom-up rows of ``arr`` (h, w, 3)
    u8."""
    h, w, _ = arr.shape
    stride = (w * 3 + 3) & ~3
    rows = b"".join(arr[y, :, ::-1].tobytes().ljust(stride, b"\0")
                    for y in range(h - 1, -1, -1))
    return struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(rows), 0, 0,
                       0, 0) + rows


def _wmf(recs, placeable=True, box=(0, 0, 100, 100), inch=72):
    recs = recs + _wmf_rec(0x0000, [])
    hdr = struct.pack("<HHHIHIH", 1, 9, 0x300, (18 + len(recs)) // 2,
                      2, 0, 0)
    if not placeable:
        return hdr + recs
    ph = (struct.pack("<IH4hH", 0x9AC6CDD7, 0, *box, inch) +
          struct.pack("<IH", 0, 0))
    return ph + hdr + recs


def _wmf_samples():
    dib = _dib((_pixels(7, 3, 4) * 255).astype(np.uint8))
    sample = (                               # tests/test_coders_r4b.py's
        _wmf_rec(0x020C, [100, 100]) + _wmf_rec(0x020B, [0, 0]) +
        _wmf_rec(0x02FC, [0, 0x00FF, 0x0000]) + _wmf_rec(0x012D, [0]) +
        _wmf_rec(0x02FA, [0, 2, 0, 0x0000, 0x00FF]) + _wmf_rec(0x012D, [1]) +
        _wmf_rec(0x041B, [80, 80, 20, 20]) + _wmf_rec(0x0214, [5, 5]) +
        _wmf_rec(0x0213, [95, 95]) + _wmf_rec(0x0418, [95, 95, 82, 82]))
    text = (
        _wmf_rec(0x020C, [64, 64]) + _wmf_rec(0x020B, [0, 0]) +
        _wmf_rec(0x02FC, [0, 0x0000, 0x0000]) + _wmf_rec(0x012D, [0]) +
        _wmf_rec(0x0324, [3, 4, 60, 32, 4, 60, 60]) +
        _wmf_rec(0x0521, [2], b"Hi" + struct.pack("<hh", 10, 6)))
    many = (
        _wmf_rec(0x020C, [80, 120]) + _wmf_rec(0x020B, [-10, 5]) +
        _wmf_rec(0x02FA, [1, 3, 0, 0x8000, 0x0000]) +       # dashed pen
        _wmf_rec(0x02FA, [2, 1, 0, 0x00FF, 0x0080]) +       # dotted pen
        _wmf_rec(0x02FC, [0, 0xC040, 0x0020]) +             # brush
        _wmf_rec(0x00F7, []) +                              # pattern brush
        _wmf_rec(0x02FB, [-14] + [0] * 8, b"Courier\0") +   # font
        _wmf_rec(0x012D, [0]) + _wmf_rec(0x012D, [2]) +
        _wmf_rec(0x012D, [4]) + _wmf_rec(0x0209, [0x00FF, 0x0000]) +
        _wmf_rec(0x0325, [3, 10, 10, 50, 60, 100, 10]) +     # polyline
        _wmf_rec(0x0538, [2, 3, 4, 10, 30, 30, 30, 20, 50,
                          60, 40, 90, 40, 90, 70, 60, 70]) +
        _wmf_rec(0x061C, [10, 16, 70, 110, 50, 70]) +        # roundrect
        _wmf_rec(0x012D, [1]) + _wmf_rec(0x012D, [3]) +
        _wmf_rec(0x0418, [60, 40, 20, 0]) +
        _wmf_rec(0x041F, [0x00FF, 0x00FF, 5, 5]) +            # setpixel
        _wmf_rec(0x0A32, [40, 8, 3, 0], b"Abc") +             # exttextout
        _wmf_rec(0x0A32, [60, 8, 2, 4, 0, 0, 9, 9], b"Zq") +  # clipped
        _wmf_rec(0x01F0, [2]) + _wmf_rec(0x012D, [2]) +
        _wmf_rec(0x0F43, [0x20, 0x00CC, 0, 3, 4, 0, 0, 30, 40, 45, 70],
                 dib) +                                       # StretchDIB
        _wmf_rec(0x0B41, [0x20, 0x00CC, 3, 4, 0, 0, 12, 20, 5, 90],
                 dib) +                                       # DIBStretchBlt
        _wmf_rec(0x0F43, [0, 0, 0, 1, 1, 0, 0, 9, 9, 0, 0],
                 b"\x0c" + bytes(40)))                        # bad DIB
    return {"sample": _wmf(sample), "text-polygon": _wmf(text, False),
            "records": _wmf(many, box=(-20, -10, 180, 110), inch=288),
            "no-window": _wmf(_wmf_rec(0x041B, [30, 30, 10, 10]), False)}


@pytest.mark.parametrize("name", sorted(_wmf_samples()))
def test_wmf_decodes_as_jax(name):
    blob = _wmf_samples()[name]
    _same(tio.image_from_blob(blob, "wmf", device="cpu"),
          jio.image_from_blob(blob, "wmf"),
          DIB_TOL if name == "records" else 0.0)


# -- EMF ---------------------------------------------------------------------

def _rec(rtype, payload=b""):
    size = 8 + len(payload)
    pad = (-size) % 4
    return struct.pack("<II", rtype, size + pad) + payload + b"\0" * pad


def _emf(records, bounds=(0, 0, 99, 99), frame=None):
    """A minimal EMF: EMR_HEADER + records + EMR_EOF (tests/test_emf.py)."""
    if frame is None:
        frame = (0, 0, int(round((bounds[2] + 1) * 2540 / 96.0)),
                 int(round((bounds[3] + 1) * 2540 / 96.0)))
    body = b"".join(records) + _rec(14, struct.pack("<3I", 0, 16, 20))
    hdr_payload = struct.pack(
        "<4i4iIIIHHIII2i2i", *bounds, *frame, temf._EMF_SIG, 0x10000,
        88 + len(body), len(records) + 2, 16, 0, 0, 0, 1024, 768, 270, 203)
    return struct.pack("<II", 1, 8 + len(hdr_payload)) + hdr_payload + body


def _pts16(pts):
    return b"".join(struct.pack("<2h", x, y) for x, y in pts)


def _poly16(rtype, pts):
    return _rec(rtype, struct.pack("<4iI", 0, 0, 99, 99, len(pts)) +
                _pts16(pts))


def _stretch_dib(x, y, w, h, arr):
    dib = _dib(arr)
    bmi, bits = dib[:40], dib[40:]
    head = struct.pack("<4i6i4I2I2i", 0, 0, 99, 99, x, y, 0, 0,
                       arr.shape[1], arr.shape[0], 80, 40, 120, len(bits),
                       0, 0x00CC0020, w, h)
    return _rec(81, head + bmi + bits)


def _ext_text(x, y, msg, wide=True):
    raw = msg.encode("utf-16le" if wide else "latin-1")
    emrtext = struct.pack("<2iIII4iI", x, y, len(msg), 76, 0, 0, 0, 0, 0, 0)
    return _rec(84 if wide else 83,
                struct.pack("<4iI2f", 0, 0, 99, 99, 1, 1.0, 1.0) + emrtext +
                raw)


def _emf_samples():
    dib = (_pixels(8, 4, 5) * 255).astype(np.uint8)
    stock = [_rec(37, struct.pack("<I", 0x80000000 | 8)),
             _rec(37, struct.pack("<I", 0x80000000 | 4)),
             _poly16(86, [(10, 10), (90, 10), (50, 90)]),
             _rec(37, struct.pack("<I", 0x80000000 | 7)),
             _rec(37, struct.pack("<I", 0x80000000 | 1)),
             _rec(43, struct.pack("<4i", 60, 60, 95, 95))]
    path = [_rec(39, struct.pack("<IIII", 1, 0, 0x00FF00, 0)),
            _rec(37, struct.pack("<I", 1)), _rec(59),
            _rec(27, struct.pack("<2i", 10, 10)),
            _rec(54, struct.pack("<2i", 90, 10)),
            _rec(54, struct.pack("<2i", 90, 90)),
            _poly16(88, [(60, 95), (30, 95), (10, 60)]),
            _poly16(89, [(10, 40), (12, 20)]), _rec(61), _rec(60),
            _rec(62, struct.pack("<4i", 0, 0, 99, 99)),
            _rec(59), _poly16(86, [(20, 20), (40, 20), (30, 35)]), _rec(60),
            _rec(63, struct.pack("<4i", 0, 0, 99, 99)),
            _rec(59), _poly16(87, [(5, 95), (95, 5)]), _rec(60),
            _rec(64, struct.pack("<4i", 0, 0, 99, 99))]
    xform = [_rec(10, struct.pack("<2i", 0, 0)),
             _rec(9, struct.pack("<2i", 200, 200)),
             _rec(12, struct.pack("<2i", 0, 0)),
             _rec(11, struct.pack("<2i", 100, 100)),
             _rec(39, struct.pack("<IIII", 1, 0, 0xFF0000, 0)),
             _rec(37, struct.pack("<I", 1)),
             _rec(37, struct.pack("<I", 0x80000000 | 8)),
             _rec(43, struct.pack("<4i", 100, 100, 200, 200)),
             _rec(35, struct.pack("<6f", 0.8, 0.2, -0.2, 0.8, 30, 10)),
             _rec(95, struct.pack("<I4I4I", 2, 0, 0, 0, 0, 1, 3, 0,
                                  0x0000FF)),
             _rec(37, struct.pack("<I", 2)),
             _rec(42, struct.pack("<4i", 20, 20, 120, 80)),
             _rec(36, struct.pack("<6fI", 1, 0, 0, 1, 5, 5, 2)),
             _rec(44, struct.pack("<6i", 10, 100, 90, 180, 20, 30)),
             _rec(36, struct.pack("<6fI", 1, 0, 0, 1, -5, 0, 3)),
             _rec(85, struct.pack("<4iI", 0, 0, 99, 99, 4) +
                  _pts16([(0, 150), (50, 100), (100, 200), (150, 150)])),
             _rec(36, struct.pack("<6fI", 1, 0, 0, 1, 0, 0, 1)),
             _rec(91, struct.pack("<4iII2I", 0, 0, 99, 99, 2, 7, 3, 4) +
                  _pts16([(0, 0), (30, 0), (0, 30), (150, 150), (190, 150),
                          (190, 190), (150, 190)])),
             _rec(90, struct.pack("<4iII2I", 0, 0, 99, 99, 2, 4, 2, 2) +
                  _pts16([(0, 199), (199, 0), (0, 100), (199, 100)])),
             _rec(15, struct.pack("<2iI", 150, 20, 0x00FF00)),
             _rec(40, struct.pack("<I", 2))]
    text = [_rec(24, struct.pack("<I", 0x204080)),
            _rec(82, struct.pack("<Ii", 1, -20) + b"\0" * 24 +
                 "Arial".encode("utf-16le") + b"\0" * 54),
            _rec(37, struct.pack("<I", 1)),
            _ext_text(10, 40, "Hi"), _ext_text(30, 70, "Ab", wide=False)]
    dibs = [_stretch_dib(10, 20, 20, 15, dib),
            _stretch_dib(70, 5, 20, 60, dib[:3, :3]),
            _rec(81, bytes(72)),
            _rec(38, struct.pack("<IIiiI", 3, 1, 2, 0, 0x000000)),
            _rec(37, struct.pack("<I", 3)),
            _rec(54, struct.pack("<2i", 99, 99))]
    return {"stock": _emf(stock), "path": _emf(path), "transforms":
            _emf(xform), "text": _emf(text), "dibs": _emf(dibs),
            "degenerate-frame": _emf(stock, bounds=(5, 5, 64, 40),
                                     frame=(0, 0, 0, 0))}


@pytest.mark.parametrize("name", sorted(_emf_samples()))
def test_emf_decodes_as_jax(name):
    blob = _emf_samples()[name]
    assert temf.is_emf(blob) and tio.detect_format(blob) == "emf"
    tol = DIB_TOL if name == "dibs" else 0.0
    _same(tio.image_from_blob(blob, device="cpu"), jio.image_from_blob(blob),
          tol)
    if name == "stock":       # at another density
        _same([temf.decode_emf(blob, 48.0, device="cpu")],
              [jemf.decode_emf(blob, 48.0)])


# -- HDR ---------------------------------------------------------------------

HDR_IMAGES = [
    ("rgb", (6, 9, 3)), ("gray", (5, 10, 1)), ("rgba", (4, 8, 4)),
    ("narrow", (3, 7, 3)), ("flat-runs", (4, 300, 3)),
    ("wide", (1, 32768, 3))]


def _hdr_pixels(name, shape):
    arr = _pixels(9, *shape, scale=16.0)
    if name == "flat-runs":
        arr[:, 40:200] = arr[:, 40:41]
        arr[1, 220:223] = 0.0
        arr[2] = 1e-40
    arr[0, 0, 0] = 0.0
    return arr


@pytest.mark.parametrize("name,shape", HDR_IMAGES,
                         ids=[h[0] for h in HDR_IMAGES])
def test_hdr_matches_jax(name, shape):
    arr = _hdr_pixels(name, shape)
    c = shape[-1]
    spec = dict(colorspace="gray" if c == 1 else "rgb", alpha=c == 4)
    t, j = _pair(arr, **spec)
    blob = tio.image_to_blob(t, "hdr")
    assert blob == jio.image_to_blob(j, "hdr")
    got = tio.image_from_blob(blob, device="cpu")
    _same(got, jio.image_from_blob(blob))
    assert got[0].data.max() > 1.0           # values above 1, unclipped


def _rgbe_file(magic, w, h, body):
    return (magic + b"\nFORMAT=32-bit_rle_rgbe\n\n" +
            b"-Y %d +X %d\n" % (h, w) + body)


HDR_FILES = {
    "rgbe-flat": _rgbe_file(b"#?RGBE", 2, 1, bytes([128, 64, 32, 129,
                                                    1, 2, 3, 130])),
    "rle-then-flat": _rgbe_file(
        b"#?RADIANCE", 8, 2, bytes([2, 2, 0, 8]) + b"".join(
            bytes([136, v]) for v in (128, 64, 32, 129)) +
        bytes([1, 2, 3, 140]) * 8),
    "literals": _rgbe_file(
        b"#?RADIANCE", 9, 1, bytes([2, 2, 0, 9]) + b"".join(
            bytes([9]) + bytes(range(v, v + 9)) for v in (10, 40, 70)) +
        bytes([133, 128, 132, 129])),
    "header-lines": b"#?RADIANCE\nGAMMA=1\nEXPOSURE=2\n" + b"X" * 300 +
    b"\nFORMAT=32-bit_rle_rgbe\n\n-Y1+X2 trailing\n" + bytes(range(8)),
}


@pytest.mark.parametrize("name", sorted(HDR_FILES))
def test_hdr_files_decode_as_jax(name):
    blob = HDR_FILES[name]
    _same(tio.image_from_blob(blob, device="cpu"), jio.image_from_blob(blob))


def test_jax_hdr_writer_raises_on_gray_with_alpha():
    """The JAX _encode_hdr indexes channels [2, 1, 0] of a gray image with
    alpha (IndexError); the port writes its gray three times and drops
    alpha, the bytes the JAX writer gives the gray channel alone."""
    arr = _pixels(10, 4, 9, 2, 4.0)
    t, j = _pair(arr, colorspace="gray", alpha=True)
    with pytest.raises(IndexError):
        jio.image_to_blob(j, "hdr")
    _, j1 = _pair(arr[..., :1], colorspace="gray")
    assert tio.image_to_blob(t, "hdr") == jio.image_to_blob(j1, "hdr")


# -- JBIG --------------------------------------------------------------------

def test_jbig_matches_jax_where_libjbig_builds():
    if not tnat.jbig_available():
        pytest.skip("libjbig does not build here")
    bm = np.random.default_rng(11).random((40, 70, 3)).astype(np.float32)
    t, j = _pair(bm, colorspace="srgb")
    blob = tio.image_to_blob(t, "jbig")
    assert blob == jio.image_to_blob(j, "jbig")
    for fmt in ("jbig", "jbg", "bie"):
        _same(tio.image_from_blob(blob, fmt, device="cpu"),
              jio.image_from_blob(blob, fmt))
    assert {"jbig", "jbg", "bie"} <= set(tio.supported_read_formats())
    assert {"jbig", "jbg", "bie"} <= set(tio.supported_write_formats())


def test_jbig_without_libjbig_raises_the_jax_error(monkeypatch):
    t, _ = _pair(_pixels(12, 4, 4), colorspace="srgb")
    monkeypatch.setattr(tnat, "jbig_encode", lambda bm: None)
    monkeypatch.setattr(tnat, "jbig_decode", lambda data: None)
    with pytest.raises(ValueError, match="libjbig unavailable"):
        tio.image_to_blob(t, "jbig")
    with pytest.raises(ValueError, match="JBIG decode failed"):
        tio.image_from_blob(b"\0" * 20, "jbig", device="cpu")


# -- url: --------------------------------------------------------------------

def test_file_urls_read_as_jax(tmp_path):
    from PIL import Image as PImage

    path = tmp_path / "u.png"
    PImage.fromarray((_pixels(13, 6, 5) * 255).astype(np.uint8)).save(path)
    for name in (f"file://{path}", f"url:file://{path}"):
        _same(tio.read_images(name, device="cpu"), jio.read_images(name))
    for name, exc in ((f"file://{tmp_path}/none.png", IOError),):
        with pytest.raises(exc):
            jio.read_images(name)
        with pytest.raises(exc):
            tio.read_images(name, device="cpu")


# -- malformed files ---------------------------------------------------------

MALFORMED = {
    "wmf-short": (b"\xd7\xcd\xc6\x9a" + b"\0" * 18, "wmf"),
    "wmf-header": (b"\0" * 40, "wmf"),
    "wmf-zeros": (b"\xd7\xcd\xc6\x9a" + b"\0" * 64, None),
    "emf-short": (b"\x01\0\0\0" + b"\0" * 40, "emf"),
    "emf-zeros": (b"\x01\0\0\0" + b"\0" * 36 + b" EMF" + b"\0" * 40, None),
    "hdr-zeros": (b"#?RADIANCE\n" + b"\0" * 64, None),
    "hdr-cut": (HDR_FILES["literals"][:-5], None),
    "hdr-width": (_rgbe_file(b"#?RADIANCE", 8, 1, bytes([2, 2, 0, 9])),
                  None),
    "hdr-orientation": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 2\n"
                        + bytes(8), None),
    "hdr-no-format": (b"#?RADIANCE\n\n-Y 1 +X 2\n" + bytes(8), None),
    "hdr-magic": (b"#?NOPE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n" +
                  bytes(8), "hdr"),
    "hdr-zero-run": (_rgbe_file(b"#?RADIANCE", 8, 1, bytes([2, 2, 0, 8, 0,
                                                            1])), None),
    "8bimtext": (b"8BIM#1=\"unterminated\n\xff\xfe", "8bimtext"),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_files_raise_as_jax(name):
    blob, fmt = MALFORMED[name]
    _same_or_raise(lambda: tio.image_from_blob(blob, fmt, device="cpu"),
                   lambda: jio.image_from_blob(blob, fmt))


# -- the policy --------------------------------------------------------------

def test_host_files_refused_inside_no_host_files(tmp_path):
    t, _ = _pair(_pixels(14, 3, 3), colorspace="srgb")
    st = _dmr_settings(tmp_path)
    t4b.write_dmr([t], "image/x", st)
    key = tmp_path / "key"
    key.write_bytes(b"k")
    png = tmp_path / "p.png"
    png.write_bytes(b"")
    with no_host_files():
        for call in (
                lambda: tio.read_images("dmr:image/x", settings=st,
                                        device="cpu"),
                lambda: tio.write_image(t, "dmr:image/y", settings=st),
                lambda: t4b.read_dmr("image/x", {}, device="cpu"),
                lambda: t4b._dmr_passphrase({"dmr:passphrase": str(key)}),
                lambda: tio.read_images(f"file://{png}", device="cpu"),
                lambda: tio.read_images(f"url:file://{png}", device="cpu"),
                lambda: tio.read_images("http://localhost:9/x.png",
                                        device="cpu"),
                lambda: tio.read_images("https://localhost:9/x.png",
                                        device="cpu")):
            with pytest.raises(PolicyError):
                call()
    assert not (tmp_path / "image/y").exists()


def test_formats_lists_name_the_coders_of_this_slice():
    reads, writes = tio.supported_read_formats(), tio.supported_write_formats()
    for fmt in ("strimg", "dmr", "wmf", "emf", "hdr", "8bim", "8bimtext",
                "exif", "xmp", "icc", "iptc", "iptctext"):
        assert fmt in reads
    for fmt in ("strimg", "debug", "matte", "dmr", "hdr", "8bim",
                "8bimtext", "iptc", "iptctext", "xmp", "icc"):
        assert fmt in writes
    assert ("jbig" in reads) == tnat.jbig_available()
    assert {"jbig", "jbg", "bie", "hdr", "debug"} <= set(
        tio.known_write_formats())


@pytest.mark.parametrize("out", ["out.hdr", "debug:{d}/dbg.txt",
                                 "out.matte", "strimg:{d}/s.txt",
                                 "icc:{d}/p.icc", "{d}/t.8bimtext"])
def test_cli_writes_as_jax(tmp_path, out):
    from PIL import Image as PImage

    src = tmp_path / "in.png"
    arr = np.concatenate([(_pixels(15, 5, 6) * 255).astype(np.uint8),
                          np.full((5, 6, 1), 200, np.uint8)], -1)
    PImage.fromarray(arr).save(src)
    prof = tmp_path / "prof"
    if out.startswith("icc"):
        prof.write_bytes(META_BLOBS["icc"])
        inputs = [f"icc:{prof}"]
    elif "8bim" in out:
        prof = tmp_path / "prof.8bim"
        prof.write_bytes(_sample_8bim(t4b))
        inputs = [str(prof)]
    else:
        inputs = [str(src), "-flip"]
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        d = tmp_path / side
        d.mkdir()
        name = out.format(d=d) if "{d}" in out else str(d / out)
        assert main(inputs + [name]) == 0
        outs.append(open(name.split(":", 1)[-1], "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", ["wmf", "emf", "hdr", "strimg", "file"])
def test_cli_reads_metafiles_and_hdr_as_jax(tmp_path, kind):
    """wmf:, emf:, hdr:, strimg: and file: names read through the CLI as
    through the JAX CLI."""
    from PIL import Image as PImage

    if kind == "strimg":
        name = "strimg:Hello, CLI"
    elif kind == "file":
        src = tmp_path / "in.png"
        PImage.fromarray((_pixels(16, 8, 10) * 255).astype(np.uint8)).save(
            src)
        name = f"file://{src}"
    else:
        blob = {"wmf": _wmf_samples()["sample"],
                "emf": _emf_samples()["stock"],
                "hdr": HDR_FILES["literals"]}[kind]
        src = tmp_path / f"in.{kind}"
        src.write_bytes(blob)
        name = f"{kind}:{src}"
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.png"
        assert main([name, "-resize", "50%", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
