"""Port parity: io/formats4.py (AAI, HRZ, SCR, RGF, CIP, TXT, INLINE, PGX,
VIPS, UYVY, CALS, ART, SCT, XWD, braille, UIL, HTML, CUBE, TIM, SFW, CUT,
RLE, MAC, PIX, YUV, BAYER, TIM2, JNX, PES, 16-bit TIFF, DCX, CUR, MAGICK,
IPL, MAP, FTXT, ASHLAR, EPT, WPG, PWP, MVG, TTF, stegano: and PDB)
against the JAX package, through the module, io/'s dispatch and the CLI.

Inputs are made from a numpy seed at tens of pixels a side (one CALS page
is 1728 wide); hand-built files are made as the JAX tests make them in
test_formats4.py.  Tolerances: none, but for MAP's and WPG's k-means on a
noisy image.  Every encoder gives the JAX encoder's bytes from equal
pixels (MAP and WPG on a posterized image of at most 64 colours, where
k-means lands on the same centres); every decoder gives the JAX
decoder's float32 pixels, spec, properties and page, bit for bit, from
equal bytes; a truncated or malformed file raises the JAX decoder's
exception class.  The coders that pass through PNG, JPEG or TIFF take
PIL on both sides (the native codecs off).  Two faults of the JAX module
are kept visible in ``test_jax_*`` tests: its WPG writer's 128-byte
literal runs, and the JAX package's 48-bit TIFFs that its deep reader
declines, which Pillow narrows to 8 bits."""

import importlib
import io as _io
import struct

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.policy import PolicyError, no_host_files
from imagemagick_tpu_torch.io import formats4 as t4

jio = importlib.import_module("imagemagick_tpu.io")
j4 = importlib.import_module("imagemagick_tpu.io.formats4")
jnat = importlib.import_module("imagemagick_tpu.native")
jm = importlib.import_module("imagemagick_tpu.cli.main")
jvfx = importlib.import_module("imagemagick_tpu.ops.visual_effects")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec
TSpec = importlib.import_module("imagemagick_tpu_torch.core.spec").ImageSpec

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
# MAP and WPG on a noisy image: the JAX k-means sums its clusters in
# float32 by matmul, the port's in float64, so a centre moves by an ulp
# and a label near a boundary flips, and flips cascade (ROADMAP.md Queue
# 3, "K-means sums its clusters in float64"; the bound of
# test_set_image_type_palette_by_kmeans_matches_jax, 4 % of the labels)
KMEANS_LABELS_APART = 0.04
KMEANS_PALETTE_CODES = 1


def _pixels(seed=0, h=14, w=19, c=3, spill=True):
    """Smooth texture, a flat block and noise, float32; with ``spill`` a
    few samples lie outside [0, 1] (the encoders clip them)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.45 * np.sin(yy / 4.0)[..., None] * np.cos(
        xx[..., None] / 5.0 + np.arange(c))
    img = base + 0.05 * rng.standard_normal((h, w, c))
    img[h // 3:h // 2, w // 4:w // 2] = 0.75
    if not spill:
        img = np.clip(img, 0, 1)
    return img.astype(np.float32)


def _spec(c, **kw):
    d = dict(colorspace="gray" if c <= 2 else "srgb", alpha=c in (2, 4))
    d.update(kw)
    return d


def _pair(arr, **spec):
    spec = spec or _spec(arr.shape[-1])
    return (TImage(torch.from_numpy(arr.copy()), TSpec(**spec)),
            JImage(arr.copy(), JSpec(**spec)))


def _arr(img) -> np.ndarray:
    d = img.data
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _same(got, want):
    """Images (or lists) equal bit for bit, with equal spec, properties,
    profiles, page and delay; the port's on the CPU."""
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.device == torch.device("cpu")
        assert g.data.dtype == torch.float32
        a, b = _arr(g), _arr(w)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert (g.spec.colorspace, g.spec.alpha, g.spec.depth) == \
            (w.spec.colorspace, w.spec.alpha, w.spec.depth)
        assert (g.properties, g.profiles, g.page, g.delay) == \
            (w.properties, w.profiles, w.page, w.delay)


def _decode_both(name, blob, *args):
    """The port's ``name`` decoder (on the CPU) and the JAX one's on the
    same bytes: equal images, or an error of the same class."""
    try:
        want = getattr(j4, name)(blob, *args)
    except Exception as e:      # the port raises as the JAX module does
        with pytest.raises(type(e)):
            getattr(t4, name)(blob, *args, device="cpu")
        return None
    got = getattr(t4, name)(blob, *args, device="cpu")
    _same(got, want)
    return got


@pytest.fixture
def pil_codecs(monkeypatch):
    """Both packages without their native JPEG and PNG codecs: PIL's."""
    monkeypatch.setattr(jnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "png_available", lambda: False)


# -- encoders: the JAX bytes ------------------------------------------------

def _enc_cases():
    cases = []
    for c in (1, 2, 3, 4):
        cases += [("encode_aai", c, {}), ("encode_xwd", c, {}),
                  ("encode_tim", c, {}), ("encode_tiff16", c, {})]
    for c in (1, 3):
        cases += [("encode_rgf", c, {}), ("encode_cip", c, {}),
                  ("encode_art", c, {}), ("encode_cals", c, {}),
                  ("encode_uil", c, {}), ("encode_pdb", c, {}),
                  ("encode_ftxt", c, {})]
        for depth in (8, 16):
            cases += [("encode_pgx", c, {"depth": depth}),
                      ("encode_ipl", c, {"depth": depth}),
                      ("encode_bayer", c, {"depth": depth})]
    for c in (1, 2, 3, 4):
        for depth in (8, 16):
            cases.append(("encode_vips", c, {"depth": depth}))
    for variant in ("brf", "ubrl", "ubrl6", "isobrl", "isobrl6"):
        cases.append(("encode_braille", 3, {"variant": variant}))
    cases += [("encode_yuv", 3, {}), ("encode_hrz", 3, {})]
    return cases


@pytest.mark.parametrize("name,c,kw", _enc_cases(),
                         ids=lambda v: str(v) if not isinstance(v, dict)
                         else "-".join(f"{k}{x}" for k, x in v.items()))
def test_encoders_give_the_jax_bytes(name, c, kw):
    """Odd extents (braille's cells, PGX's and ART's padding), values
    outside [0, 1], gray with alpha and RGBA (TIFF16 drops alpha); HRZ
    from a 14x19 image resizes it to 256x240 (on the image's device)."""
    t, j = _pair(_pixels(len(name) + c, 14, 19, c))
    assert getattr(t4, name)(t, **kw) == getattr(j4, name)(j, **kw)


def test_hrz_at_its_native_size_gives_the_jax_bytes():
    t, j = _pair(_pixels(3, 240, 256, 3))
    assert t4.encode_hrz(t) == j4.encode_hrz(j)


@pytest.mark.parametrize("name,kw", [
    ("encode_inline", {}), ("encode_html", {}), ("encode_cur", {}),
    ("encode_magick", {}), ("encode_ept", {})])
@pytest.mark.parametrize("c", [3, 4])
def test_encoders_through_inner_blobs_give_the_jax_bytes(pil_codecs, name,
                                                         kw, c):
    """INLINE, HTML and CUR wrap a PNG, MAGICK a GIF (a PNG with alpha),
    EPT an EPS and a TIFF (PIL's EPS writer refuses RGBA: the same
    error)."""
    t, j = _pair(_pixels(40 + c, 12, 17, c, spill=False), **_spec(c, depth=8))
    try:
        want = getattr(j4, name)(j, **kw)
    except ValueError as e:
        with pytest.raises(type(e), match=str(e)):
            getattr(t4, name)(t, **kw)
        return
    assert getattr(t4, name)(t, **kw) == want


@pytest.mark.parametrize("name", ["encode_dcx", "encode_ashlar"])
def test_list_encoders_give_the_jax_bytes(pil_codecs, name):
    """DCX and ASHLAR over three images of different extents."""
    pairs = [_pair(_pixels(50 + k, 9 + 3 * k, 13 + k, 3, spill=False),
                   **_spec(3, depth=8)) for k in range(3)]
    assert getattr(t4, name)([t for t, _ in pairs]) == \
        getattr(j4, name)([j for _, j in pairs])


def _posterized(seed, h, w, levels=5):
    """RGB on the quarter grid, in smooth regions (under 64 distinct
    colours at these sizes): k-means' cluster sums and means are exact in
    float32 there, so both packages land on the same centres and break
    their ties (clusters seeded on one colour) alike."""
    arr = np.clip(_pixels(seed, h, w, 3), 0, 1)
    return (np.floor(arr * (levels - 1) + 0.5) / (levels - 1)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["encode_map", "encode_wpg"])
def test_palette_writers_give_the_jax_bytes(name):
    """A posterized image of under 64 colours: k-means (256 clusters, 20
    rounds) lands on the same centres, so the bytes are equal."""
    t, j = _pair(_posterized(60, 20, 31))
    assert getattr(t4, name)(t) == getattr(j4, name)(j)


def _map_parts(blob, h, w):
    pal = np.frombuffer(blob, np.uint8, 256 * 3).reshape(256, 3)
    return pal, np.frombuffer(blob, np.uint8, h * w, 768).reshape(h, w)


def test_palette_writers_on_a_noisy_image_hold_the_jax_palette():
    """On noise the palettes agree within KMEANS_PALETTE_CODES 8-bit codes
    and the labels on all but KMEANS_LABELS_APART of the pixels; the WPG
    file holds the MAP file's palette and labels."""
    h, w = 24, 32
    arr = np.random.default_rng(61).random((h, w, 3), dtype=np.float32)
    t, j = _pair(arr)
    tpal, tlab = _map_parts(t4.encode_map(t), h, w)
    jpal, jlab = _map_parts(j4.encode_map(j), h, w)
    same = tlab == jlab
    assert np.mean(~same) <= KMEANS_LABELS_APART
    used = np.unique(tlab[same])
    assert np.abs(tpal[used].astype(int) - jpal[used]).max() <= \
        KMEANS_PALETTE_CODES
    back = t4.decode_wpg(t4.encode_wpg(t), device="cpu")
    np.testing.assert_array_equal(
        np.rint(_arr(back) * 255).astype(np.uint8), tpal[tlab])


# -- the WPG writer's literal runs ------------------------------------------

@pytest.mark.parametrize("row", [
    bytes([0, 0, 1, 1] * 40), bytes([0, 0, 1, 1] * 31 + [2, 2, 2, 3]),
    bytes(range(200)), bytes([5] * 300), bytes([7, 7, 8] * 60)])
def test_wpg_rows_give_the_jax_bytes_or_read_back(row):
    """A row whose literals stop at 126 and then take a pair: the JAX
    writer emits a literal count of 128 (a run opcode to the reader), the
    port stops at 127; every other row gives the JAX bytes.  The port's
    rows read back through both readers."""
    got = t4._wpg_rle_row(row)
    want = j4._wpg_rle_row(row)
    jback = j4._wpg_unpack(want, 0, len(want), len(row), 1, 8)[0]
    if jback == row:
        assert got == want
    for unpack in (t4._wpg_unpack, j4._wpg_unpack):
        assert unpack(got, 0, len(got), len(row), 1, 8)[0] == row


def test_jax_wpg_writer_emits_a_literal_count_of_128():
    """The JAX fault the port does not copy (ROADMAP.md Queue 3): 126
    literals and a pair become a count byte 0x80, which the reader takes
    for a run of 0xFF bytes."""
    row = bytes([0, 0, 1, 1] * 40)
    blob = j4._wpg_rle_row(row)
    assert blob[0] == 0x80
    assert j4._wpg_unpack(blob, 0, len(blob), len(row), 1, 8)[0] != row
    assert t4._wpg_rle_row(row)[0] == 0x7F


# -- decoders of the encoders' bytes ----------------------------------------

@pytest.mark.parametrize("enc,dec,c,kw", [
    ("encode_aai", "decode_aai", 4, {}), ("encode_aai", "decode_aai", 3, {}),
    ("encode_hrz", "decode_hrz", 3, {}), ("encode_rgf", "decode_rgf", 3, {}),
    ("encode_pgx", "decode_pgx", 1, {"depth": 8}),
    ("encode_pgx", "decode_pgx", 1, {"depth": 16}),
    ("encode_vips", "decode_vips", 1, {"depth": 16}),
    ("encode_vips", "decode_vips", 2, {"depth": 8}),
    ("encode_vips", "decode_vips", 4, {"depth": 16}),
    ("encode_cals", "decode_cals", 1, {}), ("encode_art", "decode_art", 3, {}),
    ("encode_xwd", "decode_xwd", 3, {}), ("encode_tim", "decode_tim", 3, {}),
    ("encode_pdb", "decode_pdb", 3, {}), ("encode_ipl", "decode_ipl", 1,
                                          {"depth": 16}),
    ("encode_ipl", "decode_ipl", 3, {"depth": 8}),
    ("encode_ftxt", "decode_ftxt", 4, {}),
    ("encode_ftxt", "decode_ftxt", 1, {}),
    ("encode_tiff16", "decode_tiff16", 3, {}),
    ("encode_tiff16", "decode_tiff16", 1, {}),
    ("encode_wpg", "decode_wpg", 3, {})])
def test_decoders_of_encoded_bytes_match_jax(enc, dec, c, kw):
    _, j = _pair(_pixels(c + 30, 12, 17, c))
    _decode_both(dec, getattr(j4, enc)(j, **kw))


def _xwd_lsb16():
    val = (31 << 11) | (5 << 5) | 16
    head = struct.pack("<25I", 100, 7, 2, 16, 3, 2, 0, 0, 16, 0, 16, 16, 6,
                       4, 0xF800, 0x07E0, 0x001F, 5, 0, 0, 3, 2, 0, 0, 0)
    px = np.array([[val, 0, 0xFFFF], [0x07E0, 0x1234, val ^ 0xFFFF]], "<u2")
    return head + px.tobytes()


def _xwd_cmap8():
    head = struct.pack(">25I", 100, 7, 2, 8, 4, 2, 0, 1, 8, 1, 8, 8, 4, 3,
                       0, 0, 0, 8, 3, 3, 4, 2, 0, 0, 0)
    cmap = b"".join(struct.pack(">IHHHBB", i, 65535 * (i == 0),
                                30000 * i, 1000, 7, 0) for i in range(3))
    return head + cmap + bytes([0, 1, 2, 7, 2, 1, 0, 0])


def _xwd_bitmap():
    head = struct.pack(">25I", 100, 7, 0, 1, 10, 2, 0, 1, 8, 0, 8, 1, 2, 0,
                       0, 0, 0, 1, 0, 0, 10, 2, 0, 0, 0)
    return head + bytes([0xA5, 0x03, 0xFF, 0x00])


def _vips_msb(fmt=0, bands=3, vtype=22):
    dt = {0: ">u1", 2: ">u2", 3: ">i2", 6: ">f4"}[fmt]
    payload = (np.arange(12 * bands) * 7 % 200).astype(dt).reshape(
        3, 4, bands)
    head = struct.pack(">I7i", 0x08F2A6B6, 4, 3, bands, 0, fmt, 0, vtype)
    head = struct.pack("<I", 0xB6A6F208) + head[4:]
    return head + struct.pack(">2f", 0.0, 0.0) + b"\0" * 24 + \
        payload.tobytes()


def _tim(mode, clut=True, w16=2, h=3):
    """A TIM of pixel mode ``mode`` (0: 4 bpp, 1: 8 bpp, 2: 16 bpp, 3: 24
    bpp), with a CLUT for the indexed modes."""
    rng = np.random.default_rng(mode)
    flag = mode | (0x08 if clut and mode < 2 else 0)
    out = struct.pack("<II", 0x10, flag)
    if flag & 0x08:
        n = 256 if mode == 1 else 16
        words = rng.integers(0, 0x8000, n).astype("<u2")
        out += struct.pack("<IHHHH", 12 + 2 * n, 0, 0, n, 1) + \
            words.tobytes()
    body = rng.integers(0, 256, w16 * 2 * h).astype(np.uint8).tobytes()
    return out + struct.pack("<IHHHH", 12 + len(body), 0, 0, w16, h) + body


def _tim2(bpp_type, clut_type=0, clut_colors=0, w=3, h=2):
    rng = np.random.default_rng(bpp_type * 7 + clut_type)
    nbytes = {1: 2 * w * h, 2: 3 * w * h, 3: 4 * w * h, 4: (w * h + 1) // 2,
              5: w * h}[bpp_type]
    px = rng.integers(0, 256, nbytes).astype(np.uint8).tobytes()
    csize = {0: 0, 1: 2, 2: 3, 3: 4}[clut_type & 0x0F] * clut_colors
    clut = rng.integers(0, 256, csize).astype(np.uint8).tobytes()
    ihdr = struct.pack("<3IHH", 48 + nbytes + csize, csize, nbytes, 48,
                       clut_colors)
    ihdr += bytes([0, 1, clut_type, bpp_type]) + struct.pack("<HH", w, h)
    ihdr += b"\0" * 24
    return b"TIM2" + bytes([4, 0]) + struct.pack("<H", 1) + b"\0" * 8 + \
        ihdr + px + clut


def _wpg(bm, pal=None):
    head = struct.pack("<II", 0x435057FF, 16) + bytes([1, 0x16]) + \
        b"\0" * 6
    if pal is not None:
        head += bytes([0x0E, 4 + len(pal)]) + struct.pack(
            "<HH", 0, len(pal) // 3) + pal
    return head + bm


def _wpg_8bpp():
    raster = bytes([0x03, 0, 1, 2, 0x00, 0x01])
    bm = bytes([0x0B, 10 + len(raster)]) + struct.pack(
        "<5H", 3, 2, 8, 0, 0) + raster
    return _wpg(bm, bytes([255, 0, 0, 0, 255, 0, 0, 0, 255]))


def _wpg_1bpp():
    raster = bytes([0x80, 0x01, 0x81, 0x00, 0x82, 0x5A, 0x00, 0x02])
    bm = bytes([0x0B, 10 + len(raster)]) + struct.pack(
        "<5H", 16, 5, 1, 0, 0) + raster
    return _wpg(bm)


def _wpg_type2_4bpp():
    raster = bytes([0x02, 0x12, 0x34, 0x84, 0x77])
    body = b"\0" * 10 + struct.pack("<5H", 4, 3, 4, 0, 0) + raster
    return _wpg(bytes([0x14, len(body)]) + body)


def _rle(background=True, planes=3, cmaps=0):
    flags = 0x00 if background else 0x02
    head = b"\x52\xcc" + struct.pack("<4H", 0, 0, 3, 2)
    head += bytes([flags, planes, 8, cmaps, 2 if cmaps else 0])
    head += bytes(planes if background else 1)
    if planes % 2 == 0:
        head += b"\0"
    if cmaps:
        head += (np.arange(cmaps * 4, dtype="<u2") * 3000).astype(
            "<u2").tobytes()
    body = bytes([0x02, 0, 0x06, 2, 200, 0, 0x01, 1, 0x02, 1 % planes,
                  0x05, 1, 11, 22, 0x03, 1, 0x45, 0, 0, 9, 0x07, 0])
    return head + body


def _pdb_rle_of(body):
    out = bytearray()
    i = 0
    while i < len(body):
        j = i
        while j < len(body) and body[j] == body[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i - 1, body[i]])
            i = j
        else:
            n = min(3, len(body) - i)
            out += bytes([n - 1]) + body[i:i + n]
            i += n
    return bytes(out)


def _pdb_with_rle():
    _, j = _pair(np.clip(_pixels(70, 9, 22, 1), 0, 1))
    blob = bytearray(j4.encode_pdb(j))
    off = struct.unpack(">i", blob[78:82])[0]
    blob[off + 32] = 1
    return bytes(blob[:off + 58]) + _pdb_rle_of(bytes(blob[off + 58:]))


def _scr():
    rng = np.random.default_rng(9)
    return rng.integers(0, 256, 6912).astype(np.uint8).tobytes()


def _sct(seps=3, mask=0x07):
    rng = np.random.default_rng(seps)
    px = rng.integers(0, 256, (5, 7, seps), np.uint8)
    header = bytearray(2048)
    header[0:8] = b"scan.sct"
    header[80:82] = b"CT"
    header[1025] = seps
    header[1026:1028] = mask.to_bytes(2, "big")
    header[1056:1068] = b"5           "
    header[1068:1080] = b"7           "
    body = bytearray()
    for y in range(5):
        for s in range(seps):
            body += bytes(px[y, :, s]) + b"\0"
    return bytes(header) + bytes(body)


def _cut(onebit=False):
    if onebit:
        rows = [bytes([0x82, 0xF0, 0]), bytes([0x02, 0x0F, 0xAA, 0])]
        return struct.pack("<HHH", 12, 2, 0) + b"".join(
            struct.pack("<H", len(r)) + r for r in rows)
    rows = [bytes([0x83, 100, 0]), bytes([0x03, 10, 20, 30, 0])]
    return struct.pack("<HHH", 3, 2, 0) + b"".join(
        struct.pack("<H", len(r)) + r for r in rows)


def _mac():
    payload = bytearray()
    total = 72 * 720
    k = 0
    while total > 0:
        if k % 3 == 2:
            lit = bytes([(k * 37) % 256, (k * 11) % 256])
            payload += bytes([len(lit) - 1]) + lit
            total -= len(lit)
        else:
            n = min(2 + k % 100, total)
            if n < 2:
                payload += bytes([0x00, 0x0F])
                total -= 1
                continue
            payload += bytes([(~(n - 2)) & 0xFF, 0x0F * (k % 2)])
            total -= n
        k += 1
    return struct.pack("<H", 0) + b"\0" * 510 + bytes(payload)


def _pix(bpp=24):
    if bpp == 8:
        return struct.pack(">5H", 3, 2, 0, 0, 8) + bytes([4, 9, 2, 200])
    return struct.pack(">5H", 3, 2, 0, 0, 24) + bytes(
        [2, 10, 20, 30, 3, 40, 50, 60, 1, 70, 80, 90])


def _jpeg(arr, quality=90):
    from PIL import Image as PImage

    buf = _io.BytesIO()
    PImage.fromarray((np.clip(arr, 0, 1) * 255 + 0.5).astype(
        np.uint8)).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _jnx():
    tile = _jpeg(_pixels(80, 13, 17, 3))[2:]
    head = struct.pack("<12i", 3, 0, 100, 100, -100, -100, 1, 0, 0, 0, 0, 0)
    level_off = len(head) + 12
    level = struct.pack("<iii", 1, level_off, 0)
    tile_off = level_off + 28
    entry = struct.pack("<4iHHIi", 50, 60, -50, -60, 17, 13, len(tile),
                        tile_off)
    return head + level + entry + tile


def _sfw(seed=81):
    jpeg = bytearray(_jpeg(_pixels(seed, 13, 17, 3), 95))
    inv = {v: k for k, v in j4._SFW_XLAT.items()}
    out = bytearray()
    i = 0
    while i < len(jpeg):
        if jpeg[i] == 0xFF and i + 1 < len(jpeg):
            m = jpeg[i + 1]
            seglen = (jpeg[i + 2] << 8) | jpeg[i + 3] if i + 3 < len(jpeg) \
                else 0
            if m == 0xC4:
                i += 2 + seglen
                continue
            if m == 0xE0:
                seg = bytearray(jpeg[i:i + 2 + seglen])
                seg[1] = 0xD0
                seg[4:11] = b"\0" * 7
                out += seg
                i += 2 + seglen
                continue
            if m in inv:
                out += bytes([0xFF, inv[m]])
                i += 2
                continue
        out.append(jpeg[i])
        i += 1
    if out[-2:] == b"\xff\xd9":
        out[-2:] = b"\xff\xc9"
    return b"SFW94A" + bytes(out)


def _pes():
    head = b"#PES" + b"0001" + struct.pack("<i", 0)
    body = bytearray(b"\0" * 36) + bytes([1, 5, 20])
    body += b"\0" * (532 - 2 - 21)
    st = bytearray([0, 0, 20, 0, 0, 20, 0x40 | (0x7F & -20), 0])
    st += bytes([254, 176, 0])
    st += bytes([0x80 | 0x0, 30, 10])           # a 12-bit jump
    st += bytes([5, 5, 0, 0x40 | (0x7F & -9)])
    st += b"\xff\x00"
    return head + bytes(body) + bytes(st)


def _cube(level, title=True):
    rng = np.random.default_rng(level)
    lines = ["# a grade", "LUT_3D_SIZE %d" % level]
    if title:
        lines.append('TITLE "warm look"')
    lines.append("DOMAIN_MIN 0 0 0")
    g = np.linspace(0, 1, level)
    for b in g:
        for gg in g:
            for r in g:
                v = np.clip([r ** 0.9 + 0.02 * rng.standard_normal(),
                             gg, b * 0.95], 0, 1)
                lines.append("%.6f %.6f %.6f" % tuple(v))
    return "\n".join(lines).encode()


def _txt():
    _, j = _pair(np.clip(_pixels(90, 7, 9, 3), 0, 1), **_spec(3, depth=8))
    return jio.image_to_blob(j, "txt")


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


def _ept_tiff_only():
    from PIL import Image as PImage

    buf = _io.BytesIO()
    PImage.fromarray((np.clip(_pixels(95, 9, 11, 3), 0, 1) * 255).astype(
        np.uint8)).save(buf, "TIFF")
    tiff = buf.getvalue()
    head = struct.pack("<7I", 0xC6D3D0C5, 0, 0, 0, 0, 30, len(tiff))
    return head + b"\xff\xff" + tiff


MVG = (b"viewbox 0 0 40 30\nfill 'red'\nrectangle 5,5 20,20\n"
       b"fill 'navy'\ncircle 30,15 30,22\nstroke 'gold'\n"
       b"stroke-width 2\nline 0,29 39,0\n")

DECODE_CASES = {
    "xwd-lsb16": ("decode_xwd", _xwd_lsb16),
    "xwd-cmap8": ("decode_xwd", _xwd_cmap8),
    "xwd-bitmap": ("decode_xwd", _xwd_bitmap),
    "vips-msb-u8": ("decode_vips", _vips_msb),
    "vips-msb-u16-gray": ("decode_vips", lambda: _vips_msb(2, 1, 1)),
    "vips-msb-i16-cmyk": ("decode_vips", lambda: _vips_msb(3, 4, 15)),
    "vips-msb-f32": ("decode_vips", lambda: _vips_msb(6, 3, 22)),
    "pgx-lm-16": ("decode_pgx", lambda: b"PG LM - 16 8 4\n" + (np.arange(
        32, dtype="<u2") * 2000).tobytes()),
    "pgx-ml-12": ("decode_pgx", lambda: b"PG ML + 12 3 2\n" + (np.arange(
        6, dtype=">u2") * 700).tobytes()),
    "tim-4bpp": ("decode_tim", lambda: _tim(0)),
    "tim-4bpp-gray": ("decode_tim", lambda: _tim(0, clut=False)),
    "tim-8bpp": ("decode_tim", lambda: _tim(1)),
    "tim-16bpp": ("decode_tim", lambda: _tim(2)),
    "tim-24bpp": ("decode_tim", lambda: _tim(3, w16=3)),
    "tim-two": ("decode_tim", lambda: _tim(1) + _tim(2)),
    "tim2-16bpp": ("decode_tim2", lambda: _tim2(1)),
    "tim2-24bpp": ("decode_tim2", lambda: _tim2(2)),
    "tim2-32bpp": ("decode_tim2", lambda: _tim2(3)),
    "tim2-8bpp-clut32": ("decode_tim2", lambda: _tim2(5, 0x13, 256)),
    "tim2-8bpp-clut16-csm1": ("decode_tim2", lambda: _tim2(5, 0x01, 64)),
    "tim2-4bpp-clut24": ("decode_tim2", lambda: _tim2(4, 0x12, 16)),
    "wpg-8bpp": ("decode_wpg", _wpg_8bpp),
    "wpg-1bpp-runs": ("decode_wpg", _wpg_1bpp),
    "wpg-type2-4bpp": ("decode_wpg", _wpg_type2_4bpp),
    "rle-background": ("decode_rle", _rle),
    "rle-no-background": ("decode_rle", lambda: _rle(False)),
    "rle-gray-cmap": ("decode_rle", lambda: _rle(True, 1, 1)),
    "rle-palette": ("decode_rle", lambda: _rle(False, 1, 3)),
    "rle-rgb-cmaps": ("decode_rle", lambda: _rle(True, 3, 3)),
    "pdb-rle": ("decode_pdb", _pdb_with_rle),
    "scr": ("decode_scr", _scr),
    "sct-rgb": ("decode_sct", _sct),
    "sct-cmyk": ("decode_sct", lambda: _sct(4, 0x0F)),
    "sct-gray": ("decode_sct", lambda: _sct(1, 0x08)),
    "cut-8bit": ("decode_cut", _cut),
    "cut-1bit": ("decode_cut", lambda: _cut(True)),
    "mac": ("decode_mac", _mac),
    "pix-24": ("decode_pix", _pix),
    "pix-8": ("decode_pix", lambda: _pix(8)),
    "pes": ("decode_pes", _pes),
    "cube-2": ("decode_cube", lambda: _cube(2)),
    "cube-17": ("decode_cube", lambda: _cube(17, False)),
    "txt": ("decode_txt", _txt),
    "txt-cmyka-percent": ("decode_txt", lambda: (
        b"# ImageMagick pixel enumeration: 2,1,65535,cmyka\n"
        b"0,0: (10%,20%,0,65535,50%)\n1,0: (1,2,3,4,5)\n")),
    "mvg": ("decode_mvg", lambda: MVG),
    "deep-tiff": ("decode_tiff16", lambda: _tiff_rgb16(
        np.random.default_rng(0).integers(0, 65536, (4, 5, 3)))),
    "ept-tiff": ("decode_ept", _ept_tiff_only),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_hand_built_files_decode_as_jax(pil_codecs, case):
    name, build = DECODE_CASES[case]
    assert _decode_both(name, build()) is not None


@pytest.mark.parametrize("case", ["sfw", "pwp", "jnx", "inline", "magick",
                                  "ttf"])
def test_files_around_other_codecs_decode_as_jax(pil_codecs, case):
    """SFW, PWP and JNX hold JPEGs (PIL decodes them on both sides),
    INLINE a PNG, MAGICK a GIF; TTF renders its sample sheet with PIL."""
    if case == "sfw":
        blob = _sfw()
    elif case == "pwp":
        blob = b"SFW95" + b"\0" * 8 + _sfw(82) + _sfw(83)
    elif case == "jnx":
        blob = _jnx()
    elif case == "inline":
        _, j = _pair(np.clip(_pixels(84, 8, 11, 4), 0, 1),
                     **_spec(4, depth=8))
        blob = j4.encode_inline(j)
    elif case == "magick":
        _, j = _pair(np.clip(_pixels(85, 8, 11, 3), 0, 1),
                     **_spec(3, depth=8))
        blob = j4.encode_magick(j)
    else:
        with open(FONT, "rb") as f:
            blob = f.read()
    got = _decode_both("decode_" + case, blob)
    assert got is not None


def test_stegano_extraction_matches_jax():
    t, j = _pair(_pixels(86, 10, 12, 3))
    _same(t4.decode_stegano(t, 5, 4, device="cpu"),
          j4.decode_stegano(j, 5, 4))
    _same(t4.decode_stegano(t, 16, 14, device="cpu"),
          j4.decode_stegano(j, 16, 14))


# -- truncated and malformed files ------------------------------------------

def _malformed():
    _, j = _pair(_pixels(87, 6, 8, 3))
    vips = j4.encode_vips(j)
    return {
        "decode_aai": [b"\1\0\0\0", struct.pack("<II", 4, 4) + b"\0" * 10],
        "decode_hrz": [b"\0" * 100],
        "decode_scr": [b"\0" * 6000],
        "decode_rgf": [b"\x08", b"\x00\x03", b"\x10\x04\0"],
        "decode_txt": [b"nothing", b"# ImageMagick pixel enumeration: 2,2,"
                       b"255,srgb\n0,0: (1,x,3)\n"],
        "decode_pgx": [b"PX ML", b"PG ML + 8 40 40\n" + b"\0" * 9],
        "decode_vips": [vips[:40], b"\0" * 80, vips[:4] + bytes(60),
                        vips[:24] + struct.pack("<i", 7) + vips[28:]],
        "decode_cals": [b"srcdocid: x", b"srcdocid:".ljust(2048, b" ")],
        "decode_art": [b"\0\0", struct.pack("<4H", 0, 9, 0, 9) + b"\0"],
        "decode_sct": [b"\0" * 100, bytearray(2048)],
        "decode_xwd": [b"\0" * 50, _xwd_lsb16()[:104],
                       struct.pack(">25I", 100, 6, *([0] * 23))],
        "decode_tim": [b"\x11\0\0\0" + b"\0" * 8,
                       struct.pack("<II", 0x10, 0x04) + b"\0" * 12],
        "decode_sfw": [b"SFW94A\0\0", b"NOPE"],
        "decode_cut": [b"\0\0", struct.pack("<HHH", 2, 2, 0)],
        "decode_rle": [b"\x52\xcc" + b"\0" * 13, b"XX"],
        "decode_mac": [b"\x01"],
        "decode_pix": [b"\0" * 5, struct.pack(">5H", 1, 1, 0, 0, 16)],
        "decode_tim2": [b"TIM2\x03\0", b"TIM2\x04\0\1\0" + b"\0" * 8,
                        _tim2(1)[:70]],
        "decode_jnx": [b"\0" * 20, struct.pack("<i", 5) + b"\0" * 60,
                       struct.pack("<7i", 3, 0, 0, 0, 0, 0, 0) + b"\0" * 40],
        "decode_pes": [b"#PEC", b"#PES0001" + struct.pack("<i", 900)],
        "decode_tiff16": [b"II*\0\x08\0\0\0\x00\x00",
                          _tiff_rgb16(np.zeros((3, 3, 3)))[:150]],
        "decode_ipl": [b"nope", b"iiii" + b"\0" * 8 + b"nope",
                       b"iiii" + b"\0" * 8 + b"data" + b"\0" * 28],
        "decode_ept": [b"\xc5\xd0\xd3\xc6" + b"\0" * 10,
                       struct.pack("<7I", 0xC6D3D0C5, 0, 0, 0, 0, 0, 0)
                       + b"\0\0"],
        "decode_wpg": [b"\xffWPC" + b"\0" * 4, _wpg(b"\x10\x00"),
                       struct.pack("<II", 0x435057FF, 16) + b"\1\x2c" +
                       b"\0" * 6],
        "decode_pdb": [b"\0" * 90, _pdb_with_rle()[:100]],
        "decode_magick": [b"static const unsigned char x[] = { 0x01 };"],
        "decode_ftxt": [b"hello\n"],
        "decode_cube": [b"LUT_3D_SIZE 1\n0 0 0\n", b"TITLE x\n"],
        "decode_inline": [b"data:image/png,abc"],
        "decode_pwp": [b"SFW95" + b"SFW94A" + b"\0" * 10],
    }


def _malformed_cases():
    return [pytest.param(name, k, id=f"{name}-{k}")
            for name, blobs in sorted(_malformed().items())
            for k in range(len(blobs))]


@pytest.mark.parametrize("name,k", _malformed_cases())
def test_truncated_and_malformed_files_raise_as_jax(name, k):
    blob = bytes(_malformed()[name][k])
    with pytest.raises(Exception) as want:
        getattr(j4, name)(blob)
    with pytest.raises(want.type):
        getattr(t4, name)(blob, device="cpu")


# -- -size reads and stegano: -----------------------------------------------

@pytest.mark.parametrize("fmt,size,nbytes", [
    ("uyvy", "6x4", 6 * 4 * 2), ("yuv", "7x5", 7 * 5 + 2 * 4 * 3),
    ("bayer", "6x5", 6 * 5), ("bayer", "6x5", 6 * 5 * 2),
    ("map", "5x4", 768 + 20), ("map", "5x4", 3 * 7 + 20)])
def test_size_reads_match_jax(tmp_path, fmt, size, nbytes):
    """UYVY and YUV 4:2:0 give YCbCr pixels, Bayer demosaics 8 and 16-bit
    mosaics, MAP takes its palette from what precedes the indices."""
    blob = np.random.default_rng(nbytes).integers(
        0, 256, nbytes).astype(np.uint8).tobytes()
    path = str(tmp_path / f"in.{fmt}")
    with open(path, "wb") as f:
        f.write(blob)
    _same(tio.read_images(path, size, device="cpu"),
          jio.read_images(path, size))
    _same(tio.read_images(f"{fmt}:{path}", size, device="cpu"),
          jio.read_images(f"{fmt}:{path}", size))


@pytest.mark.parametrize("size", ["8x6", "30x25"])
def test_stegano_reads_match_jax(pil_codecs, tmp_path, size):
    """A watermark hidden by the JAX stegano in a PNG; -size smaller and
    larger than the host."""
    rng = np.random.default_rng(2)
    host = rng.random((20, 24, 3)).astype(np.float32)
    wm = (rng.random((6, 8, 1)) > 0.5).astype(np.float32)
    stamped = np.asarray(jvfx.stegano(host, wm))
    path = str(tmp_path / "host.png")
    jio.write_image(JImage(stamped, JSpec(colorspace="srgb")), path)
    got = tio.read_images("stegano:" + path, size, device="cpu")
    _same(got, jio.read_images("stegano:" + path, size))
    if size == "8x6":
        np.testing.assert_array_equal(_arr(got[0])[..., 0], wm[..., 0])
    with pytest.raises(ValueError, match="-size"):
        tio.read_images("stegano:" + path, device="cpu")


# -- dispatch: detect_format, image_from_blob, image_to_blob ----------------

def _sniffed():
    _, j = _pair(_pixels(88, 6, 8, 3))
    return {
        "vips": j4.encode_vips(j), "pgx": j4.encode_pgx(j),
        "txt": _txt(), "cals": j4.encode_cals(j), "rle": _rle(),
        "ept": _ept_tiff_only(), "wpg": _wpg_8bpp(),
        "ipl": j4.encode_ipl(j), "tim2": _tim2(1), "pes": _pes(),
        "sfw": _sfw(), "pwp": b"SFW95" + b"\0" * 8 + _sfw(),
        "pdb": j4.encode_pdb(j), "sct": _sct(), "xwd": j4.encode_xwd(j),
        "inline": b"data:image/png;base64,AAAA", "tiff": _tiff_rgb16(
            np.random.default_rng(1).integers(0, 65536, (3, 4, 3))),
    }


@pytest.mark.parametrize("fmt", sorted(_sniffed()))
def test_detect_format_of_each_magic_matches_jax(fmt):
    blob = _sniffed()[fmt]
    assert tio.detect_format(blob) == jio.detect_format(blob) == fmt


def _by_name():
    _, j = _pair(_pixels(89, 7, 10, 3))
    _, g = _pair(np.clip(_pixels(89, 7, 10, 1), 0, 1))
    return {
        "aai": j4.encode_aai(j), "hrz": j4.encode_hrz(j),
        "scr": _scr(), "rgf": j4.encode_rgf(j), "txt": _txt(),
        "text": _txt(), "pgx": j4.encode_pgx(g), "vips": j4.encode_vips(j),
        "v": j4.encode_vips(j), "cals": j4.encode_cals(j),
        "cal": j4.encode_cals(j), "art": j4.encode_art(j), "sct": _sct(),
        "xwd": j4.encode_xwd(j), "sfw": _sfw(), "pdb": j4.encode_pdb(j),
        "tim": j4.encode_tim(j), "cube": _cube(3), "cut": _cut(),
        "rle": _rle(), "mac": _mac(), "pix": _pix(), "mvg": MVG,
        "ept": _ept_tiff_only(), "ept2": _ept_tiff_only(),
        "ept3": _ept_tiff_only(), "wpg": _wpg_1bpp(),
        "ipl": j4.encode_ipl(j), "ftxt": j4.encode_ftxt(j),
        "magick": j4.encode_magick(j), "h": j4.encode_magick(j),
        "tim2": _tim2(1), "jnx": _jnx(), "pes": _pes(),
        "tiff": _tiff_rgb16(np.random.default_rng(2).integers(
            0, 65536, (3, 4, 3))),
        "tif": j4.encode_tiff16(g), "inline": j4.encode_inline(j),
    }


@pytest.mark.parametrize("fmt", sorted(_by_name()))
def test_image_from_blob_by_each_name_matches_jax(pil_codecs, fmt):
    blob = _by_name()[fmt]
    _same(tio.image_from_blob(blob, fmt, device="cpu"),
          jio.image_from_blob(blob, fmt))


WRITE_NAMES = ["aai", "hrz", "rgf", "cip", "pgx", "vips", "v", "inline",
               "cals", "cal", "art", "xwd", "braille", "brf", "ubrl",
               "ubrl6", "isobrl", "isobrl6", "uil", "html", "htm", "shtml",
               "pdb", "tim", "yuv", "bayer", "ps", "ps2", "ps3", "ept",
               "ept2", "ept3", "ipl", "map", "ftxt", "ashlar", "magick",
               "h", "dcx", "cur", "wpg", "tiff", "tif"]


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("fmt", WRITE_NAMES)
def test_image_to_blob_by_each_name_matches_jax(pil_codecs, fmt, depth):
    """Two posterized images (ASHLAR and DCX take both, the rest the
    first; a TIFF at depth 16 is the native deep writer's)."""
    pairs = [_pair(_posterized(90 + k, 9, 12), **_spec(3, depth=depth))
             for k in range(2)]
    got = tio.image_to_blob([t for t, _ in pairs], fmt)
    want = jio.image_to_blob([j for _, j in pairs], fmt)
    if fmt.startswith("ps") or fmt.startswith("ept"):
        # the EPS writer's %%CreationDate line holds the clock
        got, want = (b"\n".join(ln for ln in x.split(b"\n")
                                if b"CreationDate" not in ln)
                     for x in (got, want))
    assert got == want


def test_formats_lists_name_the_formats4_coders():
    reads, writes = tio.supported_read_formats(), tio.supported_write_formats()
    for fmt in ("aai", "vips", "cals", "xwd", "uyvy", "yuv", "bayer", "map",
                "cube", "stegano", "txt", "mvg", "wpg", "tim2", "pes"):
        assert fmt in reads
    for fmt in ("aai", "vips", "cals", "xwd", "map", "wpg", "braille", "ps",
                "ps3", "ept", "dcx", "cur", "ashlar", "shtml", "h"):
        assert fmt in writes
    for fmt in ("wmf", "emf", "hdr", "strimg", "exif"):
        assert fmt in reads
    for fmt in ("hdr", "strimg", "matte", "debug", "exif"):
        assert fmt in writes
    assert ("jbig" in reads) == ("jbig" in writes) == tnat.jbig_available()


# -- deep TIFF --------------------------------------------------------------

def _deep_tiff_compressed():
    """A 48-bit RGB TIFF that the deep reader declines: two strips with a
    gap between them (the native reader asks that they follow one
    another)."""
    blob = bytearray(_tiff_rgb16(np.random.default_rng(3).integers(
        0, 65536, (2, 3, 3))))
    # turn the one strip into two: StripOffsets and StripByteCounts of
    # count 2 stored after the pixels, the second strip 2 bytes late
    n = struct.unpack_from("<H", blob, 8)[0]
    data_off = len(blob) - 36
    tail = len(blob) + 2
    blob += b"\0\0" + blob[data_off + 18:] + b"\0\0"
    extra = len(blob)
    blob += struct.pack("<2I", data_off, tail) + struct.pack("<2I", 18, 18)
    for i in range(n):
        pos = 10 + 12 * i
        tag = struct.unpack_from("<H", blob, pos)[0]
        if tag == 273:
            struct.pack_into("<HHII", blob, pos, 273, 4, 2, extra)
        elif tag == 279:
            struct.pack_into("<HHII", blob, pos, 279, 4, 2, extra + 8)
        elif tag == 278:
            struct.pack_into("<HHHH", blob, pos, 278, 3, 1, 0)
            struct.pack_into("<I", blob, pos + 4, 1)
            struct.pack_into("<HH", blob, pos + 8, 1, 0)
    return bytes(blob)


def test_jax_narrows_a_deep_tiff_that_its_deep_reader_declines():
    """The JAX fault the port does not copy (ROADMAP.md Queue 3): a
    48-bit RGB TIFF in strips with a gap goes to Pillow, which narrows
    its samples to 8 bits; the port raises a ValueError that says why."""
    blob = _deep_tiff_compressed()
    with pytest.raises(ValueError):
        j4.decode_tiff16(blob)
    want = jio.image_from_blob(blob)[0]
    assert want.spec.depth == 8
    with pytest.raises(ValueError, match="narrow these to 8 bits"):
        tio.image_from_blob(blob, device="cpu")


def test_deep_tiff_writes_and_reads_as_jax(pil_codecs, tmp_path):
    """A 48-bit TIFF written at -depth 16 by each CLI and read back."""
    t, j = _pair(np.clip(_pixels(91, 9, 13, 3), 0, 1), **_spec(3, depth=16))
    tblob = tio.image_to_blob(t, "tiff", depth=16)
    assert tblob == jio.image_to_blob(j, "tiff", depth=16)
    _same(tio.image_from_blob(tblob, device="cpu"),
          jio.image_from_blob(tblob))
    src = str(tmp_path / "in.tif")
    with open(src, "wb") as f:
        f.write(tblob)
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        assert main([src, "-flip", "-depth", "16",
                     str(tmp_path / f"{side}.tif")]) == 0
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()


# -- the CLI ----------------------------------------------------------------

def _png(path, arr):
    from PIL import Image as PImage

    PImage.fromarray((np.clip(arr, 0, 1) * 255 + 0.5).astype(
        np.uint8).squeeze()).save(path)


@pytest.mark.parametrize("prefix", ["aai", "vips", "cals", "xwd", "map",
                                    "wpg", "braille", "pgx", "yuv", "tim"])
def test_cli_writes_each_prefix_as_jax(pil_codecs, tmp_path, prefix):
    src = str(tmp_path / "in.png")
    _png(src, _posterized(92, 10, 14))
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.out"
        assert main([src, "-flip", f"{prefix}:{out}"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("argv", [
    ["-size", "6x4", "uyvy:{d}/in.uyvy"], ["-size", "6x4", "yuv:{d}/in.yuv"],
    ["-size", "6x4", "bayer:{d}/in.bayer"],
    ["-size", "6x4", "map:{d}/in.map"],
    ["-size", "4x3", "stegano:{d}/in.png"], ["cube:{d}/in.cube"],
    ["inline:{d}/in.inline"], ["txt:{d}/in.txt"], ["mvg:{d}/in.mvg"]])
def test_cli_reads_each_as_jax(pil_codecs, tmp_path, argv):
    d = str(tmp_path)
    rng = np.random.default_rng(93)
    for name, blob in (("in.uyvy", 48), ("in.yuv", 36), ("in.bayer", 24),
                       ("in.map", 768 + 24)):
        (tmp_path / name).write_bytes(
            rng.integers(0, 256, blob).astype(np.uint8).tobytes())
    _png(str(tmp_path / "in.png"), _pixels(94, 8, 9, 3, spill=False))
    (tmp_path / "in.cube").write_bytes(_cube(2))
    _, j = _pair(np.clip(_pixels(95, 5, 6, 3), 0, 1), **_spec(3, depth=8))
    (tmp_path / "in.inline").write_bytes(j4.encode_inline(j))
    (tmp_path / "in.txt").write_bytes(_txt())
    (tmp_path / "in.mvg").write_bytes(MVG)
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.ppm"
        assert main([a.format(d=d) for a in argv] + ["-negate",
                                                     str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_cli_hald_clut_with_a_cube_grades_as_jax(pil_codecs, tmp_path):
    """-hald-clut with a .cube LUT as its second image: decode_cube's
    level-8 Hald image, applied by enhance.hald_clut."""
    src = str(tmp_path / "in.tif")
    t, _ = _pair(np.clip(_pixels(96, 10, 14, 3), 0, 1), **_spec(3, depth=16))
    with open(src, "wb") as f:
        f.write(tio.image_to_blob(t, "tiff", depth=16))
    (tmp_path / "look.cube").write_bytes(_cube(5))
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.tif"
        assert main([src, str(tmp_path / "look.cube"), "-hald-clut",
                     "-depth", "16", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


# -- the device-side coders and what a request may not reach ----------------

def test_device_side_writers_run_on_the_images_device(monkeypatch):
    """HRZ's resize, YUV's colour conversion and MAP's k-means take the
    image's tensor on its device (here the CPU; the card case is in
    test_torch_gpu.py)."""
    from imagemagick_tpu_torch.ops import colorspace, quantize, resize

    seen = []
    for mod, name in ((resize, "resize"), (colorspace, "rgb_to_ycbcr"),
                      (quantize, "kmeans")):
        real = getattr(mod, name)

        def spy(x, *a, _real=real, **kw):
            seen.append(x.device.type)
            return _real(x, *a, **kw)

        monkeypatch.setattr(mod, name, spy)
    t, _ = _pair(_pixels(97, 6, 8, 3))
    t4.encode_hrz(t), t4.encode_yuv(t), t4.encode_map(t)
    assert seen == ["cpu"] * 3
    img = t4.decode_mvg(MVG, device="cpu")
    assert img.data.device.type == "cpu"


@pytest.mark.parametrize("body", [
    MVG + b"image over 0,0 10,10 '/etc/hostname'\n",
    MVG + b"font '/etc/hostname'\ntext 2,10 'a'\n"])
def test_mvg_naming_a_host_file_is_refused_without_host_files(body):
    with no_host_files():
        with pytest.raises(PolicyError, match="no file of the host"):
            tio.image_from_blob(body, "mvg", device="cpu")
    if b"image" in body:   # draw has no image primitive: it is skipped
        _same(tio.image_from_blob(body, "mvg", device="cpu"),
              jio.image_from_blob(body, "mvg"))


def test_ept_reads_its_tiff_when_ghostscript_is_refused(pil_codecs,
                                                       monkeypatch):
    """Inside no_host_files the ghostscript delegate is refused, and the
    EPT's TIFF section is read, as the JAX decode_ept falls back to it
    when its delegate fails."""
    def no_gs(*a, **kw):
        raise RuntimeError("ghostscript failed")

    monkeypatch.setattr(importlib.import_module(
        "imagemagick_tpu.io.delegates"), "decode_postscript", no_gs)
    _, j = _pair(np.clip(_pixels(98, 8, 10, 3), 0, 1), **_spec(3, depth=8))
    blob = j4.encode_ept(j)
    with no_host_files():
        got = tio.image_from_blob(blob, device="cpu")
    _same(got, jio.image_from_blob(blob))


def test_jax_reads_planar_deep_tiff_samples_as_chunky():
    """The JAX fault the port does not copy (ROADMAP.md Queue 3): the deep
    reader ignores PlanarConfiguration 2, so a planar 48-bit TIFF's
    planes come back as interleaved pixels; the port's reader declines
    it, and io raises a ValueError rather than narrowing it."""
    rng = np.random.default_rng(4)
    planes = rng.integers(0, 65536, (3, 2, 5))
    blob = bytearray(_tiff_rgb16(planes.transpose(1, 2, 0)))
    n = struct.unpack_from("<H", blob, 8)[0]
    for i in range(n):
        if struct.unpack_from("<H", blob, 10 + 12 * i)[0] == 284:
            struct.pack_into("<HH", blob, 10 + 12 * i + 8, 2, 0)
    # the pixel bytes as planes: R then G then B
    start = len(blob) - planes.size * 2
    blob[start:] = planes.astype("<u2").tobytes()
    got = np.rint(np.asarray(j4.decode_tiff16(bytes(blob)).data) * 65535)
    assert not np.array_equal(got, planes.transpose(1, 2, 0))
    with pytest.raises(ValueError, match="planar"):
        t4.decode_tiff16(bytes(blob), device="cpu")
    with pytest.raises(ValueError, match="narrow these to 8 bits"):
        tio.image_from_blob(bytes(blob), device="cpu")
