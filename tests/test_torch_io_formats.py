"""Port parity: io/formats2.py, io/formats3.py, utils/fax.py and
utils/compress.py (DPX, CIN, DICOM, XCF, PSD, PDF, FITS, WBMP, AVS, MTV,
FL32, VICAR, SUN, OTB, MONO, G3, G4, MAT, VIFF, RLA, Palm and PICT)
against the JAX package, through the modules, io/'s dispatch and the CLI.

Inputs are made from a numpy seed at tens of pixels a side (one fax page
is 1728 wide, one 3000).  Tolerances: none.  Every encoder gives the JAX
encoder's bytes from equal pixels; every decoder gives the JAX decoder's
float32 pixels, spec, properties and page, bit for bit, from equal bytes
(hand-built files are made as the JAX tests make them in test_coders2.py
and test_coders3.py); the fax and byte codecs give the JAX codecs' bytes and
arrays, and on garbage streams the same error."""

import importlib
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.io import formats2 as t2
from imagemagick_tpu_torch.io import formats3 as t3
from imagemagick_tpu_torch.utils import compress as tcomp
from imagemagick_tpu_torch.utils import fax as tfax

jio = importlib.import_module("imagemagick_tpu.io")
j2 = importlib.import_module("imagemagick_tpu.io.formats2")
j3 = importlib.import_module("imagemagick_tpu.io.formats3")
jcomp = importlib.import_module("imagemagick_tpu.utils.compress")
jfax = importlib.import_module("imagemagick_tpu.utils.fax")
jm = importlib.import_module("imagemagick_tpu.cli.main")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
JSpec = importlib.import_module("imagemagick_tpu.core.spec").ImageSpec
TSpec = importlib.import_module("imagemagick_tpu_torch.core.spec").ImageSpec


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
    same bytes: equal images, or the same error."""
    tdec = getattr(t2, name, None) or getattr(t3, name)
    jdec = getattr(j2, name, None) or getattr(j3, name)
    try:
        want = jdec(blob, *args)
    except Exception as e:      # the port raises as the JAX module does
        with pytest.raises(type(e)):
            tdec(blob, *args, device="cpu")
        return None
    got = tdec(blob, *args, device="cpu")
    _same(got, want)
    return got


# -- encoders: the JAX bytes ------------------------------------------------

def _enc_cases():
    cases = []
    for bits in (8, 10, 16):
        for c in (1, 2, 3, 4):
            cases.append(("encode_dpx", c, {"bits": bits}))
    for depth in (8, 16):
        for c in (1, 3, 4):
            cases.append(("encode_psd", c, {"depth": depth}))
    for c in (1, 3, 4):
        cases += [("encode_fits", c, {}), ("encode_avs", c, {}),
                  ("encode_mtv", c, {}), ("encode_fl32", c, {}),
                  ("encode_vicar", c, {}), ("encode_sun", c, {}),
                  ("encode_wbmp", c, {}), ("encode_otb", c, {}),
                  ("encode_mono", c, {}), ("encode_fax", c, {}),
                  ("encode_g4_image", c, {}), ("encode_viff", c, {}),
                  ("encode_rla", c, {}), ("encode_palm", c, {}),
                  ("encode_pict", c, {})]
    cases += [("encode_avs", 2, {}), ("encode_fl32", 2, {}),
              ("encode_rla", 2, {}), ("encode_pict", 2, {})]
    for depth in (8, 16):
        for c in (1, 3, 4):
            cases.append(("encode_mat", c, {"depth": depth}))
    return cases


@pytest.mark.parametrize("name,c,kw", _enc_cases(),
                         ids=lambda v: str(v) if not isinstance(v, dict)
                         else "-".join(f"{k}{x}" for k, x in v.items()))
def test_encoders_give_the_jax_bytes(name, c, kw):
    """Odd widths (SUN's and PICT's row padding), values outside [0, 1];
    where the JAX encoder raises (PICT of gray and alpha), the same
    error."""
    t, j = _pair(_pixels(zlib.crc32(name.encode()) % 97 + c, 13, 19, c))
    tenc = getattr(t2, name, None) or getattr(t3, name)
    jenc = getattr(j2, name, None) or getattr(j3, name)
    _same_result(lambda im: tenc(im, **kw), lambda im: jenc(im, **kw), (t, j))


@pytest.mark.parametrize("shape", [(40, 300), (300, 12), (9, 100)])
@pytest.mark.parametrize("name", ["encode_otb", "encode_pict", "encode_rla",
                                  "encode_palm", "encode_vicar"])
def test_encoders_at_wide_and_tall_extents(name, shape):
    """OTB's two-byte extents past 255, PICT's u16 row lengths past 250
    bytes, runs longer than RLA's 128 and PackBits' 128."""
    arr = _pixels(5, *shape, 3, spill=False)
    arr[:, : shape[1] // 2] = 0.2            # long runs
    t, j = _pair(arr)
    tenc = getattr(t2, name, None) or getattr(t3, name)
    jenc = getattr(j2, name, None) or getattr(j3, name)
    assert tenc(t) == jenc(j)


def test_pdf_of_several_images_gives_the_jax_bytes():
    imgs = [_pair(_pixels(k, 9 + k, 11, c)) for k, c in
            enumerate((1, 3, 4, 2))]
    assert t2.encode_pdf([t for t, _ in imgs]) == \
        j2.encode_pdf([j for _, j in imgs])
    assert t2.encode_pdf(imgs[1][0]) == j2.encode_pdf(imgs[1][1])


# -- decoders of the encoders' bytes ----------------------------------------

@pytest.mark.parametrize("enc,dec,c", [
    ("encode_dpx", "decode_dpx", 1), ("encode_dpx", "decode_dpx", 3),
    ("encode_dpx", "decode_dpx", 4), ("encode_fits", "decode_fits", 1),
    ("encode_fits", "decode_fits", 3), ("encode_avs", "decode_avs", 3),
    ("encode_mtv", "decode_mtv", 3), ("encode_fl32", "decode_fl32", 4),
    ("encode_fl32", "decode_fl32", 1), ("encode_vicar", "decode_vicar", 3),
    ("encode_sun", "decode_sun", 3), ("encode_wbmp", "decode_wbmp", 3),
    ("encode_otb", "decode_otb", 1), ("encode_viff", "decode_viff", 1),
    ("encode_viff", "decode_viff", 3), ("encode_rla", "decode_rla", 1),
    ("encode_rla", "decode_rla", 4), ("encode_palm", "decode_palm", 1),
    ("encode_palm", "decode_palm", 3), ("encode_pict", "decode_pict", 3),
    ("encode_pict", "decode_pict", 4), ("encode_mat", "decode_mat", 1),
    ("encode_mat", "decode_mat", 3)])
def test_decoders_of_encoded_bytes_match_jax(enc, dec, c):
    _, j = _pair(_pixels(c + 30, 12, 17, c))
    blob = (getattr(j2, enc, None) or getattr(j3, enc))(j)
    _decode_both(dec, blob)


@pytest.mark.parametrize("bits", [8, 10, 16])
def test_dpx_depths_round_trip_as_jax(bits):
    _, j = _pair(_pixels(bits, 10, 13, 3))
    _decode_both("decode_dpx", j2.encode_dpx(j, bits=bits))


# -- hand-built DPX and CIN -------------------------------------------------

def _dpx(q, bits, packing=1, bo=">", descriptor=50, offset=2048,
         el_offset=None):
    """A DPX of samples ``q`` (h, w, c) as ``bits``-bit codes."""
    h, w, c = q.shape
    head = bytearray(offset)
    head[0:4] = b"SDPX" if bo == ">" else b"XPDS"
    struct.pack_into(bo + "I", head, 4, offset)
    struct.pack_into(bo + "I", head, 772, w)
    struct.pack_into(bo + "I", head, 776, h)
    head[800] = descriptor
    head[803] = bits
    struct.pack_into(bo + "H", head, 804, packing)
    struct.pack_into(bo + "I", head, 808,
                     offset if el_offset is None else el_offset)
    flat = q.reshape(-1).astype(np.uint32)
    if bits == 8:
        payload = flat.astype(np.uint8).tobytes()
    elif bits == 16:
        payload = flat.astype(bo + "u2").tobytes()
    elif bits == 10 and packing == 1:
        flat = np.concatenate([flat, np.zeros((-len(flat)) % 3, np.uint32)])
        t = flat.reshape(-1, 3)
        payload = ((t[:, 0] << 22) | (t[:, 1] << 12) | (t[:, 2] << 2)
                   ).astype(bo + "u4").tobytes()
    elif bits == 10:
        bitsarr = ((flat[:, None] >> np.arange(9, -1, -1)) & 1).astype(
            np.uint8)
        payload = np.packbits(bitsarr.reshape(-1)).tobytes()
    else:  # 12-bit filled, left-justified in 16-bit words
        payload = (flat << 4).astype(bo + "u2").tobytes()
    return bytes(head) + payload


@pytest.mark.parametrize("bits,packing", [(8, 0), (10, 1), (10, 0), (12, 1),
                                          (16, 0)])
@pytest.mark.parametrize("bo", [">", "<"])
@pytest.mark.parametrize("descriptor,c", [(6, 1), (50, 3), (51, 4), (52, 4)])
def test_dpx_hand_built_match_jax(bits, packing, bo, descriptor, c):
    """8, 10 (filled and packed), 12 and 16 bits, both byte orders, luma,
    RGB, RGBA and ABGR."""
    rng = np.random.default_rng(bits + c)
    q = rng.integers(0, 1 << bits, (5, 7, c))
    _decode_both("decode_dpx", _dpx(q, bits, packing, bo, descriptor))


@pytest.mark.parametrize("el_offset", [0, 0xFFFFFFFF])
def test_dpx_element_offset_falls_back_to_the_header(el_offset):
    q = np.random.default_rng(1).integers(0, 1024, (4, 6, 3))
    _decode_both("decode_dpx", _dpx(q, 10, el_offset=el_offset))


def test_dpx_refusals_match_jax():
    q = np.zeros((2, 2, 3), np.int64)
    _decode_both("decode_dpx", _dpx(q, 12, packing=0))
    _decode_both("decode_dpx", _dpx(q, 10, descriptor=100))
    _decode_both("decode_dpx", b"NOPE" + bytes(900))


def _cin(q, bits, bo=">"):
    h, w, c = q.shape
    head = bytearray(2048)
    head[0:4] = b"\x80\x2a\x5f\xd7" if bo == ">" else b"\xd7\x5f\x2a\x80"
    struct.pack_into(bo + "I", head, 4, 2048)
    head[193] = c
    off = 194
    for _ in range(c):
        head[off + 3] = bits
        struct.pack_into(bo + "I", head, off + 4, w)
        struct.pack_into(bo + "I", head, off + 8, h)
        off += 28
    flat = q.reshape(-1).astype(np.uint32)
    if bits == 8:
        return bytes(head) + flat.astype(np.uint8).tobytes()
    if bits != 10:
        return bytes(head) + bytes(8)
    flat = np.concatenate([flat, np.zeros((-len(flat)) % 3, np.uint32)])
    t = flat.reshape(-1, 3)
    return bytes(head) + ((t[:, 0] << 22) | (t[:, 1] << 12) | (t[:, 2] << 2)
                          ).astype(bo + "u4").tobytes()


@pytest.mark.parametrize("bits", [8, 10, 12])
@pytest.mark.parametrize("bo", [">", "<"])
@pytest.mark.parametrize("c", [1, 3])
def test_cin_hand_built_match_jax(bits, bo, c):
    """8 and 10 bits, both byte orders, 1 and 3 channels; 12 bits is
    refused."""
    q = np.random.default_rng(bits * c).integers(0, 1 << min(bits, 10),
                                                 (6, 9, c))
    _decode_both("decode_cin", _cin(q, bits, bo))


# -- hand-built DICOM -------------------------------------------------------

def _dcm(px, rows, cols, explicit=True, preamble=True, bits=16,
         signed=False, photometric=b"MONOCHROME2 ", samples=1, extra=()):
    def elem(group, el, vr, value):
        if not explicit:
            return struct.pack("<HHI", group, el, len(value)) + value
        if vr in (b"OB", b"OW"):
            return (struct.pack("<HH2sHI", group, el, vr, 0, len(value))
                    + value)
        return struct.pack("<HH2sH", group, el, vr, len(value)) + value

    body = b"\0" * 128 + b"DICM" if preamble else b""
    body += elem(0x0028, 0x0002, b"US", struct.pack("<H", samples))
    body += elem(0x0028, 0x0004, b"CS", photometric)
    body += elem(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += elem(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    if bits is not None:
        body += elem(0x0028, 0x0100, b"US", struct.pack("<H", bits))
    body += elem(0x0028, 0x0103, b"US", struct.pack("<H", int(signed)))
    for group, el, vr, value in extra:
        body += elem(group, el, vr, value)
    return body + elem(0x7FE0, 0x0010, b"OW", px.tobytes())


@pytest.mark.parametrize("case", [
    "explicit-u16", "implicit-u16", "no-preamble-s16", "implicit-s16-slope",
    "monochrome1-u8", "rgb-u8", "s32", "default-bits", "flat"])
def test_dcm_hand_built_match_jax(case):
    """Explicit and implicit VR, signed, MONOCHROME1, slope and intercept
    (DS strings), RGB samples, 32 bits, no BitsAllocated, a flat image
    (its window clamps to 1e-12)."""
    rng = np.random.default_rng(len(case))
    rows, cols = 7, 11
    kw = {}
    if case in ("explicit-u16", "implicit-u16", "default-bits"):
        px = rng.integers(0, 4096, rows * cols).astype("<u2")
        kw = dict(explicit=case != "implicit-u16",
                  bits=None if case == "default-bits" else 16)
    elif case in ("no-preamble-s16", "implicit-s16-slope"):
        px = rng.integers(-2000, 2000, rows * cols).astype("<i2")
        kw = dict(signed=True, preamble=case == "implicit-s16-slope",
                  explicit=case == "no-preamble-s16")
        if case == "implicit-s16-slope":
            kw["extra"] = [(0x0028, 0x1052, b"DS", b"-1024 "),
                           (0x0028, 0x1053, b"DS", b"2.5 ")]
    elif case == "monochrome1-u8":
        px = rng.integers(0, 256, rows * cols).astype(np.uint8)
        kw = dict(bits=8, photometric=b"MONOCHROME1 ")
    elif case == "rgb-u8":
        px = rng.integers(0, 256, rows * cols * 3).astype(np.uint8)
        kw = dict(bits=8, samples=3, photometric=b"RGB ")
    elif case == "s32":
        px = rng.integers(-70000, 70000, rows * cols).astype("<i4")
        kw = dict(bits=32, signed=True)
    else:
        px = np.full(rows * cols, 300, "<u2")
    _decode_both("decode_dcm", _dcm(px, rows, cols, **kw))


def test_dcm_refusals_match_jax():
    px = np.zeros(4, "<u2")
    blob = _dcm(px, 2, 2)
    _decode_both("decode_dcm", blob[:-8])           # no pixel data
    undefined = blob[:-12] + struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB",
                                         0, 0xFFFFFFFF)
    _decode_both("decode_dcm", undefined)           # encapsulated


# -- hand-built XCF ---------------------------------------------------------

def _xcf_rle(vals: bytes) -> bytes:
    """XCF RLE using all four of its forms: short and long runs, short
    and long literal stretches."""
    out = bytearray()
    i, n = 0, len(vals)
    while i < n:
        run = 1
        while i + run < n and vals[i + run] == vals[i]:
            run += 1
        if run >= 2:
            if run <= 127:
                out += bytes([run - 1, vals[i]])
            else:
                out += bytes([127]) + struct.pack(">H", run) + vals[i:i + 1]
            i += run
            continue
        j = i + 1
        while j < n and not (j + 1 < n and vals[j] == vals[j + 1]):
            j += 1
        lit = vals[i:j]
        if len(lit) <= 127:
            out += bytes([256 - len(lit)]) + lit
        else:
            out += bytes([128]) + struct.pack(">H", len(lit)) + lit
        i = j
    return bytes(out)


def _xcf(w, h, layers, version=1):
    """An XCF of ``layers`` (top first): (pixels u8 (lh, lw, bpp), type,
    props) with props a list of (ptype, payload bytes)."""
    ptr = ">Q" if version >= 11 else ">I"
    psize = struct.calcsize(ptr)
    buf = bytearray(b"gimp xcf " + (b"file" if version == 0 else
                                    b"v%03d" % version) + b"\0")
    buf += struct.pack(">III", w, h, 0)
    if version >= 4:
        buf += struct.pack(">I", 150)
    buf += struct.pack(">II", 17, 1) + b"\0"      # a property, skipped
    buf += struct.pack(">II", 0, 0)
    table = len(buf)
    buf += b"\0" * (psize * (len(layers) + 1))
    for k, (px, ltype, props) in enumerate(layers):
        struct.pack_into(ptr, buf, table + psize * k, len(buf))
        lh, lw, bpp = px.shape
        buf += struct.pack(">III", lw, lh, ltype)
        name = b"layer%d\0" % k
        buf += struct.pack(">I", len(name)) + name
        for ptype, payload in props:
            buf += struct.pack(">II", ptype, len(payload)) + payload
        buf += struct.pack(">II", 0, 0)
        hier_ptr = len(buf)
        buf += b"\0" * (2 * psize)
        struct.pack_into(ptr, buf, hier_ptr, len(buf))
        buf += struct.pack(">III", lw, lh, bpp)
        lvl_ptr = len(buf)
        buf += b"\0" * (2 * psize)
        struct.pack_into(ptr, buf, lvl_ptr, len(buf))
        buf += struct.pack(">II", lw, lh)
        ntx, nty = -(-lw // 64), -(-lh // 64)
        tiles = len(buf)
        buf += b"\0" * (psize * (ntx * nty + 1))
        for ty in range(nty):
            for tx in range(ntx):
                sub = px[ty * 64:(ty + 1) * 64, tx * 64:(tx + 1) * 64]
                struct.pack_into(ptr, buf, tiles + psize * (ty * ntx + tx),
                                 len(buf))
                if version == 0:
                    buf += np.ascontiguousarray(sub).tobytes()
                else:
                    for ch in range(bpp):
                        buf += _xcf_rle(np.ascontiguousarray(
                            sub[..., ch]).tobytes())
    return bytes(buf)


@pytest.mark.parametrize("version", [0, 1, 11])
def test_xcf_two_layers_match_jax(version):
    """An RGBA layer at an offset and opacity over an RGB one, RLE tiles
    (a layer wider than one 64-tile, flat areas for runs past 127), v0's
    raw tiles and v11's 8-byte pointers."""
    rng = np.random.default_rng(version)
    w, h = 90, 70
    bottom = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    bottom[:, :40] = 200
    top = rng.integers(0, 256, (30, 80, 4)).astype(np.uint8)
    top[5:20] = (10, 20, 30, 255)
    layers = [(top, 1, [(6, struct.pack(">I", 180)),
                        (15, struct.pack(">ii", 20, -5))]),
              (bottom, 0, [(8, struct.pack(">I", 1))])]
    _decode_both("decode_xcf", _xcf(w, h, layers, version))


def test_xcf_gray_hidden_and_float_opacity_match_jax():
    rng = np.random.default_rng(7)
    gray_a = rng.integers(0, 256, (20, 30, 2)).astype(np.uint8)
    gray = rng.integers(0, 256, (40, 40, 1)).astype(np.uint8)
    hidden = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    layers = [(gray_a, 3, [(33, struct.pack(">f", 0.4)),
                           (15, struct.pack(">ii", -10, 30))]),
              (hidden, 0, [(8, struct.pack(">I", 0))]),
              (gray, 2, []),
              (gray, 2, [(15, struct.pack(">ii", 50, 50))])]   # off canvas
    _decode_both("decode_xcf", _xcf(40, 40, layers, 3))
    indexed = [(gray, 4, [])]
    _decode_both("decode_xcf", _xcf(40, 40, indexed, 1))


# -- FITS, VICAR, SUN, OTB, WBMP, MONO --------------------------------------

def _fits(arr, bitpix, naxis3=None, bzero=None):
    cards = [j2._fits_card("SIMPLE", True), j2._fits_card("BITPIX", bitpix),
             j2._fits_card("NAXIS", 3 if naxis3 else 2),
             j2._fits_card("NAXIS1", arr.shape[-1]),
             j2._fits_card("NAXIS2", arr.shape[-2])]
    if naxis3:
        cards.append(j2._fits_card("NAXIS3", naxis3))
    if bzero is not None:
        cards.append(j2._fits_card("BZERO", bzero))
    cards.append(b"COMMENT   a card with no value".ljust(80))
    cards.append(b"END".ljust(80))
    head = b"".join(cards)
    head += b" " * ((-len(head)) % 2880)
    dt = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    return head + arr.astype(dt).tobytes()


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("planes", [None, 3])
def test_fits_hand_built_match_jax(bitpix, planes):
    rng = np.random.default_rng(abs(bitpix))
    shape = (planes or 1, 6, 9)
    if bitpix > 0:
        arr = rng.integers(0, 1 << min(bitpix - 1, 15), shape)
    else:
        arr = rng.standard_normal(shape) * 50
    _decode_both("decode_fits", _fits(arr[0] if planes is None else arr,
                                      bitpix, planes,
                                      32768 if bitpix == 16 else None))
    _decode_both("decode_fits", b"NOTFITS" + bytes(2880))


@pytest.mark.parametrize("fmt,dt", [("BYTE", "u1"), ("HALF", "<i2"),
                                    ("FULL", "<i4"), ("REAL", "<f4")])
def test_vicar_hand_built_match_jax(fmt, dt):
    rng = np.random.default_rng(len(fmt))
    arr = (rng.standard_normal((5, 8)) * 1e4).astype(dt)
    label = f"LBLSIZE=96  FORMAT='{fmt}'  TYPE='IMAGE'  NL=5  NS=8"
    _decode_both("decode_vicar", label.ljust(96).encode() + arr.tobytes())


def _sun(w, h, depth, raw, rtype=1, cmap=b""):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(raw), rtype,
                       1 if cmap else 0, len(cmap)) + cmap + raw


def _sun_rle(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        run = 1
        while i + run < len(raw) and raw[i + run] == raw[i] and run < 256:
            run += 1
        if run >= 3 or raw[i] == 0x80:
            out += bytes([0x80, run - 1, raw[i]]) if run > 1 or \
                raw[i] != 0x80 else bytes([0x80, 0])
            i += run
        else:
            out.append(raw[i])
            i += 1
    return bytes(out)


@pytest.mark.parametrize("depth,rtype,cmap", [
    (1, 1, False), (8, 1, True), (8, 0, False), (24, 1, False),
    (24, 2, False), (24, 3, False), (32, 1, False), (32, 3, False),
    (8, 2, True)])
def test_sun_hand_built_match_jax(depth, rtype, cmap):
    """Depths 1/8/24/32, rows padded to 16 bits, an RGB colormap, the
    byte-RLE type (with 0x80 escapes) and RT_FORMAT_RGB."""
    rng = np.random.default_rng(depth + rtype)
    w, h = 13, 6
    stride = ((w + 15) // 16) * 2 if depth == 1 else \
        w * (depth // 8) + ((w * (depth // 8)) & 1)
    raw = rng.integers(0, 256, (h, stride)).astype(np.uint8)
    raw[:, 2:8] = 0x80
    raw = raw.tobytes()
    pal = rng.integers(0, 256, 3 * 10).astype(np.uint8).tobytes() \
        if cmap else b""
    _decode_both("decode_sun", _sun(w, h, depth, _sun_rle(raw) if rtype == 2
                                    else raw, rtype, pal))


def test_sun_refusals_match_jax():
    _decode_both("decode_sun", b"\x59\xa6\x6a\x95" + bytes(10))
    _decode_both("decode_sun", _sun(4, 4, 16, bytes(32)))
    _decode_both("decode_sun", _sun(4, 4, 8, bytes(7)))


def test_otb_wbmp_and_mono_hand_built_match_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (5, 2)).astype(np.uint8).tobytes()
    _decode_both("decode_otb", bytes([0, 13, 5, 1]) + packed)
    _decode_both("decode_otb", bytes([0x10, 0, 13, 0, 5, 1]) + packed)
    _decode_both("decode_wbmp", b"\0\0" + bytes([13, 5]) + packed)
    wide = rng.integers(0, 256, (3, 38)).astype(np.uint8).tobytes()
    _decode_both("decode_wbmp", b"\0\0" + bytes([0x82, 0x2c, 3]) + wide)
    _decode_both("decode_wbmp", b"\1\0" + bytes(8))
    _decode_both("decode_mono", packed, 13, 5)
    _decode_both("decode_mono", packed[:3], 13, 5)


def test_avs_mtv_and_fl32_hand_built_match_jax():
    rng = np.random.default_rng(4)
    argb = rng.integers(0, 256, (4, 6, 4)).astype(np.uint8)
    _decode_both("decode_avs", struct.pack(">II", 6, 4) + argb.tobytes())
    _decode_both("decode_mtv", b"6 4\n" + argb[..., :3].tobytes())
    for magic in (b"L32F", b"fl32", b"FL32", b"XXXX"):
        vals = rng.standard_normal((4, 6, 2)).astype("<f4")
        _decode_both("decode_fl32", struct.pack("<4sIII", magic, 6, 4, 2)
                     + vals.tobytes())


# -- MAT --------------------------------------------------------------------

def _element(t, body, bo="<"):
    pad = (-len(body)) % 8
    return struct.pack(bo + "II", t, len(body)) + body + b"\0" * pad


def _mat5(arrays, bo="<", compress=(), small_name=False):
    """A level-5 MAT-file of numeric ``arrays`` (column-major), those at
    the indices in ``compress`` inside miCOMPRESSED envelopes."""
    mi = {np.dtype(np.uint8): (2, 9), np.dtype(np.int16): (3, 10),
          np.dtype(np.uint16): (4, 11), np.dtype(np.int32): (5, 12),
          np.dtype(np.uint32): (6, 13), np.dtype(np.float32): (7, 7),
          np.dtype(np.float64): (9, 6), np.dtype(np.int8): (1, 8),
          np.dtype(np.int64): (12, 14), np.dtype(np.uint64): (13, 15)}
    out = (b"MATLAB 5.0 MAT-file, test".ljust(116) + b"\0" * 8
           + struct.pack(bo + "H", 0x0100) + (b"IM" if bo == "<" else b"MI"))
    for k, a in enumerate(arrays):
        t, mx = mi[a.dtype]
        if small_name:   # small-element format: type and length in 4 bytes
            name = struct.pack(bo + "HH", 1, 1) + b"m\0\0\0"
        else:
            name = _element(1, b"img", bo)
        body = (_element(6, struct.pack(bo + "II", mx, 0), bo)
                + _element(5, struct.pack(bo + f"{a.ndim}i", *a.shape), bo)
                + name
                + _element(t, np.asfortranarray(a).astype(
                    a.dtype.newbyteorder(bo)).tobytes(order="F"), bo))
        el = _element(14, body, bo)
        if k in compress:
            comp = zlib.compress(el)
            el = struct.pack(bo + "II", 15, len(comp)) + comp
            el += b"\0" * ((-len(comp)) % 8)
        out += el
    return out


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int8", "int16",
                                   "int32", "uint32", "int64", "uint64",
                                   "float32", "float64"])
def test_mat5_classes_match_jax(dtype):
    """Every numeric class: integer ranges, floats by their extrema (or
    kept where they lie in [0, 1])."""
    rng = np.random.default_rng(len(dtype))
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.standard_normal((5, 7)) * (3 if dtype == "float64" else 0.2)
        a = a.astype(dt)
    else:
        info = np.iinfo(dt)
        a = rng.integers(max(info.min, -1000), min(info.max, 1000), (5, 7),
                         dtype=dt)
    _decode_both("decode_mat", _mat5([a]))


def test_mat5_several_images_compressed_big_endian_match_jax():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    gray = rng.random((4, 9))
    flat = np.full((3, 3), 7.0)
    nan = rng.random((3, 4))
    nan[1, 2] = np.nan
    for bo in ("<", ">"):
        _decode_both("decode_mat", _mat5([rgb, gray, flat, nan], bo,
                                         compress=(1,), small_name=True))
    corrupt = _mat5([gray])[:128] + struct.pack("<II", 15, 8) + b"notzlib!"
    _decode_both("decode_mat", corrupt + _mat5([rgb])[128:])
    _decode_both("decode_mat", corrupt)


@pytest.mark.parametrize("mopt,dt,bo", [(0, "<f8", "<"), (10, "<f4", "<"),
                                        (20, "<i4", "<"), (50, "u1", "<"),
                                        (1030, ">i2", ">"),
                                        (1040, ">u2", ">"), (60, "u1", "<")])
def test_mat4_match_jax(mopt, dt, bo):
    """Level 4, both byte orders (a big-endian header the JAX module
    recognizes: its first word read little-endian is >= 1000), and an
    unknown precision."""
    vals = (np.random.default_rng(mopt).random((3, 4)) * 200).astype(dt)
    blob = (struct.pack(bo + "5i", mopt, 3, 4, 0, 2) + b"m\0"
            + vals.T.tobytes())
    _decode_both("decode_mat", blob)


# -- VIFF, RLA, Palm, PICT --------------------------------------------------

def _viff(planes, storage, bo="<", colormap=None, comment=b"a comment"):
    bands, rows, cols = planes.shape[:3]
    hdr = bytearray(1024)
    hdr[0], hdr[1], hdr[2], hdr[3] = 0xAB, 1, 1, 3
    hdr[4] = 0x4 if bo == "<" else 0x2
    hdr[8:8 + len(comment)] = comment
    for off, v in ((520, rows), (524, cols), (548, 1), (556, 1),
                   (560, bands), (564, storage)):
        struct.pack_into(bo + "I", hdr, off, v)
    body = b""
    if colormap is not None:
        struct.pack_into(bo + "I", hdr, 572, 1)
        struct.pack_into(bo + "I", hdr, 576, 1)
        struct.pack_into(bo + "I", hdr, 580, colormap.shape[0])
        struct.pack_into(bo + "I", hdr, 584, colormap.shape[1])
        body += colormap.astype(np.uint8).tobytes()
    if storage == 0:
        bits = planes.astype(np.uint8)
        body += np.packbits(bits, axis=-1, bitorder="little").tobytes()
    else:
        dt = {2: "u2", 4: "u4", 5: "f4", 9: "f8"}.get(storage, "u1")
        body += planes.astype(np.dtype(dt).newbyteorder(bo)).tobytes()
    return bytes(hdr) + body


@pytest.mark.parametrize("storage", [0, 1, 2, 4, 5, 9])
@pytest.mark.parametrize("bo", ["<", ">"])
@pytest.mark.parametrize("bands", [1, 4])
def test_viff_hand_built_match_jax(storage, bo, bands):
    """The bit type (LSB first), 1/2/4-byte integers, floats (kept in
    [0, 1], else stretched by their extrema), both byte orders, 4 bands."""
    rng = np.random.default_rng(storage * 10 + bands)
    shape = (bands, 5, 11)
    planes = {0: rng.integers(0, 2, shape), 1: rng.integers(0, 256, shape),
              2: rng.integers(0, 65536, shape),
              4: rng.integers(0, 1 << 32, shape, dtype=np.uint64),
              5: rng.random(shape) * (3 if bands == 4 else 1),
              9: rng.standard_normal(shape)}[storage]
    _decode_both("decode_viff", _viff(planes, storage, bo))


def test_viff_colormap_and_refusals_match_jax():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 8, (1, 4, 6))
    cmap = rng.integers(0, 256, (3, 8))
    _decode_both("decode_viff", _viff(idx, 1, colormap=cmap))
    blob = bytearray(_viff(idx, 1))
    struct.pack_into("<I", blob, 568, 1)          # an encoding
    _decode_both("decode_viff", bytes(blob))
    _decode_both("decode_viff", _viff(idx, 3))    # an unknown storage
    _decode_both("decode_viff", b"\xab\x02" + bytes(1100))


def _rla(q, n_chan, n_matte, desc=b"rla test"):
    h, w, total = q.shape
    hdr = bytearray(740)
    struct.pack_into(">4h", hdr, 0, 0, w - 1, 0, h - 1)
    struct.pack_into(">4h", hdr, 8, 0, w - 1, 0, h - 1)
    struct.pack_into(">6h", hdr, 16, 0, 0, n_chan, n_matte, 0, -2)
    hdr[157:157 + len(desc)] = desc
    lines = []
    for y in range(h):
        chunk = b""
        for c in range(total):
            enc = j3._rla_rle_encode(q[y, :, c])
            chunk += struct.pack(">h", len(enc)) + enc
        lines.append(chunk)
    offsets, pos = [], 740 + 4 * h
    for y in range(h - 1, -1, -1):
        offsets.append(pos)
        pos += len(lines[y])
    return (bytes(hdr) + struct.pack(f">{h}i", *offsets)
            + b"".join(lines[::-1]))


@pytest.mark.parametrize("n_chan,n_matte", [(1, 0), (1, 1), (3, 0), (3, 1),
                                            (4, 1), (5, 0)])
def test_rla_hand_built_match_jax(n_chan, n_matte):
    rng = np.random.default_rng(n_chan * 3 + n_matte)
    total = min(n_chan + n_matte, 4)
    q = rng.integers(0, 256, (6, 150, total)).astype(np.uint8)
    q[:, 10:140:2] = 77                     # long runs and short ones
    _decode_both("decode_rla", _rla(q, n_chan, n_matte))


def test_rla_storage_refusal_matches_jax():
    blob = bytearray(_rla(np.zeros((2, 3, 3), np.uint8), 3, 0))
    struct.pack_into(">h", blob, 18, 1)
    _decode_both("decode_rla", bytes(blob))


def _palm(w, h, bpr, flags, bpp, payload, version=1, transparent=0,
          ctype=0xFF, colormap=None):
    head = struct.pack(">4HBBHBBH", w, h, bpr, flags, bpp, version, 0,
                       transparent, ctype, 0)
    if bpp == 16:
        head += struct.pack(">BBBBB3B", 5, 6, 5, 0, 0, 0, 0, 0)
    if colormap is not None:
        head += struct.pack(">H", len(colormap))
        for k, (r, g, b) in enumerate(colormap):
            head += bytes([k, r, g, b])
    if flags & 0x8000:
        head += struct.pack(">H", len(payload))
    return head + payload


@pytest.mark.parametrize("case", ["1bit-rle", "scanline", "8bit-system",
                                  "2bit-ramp", "colormap-transparent",
                                  "16bit", "unknown-compression",
                                  "bad-depth"])
def test_palm_hand_built_match_jax(case):
    rng = np.random.default_rng(len(case))
    if case == "1bit-rle":
        blob = _palm(16, 2, 2, 0x8000, 1, bytes([1, 0xF0, 1, 0x0F, 1, 0xFF,
                                                 1, 0x00]), ctype=0x01)
    elif case == "scanline":
        blob = _palm(8, 3, 1, 0x8000, 1, bytes([0x80, 0xAA, 0x00, 0x80,
                                                0x55]), ctype=0x00)
    elif case == "8bit-system":
        blob = _palm(9, 4, 10, 0, 8, rng.integers(
            0, 256, 40).astype(np.uint8).tobytes())
    elif case == "2bit-ramp":
        blob = _palm(7, 3, 2, 0, 2, rng.integers(
            0, 256, 6).astype(np.uint8).tobytes())
    elif case == "colormap-transparent":
        pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(5)]
        blob = _palm(6, 3, 6, 0x4000 | 0x2000, 8, rng.integers(
            0, 5, 18).astype(np.uint8).tobytes(), transparent=2,
            colormap=pal)
    elif case == "16bit":
        blob = _palm(5, 3, 10, 0x0400, 16, rng.integers(
            0, 256, 30).astype(np.uint8).tobytes(), version=2)
    elif case == "unknown-compression":
        blob = _palm(8, 1, 1, 0x8000, 1, bytes(4), ctype=0x02)
    else:
        blob = _palm(8, 1, 1, 0, 3, bytes(4))
    _decode_both("decode_palm", blob)


def _pict(q, bits=32, op=0x009A, colormap=None, comment=True,
          row_bytes=None):
    """A v2 PICT of one raster op: DirectBitsRect of planar rows (``q``
    (h, w, nc) u8), or PackBitsRect of 8-bit indices (``q`` (h, w)) with
    ``colormap`` ((n, 3) u16)."""
    h, w = q.shape[:2]
    out = bytearray(512)

    def u16(v):
        out.extend(struct.pack(">H", v & 0xFFFF))

    def u32(v):
        out.extend(struct.pack(">I", v & 0xFFFFFFFF))

    def rect():
        u16(0), u16(0), u16(h), u16(w)

    u16(0)
    rect()
    u16(0x0011), u16(0x02FF)
    u16(0x0C00)
    out.extend(bytes(24))
    u16(0x0000)                                  # NOP
    u16(0x001E)                                  # DefHilite
    if comment:
        u16(0x00A1), u16(100), u16(3)
        out.extend(b"abc\0")
    u16(0x0001), u16(0x000A)
    rect()
    u16(op)
    if op == 0x009A:
        u32(0xFF)
    nc = 1 if q.ndim == 2 else q.shape[-1]
    rb = row_bytes or (w if op == 0x0098 else 4 * w)
    u16(rb | 0x8000)
    rect()
    u16(0), u16(0 if rb < 8 else 4), u32(0)
    u16(72), u16(0), u16(72), u16(0)
    u16(0 if op == 0x0098 else 16), u16(bits), u16(nc), u16(8)
    u32(0), u32(0), u32(0)
    if op == 0x0098:
        u32(0), u16(0), u16(len(colormap) - 1)
        for k, (r, g, b) in enumerate(colormap):
            u16(k), u16(r), u16(g), u16(b)
    rect()
    rect()
    u16(0)
    for y in range(h):
        row = (q[y] if q.ndim == 2 else
               np.transpose(q[y], (1, 0)).reshape(-1)).tobytes()
        if rb < 8:
            out.extend(row[:rb].ljust(rb, b"\0"))
        else:
            out.extend(j3._pict_pack_row(row, rb))
    if (len(out) - 512) & 1:
        out.append(0)
    u16(0x00FF)
    return bytes(out)


@pytest.mark.parametrize("case", ["rgb", "orgb", "wide", "indexed",
                                  "indexed-narrow", "gray8", "bad-op",
                                  "bad-bits", "not-v2"])
def test_pict_hand_built_match_jax(case):
    """DirectBitsRect (RGB, O-R-G-B, rows past 250 bytes), PackBitsRect
    with a colormap (rows of fewer than 8 bytes unpacked), 8-bit gray,
    a long comment, and the refusals."""
    rng = np.random.default_rng(len(case))
    if case in ("rgb", "orgb", "wide"):
        w = 70 if case == "wide" else 9
        q = rng.integers(0, 256, (5, w, 4 if case == "orgb" else 3))
        q[:, 2:6] = 40
        blob = _pict(q.astype(np.uint8))
    elif case.startswith("indexed"):
        w = 5 if case == "indexed-narrow" else 30
        cmap = rng.integers(0, 65536, (12, 3))
        blob = _pict(rng.integers(0, 12, (4, w)).astype(np.uint8), 8,
                     0x0098, cmap, row_bytes=w)
    elif case == "gray8":
        blob = _pict(rng.integers(0, 256, (4, 12, 1)).astype(np.uint8), 8,
                     row_bytes=12)
        blob = blob.replace(struct.pack(">4H", 16, 8, 1, 8),
                            struct.pack(">4H", 0, 8, 1, 8), 1)
    elif case == "bad-op":
        blob = _pict(np.zeros((2, 3, 3), np.uint8))
        blob = blob[:-2] + struct.pack(">H", 0x0031) + blob[-2:]
    elif case == "bad-bits":
        blob = _pict(np.zeros((2, 3, 3), np.uint8), bits=16)
    else:
        blob = bytearray(_pict(np.zeros((2, 3, 3), np.uint8)))
        blob[522:524] = b"\x00\x12"
        blob = bytes(blob)
    _decode_both("decode_pict", blob)


# -- the fax and byte codecs ------------------------------------------------

def _pages():
    """Long runs (makeup codes past 2560 at width 3000), an all-white
    row, an all-black row, pass-mode shapes and text-like strokes."""
    rng = np.random.default_rng(11)
    wide = np.zeros((6, 3000), np.uint8)
    wide[1, 100:2800] = 1
    wide[2] = 1
    wide[3, ::7] = 1
    wide[4, 2900:] = 1
    shrink = np.zeros((5, 40), np.uint8)
    shrink[0, 5:30] = 1
    shrink[1, 10:20] = 1
    shrink[2, 10:12] = 1
    text = np.zeros((30, 1728), np.uint8)
    for _ in range(60):
        y, x = rng.integers(0, 26), rng.integers(0, 1700)
        text[y:y + 4, x:x + rng.integers(2, 25)] = 1
    return {"wide": wide, "shrink": shrink, "text": text,
            "noise": (rng.random((12, 97)) < 0.4).astype(np.uint8)}


@pytest.mark.parametrize("page", ["wide", "shrink", "text", "noise"])
@pytest.mark.parametrize("codec", ["g3", "g4"])
def test_fax_codecs_give_the_jax_bytes_and_rows(page, codec):
    bits = _pages()[page]
    enc = getattr(tfax, "encode_" + codec)(bits)
    assert enc == getattr(jfax, "encode_" + codec)(bits)
    got = getattr(tfax, "decode_" + codec)(enc, bits.shape[1])
    want = getattr(jfax, "decode_" + codec)(enc, bits.shape[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:bits.shape[0]], bits)


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 6), st.integers(1, 90), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([0.05, 0.5, 0.95]))
def test_fax_codecs_on_random_rows_match_jax(h, w, seed, p):
    bits = (np.random.default_rng(seed).random((h, w)) < p).astype(np.uint8)
    for codec in ("g3", "g4"):
        enc = getattr(tfax, "encode_" + codec)(bits)
        assert enc == getattr(jfax, "encode_" + codec)(bits)
        np.testing.assert_array_equal(
            getattr(tfax, "decode_" + codec)(enc, w),
            getattr(jfax, "decode_" + codec)(enc, w))


def _same_result(tfn, jfn, *args):
    """``tfn`` and ``jfn`` give equal results or raise the same error; an
    argument given as a (port, JAX) tuple goes to each side's call."""
    targs = [a[0] if isinstance(a, tuple) else a for a in args]
    jargs = [a[1] if isinstance(a, tuple) else a for a in args]
    try:
        want = jfn(*jargs)
    except Exception as e:
        with pytest.raises(type(e)) as got:
            tfn(*targs)
        assert str(got.value) == str(e)
        return
    got = tfn(*targs)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@settings(max_examples=60, deadline=None, database=None)
@given(st.binary(min_size=0, max_size=64), st.integers(1, 40))
def test_fax_decoders_on_garbage_match_jax(data, width):
    """Streams that end mid-code, lack an EOL or hold bad codes: the same
    rows or the same error."""
    for codec in ("g3", "g4"):
        _same_result(getattr(tfax, "decode_" + codec),
                     getattr(jfax, "decode_" + codec), data, width, 64)


@settings(max_examples=80, deadline=None, database=None)
@given(st.binary(min_size=0, max_size=300))
def test_byte_codecs_match_jax(data):
    for name in ("ascii85_encode", "packbits_encode"):
        enc = getattr(tcomp, name)(data)
        assert enc == getattr(jcomp, name)(data)
    assert tcomp.ascii85_decode(tcomp.ascii85_encode(data)) == data
    assert tcomp.packbits_decode(tcomp.packbits_encode(data)) == data
    for name in ("ascii85_decode", "packbits_decode"):
        _same_result(getattr(tcomp, name), getattr(jcomp, name), data)


def test_runs_of_a_row_are_the_jax_loops():
    rng = np.random.default_rng(5)
    for row in [np.zeros(0, np.uint8), np.ones(5, np.uint8),
                np.zeros(5, np.uint8)] + [
            (rng.random(n) < p).astype(np.uint8)
            for n in (1, 2, 17, 300) for p in (0.1, 0.5, 0.9)]:
        assert tfax._runs_of_row(row) == jfax._runs_of_row(row)


# -- io's dispatch ----------------------------------------------------------

def _blobs():
    """One file of each new format from the JAX encoders, and the
    hand-built read-only ones."""
    _, j3c = _pair(_pixels(60, 12, 17, 3, spill=False))
    _, j1c = _pair(_pixels(61, 12, 17, 1, spill=False))
    q = np.random.default_rng(62).integers(0, 1024, (5, 7, 3))
    xcf_px = np.random.default_rng(63).integers(0, 256, (8, 9, 3))
    blobs = {f: jio.image_to_blob(j3c, f) for f in (
        "dpx", "fits", "fts", "avs", "mtv", "fl32", "vicar", "vic", "sun",
        "mat", "viff", "xv", "vif", "rla", "palm", "pict", "pct")}
    blobs.update({f: jio.image_to_blob(j1c, f) for f in (
        "wbmp", "otb", "fax", "g3", "g4")})
    blobs["cin"] = _cin(q, 10)
    blobs["dcm"] = blobs["dicom"] = _dcm(
        q[..., 0].astype("<u2").reshape(-1), 5, 7)
    blobs["xcf"] = _xcf(9, 8, [(xcf_px.astype(np.uint8), 0, [])])
    return blobs


BLOB_NAMES = ["dpx", "fits", "fts", "avs", "mtv", "fl32", "vicar", "vic",
              "sun", "mat", "viff", "xv", "vif", "rla", "palm", "pict", "pct",
              "wbmp", "otb", "fax", "g3", "g4", "cin", "dcm", "dicom", "xcf"]


@pytest.mark.parametrize("fmt", BLOB_NAMES)
def test_image_from_blob_through_each_name_matches_jax(fmt):
    blob = _blobs()[fmt]
    assert tio.detect_format(blob) == jio.detect_format(blob)
    _same(tio.image_from_blob(blob, fmt, device="cpu"),
          jio.image_from_blob(blob, fmt))


WRITE_NAMES = ["dpx", "psd", "pdf", "fits", "fts", "wbmp", "avs", "mtv",
               "fl32", "vicar", "vic", "sun", "otb", "mono", "fax", "g3",
               "g4", "mat", "viff", "xv", "vif", "rla", "palm", "pict",
               "pct"]


@pytest.mark.parametrize("fmt", WRITE_NAMES)
@pytest.mark.parametrize("depth", [None, 8, 16])
def test_image_to_blob_through_each_name_matches_jax(fmt, depth):
    """DPX's depth rule (10 bits past 8), PSD at 8 bits, MAT at the given
    depth, a non-sRGB image converted first, a list for PDF."""
    t, j = _pair(_pixels(70, 11, 13, 3))
    lt, lj = _pair(_pixels(71, 8, 10, 3), colorspace="lab", depth=16)
    assert tio.image_to_blob([t, lt], fmt, depth=depth) == \
        jio.image_to_blob([j, lj], fmt, depth=depth)


def test_magics_are_detected_as_jax_does():
    blobs = _blobs()
    for blob in list(blobs.values()) + [b"MATLAB 5.0 MAT-file",
                                        b"\x80\x2a\x5f\xd7", b"LBLSIZE=",
                                        b"L32F" + bytes(12)]:
        assert tio.detect_format(blob) == jio.detect_format(blob)
    assert tio.detect_format(blobs["dpx"]) == "dpx"
    assert tio.detect_format(blobs["dcm"]) == "dcm"


def test_mono_with_size_reads_as_jax(tmp_path):
    _, j = _pair(_pixels(72, 9, 21, 1))
    path = tmp_path / "page.mono"
    path.write_bytes(jio.image_to_blob(j, "mono"))
    for name in (str(path), "mono:" + str(path)):
        _same(tio.read_images(name, size="21x9", device="cpu"),
              jio.read_images(name, size="21x9"))
    with pytest.raises(Exception):
        jio.read_images("mono:" + str(path))
    with pytest.raises(Exception):
        tio.read_images("mono:" + str(path), device="cpu")


def test_write_image_lists_match_jax(tmp_path):
    """A PDF adjoins its pages; a DPX list goes to %d names."""
    pairs = [_pair(_pixels(k, 7, 9, 3)) for k in range(3)]
    for name in ("all.pdf", "f-%d.dpx", "page.g4"):
        tio.write_image([t for t, _ in pairs], str(tmp_path / ("t" + name)))
        jio.write_image([j for _, j in pairs], str(tmp_path / ("j" + name)))
    for name in ("all.pdf", "f-0.dpx", "f-1.dpx", "f-2.dpx", "page.g4"):
        assert (tmp_path / ("t" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()


def test_formats_lists_name_the_new_coders():
    reads, writes = tio.supported_read_formats(), tio.supported_write_formats()
    for fmt in ("dpx", "cin", "dcm", "xcf", "fits", "mat", "viff", "rla",
                "palm", "pict", "g4", "fax", "mono", "sun", "wbmp"):
        assert fmt in reads
    for fmt in ("dpx", "psd", "pdf", "fits", "mat", "viff", "rla", "palm",
                "pict", "g3", "g4", "sun", "otb", "vicar"):
        assert fmt in writes
    for fmt in ("hdr", "strimg"):
        assert fmt in reads and fmt in writes
    assert ("jbig" in reads) == ("jbig" in writes) == tnat.jbig_available()


# -- the CLI ----------------------------------------------------------------

def _png(path, arr):
    from PIL import Image as PImage

    PImage.fromarray((np.clip(arr, 0, 1) * 255 + 0.5).astype(
        np.uint8).squeeze()).save(path)


@pytest.mark.parametrize("prefix", ["fax", "g3", "g4", "mono", "vicar", "vic",
                                    "viff", "xv", "vif", "pict", "pct", "dpx",
                                    "mat", "rla", "psd", "pdf"])
def test_cli_writes_each_prefix_as_jax(tmp_path, prefix):
    """``vif:`` is a prefix of neither CLI: both take the name for an
    input file that is not there (``.vif`` names VIFF)."""
    src = str(tmp_path / "in.png")
    _png(src, _pixels(73, 10, 14, 3, spill=False))
    rcs, outs = [], []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.out"
        rcs.append(main([src, "-flip", f"{prefix}:{out}"]))
        outs.append(out.read_bytes() if rcs[-1] == 0 else None)
    assert rcs == [int(prefix == "vif")] * 2 and outs[0] == outs[1]
    if prefix == "vif":
        for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                           ("j", jm.main)):
            assert main([src, "-flip", str(tmp_path / f"{side}.vif")]) == 0
        assert (tmp_path / "t.vif").read_bytes() == \
            (tmp_path / "j.vif").read_bytes()


@pytest.mark.parametrize("prefix,kind", [
    ("fax", "fax"), ("g3", "g3"), ("g4", "g4"), ("dcm", "dcm"),
    ("dicom", "dcm"), ("vicar", "vicar"), ("vic", "vicar"),
    ("viff", "viff"), ("xv", "viff"), ("pict", "pict"), ("pct", "pict"),
    ("mono", "mono")])
def test_cli_reads_each_prefix_as_jax(tmp_path, prefix, kind):
    blobs = _blobs()
    blob = blobs.get(kind)
    size = []
    if kind == "mono":
        _, j = _pair(_pixels(74, 9, 21, 1))
        blob, size = jio.image_to_blob(j, "mono"), ["-size", "21x9"]
    src = tmp_path / "in.bin"
    src.write_bytes(blob)
    outs = []
    for side, main in (("t", lambda a: tm.main(a, device="cpu")),
                       ("j", jm.main)):
        out = tmp_path / f"{side}.pgm"
        assert main(size + [f"{prefix}:{src}", "-negate", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_still_unported_coders_raise_naming_their_entry(tmp_path):
    """The coders that were still unported here now write the JAX bytes
    (MATTE of an image without alpha raises its ValueError, JBIG's where
    libjbig is missing), and a cut WMF raises the JAX ValueError."""
    t, j = _pair(_pixels(75, 4, 4, 3))
    for fmt in ("hdr", "jbig", "matte", "strimg"):
        try:
            want = jio.image_to_blob(j, fmt)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:20]):
                tio.image_to_blob(t, fmt)
        else:
            assert tio.image_to_blob(t, fmt) == want
    raw = tmp_path / "x.wmf"
    raw.write_bytes(b"\xd7\xcd\xc6\x9a" + bytes(32))
    for mod, kw in ((jio, {}), (tio, {"device": "cpu"})):
        with pytest.raises(ValueError, match="WMF: truncated header"):
            mod.read_images(str(raw), **kw)
