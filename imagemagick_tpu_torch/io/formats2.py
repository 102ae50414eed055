"""Film, print and interchange formats: DPX, CIN, DICOM, XCF, PSD, PDF,
FITS, WBMP, AVS, MTV, FL32, VICAR, SUN, OTB, MONO and the fax images.

Port of ``imagemagick_tpu/io/formats2.py``: numpy re-implementations of
the wire formats of ImageMagick's coders, from the specs they cite:

  DPX    read/write  (coders/dpx.c, SMPTE 268M-2003)
  CIN    read        (coders/cin.c, Kodak Cineon 4.5)
  DCM    read        (coders/dcm.c, DICOM PS3.10 subset)
  XCF    read        (coders/xcf.c, GIMP xcf up to v011)
  PSD    write       (coders/psd.c, merged-image documents)
  PDF    write       (coders/pdf.c's write side; here a native
                      Flate-image PDF, no ghostscript needed)
  FITS   read/write  (coders/fits.c, 2880-byte cards)
  WBMP   read/write  (coders/wbmp.c, WAP type-0)
  AVS    read/write  (coders/avs.c, w/h + ARGB)
  MTV    read/write  (coders/mtv.c, ray-tracer RGB)
  FL32   read/write  (coders/fl32.c, krita float raster)
  VICAR  read/write  (coders/vicar.c, labeled raster)
  SUN    read/write  (coders/sun.c, rasterfiles of types 0-3)
  OTB    read/write  (coders/otb.c, Nokia on-the-air bitmap)
  MONO   read/write  (coders/mono.c, raw 1-bit LSB rows, with -size)
  FAX    read/write  (coders/fax.c: raw G3 and G4 streams, ``utils/fax.py``)

Everything here is host code, as in the JAX module: the bytes are parsed
and packed with numpy, struct and zlib, a DICOM's window is normalized in
float64 and an XCF's layers are composited in numpy.  A decoded image goes
to ``device`` once (the card unless the caller asks for the CPU); an
encoded one comes to the host once and is quantized there with the JAX
module's expressions.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..core.image import Image
from ..core.spec import ImageSpec


def _f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# DPX (SMPTE 268M) — 8/10/12/16-bit RGB(A)/luma, packing 0/1, both endians
# ---------------------------------------------------------------------------

_DPX_DESCRIPTOR_CH = {6: 1, 50: 3, 51: 4, 52: 4}  # luma, RGB, RGBA, ABGR


def decode_dpx(data: bytes, device="cuda") -> Image:
    magic = data[:4]
    if magic == b"SDPX":
        bo = ">"
    elif magic == b"XPDS":
        bo = "<"
    else:
        raise ValueError("not a DPX stream")
    u32 = lambda off: struct.unpack_from(bo + "I", data, off)[0]
    u16 = lambda off: struct.unpack_from(bo + "H", data, off)[0]
    width = u32(772)
    height = u32(776)
    el = 780  # first image element
    descriptor = data[el + 20]
    bits = data[el + 23]
    packing = u16(el + 24)
    offset = u32(el + 28)
    if offset in (0, 0xFFFFFFFF):
        offset = u32(4)
    ch = _DPX_DESCRIPTOR_CH.get(descriptor)
    if ch is None:
        raise ValueError(f"DPX descriptor {descriptor} unsupported")
    n = width * height * ch
    if bits == 8:
        arr = np.frombuffer(data, np.uint8, n, offset).astype(np.float32) / 255.0
    elif bits == 16:
        arr = np.frombuffer(data, bo + "u2", n, offset).astype(np.float32) / 65535.0
    elif bits == 10 and packing == 1:
        # method A: 3 samples left-justified in each 32-bit word (bits 31..2)
        nwords = -(-n // 3)
        words = np.frombuffer(data, bo + "u4", nwords, offset).astype(np.uint32)
        s0 = (words >> 22) & 0x3FF
        s1 = (words >> 12) & 0x3FF
        s2 = (words >> 2) & 0x3FF
        arr = np.stack([s0, s1, s2], -1).reshape(-1)[:n].astype(np.float32) / 1023.0
    elif bits == 10 and packing == 0:
        bits_arr = np.unpackbits(np.frombuffer(
            data, np.uint8, -(-(n * 10) // 8), offset))
        arr = bits_arr[: n * 10].reshape(n, 10)
        arr = (arr * (1 << np.arange(9, -1, -1))).sum(1).astype(np.float32) / 1023.0
    elif bits == 12 and packing == 1:
        # 12-bit filled: one sample per 16-bit word, left-justified
        words = np.frombuffer(data, bo + "u2", n, offset)
        arr = ((words >> 4) & 0xFFF).astype(np.float32) / 4095.0
    else:
        raise ValueError(f"DPX bits={bits} packing={packing} unsupported")
    arr = arr.reshape(height, width, ch)
    if descriptor == 52:  # ABGR
        arr = arr[..., ::-1]
    return Image(arr, ImageSpec(colorspace="srgb" if ch >= 3 else "gray",
                                alpha=(ch == 4), depth=16), device=device)


def encode_dpx(img: Image, bits: int = 10) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    if c == 2:
        arr, c = arr[..., :1], 1
    if c == 1:
        descriptor = 6
    elif c == 3:
        descriptor = 50
    elif c == 4:
        descriptor = 51
    else:
        raise ValueError("DPX supports 1/3/4 channels")
    offset = 8192
    head = bytearray(offset)
    struct.pack_into(">4s", head, 0, b"SDPX")
    struct.pack_into(">I", head, 4, offset)
    struct.pack_into("8s", head, 8, b"V2.0\0\0\0\0")
    struct.pack_into(">I", head, 24, 768)      # generic section size
    struct.pack_into(">I", head, 28, 384)      # industry
    struct.pack_into(">I", head, 32, 0)        # user
    struct.pack_into("100s", head, 36, b"imagemagick_tpu.dpx")
    struct.pack_into(">H", head, 768, 0)       # orientation
    struct.pack_into(">H", head, 770, 1)       # one element
    struct.pack_into(">I", head, 772, w)
    struct.pack_into(">I", head, 776, h)
    el = 780
    struct.pack_into(">I", head, el + 4, 0)            # ref low
    struct.pack_into(">I", head, el + 12, (1 << bits) - 1)
    head[el + 20] = descriptor
    head[el + 21] = 2                                   # transfer: linear
    head[el + 22] = 2
    head[el + 23] = bits
    struct.pack_into(">H", head, el + 24, 1 if bits == 10 else 0)
    struct.pack_into(">I", head, el + 28, offset)
    n = w * h * c
    if bits == 10:
        q = (arr.reshape(-1) * 1023.0 + 0.5).astype(np.uint32)
        pad = (-len(q)) % 3
        if pad:
            q = np.concatenate([q, np.zeros(pad, np.uint32)])
        q = q.reshape(-1, 3)
        words = (q[:, 0] << 22) | (q[:, 1] << 12) | (q[:, 2] << 2)
        payload = words.astype(">u4").tobytes()
    elif bits == 16:
        payload = (arr.reshape(-1) * 65535.0 + 0.5).astype(">u2").tobytes()
    else:
        payload = (arr.reshape(-1) * 255.0 + 0.5).astype(np.uint8).tobytes()
    struct.pack_into(">I", head, 16, offset + len(payload))  # file size
    return bytes(head) + payload


# ---------------------------------------------------------------------------
# Cineon (CIN) — 10-bit filled RGB film scans
# ---------------------------------------------------------------------------

def decode_cin(data: bytes, device="cuda") -> Image:
    if data[:4] == b"\x80\x2a\x5f\xd7":
        bo = ">"
    elif data[:4] == b"\xd7\x5f\x2a\x80":
        bo = "<"
    else:
        raise ValueError("not a Cineon stream")
    image_offset = struct.unpack_from(bo + "I", data, 4)[0]
    nch = data[193]
    channels = []
    off = 194
    for _ in range(min(nch, 8)):
        bits = data[off + 3]
        ppl = struct.unpack_from(bo + "I", data, off + 4)[0]
        lpi = struct.unpack_from(bo + "I", data, off + 8)[0]
        channels.append((bits, ppl, lpi))
        off += 28
    bits, w, h = channels[0]
    n = w * h * nch
    if bits == 10:
        nwords = -(-n // 3)
        words = np.frombuffer(data, bo + "u4", nwords, image_offset)
        s0 = (words >> 22) & 0x3FF
        s1 = (words >> 12) & 0x3FF
        s2 = (words >> 2) & 0x3FF
        arr = np.stack([s0, s1, s2], -1).reshape(-1)[:n].astype(np.float32) / 1023.0
    elif bits == 8:
        arr = np.frombuffer(data, np.uint8, n, image_offset).astype(np.float32) / 255.0
    else:
        raise ValueError(f"Cineon bits={bits} unsupported")
    arr = arr.reshape(h, w, nch)
    return Image(arr, ImageSpec(colorspace="srgb" if nch >= 3 else "gray",
                                depth=16), device=device)


# ---------------------------------------------------------------------------
# DICOM (DCM) — uncompressed little-endian single-frame subset
# ---------------------------------------------------------------------------

_DCM_EXPLICIT_LONG = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL"}


def decode_dcm(data: bytes, device="cuda") -> Image:
    pos = 0
    if data[128:132] == b"DICM":
        pos = 132
    elems = {}
    explicit = True
    # sniff: explicit VR has two uppercase letters after the first tag
    vr_probe = data[pos + 4:pos + 6]
    explicit = vr_probe.isalpha() and vr_probe.isupper()
    pixel_data = None
    n = len(data)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", data, pos)
        pos += 4
        if explicit:
            vr = data[pos:pos + 2]
            if vr in _DCM_EXPLICIT_LONG:
                length = struct.unpack_from("<I", data, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", data, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            raise ValueError("DICOM: encapsulated/compressed pixel data "
                             "unsupported")
        if (group, elem) == (0x7FE0, 0x0010):
            pixel_data = data[pos:pos + length]
            pos += length
            break
        elems[(group, elem)] = data[pos:pos + length]
        pos += length

    def _int(tag, default=None):
        raw = elems.get(tag)
        if raw is None:
            return default
        if len(raw) == 2:
            return struct.unpack("<H", raw)[0]
        try:
            return int(raw.decode("ascii").strip("\0 "))
        except (ValueError, UnicodeDecodeError):
            return struct.unpack("<I", raw[:4])[0]

    rows = _int((0x0028, 0x0010))
    cols = _int((0x0028, 0x0011))
    if not rows or not cols or pixel_data is None:
        raise ValueError("DICOM: missing image geometry or pixel data")
    bits_alloc = _int((0x0028, 0x0100), 16)
    samples = _int((0x0028, 0x0002), 1)
    signed = _int((0x0028, 0x0103), 0) == 1
    photometric = elems.get((0x0028, 0x0004), b"MONOCHROME2").decode(
        "ascii", "replace").strip("\0 ")
    dt = {8: np.uint8, 16: np.int16 if signed else np.uint16,
          32: np.int32 if signed else np.uint32}[bits_alloc]
    arr = np.frombuffer(pixel_data, dt, rows * cols * samples).astype(np.float64)
    slope = float(elems.get((0x0028, 0x1053), b"1").decode("ascii",
                                                           "replace") or 1)
    inter = float(elems.get((0x0028, 0x1052), b"0").decode("ascii",
                                                           "replace") or 0)
    arr = arr * slope + inter
    lo, hi = arr.min(), arr.max()
    arr = (arr - lo) / max(hi - lo, 1e-12)
    if photometric == "MONOCHROME1":
        arr = 1.0 - arr
    arr = arr.reshape(rows, cols, samples).astype(np.float32)
    return Image(arr, ImageSpec(colorspace="gray" if samples == 1 else "srgb",
                                depth=16), device=device)


# ---------------------------------------------------------------------------
# GIMP XCF — read, layers composited with normal blending
# ---------------------------------------------------------------------------

def _xcf_rle_decode(data: bytes, pos: int, out_len: int) -> Tuple[bytes, int]:
    out = bytearray()
    while len(out) < out_len:
        b = data[pos]; pos += 1
        if b <= 126:
            out += data[pos:pos + 1] * (b + 1); pos += 1
        elif b == 127:
            cnt = (data[pos] << 8) | data[pos + 1]; pos += 2
            out += data[pos:pos + 1] * cnt; pos += 1
        elif b == 128:
            cnt = (data[pos] << 8) | data[pos + 1]; pos += 2
            out += data[pos:pos + cnt]; pos += cnt
        else:
            cnt = 256 - b
            out += data[pos:pos + cnt]; pos += cnt
    return bytes(out[:out_len]), pos


def decode_xcf(data: bytes, device="cuda") -> Image:
    if not data.startswith(b"gimp xcf "):
        raise ValueError("not an XCF stream")
    tag = data[9:13]
    version = 0 if tag == b"file" else int(tag[1:4])
    pos = 14
    u32 = lambda p: struct.unpack_from(">I", data, p)[0]
    width, height, base_type = struct.unpack_from(">III", data, pos)
    pos += 12
    if version >= 4:
        precision = u32(pos); pos += 4
        if precision not in (100, 150):   # 8-bit int (linear/gamma)
            raise ValueError(f"XCF precision {precision} unsupported")
    ptr_size = 8 if version >= 11 else 4
    rdptr = (lambda p: struct.unpack_from(">Q", data, p)[0]) if ptr_size == 8 \
        else u32
    # image properties
    while True:
        ptype, plen = struct.unpack_from(">II", data, pos)
        pos += 8
        if ptype == 0:
            break
        pos += plen
    layer_offsets = []
    while True:
        off = rdptr(pos); pos += ptr_size
        if off == 0:
            break
        layer_offsets.append(off)

    canvas = np.zeros((height, width, 4), np.float32)

    def read_string(p):
        ln = u32(p)
        return data[p + 4:p + 4 + max(ln - 1, 0)], p + 4 + ln

    for off in reversed(layer_offsets):   # bottom layer first
        lw, lh, ltype = struct.unpack_from(">III", data, off)
        p = off + 12
        _, p = read_string(p)
        opacity, visible, ox, oy = 1.0, True, 0, 0
        while True:
            ptype, plen = struct.unpack_from(">II", data, p)
            p += 8
            if ptype == 0:
                break
            if ptype == 6:      # PROP_OPACITY
                opacity = u32(p) / 255.0
            elif ptype == 8:    # PROP_VISIBLE
                visible = u32(p) != 0
            elif ptype == 15:   # PROP_OFFSETS
                ox, oy = struct.unpack_from(">ii", data, p)
            elif ptype == 33:   # PROP_FLOAT_OPACITY
                opacity = struct.unpack_from(">f", data, p)[0]
            p += plen
        hier_off = rdptr(p)
        # hierarchy: width, height, bpp, level offsets
        hw, hh, bpp = struct.unpack_from(">III", data, hier_off)
        lvl_off = rdptr(hier_off + 12)
        # level: width, height, tile offsets
        tw_total, th_total = struct.unpack_from(">II", data, lvl_off)
        tp = lvl_off + 8
        tile_offsets = []
        while True:
            toff = rdptr(tp); tp += ptr_size
            if toff == 0:
                break
            tile_offsets.append(toff)
        ntx = -(-hw // 64)
        nty = -(-hh // 64)
        plane = np.zeros((hh, hw, bpp), np.uint8)
        for ti, toff in enumerate(tile_offsets):
            ty, tx = divmod(ti, ntx)
            tile_w = min(64, hw - tx * 64)
            tile_h = min(64, hh - ty * 64)
            count = tile_w * tile_h
            if version == 0:
                raw = data[toff:toff + count * bpp]
                tile = np.frombuffer(raw, np.uint8).reshape(tile_h, tile_w, bpp)
            else:
                chans = []
                pp = toff
                for _ in range(bpp):
                    raw, pp = _xcf_rle_decode(data, pp, count)
                    chans.append(np.frombuffer(raw, np.uint8))
                tile = np.stack(chans, -1).reshape(tile_h, tile_w, bpp)
            plane[ty * 64:ty * 64 + tile_h, tx * 64:tx * 64 + tile_w] = tile
        if not visible:
            continue
        f = plane.astype(np.float32) / 255.0
        if ltype in (0, 1):       # RGB(A)
            rgb = f[..., :3]
            a = f[..., 3:4] if ltype == 1 else np.ones_like(f[..., :1])
        elif ltype in (2, 3):     # gray(A)
            rgb = np.repeat(f[..., :1], 3, -1)
            a = f[..., 1:2] if ltype == 3 else np.ones_like(f[..., :1])
        else:
            raise ValueError("XCF indexed layers unsupported")
        a = a * opacity
        # composite onto canvas at (ox, oy), normal mode
        x0, y0 = max(ox, 0), max(oy, 0)
        x1 = min(ox + hw, width)
        y1 = min(oy + hh, height)
        if x1 <= x0 or y1 <= y0:
            continue
        sx, sy = x0 - ox, y0 - oy
        sub_rgb = rgb[sy:sy + (y1 - y0), sx:sx + (x1 - x0)]
        sub_a = a[sy:sy + (y1 - y0), sx:sx + (x1 - x0)]
        dst = canvas[y0:y1, x0:x1]
        out_a = sub_a + dst[..., 3:4] * (1 - sub_a)
        safe = np.where(out_a < 1e-6, 1.0, out_a)
        out_rgb = (sub_rgb * sub_a + dst[..., :3] * dst[..., 3:4] *
                   (1 - sub_a)) / safe
        canvas[y0:y1, x0:x1, :3] = out_rgb
        canvas[y0:y1, x0:x1, 3:4] = out_a
    return Image(canvas, ImageSpec(colorspace="srgb", alpha=True, depth=8),
                 device=device)


# ---------------------------------------------------------------------------
# PSD write — single merged image, RAW (uncompressed) channels
# ---------------------------------------------------------------------------

def encode_psd(img: Image, depth: int = 8) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    gray = c <= 2
    mode = 1 if gray else 3   # grayscale / RGB
    out = bytearray()
    out += b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w,
                                 16 if depth > 8 else 8, mode)
    out += struct.pack(">I", 0)   # color mode data
    out += struct.pack(">I", 0)   # image resources
    out += struct.pack(">I", 0)   # layer & mask info
    out += struct.pack(">H", 0)   # compression: raw
    if depth > 8:
        q = (arr * 65535.0 + 0.5).astype(">u2")
    else:
        q = (arr * 255.0 + 0.5).astype(np.uint8)
    for ch in range(c):           # planar channel order
        out += q[..., ch].tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# PDF write — one Flate-compressed RGB image XObject per page
# ---------------------------------------------------------------------------

def encode_pdf(images) -> bytes:
    if isinstance(images, Image):
        images = [images]
    objs: List[bytes] = []

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    page_ids = []
    catalog_id = add(b"<< /Type /Catalog /Pages 2 0 R >>")
    pages_id = add(b"")  # patched later
    for img in images:
        arr = np.clip(img.to_numpy(), 0.0, 1.0)
        if arr.ndim == 4:
            arr = arr[0]
        h, w, c = arr.shape
        rgb = arr[..., :3] if c >= 3 else np.repeat(arr[..., :1], 3, -1)
        raw = (rgb * 255.0 + 0.5).astype(np.uint8).tobytes()
        stream = zlib.compress(raw, 6)
        im_id = add(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d"
                    b" /ColorSpace /DeviceRGB /BitsPerComponent 8"
                    b" /Filter /FlateDecode /Length %d >>\nstream\n"
                    % (w, h, len(stream)) + stream + b"\nendstream")
        content = (b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h))
        ct_id = add(b"<< /Length %d >>\nstream\n" % len(content) + content
                    + b"\nendstream")
        pg_id = add(b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d]"
                    b" /Resources << /XObject << /Im0 %d 0 R >> >>"
                    b" /Contents %d 0 R >>" % (w, h, im_id, ct_id))
        page_ids.append(pg_id)
    objs[1] = (b"<< /Type /Pages /Kids [" +
               b" ".join(b"%d 0 R" % p for p in page_ids) +
               b"] /Count %d >>" % len(page_ids))
    out = bytearray(b"%PDF-1.4\n")
    offsets = [0]
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 %d\n" % (len(objs) + 1)
    out += b"0000000000 65535 f \n"
    for off in offsets[1:]:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, xref_at))
    return bytes(out)


# ---------------------------------------------------------------------------
# FITS — BITPIX 8/16/-32, NAXIS 2/3
# ---------------------------------------------------------------------------

def _fits_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        return f"{key:<8}= {v:>20}".ljust(80).encode()
    if isinstance(value, (int, float)):
        return f"{key:<8}= {value:>20}".ljust(80).encode()
    return f"{key:<8}= '{value}'".ljust(80).encode()


def encode_fits(img: Image, depth: int = 16) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    cards = [_fits_card("SIMPLE", True), _fits_card("BITPIX", 16),
             _fits_card("NAXIS", 2 if c == 1 else 3),
             _fits_card("NAXIS1", w), _fits_card("NAXIS2", h)]
    if c > 1:
        cards.append(_fits_card("NAXIS3", c))
    cards.append(_fits_card("BZERO", 32768))
    cards.append(_fits_card("BSCALE", 1))
    cards.append("END".ljust(80).encode())
    head = b"".join(cards)
    head += b" " * ((-len(head)) % 2880)
    # FITS rows bottom-up; planes last axis first
    q = (arr * 65535.0 + 0.5).astype(np.int64) - 32768
    q = q[::-1]  # bottom-up
    planes = np.moveaxis(q, -1, 0)  # (c, h, w)
    payload = planes.astype(">i2").tobytes()
    payload += b"\0" * ((-len(payload)) % 2880)
    return head + payload


def decode_fits(data: bytes, device="cuda") -> Image:
    if not data.startswith(b"SIMPLE"):
        raise ValueError("not a FITS stream")
    cards = {}
    pos = 0
    while pos < len(data):
        card = data[pos:pos + 80].decode("ascii", "replace")
        pos += 80
        key = card[:8].strip()
        if key == "END":
            pos = -(-pos // 2880) * 2880
            break
        if "=" in card:
            cards[key] = card.split("=", 1)[1].split("/")[0].strip()
    bitpix = int(cards.get("BITPIX", "8"))
    naxis = int(cards.get("NAXIS", "2"))
    w = int(cards.get("NAXIS1", "0"))
    h = int(cards.get("NAXIS2", "0"))
    c = int(cards.get("NAXIS3", "1")) if naxis >= 3 else 1
    bzero = float(cards.get("BZERO", "0"))
    bscale = float(cards.get("BSCALE", "1"))
    dt = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    arr = np.frombuffer(data, dt, w * h * c, pos).astype(np.float64)
    arr = arr * bscale + bzero
    if bitpix > 0:
        # integer data: the reference maps over the full pixel range
        # (fits.c:470 GetFITSPixelRange), no data-extrema stretch — this
        # also makes 16-bit round trips exact
        arr = arr / float((1 << bitpix) - 1)
        arr = np.clip(arr, 0.0, 1.0)
    else:
        # float data: normalize by extrema (fits.c:463 GetFITSPixelExtrema)
        lo, hi = arr.min(), arr.max()
        arr = (arr - lo) / max(hi - lo, 1e-12)
    arr = arr.reshape(c, h, w) if naxis >= 3 else arr.reshape(1, h, w)
    arr = np.moveaxis(arr, 0, -1)[::-1]  # bottom-up -> top-down
    return Image(arr.astype(np.float32),
                 ImageSpec(colorspace="gray" if c == 1 else "srgb", depth=16),
                 device=device)


# ---------------------------------------------------------------------------
# WBMP (WAP type 0)
# ---------------------------------------------------------------------------

def _wbmp_multibyte(value: int) -> bytes:
    out = bytearray([value & 0x7F])
    value >>= 7
    while value:
        out.insert(0, 0x80 | (value & 0x7F))
        value >>= 7
    return bytes(out)


def _wbmp_read_multibyte(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    while True:
        b = data[pos]; pos += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, pos


def decode_wbmp(data: bytes, device="cuda") -> Image:
    if data[0] != 0 or data[1] != 0:
        raise ValueError("not a type-0 WBMP")
    w, pos = _wbmp_read_multibyte(data, 2)
    h, pos = _wbmp_read_multibyte(data, pos)
    stride = -(-w // 8)
    bits = np.unpackbits(np.frombuffer(data, np.uint8, stride * h, pos)
                         .reshape(h, stride), axis=1)[:, :w]
    return Image(bits.astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_wbmp(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    bits = (gray >= 0.5).astype(np.uint8)
    h, w = bits.shape
    packed = np.packbits(bits, axis=1)
    return (b"\x00\x00" + _wbmp_multibyte(w) + _wbmp_multibyte(h)
            + packed.tobytes())


# ---------------------------------------------------------------------------
# AVS X (w, h big-endian + ARGB bytes)
# ---------------------------------------------------------------------------

def decode_avs(data: bytes, device="cuda") -> Image:
    w, h = struct.unpack_from(">II", data, 0)
    arr = np.frombuffer(data, np.uint8, w * h * 4, 8).reshape(h, w, 4)
    rgba = np.concatenate([arr[..., 1:], arr[..., :1]], -1)
    return Image(rgba.astype(np.float32) / 255.0,
                 ImageSpec(colorspace="srgb", alpha=True, depth=8),
                 device=device)


def encode_avs(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    if c < 4:
        pad = [np.ones((h, w, 1), arr.dtype)] if c == 3 else \
            [np.repeat(arr[..., :1], 3 - c + 1, -1)]
        arr = np.concatenate([arr] + ([pad[0]] if c == 3 else pad), -1)[..., :4]
    q = (arr * 255.0 + 0.5).astype(np.uint8)
    argb = np.concatenate([q[..., 3:4], q[..., :3]], -1)
    return struct.pack(">II", w, h) + argb.tobytes()


# ---------------------------------------------------------------------------
# MTV ray tracer (ASCII "W H\n" + RGB bytes)
# ---------------------------------------------------------------------------

def decode_mtv(data: bytes, device="cuda") -> Image:
    nl = data.index(b"\n")
    w, h = (int(v) for v in data[:nl].split())
    arr = np.frombuffer(data, np.uint8, w * h * 3, nl + 1).reshape(h, w, 3)
    return Image(arr.astype(np.float32) / 255.0, ImageSpec(depth=8),
                 device=device)


def encode_mtv(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    rgb = arr[..., :3] if c >= 3 else np.repeat(arr[..., :1], 3, -1)
    return (f"{w} {h}\n".encode()
            + (rgb * 255.0 + 0.5).astype(np.uint8).tobytes())


# ---------------------------------------------------------------------------
# FL32 (krita float raster: magic, w, h, channels; f32 LE)
# ---------------------------------------------------------------------------

def decode_fl32(data: bytes, device="cuda") -> Image:
    magic, w, h, c = struct.unpack_from("<4sIII", data, 0)
    if magic != b"23lf"[::-1] and magic != b"fl32" and magic != b"FL32":
        # reference uses 0x5a32334c 'L32Z'? accept our own magic too
        if magic != b"L32F":
            raise ValueError("not an FL32 stream")
    arr = np.frombuffer(data, "<f4", w * h * c, 16).reshape(h, w, c)
    return Image(arr.astype(np.float32),
                 ImageSpec(colorspace="gray" if c == 1 else "srgb",
                           alpha=(c in (2, 4)), depth=16), device=device)


def encode_fl32(img: Image) -> bytes:
    arr = img.to_numpy().astype("<f4")
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    return struct.pack("<4sIII", b"L32F", w, h, c) + arr.tobytes()


# ---------------------------------------------------------------------------
# VICAR (JPL labeled raster)
# ---------------------------------------------------------------------------

def decode_vicar(data: bytes, device="cuda") -> Image:
    head = data[:40].decode("ascii", "replace")
    m = re.match(r"LBLSIZE=(\d+)", head)
    if not m:
        raise ValueError("not a VICAR stream")
    lblsize = int(m.group(1))
    label = data[:lblsize].decode("ascii", "replace")

    def field(key, default=None):
        mm = re.search(rf"\b{key}=([^\s]+)", label)
        return mm.group(1).strip("'") if mm else default

    nl = int(field("NL", "0"))
    ns = int(field("NS", "0"))
    fmt = field("FORMAT", "BYTE")
    dt = {"BYTE": ("u1", 255.0), "HALF": ("<i2", 32767.0),
          "FULL": ("<i4", 2147483647.0), "REAL": ("<f4", 1.0)}[fmt]
    arr = np.frombuffer(data, dt[0], nl * ns, lblsize).astype(np.float32)
    arr = arr.reshape(nl, ns, 1) / dt[1]
    return Image(np.clip(arr, 0.0, 1.0), ImageSpec(colorspace="gray", depth=8),
                 device=device)


def encode_vicar(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    h, w = gray.shape
    label = (f"LBLSIZE=0  FORMAT='BYTE'  TYPE='IMAGE'  ORG='BSQ'  "
             f"NL={h}  NS={w}  NB=1  N1={w}  N2={h}  N3=1")
    lblsize = -(-(len(label) + 20) // 16) * 16
    label = f"LBLSIZE={lblsize}" + label[len(f"LBLSIZE=0"):]
    label = label.ljust(lblsize)
    return label.encode() + (gray * 255.0 + 0.5).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# SUN rasterfile write (type 1, 24-bit BGR; PIL reads it back)
# ---------------------------------------------------------------------------

def encode_sun(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    rgb = arr[..., :3] if c >= 3 else np.repeat(arr[..., :1], 3, -1)
    q = (rgb * 255.0 + 0.5).astype(np.uint8)[..., ::-1]  # BGR
    row = q.reshape(h, w * 3)
    if (w * 3) % 2:
        row = np.concatenate([row, np.zeros((h, 1), np.uint8)], 1)
    payload = row.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, 24, len(payload), 1, 0, 0) \
        + payload


def decode_sun(data: bytes, device="cuda") -> Image:
    """SUN rasterfile read (coders/sun.c): types 0/1 (standard/old) and 2
    (byte-RLE), depths 1/8/24/32, optional RGB colormap, rows padded to
    16 bits."""
    if len(data) < 32:
        raise ValueError("SUN: truncated header")
    magic, w, h, depth, length, rtype, maptype, maplen = struct.unpack(
        ">8I", data[:32])
    if magic != 0x59A66A95:
        raise ValueError("SUN: bad magic")
    if w == 0 or h == 0 or depth not in (1, 8, 24, 32):
        raise ValueError("SUN: unsupported geometry/depth")
    pos = 32
    cmap = None
    if maptype and maplen:
        if maptype == 1 and maplen % 3 == 0:          # RGB planes
            n = maplen // 3
            raw = np.frombuffer(data, np.uint8, maplen, pos)
            cmap = np.stack([raw[:n], raw[n:2 * n], raw[2 * n:]], -1)
        pos += maplen
    if depth == 1:
        stride = ((w + 15) // 16) * 2
    elif depth == 8:
        stride = w + (w & 1)
    else:
        bpp = depth // 8
        stride = w * bpp + ((w * bpp) & 1)
    need = stride * h
    if rtype == 2:                                     # RT_BYTE_ENCODED
        out = bytearray()
        i = pos
        n = len(data)
        while len(out) < need and i < n:
            b = data[i]
            i += 1
            if b == 0x80:
                if i >= n:
                    break
                cnt = data[i]
                i += 1
                if cnt == 0:
                    out.append(0x80)
                else:
                    if i >= n:
                        break
                    out += bytes([data[i]]) * (cnt + 1)
                    i += 1
            else:
                out.append(b)
        raw = bytes(out[:need].ljust(need, b"\0"))
    else:
        if len(data) < pos + need:
            raise ValueError("SUN: truncated pixel data")
        raw = data[pos:pos + need]
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    if depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        arr = (1.0 - bits).astype(np.float32)[..., None]   # 1 = black
        return Image(arr, ImageSpec(colorspace="gray", depth=1), device=device)
    if depth == 8:
        idx = rows[:, :w]
        if cmap is not None:
            arr = cmap[np.minimum(idx, len(cmap) - 1)].astype(
                np.float32) / 255.0
            return Image(arr, ImageSpec(colorspace="srgb"), device=device)
        return Image((idx.astype(np.float32) / 255.0)[..., None],
                     ImageSpec(colorspace="gray"), device=device)
    bpp = depth // 8
    px = rows[:, :w * bpp].reshape(h, w, bpp)
    if depth == 32:
        if rtype == 3:  # RT_FORMAT_RGB: x-R-G-B, already in order
            arr = px[..., 1:].astype(np.float32) / 255.0
        else:           # types 0/1/2: x-B-G-R (alpha byte first)
            arr = px[..., :0:-1].astype(np.float32) / 255.0
    elif rtype == 3:
        # RT_FORMAT_RGB is already RGB — no channel swap
        arr = px.astype(np.float32) / 255.0
    else:
        # BGR for types 0/1/2
        arr = px[..., ::-1].astype(np.float32) / 255.0
    return Image(arr.astype(np.float32), ImageSpec(colorspace="srgb"),
                 device=device)


# ---------------------------------------------------------------------------
# OTB (Nokia on-the-air bitmap) and MONO (raw 1-bit LSB)
# ---------------------------------------------------------------------------

def decode_otb(data: bytes, device="cuda") -> Image:
    info = data[0]
    if info & 0x10:   # extended dims (u16)
        w = (data[1] << 8) | data[2]
        h = (data[3] << 8) | data[4]
        pos = 6
    else:
        w, h = data[1], data[2]
        pos = 4
    stride = -(-w // 8)
    bits = np.unpackbits(np.frombuffer(data, np.uint8, stride * h, pos)
                         .reshape(h, stride), axis=1)[:, :w]
    # OTB: 1 = black
    return Image((1.0 - bits).astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_otb(img: Image) -> bytes:
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    bits = (gray < 0.5).astype(np.uint8)   # 1 = black
    h, w = bits.shape
    if w > 255 or h > 255:
        head = bytes([0x10, w >> 8, w & 0xFF, h >> 8, h & 0xFF, 1])
    else:
        head = bytes([0, w, h, 1])
    return head + np.packbits(bits, axis=1).tobytes()


def decode_mono(data: bytes, width: int, height: int,
                device="cuda") -> Image:
    """MONO: raw 1-bit LSB-first rows; wire bit 1 = black (coders/mono.c
    ReadMONOImage maps a set bit to colormap index 0 = black)."""
    stride = -(-width // 8)
    packed = np.frombuffer(data, np.uint8, stride * height).reshape(
        height, stride)
    bits = np.unpackbits(packed, axis=1, bitorder="little")[:, :width]
    return Image((1.0 - bits).astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_mono(img: Image) -> bytes:
    """Wire bit 1 = black (coders/mono.c WriteMONOImage: luma < 1/2 sets
    the bit), LSB-first, row-aligned."""
    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    bits = (gray < 0.5).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


# ---------------------------------------------------------------------------
# FAX (raw CCITT Group 3 MH stream, coders/fax.c; codec in utils/fax.py)
# ---------------------------------------------------------------------------

def decode_fax(data: bytes, width: int = 1728, device="cuda") -> Image:
    from ..utils.fax import decode_g3

    bits = decode_g3(data, width)
    # fax: 1 = black
    return Image((1.0 - bits).astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_fax(img: Image) -> bytes:
    from ..utils.fax import encode_g3

    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    return encode_g3((gray < 0.5).astype(np.uint8))


def decode_g4_image(data: bytes, width: int = 1728,
                    device="cuda") -> Image:
    """Raw ITU-T T.6 (Group 4 MMR) bilevel stream (compress.c family)."""
    from ..utils.fax import decode_g4

    bits = decode_g4(data, width)
    return Image((1.0 - bits).astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_g4_image(img: Image) -> bytes:
    from ..utils.fax import encode_g4

    arr = np.clip(img.to_numpy(), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = arr.mean(-1) if arr.shape[-1] > 1 else arr[..., 0]
    return encode_g4((gray < 0.5).astype(np.uint8))
