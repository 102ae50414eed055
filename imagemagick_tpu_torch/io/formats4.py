"""Small raster, video, legacy, text and LUT formats: the fourth batch
of native coders.

Port of ``imagemagick_tpu/io/formats4.py``: numpy re-implementations of
the wire formats of ImageMagick's coders, from the formats they read and
write:

  AAI, HRZ, SCR, RGF, CIP, TXT, INLINE, PGX, VIPS, UYVY, CALS, ART, SCT,
  XWD, the braille family, UIL, HTML, CUBE, TIM, SFW, CUT, RLE, MAC, PIX,
  YUV, BAYER, TIM2, JNX, PES, 16-bit TIFF, DCX, CUR, MAGICK, IPL, MAP,
  FTXT, ASHLAR, EPT, WPG, PWP, MVG, TTF, the stegano: extraction and PDB.

Bytes are parsed and packed on the host with numpy, struct and re, as in
the JAX module, with its expressions, so a decode's float32 pixels and an
encode's bytes are the JAX module's.  A decoded image goes to ``device``
once (the card unless the caller asks for the CPU); an encoded one comes
to the host once and is quantized there.  Five coders run device ops on
the image's device, as ``extra_coders`` does: HRZ's resize to 256x240,
YUV's ``rgb_to_ycbcr``, MAP's and WPG's 256-colour ``kmeans``, and MVG's
``draw`` (on a canvas made on ``device``).  A CUBE LUT's trilinear lookup
and a Bayer mosaic's bilinear demosaic stay numpy on the host, so their
float32 sums keep the JAX module's order.

The loops that the JAX module runs in Python over every line, byte or
opcode (TXT's and FTXT's lines, WPG's run-length rows, RLE's opcodes)
are the port's too: they give its bytes and pixels, and a 1080p WPG's
rows take about half a second.  Two faults of the JAX module are not copied: the WPG
writer's literal runs stop at 127 bytes, where the JAX writer can emit a
run of 128 literals whose count byte reads back as a run opcode, and the
16-bit TIFF reader declines planar samples, which the JAX reader takes
for interleaved ones.
"""

from __future__ import annotations

import base64
import re
import struct
from typing import Optional

import numpy as np
import torch

from ..core.image import Image
from ..core.spec import ImageSpec
from .extra_coders import _on_device


def _flat(img: Image) -> np.ndarray:
    arr = np.asarray(img.to_numpy(), dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    return arr


def _rgb(arr: np.ndarray) -> np.ndarray:
    if arr.shape[-1] in (1, 2):     # gray / gray+alpha
        arr = np.repeat(arr[..., :1], 3, -1)
    return arr[..., :3]


def _colors_alpha(img: Image):
    """Split into (H,W,3) color and optional (H,W) alpha per the spec."""
    arr = _flat(img)
    n = arr.shape[-1]
    has_a = bool(getattr(img.spec, "alpha", False)) and n in (2, 4, 5)
    alpha = arr[..., n - 1] if has_a else None
    color = arr[..., :n - 1] if has_a else arr
    if color.shape[-1] == 1:
        color = np.repeat(color, 3, -1)
    return color[..., :3], alpha


def _luma(arr: np.ndarray) -> np.ndarray:
    """Rec.709 luma (GetPixelLuma, pixel-accessor.h)."""
    rgb = _rgb(arr)
    return 0.212656 * rgb[..., 0] + 0.715158 * rgb[..., 1] + 0.072186 * rgb[..., 2]


def _u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# AAI Dune (aai.c: ReadAAIImage — u32le w,h then BGRA byte rows;
# alpha byte 254 is promoted to 255 on read)
# ---------------------------------------------------------------------------

def decode_aai(data: bytes, device="cuda") -> Image:
    if len(data) < 8:
        raise ValueError("AAI: truncated header")
    w, h = struct.unpack("<II", data[:8])
    if w == 0 or h == 0 or len(data) < 8 + 4 * w * h:
        raise ValueError("AAI: improper image header")
    raw = np.frombuffer(data, np.uint8, 4 * w * h, 8).reshape(h, w, 4)
    bgra = raw.astype(np.float32) / 255.0
    a = raw[..., 3]
    alpha = np.where(a == 254, np.uint8(255), a).astype(np.float32) / 255.0
    rgba = np.stack([bgra[..., 2], bgra[..., 1], bgra[..., 0], alpha], -1)
    return Image(rgba, ImageSpec(colorspace="srgb", alpha=True), device=device)


def encode_aai(img: Image) -> bytes:
    color, a = _colors_alpha(img)
    h, w = color.shape[:2]
    rgb = _u8(color)
    alpha = _u8(a) if a is not None else np.full((h, w), 255, np.uint8)
    bgra = np.stack([rgb[..., 2], rgb[..., 1], rgb[..., 0], alpha], -1)
    return struct.pack("<II", w, h) + bgra.tobytes()


# ---------------------------------------------------------------------------
# HRZ slow-scan TV (hrz.c: fixed 256x240; 6-bit RGB, decoded as 4*v)
# ---------------------------------------------------------------------------

def decode_hrz(data: bytes, device="cuda") -> Image:
    need = 256 * 240 * 3
    if len(data) < need:
        raise ValueError("HRZ: expected %d bytes" % need)
    raw = np.frombuffer(data, np.uint8, need).reshape(240, 256, 3)
    arr = np.minimum(raw.astype(np.float32) * 4.0, 255.0) / 255.0
    return Image(arr, ImageSpec(colorspace="srgb"), device=device)


def encode_hrz(img: Image) -> bytes:
    arr = _rgb(_flat(img))
    if arr.shape[:2] != (240, 256):
        # HRZ is a fixed-geometry format: resized on the image's device
        from ..ops.resize import resize as _resize

        arr = _rgb(_on_device(
            lambda x: _resize(x[None], 240, 256, "triangle")[0], arr,
            img.data.device))
    return (_u8(arr) // 4).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# ZX Spectrum SCR (scr.c: 6144-byte bitmap in thirds + 768 attribute bytes;
# attr = FBPPPIII; palette value 192, bright -> 255)
# ---------------------------------------------------------------------------

_SCR_LEVELS = (192, 255)


def decode_scr(data: bytes, device="cuda") -> Image:
    if len(data) < 6912:
        raise ValueError("SCR: expected 6912 bytes")
    bitmap = np.frombuffer(data, np.uint8, 6144)
    attrs = np.frombuffer(data, np.uint8, 768, 6144).reshape(24, 32)
    # Spectrum address layout: addr = zone*2048 + octetline*256 + charline*32
    # + col ; y = zone*64 + charline*8 + octetline
    bm = bitmap.reshape(3, 8, 8, 32)          # zone, octetline, charline, col
    bm = bm.transpose(0, 2, 1, 3)             # zone, charline, octetline, col
    bits = np.unpackbits(bm.reshape(-1, 32), axis=1)  # MSB-first -> x order
    pix = bits.reshape(3, 8, 8, 256).reshape(192, 256)
    ink = attrs & 0x07
    paper = (attrs >> 3) & 0x07
    bright = (attrs >> 6) & 0x01
    lvl = np.where(bright == 1, _SCR_LEVELS[1], _SCR_LEVELS[0]).astype(np.float32)
    # 3-bit GRB component order: bit0=blue, bit1=red, bit2=green
    def expand(c3):
        b = (c3 & 1).astype(np.float32)
        r = ((c3 >> 1) & 1).astype(np.float32)
        g = ((c3 >> 2) & 1).astype(np.float32)
        return np.stack([r, g, b], -1) * lvl[..., None] / 255.0

    ink_rgb = expand(ink)
    paper_rgb = expand(paper)
    cell = pix.reshape(24, 8, 32, 8)
    sel = cell.transpose(0, 2, 1, 3).astype(bool)       # (24,32,8,8)
    out = np.where(sel[..., None], ink_rgb[:, :, None, None, :],
                   paper_rgb[:, :, None, None, :])
    out = out.transpose(0, 2, 1, 3, 4).reshape(192, 256, 3)
    return Image(out.astype(np.float32), ImageSpec(colorspace="srgb"),
                 device=device)


# ---------------------------------------------------------------------------
# LEGO Mindstorms EV3 RGF (rgf.c: w,h single bytes; rows of LSB-first 1bpp,
# byte-aligned; wire bit 1 = dark pixel — the writer's convention, which we
# mirror on read for exact round trips)
# ---------------------------------------------------------------------------

def decode_rgf(data: bytes, device="cuda") -> Image:
    if len(data) < 2:
        raise ValueError("RGF: truncated")
    w, h = data[0], data[1]
    if w == 0 or h == 0:
        raise ValueError("RGF: improper header")
    stride = (w + 7) // 8
    if len(data) < 2 + stride * h:
        raise ValueError("RGF: truncated pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, 2).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    arr = (1.0 - bits).astype(np.float32)[..., None]   # 1 = dark
    return Image(arr, ImageSpec(colorspace="gray", depth=1), device=device)


def encode_rgf(img: Image) -> bytes:
    arr = _flat(img)
    h, w = arr.shape[:2]
    if w > 255 or h > 255:
        raise ValueError("RGF supports at most 255x255")
    dark = (_luma(arr) < 0.5).astype(np.uint8)
    return bytes([w, h]) + np.packbits(dark, axis=1, bitorder="little").tobytes()


# ---------------------------------------------------------------------------
# Cisco IP phone CIP (cip.c: XML wrapper; 2-bit luma, 4 px/byte packed
# low-to-high within the byte, hex text; width padded to even)
# ---------------------------------------------------------------------------

def encode_cip(img: Image, title: str = "image") -> bytes:
    arr = _flat(img)
    h, w = arr.shape[:2]
    q = np.minimum((_luma(arr) * 3.0).astype(np.int64), 3).astype(np.uint8)
    pad = (-w) % 4
    if pad:
        q = np.pad(q, ((0, 0), (0, pad)))
    qq = q.reshape(h, -1, 4)
    byte = (qq[..., 0] | (qq[..., 1] << 2) | (qq[..., 2] << 4)
            | (qq[..., 3] << 6)).astype(np.uint8)
    hexdata = byte.tobytes().hex()
    out = ["<CiscoIPPhoneImage>",
           "<Title>%s</Title>" % title,
           "<LocationX>0</LocationX>", "<LocationY>0</LocationY>",
           "<Width>%d</Width>" % (w + (w % 2)),
           "<Height>%d</Height>" % h,
           "<Depth>2</Depth>",
           "<Data>%s</Data>" % hexdata,
           "</CiscoIPPhoneImage>", ""]
    return "\n".join(out).encode()


# ---------------------------------------------------------------------------
# TXT pixel enumeration (txt.c ReadTXTImage: header
# "# ImageMagick pixel enumeration: w,h[,meta],max,colorspace" then
# "x,y: (v,v,v[,v])" lines)
# ---------------------------------------------------------------------------

_TXT_HEADER = re.compile(
    rb"#\s*ImageMagick pixel enumeration:\s*(\d+),(\d+)(?:,(\d+))?,"
    rb"([0-9.eE+-]+),(\w+)")
_TXT_LINE = re.compile(
    rb"^\s*(\d+),(\d+):\s*\(([^)]*)\)")


def decode_txt(data: bytes, device="cuda") -> Image:
    m = _TXT_HEADER.search(data[:512])
    if not m:
        raise ValueError("TXT: no pixel-enumeration header")
    w, h = int(m.group(1)), int(m.group(2))
    maxval = float(m.group(4))
    cs = m.group(5).decode().lower()
    alpha = cs.endswith("a")
    if alpha:
        cs = cs[:-1]
    nch = (1 if cs in ("gray", "grey", "lineargray") else
           4 if cs == "cmyk" else 3) + (1 if alpha else 0)
    arr = np.zeros((h, w, nch), np.float32)
    for line in data.splitlines():
        lm = _TXT_LINE.match(line)
        if not lm:
            continue
        x, y = int(lm.group(1)), int(lm.group(2))
        if x >= w or y >= h:
            continue
        vals = []
        for tok in lm.group(3).split(b","):
            tok = tok.strip()
            if tok.endswith(b"%"):
                vals.append(float(tok[:-1]) / 100.0)
            else:
                vals.append(float(tok) / (maxval if maxval > 0 else 1.0))
        vals = (vals + [0.0] * nch)[:nch]
        arr[y, x] = vals
    spec = ImageSpec(colorspace="gray" if nch - int(alpha) == 1 else
                     ("cmyk" if cs == "cmyk" else "srgb"), alpha=alpha)
    return Image(arr, spec, device=device)


# ---------------------------------------------------------------------------
# INLINE data URI (inline.c: "data:<mime>;base64,<payload>")
# ---------------------------------------------------------------------------

def decode_inline(data: bytes, device="cuda"):
    from . import image_from_blob

    text = data.strip()
    idx = text.find(b"base64,")
    if not text.startswith(b"data:") or idx < 0:
        raise ValueError("INLINE: not a base64 data: URI")
    return image_from_blob(base64.b64decode(text[idx + 7:]),
                           device=device)


def encode_inline(img: Image, inner_fmt: str = "png") -> bytes:
    from . import image_to_blob

    blob = image_to_blob(img, inner_fmt)
    mime = {"png": "image/png", "jpeg": "image/jpeg", "jpg": "image/jpeg",
            "gif": "image/gif", "webp": "image/webp"}.get(
                inner_fmt, "image/" + inner_fmt)
    return b"data:" + mime.encode() + b";base64," + base64.b64encode(blob)


# ---------------------------------------------------------------------------
# PGX (pgx.c — JPEG-2000 verification-model raw gray:
# "PG <ML|LM> <+|-><depth> <width> <height>", big-endian when ML)
# ---------------------------------------------------------------------------

_PGX_HEADER = re.compile(
    rb"PG[ \t]+(ML|LM)[ \t]*([+-]?)[ \t]*(\d+)[ \t]+(\d+)[ \t]+(\d+)")


def decode_pgx(data: bytes, device="cuda") -> Image:
    m = _PGX_HEADER.match(data)
    if not m:
        raise ValueError("PGX: bad header")
    endian = ">" if m.group(1) == b"ML" else "<"
    depth = int(m.group(3))
    w, h = int(m.group(4)), int(m.group(5))
    off = data.index(b"\n", m.start()) + 1
    nbytes = 1 if depth <= 8 else 2
    dt = np.dtype(("u%d" % nbytes)).newbyteorder(endian)
    raw = np.frombuffer(data, dt, w * h, off).reshape(h, w)
    arr = raw.astype(np.float32) / float((1 << depth) - 1)
    return Image(arr[..., None], ImageSpec(colorspace="gray",
                                           depth=min(depth, 16)),
                 device=device)


def encode_pgx(img: Image, depth: int = 8) -> bytes:
    arr = _flat(img)
    gray = _luma(arr) if arr.shape[-1] > 1 else arr[..., 0]
    h, w = gray.shape
    maxv = (1 << depth) - 1
    q = (np.clip(gray, 0.0, 1.0) * maxv + 0.5).astype(
        np.uint8 if depth <= 8 else ">u2")
    header = ("PG ML + %d %d %d\n" % (depth, w, h)).encode()
    return header + q.tobytes()


# ---------------------------------------------------------------------------
# VIPS v4 (vips.c: magic 0x08f2a6b6, 64-byte header, coding NONE,
# band-interleaved pixels, optional trailing XML metadata)
# ---------------------------------------------------------------------------

_VIPS_MAGIC_LSB = 0x08F2A6B6
_VIPS_MAGIC_MSB = 0xB6A6F208

_VIPS_FMT = {0: ("u1", 8), 1: ("i1", 8), 2: ("u2", 16), 3: ("i2", 16),
             4: ("u4", 32), 5: ("i4", 32), 6: ("f4", 32), 8: ("f8", 64)}


def decode_vips(data: bytes, device="cuda") -> Image:
    (magic,) = struct.unpack("<I", data[:4])
    if magic == _VIPS_MAGIC_LSB:
        e = "<"
    elif magic == _VIPS_MAGIC_MSB:
        e = ">"
    else:
        raise ValueError("VIPS: bad magic")
    w, h, bands, _legacy, fmt, coding, vtype = struct.unpack(
        e + "7i", data[4:32])
    if coding != 0:
        raise ValueError("VIPS: only coding NONE supported")
    if fmt not in _VIPS_FMT:
        raise ValueError("VIPS: unsupported band format %d" % fmt)
    if not (1 <= bands <= 5):
        raise ValueError("VIPS: unsupported band count %d" % bands)
    dtype_s, depth = _VIPS_FMT[fmt]
    dt = np.dtype(dtype_s).newbyteorder(e)
    off = 32 + 4 + 4 + 24        # xres,yres floats + 3x8 reserved
    raw = np.frombuffer(data, dt, w * h * bands, off).reshape(h, w, bands)
    if dt.kind == "f":
        arr = raw.astype(np.float32)
    elif dt.kind == "i":
        info = np.iinfo(dt)
        arr = (raw.astype(np.float32) - info.min) / (info.max - info.min)
    else:
        arr = raw.astype(np.float32) / float(np.iinfo(dt).max)
    if vtype == 15:          # CMYK
        cs, alpha = "cmyk", bands == 5
    elif bands in (1, 2):
        cs, alpha = "gray", bands == 2
    else:
        cs, alpha = "srgb", bands in (4, 5) and vtype != 15
    return Image(arr, ImageSpec(colorspace=cs, alpha=alpha,
                                depth=min(depth, 32)), device=device)


def encode_vips(img: Image, depth: int = 8) -> bytes:
    arr = _flat(img)
    h, w, c = arr.shape
    gray = c == 1 or (c == 2 and img.spec.colorspace == "gray")
    if depth <= 8:
        fmt, payload = 0, _u8(arr)
    else:
        fmt = 2
        payload = (np.clip(arr, 0.0, 1.0) * 65535.0 + 0.5).astype("<u2")
    vtype = (26 if gray and depth > 8 else 1) if gray else \
        (25 if depth > 8 else 22)
    head = struct.pack("<I7i", _VIPS_MAGIC_LSB, w, h, c, 0, fmt, 0, vtype)
    head += struct.pack("<2f", 0.0, 0.0) + b"\x00" * 24
    return head + payload.tobytes()


# ---------------------------------------------------------------------------
# CALS Type 1 (cals.c: 16 x 128-byte ASCII records = 2048-byte header,
# then a raw ITU-T T.6 Group-4 stream; MIL-R-28002)
# ---------------------------------------------------------------------------

def decode_cals(data: bytes, device="cuda") -> Image:
    from . import formats2

    if len(data) < 2048:
        raise ValueError("CALS: truncated header")
    width = height = 0
    density = 0
    for i in range(16):
        rec = data[128 * i:128 * (i + 1)].decode("latin-1", "replace")
        low = rec.lower()
        if low.startswith("rpelcnt:"):
            m = re.match(r"\s*(\d+)\s*,\s*(\d+)", rec[8:])
            if m:
                width, height = int(m.group(1)), int(m.group(2))
        elif low.startswith("rdensty:"):
            m = re.match(r"\s*(\d+)", rec[8:])
            if m:
                density = int(m.group(1))
    if width == 0:
        raise ValueError("CALS: missing rpelcnt record")
    img = formats2.decode_g4_image(data[2048:], width, device=device)
    if height and img.data.shape[0] >= height:
        img = Image(img.data[:height], img.spec)
    if density:
        img.properties["density"] = str(density)
    return img


def encode_cals(img: Image) -> bytes:
    from . import formats2

    arr = _flat(img)
    h, w = arr.shape[:2]
    density = int(img.properties.get("density", "200") or 200)
    records = ["srcdocid: NONE", "dstdocid: NONE", "txtfilid: NONE",
               "figid: NONE", "srcgph: NONE", "doccls: NONE", "rtype: 1",
               "rorient: 000,270",
               "rpelcnt: %06d,%06d" % (w, h),
               "rdensty: %04d" % density, "notes: NONE"]
    header = b"".join(r.ljust(128).encode() for r in records)
    header += b" " * 128 * (16 - len(records))
    return header + formats2.encode_g4_image(img)


# ---------------------------------------------------------------------------
# PFS: 1st Publisher ART (art.c: u16le pad/width/pad/height, then
# MSB-first 1bpp gray rows — bit 1 = white — padded to even byte counts)
# ---------------------------------------------------------------------------

def decode_art(data: bytes, device="cuda") -> Image:
    if len(data) < 8:
        raise ValueError("ART: truncated header")
    _, w, _, h = struct.unpack("<4H", data[:8])
    if w == 0 or h == 0:
        raise ValueError("ART: improper header")
    stride = (w + 7) // 8
    padded = stride + (stride & 1)
    if len(data) < 8 + padded * h:
        raise ValueError("ART: truncated pixel data")
    rows = np.frombuffer(data, np.uint8, padded * h, 8).reshape(h, padded)
    bits = np.unpackbits(rows[:, :stride], axis=1)[:, :w]
    return Image(bits.astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


def encode_art(img: Image) -> bytes:
    arr = _flat(img)
    h, w = arr.shape[:2]
    white = (_luma(arr) >= 0.5).astype(np.uint8)
    packed = np.packbits(white, axis=1)
    if packed.shape[1] & 1:
        packed = np.pad(packed, ((0, 0), (0, 1)))
    return struct.pack("<4H", 0, w, 0, h) + packed.tobytes()


# ---------------------------------------------------------------------------
# Scitex CT (sct.c: 2048-byte parameter block — "CT" magick at offset 80,
# separations at 1026, rows/cols as ASCII at 1056/1068 — then per-row
# planar separations, rows padded to even width; read-only like the
# reference)
# ---------------------------------------------------------------------------

def decode_sct(data: bytes, device="cuda") -> Image:
    if len(data) < 2048:
        raise ValueError("SCT: truncated header")
    magick = data[80:82]
    if magick != b"CT":
        if magick in (b"LW", b"BM", b"PG", b"TX"):
            raise ValueError("SCT: only continuous-tone (CT) supported")
        raise ValueError("SCT: improper header")
    separations = data[1025]
    sep_mask = struct.unpack(">H", data[1026:1028])[0]
    rows = int(float(data[1056:1068].split(b"\x00")[0] or b"0"))
    cols = int(float(data[1068:1080].split(b"\x00")[0] or b"0"))
    if rows < 1 or cols < 1 or separations not in (1, 3, 4):
        raise ValueError("SCT: unsupported geometry/separations")
    stride = cols + (cols & 1)
    need = rows * separations * stride
    if len(data) < 2048 + need:
        raise ValueError("SCT: truncated pixel data")
    raw = np.frombuffer(data, np.uint8, need, 2048)
    raw = raw.reshape(rows, separations, stride)[:, :, :cols]
    arr = raw.transpose(0, 2, 1).astype(np.float32) / 255.0
    if separations == 4 or sep_mask == 0x0F:
        cs = "cmyk"
    elif separations == 1:
        cs = "gray"
    else:
        cs = "srgb"
    return Image(arr, ImageSpec(colorspace=cs), device=device)


# ---------------------------------------------------------------------------
# X Window Dump (xwd.c: 25 u32be header words + window name + XWDColor
# table + pixels; ZPixmap direct 16/24/32-bit via channel masks and
# 8-bit PseudoClass via the colormap; writer emits ZPixmap 24bpp/32-pad)
# ---------------------------------------------------------------------------

_XWD_VERSION = 7


def decode_xwd(data: bytes, device="cuda") -> Image:
    if len(data) < 100:
        raise ValueError("XWD: truncated header")
    words = struct.unpack(">25I", data[:100])
    (hdr_size, version, pix_format, _depth, w, h, xoff, byte_order,
     _bmp_unit, bit_order, _bmp_pad, bpp, bpl, _vis_class, rmask, gmask,
     bmask, _bits_rgb, _cmap_entries, ncolors) = words[:20]
    if version != _XWD_VERSION:
        # some writers store the header little-endian
        words = struct.unpack("<25I", data[:100])
        (hdr_size, version, pix_format, _depth, w, h, xoff, byte_order,
         _bmp_unit, bit_order, _bmp_pad, bpp, bpl, _vis_class, rmask,
         gmask, bmask, _bits_rgb, _cmap_entries, ncolors) = words[:20]
        if version != _XWD_VERSION:
            raise ValueError("XWD: bad file version")
        be = False
    else:
        be = True
    e = ">" if be else "<"
    off = hdr_size
    cmap = None
    if ncolors:
        cmap = np.zeros((ncolors, 3), np.float32)
        for i in range(ncolors):
            _pix, r, g, b = struct.unpack(e + "IHHH",
                                          data[off + 12 * i:off + 12 * i + 10])
            cmap[i] = (r / 65535.0, g / 65535.0, b / 65535.0)
        off += 12 * ncolors
    if pix_format == 0 or bpp == 1:      # XYBitmap / 1-bit
        stride = bpl if bpl else (w + 7) // 8
        rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
        bits = np.unpackbits(
            rows, axis=1,
            bitorder="big" if bit_order == 1 else "little")[:, :w]
        arr = bits.astype(np.float32)[..., None]
        return Image(arr, ImageSpec(colorspace="gray", depth=1), device=device)
    if pix_format != 2:
        raise ValueError("XWD: only ZPixmap supported")
    nbytes = bpp // 8
    if bpp == 8:
        stride = bpl if bpl else w
        idx = np.frombuffer(data, np.uint8, stride * h, off).reshape(
            h, stride)[:, :w]
        if cmap is None:
            arr = np.repeat(idx.astype(np.float32)[..., None] / 255.0, 3, -1)
        else:
            arr = cmap[np.minimum(idx, len(cmap) - 1)]
        return Image(arr.astype(np.float32), ImageSpec(colorspace="srgb"),
                     device=device)
    if bpp not in (16, 24, 32):
        raise ValueError("XWD: unsupported bits_per_pixel %d" % bpp)
    stride = bpl if bpl else w * nbytes
    rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
    px = rows[:, :w * nbytes].reshape(h, w, nbytes).astype(np.uint32)
    if byte_order == 1:   # MSBFirst
        val = np.zeros((h, w), np.uint32)
        for i in range(nbytes):
            val = (val << 8) | px[..., i]
    else:
        val = np.zeros((h, w), np.uint32)
        for i in reversed(range(nbytes)):
            val = (val << 8) | px[..., i]

    def chan(mask):
        if mask == 0:
            return np.zeros((h, w), np.float32)
        shift = int(mask & -mask).bit_length() - 1
        width_ = int(mask >> shift).bit_length()
        maxv = (1 << width_) - 1
        return ((val >> shift) & maxv).astype(np.float32) / maxv

    arr = np.stack([chan(rmask), chan(gmask), chan(bmask)], -1)
    return Image(arr, ImageSpec(colorspace="srgb"), device=device)


def encode_xwd(img: Image, name: str = "imagemagick_tpu") -> bytes:
    arr = _rgb(_flat(img))
    h, w = arr.shape[:2]
    wname = name.encode() + b"\x00"
    hdr_size = 100 + len(wname)
    head = struct.pack(
        ">25I", hdr_size, _XWD_VERSION,
        2,              # ZPixmap
        24, w, h, 0,    # depth, width, height, xoffset
        1,              # byte_order MSBFirst
        32, 1, 32,      # bitmap_unit, bit_order, bitmap_pad
        24, w * 3,      # bits_per_pixel, bytes_per_line (packed 24bpp)
        5,              # visual_class TrueColor
        0xFF0000, 0x00FF00, 0x0000FF,
        8, 0, 0,        # bits_per_rgb, colormap_entries, ncolors
        w, h, 0, 0, 0)  # window geometry
    return head + wname + _u8(arr).tobytes()


# ---------------------------------------------------------------------------
# Braille (braille.c: 2x4-dot cells; dark pixel = raised dot; BRF 6-dot
# ASCII table, UBRL/UBRL6 UTF-8 U+2800+cell, ISOBRL/ISOBRL6 raw bytes)
# ---------------------------------------------------------------------------

_ISO_TO_BRF = (" A1B'K2L@CIF/MSP\"E3H9O6R^DJG>NTQ,*5<-U8V.%[$+X!&;:4\\0Z7(_?W]#Y)=")


def encode_braille(img: Image, variant: str = "ubrl") -> bytes:
    variant = variant.lower()
    cell_h = 3 if variant in ("brf", "ubrl6", "isobrl6") else 4
    arr = _flat(img)
    dark = (_luma(arr) < 0.5).astype(np.uint8)
    h, w = dark.shape
    pw = w + (w % 2)
    ph = -(-h // cell_h) * cell_h
    d = np.zeros((ph, pw), np.uint8)
    d[:h, :w] = dark
    cells = d.reshape(ph // cell_h, cell_h, pw // 2, 2).transpose(0, 2, 1, 3)
    # bit layout (dx,dy)->bit: (0,0)0 (0,1)1 (0,2)2 (1,0)3 (1,1)4 (1,2)5
    # (0,3)6 (1,3)7
    weights = np.zeros((cell_h, 2), np.uint8)
    weights[0, 0], weights[0, 1] = 1 << 0, 1 << 3
    if cell_h > 1:
        weights[1, 0], weights[1, 1] = 1 << 1, 1 << 4
    if cell_h > 2:
        weights[2, 0], weights[2, 1] = 1 << 2, 1 << 5
    if cell_h > 3:
        weights[3, 0], weights[3, 1] = 1 << 6, 1 << 7
    cellv = (cells * weights).sum((2, 3)).astype(np.uint8)
    out = bytearray()
    if not variant.startswith("isobrl"):
        out += b"Width: %d\nHeight: %d\n\n" % (pw, h)
    for row in cellv:
        for c in row:
            if variant.startswith("ubrl"):
                out += chr(0x2800 + int(c)).encode("utf-8")
            elif variant.startswith("isobrl"):
                out.append(int(c))
            else:
                out += _ISO_TO_BRF[int(c)].encode()
        if not variant.startswith("isobrl"):
            out += b"\n"
    return bytes(out)


# ---------------------------------------------------------------------------
# Motif UIL icon (uil.c: color_table + icon string rows, XPM-style
# symbol alphabet; write-only)
# ---------------------------------------------------------------------------

_CIXEL = (" .XoO+@#$%&*=-;:>,<1234567890qwertyuipasdfghjklzxcvbnm"
          "MNBVCZASDFGHJKLPIUYTREWQ!~^/()_`'][{}|")


def encode_uil(img: Image, basename: str = "image") -> bytes:
    arr = _flat(img)
    h, w = arr.shape[:2]
    rgb = _u8(_rgb(arr))
    flat = rgb.reshape(-1, 3)
    colors, inverse = np.unique(flat, axis=0, return_inverse=True)
    if len(colors) > len(_CIXEL) ** 2:
        # quantize to 256 colors via 3:3:2 binning
        q = (flat[:, 0] >> 5 << 5, flat[:, 1] >> 5 << 5, flat[:, 2] >> 6 << 6)
        flat = np.stack(q, -1).astype(np.uint8)
        colors, inverse = np.unique(flat, axis=0, return_inverse=True)
    cpp = 1 if len(colors) <= len(_CIXEL) else 2
    n = len(_CIXEL)

    def symbol(i):
        s = _CIXEL[i % n]
        if cpp > 1:
            s += _CIXEL[(i // n) % n]
        return s.replace("'", "''")

    lines = ["/* UIL */",
             "value\n  %s_ct : color_table(" % basename]
    for i, c in enumerate(colors):
        name = "#%02X%02X%02X" % tuple(int(v) for v in c)
        role = ("background" if 0.212656 * c[0] + 0.715158 * c[1]
                + 0.072186 * c[2] < 127.5 else "foreground")
        sep = ");" if i == len(colors) - 1 else ","
        lines.append("    color('%s',%s) = '%s'%s" % (name, role,
                                                      symbol(i), sep))
    lines.append("  %s_icon : icon(color_table = %s_ct," % (basename,
                                                            basename))
    idx = inverse.reshape(h, w)
    for y in range(h):
        row = "".join(symbol(int(i)) for i in idx[y])
        lines.append('    "%s"%s' % (row, ");" if y == h - 1 else ","))
    return ("\n".join(lines) + "\n").encode()


# ---------------------------------------------------------------------------
# HTML (html.c writes an HTML page referencing the raster; here the page
# is self-contained via a base64 PNG data URI — no side files)
# ---------------------------------------------------------------------------

def encode_html(img: Image, title: str = "image") -> bytes:
    uri = encode_inline(img).decode()
    arr = _flat(img)
    h, w = arr.shape[:2]
    page = ("<!DOCTYPE html>\n<html>\n<head>\n<title>%s</title>\n</head>\n"
            "<body>\n<img width=%d height=%d src=\"%s\" alt=\"%s\">\n"
            "</body>\n</html>\n" % (title, w, h, uri, title))
    return page.encode()


# ---------------------------------------------------------------------------
# Adobe/IRIDAS .cube LUT (cube.c: LUT_3D_SIZE N + N^3 "r g b" rows with r
# fastest; decoded — like the reference — into a level-8 Hald CLUT image
# by trilinear interpolation, so it plugs into ops/enhance.hald_clut)
# ---------------------------------------------------------------------------

def decode_cube(data: bytes, hald_level: int = 8, device="cuda") -> Image:
    level = 0
    title = None
    rows = []
    for raw in data.decode("latin-1", "replace").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        key = tok[0].upper()
        if key in ("LUT_3D_SIZE", "LUT_1D_SIZE") and level == 0:
            n = int(tok[1])
            if key == "LUT_1D_SIZE":
                n = int(np.ceil(n ** (1.0 / 3.0)))
            level = n
        elif key == "TITLE" and len(tok) > 1:
            title = " ".join(tok[1:]).strip('"')
        elif key.replace(".", "").replace("-", "").replace("+", "") \
                .replace("E", "").isdigit() or key[0] in "0123456789.-+":
            try:
                rows.append([float(v) for v in tok[:3]])
            except ValueError:
                pass
    if level < 2 or level > 256:
        raise ValueError("CUBE: missing/bad LUT_3D_SIZE")
    need = level ** 3
    lut = np.zeros((need, 3), np.float32)
    lut[:min(len(rows), need)] = np.asarray(rows[:need], np.float32)
    lut = lut.reshape(level, level, level, 3)      # [b][g][r] (r fastest)
    from .pseudo import hald as _hald

    ident = _hald(hald_level, device="cpu").data.numpy()   # (s^3, s^3, 3)
    u = ident * (level - 1.0)
    i0 = np.floor(u).astype(np.int64)
    i0 = np.minimum(i0, level - 2)
    f = (u - i0).astype(np.float32)
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = f[..., 0, None], f[..., 1, None], f[..., 2, None]
    out = np.zeros(ident.shape, np.float32)
    for db in (0, 1):
        for dg in (0, 1):
            for dr in (0, 1):
                w = ((fr if dr else 1 - fr) * (fg if dg else 1 - fg)
                     * (fb if db else 1 - fb))
                out += w * lut[b0 + db, g0 + dg, r0 + dr]
    img = Image(out, ImageSpec(colorspace="srgb"), device=device)
    if title:
        img.properties["title"] = title
    return img


# ---------------------------------------------------------------------------
# PlayStation TIM (tim.c: u32le id 0x10, flag -> bpp/CLUT; CLUT block of
# 16/256 u16le 5:5:5 entries (R in the low bits); image block header in
# 16-bit units; 4bpp low-nibble-first; ScaleColor5to8 = v<<3 | v>>2)
# ---------------------------------------------------------------------------

def _c5to8(v: np.ndarray) -> np.ndarray:
    return ((v << 3) | (v >> 2)).astype(np.float32) / 255.0


def decode_tim(data: bytes, device="cuda"):
    images = []
    off = 0
    while off + 8 <= len(data):
        (tim_id,) = struct.unpack_from("<I", data, off)
        if (tim_id & 0xFF) != 0x10:
            break
        (flag,) = struct.unpack_from("<I", data, off + 4)
        off += 8
        pixel_mode = flag & 0x07
        has_clut = bool(flag & 0x08)
        bpp = {0: 4, 1: 8, 2: 16, 3: 24}.get(pixel_mode)
        if bpp is None:
            raise ValueError("TIM: unsupported pixel mode %d" % pixel_mode)
        cmap = None
        if has_clut:
            ncolors = 256 if pixel_mode == 1 else 16
            off += 12           # block length + x,y
            words = np.frombuffer(data, "<u2", ncolors, off)
            off += 2 * ncolors
            cmap = np.stack([_c5to8((words & 0x1F).astype(np.uint8)),
                             _c5to8(((words >> 5) & 0x1F).astype(np.uint8)),
                             _c5to8(((words >> 10) & 0x1F).astype(np.uint8))],
                            -1)
        off += 8                # image block length + x,y
        w16, h = struct.unpack_from("<HH", data, off)
        off += 4
        bytes_per_line = w16 * 2
        w = (w16 * 16) // bpp
        raw = np.frombuffer(data, np.uint8, bytes_per_line * h,
                            off).reshape(h, bytes_per_line)
        off += bytes_per_line * h
        if bpp == 4:
            lo = raw & 0x0F
            hi = raw >> 4
            idx = np.stack([lo, hi], -1).reshape(h, -1)[:, :w]
            if cmap is None:
                cmap = np.repeat(np.linspace(0, 1, 16,
                                             dtype=np.float32)[:, None], 3, 1)
            arr = cmap[idx]
        elif bpp == 8:
            idx = raw[:, :w]
            if cmap is None:
                cmap = np.repeat(np.linspace(0, 1, 256,
                                             dtype=np.float32)[:, None], 3, 1)
            arr = cmap[idx]
        elif bpp == 16:
            words = raw.view("<u2")[:, :w]
            arr = np.stack([_c5to8((words & 0x1F).astype(np.uint8)),
                            _c5to8(((words >> 5) & 0x1F).astype(np.uint8)),
                            _c5to8(((words >> 10) & 0x1F).astype(np.uint8))],
                           -1)
        else:
            arr = raw.reshape(h, -1, 3)[:, :w].astype(np.float32) / 255.0
        images.append(Image(arr.astype(np.float32),
                            ImageSpec(colorspace="srgb"), device=device))
    if not images:
        raise ValueError("TIM: no frames")
    return images


def encode_tim(img: Image) -> bytes:
    """16bpp direct-color TIM (mode 2), the lossless-ish common case."""
    color, _ = _colors_alpha(img)
    h, w = color.shape[:2]
    q5 = (np.clip(color, 0.0, 1.0) * 31.0 + 0.5).astype(np.uint16)
    words = (q5[..., 0] | (q5[..., 1] << 5) | (q5[..., 2] << 10)).astype("<u2")
    w16 = w      # one 16-bit unit per pixel in mode 2
    block_len = 12 + 2 * w16 * h
    head = struct.pack("<II", 0x10, 0x02)
    head += struct.pack("<IHHHH", block_len, 0, 0, w16, h)
    return head + words.tobytes()


# ---------------------------------------------------------------------------
# Seattle FilmWorks SFW (sfw.c: a JPEG with obfuscated marker codes —
# C8->D8 SOI, D0->E0 APP, CB->DB DQT, A0->C0/A4->C4 SOF, CA->DA SOS,
# C9->D9 EOI — a blanked JFIF id, and the DHT segment stripped; recover
# by translating markers and re-inserting the ITU T.81 Annex K tables)
# ---------------------------------------------------------------------------

_SFW_XLAT = {0xC8: 0xD8, 0xD0: 0xE0, 0xCB: 0xDB, 0xA0: 0xC0, 0xA4: 0xC4,
             0xCA: 0xDA, 0xC9: 0xD9}

# ITU T.81 Annex K "typical" Huffman tables (public spec data)
_DC_LUM = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
           list(range(12)))
_DC_CHR = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
           list(range(12)))
_AC_LUM = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
           [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
            0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
            0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
            0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
            0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A,
            0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
            0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
            0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
            0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
            0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94,
            0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
            0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
            0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
            0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
            0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
            0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
            0xF9, 0xFA])
_AC_CHR = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
           [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
            0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
            0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
            0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
            0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28,
            0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
            0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
            0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
            0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
            0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
            0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
            0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
            0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
            0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
            0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
            0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
            0xF9, 0xFA])


def _std_dht() -> bytes:
    body = b""
    for tid, (counts, values) in ((0x00, _DC_LUM), (0x01, _DC_CHR),
                                  (0x10, _AC_LUM), (0x11, _AC_CHR)):
        body += bytes([tid]) + bytes(counts) + bytes(values)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def decode_sfw(data: bytes, device="cuda"):
    from . import codecs

    if not data.startswith(b"SFW"):
        raise ValueError("SFW: improper header")
    buf = bytearray(data)
    pos = data.find(b"\xff\xc8\xff\xd0")
    if pos < 0:
        raise ValueError("SFW: no scrambled JFIF start")

    def xlat(i):
        buf[i + 1] = _SFW_XLAT.get(buf[i + 1], buf[i + 1])

    xlat(pos)
    xlat(pos + 2)
    buf[pos + 6:pos + 13] = b"JFIF\x00\x01\x00"
    off = pos + 2
    off += ((buf[off + 2] << 8) | buf[off + 3]) + 2
    while True:
        if off + 4 > len(buf) - 1:
            raise ValueError("SFW: truncated marker stream")
        xlat(off)
        if buf[off + 1] == 0xDA:
            break
        off += ((buf[off + 2] << 8) | buf[off + 3]) + 2
    sos = off
    dpos = bytes(buf).find(b"\xff\xc9", sos)
    if dpos < 0:
        raise ValueError("SFW: no end-of-image marker")
    xlat(dpos)
    jpeg = bytes(buf[pos:sos]) + _std_dht() + bytes(buf[sos:dpos + 2])
    return codecs.decode(jpeg, "jpeg", device)


# ---------------------------------------------------------------------------
# Dr. Halo CUT (cut.c: u16le w,h,reserved; per row u16le byte-count then
# RLE — ctrl>=0x80 is a run of (ctrl&0x7F) copies, else ctrl literals,
# 0 terminates the row. Without the companion .PAL the raster decodes as
# grayscale, like the reference's fallback.)
# ---------------------------------------------------------------------------

def decode_cut(data: bytes, device="cuda") -> Image:
    if len(data) < 6:
        raise ValueError("CUT: truncated header")
    w, h, reserved = struct.unpack("<HHH", data[:6])
    if w == 0 or h == 0 or reserved != 0:
        raise ValueError("CUT: improper header")
    pos = 6
    rows = []
    for _ in range(h):
        if pos + 2 > len(data):
            raise ValueError("CUT: truncated row")
        pos += 2                      # encoded byte count (unused)
        row = bytearray()
        while pos < len(data):
            ctrl = data[pos]
            pos += 1
            if (ctrl & 0x7F) == 0:
                break
            if ctrl >= 0x80:
                row += bytes([data[pos]]) * (ctrl & 0x7F)
                pos += 1
            else:
                row += data[pos:pos + ctrl]
                pos += ctrl
        rows.append(bytes(row))
    ldblk = len(rows[0]) if rows else 0
    if ldblk == (w + 7) // 8:         # 1-bit
        packed = np.frombuffer(b"".join(r.ljust(ldblk, b"\0")[:ldblk]
                                        for r in rows),
                               np.uint8).reshape(h, ldblk)
        bits = np.unpackbits(packed, axis=1)[:, :w]
        arr = bits.astype(np.float32)
        return Image(arr[..., None], ImageSpec(colorspace="gray", depth=1),
                     device=device)
    arr = np.zeros((h, w), np.uint8)
    for y, r in enumerate(rows):
        n = min(w, len(r))
        arr[y, :n] = np.frombuffer(r[:n], np.uint8)
    return Image((arr.astype(np.float32) / 255.0)[..., None],
                 ImageSpec(colorspace="gray"), device=device)


# ---------------------------------------------------------------------------
# Utah Raster Toolkit RLE (rle.c: magic 52 CC; u16le x,y,w,h; flags/
# planes/bpp/ncolormaps/log2-maplen bytes; optional background bytes;
# colormaps as u16le entries (high byte significant); opcode stream
# SkipLines/SetColor/SkipPixels/ByteData/RunData with 0x40 long form;
# rows bottom-up; read-only like the reference)
# ---------------------------------------------------------------------------

def decode_rle(data: bytes, device="cuda") -> Image:
    if data[:2] != b"\x52\xcc":
        raise ValueError("RLE: improper header")
    pos = 2
    _x, _y, w, h = struct.unpack_from("<4H", data, pos)
    pos += 8
    flags, planes, bpp, ncmaps, maplog = data[pos:pos + 5]
    pos += 5
    if bpp != 8 or w == 0 or h == 0 or planes == 0 or planes > 4:
        raise ValueError("RLE: unsupported geometry")
    maplen = 1 << maplog
    has_alpha = bool(flags & 0x04)
    if flags & 0x02:
        pos += 1                               # no background, pad byte
    else:
        pos += planes                          # background bytes
    if planes % 2 == 0:
        pos += 1
    nplanes = planes + (1 if has_alpha else 0)
    cmap = None
    if ncmaps:
        entries = np.frombuffer(data, "<u2", ncmaps * maplen, pos)
        pos += 2 * ncmaps * maplen
        cmap = (entries.reshape(ncmaps, maplen) >> 8).astype(np.uint8)
    if flags & 0x08:                           # comment block
        (clen,) = struct.unpack_from("<H", data, pos)
        pos += 2 + clen + (clen & 1)
    pix = np.zeros((h, w, nplanes), np.uint8)
    x = y = 0
    plane = 0

    def operand(long_form):
        nonlocal pos
        v = data[pos]
        pos += 1
        if long_form:
            (v,) = struct.unpack_from("<h", data, pos)
            pos += 2
        return v

    while pos < len(data):
        op = data[pos]
        pos += 1
        code = op & 0x3F
        if code == 0x07:                       # EOF
            break
        if code == 0x01:                       # SkipLines
            y += operand(op & 0x40)
            x = 0
        elif code == 0x02:                     # SetColor
            plane = data[pos]
            pos += 1
            if plane == 255:
                plane = nplanes - 1
            x = 0
        elif code == 0x03:                     # SkipPixels
            x += operand(op & 0x40)
        elif code == 0x05:                     # ByteData
            n = operand(op & 0x40) + 1
            chunk = np.frombuffer(data, np.uint8, min(n, len(data) - pos),
                                  pos)
            pos += n + (n & 1)
            yy = h - y - 1
            if 0 <= yy < h and plane < nplanes:
                m = min(n, w - x, len(chunk))
                if m > 0:
                    pix[yy, x:x + m, plane] = chunk[:m]
            x += n
        elif code == 0x06:                     # RunData
            n = operand(op & 0x40) + 1
            val = data[pos]
            pos += 2                           # value + pad
            yy = h - y - 1
            if 0 <= yy < h and plane < nplanes:
                m = min(n, w - x)
                if m > 0:
                    pix[yy, x:x + m, plane] = val
            x += n
        else:
            break
    if cmap is not None:
        if ncmaps == 1:
            pix = cmap[0][pix & (maplen - 1)]
        elif planes == 1 and ncmaps >= 3:
            # palette image: expand through the three maps to RGB
            idx = pix[..., 0] & (maplen - 1)
            rgb = np.stack([cmap[0][idx], cmap[1][idx], cmap[2][idx]], -1)
            if has_alpha:
                rgb = np.concatenate([rgb, pix[..., 1:2]], -1)
            pix = rgb
            planes = 3
            nplanes = planes + (1 if has_alpha else 0)
        elif planes >= 3 and ncmaps >= 3:
            for c in range(min(planes, ncmaps)):
                pix[..., c] = cmap[c][pix[..., c] & (maplen - 1)]
    arr = pix.astype(np.float32) / 255.0
    cs = "gray" if planes == 1 else "srgb"
    return Image(arr, ImageSpec(colorspace=cs, alpha=has_alpha), device=device)


# ---------------------------------------------------------------------------
# MacPaint MAC (mac.c: u16le type word — 0 means a 512-byte header, else
# 640 — then PackBits-style RLE of INVERTED bytes; fixed 576x720 1-bit,
# wire bit 1 = black)
# ---------------------------------------------------------------------------

def decode_mac(data: bytes, device="cuda") -> Image:
    if len(data) < 2:
        raise ValueError("MAC: truncated")
    (tword,) = struct.unpack("<H", data[:2])
    if tword & 0xFF:
        raise ValueError("MAC: improper header")
    pos = 512 if tword == 0 else 640
    W, H = 576, 720
    stride = W // 8
    out = bytearray()
    need = stride * H
    n = len(data)
    while len(out) < need and pos < n:
        count = data[pos]
        pos += 1
        if count == 0 or count >= 128:
            if pos >= n:
                break
            byte = (~data[pos]) & 0xFF
            pos += 1
            run = ((~count) & 0xFF) + 2
            out += bytes([byte]) * run
        else:
            take = count + 1
            chunk = data[pos:pos + take]
            pos += take
            out += bytes((~b) & 0xFF for b in chunk)
    out = out[:need].ljust(need, b"\xff")
    rows = np.frombuffer(bytes(out), np.uint8).reshape(H, stride)
    bits = np.unpackbits(rows, axis=1)[:, :W]   # MSB-first; 1 = white
    return Image(bits.astype(np.float32)[..., None],
                 ImageSpec(colorspace="gray", depth=1), device=device)


# ---------------------------------------------------------------------------
# Alias/Wavefront PIX (pix.c: u16be w,h,xoff,yoff,bpp; run-length rows —
# count byte then BGR triplet (24-bit) or gray byte (8-bit))
# ---------------------------------------------------------------------------

def decode_pix(data: bytes, device="cuda") -> Image:
    if len(data) < 10:
        raise ValueError("PIX: truncated header")
    w, h, _, _, bpp = struct.unpack(">5H", data[:10])
    if w == 0 or h == 0 or bpp not in (8, 24):
        raise ValueError("PIX: improper header")
    nch = 1 if bpp == 8 else 3
    out = np.zeros((h * w, nch), np.uint8)
    pos = 10
    i = 0
    total = h * w
    while i < total and pos < len(data):
        count = data[pos]
        pos += 1
        if count == 0:
            break
        if bpp == 8:
            val = data[pos:pos + 1]
            pos += 1
            out[i:i + count, 0] = val[0]
        else:
            b, g, r = data[pos:pos + 3]
            pos += 3
            out[i:i + count] = (r, g, b)
        i += count
    arr = out.reshape(h, w, nch).astype(np.float32) / 255.0
    return Image(arr, ImageSpec(colorspace="gray" if nch == 1 else "srgb"),
                 device=device)


# ---------------------------------------------------------------------------
# Raw planar YUV (yuv.c: Y plane then 2x2-subsampled U,V planes — 4:2:0,
# the reference's default sampling; geometry from -size)
# ---------------------------------------------------------------------------

def decode_yuv(data: bytes, width: int, height: int, device="cuda") -> Image:
    cw, ch = (width + 1) // 2, (height + 1) // 2
    need = width * height + 2 * cw * ch
    if len(data) < need:
        raise ValueError("YUV: truncated for %dx%d 4:2:0" % (width, height))
    yplane = np.frombuffer(data, np.uint8, width * height).reshape(
        height, width)
    u = np.frombuffer(data, np.uint8, cw * ch, width * height).reshape(
        ch, cw)
    v = np.frombuffer(data, np.uint8, cw * ch,
                      width * height + cw * ch).reshape(ch, cw)
    u2 = np.repeat(np.repeat(u, 2, 0), 2, 1)[:height, :width]
    v2 = np.repeat(np.repeat(v, 2, 0), 2, 1)[:height, :width]
    ycbcr = np.stack([yplane, u2, v2], -1).astype(np.float32) / 255.0
    return Image(ycbcr, ImageSpec(colorspace="ycbcr"), device=device)


def encode_yuv(img: Image) -> bytes:
    from ..ops.colorspace import rgb_to_ycbcr

    arr = _flat(img)
    if img.spec.colorspace != "ycbcr":
        arr = _on_device(rgb_to_ycbcr, _rgb(arr), img.data.device)
    h, w = arr.shape[:2]
    q = _u8(arr)
    yb = q[..., 0].tobytes()
    u = q[0::2, 0::2, 1]
    v = q[0::2, 0::2, 2]
    return yb + u.tobytes() + v.tobytes()


# ---------------------------------------------------------------------------
# BAYER mosaic (bayer.c: raw RGGB mosaic via -size; read demosaics with
# bilinear interpolation — a vectorized convolution instead of the
# reference's mask/resize composition — write remosaics)
# ---------------------------------------------------------------------------

def decode_bayer(data: bytes, width: int, height: int, device="cuda") -> Image:
    depth = 16 if len(data) >= width * height * 2 else 8
    if depth == 8:
        mosaic = np.frombuffer(data, np.uint8, width * height).reshape(
            height, width).astype(np.float32) / 255.0
    else:
        mosaic = np.frombuffer(data, "<u2", width * height).reshape(
            height, width).astype(np.float32) / 65535.0
    yy, xx = np.mgrid[0:height, 0:width]
    r_mask = ((yy % 2 == 0) & (xx % 2 == 0)).astype(np.float32)
    g_mask = ((yy % 2) != (xx % 2)).astype(np.float32)
    b_mask = ((yy % 2 == 1) & (xx % 2 == 1)).astype(np.float32)

    def interp(mask):
        vals = mosaic * mask
        k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
        pv = np.pad(vals, 1, mode="reflect")
        pm = np.pad(mask, 1, mode="reflect")
        num = sum(k[dy, dx] * pv[dy:dy + height, dx:dx + width]
                  for dy in range(3) for dx in range(3))
        den = sum(k[dy, dx] * pm[dy:dy + height, dx:dx + width]
                  for dy in range(3) for dx in range(3))
        return num / np.maximum(den, 1e-12)

    arr = np.stack([interp(r_mask), interp(g_mask), interp(b_mask)],
                   -1).astype(np.float32)
    return Image(arr, ImageSpec(colorspace="srgb", depth=depth), device=device)


def encode_bayer(img: Image, depth: int = 8) -> bytes:
    arr = _rgb(_flat(img))
    h, w = arr.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    chan = np.where((yy % 2 == 0) & (xx % 2 == 0), 0,
                    np.where((yy % 2 == 1) & (xx % 2 == 1), 2, 1))
    mosaic = np.take_along_axis(arr, chan[..., None], axis=2)[..., 0]
    if depth <= 8:
        return _u8(mosaic).tobytes()
    return (np.clip(mosaic, 0, 1) * 65535 + 0.5).astype("<u2").tobytes()


# ---------------------------------------------------------------------------
# PlayStation 2 TIM2 (tim2.c: "TIM2" + version 4 file header — 16 or 128
# bytes by format_type — then a 48-byte picture header; pixels before the
# CLUT; A1B5G5R5 / RGB24 / RGBA32 (alpha doubled) encodings; 4/8bpp CLUT
# indices with the CSM1 page-block deshuffle)
# ---------------------------------------------------------------------------

def _tim2_colors(words: np.ndarray, depth: int):
    if depth == 16:
        r = ((words & 0x1F) << 3).astype(np.float32) / 255.0
        g = (((words >> 5) & 0x1F) << 3).astype(np.float32) / 255.0
        b = (((words >> 10) & 0x1F) << 3).astype(np.float32) / 255.0
        a = np.where((words >> 15) & 1, 1.0, 0.0).astype(np.float32)
        return np.stack([r, g, b, a], -1)
    raise ValueError("bad depth")


def decode_tim2(data: bytes, device="cuda"):
    if data[:4] != b"TIM2":
        raise ValueError("TIM2: improper header")
    vers, ftype = data[4], data[5]
    if vers != 0x04:
        raise ValueError("TIM2: unsupported version")
    (count,) = struct.unpack_from("<H", data, 6)
    pos = 16 if ftype == 0 else 128
    images = []
    for _ in range(max(count, 1)):
        (total_size, clut_size, image_size, header_size, clut_colors) = \
            struct.unpack_from("<3IHH", data, pos)
        img_format, mipmaps, clut_type, bpp_type = data[pos + 16:pos + 20]
        w, h = struct.unpack_from("<HH", data, pos + 20)
        del img_format
        if mipmaps != 1:
            raise ValueError("TIM2: mipmaps unsupported")
        px = pos + header_size
        cl = px + image_size
        bpp = {1: 16, 2: 24, 3: 32, 4: 4, 5: 8}.get(bpp_type)
        if bpp is None or w == 0 or h == 0:
            raise ValueError("TIM2: improper picture header")
        cmap = None
        if clut_type and clut_size:
            cdepth = {1: 16, 2: 24, 3: 32}.get(clut_type & 0x0F)
            if cdepth == 16:
                cw = np.frombuffer(data, "<u2", clut_colors, cl)
                cmap = _tim2_colors(cw.astype(np.uint32), 16)
            elif cdepth == 24:
                cb = np.frombuffer(data, np.uint8, clut_colors * 3,
                                   cl).reshape(-1, 3)
                cmap = np.concatenate(
                    [cb.astype(np.float32) / 255.0,
                     np.ones((len(cb), 1), np.float32)], -1)
            else:
                cb = np.frombuffer(data, np.uint8, clut_colors * 4,
                                   cl).reshape(-1, 4)
                cmap = np.concatenate(
                    [cb[:, :3].astype(np.float32) / 255.0,
                     np.minimum(cb[:, 3:].astype(np.int64) * 2, 255)
                     .astype(np.float32) / 255.0], -1)
            if (clut_type >> 4) == 0 and len(cmap) >= 32:
                # CSM1: swap blocks 2 and 3 (8 colors each) in every
                # 32-color page
                cm = cmap.copy()
                for page in range(len(cmap) // 32):
                    i = page * 32
                    cm[i + 8:i + 16] = cmap[i + 16:i + 24]
                    cm[i + 16:i + 24] = cmap[i + 8:i + 16]
                cmap = cm
        if bpp == 16:
            words = np.frombuffer(data, "<u2", w * h, px).reshape(h, w)
            arr = _tim2_colors(words.astype(np.uint32), 16)
            alpha = True
        elif bpp == 24:
            arr = np.frombuffer(data, np.uint8, w * h * 3, px).reshape(
                h, w, 3).astype(np.float32) / 255.0
            alpha = False
        elif bpp == 32:
            raw = np.frombuffer(data, np.uint8, w * h * 4, px).reshape(
                h, w, 4)
            arr = np.concatenate(
                [raw[..., :3].astype(np.float32) / 255.0,
                 np.minimum(raw[..., 3:].astype(np.int64) * 2, 255)
                 .astype(np.float32) / 255.0], -1)
            alpha = True
        else:
            if bpp == 4:
                raw = np.frombuffer(data, np.uint8, (w * h + 1) // 2, px)
                lo = raw & 0x0F
                hi = raw >> 4
                idx = np.stack([lo, hi], -1).reshape(-1)[:w * h].reshape(
                    h, w)
            else:
                idx = np.frombuffer(data, np.uint8, w * h, px).reshape(h, w)
            if cmap is None:
                cmap = np.concatenate(
                    [np.repeat(np.linspace(0, 1, 1 << bpp,
                                           dtype=np.float32)[:, None], 3, 1),
                     np.ones((1 << bpp, 1), np.float32)], -1)
            arr = cmap[np.minimum(idx, len(cmap) - 1)]
            alpha = True
        images.append(Image(arr.astype(np.float32),
                            ImageSpec(colorspace="srgb", alpha=alpha),
                            device=device))
        pos += total_size if total_size else header_size + image_size + \
            clut_size
    return images


# ---------------------------------------------------------------------------
# Garmin JNX raster maps (jnx.c: version 3/4 header with geo extents,
# per-level tile tables, tiles as JPEG streams minus their SOI marker)
# ---------------------------------------------------------------------------

def decode_jnx(data: bytes, device="cuda"):
    from . import codecs

    if len(data) < 52:
        raise ValueError("JNX: truncated header")
    version = struct.unpack_from("<i", data, 0)[0]
    if version not in (3, 4):
        raise ValueError("JNX: unsupported version %d" % version)
    levels = struct.unpack_from("<i", data, 24)[0]
    if not (0 < levels <= 20):
        raise ValueError("JNX: improper level count")
    pos = 48 if version == 3 else 52
    level_info = []
    for _ in range(levels):
        count, offset = struct.unpack_from("<ii", data, pos)
        pos += 12
        if version > 3:
            pos += 4
            while pos + 1 < len(data) and \
                    struct.unpack_from("<H", data, pos)[0] != 0:
                pos += 2
            pos += 2
        if count > 50000:
            raise ValueError("JNX: improper tile count")
        level_info.append((count, offset))
    images = []
    for count, offset in level_info:
        pos = offset
        for _ in range(count):
            if pos + 28 > len(data):
                break
            ne_x, ne_y, sw_x, sw_y = struct.unpack_from("<4i", data, pos)
            length, toff = struct.unpack_from("<Ii", data, pos + 20)
            pos += 28
            if toff == -1 or toff + length > len(data):
                continue
            jpeg = b"\xff\xd8" + data[toff:toff + length]
            try:
                tile = codecs.decode(jpeg, "jpeg", device)[0]
            except Exception:
                continue
            scale = 180.0 / 0x7FFFFFFF
            tile.properties["jnx:northeast"] = "%.10g,%.10g" % (
                ne_x * scale, ne_y * scale)
            tile.properties["jnx:southwest"] = "%.10g,%.10g" % (
                sw_x * scale, sw_y * scale)
            images.append(tile)
    if not images:
        raise ValueError("JNX: no decodable tiles")
    return images


# ---------------------------------------------------------------------------
# Brother PES embroidery (pes.c: "#PES" header, PEC stitch stream with
# 7-bit normal / 12-bit jump deltas and 254,176 color-change markers;
# rendered — like the reference — by emitting the stitch blocks as SVG
# paths in the thread palette and rasterizing)
# ---------------------------------------------------------------------------

_PES_COLORS = [
    (0, 0, 0), (14, 31, 124), (10, 85, 163), (48, 135, 119),
    (75, 107, 175), (237, 23, 31), (209, 92, 0), (145, 54, 151),
    (228, 154, 203), (145, 95, 172), (157, 214, 125), (232, 169, 0),
    (254, 186, 53), (255, 255, 0), (112, 188, 31), (192, 148, 0),
    (168, 168, 168), (123, 111, 0), (255, 255, 179), (79, 85, 86),
    (0, 0, 0), (11, 61, 145), (119, 1, 118), (41, 49, 51),
    (42, 19, 1), (246, 74, 138), (178, 118, 36), (252, 187, 196),
    (254, 55, 15), (240, 240, 240), (106, 28, 138), (168, 221, 196),
    (37, 132, 187), (254, 179, 67), (255, 240, 141), (208, 166, 96),
    (209, 84, 0), (102, 186, 73), (19, 74, 70), (135, 135, 135),
    (216, 202, 198), (67, 86, 7), (254, 227, 197), (249, 147, 188),
    (0, 56, 34), (178, 175, 212), (104, 106, 176), (239, 227, 185),
    (247, 56, 102), (181, 76, 100), (19, 43, 26), (199, 1, 85),
    (254, 158, 50), (168, 222, 235), (0, 103, 26), (78, 41, 144),
    (47, 126, 32), (253, 217, 222), (255, 217, 17), (9, 91, 166),
    (240, 249, 112), (227, 243, 91), (255, 200, 100), (255, 200, 150),
    (255, 200, 200)]


def decode_pes(data: bytes, device="cuda") -> Image:
    from .extra_coders import decode_svg

    if data[:4] != b"#PES":
        raise ValueError("PES: improper header")
    (pec_offset,) = struct.unpack_from("<i", data, 8)
    pos = 12 + pec_offset + 36
    if pos >= len(data):
        raise ValueError("PES: truncated")
    ncolors = data[pos] + 1
    color_idx = [min(max(data[pos + 1 + i], 0), len(_PES_COLORS) - 1)
                 for i in range(min(ncolors, 255))]
    pos += 1 + ncolors + (532 - ncolors - 21)
    stitches = []
    block_offsets = [0]
    x = y = 0
    n = len(data)
    while pos + 1 < n:
        a, b = data[pos], data[pos + 1]
        pos += 2
        if a == 0xFF and b == 0:
            break
        if a == 254 and b == 176:
            block_offsets.append(len(stitches))
            pos += 1
            continue
        if a & 0x80:                       # jump: 12-bit signed
            dx = ((a & 0x0F) << 8) + b
            if dx & 0x800:
                dx -= 0x1000
            if pos >= n:
                break
            b = data[pos]
            pos += 1
        else:                              # normal: 7-bit signed
            dx = a - 0x80 if a & 0x40 else a
        if b & 0x80:
            dy = ((b & 0x0F) << 8) + (data[pos] if pos < n else 0)
            pos += 1
            if dy & 0x800:
                dy -= 0x1000
        else:
            dy = b - 0x80 if b & 0x40 else b
        x += dx
        y += dy
        stitches.append((x, y))
    if not stitches:
        raise ValueError("PES: no stitches")
    block_offsets.append(len(stitches))
    xs = [p[0] for p in stitches]
    ys = [p[1] for p in stitches]
    x1, x2 = min(xs), max(xs)
    y1, y2 = min(ys), max(ys)
    w = max(int(x2 - x1), 1)
    h = max(int(y2 - y1), 1)
    parts = ['<svg width="%d" height="%d">' % (w, h)]
    for bi in range(len(block_offsets) - 1):
        s, e = block_offsets[bi], block_offsets[bi + 1]
        if e <= s:
            continue
        ci = color_idx[bi] if bi < len(color_idx) else 0
        r, g, b_ = _PES_COLORS[ci]
        d = "M %g %g " % (stitches[s][0] - x1, stitches[s][1] - y1)
        d += " ".join("L %g %g" % (px - x1, py - y1)
                      for px, py in stitches[s + 1:e])
        parts.append('<path stroke="#%02x%02x%02x" fill="none" d="%s"/>'
                     % (r, g, b_, d))
    parts.append("</svg>")
    return decode_svg("\n".join(parts).encode(), device=device)


# ---------------------------------------------------------------------------
# 16-bit TIFF (tiff.c deep-pixel path): classic little-endian TIFF with
# one uncompressed strip — written natively because Pillow cannot save
# 48-bit RGB; a matching minimal reader covers what Pillow cannot load
# ---------------------------------------------------------------------------

def encode_tiff16(img: Image) -> bytes:
    arr = _flat(img)
    if arr.shape[-1] == 2:
        arr = arr[..., :1]
    elif arr.shape[-1] > 3:
        arr = arr[..., :3]
    h, w, c = arr.shape
    q = (np.clip(arr, 0.0, 1.0) * 65535.0 + 0.5).astype("<u2")
    payload = q.tobytes()
    entries = []

    def entry(tag, typ, count, value):
        entries.append(struct.pack("<HHI", tag, typ, count)
                       + struct.pack("<I", value))

    nent = 10
    ifd_off = 8
    data_off = ifd_off + 2 + nent * 12 + 4
    bits_off = data_off
    extra = b""
    if c == 3:
        extra = struct.pack("<3H", 16, 16, 16) + b"\x00\x00"
        strip_off = data_off + len(extra)
    else:
        strip_off = data_off
    entry(256, 3, 1, w)                       # ImageWidth
    entry(257, 3, 1, h)                       # ImageLength
    if c == 3:
        entry(258, 3, 3, bits_off)            # BitsPerSample offset
    else:
        entry(258, 3, 1, 16)
    entry(259, 3, 1, 1)                       # no compression
    entry(262, 3, 1, 2 if c == 3 else 1)      # photometric
    entry(273, 4, 1, strip_off)               # StripOffsets
    entry(277, 3, 1, c)                       # SamplesPerPixel
    entry(278, 3, 1, h)                       # RowsPerStrip
    entry(279, 4, 1, len(payload))            # StripByteCounts
    entry(284, 3, 1, 1)                       # chunky planar config
    head = b"II*\x00" + struct.pack("<I", ifd_off)
    ifd = struct.pack("<H", nent) + b"".join(entries) + struct.pack("<I", 0)
    return head + ifd + extra + payload


def decode_tiff16(data: bytes, device="cuda") -> Image:
    """Minimal reader for the uncompressed chunky TIFFs encode_tiff16
    emits (and similar deep files Pillow rejects)."""
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("TIFF16: bad magic")
    e = "<" if data[:2] == b"II" else ">"
    (ifd_off,) = struct.unpack_from(e + "I", data, 4)
    (nent,) = struct.unpack_from(e + "H", data, ifd_off)
    tags = {}
    for i in range(nent):
        tag, typ, count, raw = struct.unpack_from(
            e + "HHI4s", data, ifd_off + 2 + i * 12)
        tags[tag] = (typ, count, raw)

    def val(tag, default=None):
        if tag not in tags:
            return default
        typ, count, raw = tags[tag]
        size = {1: 1, 3: 2, 4: 4}.get(typ, 4)
        if count * size <= 4:
            if typ == 3:
                return struct.unpack(e + "H", raw[:2])[0]
            return struct.unpack(e + "I", raw)[0]
        (off,) = struct.unpack(e + "I", raw)
        if typ == 3:
            return struct.unpack_from(e + "H", data, off)[0]
        return struct.unpack_from(e + "I", data, off)[0]

    def vals(tag):
        """All entries of an array-valued tag (e.g. StripOffsets)."""
        if tag not in tags:
            return []
        typ, count, raw = tags[tag]
        size = {1: 1, 3: 2, 4: 4}.get(typ, 4)
        fmt = {1: "B", 3: "H", 4: "I"}.get(typ, "I")
        src, off = (raw, 0) if count * size <= 4 else \
            (data, struct.unpack(e + "I", raw)[0])
        return [struct.unpack_from(e + fmt, src, off + i * size)[0]
                for i in range(count)]

    w, h = val(256), val(257)
    bps = val(258, 8)
    comp = val(259, 1)
    spp = val(277, 1)
    strip = val(273)
    if comp != 1 or bps != 16 or not w or not h:
        raise ValueError("TIFF16: only uncompressed 16-bit supported")
    if spp > 1 and val(284, 1) != 1:
        # planar samples (one plane a channel): the JAX reader takes them
        # for chunky pixels
        raise ValueError("TIFF16: planar samples unsupported")
    offs, counts = vals(273), vals(279)
    if len(offs) > 1:
        # multi-strip: only readable when the strips are verified
        # contiguous — otherwise raise so the caller falls back to Pillow
        # instead of decoding garbage
        if len(counts) != len(offs) or any(
                offs[i] + counts[i] != offs[i + 1]
                for i in range(len(offs) - 1)):
            raise ValueError("TIFF16: non-contiguous strips unsupported")
    dt = np.dtype("u2").newbyteorder(e)
    arr = np.frombuffer(data, dt, w * h * spp, strip).reshape(h, w, spp)
    cs = "gray" if spp == 1 else "srgb"
    return Image((arr.astype(np.float32) / 65535.0),
                 ImageSpec(colorspace=cs, alpha=spp == 4, depth=16),
                 device=device)


# ---------------------------------------------------------------------------
# DCX multi-page PCX container (pcx.c DCX path: u32le magic 0x3ADE68B1 +
# 1024-slot offset table + PCX frames) and CUR cursor write (icon.c CUR
# registration: ICO directory with type 2 + hotspot fields)
# ---------------------------------------------------------------------------

def encode_dcx(images) -> bytes:
    from . import image_to_blob

    frames = [image_to_blob(im, "pcx") for im in images[:1023]]
    table = np.zeros(1024, "<u4")
    pos = 4 + 1024 * 4
    for i, f in enumerate(frames):
        table[i] = pos
        pos += len(f)
    return struct.pack("<I", 0x3ADE68B1) + table.tobytes() + b"".join(frames)


def encode_cur(img: Image, hotspot=(0, 0)) -> bytes:
    from . import image_to_blob

    ico = bytearray(image_to_blob(img, "ico"))
    if len(ico) < 22 or ico[:4] != b"\x00\x00\x01\x00":
        raise ValueError("CUR: inner ICO encode failed")
    ico[2] = 2                                    # resource type: cursor
    # directory entry planes/bpp fields become the hotspot
    struct.pack_into("<HH", ico, 10, int(hotspot[0]), int(hotspot[1]))
    return bytes(ico)


# ---------------------------------------------------------------------------
# MAGICK C-header image (magick.c: "static const unsigned char
# MagickImage[] = { 0x.., ... };" wrapping a GIF/PNM blob — write emits
# the header, read extracts the hex bytes and decodes the inner blob)
# ---------------------------------------------------------------------------

def decode_magick(data: bytes, device="cuda"):
    from . import image_from_blob

    hexbytes = re.findall(rb"0[xX]([0-9a-fA-F]{2})", data)
    if len(hexbytes) < 8:
        raise ValueError("MAGICK: no embedded image bytes")
    blob = bytes(int(h, 16) for h in hexbytes)
    return image_from_blob(blob, device=device)


def encode_magick(img: Image, name: str = "MagickImage") -> bytes:
    from . import image_to_blob

    inner = image_to_blob(img, "gif" if not img.spec.alpha else "png")
    lines = ["/*", "  %s (%s)." % (name, "GIF" if not img.spec.alpha
                                   else "PNG"), "*/",
             "static const unsigned char", "  %s[] =" % name, "  {"]
    row = []
    body = []
    for i, b in enumerate(inner):
        row.append("0x%02X" % b)
        if len(row) == 12:
            body.append(", ".join(row) + ",")
            row = []
    if row:
        body.append(", ".join(row))
    else:
        body[-1] = body[-1].rstrip(",")
    lines += ["    " + r for r in body] + ["  };", ""]
    return "\n".join(lines).encode()


# ---------------------------------------------------------------------------
# IPLab IPL (ipl.c: "iiii" LSB / "mmmm" MSB magick, 8 reserved bytes,
# "data" tag, then u32 size/width/height/colors/z/time/byteType and z
# grayscale frames whose sample type byteType selects)
# ---------------------------------------------------------------------------

_IPL_TYPES = {0: ("u1", 8), 1: ("i2", 16), 2: ("u2", 16), 3: ("i4", 32),
              4: ("f4", 32), 5: ("u1", 8), 6: ("u2", 16), 10: ("f8", 64)}


def decode_ipl(data: bytes, device="cuda"):
    if data[:4] == b"iiii":
        e = "<"
    elif data[:4] == b"mmmm":
        e = ">"
    else:
        raise ValueError("IPL: improper header")
    if data[12:16] != b"data":
        raise ValueError("IPL: missing data tag")
    _size, w, h, _colors, z, _time, btype = struct.unpack(
        e + "7I", data[16:44])
    if w == 0 or h == 0:
        raise ValueError("IPL: improper geometry")
    dtype_s, _depth = _IPL_TYPES.get(btype, ("u2", 16))
    dt = np.dtype(dtype_s).newbyteorder(e)
    frames = []
    off = 44
    for _ in range(max(z, 1)):
        raw = np.frombuffer(data, dt, w * h, off).reshape(h, w)
        off += w * h * dt.itemsize
        if dt.kind == "f":
            arr = raw.astype(np.float32)
        elif dt.kind == "i":
            info = np.iinfo(dt)
            arr = (raw.astype(np.float32) - info.min) / (info.max - info.min)
        else:
            arr = raw.astype(np.float32) / np.iinfo(dt).max
        frames.append(Image(arr[..., None],
                            ImageSpec(colorspace="gray",
                                      depth=min(_depth, 32)), device=device))
    return frames


def encode_ipl(img: Image, depth: int = 16) -> bytes:
    arr = _flat(img)
    gray = _luma(arr) if arr.shape[-1] > 1 else arr[..., 0]
    h, w = gray.shape
    if depth <= 8:
        btype, payload = 0, _u8(gray).tobytes()
    else:
        btype = 2
        payload = (np.clip(gray, 0, 1) * 65535 + 0.5).astype(
            "<u2").tobytes()
    head = b"iiii" + b"\x64\x00\x00\x00" + b"\x00" * 4 + b"data"
    head += struct.pack("<7I", len(payload), w, h, 1, 1, 0, btype)
    return head + payload


# ---------------------------------------------------------------------------
# Colormap MAP (map.c: raw colormap entries — 3 bytes (or 6 at 16-bit) per
# color — followed by index bytes; geometry from -size, colors from the
# blob partition at 256 by default)
# ---------------------------------------------------------------------------

def decode_map(data: bytes, width: int, height: int,
               colors: int = 256, device="cuda") -> Image:
    need_idx = width * height
    pal_bytes = len(data) - need_idx
    if pal_bytes >= colors * 3:
        ncol = colors
    else:
        ncol = max(2, pal_bytes // 3)
    cmap = np.frombuffer(data, np.uint8, ncol * 3).reshape(ncol, 3)
    idx = np.frombuffer(data, np.uint8, need_idx,
                        ncol * 3).reshape(height, width)
    arr = cmap[np.minimum(idx, ncol - 1)].astype(np.float32) / 255.0
    return Image(arr, ImageSpec(colorspace="srgb"), device=device)


def _kmeans(img: Image, colors: int):
    """(u8 palette, u8 labels) of the image's RGB by ``kmeans`` on the
    image's device."""
    from ..ops.quantize import kmeans

    arr = _rgb(_flat(img))
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(img.data.device)
    pal, labels = kmeans(x, colors)
    return _u8(pal.cpu().numpy()), labels.cpu().numpy().astype(np.uint8)


def encode_map(img: Image, colors: int = 256) -> bytes:
    pal8, labels = _kmeans(img, colors)
    return pal8.tobytes() + labels.tobytes()


# ---------------------------------------------------------------------------
# Formatted text FTXT (ftxt.c: default format "\x,\y:\c\n" — one line per
# pixel, channels joined by ',' at quantum scale)
# ---------------------------------------------------------------------------

_FTXT_LINE = re.compile(rb"^\s*(\d+),(\d+):(.*)$")


def decode_ftxt(data: bytes, device="cuda") -> Image:
    pts = []
    w = h = 0
    for line in data.splitlines():
        m = _FTXT_LINE.match(line)
        if not m:
            continue
        x, y = int(m.group(1)), int(m.group(2))
        vals = []
        for tok in m.group(3).split(b","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                vals.append(float(int(tok, 16)) if tok.startswith(b"#")
                            else float(tok))
            except ValueError:
                pass
        if vals:
            pts.append((x, y, vals))
            w = max(w, x + 1)
            h = max(h, y + 1)
    if not pts:
        raise ValueError("FTXT: no pixel lines")
    nch = min(max(len(v) for _, _, v in pts), 5)
    arr = np.zeros((h, w, nch), np.float32)
    for x, y, vals in pts:
        row = (vals + [0.0] * nch)[:nch]
        arr[y, x] = [v / 65535.0 for v in row]
    cs = "gray" if nch == 1 else "srgb"
    return Image(arr, ImageSpec(colorspace=cs, alpha=nch in (2, 4)),
                 device=device)


def encode_ftxt(img: Image) -> bytes:
    arr = _flat(img)
    h, w, c = arr.shape
    q = np.clip(arr, 0.0, 1.0) * 65535.0
    lines = []
    for y in range(h):
        for x in range(w):
            vals = ",".join("%g" % v for v in q[y, x])
            lines.append("%d,%d:%s" % (x, y, vals))
    return ("\n".join(lines) + "\n").encode()


# ---------------------------------------------------------------------------
# ASHLAR (ashlar.c, write-only): pack a sequence of images onto one
# canvas with a shelf best-fit — emitted as PNG wrapped composition
# ---------------------------------------------------------------------------

def encode_ashlar(images, inner_fmt: str = "png") -> bytes:
    from . import image_to_blob

    tiles = [(_flat(im), i) for i, im in enumerate(images)]
    tiles.sort(key=lambda t: -t[0].shape[0])
    total = sum(t[0].shape[0] * t[0].shape[1] for t in tiles)
    W = max(int(np.ceil(np.sqrt(total * 1.2))),
            max(t[0].shape[1] for t in tiles))
    x = y = shelf = 0
    placed = []
    for arr, _ in tiles:
        th, tw = arr.shape[:2]
        if x + tw > W:
            x = 0
            y += shelf
            shelf = 0
        placed.append((y, x, arr))
        x += tw
        shelf = max(shelf, th)
    H = y + shelf
    canvas = np.ones((H, W, 3), np.float32)
    for py, px, arr in placed:
        canvas[py:py + arr.shape[0], px:px + arr.shape[1]] = _rgb(arr)
    return image_to_blob(Image(canvas, ImageSpec(colorspace="srgb"),
                               device="cpu"), inner_fmt)


# ---------------------------------------------------------------------------
# DOS EPS / EPT (ept.c: C5 D0 D3 C6 header with offsets/lengths for a
# PostScript section and a TIFF preview; decode prefers the PostScript
# via the ghostscript delegate, falling back to the TIFF; write emits
# EPS + TIFF preview)
# ---------------------------------------------------------------------------

_EPT_MAGIC = 0xC6D3D0C5


def decode_ept(data: bytes, device="cuda"):
    if len(data) < 30 or struct.unpack("<I", data[:4])[0] != _EPT_MAGIC:
        raise ValueError("EPT: improper header")
    ps_off, ps_len, _, _, tiff_off, tiff_len = struct.unpack(
        "<6I", data[4:28])
    if ps_len:
        try:
            from . import delegates

            return delegates.decode_postscript(
                data[ps_off:ps_off + ps_len], "eps", device=device)
        except Exception:
            pass
    if tiff_len:
        from . import codecs

        return codecs.decode(data[tiff_off:tiff_off + tiff_len], "tiff",
                             device)
    raise ValueError("EPT: no decodable section")


def encode_ept(img: Image) -> bytes:
    from . import image_to_blob

    eps = image_to_blob(img, "eps")
    tiff = image_to_blob(img, "tiff")
    ps_off = 30
    tiff_off = ps_off + len(eps)
    head = struct.pack("<7I", _EPT_MAGIC, ps_off, len(eps), 0, 0,
                       tiff_off, len(tiff))
    head += b"\xff\xff"          # checksum: -1 = unused
    return head + eps + tiff


# ---------------------------------------------------------------------------
# WordPerfect Graphics WPG, level 1 (wpg.c: FF 'WPC' header, record
# stream with WP variable-length sizes; bitmap type 1 (0x0B) / type 2
# (0x14) rasters, palette records (0x0E), byte-RLE with repeat-previous-
# row opcodes; 1/2/4/8 bpp MSB-first)
# ---------------------------------------------------------------------------

def _wp_dword(data: bytes, pos: int):
    b = data[pos]
    pos += 1
    if b < 0xFF:
        return b, pos
    v = data[pos] | (data[pos + 1] << 8)
    pos += 2
    if v < 0x8000:
        return v, pos
    v = (v & 0x7FFF) << 16
    v += data[pos] | (data[pos + 1] << 8)
    return v, pos + 2


def _wpg_unpack(data: bytes, pos: int, end: int, w: int, h: int, bpp: int):
    ldblk = (bpp * w + 7) // 8
    rows = []
    cur = bytearray()
    prev = bytes(ldblk)

    def flush_row():
        nonlocal cur, prev
        row = bytes(cur[:ldblk].ljust(ldblk, b"\0"))
        rows.append(row)
        prev = row
        cur = bytearray()

    while pos < end and len(rows) < h:
        b = data[pos]
        pos += 1
        rc = b & 0x7F
        if b & 0x80:
            if rc:
                val = data[pos]
                pos += 1
                cur += bytes([val]) * rc
            else:
                rc = data[pos]
                pos += 1
                cur += b"\xff" * rc
        else:
            if rc:
                cur += data[pos:pos + rc]
                pos += rc
            else:
                rc = data[pos]
                pos += 1
                if cur:
                    flush_row()
                for _ in range(rc):
                    if len(rows) >= h:
                        break
                    rows.append(prev)
                continue
        while len(cur) >= ldblk and len(rows) < h:
            row = bytes(cur[:ldblk])
            rows.append(row)
            prev = row
            cur = bytearray(cur[ldblk:])
    while len(rows) < h:
        rows.append(prev)
    return rows


def decode_wpg(data: bytes, device="cuda") -> Image:
    if len(data) < 16 or struct.unpack("<I", data[:4])[0] != 0x435057FF:
        raise ValueError("WPG: improper header")
    (offset,) = struct.unpack("<I", data[4:8])
    filetype = data[9]
    if filetype != 0x16:
        raise ValueError("WPG: not a level-1 graphics file")
    pos = offset
    palette = None
    result = None
    while pos < len(data) - 1:
        rectype = data[pos]
        pos += 1
        try:
            length, pos = _wp_dword(data, pos)
        except IndexError:
            break
        nxt = pos + length
        if rectype == 0x0E and length >= 4:          # palette
            start, nent = struct.unpack_from("<HH", data, pos)
            entries = np.frombuffer(
                data, np.uint8, min(3 * nent, length - 4),
                pos + 4).reshape(-1, 3)
            palette = np.zeros((256, 3), np.uint8)
            palette[start:start + len(entries)] = entries
        elif rectype in (0x0B, 0x14):
            if rectype == 0x0B:
                w, h, bpp = struct.unpack_from("<3H", data, pos)
                rpos = pos + 10
            else:
                w, h, bpp = struct.unpack_from("<3H", data, pos + 10)
                rpos = pos + 20
            if w and h and bpp in (1, 2, 4, 8):
                rows = _wpg_unpack(data, rpos, nxt, w, h, bpp)
                packed = np.frombuffer(b"".join(rows), np.uint8).reshape(
                    h, -1)
                if bpp == 8:
                    idx = packed[:, :w]
                else:
                    bits = np.unpackbits(packed, axis=1)
                    vals = bits.reshape(h, -1, bpp)
                    weights = (1 << np.arange(bpp - 1, -1, -1))
                    idx = (vals * weights).sum(-1)[:, :w].astype(np.uint8)
                if palette is not None:
                    arr = palette[idx].astype(np.float32) / 255.0
                    result = Image(arr, ImageSpec(colorspace="srgb"),
                                   device=device)
                else:
                    maxv = (1 << bpp) - 1
                    arr = (idx.astype(np.float32) / maxv)[..., None]
                    result = Image(arr, ImageSpec(
                        colorspace="gray", depth=min(bpp, 8)), device=device)
                break
        pos = nxt
    if result is None:
        raise ValueError("WPG: no raster record found")
    return result


def _wpg_rle_row(row: bytes) -> bytes:
    """WPG1 byte RLE (wpg.c WPGAddRLEBlock semantics, matching the
    reader's opcodes: 0x80|n + byte = run, n<0x80 + bytes = literals)."""
    out = bytearray()
    i = 0
    n = len(row)
    while i < n:
        j = i
        while j < n and row[j] == row[i] and j - i < 0x7F:
            j += 1
        run = j - i
        if run >= 3:
            out.append(0x80 | run)
            out.append(row[i])
            i = j
        else:
            k = i
            lit = bytearray()
            while k < n and len(lit) < 0x7F:
                rr = k
                while rr < n and row[rr] == row[k] and rr - k < 3:
                    rr += 1
                if rr - k >= 3:
                    break
                lit += row[k:rr]
                k = rr
            if len(lit) > 0x7F:
                # a pair taken at 126 literals: its second byte starts the
                # next run (the JAX writer emits a count of 128 here,
                # which reads back as a run opcode)
                del lit[0x7F:]
                k -= 1
            out.append(len(lit))
            out += lit
            i = k
    return bytes(out)


def encode_wpg(img: Image, colors: int = 256) -> bytes:
    """WPG level-1 writer (wpg.c WriteWPGImage layout): start record,
    palette record, bitmap-1 record with long-form length, byte RLE,
    end record."""
    pal8, idx = _kmeans(img, colors)
    h, w = idx.shape
    out = bytearray()
    out += struct.pack("<II", 0x435057FF, 16)
    out += bytes([1, 0x16, 1, 0]) + struct.pack("<HH", 0, 0)
    # start-of-WPG record
    out += bytes([0x0F, 0x06, 1, 0]) + struct.pack("<HH", w, h)
    # palette record
    nent = len(pal8)
    body = struct.pack("<HH", 0, nent) + pal8.tobytes()
    out.append(0x0E)
    if len(body) < 0xFF:
        out.append(len(body))
    else:
        out.append(0xFF)
        out += struct.pack("<H", len(body))
    out += body
    # bitmap-1 record with reserved long-form length
    raster = bytearray()
    for y in range(h):
        raster += _wpg_rle_row(idx[y].tobytes())
    bm_body = struct.pack("<5H", w, h, 8, 75, 75) + bytes(raster)
    out.append(0x0B)
    out.append(0xFF)
    out += struct.pack("<HH", 0x8000 | (len(bm_body) >> 16),
                       len(bm_body) & 0xFFFF)
    out += bm_body
    out += bytes([0x10, 0x00])
    return bytes(out)


# ---------------------------------------------------------------------------
# Seattle FilmWorks multi-frame PWP (pwp.c: "SFW95" container of embedded
# "SFW94A" frames)
# ---------------------------------------------------------------------------

def decode_pwp(data: bytes, device="cuda"):
    if not data.startswith(b"SFW95"):
        raise ValueError("PWP: improper header")
    images = []
    parts = data.split(b"SFW94A")
    for chunk in parts[1:]:
        try:
            images.extend(decode_sfw(b"SFW94A" + chunk, device))
        except Exception:
            continue
    if not images:
        raise ValueError("PWP: no decodable SFW frames")
    return images


# ---------------------------------------------------------------------------
# MVG vector text (mvg.c: canvas from the "viewbox" primitive, then the
# framework's MVG rasterizer in ops/draw.py)
# ---------------------------------------------------------------------------

_MVG_IMAGE = re.compile(
    r"\bimage\s+\w+\s+[-+0-9.,]+\s+[-+0-9.,]+\s+['\"]?([^'\"\s]+)",
    re.I)


def decode_mvg(data: bytes, width: Optional[int] = None,
               height: Optional[int] = None, device="cuda") -> Image:
    from ..core.image import checked_device
    from ..core.policy import enforce_path
    from ..ops import draw as dw

    text = data.decode("utf-8", "replace")
    w, h = width, height
    m = re.search(r"viewbox\s+([0-9.+-]+)\s+([0-9.+-]+)\s+([0-9.+-]+)"
                  r"\s+([0-9.+-]+)", text, re.I)
    if m and not (w and h):
        x1, y1, x2, y2 = (float(v) for v in m.groups())
        w = int(round(x2 - x1))
        h = int(round(y2 - y1))
    w = w or 256
    h = h or 256
    # ops/draw.py has no image primitive, so it opens no file that one
    # names; such a name is still refused where no host file may be named
    for m in _MVG_IMAGE.finditer(text):
        enforce_path(m.group(1))
    canvas = torch.ones((h, w, 3), dtype=torch.float32,
                        device=checked_device(device))
    out = dw.draw(canvas, text)
    return Image(out, ImageSpec(colorspace="srgb"))


# ---------------------------------------------------------------------------
# TTF/OTF font preview (ttf.c: 800x480 sample sheet — alphabet rows and a
# pangram at increasing point sizes, rendered with the font itself)
# ---------------------------------------------------------------------------

def decode_ttf(data: bytes, device="cuda") -> Image:
    import io as _io

    from PIL import Image as PImage
    from PIL import ImageDraw, ImageFont

    W, H = 800, 480
    page = PImage.new("RGB", (W, H), (255, 255, 255))
    dr = ImageDraw.Draw(page)
    y = 10
    f12 = ImageFont.truetype(_io.BytesIO(data), 18)
    for line in ("abcdefghijklmnopqrstuvwxyz",
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                 "0123456789.:,;(*!?}^)#${%^&-+@"):
        dr.text((12, y), line, font=f12, fill=(0, 0, 0))
        y += 28
    for ps in (11, 12, 14, 16, 18, 20, 22, 24, 26, 28):
        f = ImageFont.truetype(_io.BytesIO(data), ps)
        dr.text((12, y), "%d The quick brown fox jumps over the lazy dog."
                % ps, font=f, fill=(0, 0, 0))
        y += ps + 10
        if y > H - 30:
            break
    arr = np.asarray(page, np.uint8).astype(np.float32) / 255.0
    return Image(arr, ImageSpec(colorspace="srgb"), device=device)


# ---------------------------------------------------------------------------
# STEGANO extraction (stegano.c read side): recover the LSB-embedded
# watermark written by SteganoImage. This framework's embedder
# (ops/visual_effects.stegano) stores the bilevel watermark in the LSB of
# every channel at the top-left, so extraction reads the red LSB.
# ---------------------------------------------------------------------------

def decode_stegano(host: Image, width: int, height: int,
                   device="cuda") -> Image:
    arr = _flat(host)
    q = (np.clip(arr[..., 0], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    bits = (q & 1).astype(np.float32)
    h = min(height, bits.shape[0])
    w = min(width, bits.shape[1])
    out = np.zeros((height, width), np.float32)
    out[:h, :w] = bits[:h, :w]
    return Image(out[..., None], ImageSpec(colorspace="gray", depth=1),
                 device=device)


# ---------------------------------------------------------------------------
# Palm Database ImageViewer PDB (pdb.c: 78-byte MSB database header with
# type/id "vIMG"/"View", record list, 58-byte image record; 1/2/4-bit
# grayscale MSB-first with INVERTED values (index = (2^bpp-1) - bits),
# optional byte-RLE where ctrl>128 = run of (ctrl-128+1))
# ---------------------------------------------------------------------------

def _pdb_rle(data: bytes, need: int) -> bytes:
    out = bytearray()
    i = 0
    while len(out) < need and i < len(data):
        c = data[i]
        i += 1
        if c > 128:
            if i >= len(data):
                break
            out += bytes([data[i]]) * (c - 128 + 1)
            i += 1
        else:
            out += data[i:i + c + 1]
            i += c + 1
    if len(out) < need:
        raise ValueError("PDB: RLE underrun")
    return bytes(out[:need])


def decode_pdb(data: bytes, device="cuda") -> Image:
    if len(data) < 78 + 8 or data[60:68] != b"vIMGView":
        raise ValueError("PDB: not an ImageViewer database")
    nrec = struct.unpack(">H", data[76:78])[0]
    if nrec < 1:
        raise ValueError("PDB: no records")
    img_offset = struct.unpack(">i", data[78:82])[0]
    hdr = img_offset
    version = data[hdr + 32]
    ptype = data[hdr + 33]
    w, h = struct.unpack(">HH", data[hdr + 54:hdr + 58])
    if w == 0 or h == 0:
        raise ValueError("PDB: improper image header")
    bpp = {0: 2, 2: 4}.get(ptype, 1)
    stride = (bpp * w + 7) // 8
    body = data[hdr + 58:]
    if version & 1:
        raw = _pdb_rle(body, stride * h)
    else:
        if len(body) < stride * h:
            raise ValueError("PDB: truncated pixel data")
        raw = body[:stride * h]
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1)          # MSB-first
    if bpp == 1:
        val = bits[:, :w]
        arr = (1.0 - val).astype(np.float32)    # set bit = black
    else:
        packed = bits.reshape(h, -1, bpp)
        weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
        val = (packed * weights).sum(-1)[:, :w]
        maxv = (1 << bpp) - 1
        arr = ((maxv - val) / maxv).astype(np.float32)
    return Image(arr[..., None], ImageSpec(colorspace="gray", depth=bpp),
                 device=device)


def encode_pdb(img: Image, name: str = "image") -> bytes:
    """Uncompressed 2-bit grayscale vIMG record (pdb.c WritePDBImage
    geometry; version 0 = no RLE for maximum reader tolerance)."""
    arr = _flat(img)
    h, w = arr.shape[:2]
    gray = _luma(arr)
    val = np.minimum((gray * 4.0).astype(np.int64), 3).astype(np.uint8)
    inv = (3 - val).astype(np.uint8)
    hi = (inv >> 1) & 1
    lo = inv & 1
    interleaved = np.stack([hi, lo], -1).reshape(h, -1).astype(np.uint8)
    packed = np.packbits(interleaved, axis=1)
    dbname = name.encode()[:31].ljust(32, b"\x00")
    head = dbname + struct.pack(">HH", 0, 0)
    head += struct.pack(">6I", 0, 0, 0, 0, 0, 0)
    head += b"vIMG" + b"View" + struct.pack(">II", 0, 0)
    head += struct.pack(">H", 1)             # one record
    img_offset = len(head) + 8
    head += struct.pack(">i", img_offset) + b"\x40" + b"\x6f\x80\x00"
    rec = name.encode()[:31].ljust(32, b"\x00")
    rec += bytes([0, 0])                     # version 0, type 0 (2-bit)
    rec += struct.pack(">II", 0, 0)          # reserved, note
    rec += struct.pack(">HH", 0, 0)          # x_last, y_last
    rec += struct.pack(">I", 0)              # reserved_2
    rec += struct.pack(">HH", 0, 0)          # anchors
    rec += struct.pack(">HH", w, h)
    return head + rec + packed.tobytes()


# ---------------------------------------------------------------------------
# UYVY 4:2:2 (uyvy.c: U Y1 V Y2 per pixel pair; BT.601 full-range like the
# reference's read path; width must be even; geometry from -size)
# ---------------------------------------------------------------------------

def decode_uyvy(data: bytes, width: int, height: int, device="cuda") -> Image:
    if width % 2:
        raise ValueError("UYVY: width must be even")
    need = width * height * 2
    if len(data) < need:
        raise ValueError("UYVY: truncated for %dx%d" % (width, height))
    raw = np.frombuffer(data, np.uint8, need).reshape(height, width // 2, 4)
    u = raw[..., 0].astype(np.float32)
    v = raw[..., 2].astype(np.float32)
    y = raw[..., (1, 3)].astype(np.float32).reshape(height, width)
    u2 = np.repeat(u, 2, -1)
    v2 = np.repeat(v, 2, -1)
    ycbcr = np.stack([y, u2, v2], -1) / 255.0
    return Image(ycbcr.astype(np.float32), ImageSpec(colorspace="ycbcr"),
                 device=device)
