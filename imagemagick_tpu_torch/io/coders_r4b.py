"""STRIMG, DEBUG, MATTE, META, DMR, WMF and JBIG.

Port of ``imagemagick_tpu/io/coders_r4b.py``.  Parity targets:
  * STRIMG — coders/strimg.c:203 ("String to image and back"): read =
    encode the filename string as a 1-row 8-bit gray image (pixel =
    char/255); write = export the pixels as 8-bit gray quantum bytes,
    recovering the string.
  * DEBUG — coders/debug.c:105 (write-only): a header "# ImageMagick
    pixel debugging: W,H,QuantumRange,colorspace" then one "x,y:
    r,g,b[,k][,a]" line per pixel with %.20g quantum values.
  * MATTE — coders/matte.c:96 (write-only): the alpha channel replicated
    into RGB with opaque alpha, written as MIFF; CoderError when the
    image has no alpha channel.
  * META — coders/meta.c:1452-1545: the 8BIM/EXIF/XMP/ICC/IPTC profile
    payloads as standalone files attached to a 1x1 image.
    8BIMTEXT/IPTCTEXT use the reference's line grammar (format8BIM at
    meta.c:2131 / formatIPTCfromBuffer at meta.c:2016, parse8BIM at
    meta.c:305): `8BIM#<id>[#<name>]="value"` and
    `<dataset>#<record>#<name>="value"`, with &#NNN;/&amp;/&quot;
    escapes (formatString, meta.c framework).
  * DMR — coders/dmr.c:282 ("Digital Media Repository"): a content IRI
    (`<type>/<path>`) resolved against an on-disk repository rooted at
    the `dmr:path` define (or $MAGICK_CACHE); image resources round-trip
    as MIFF, blob resources feed the normal blob decode path, meta
    resources surface as a `dmr:meta` property.  An optional
    `dmr:passphrase` enciphers/deciphers resources with AES-CTR
    (``utils.signature._keystream``).  Inside ``core.policy.no_host_files``
    the repository root and a passphrase file are refused.
  * WMF — coders/wmf.c (libwmf delegate): a native parser for the
    placeable/standard WMF record stream translating the common GDI
    subset (pens, brushes, polygons, polylines, rectangles, ellipses,
    round-rects, text, embedded DIBs) into MVG for the vector rasterizer
    (ops/draw.py).  No libwmf dependency.
  * JBIG — coders/jbig.c through the port's ``native.jbig_*``.

Bytes are parsed and packed on the host as in the JAX module.  A decoded
image goes to ``device`` (the card unless the caller asks for the CPU);
a WMF's canvas is made there and drawn, and its DIBs resized and
composited there.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.image import Image, checked_device
from ..core.spec import ImageSpec


def _host64(image: Image) -> np.ndarray:
    """The first frame of ``image`` on the host, as float64."""
    arr = image.to_numpy().astype(np.float64)
    return arr[0] if arr.ndim == 4 else arr


def _intensity(arr: np.ndarray) -> np.ndarray:
    if arr.shape[2] >= 3:
        return (0.212656 * arr[..., 0] + 0.715158 * arr[..., 1] +
                0.072186 * arr[..., 2])
    return arr[..., 0]


# ---------------------------------------------------------------------------
# STRIMG
# ---------------------------------------------------------------------------

def strimg_pseudo(text: str, device="cuda") -> Image:
    """ReadSTRIMGImage (strimg.c:101): the string as a 1-row gray image,
    depth 8, pixel = ScaleCharToQuantum(char)."""
    if not text:
        text = " "
    arr = np.frombuffer(text.encode("utf-8", "replace"),
                        np.uint8).astype(np.float32) / 255.0
    return Image(arr[None, :, None],
                 ImageSpec(colorspace="gray", alpha=False, depth=8),
                 device=device)


def encode_strimg(image: Image) -> bytes:
    """WriteSTRIMGImage (strimg.c:255): 8-bit gray quantum export —
    the bytes ARE the string."""
    inten = _intensity(_host64(image))
    return np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# DEBUG
# ---------------------------------------------------------------------------

def _g20(v: float) -> str:
    """FormatLocaleString %.20g."""
    return "%.20g" % float(v)


def encode_debug(images: List[Image]) -> bytes:
    """WriteDEBUGImage (debug.c:156): per-pixel quantum values in text."""
    out = []
    for im in images:
        arr = _host64(im)
        h, w, c = arr.shape
        # header range follows the image depth (rose: -> 255, xc: ->
        # 65535) but pixel values are always raw Q16-HDRI quantums
        # (debug.c prints pixel.red, a 65535-scale double)
        depth = 8 if (im.spec.depth or 16) <= 8 else 16
        qrange = (1 << depth) - 1
        cs = (im.spec.colorspace or "srgb").lower()
        cmyk = cs == "cmyk"
        csname = cs + ("a" if im.spec.alpha else "")
        out.append("# ImageMagick pixel debugging: %s,%s,%s,%s\n"
                   % (_g20(w), _g20(h), _g20(qrange), csname))
        # snap to the Q16 integer grid where float32 storage of n/255 or
        # n/65535 introduced sub-quantum noise (tol ~5x f32 eps at 65535);
        # genuine HDRI fractions like 32767.5 are far outside the snap
        q = arr * 65535.0
        qr = np.round(q)
        q = np.where(np.abs(q - qr) < 0.02, qr, q)
        # one "%.20g" string a sample, then the JAX loop's line layout
        cols = [0, 1, 2] if c >= 3 else [0, 0, 0]
        if cmyk and c >= 4:
            cols.append(3)
        if im.spec.alpha:
            cols.append(c - 1)
        plane = {k: ["%.20g" % v for v in q[..., k].reshape(-1).tolist()]
                 for k in set(cols)}
        r, g, b = plane[cols[0]], plane[cols[1]], plane[cols[2]]
        extra = [plane[k] for k in cols[3:]]
        i = 0
        for y in range(h):
            for x in range(w):
                tup = "%s,%s,%s " % (r[i], g[i], b[i])
                for e in extra:
                    tup += ",%s " % e[i]
                out.append("%d,%d: %s\n" % (x, y, tup))
                i += 1
    return "".join(out).encode()


# ---------------------------------------------------------------------------
# MATTE
# ---------------------------------------------------------------------------

def encode_matte(image: Image) -> bytes:
    """WriteMATTEImage (matte.c:155): alpha replicated into RGB, opaque
    alpha, serialized as MIFF; error without an alpha channel."""
    if not image.spec.alpha:
        raise ValueError("MATTE write: ImageDoesNotHaveAnAlphaChannel")
    from . import miff

    data = image.data[0] if image.data.ndim == 4 else image.data
    a = data[..., -1:]
    # alpha_trait is reset to Undefined after the fill (matte.c:189), so
    # the serialized MIFF carries plain RGB
    matte = Image(torch.cat([a, a, a], dim=-1),
                  ImageSpec(colorspace="srgb", alpha=False,
                            depth=image.spec.depth))
    return miff.encode([matte], depth=16 if (image.spec.depth or 16) > 8
                       else 8, compression="zip")


# ---------------------------------------------------------------------------
# META (8BIM / 8BIMTEXT / EXIF / APP1 / XMP / ICC / ICM / IPTC / IPTCTEXT)
# ---------------------------------------------------------------------------

_META_PROFILE = {"8bim": "8bim", "8bimtext": "8bim",
                 "exif": "exif", "app1": "exif",
                 "xmp": "xmp", "icc": "icc", "icm": "icc",
                 "iptc": "iptc", "iptctext": "iptc"}

IPTC_ID = 1028   # 8BIM resource holding the IPTC record (meta.c IPTC_ID)


def _format_escape(data: bytes) -> str:
    """formatString (meta.c): printable chars verbatim, '&'->&amp;,
    '"'->&quot;, everything else &#NNN;."""
    out = []
    for b in data:
        if b == 0x26:
            out.append("&amp;")
        elif b == 0x22:
            out.append("&quot;")
        elif 0x20 <= b < 0x7F:
            out.append(chr(b))
        else:
            out.append("&#%d;" % b)
    return "".join(out)


def _parse_escape(text: str) -> bytes:
    """convertHTMLcodes inverse of _format_escape."""
    out = bytearray()
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "&":
            m = re.match(r"&(#\d+|amp|quot|lt|gt);", text[i:])
            if m:
                tok = m.group(1)
                if tok.startswith("#"):
                    out.append(int(tok[1:]) & 255)
                else:
                    out.append({"amp": 0x26, "quot": 0x22,
                                "lt": 0x3C, "gt": 0x3E}[tok])
                i += m.end()
                continue
        out.append(ord(ch) & 255)
        i += 1
    return bytes(out)


def _iter_8bim(blob: bytes):
    """Walk 8BIM resource blocks: (id, name, data) triples."""
    i = 0
    n = len(blob)
    while i + 12 <= n:
        if blob[i:i + 4] != b"8BIM":
            i += 1
            continue
        rid = struct.unpack(">H", blob[i + 4:i + 6])[0]
        plen = blob[i + 6]
        name = blob[i + 7:i + 7 + plen]
        j = i + 7 + plen
        if (plen & 1) == 0:
            j += 1      # PString padded to even total (length byte + data)
        if j + 4 > n:
            break
        count = struct.unpack(">I", blob[j:j + 4])[0]
        j += 4
        data = blob[j:j + count]
        yield rid, name.decode("latin-1"), data
        j += count
        if count & 1:
            j += 1      # data padded to even
        i = j


def _build_8bim(records) -> bytes:
    """Assemble 8BIM resource blocks from (id, name, data) triples."""
    out = bytearray()
    for rid, name, data in records:
        out += b"8BIM"
        out += struct.pack(">H", rid)
        nb = name.encode("latin-1")
        out.append(len(nb))
        out += nb
        if (len(nb) & 1) == 0:
            out.append(0)
        out += struct.pack(">I", len(data))
        out += data
        if len(data) & 1:
            out.append(0)
    return bytes(out)


def _iter_iptc(blob: bytes):
    """Walk IPTC records: (dataset, record, data)."""
    i = 0
    n = len(blob)
    while i + 5 <= n:
        if blob[i] != 0x1C:
            i += 1
            continue
        ds, rec = blob[i + 1], blob[i + 2]
        length = struct.unpack(">H", blob[i + 3:i + 5])[0]
        i += 5
        if length & 0x8000:   # extended-length records: skip (rare)
            break
        yield ds, rec, blob[i:i + length]
        i += length


_IPTC_NAMES = {
    (2, 5): "Image Name", (2, 10): "Priority", (2, 15): "Category",
    (2, 20): "Supplemental Category", (2, 25): "Keyword",
    (2, 40): "Special Instructions", (2, 55): "Created Date",
    (2, 60): "Created Time", (2, 80): "Byline", (2, 85): "Byline Title",
    (2, 90): "City", (2, 95): "Province State",
    (2, 100): "Country Code", (2, 101): "Country",
    (2, 103): "Original Transmission Reference", (2, 105): "Headline",
    (2, 110): "Credit", (2, 115): "Source", (2, 116): "Copyright String",
    (2, 120): "Caption", (2, 122): "Local Caption",
}


def format_8bimtext(blob: bytes) -> str:
    """format8BIM (meta.c:2131): '8BIM#<id>[#<name>]="value"' lines;
    the IPTC resource expands through formatIPTCfromBuffer."""
    lines = []
    for rid, name, data in _iter_8bim(blob):
        head = f"8BIM#{rid}#{name}=" if name else f"8BIM#{rid}="
        if rid == IPTC_ID:
            lines.append(head + '"IPTC"\n' + format_iptctext(data))
        else:
            lines.append(head + '"' + _format_escape(data) + '"\n')
    return "".join(lines)


def format_iptctext(blob: bytes) -> str:
    """formatIPTCfromBuffer (meta.c:2016): '<ds>#<rec>#<name>="value"'."""
    lines = []
    for ds, rec, data in _iter_iptc(blob):
        name = _IPTC_NAMES.get((ds, rec), f"Record {rec}")
        lines.append(f"{ds}#{rec}#{name}=\"{_format_escape(data)}\"\n")
    return "".join(lines)


_TEXT_LINE = re.compile(r'^\s*(8BIM|\d+)#(\d+)(?:#([^=]*))?="(.*)"\s*$')


def _iptc_record(ds: str, rec: str, data: bytes) -> bytes:
    return (bytes([0x1C, int(ds) & 255, int(rec) & 255]) +
            struct.pack(">H", len(data)) + data)


def parse_8bimtext(text: str) -> bytes:
    """parse8BIM (meta.c:305): the line grammar back to binary 8BIM.
    IPTC lines (numeric dataset) aggregate into one 1028 resource."""
    records = []
    iptc = bytearray()
    iptc_pos = None
    for line in text.splitlines():
        m = _TEXT_LINE.match(line)
        if not m:
            continue
        ds, rec, name, value = m.groups()
        data = _parse_escape(value)
        if ds == "8BIM":
            if int(rec) == IPTC_ID and data == b"IPTC":
                iptc_pos = len(records)   # marker; ds#rec lines follow
                continue
            records.append((int(rec), name or "", data))
        else:
            if iptc_pos is None:
                iptc_pos = len(records)
            iptc += _iptc_record(ds, rec, data)
    if iptc or iptc_pos is not None:
        records.insert(iptc_pos if iptc_pos is not None else len(records),
                       (IPTC_ID, "", bytes(iptc)))
    return _build_8bim(records)


def parse_iptctext(text: str) -> bytes:
    """IPTCTEXT read: '<ds>#<rec>#<name>="value"' lines to IPTC stream."""
    out = bytearray()
    for line in text.splitlines():
        m = _TEXT_LINE.match(line)
        if not m or m.group(1) == "8BIM":
            continue
        ds, rec, _name, value = m.groups()
        out += _iptc_record(ds, rec, _parse_escape(value))
    return bytes(out)


def iptc_from_8bim(blob: bytes) -> Optional[bytes]:
    """GetIPTCStream: the IPTC payload inside an 8BIM wrapper (or the
    blob itself when it already starts with an IPTC tag mark)."""
    if blob[:1] == b"\x1c":
        return blob
    for rid, _name, data in _iter_8bim(blob):
        if rid == IPTC_ID:
            return data
    return None


def decode_meta(data: bytes, fmt: str, device="cuda") -> Image:
    """ReadMETAImage (meta.c:1198): a 1x1 white image on ``device``
    carrying the blob as the profile the format names; *TEXT variants
    parse the text grammar back to binary first.  A bare IPTC stream is
    kept as it is under "iptc" (the reference wraps it into an 8BIM
    container, meta.c:1310)."""
    fmt = fmt.lower()
    key = _META_PROFILE[fmt]
    if fmt == "8bimtext":
        payload = parse_8bimtext(data.decode("utf-8", "replace"))
    elif fmt == "iptctext":
        payload = parse_iptctext(data.decode("utf-8", "replace"))
    else:
        payload = data
    im = Image(np.ones((1, 1, 3), np.float32),
               ImageSpec(colorspace="srgb", alpha=False, depth=8),
               device=device)
    im.profiles[key] = payload
    return im


def encode_meta(image: Image, fmt: str) -> bytes:
    """WriteMETAImage (meta.c:2276): emit the named profile; text
    variants run the formatter; IPTC extracts the stream from 8BIM."""
    fmt = fmt.lower()
    key = _META_PROFILE[fmt]
    prof = image.profiles.get(key)
    if prof is None and key == "iptc":
        prof8 = image.profiles.get("8bim")
        if prof8 is not None:
            prof = iptc_from_8bim(bytes(prof8))
    if prof is None and fmt in ("8bimtext",):
        prof = image.profiles.get("8bim")
    if prof is None:
        raise ValueError(f"META write: no {key} profile is available")
    prof = bytes(prof)
    if fmt == "8bimtext":
        return format_8bimtext(prof).encode()
    if fmt == "iptctext":
        if prof[:1] != b"\x1c":
            prof = iptc_from_8bim(prof) or b""
        return format_iptctext(prof).encode()
    if fmt == "iptc" and prof[:1] != b"\x1c":
        prof = iptc_from_8bim(prof) or b""
        if not prof:
            raise ValueError("META write: NoIPTCProfileAvailable")
    return prof


# ---------------------------------------------------------------------------
# DMR (Digital Media Repository)
# ---------------------------------------------------------------------------

class DMRError(ValueError):
    pass


def _cipher_blob(blob: bytes, passphrase: bytes) -> bytes:
    """AES-CTR whole-blob cipher for repository resources (the
    SetMagickCacheResourcePassphrase analog).  Self-inverse (CTR xor);
    key/nonce derived from SHA-256 of the passphrase."""
    import hashlib

    from ..utils.signature import _keystream

    key = hashlib.sha256(passphrase).digest()[:16]
    nonce = hashlib.sha256(passphrase + b"\x00imtpu-dmr-nonce").digest()[:16]
    ks = _keystream(key, nonce, 1, len(blob))[0]
    return (np.frombuffer(blob, np.uint8) ^ ks).tobytes()


def _dmr_root(settings: Optional[dict]) -> str:
    """The repository root (``dmr:path``, else $MAGICK_CACHE), refused
    inside ``no_host_files`` before it is looked at."""
    from ..core.policy import enforce_path

    settings = settings or {}
    defines = settings.get("defines", settings)
    path = defines.get("dmr:path") or os.environ.get("MAGICK_CACHE", "")
    enforce_path(path or "dmr:")
    if not path:
        raise DMRError("dmr: no repository path "
                       "(set -define dmr:path=/path or $MAGICK_CACHE)")
    return path


def _dmr_passphrase(settings: Optional[dict]) -> Optional[bytes]:
    from ..core.policy import enforce_path

    settings = settings or {}
    defines = settings.get("defines", settings)
    pp = defines.get("dmr:passphrase")
    if pp is None:
        return None
    enforce_path(pp)
    if os.path.exists(pp):   # FileToStringInfo: the option names a file
        with open(pp, "rb") as f:
            return f.read()
    return pp.encode()


def _safe_iri(iri: str) -> str:
    """Resolve an IRI to a repo-relative path, refusing escapes."""
    parts = [p for p in iri.split("/") if p not in ("", ".")]
    if any(p == ".." for p in parts) or not parts:
        raise DMRError(f"dmr: malformed resource IRI {iri!r}")
    return "/".join(parts)


def read_dmr(iri: str, settings: Optional[dict] = None,
             device="cuda") -> List[Image]:
    """ReadDMRImage (dmr.c:101): fetch image/blob/meta resources from
    the repository onto ``device``; passphrase-deciphered when
    dmr:passphrase is set."""
    root = _dmr_root(settings)
    rel = _safe_iri(iri)
    rtype = rel.split("/", 1)[0]
    base = os.path.join(root, rel)
    if not os.path.isdir(base):
        raise DMRError(f"dmr: no such resource {iri!r}")
    pp = _dmr_passphrase(settings)
    if rtype == "meta":
        with open(os.path.join(base, "resource.txt"), "rb") as f:
            meta = f.read()
        if pp is not None:
            meta = _cipher_blob(meta, pp)
        im = Image(np.zeros((1, 1, 3), np.float32),
                   ImageSpec(colorspace="srgb", alpha=False), device=device)
        im.properties["dmr:meta"] = meta.decode("utf-8", "replace")
        return [im]
    names = [n for n in sorted(os.listdir(base))
             if n.startswith("resource.")]
    if not names:
        raise DMRError(f"dmr: no such resource {iri!r}")
    with open(os.path.join(base, names[0]), "rb") as f:
        blob = f.read()
    if pp is not None:
        blob = _cipher_blob(blob, pp)
    from . import image_from_blob

    return image_from_blob(blob, device=device)


def write_dmr(images: List[Image], iri: str,
              settings: Optional[dict] = None) -> None:
    """DMR write: store the image list as a MIFF resource (blob/meta
    IRIs store raw payloads), enciphered when dmr:passphrase is set."""
    root = _dmr_root(settings)
    rel = _safe_iri(iri)
    rtype = rel.split("/", 1)[0]
    base = os.path.join(root, rel)
    os.makedirs(base, exist_ok=True)
    pp = _dmr_passphrase(settings)
    if rtype == "meta":
        meta = images[0].properties.get("dmr:meta", "").encode()
        if pp is not None:
            meta = _cipher_blob(meta, pp)
        with open(os.path.join(base, "resource.txt"), "wb") as f:
            f.write(meta)
        return
    from . import miff

    blob = miff.encode(images, depth=16, compression="zip")
    if pp is not None:
        blob = _cipher_blob(blob, pp)
    with open(os.path.join(base, "resource.miff"), "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# The metafiles' raster tail (WMF here, EMF in emf.py)
# ---------------------------------------------------------------------------

def render_metafile(height: int, width: int, mvg: List[str], dibs,
                    device) -> Image:
    """A white canvas of ``height`` x ``width`` made on ``device``, the
    MVG primitives drawn on it, then each DIB (image, x, y, w, h)
    resized ("triangle") and composited over it there."""
    from ..ops.composite import composite_at
    from ..ops.draw import draw
    from ..ops.resize import resize

    out = torch.ones((height, width, 3), dtype=torch.float32,
                     device=checked_device(device, "metafile"))
    if mvg:
        out = draw(out, "\n".join(mvg), has_alpha=False)
    for img, dx, dy, dw, dh in dibs:
        scaled = resize(img.data[..., :3], max(int(round(dh)), 1),
                        max(int(round(dw)), 1), "triangle")
        out = composite_at(out, scaled, "over", int(round(dx)),
                           int(round(dy)), src_alpha=False,
                           dst_alpha=False)
    return Image(out, ImageSpec(colorspace="srgb", alpha=False, depth=8))


# ---------------------------------------------------------------------------
# WMF — native subset renderer (wmf.c re-design, no libwmf)
# ---------------------------------------------------------------------------

_WMF_PLACEABLE = 0x9AC6CDD7


def _colorref(lo: int, hi: int) -> str:
    v = (hi << 16) | lo
    return "#%02X%02X%02X" % (v & 255, (v >> 8) & 255, (v >> 16) & 255)


def decode_wmf(data: bytes, density: float = 72.0, device="cuda") -> Image:
    """Parse a (placeable) WMF record stream and rasterize it through the
    MVG renderer on ``device``.  Supported records: window org/ext,
    pen/brush/font objects, move/line, polyline/polygon/polypolygon,
    rectangle, round-rect, ellipse, text-out/ext-text-out, set-pixel,
    embedded DIBs (StretchDIB).  wmf.c's libwmf ipa plays the same role.
    A DIB of a layout the BMP reader declines is skipped, as in the JAX
    function."""
    off = 0
    bbox = None
    inch = 1440
    if len(data) >= 22 and struct.unpack("<I", data[:4])[0] == _WMF_PLACEABLE:
        left, top, right, bottom = struct.unpack("<4h", data[6:14])
        inch = struct.unpack("<H", data[14:16])[0] or 1440
        bbox = (left, top, right, bottom)
        off = 22
    if len(data) < off + 18:
        raise ValueError("WMF: truncated header")
    ftype, hsize = struct.unpack("<HH", data[off:off + 4])
    if ftype not in (1, 2) or hsize != 9:
        raise ValueError("WMF: not a metafile header")
    off += 18

    # pass over the records
    words = np.frombuffer(data[off:len(data) - ((len(data) - off) & 1)],
                          dtype="<u2")
    recs: List[Tuple[int, np.ndarray]] = []
    i = 0
    while i + 3 <= len(words):
        size = int(words[i]) | (int(words[i + 1]) << 16)
        func = int(words[i + 2])
        if size < 3 or i + size > len(words):
            break
        recs.append((func, words[i + 3:i + size]))
        if func == 0:
            break
        i += size

    # window transform: prefer SetWindowOrg/Ext, fall back to the
    # placeable bbox
    orgx = orgy = 0
    extw = exth = None
    for func, p in recs:
        if func == 0x020B and len(p) >= 2:      # SetWindowOrg (y, x)
            orgy, orgx = int(np.int16(p[0])), int(np.int16(p[1]))
        elif func == 0x020C and len(p) >= 2 and extw is None:  # SetWindowExt
            exth, extw = int(np.int16(p[0])), int(np.int16(p[1]))
    if bbox is not None:
        bw, bh = bbox[2] - bbox[0], bbox[3] - bbox[1]
        width = max(1, int(round(abs(bw) * density / inch)))
        height = max(1, int(round(abs(bh) * density / inch)))
        if extw is None:
            orgx, orgy, extw, exth = bbox[0], bbox[1], bw, bh
    else:
        if extw is None:
            orgx = orgy = 0
            extw = exth = 256
        width, height = abs(extw), abs(exth)
    sx = width / float(extw if extw else 1)
    sy = height / float(exth if exth else 1)

    def tx(x):
        return (int(np.int16(x)) - orgx) * sx

    def ty(y):
        return (int(np.int16(y)) - orgy) * sy

    # object table + graphics state -> MVG
    objects: Dict[int, dict] = {}
    pen = {"color": "#000000", "width": 1.0, "style": 0}
    brush = {"color": "#000000", "style": 1}     # BS_NULL=1 -> no fill
    font = {"size": 12.0, "name": None}
    text_color = "#000000"
    cur = (0.0, 0.0)
    mvg: List[str] = []
    dibs: List[Tuple[Image, float, float, float, float]] = []

    def _alloc(obj):
        for k in range(4096):
            if k not in objects:
                objects[k] = obj
                return

    def _style():
        stroke = "none" if pen["style"] == 5 else pen["color"]  # PS_NULL
        fill = "none" if brush["style"] == 1 else brush["color"]
        sw = max(pen["width"] * sx, 1.0) if stroke != "none" else 0
        s = f"stroke-width {sw:g} stroke {stroke} fill {fill}"
        if pen["style"] in (1, 2):        # PS_DASH / PS_DOT
            d = 6 * max(sw, 1.0) if pen["style"] == 1 else 2 * max(sw, 1.0)
            s += f" stroke-dasharray {d:g},{d:g}"
        return s

    def _text(x, y, text):
        fs = max(font["size"] * sy, 1.0)
        esc = text.replace("\\", "\\\\").replace("'", "\\'")
        mvg.append(f"push graphic-context fill {text_color} "
                   f"stroke none font-size {fs:g} "
                   f"text {tx(x):g},{ty(y):g} '{esc}' "
                   f"pop graphic-context")

    for func, p in recs:
        if func == 0x02FA and len(p) >= 5:        # CreatePenIndirect
            _alloc({"kind": "pen", "style": int(p[0]) & 15,
                    "width": max(1, int(np.int16(p[1]))),
                    "color": _colorref(int(p[3]), int(p[4]))})
        elif func == 0x02FC and len(p) >= 3:      # CreateBrushIndirect
            _alloc({"kind": "brush", "style": int(p[0]),
                    "color": _colorref(int(p[1]), int(p[2]))})
        elif func == 0x02FB:                      # CreateFontIndirect
            hgt = abs(int(np.int16(p[0]))) if len(p) else 12
            name = b""
            if len(p) > 9:
                name = p[9:].tobytes().split(b"\x00")[0]
            _alloc({"kind": "font", "size": max(hgt, 1),
                    "name": name.decode("latin-1", "replace") or None})
        elif func in (0x00F7, 0x0142, 0x06FF):    # pattern brushes etc
            _alloc({"kind": "brush", "style": 0, "color": "#808080"})
        elif func == 0x012D and len(p) >= 1:      # SelectObject
            obj = objects.get(int(p[0]))
            if obj:
                if obj["kind"] == "pen":
                    pen = obj
                elif obj["kind"] == "brush":
                    brush = obj
                elif obj["kind"] == "font":
                    font = {"size": obj["size"], "name": obj.get("name")}
        elif func == 0x01F0 and len(p) >= 1:      # DeleteObject
            objects.pop(int(p[0]), None)
        elif func == 0x0209 and len(p) >= 2:      # SetTextColor
            text_color = _colorref(int(p[0]), int(p[1]))
        elif func == 0x0214 and len(p) >= 2:      # MoveTo (y, x)
            cur = (tx(p[1]), ty(p[0]))
        elif func == 0x0213 and len(p) >= 2:      # LineTo
            nxt = (tx(p[1]), ty(p[0]))
            mvg.append(f"push graphic-context {_style()} fill none "
                       f"line {cur[0]:g},{cur[1]:g} {nxt[0]:g},{nxt[1]:g} "
                       f"pop graphic-context")
            cur = nxt
        elif func in (0x0324, 0x0325) and len(p) >= 1:   # Polygon/Polyline
            n = int(p[0])
            pts = " ".join(f"{tx(p[1 + 2 * k]):g},{ty(p[2 + 2 * k]):g}"
                           for k in range(n) if 2 + 2 * k < len(p))
            prim = "polygon" if func == 0x0324 else "polyline"
            style = _style() if func == 0x0324 else \
                _style().replace(f"fill {brush['color']}", "fill none")
            mvg.append(f"push graphic-context {style} {prim} {pts} "
                       f"pop graphic-context")
        elif func == 0x0538 and len(p) >= 1:      # PolyPolygon
            np_ = int(p[0])
            counts = [int(p[1 + k]) for k in range(np_)]
            base_i = 1 + np_
            for cnt in counts:
                pts = " ".join(
                    f"{tx(p[base_i + 2 * k]):g},{ty(p[base_i + 2 * k + 1]):g}"
                    for k in range(cnt) if base_i + 2 * k + 1 < len(p))
                mvg.append(f"push graphic-context {_style()} polygon {pts} "
                           f"pop graphic-context")
                base_i += 2 * cnt
        elif func in (0x041B, 0x0418) and len(p) >= 4:  # Rectangle/Ellipse
            b, r, t, l = (ty(p[0]), tx(p[1]), ty(p[2]), tx(p[3]))
            if func == 0x041B:
                mvg.append(f"push graphic-context {_style()} rectangle "
                           f"{l:g},{t:g} {r:g},{b:g} pop graphic-context")
            else:
                cx, cy = (l + r) / 2, (t + b) / 2
                mvg.append(f"push graphic-context {_style()} ellipse "
                           f"{cx:g},{cy:g} {abs(r - l) / 2:g},"
                           f"{abs(b - t) / 2:g} 0,360 pop graphic-context")
        elif func == 0x061C and len(p) >= 6:      # RoundRect
            eh = abs(int(np.int16(p[0]))) * sy
            ew = abs(int(np.int16(p[1]))) * sx
            b, r, t, l = (ty(p[2]), tx(p[3]), ty(p[4]), tx(p[5]))
            mvg.append(f"push graphic-context {_style()} roundrectangle "
                       f"{l:g},{t:g} {r:g},{b:g} {ew / 2:g},{eh / 2:g} "
                       f"pop graphic-context")
        elif func == 0x041F and len(p) >= 4:      # SetPixel
            color = _colorref(int(p[0]), int(p[1]))
            mvg.append(f"push graphic-context fill {color} stroke none "
                       f"point {tx(p[3]):g},{ty(p[2]):g} pop graphic-context")
        elif func == 0x0521 and len(p) >= 1:      # TextOut
            cnt = int(p[0])
            raw = p[1:].tobytes()
            text = raw[:cnt].decode("latin-1", "replace")
            rest = raw[cnt + (cnt & 1):]
            if len(rest) >= 4:
                y, x = struct.unpack("<hh", rest[:4])
                _text(x, y, text)
        elif func == 0x0A32 and len(p) >= 4:      # ExtTextOut
            y, x, cnt, opts = (int(np.int16(p[0])), int(np.int16(p[1])),
                               int(p[2]), int(p[3]))
            skip = 4 + (4 if opts & 0x6 else 0)   # optional clip rect
            text = p[skip:].tobytes()[:cnt].decode("latin-1", "replace")
            if text:
                _text(x, y, text)
        elif func in (0x0F43, 0x0B41):            # StretchDIB / DIBStretchBlt
            try:
                img, rect = _wmf_dib(func, p, device)
                dibs.append((img, tx(rect[0]), ty(rect[1]),
                             max(rect[2] * sx, 1), max(rect[3] * sy, 1)))
            except Exception:   # noqa: BLE001 — unsupported DIB layout
                pass

    return render_metafile(height, width, mvg, dibs, device)


def _wmf_dib(func: int, p: np.ndarray, device):
    """Decode the embedded DIB of a StretchDIB/DIBStretchBlt record onto
    ``device``; returns (Image, (dstX, dstY, dstW, dstH)) in metafile
    units."""
    if func == 0x0F43:
        # layout: [rop lo, rop hi, usage, srcH, srcW, srcY, srcX,
        #          dstH, dstW, dstY, dstX, dib...]
        hdr = 11
        dsth, dstw = int(np.int16(p[7])), int(np.int16(p[8]))
        dsty, dstx = int(np.int16(p[9])), int(np.int16(p[10]))
    else:
        # rop(2w) srcH srcW srcY srcX dstH dstW dstY dstX dib...
        hdr = 10
        dsth, dstw = int(np.int16(p[6])), int(np.int16(p[7]))
        dsty, dstx = int(np.int16(p[8])), int(np.int16(p[9]))
    dib = p[hdr:].tobytes()
    if len(dib) < 40:
        raise ValueError("no DIB payload")
    bmsize = 14 + len(dib)
    bisize = struct.unpack("<I", dib[:4])[0]
    bpp = struct.unpack("<H", dib[14:16])[0] if bisize >= 16 else 24
    ncolors = struct.unpack("<I", dib[32:36])[0] if bisize >= 36 else 0
    if ncolors == 0 and bpp <= 8:
        ncolors = 1 << bpp
    dataoff = 14 + bisize + 4 * ncolors
    bmp = (b"BM" + struct.pack("<IHHI", bmsize, 0, 0, dataoff) + dib)
    from . import image_from_blob

    img = image_from_blob(bmp, "bmp", device)[0]
    return img, (dstx, dsty, dstw, dsth)


# ---------------------------------------------------------------------------
# JBIG (jbig-kit, the library coders/jbig.c delegates to)
# ---------------------------------------------------------------------------

def decode_jbig(data: bytes, device="cuda") -> Image:
    """ReadJBIGImage (coders/jbig.c): incremental jbg_dec_in over the
    blob; 1 = black, surfaced as a bilevel gray raster on ``device``."""
    from .. import native

    bits = native.jbig_decode(data)
    if bits is None:
        raise ValueError("JBIG decode failed (libjbig unavailable or "
                         "corrupt stream)")
    arr = (1.0 - bits.astype(np.float32))[..., None]
    return Image(arr, ImageSpec(colorspace="gray", alpha=False, depth=1),
                 device=device)


def encode_jbig(image: Image) -> bytes:
    """WriteJBIGImage (coders/jbig.c): 50%-threshold bilevel encode."""
    from .. import native

    arr = image.to_numpy().astype(np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    inten = _intensity(arr)
    bm = (inten < 0.5).astype(np.uint8)   # 1 = black
    blob = native.jbig_encode(bm)
    if blob is None:
        raise ValueError("JBIG encode failed (libjbig unavailable)")
    return blob
