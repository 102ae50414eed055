"""Binary metadata parsers: EXIF, IPTC (8BIM), XMP.

A copy of ``imagemagick_tpu/core/metadata.py``, pure Python over bytes.

Pure-Python struct walkers replacing the reference's in-C parsers
(MagickCore/property.c — GetEXIFProperty :827,
Get8BIMProperty :579, GetXMPProperty :1814).  Results land in
Image.properties as ``exif:*`` / ``iptc:*`` / ``xmp:*`` keys, driving the
``%[EXIF:...]`` escapes of the property interpreter and ``-auto-orient``
without relying on what PIL happens to surface.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, Optional

# --- EXIF tag names (the subset property.c's tag table surfaces most) -------

EXIF_TAGS = {
    0x010E: "ImageDescription", 0x010F: "Make", 0x0110: "Model",
    0x0112: "Orientation", 0x011A: "XResolution", 0x011B: "YResolution",
    0x0128: "ResolutionUnit", 0x0131: "Software", 0x0132: "DateTime",
    0x013B: "Artist", 0x8298: "Copyright", 0x829A: "ExposureTime",
    0x829D: "FNumber", 0x8822: "ExposureProgram", 0x8827: "ISOSpeedRatings",
    0x9000: "ExifVersion", 0x9003: "DateTimeOriginal",
    0x9004: "DateTimeDigitized", 0x9201: "ShutterSpeedValue",
    0x9202: "ApertureValue", 0x9203: "BrightnessValue",
    0x9204: "ExposureBiasValue", 0x9205: "MaxApertureValue",
    0x9206: "SubjectDistance", 0x9207: "MeteringMode", 0x9208: "LightSource",
    0x9209: "Flash", 0x920A: "FocalLength", 0x927C: "MakerNote",
    0x9286: "UserComment", 0xA000: "FlashpixVersion", 0xA001: "ColorSpace",
    0xA002: "ExifImageWidth", 0xA003: "ExifImageLength",
    0xA005: "InteroperabilityOffset", 0xA20E: "FocalPlaneXResolution",
    0xA20F: "FocalPlaneYResolution", 0xA210: "FocalPlaneResolutionUnit",
    0xA215: "ExposureIndex", 0xA217: "SensingMethod", 0xA300: "FileSource",
    0xA301: "SceneType", 0xA401: "CustomRendered", 0xA402: "ExposureMode",
    0xA403: "WhiteBalance", 0xA404: "DigitalZoomRatio",
    0xA405: "FocalLengthIn35mmFilm", 0xA406: "SceneCaptureType",
    0xA407: "GainControl", 0xA408: "Contrast", 0xA409: "Saturation",
    0xA40A: "Sharpness", 0xA40C: "SubjectDistanceRange",
    0xA420: "ImageUniqueID", 0x0100: "ImageWidth", 0x0101: "ImageLength",
    0x0102: "BitsPerSample", 0x0103: "Compression",
    0x0106: "PhotometricInterpretation", 0x0115: "SamplesPerPixel",
    0x8769: "ExifOffset", 0x8825: "GPSInfo", 0x9290: "SubSecTime",
    0x9291: "SubSecTimeOriginal", 0x9292: "SubSecTimeDigitized",
    0xA430: "CameraOwnerName", 0xA431: "BodySerialNumber",
    0xA432: "LensSpecification", 0xA433: "LensMake", 0xA434: "LensModel",
}

GPS_TAGS = {
    0x0000: "GPSVersionID", 0x0001: "GPSLatitudeRef", 0x0002: "GPSLatitude",
    0x0003: "GPSLongitudeRef", 0x0004: "GPSLongitude",
    0x0005: "GPSAltitudeRef", 0x0006: "GPSAltitude", 0x0007: "GPSTimeStamp",
    0x001D: "GPSDateStamp",
}

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8}

# IPTC record 2 dataset names (property.c Get8BIMProperty's table subset)
IPTC_DATASETS = {
    5: "Image Name", 7: "Edit Status", 10: "Priority", 15: "Category",
    20: "Supplemental Category", 22: "Fixture Identifier", 25: "Keyword",
    30: "Release Date", 35: "Release Time", 40: "Special Instructions",
    45: "Reference Service", 47: "Reference Date", 50: "Reference Number",
    55: "Created Date", 60: "Created Time", 65: "Originating Program",
    70: "Program Version", 75: "Object Cycle", 80: "Byline",
    85: "Byline Title", 90: "City", 92: "Sub-Location",
    95: "Province State", 100: "Country Code", 101: "Country",
    103: "Original Transmission Reference", 105: "Headline",
    110: "Credit", 115: "Source", 116: "Copyright String", 120: "Caption",
    121: "Local Caption", 122: "Caption Writer", 200: "Custom Field 1",
}


def _read_value(data: bytes, bo: str, vtype: int, count: int, off: int):
    size = _TYPE_SIZE.get(vtype, 1) * count
    raw = data[off:off + size]
    if vtype == 2:      # ASCII
        return raw.split(b"\0", 1)[0].decode("latin-1", "replace")
    if vtype in (1, 6, 7):
        if count == 1:
            return raw[0] if raw else 0
        return raw
    if vtype in (3, 8):
        fmt = bo + ("H" if vtype == 3 else "h")
        vals = [struct.unpack_from(fmt, raw, 2 * i)[0] for i in range(count)]
    elif vtype in (4, 9):
        fmt = bo + ("I" if vtype == 4 else "i")
        vals = [struct.unpack_from(fmt, raw, 4 * i)[0] for i in range(count)]
    elif vtype in (5, 10):
        fmt = bo + ("II" if vtype == 5 else "ii")
        vals = []
        for i in range(count):
            num, den = struct.unpack_from(fmt, raw, 8 * i)
            vals.append(f"{num}/{den}" if den not in (0, 1) else
                        (num if den == 1 else f"{num}/0"))
    elif vtype == 11:
        vals = [struct.unpack_from(bo + "f", raw, 4 * i)[0]
                for i in range(count)]
    elif vtype == 12:
        vals = [struct.unpack_from(bo + "d", raw, 8 * i)[0]
                for i in range(count)]
    else:
        return raw
    if count == 1:
        return vals[0]
    return ", ".join(str(v) for v in vals)


def _parse_ifd(data: bytes, bo: str, offset: int, tags: Dict[int, str],
               out: Dict[str, str], depth: int = 0) -> None:
    if depth > 4 or offset + 2 > len(data):
        return
    (n,) = struct.unpack_from(bo + "H", data, offset)
    pos = offset + 2
    for _ in range(min(n, 512)):
        if pos + 12 > len(data):
            return
        tag, vtype, count = struct.unpack_from(bo + "HHI", data, pos)
        size = _TYPE_SIZE.get(vtype, 1) * count
        if size <= 4:
            val_off = pos + 8
        else:
            (val_off,) = struct.unpack_from(bo + "I", data, pos + 8)
        if tag == 0x8769 and vtype == 4:      # EXIF sub-IFD
            (sub,) = struct.unpack_from(bo + "I", data, pos + 8)
            _parse_ifd(data, bo, sub, EXIF_TAGS, out, depth + 1)
        elif tag == 0x8825 and vtype == 4:    # GPS IFD
            (sub,) = struct.unpack_from(bo + "I", data, pos + 8)
            _parse_ifd(data, bo, sub, GPS_TAGS, out, depth + 1)
        else:
            name = tags.get(tag)
            if name and val_off + size <= len(data):
                val = _read_value(data, bo, vtype, count, val_off)
                if isinstance(val, bytes):
                    val = val[:64].hex()
                out.setdefault(f"exif:{name}", str(val))
        pos += 12


def parse_exif(blob: bytes) -> Dict[str, str]:
    """Parse a TIFF-structured EXIF blob (property.c:827 GetEXIFProperty).

    Accepts raw TIFF bytes or an APP1 payload with the 'Exif\\0\\0' prefix.
    """
    if blob[:6] == b"Exif\x00\x00":
        blob = blob[6:]
    if blob[:2] == b"II":
        bo = "<"
    elif blob[:2] == b"MM":
        bo = ">"
    else:
        return {}
    try:
        (magic,) = struct.unpack_from(bo + "H", blob, 2)
        if magic != 42:
            return {}
        (ifd0,) = struct.unpack_from(bo + "I", blob, 4)
        out: Dict[str, str] = {}
        _parse_ifd(blob, bo, ifd0, EXIF_TAGS, out)
        return out
    except struct.error:
        return {}


def parse_8bim(blob: bytes) -> Dict[str, str]:
    """Parse Photoshop 8BIM resource blocks; IPTC lives in resource 0x0404
    (property.c:579 Get8BIMProperty)."""
    out: Dict[str, str] = {}
    pos = 0
    if blob[:14] == b"Photoshop 3.0\x00":
        pos = 14
    n = len(blob)
    while pos + 12 <= n:
        if blob[pos:pos + 4] != b"8BIM":
            pos += 1
            continue
        (rid,) = struct.unpack_from(">H", blob, pos + 4)
        pos += 6
        name_len = blob[pos]
        pos += 1 + name_len
        if (name_len + 1) % 2:
            pos += 1
        (size,) = struct.unpack_from(">I", blob, pos)
        pos += 4
        payload = blob[pos:pos + size]
        pos += size + (size % 2)
        if rid == 0x0404:
            out.update(parse_iptc(payload))
        elif rid == 0x040F:
            out["icc:payload-bytes"] = str(size)
    return out


def clip_path_from_8bim(blob: bytes, width: int, height: int
                        ) -> "Optional[str]":
    """First Photoshop clip path (resource ids 2000-2997) as an SVG path.

    Mirrors TracePSClippingPath (property.c Get8BIMProperty '#1' form):
    path records are 26 bytes — a selector then 3 (y, x) points as signed
    32-bit 8.24 fixed fractions of the canvas; knots chain into cubic
    beziers (prev control-out, this control-in, this anchor)."""
    pos = 14 if blob[:14] == b"Photoshop 3.0\x00" else 0
    n = len(blob)
    payload = None
    while pos + 12 <= n:
        if blob[pos:pos + 4] != b"8BIM":
            pos += 1
            continue
        (rid,) = struct.unpack_from(">H", blob, pos + 4)
        pos += 6
        name_len = blob[pos]
        pos += 1 + name_len
        if (name_len + 1) % 2:
            pos += 1
        (size,) = struct.unpack_from(">I", blob, pos)
        pos += 4
        if 2000 <= rid <= 2997:
            payload = blob[pos:pos + size]
            break
        pos += size + (size % 2)
    if payload is None:
        return None

    def pt(off):
        y, x = struct.unpack_from(">ii", payload, off)
        return (x / (1 << 24)) * width, (y / (1 << 24)) * height

    subpaths = []
    knots: list = []
    for off in range(0, len(payload) - 25, 26):
        (sel,) = struct.unpack_from(">H", payload, off)
        if sel in (0, 3):                      # subpath length record
            if knots:
                subpaths.append(knots)
            knots = []
        elif sel in (1, 2, 4, 5):              # knot: in, anchor, out
            knots.append((pt(off + 2), pt(off + 10), pt(off + 18)))
    if knots:
        subpaths.append(knots)
    if not subpaths:
        return None
    parts = []
    for kn in subpaths:
        (x0, y0) = kn[0][1]
        parts.append(f"M{x0:.4g},{y0:.4g}")
        for i in range(1, len(kn) + 1):
            prev, cur = kn[i - 1], kn[i % len(kn)]
            (c1x, c1y), (c2x, c2y), (ax, ay) = \
                prev[2], cur[0], cur[1]
            parts.append(f"C{c1x:.4g},{c1y:.4g} {c2x:.4g},{c2y:.4g} "
                         f"{ax:.4g},{ay:.4g}")
        parts.append("Z")
    return " ".join(parts)


def parse_iptc(blob: bytes) -> Dict[str, str]:
    """Parse raw IPTC-NAA datasets (0x1C record dataset len payload)."""
    out: Dict[str, str] = {}
    pos = 0
    n = len(blob)
    while pos + 5 <= n:
        if blob[pos] != 0x1C:
            pos += 1
            continue
        record, dataset = blob[pos + 1], blob[pos + 2]
        (length,) = struct.unpack_from(">H", blob, pos + 3)
        pos += 5
        if length & 0x8000:   # extended length — skip conservatively
            break
        payload = blob[pos:pos + length]
        pos += length
        if record == 2:
            name = IPTC_DATASETS.get(dataset, f"unknown[{dataset}]")
            key = f"iptc:{name}"
            val = payload.decode("utf-8", "replace")
            if key in out:
                out[key] += ";" + val
            else:
                out[key] = val
    return out


def parse_xmp(blob: bytes) -> Dict[str, str]:
    """Flatten an XMP packet into xmp:* properties (property.c:1814)."""
    try:
        text = blob.decode("utf-8", "replace")
    except Exception:
        return {}
    out: Dict[str, str] = {}
    # attribute-style properties on rdf:Description
    for m in re.finditer(r'([A-Za-z][\w]*):([A-Za-z][\w.-]*)="([^"]*)"', text):
        ns, name, val = m.groups()
        if ns in ("xmlns", "x", "rdf"):
            continue
        out.setdefault(f"xmp:{name}", val)
    # element-style <ns:Name>value</ns:Name>
    for m in re.finditer(r"<(?!/)(?!x:)(?!rdf:)([A-Za-z][\w]*):"
                         r"([A-Za-z][\w.-]*)>([^<]+)</\1:\2>", text):
        ns, name, val = m.groups()
        out.setdefault(f"xmp:{name}", val.strip())
    return out


# --- container extraction ----------------------------------------------------

def extract_jpeg_metadata(data: bytes) -> Dict[str, str]:
    """Walk JPEG APPn markers for EXIF (APP1), XMP (APP1), IPTC (APP13)."""
    out: Dict[str, str] = {}
    if data[:2] != b"\xff\xd8":
        return out
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xDA:   # start of scan — metadata is before this
            break
        (seglen,) = struct.unpack_from(">H", data, pos + 2)
        seg = data[pos + 4:pos + 2 + seglen]
        if marker == 0xE1:
            if seg[:6] == b"Exif\x00\x00":
                out.update(parse_exif(seg))
            elif seg[:28] == b"http://ns.adobe.com/xap/1.0/":
                out.update(parse_xmp(seg[29:]))
        elif marker == 0xED:
            out.update(parse_8bim(seg))
        pos += 2 + seglen
    return out


def extract_png_metadata(data: bytes) -> Dict[str, str]:
    """PNG eXIf chunk + iTXt XML:com.adobe.xmp packet."""
    out: Dict[str, str] = {}
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return out
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if ctype == b"eXIf":
            out.update(parse_exif(payload))
        elif ctype == b"iTXt" and payload.startswith(b"XML:com.adobe.xmp"):
            xmp = payload.split(b"\x00", 5)[-1]
            out.update(parse_xmp(xmp))
        elif ctype == b"IDAT":
            break
        pos += 12 + length
    return out


def extract_tiff_metadata(data: bytes) -> Dict[str, str]:
    """TIFF IS the EXIF container: parse IFD0 directly."""
    return parse_exif(data)


def extract_metadata(data: bytes, fmt: Optional[str]) -> Dict[str, str]:
    f = (fmt or "").lower()
    if f in ("jpeg", "jpg") or data[:2] == b"\xff\xd8":
        return extract_jpeg_metadata(data)
    if f == "png" or data[:8] == b"\x89PNG\r\n\x1a\n":
        return extract_png_metadata(data)
    if f in ("tiff", "tif") or data[:4] in (b"II*\x00", b"MM\x00*"):
        return extract_tiff_metadata(data)
    return {}
