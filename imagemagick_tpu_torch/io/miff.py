"""MIFF, ImageMagick's own lossless format (coders/miff.c).

Port of ``imagemagick_tpu/io/miff.py``: a text ``key=value`` header ended
by ``:\x1a``, then big-endian samples, stored or compressed with zlib,
bzip2 or MIFF's run-length packets.  Read: DirectClass and PseudoClass
(the colormap expanded), 8-, 16- and 32-bit samples (16 and 32 also as
floating point), gray, sRGB and CMYK with or without alpha, binary
profiles, a montage directory, several frames, and the header's other
keys as properties.  Write: DirectClass at 8, 16 or 32 (float) bits, one
frame after another, stored or compressed row by row.  The header and
the samples are parsed and packed on the host with numpy; a decoded
frame goes to ``device`` once (the card unless the caller asks for the
CPU), and an encoded one comes to the host once.
"""

from __future__ import annotations

import bz2
import re
import zlib
from typing import Dict, List, Tuple

import numpy as np

from ..core.image import Image, host_property
from ..core.spec import ImageSpec, normalize_colorspace

_MAGIC = b"id=ImageMagick"


def _parse_header(data: bytes, pos: int) -> Tuple[Dict[str, str], int]:
    """Parse key=value pairs up to the ':' separator (miff.c ReadMIFFImage)."""
    fields: Dict[str, str] = {}
    token = b""
    comment = False
    key = None
    i = pos
    while i < len(data):
        ch = data[i:i + 1]
        if comment:
            if ch == b"}":
                comment = False
                fields["comment"] = token.decode("utf-8", "replace")
                token = b""
            else:
                token += ch
            i += 1
            continue
        if ch == b"{" and key is None:
            comment = True
            token = b""
            i += 1
            continue
        if ch == b":" and key is None and token == b"":
            # header terminator (a ':' starting a token, i.e. after
            # whitespace); may be followed by \x1a.  Keys themselves may
            # contain ':' (date:create=, quantum:format= — miff.c writes
            # namespaced attributes), so a mid-token colon is data.
            i += 1
            if data[i:i + 1] == b"\x1a":
                i += 1
            break
        if ch == b"=":
            key = token.decode("ascii", "replace").strip().lower()
            token = b""
            i += 1
            # value may be {...} quoted
            if data[i:i + 1] == b"{":
                j = data.index(b"}", i)
                _store_field(fields, key, data[i + 1:j].decode("utf-8", "replace"))
                key = None
                i = j + 1
            continue
        if ch.isspace():
            if key is not None:
                _store_field(fields, key, token.decode("utf-8", "replace"))
                key = None
            token = b""
            i += 1
            continue
        token += ch
        i += 1
    return fields, i


def _store_field(fields: Dict[str, str], key: str, value: str) -> None:
    # `profile=<name>` may repeat (one per attached profile, miff.c:948);
    # keep them in declaration order for the payload reads after the header.
    if key == "profile":
        fields.setdefault("__profiles__", []).append(value)  # type: ignore[arg-type]
    else:
        fields[key] = value


def _rle_expand(data: bytes, pos: int, sample_bytes: int, total_px: int
                ) -> Tuple[np.ndarray, int]:
    """Expand MIFF RLE packets: <pixel samples><count-1 byte> repeated.

    Runs never cross rows (miff.c WriteRLEPixels), so counts sum to
    exactly rows*columns.  Vectorized: packets are fixed-size, so the
    count bytes sit at a fixed stride.
    """
    ps = sample_bytes + 1
    avail = (len(data) - pos) // ps
    if avail == 0:
        raise ValueError("MIFF: truncated RLE stream")
    buf = np.frombuffer(data, np.uint8, count=avail * ps, offset=pos).reshape(avail, ps)
    counts = buf[:, -1].astype(np.int64) + 1
    csum = np.cumsum(counts)
    n_packets = int(np.searchsorted(csum, total_px) + 1)
    if csum[n_packets - 1] != total_px:
        raise ValueError("MIFF: RLE run total does not match pixel count")
    pixels = np.repeat(buf[:n_packets, :-1], counts[:n_packets], axis=0)
    return pixels.reshape(-1), pos + n_packets * ps


def decode(data: bytes, device="cuda") -> List[Image]:
    """The frames of a MIFF stream, each on ``device``."""
    images = []
    pos = 0
    while pos < len(data) and data[pos:pos + len(_MAGIC)].lower() == _MAGIC.lower():
        fields, pos = _parse_header(data, pos)
        w = int(fields["columns"])
        h = int(fields["rows"])
        depth = int(fields.get("depth", "16"))
        cs_name = fields.get("colorspace", "sRGB")
        try:
            cs = normalize_colorspace(cs_name)
        except ValueError:
            cs = "srgb"
        alpha = fields.get("alpha", fields.get("matte", "False")).lower() == "true"
        pseudo = fields.get("class", "DirectClass").lower() == "pseudoclass"
        colors = int(fields.get("colors", "0"))
        ncolor = 4 if cs == "cmyk" else (1 if cs in ("gray", "linear_gray") else 3)
        nch = ncolor + (1 if alpha else 0)
        compression = fields.get("compression", "None").lower()
        if compression not in ("none", "undefined", "zip", "zlib", "bzip", "rle",
                               "runlengthencoded"):
            raise ValueError(f"MIFF: unsupported compression {compression!r}")
        # montage directory: a NUL-terminated string follows the header
        # (miff.c:1161-1182); skip it.
        if "montage" in fields:
            pos = data.index(b"\x00", pos) + 1
        # binary profile payloads: MSB-u32 length + blob per declared name
        # (miff.c:1184-1223)
        profiles: Dict[str, bytes] = {}
        for name in fields.get("__profiles__", ()):  # type: ignore[arg-type]
            (plen,) = np.frombuffer(data, ">u4", count=1, offset=pos)
            pos += 4
            profiles[name] = data[pos:pos + int(plen)]
            pos += int(plen)
        qfmt = fields.get("quantum-format",
                          fields.get("quantum:format", ""))
        if depth == 8:
            itemsize, dt = 1, np.uint8
        elif depth == 16 and qfmt == "floating-point":
            # HDRI half-float quantums, normalized [0,1] (the reference
            # emits these for non-integer samples, e.g. MATTE of a
            # fractional alpha — quantum.c FloatingPointQuantumFormat)
            itemsize, dt = 2, ">f2"
        elif depth == 16:
            itemsize, dt = 2, ">u2"
        elif depth == 32 and qfmt == "floating-point":
            itemsize, dt = 4, ">f4"
        else:
            itemsize, dt = 4, ">u4"
        scale = {1: 255.0, 2: 65535.0, 4: 4294967295.0}[itemsize]
        colormap = None
        if pseudo:
            if colors <= 0:
                raise ValueError("MIFF: PseudoClass stream without colors=")
            # colormap: colors x RGB at `depth` bits, MSB (miff.c:1234)
            cmap_bytes = colors * 3 * itemsize
            cmap = np.frombuffer(data, dt, count=colors * 3, offset=pos)
            pos += cmap_bytes
            if dt == ">f4":
                raise ValueError("MIFF: float PseudoClass colormap unsupported")
            colormap = cmap.astype(np.float32).reshape(colors, 3) / scale
            nwire = 1 + (1 if alpha else 0)   # index (+ alpha) samples
        else:
            nwire = nch
        nsamples = w * h * nwire
        nbytes = nsamples * itemsize
        version = float(fields.get("version", "0") or "0")
        if compression in ("zip", "zlib", "bzip"):
            dec = (zlib.decompressobj() if compression != "bzip"
                   else bz2.BZ2Decompressor())
            if version != 0.0:
                # version>=1: stream split into MSB-u32 length-prefixed
                # chunks (miff.c:1573 read / :2710 write, Z_SYNC_FLUSH per
                # row + Z_FINISH tail); concatenated chunks form one stream.
                parts = []
                while pos + 4 <= len(data) and not dec.eof:
                    (clen,) = np.frombuffer(data, ">u4", count=1, offset=pos)
                    clen = int(clen)
                    if clen == 0 or pos + 4 + clen > len(data):
                        break
                    parts.append(dec.decompress(data[pos + 4:pos + 4 + clen]))
                    pos += 4 + clen
                raw = b"".join(parts)
            else:
                raw = dec.decompress(data[pos:], nbytes)
                pos = len(data) - len(dec.unused_data)
        elif compression in ("rle", "runlengthencoded"):
            expanded, pos = _rle_expand(data, pos, nwire * itemsize, w * h)
            raw = expanded.tobytes()
        else:
            raw = data[pos:pos + nbytes]
            pos += nbytes
        if len(raw) < nbytes:
            raise ValueError(f"MIFF: pixel payload truncated "
                             f"({len(raw)} < {nbytes} bytes)")
        arr = np.frombuffer(raw, dt, count=nsamples).reshape(h, w, nwire)
        if pseudo:
            idx = np.clip(arr[..., 0].astype(np.int64), 0, colors - 1)
            f = colormap[idx]
            if cs in ("gray", "linear_gray"):
                f = f[..., :1]
            if alpha:
                a = arr[..., 1].astype(np.float32) / scale
                f = np.concatenate([f, a[..., None]], axis=-1)
        elif dt in (">f4", ">f2"):
            f = arr.astype(np.float32)
        else:
            f = arr.astype(np.float32) / scale
        props = {k: v for k, v in fields.items()
                 if k not in ("columns", "rows", "depth", "colorspace", "alpha",
                              "matte", "compression", "class", "colors",
                              "quantum-format", "quantum:format", "quality",
                              "id", "version", "montage", "__profiles__")}
        img = Image(f, ImageSpec(colorspace=cs, alpha=alpha,
                                 depth=min(depth, 16)),
                    properties=props, profiles=profiles, device=device)
        images.append(img)
        # skip whitespace between frames
        while pos < len(data) and data[pos:pos + 1] in b"\r\n \t":
            pos += 1
    if not images:
        raise ValueError("not a MIFF stream")
    return images


def encode(images, depth: int = 16, compression: str = "none") -> bytes:
    """The MIFF bytes of one image or a list (a batch writes a frame per
    image); the pixels come to the host once an image."""
    if isinstance(images, Image):
        images = [images]
    out = bytearray()
    for img in images:
        arr = img.to_numpy()
        frames = arr if arr.ndim == 4 else arr[None]
        for frame in frames:
            out += _encode_one(frame, img.spec, img.properties, depth,
                               compression)
    return bytes(out)


_CS_NAMES = {
    "srgb": "sRGB", "rgb": "RGB", "gray": "Gray", "linear_gray": "LinearGray",
    "cmyk": "CMYK", "lab": "Lab", "xyz": "XYZ", "hsl": "HSL", "hsb": "HSB",
    "ycbcr": "YCbCr",
}


def _encode_one(arr: np.ndarray, spec: ImageSpec, properties: dict,
                depth: int, compression: str) -> bytes:
    arr = np.clip(arr, 0.0, 1.0)
    h, w, c = arr.shape
    cs = _CS_NAMES.get(spec.colorspace, "sRGB")
    comp_name = {"none": "None", "zip": "Zip", "zlib": "Zip", "bzip": "BZip"}[compression.lower()]
    head = (
        f"id=ImageMagick  version=1.0\n"
        f"class=DirectClass  colors=0  alpha={'True' if spec.alpha else 'False'}\n"
        f"columns={w}  rows={h}  depth={depth}\n"
        f"colorspace={cs}\n"
        f"compression={comp_name}  quality=0\n"
    )
    for k, v in properties.items():
        # Never re-emit quantum-format/quality keys: the encoder always
        # writes integer quantum at its chosen depth, so a stale
        # quantum:format=floating-point property would make re-decoders
        # misread the integer payload as half-floats (miff.c's encoder
        # likewise derives quantum:format from the actual pixel write).
        if str(k) in ("quantum-format", "quantum:format", "quality"):
            continue
        if re.match(r"^[A-Za-z][\w:.-]*$", str(k)):
            head += f"{k}={{{host_property(v)}}}\n"
    head += "\x0c\n:\x1a"
    if depth == 8:
        q = (arr * 255.0 + 0.5).astype(np.uint8)
    elif depth == 32:
        q = arr.astype(">f4")
        head = head.replace("compression=", "quantum-format=floating-point\ncompression=")
    else:
        q = (arr * 65535.0 + 0.5).astype(">u2")
    payload = q.tobytes()
    if comp_name == "Zip":
        payload = _frame_rows(payload, h, "zip")
    elif comp_name == "BZip":
        payload = _frame_rows(payload, h, "bzip")
    return head.encode("utf-8") + payload


def _frame_rows(payload: bytes, rows: int, kind: str) -> bytes:
    """Compress row-chunked with MSB-u32 length prefixes (miff.c:2710).

    The version>=1 wire format: one continuous compressed stream, flushed
    per row, each emitted piece prefixed with its big-endian u32 length so
    the reader can bound its input buffer.
    """
    row_bytes = len(payload) // rows
    out = bytearray()

    def emit(chunk: bytes) -> None:
        if chunk:
            out.extend(len(chunk).to_bytes(4, "big") + chunk)

    if kind == "zip":
        comp = zlib.compressobj(6)
        for y in range(rows):
            row = payload[y * row_bytes:(y + 1) * row_bytes]
            emit(comp.compress(row) + comp.flush(zlib.Z_SYNC_FLUSH))
        emit(comp.flush())
    else:
        comp = bz2.BZ2Compressor()
        for y in range(rows):
            emit(comp.compress(payload[y * row_bytes:(y + 1) * row_bytes]))
        emit(comp.flush())
    return bytes(out)
