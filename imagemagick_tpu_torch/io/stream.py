"""Incremental pixel streaming: row-batch callbacks without a full decode.

Port of ``imagemagick_tpu/io/stream.py``.  ImageMagick's ``stream``
utility (MagickCore/stream.c:993 ReadStream / :121 StreamImagePixels)
walks an image a row batch at a time through a user callback, never
holding the full pixel store.  Here:

  * binary PNM (P5/P6), raw gray/rgb/rgba/bgr, and uncompressed MIFF are
    streamed TRULY incrementally — each batch is one byte-range read
    (a MIFF's header from its first 64 KiB);
  * other formats fall back to a full decode on the CPU with batched
    delivery (the callback contract is identical; memory is not bounded).

``read_stream`` and ``open_rows`` are host readers: the callback and the
loader receive float32 numpy (rows, W, C) batches, and a callback may
return False to stop early (the reference's StreamHandler contract).
``convert_streaming`` puts each band on ``device`` (the card unless the
caller asks for the CPU) through ``models.outofcore.run_chain`` and
encodes each output band as it comes back: the never-resident convert.

The JAX ``read_stream`` reads a whole MIFF file to parse its header; the
port reads the header as ``open_rows`` does and delivers the same rows.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Callable, Optional, Tuple

import numpy as np

StreamHandler = Callable[[np.ndarray, int], Optional[bool]]

_MIFF_HEAD = 64 * 1024
_RAW_CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4, "bgr": 3}


def _pnm_header(f) -> Tuple[str, int, int, int, int]:
    """Parse a binary PNM header; returns (kind, w, h, maxval, data_off)."""
    data = f.read(512)
    m = re.match(rb"(P[56])\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+(\d+)\s",
                 data)
    if not m:
        raise ValueError("not a binary PNM stream")
    kind = m.group(1).decode()
    w, h, maxval = int(m.group(2)), int(m.group(3)), int(m.group(4))
    return kind, w, h, maxval, m.end()


def _miff_layout(f):
    """(w, h, c, itemsize, dtype, scale, data offset) of an uncompressed
    DirectClass MIFF from its first 64 KiB, or None for another MIFF."""
    from . import miff as miffmod

    fields, off = miffmod._parse_header(f.read(_MIFF_HEAD), 0)
    comp = fields.get("compression", "None").lower()
    cls = fields.get("class", "DirectClass").lower()
    if comp not in ("none", "undefined") or cls != "directclass" \
            or "__profiles__" in fields:
        return None
    w = int(fields["columns"])
    h = int(fields["rows"])
    depth = int(fields.get("depth", "16"))
    cs = fields.get("colorspace", "sRGB").lower()
    alpha = fields.get("alpha", "False").lower() == "true"
    c = (1 if "gray" in cs else 4 if cs == "cmyk" else 3) + \
        (1 if alpha else 0)
    qfmt = fields.get("quantum:format",
                      fields.get("quantum-format", "")).lower()
    if qfmt == "floating-point":
        # Q16-HDRI half-float / Q32 float payloads, values already
        # normalized [0,1] (miff.c quantum:format), as miff.decode reads
        itemsize, dtype = (2, ">f2") if depth == 16 else (4, ">f4")
        scale = 1.0
    else:
        itemsize, dtype = (1, np.uint8) if depth == 8 else (2, ">u2")
        scale = 255.0 if depth == 8 else 65535.0
    return w, h, c, itemsize, dtype, scale, off


def _raw_layout(filename: str, size: Optional[str]):
    ext = os.path.splitext(filename)[1].lstrip(".").lower()
    if ext not in _RAW_CHANNELS or not size:
        return None
    from ..core.geometry import parse_geometry

    g = parse_geometry(size)
    return int(g.width), int(g.height), _RAW_CHANNELS[ext], 1, np.uint8, \
        255.0, 0


def _rows(raw: bytes, n: int, w: int, c: int, dtype, scale) -> np.ndarray:
    a = np.frombuffer(raw, dtype, n * w * c).astype(np.float32)
    return (a / scale).reshape(n, w, c)


def read_stream(filename: str, handler: StreamHandler,
                rows_per_batch: int = 64,
                size: Optional[str] = None) -> int:
    """ReadStream analog: deliver row batches to `handler`; returns rows
    delivered.  Incremental for P5/P6 PNM, raw (needs `size`), and
    uncompressed MIFF; full-decode fallback otherwise."""
    from ..core.policy import enforce_path

    enforce_path(filename)

    def deliver_incremental(f, w, h, c, itemsize, dtype, scale, offset):
        f.seek(offset)
        row_bytes = w * c * itemsize
        done = 0
        while done < h:
            n = min(rows_per_batch, h - done)
            raw = f.read(row_bytes * n)
            if len(raw) < row_bytes * n:
                break
            if handler(_rows(raw, n, w, c, dtype, scale), done) is False:
                return done + n
            done += n
        return done

    with open(filename, "rb") as f:
        head = f.read(16)
        f.seek(0)
        layout = None
        if head[:2] in (b"P5", b"P6"):
            kind, w, h, maxval, off = _pnm_header(f)
            c = 1 if kind == "P5" else 3
            layout = (w, h, c) + ((1, np.uint8) if maxval < 256
                                  else (2, ">u2")) + (float(maxval), off)
        elif head[:14] == b"id=ImageMagick":
            layout = _miff_layout(f)
        if layout is None:
            layout = _raw_layout(filename, size)
        if layout is not None:
            return deliver_incremental(f, *layout)

    # fallback: full decode on the CPU, batched delivery (memory NOT
    # bounded)
    from . import read_images

    arr = read_images(filename, size=size, device="cpu")[0].to_numpy()
    h = arr.shape[0]
    done = 0
    while done < h:
        n = min(rows_per_batch, h - done)
        if handler(arr[done:done + n], done) is False:
            return done + n
        done += n
    return done


def open_rows(filename: str, size: Optional[str] = None):
    """Random-access row-range reader for streamable formats.

    Returns (loader, (H, W, C)) where loader(y0, y1) -> float32
    (y1-y0, W, C) reads exactly that byte range from disk — the source
    contract of models/outofcore.run_chain, so an op chain can run over
    an image that is never fully resident (stream.c ReadStream's window
    + cache.c's disk cache rolled together).  Supports binary PNM
    (P5/P6), uncompressed DirectClass MIFF, and raw gray/rgb/rgba/bgr
    with an explicit size.
    """
    from ..core.policy import enforce_path

    enforce_path(filename)
    with open(filename, "rb") as f:
        head = f.read(16)
        f.seek(0)
        if head[:2] in (b"P5", b"P6"):
            kind, w, h, maxval, off = _pnm_header(f)
            c = 1 if kind == "P5" else 3
            itemsize, dtype = (1, np.uint8) if maxval < 256 else (2, ">u2")
            scale = float(maxval)
        elif head[:14] == b"id=ImageMagick":
            layout = _miff_layout(f)
            if layout is None:
                raise ValueError("open_rows: only uncompressed DirectClass "
                                 "MIFF streams are row-addressable")
            w, h, c, itemsize, dtype, scale, off = layout
        else:
            layout = _raw_layout(filename, size)
            if layout is None:
                raise ValueError(f"open_rows: {filename!r} is not a "
                                 "row-addressable stream format")
            w, h, c, itemsize, dtype, scale, off = layout
    row_bytes = w * c * itemsize

    def loader(y0: int, y1: int) -> np.ndarray:
        with open(filename, "rb") as fh:
            fh.seek(off + y0 * row_bytes)
            raw = fh.read(row_bytes * (y1 - y0))
        return _rows(raw, y1 - y0, w, c, dtype, scale)

    return loader, (h, w, c)


class _IncrementalWriter:
    """numpy-assignment shim: run_chain writes out[y0:y1] = band in
    ascending order; each slice is encoded and flushed immediately —
    the output is never fully resident (WriteStream, stream.c:993).

    Formats: binary PNM (P5/P6), raw gray/rgb, uncompressed DirectClass
    MIFF, and PNG (zlib-streamed IDAT chunks, filter 0 rows)."""

    def __init__(self, out_path: str, fmt: str, Hout: int, Wout: int,
                 depth: int):
        self.path = out_path
        self.fmt = fmt
        self.h, self.w = Hout, Wout
        self.depth = depth
        self.f = None
        self.next_row = 0
        self.cout = None
        self._z = None          # PNG zlib stream

    def _begin(self, cout: int):
        self.cout = cout
        self.f = open(self.path, "wb")
        maxval = (1 << self.depth) - 1
        if self.fmt == "pnm":
            if cout not in (1, 3):
                raise ValueError(
                    f"streaming PNM supports 1 or 3 channels, chain "
                    f"produced {cout} (flatten or -separate alpha first)")
            kind = b"P5" if cout == 1 else b"P6"
            head = kind + b"\n%d %d\n%d\n" % (self.w, self.h, maxval)
        elif self.fmt == "miff":
            cs = "Gray" if cout == 1 else "sRGB"
            alpha = "True" if cout in (2, 4) else "False"
            head = (f"id=ImageMagick  version=1.0\n"
                    f"class=DirectClass  colors=0  alpha={alpha}\n"
                    f"columns={self.w}  rows={self.h}  depth={self.depth}\n"
                    f"colorspace={cs}\ncompression=None\n\x0c\n:\x1a"
                    ).encode("latin-1")
        elif self.fmt == "png":
            if cout not in (1, 2, 3, 4):
                raise ValueError(f"PNG cannot carry {cout} channels")
            ctype = {1: 0, 2: 4, 3: 2, 4: 6}[cout]
            bitdepth = 8 if self.depth == 8 else 16
            head = b"\x89PNG\r\n\x1a\n" + self._chunk_bytes(
                b"IHDR", struct.pack(">IIBBBBB", self.w, self.h, bitdepth,
                                     ctype, 0, 0, 0))
            self._z = zlib.compressobj(6)
        elif self.fmt == "raw":
            head = b""
        else:
            raise ValueError(f"no incremental writer for {self.fmt!r}")
        self.f.write(head)

    @staticmethod
    def _chunk_bytes(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload +
                struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    def __setitem__(self, key, value):
        y0, y1 = key.start or 0, key.stop
        assert y0 == self.next_row, "bands must arrive in order"
        value = np.asarray(value)
        if self.f is None:
            self._begin(value.shape[-1])
        maxval = (1 << self.depth) - 1
        # float64 products, as the JAX writer quantizes, a few rows at a
        # time so the float64 copy stays small
        rows = np.empty(value.shape, np.uint8 if self.depth == 8 else ">u2")
        step = max(1, (1 << 22) // max(1, value[0].size))
        for r0 in range(0, value.shape[0], step):
            q = value[r0:r0 + step].astype(np.float64)
            q *= maxval
            q += 0.5
            np.clip(q, 0, maxval, out=q)
            rows[r0:r0 + step] = q
        if self.fmt == "png":
            n = rows.shape[0]
            body = np.zeros((n, 1 + rows[0].size * rows.dtype.itemsize),
                            np.uint8)
            body[:, 1:] = rows.reshape(n, -1).view(np.uint8)
            data = self._z.compress(body.tobytes())
            if data:
                self.f.write(self._chunk_bytes(b"IDAT", data))
        else:
            self.f.write(rows.tobytes())
        self.next_row = y1

    def close(self):
        if self.f is not None:
            if self.fmt == "png" and self._z is not None:
                tail = self._z.flush()
                if tail:
                    self.f.write(self._chunk_bytes(b"IDAT", tail))
                self.f.write(self._chunk_bytes(b"IEND", b""))
            self.f.close()


_WRITER_EXT = {"pnm": "pnm", "ppm": "pnm", "pgm": "pnm",
               "miff": "miff", "png": "png",
               "gray": "raw", "rgb": "raw", "rgba": "raw"}


def convert_streaming(in_path: str, out_path: str, ops=(),
                      resize=None, post_ops=(), band_rows: int = 512,
                      depth: int = 8, size: Optional[str] = None,
                      device="cuda") -> None:
    """End-to-end never-resident convert: row-addressable input -> banded
    op chain (+ resize) on ``device`` -> incremental encoder.

    The tera-pixel tier as one call: input rows are read per band
    (open_rows), the chain runs via models/outofcore.run_chain, and each
    output band is encoded to disk as soon as it is computed (an
    out-array writer that never holds the full output).  Output formats:
    PNM, raw planes, uncompressed MIFF, PNG (streamed IDAT)."""
    from ..core.policy import enforce_path
    from ..models.outofcore import run_chain

    loader, (H, W, C) = open_rows(in_path, size=size)
    if resize is not None:
        Hout, Wout = resize[0], resize[1]
    else:
        Hout, Wout = H, W
    ext = os.path.splitext(out_path)[1].lstrip(".").lower()
    fmt = _WRITER_EXT.get(ext)
    if fmt is None:
        raise ValueError(
            f"convert_streaming: no incremental writer for {ext!r} "
            f"(supported: {sorted(_WRITER_EXT)})")
    enforce_path(out_path)

    w = _IncrementalWriter(out_path, fmt, Hout, Wout, depth)
    try:
        run_chain(loader, (H, W, C), ops, resize=resize,
                  post_ops=post_ops, band_rows=band_rows, out=w,
                  device=device)
    finally:
        w.close()
