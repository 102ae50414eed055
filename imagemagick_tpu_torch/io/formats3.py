"""Scientific and VFX interchange formats: MAT, VIFF, RLA, Palm and PICT.

Port of ``imagemagick_tpu/io/formats3.py``: numpy re-implementations of
the wire formats of ImageMagick's coders, from the public specs they
implement:

  MAT   read/write  (coders/mat.c: MATLAB level-4 and level-5 MAT-files,
                     with zlib-compressed miMATRIX elements)
  VIFF  read/write  (coders/viff.c: the Khoros Visualization 1024-byte
                     header, planar bands, both byte orders)
  RLA   read/write  (coders/rla.c: Wavefront run-length type A, a 740-byte
                     MSB header, a bottom-up scanline offset table,
                     per-channel signed-count RLE)
  PALM  read/write  (coders/palm.c: Palm Pilot bitmaps)
  PICT  read/write  (coders/pict.c: QuickDraw PICT v2 raster dumps, rows
                     through ``utils/compress.py``'s PackBits)

Everything here is host code, as in the JAX module (RLA's run-length
encoder runs the JAX loop over a row's bytes rather than its numpy
elements: the same bytes).  A decoded image goes to ``device`` once (the
card unless the caller asks for the CPU); an encoded one comes to the
host once and is quantized there with the JAX module's expressions.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

from ..core.image import Image
from ..core.spec import ImageSpec


# ---------------------------------------------------------------------------
# MATLAB MAT (mat.c) — level 5 (and level 4 numeric) matrices as images
# ---------------------------------------------------------------------------

# level-5 data types (MAT-file format spec §1; mat.c:116 miTYPE handling)
_MI_INT8, _MI_UINT8 = 1, 2
_MI_INT16, _MI_UINT16 = 3, 4
_MI_INT32, _MI_UINT32 = 5, 6
_MI_SINGLE, _MI_DOUBLE = 7, 9
_MI_INT64, _MI_UINT64 = 12, 13
_MI_MATRIX, _MI_COMPRESSED, _MI_UTF8 = 14, 15, 16

_MI_DTYPES = {
    _MI_INT8: np.int8, _MI_UINT8: np.uint8,
    _MI_INT16: np.int16, _MI_UINT16: np.uint16,
    _MI_INT32: np.int32, _MI_UINT32: np.uint32,
    _MI_SINGLE: np.float32, _MI_DOUBLE: np.float64,
    _MI_INT64: np.int64, _MI_UINT64: np.uint64,
}

# mxCLASS codes (mat.c:129 miCLASS handling)
_MX_DOUBLE, _MX_SINGLE = 6, 7
_MX_INT8, _MX_UINT8, _MX_INT16, _MX_UINT16 = 8, 9, 10, 11
_MX_INT32, _MX_UINT32, _MX_INT64, _MX_UINT64 = 12, 13, 14, 15


def _mat_normalize(arr: np.ndarray) -> np.ndarray:
    """Scale a MATLAB numeric array to [0,1] float32 (mat.c rescales
    integer classes by type range and floats by min/max)."""
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if arr.dtype in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(arr.dtype)
        return ((arr.astype(np.float64) - info.min)
                / (info.max - info.min)).astype(np.float32)
    if arr.dtype in (np.uint32, np.uint64):
        return (arr.astype(np.float64) / np.iinfo(arr.dtype).max).astype(
            np.float32)
    a = arr.astype(np.float64)
    lo, hi = float(np.nanmin(a)), float(np.nanmax(a))
    if not np.isfinite(lo) or not np.isfinite(hi):
        a = np.nan_to_num(a)
        lo, hi = float(a.min()), float(a.max())
    if 0.0 <= lo and hi <= 1.0:
        return a.astype(np.float32)
    if hi == lo:
        return np.zeros_like(a, np.float32)
    return ((a - lo) / (hi - lo)).astype(np.float32)


def _mat_image(arr: np.ndarray, device) -> Image:
    if arr.ndim == 2:
        data = _mat_normalize(arr)[..., None]
        return Image(np.ascontiguousarray(data),
                     ImageSpec(colorspace="gray", alpha=False,
                               depth=8 if arr.dtype == np.uint8 else 16),
                     device=device)
    data = _mat_normalize(arr)
    return Image(np.ascontiguousarray(data[..., :3]),
                 ImageSpec(colorspace="srgb", alpha=False,
                           depth=8 if arr.dtype == np.uint8 else 16),
                 device=device)


def _decode_mat5_element(data: bytes, bo: str) -> Optional[np.ndarray]:
    """Parse one miMATRIX element body into an (H, W[, C]) numeric array."""
    pos = 0

    def tag():
        nonlocal pos
        t, n = struct.unpack_from(bo + "II", data, pos)
        if t & 0xFFFF0000:  # small-element format: type/len packed in 4B
            n = t >> 16
            t &= 0xFFFF
            payload = data[pos + 4:pos + 4 + n]
            pos += 8
        else:
            payload = data[pos + 8:pos + 8 + n]
            pos += 8 + ((n + 7) & ~7)
        return t, payload

    _, flags = tag()  # array flags (miUINT32 x2)
    mxclass = struct.unpack_from(bo + "I", flags, 0)[0] & 0xFF
    _, dims_raw = tag()
    dims = np.frombuffer(dims_raw, np.dtype(bo + "i4"))
    tag()  # array name
    dtype_tag, real = tag()
    np_dtype = _MI_DTYPES.get(dtype_tag)
    if np_dtype is None or len(dims) < 2:
        return None
    arr = np.frombuffer(real, np.dtype(np_dtype).newbyteorder(bo),
                        count=int(np.prod(dims)))
    # MATLAB is column-major: dims = (rows, cols[, planes])
    arr = arr.reshape(tuple(int(d) for d in reversed(dims)))
    if len(dims) == 2:
        return arr.T
    return np.transpose(arr, (2, 1, 0)) if len(dims) == 3 else None


def decode_mat(data: bytes, device="cuda") -> List[Image]:
    if data[:4] != b"MATL":  # level 4 has no text header
        return [_decode_mat4(data, device)]
    endian = data[126:128]
    bo = "<" if endian == b"IM" else ">"
    pos = 128
    images: List[Image] = []
    while pos + 8 <= len(data):
        t, n = struct.unpack_from(bo + "II", data, pos)
        body = data[pos + 8:pos + 8 + n]
        pos += 8 + ((n + 7) & ~7)
        if t == _MI_COMPRESSED:
            try:
                sub = zlib.decompress(body)
            except zlib.error:
                continue
            st, sn = struct.unpack_from(bo + "II", sub, 0)
            if st == _MI_MATRIX:
                arr = _decode_mat5_element(sub[8:8 + sn], bo)
                if arr is not None:
                    images.append(_mat_image(arr, device))
        elif t == _MI_MATRIX:
            arr = _decode_mat5_element(body, bo)
            if arr is not None:
                images.append(_mat_image(arr, device))
    if not images:
        raise ValueError("MAT file contains no numeric matrix")
    return images


def _decode_mat4(data: bytes, device) -> Image:
    """MATLAB level-4: 20-byte header MOPT/mrows/ncols/imagf/namlen."""
    mopt, mrows, ncols, imagf, namlen = struct.unpack_from("<5i", data, 0)
    bo = "<"
    if mopt >= 1000:  # big-endian writer (M digit = 1)
        mopt_be = struct.unpack_from(">i", data, 0)[0]
        if 0 <= mopt_be < 5000:
            bo = ">"
            mopt, mrows, ncols, imagf, namlen = struct.unpack_from(
                ">5i", data, 0)
    p = mopt % 100 // 10  # precision digit
    dt = {0: np.float64, 1: np.float32, 2: np.int32, 3: np.int16,
          4: np.uint16, 5: np.uint8}.get(p)
    if dt is None:
        raise ValueError("unsupported MAT v4 precision")
    off = 20 + namlen
    arr = np.frombuffer(data, np.dtype(dt).newbyteorder(bo),
                        count=mrows * ncols, offset=off)
    return _mat_image(arr.reshape(ncols, mrows).T, device)


def encode_mat(img: Image, depth: int = 8) -> bytes:
    """Level-5 MAT-file with one uint8/uint16 matrix named 'imtpu'
    (mat.c write side emits the same single-matrix layout)."""
    arr = np.clip(np.asarray(img.to_numpy()), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    else:
        arr = arr[..., :3]
    if depth > 8:
        q = (arr * 65535.0 + 0.5).astype("<u2")
    else:
        q = (arr * 255.0 + 0.5).astype(np.uint8)
    # column-major payload
    if q.ndim == 2:
        payload = np.ascontiguousarray(q.T).tobytes()
        dims = (q.shape[0], q.shape[1])
        mx = _MX_UINT16 if depth > 8 else _MX_UINT8
    else:
        payload = np.ascontiguousarray(
            np.transpose(q, (2, 1, 0))).tobytes()
        dims = (q.shape[0], q.shape[1], q.shape[2])
        mx = _MX_UINT16 if depth > 8 else _MX_UINT8

    def element(t, body):
        pad = (-len(body)) % 8
        return struct.pack("<II", t, len(body)) + body + b"\0" * pad

    name = b"imtpu"
    dims_body = struct.pack(f"<{len(dims)}i", *dims)
    matrix = (element(_MI_UINT32, struct.pack("<II", mx, 0))
              + element(_MI_INT32, dims_body)
              + element(_MI_INT8, name)
              + element(_MI_UINT16 if depth > 8 else _MI_UINT8, payload))
    header = (b"MATLAB 5.0 MAT-file, created by imagemagick_tpu"
              .ljust(116) + b"\0" * 8 + struct.pack("<H", 0x0100) + b"IM")
    return header + element(_MI_MATRIX, matrix)


# ---------------------------------------------------------------------------
# Khoros VIFF (viff.c) — 1024-byte header + planar bands
# ---------------------------------------------------------------------------

_VFF_TYP = {0: "bit", 1: np.uint8, 2: np.uint16, 4: np.uint32,
            5: np.float32, 9: np.float64}
_VFF_DEP_DECORDER, _VFF_DEP_NSORDER = 0x4, 0x8


def decode_viff(data: bytes, device="cuda") -> Image:
    if data[0] != 0xAB or data[1] != 0x01:
        raise ValueError("not a VIFF stream")
    machine_dep = data[4]
    bo = "<" if machine_dep in (_VFF_DEP_DECORDER, _VFF_DEP_NSORDER) else ">"
    u32 = lambda off: struct.unpack_from(bo + "I", data, off)[0]
    comment = data[8:520].split(b"\0")[0].decode("latin-1", "replace")
    # sequential packed header (viff.c reads field-by-field): rows@520,
    # cols@524, subrows@528, x/y offsets@532/536, x/y bpp floats@540/544,
    # location_type@548, location_dim@552, n_images@556, bands@560,
    # storage@564, encode@568, map_scheme@572, map_storage@576,
    # map_rows@580, map_cols@584
    rows, cols = u32(520), u32(524)
    bands = u32(560)
    storage = u32(564)
    encode_scheme = u32(568)
    map_scheme = u32(572)
    map_storage = u32(576)
    map_rows, map_cols = u32(580), u32(584)
    if encode_scheme != 0:
        raise ValueError("VIFF: only raw encoding supported")
    pos = 1024
    # colormap (stored before image data; viff.c:433)
    colormap = None
    if map_scheme != 0 and map_storage == 1:
        n = map_rows * map_cols
        colormap = np.frombuffer(data, np.uint8, n, pos).reshape(
            map_rows, map_cols)
        pos += n
    typ = _VFF_TYP.get(storage)
    if typ is None:
        raise ValueError(f"VIFF: unsupported storage type {storage}")
    if typ == "bit":
        bpr = (cols + 7) // 8
        raw = np.frombuffer(data, np.uint8, bpr * rows * bands, pos)
        bits = np.unpackbits(raw.reshape(bands, rows, bpr), axis=-1,
                             bitorder="little")[..., :cols]
        planes = bits.astype(np.float32)
    else:
        dt = np.dtype(typ).newbyteorder(bo)
        raw = np.frombuffer(data, dt, rows * cols * bands, pos)
        planes = raw.reshape(bands, rows, cols).astype(np.float32)
        if typ == np.uint8:
            planes /= 255.0
        elif typ == np.uint16:
            planes /= 65535.0
        elif typ == np.uint32:
            planes /= 4294967295.0
        else:
            lo, hi = float(planes.min()), float(planes.max())
            if hi > 1.0 or lo < 0.0:
                planes = (planes - lo) / (hi - lo) if hi > lo else planes * 0
    arr = np.transpose(planes, (1, 2, 0))
    if colormap is not None and bands == 1 and colormap.shape[0] >= 3:
        scale = 255.0 if typ == np.uint8 else 1.0
        idx = np.clip(arr[..., 0] * scale + 0.5, 0,
                      colormap.shape[1] - 1).astype(np.int32)
        rgb = np.stack([colormap[c][idx] for c in range(3)], -1)
        arr = rgb.astype(np.float32) / 255.0
        spec = ImageSpec(colorspace="srgb", alpha=False, depth=8)
    elif arr.shape[-1] == 1:
        spec = ImageSpec(colorspace="gray", alpha=False,
                         depth=8 if typ == np.uint8 else 16)
    else:
        arr = arr[..., :3]
        spec = ImageSpec(colorspace="srgb", alpha=False,
                         depth=8 if typ == np.uint8 else 16)
    img = Image(np.ascontiguousarray(arr), spec, device=device)
    if comment:
        img.properties["comment"] = comment
    return img


def encode_viff(img: Image) -> bytes:
    arr = np.clip(np.asarray(img.to_numpy()), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    gray = img.spec.colorspace == "gray" or arr.shape[-1] == 1
    bands = 1 if gray else 3
    q = (arr[..., :bands] * 255.0 + 0.5).astype(np.uint8)
    h, w = q.shape[:2]
    hdr = bytearray(1024)
    hdr[0] = 0xAB          # identifier
    hdr[1] = 0x01          # file type
    hdr[2] = 0x01          # release
    hdr[3] = 0x03          # version
    hdr[4] = _VFF_DEP_DECORDER  # little-endian payload
    comment = b"imagemagick_tpu VIFF"
    hdr[8:8 + len(comment)] = comment
    struct.pack_into("<I", hdr, 520, h)
    struct.pack_into("<I", hdr, 524, w)
    struct.pack_into("<I", hdr, 548, 1)      # VFF_LOC_IMPLICIT
    struct.pack_into("<I", hdr, 556, 1)      # one image
    struct.pack_into("<I", hdr, 560, bands)
    struct.pack_into("<I", hdr, 564, 1)      # VFF_TYP_1_BYTE
    struct.pack_into("<I", hdr, 568, 0)      # raw
    struct.pack_into("<I", hdr, 572, 0)      # no map
    struct.pack_into("<I", hdr, 600, 15 if bands == 3 else 0)  # CM model
    planes = np.transpose(q, (2, 0, 1))
    return bytes(hdr) + planes.tobytes()


# ---------------------------------------------------------------------------
# Wavefront RLA (rla.c) — 740-byte header + bottom-up RLE scanlines
# ---------------------------------------------------------------------------

def _rla_rle_decode(stream: memoryview, pos: int, length: int,
                    out: np.ndarray):
    """Per-channel RLA RLE: signed count byte; >=0 is a run of count+1
    copies, <0 is -count literal bytes (rla.c:310)."""
    end = pos + length
    x = 0
    n = out.shape[0]
    while pos < end:
        count = stream[pos]
        pos += 1
        if count > 127:
            count -= 256
        if count < 0:
            lit = -count
            take = min(lit, n - x)
            out[x:x + take] = np.frombuffer(stream[pos:pos + take],
                                            np.uint8)
            pos += lit
            x += take
        else:
            if pos >= end:
                break
            v = stream[pos]
            pos += 1
            take = min(count + 1, n - x)
            out[x:x + take] = v
            x += take
    return end


def decode_rla(data: bytes, device="cuda") -> Image:
    mv = memoryview(data)
    window = struct.unpack_from(">4h", data, 0)
    active = struct.unpack_from(">4h", data, 8)
    (frame, storage_type, n_chan, n_matte, n_aux,
     revision) = struct.unpack_from(">6h", data, 16)
    del window, frame, revision, n_aux
    left, right, bottom, top = active
    w = right - left + 1
    h = top - bottom + 1
    if w <= 0 or h <= 0 or n_chan < 1 or n_chan > 4:
        raise ValueError("RLA: improper image header")
    if storage_type not in (0,):
        raise ValueError("RLA: only 8-bit integer storage supported")
    desc = bytes(mv[157:157 + 128]).split(b"\0")[0]
    total = min(n_chan + n_matte, 4)
    offsets = np.frombuffer(data, ">i4", h, 740)
    out = np.zeros((h, w, total), np.uint8)
    for y in range(h):
        pos = int(offsets[h - y - 1])
        for c in range(total):
            (length,) = struct.unpack_from(">h", data, pos)
            pos += 2
            pos = _rla_rle_decode(mv, pos, length, out[y, :, c])
    alpha = n_matte > 0 and total == 4
    if total == 1:
        spec = ImageSpec(colorspace="gray", alpha=False, depth=8)
    else:
        spec = ImageSpec(colorspace="srgb", alpha=alpha, depth=8)
        if total == 2:
            out = np.concatenate([np.repeat(out[..., :1], 3, -1),
                                  out[..., 1:]], -1)
    img = Image(out.astype(np.float32) / 255.0, spec, device=device)
    if desc:
        img.properties["comment"] = desc.decode("latin-1", "replace")
    return img


def _rla_rle_encode(row: np.ndarray) -> bytes:
    # the JAX module's loop, over the row's bytes (a bytes object indexes
    # to Python ints, far faster than a numpy array's elements)
    row = np.ascontiguousarray(row, np.uint8).tobytes()
    out = bytearray()
    n = len(row)
    i = 0
    while i < n:
        run = 1
        while i + run < n and row[i + run] == row[i] and run < 128:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(row[i])
            i += run
        else:
            j = i
            while j < n and (j - i) < 127:
                nxt = 1
                while j + nxt < n and row[j + nxt] == row[j] and nxt < 3:
                    nxt += 1
                if nxt >= 3:
                    break
                j += 1
            lit = row[i:j]
            out.append((-len(lit)) & 0xFF)
            out.extend(lit)
            i = j
    return bytes(out)


def encode_rla(img: Image) -> bytes:
    arr = np.clip(np.asarray(img.to_numpy()), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    if c == 1:
        arr = np.repeat(arr, 3, -1)
        c = 3
    c = min(c, 4)
    q = (arr[..., :c] * 255.0 + 0.5).astype(np.uint8)
    n_matte = 1 if c == 4 else 0
    hdr = bytearray(740)
    struct.pack_into(">4h", hdr, 0, 0, w - 1, 0, h - 1)   # window
    struct.pack_into(">4h", hdr, 8, 0, w - 1, 0, h - 1)   # active window
    struct.pack_into(">6h", hdr, 16, 0, 0, 3, n_matte, 0, -2)
    hdr[28:28 + 7] = b"2.2\0\0\0\0"                       # gamma
    hdr[157:157 + 15] = b"imagemagick_tpu"                # description
    struct.pack_into(">h", hdr, 636, 8)                   # bits per channel
    scanlines = []
    for y in range(h):
        chunks = []
        for ch in range(3 + n_matte):
            enc = _rla_rle_encode(q[y, :, min(ch, q.shape[-1] - 1)])
            chunks.append(struct.pack(">h", len(enc)) + enc)
        scanlines.append(b"".join(chunks))
    offsets = []
    pos = 740 + 4 * h
    # offsets table is indexed bottom-up (rla.c:334 reads rows-y-1)
    for y in range(h - 1, -1, -1):
        offsets.append(pos)
        pos += len(scanlines[y])
    # offsets[k] is the position of row h-1-k, exactly the bottom-up
    # indexing decode expects (table[i] -> row h-1-i)
    table = struct.pack(f">{h}i", *offsets)
    return bytes(hdr) + table + b"".join(scanlines[::-1])


# ---------------------------------------------------------------------------
# Palm Pilot bitmap (palm.c) — 16-byte MSB header, versions 0-2,
# 1/2/4/8-bit indexed (MSB-first packing, value 0 = white) and 16-bit
# RGB565 direct color; none/RLE/scanline compression
# ---------------------------------------------------------------------------

_PALM_COMPRESSED = 0x8000
_PALM_HAS_COLORMAP = 0x4000
_PALM_HAS_TRANSPARENCY = 0x2000
_PALM_DIRECT_COLOR = 0x0400


def _palm_system_palette() -> np.ndarray:
    """The PalmOS 8-bit system palette, generated from its documented
    structure (palm.c PalmPalette): the 6-level color cube ordered
    (b-half, r desc, b desc, g desc) minus the final black, ten
    non-cube grays, silver, four VGA system colors, black fill."""
    levels = [255, 204, 153, 102, 51, 0]
    pal = []
    for bhalf in ([255, 204, 153], [102, 51, 0]):
        for r in levels:
            for b in bhalf:
                for g in levels:
                    pal.append((r, g, b))
    pal = pal[:-1]  # final (0,0,0) cube entry is replaced by the tail
    for v in (17, 34, 68, 85, 119, 136, 170, 187, 221, 238):
        pal.append((v, v, v))
    pal += [(192, 192, 192), (128, 0, 0), (128, 0, 128), (0, 128, 0),
            (0, 128, 128)]
    while len(pal) < 256:
        pal.append((0, 0, 0))
    return np.asarray(pal, np.uint8)


def _palm_decompress(data: bytes, pos: int, rows: int, bpr: int,
                     ctype: int) -> np.ndarray:
    out = np.zeros((rows, bpr), np.uint8)
    if ctype == 0x01:  # RLE: (count, byte) runs per row
        for y in range(rows):
            i = 0
            while i < bpr and pos + 1 < len(data):
                count = min(data[pos], bpr - i)
                out[y, i:i + count] = data[pos + 1]
                pos += 2
                i += count
    elif ctype == 0x00:  # scanline: 8-byte groups, mask bit = new byte
        for y in range(rows):
            i = 0
            while i < bpr and pos < len(data):
                mask = data[pos]
                pos += 1
                n = min(8, bpr - i)
                for bit in range(n):
                    if y == 0 or (mask & (0x80 >> bit)):
                        out[y, i + bit] = data[pos]
                        pos += 1
                    else:
                        out[y, i + bit] = out[y - 1, i + bit]
                i += n
    else:
        raise ValueError(f"PALM: unknown compression {ctype}")
    return out


def decode_palm(data: bytes, device="cuda") -> Image:
    cols, rows, bpr, flags = struct.unpack_from(">4H", data, 0)
    bpp, version = data[8], data[9]
    transparent = data[12]
    ctype = data[13]
    if cols == 0 or rows == 0 or bpp not in (1, 2, 4, 8, 16):
        raise ValueError("PALM: improper image header")
    del version
    pos = 16
    if bpp == 16:
        pos += 8  # direct-color header (bit widths + transparent color)
    palette = None
    if flags & _PALM_HAS_COLORMAP:
        count = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        palette = np.zeros((256, 3), np.uint8)
        for i in range(count):
            palette[i] = (data[pos + 1], data[pos + 2], data[pos + 3])
            pos += 4
    if flags & _PALM_COMPRESSED:
        pos += 2  # compressed-size field
        raw = _palm_decompress(data, pos, rows, bpr, ctype)
    else:
        raw = np.frombuffer(data, np.uint8, rows * bpr,
                            pos).reshape(rows, bpr)
    if bpp == 16:
        px = raw[:, :2 * cols].reshape(rows, cols, 2)
        c16 = (px[..., 0].astype(np.uint32) << 8) | px[..., 1]
        r = ((c16 >> 11) & 0x1F).astype(np.float32) / 31.0
        g = ((c16 >> 5) & 0x3F).astype(np.float32) / 63.0
        b = (c16 & 0x1F).astype(np.float32) / 31.0
        arr = np.stack([r, g, b], -1)
        return Image(arr, ImageSpec(colorspace="srgb", alpha=False, depth=8),
                     device=device)
    # unpack MSB-first sub-byte indices
    bits = np.unpackbits(raw, axis=1)[:, :cols * bpp]
    vals = bits.reshape(rows, cols, bpp)
    weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint32)
    idx = (vals * weights).sum(-1).astype(np.int32)
    mask = (1 << bpp) - 1
    if palette is None:
        if bpp == 8:
            palette = _palm_system_palette()
        else:  # PalmOS grayscale ramps: stored 0 = white
            ramp = np.linspace(255, 0, mask + 1).astype(np.uint8)
            palette = np.stack([ramp] * 3, -1)
    arr = palette[np.clip(idx, 0, palette.shape[0] - 1)].astype(
        np.float32) / 255.0
    if flags & _PALM_HAS_TRANSPARENCY:
        alpha = (idx != transparent).astype(np.float32)[..., None]
        arr = np.concatenate([arr, alpha], -1)
        return Image(arr, ImageSpec(colorspace="srgb", alpha=True, depth=8),
                     device=device)
    return Image(arr, ImageSpec(colorspace="srgb", alpha=False, depth=8),
                 device=device)


def encode_palm(img: Image) -> bytes:
    """Gray images as 4-bit PalmOS grayscale; color as 16-bit direct."""
    arr = np.clip(np.asarray(img.to_numpy()), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w = arr.shape[:2]
    gray = img.spec.colorspace == "gray" or arr.shape[-1] == 1
    if gray:
        bpp = 4
        bpr = (w * bpp + 15) // 16 * 2  # word-aligned rows
        lum = arr[..., 0]
        idx = np.clip(((1.0 - lum) * 15 + 0.5).astype(np.uint8), 0, 15)
        bits = ((idx[..., None] >> np.arange(3, -1, -1)) & 1).astype(
            np.uint8).reshape(h, w * 4)
        pad = bpr * 8 - w * 4
        bits = np.pad(bits, ((0, 0), (0, pad)))
        rowsb = np.packbits(bits, axis=1)
        header = struct.pack(">4HBBHBBH", w, h, bpr, 0, bpp, 1, 0, 0,
                             0xFF, 0)
        return header + rowsb.tobytes()
    bpr = 2 * w
    q = arr[..., :3]
    c16 = ((np.round(q[..., 0] * 31).astype(np.uint32) << 11)
           | (np.round(q[..., 1] * 63).astype(np.uint32) << 5)
           | np.round(q[..., 2] * 31).astype(np.uint32))
    px = np.stack([(c16 >> 8) & 0xFF, c16 & 0xFF], -1).astype(np.uint8)
    header = struct.pack(">4HBBHBBH", w, h, bpr, _PALM_DIRECT_COLOR, 16, 2,
                         0, 0, 0xFF, 0)
    direct = struct.pack(">BBBBB3B", 5, 6, 5, 0, 0, 0, 0, 0)
    return header + direct + px.tobytes()


# ---------------------------------------------------------------------------
# QuickDraw PICT v2 (pict.c) — the raster-dump subset every writer (incl.
# the reference, pict.c:1805) emits: 512-byte app header, version-2
# opcode stream, PackBitsRect (indexed, 0x0098) / DirectBitsRect
# (component-planar RGB(A), 0x009A) pixel data, PackBits row compression
# ---------------------------------------------------------------------------

def _pict_unpack_row(data: bytes, pos: int, row_bytes: int):
    """One PICT scanline: u8/u16 packed-length prefix + PackBits."""
    from ..utils.compress import packbits_decode

    if row_bytes <= 250:
        n = data[pos]
        pos += 1
    else:
        n = struct.unpack_from(">H", data, pos)[0]
        pos += 2
    return packbits_decode(data[pos:pos + n]), pos + n


def decode_pict(data: bytes, device="cuda") -> Image:
    if len(data) < 528:
        raise ValueError("PICT: truncated")
    pos = 512 + 2  # app header + picture size (u16, unreliable)
    pos += 8       # picture frame rect
    if struct.unpack_from(">2H", data, pos) != (0x0011, 0x02FF):
        raise ValueError("PICT: not a version-2 picture")
    pos += 4
    arr = None
    alpha = False
    while pos + 2 <= len(data):
        op = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        if op == 0x00FF:      # end of picture
            break
        if op == 0x0000:      # NOP
            continue
        if op == 0x0C00:      # header: 24 bytes
            pos += 24
            continue
        if op == 0x0001:      # clip region: self-inclusive size
            pos += struct.unpack_from(">H", data, pos)[0]
            continue
        if op == 0x001E:      # DefHilite
            continue
        if op == 0x00A1:      # long comment: kind + size + data
            size = struct.unpack_from(">H", data, pos + 2)[0]
            pos += 4 + size + (size & 1)
            continue
        if op in (0x0098, 0x009A):
            if op == 0x009A:
                pos += 4  # base address
            row_bytes = struct.unpack_from(">H", data, pos)[0]
            pos += 2
            is_pixmap = bool(row_bytes & 0x8000)
            row_bytes &= 0x7FFF
            top, left, bottom, right = struct.unpack_from(">4h", data, pos)
            pos += 8
            h, w = bottom - top, right - left
            bits, pack_type, comp_count = 1, 0, 1
            colormap = None
            if is_pixmap:
                (_ver, pack_type, _psize) = struct.unpack_from(
                    ">HHI", data, pos)
                pos += 8 + 8  # + h/v resolution (two 16.16 fixed)
                (_ptype, bits, comp_count, _csize) = struct.unpack_from(
                    ">4H", data, pos)
                pos += 8 + 12  # + plane bytes, table handle, reserved
                if op == 0x0098:  # colormap follows
                    n = struct.unpack_from(">H", data, pos + 6)[0] + 1
                    pos += 8
                    colormap = np.zeros((max(n, 256), 3), np.uint16)
                    for i in range(n):
                        idx, r, g, b = struct.unpack_from(">4H", data, pos)
                        colormap[idx if idx < colormap.shape[0] else i] = (
                            r, g, b)
                        pos += 8
            pos += 16  # source + destination rects
            pos += 2   # transfer mode
            rows = []
            for _ in range(h):
                if row_bytes < 8:
                    rows.append(data[pos:pos + row_bytes])
                    pos += row_bytes
                else:
                    row, pos = _pict_unpack_row(data, pos, row_bytes)
                    rows.append(row)
            pos += pos & 1  # v2 opcodes are word-aligned
            if bits == 8 and colormap is not None:
                idx = np.frombuffer(b"".join(r[:w].ljust(w, b"\0")
                                             for r in rows),
                                    np.uint8).reshape(h, w)
                arr = colormap[idx].astype(np.float32) / 65535.0
            elif bits == 8:
                idx = np.frombuffer(b"".join(r[:w].ljust(w, b"\0")
                                             for r in rows),
                                    np.uint8).reshape(h, w)
                arr = (idx.astype(np.float32) / 255.0)[..., None]
                arr = np.repeat(arr, 3, -1)
            elif bits == 32 and pack_type in (0, 4):
                nc = 4 if comp_count == 4 else 3
                planes = np.zeros((h, nc, w), np.uint8)
                for y, r in enumerate(rows):
                    r = r[:nc * w].ljust(nc * w, b"\0")
                    planes[y] = np.frombuffer(r, np.uint8).reshape(nc, w)
                px = np.transpose(planes, (0, 2, 1)).astype(np.float32) / 255
                if nc == 4:  # stored O,R,G,B
                    arr = np.concatenate([px[..., 1:4], px[..., :1]], -1)
                    alpha = True
                else:
                    arr = px
            else:
                raise ValueError(
                    f"PICT: unsupported pixmap (bits={bits}, "
                    f"pack={pack_type})")
            continue
        raise ValueError(f"PICT: unsupported opcode 0x{op:04x}")
    if arr is None:
        raise ValueError("PICT: no raster op found")
    return Image(np.ascontiguousarray(arr),
                 ImageSpec(colorspace="srgb", alpha=alpha, depth=8),
                 device=device)


def _pict_pack_row(row: bytes, row_bytes: int) -> bytes:
    from ..utils.compress import packbits_encode

    packed = packbits_encode(row)
    if row_bytes <= 250:
        return bytes([len(packed)]) + packed
    return struct.pack(">H", len(packed)) + packed


def encode_pict(img: Image) -> bytes:
    """Version-2 DirectBitsRect picture (pict.c:1760 direct-class path)."""
    arr = np.clip(np.asarray(img.to_numpy()), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    h, w = arr.shape[:2]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, -1)
    use_alpha = bool(img.spec.alpha and arr.shape[-1] >= 4)
    nc = 4 if use_alpha else 3
    q = (arr * 255.0 + 0.5).astype(np.uint8)
    row_bytes = 4 * w
    out = bytearray(512)                     # zeroed application header
    def u16(v): out.extend(struct.pack(">H", v & 0xFFFF))
    def u32(v): out.extend(struct.pack(">I", v & 0xFFFFFFFF))
    rect = lambda: (u16(0), u16(0), u16(h), u16(w))
    u16(0)                                   # picture size (low word)
    rect()                                   # picture frame
    u16(0x0011); u16(0x02FF)                 # version 2
    u16(0x0C00); u32(0xFFFE0000)             # header opcode
    u16(72); u16(0); u16(72); u16(0)         # resolution 72x72
    rect(); u32(0)                           # frame + reserved
    u16(0x0001); u16(0x000A); rect()         # clip region
    u16(0x009A)                              # DirectBitsRect
    u32(0x000000FF)                          # base address
    u16(row_bytes | 0x8000)
    rect()                                   # pixmap bounds
    u16(0)                                   # pixmap version
    u16(4)                                   # pack type: run length by comp
    u32(0)                                   # pack size
    u16(72); u16(0); u16(72); u16(0)         # resolution
    u16(16)                                  # pixel type: direct
    u16(32)                                  # bits per pixel
    u16(nc)                                  # component count
    u16(8)                                   # component size
    u32(0); u32(0); u32(0)                   # plane bytes, table, reserved
    rect(); rect()                           # source, destination
    u16(0)                                   # transfer mode: srcCopy
    for y in range(h):
        if use_alpha:                        # stored O,R,G,B planes
            planes = np.concatenate([q[y, :, 3], q[y, :, 0], q[y, :, 1],
                                     q[y, :, 2]])
        else:
            planes = np.concatenate([q[y, :, 0], q[y, :, 1], q[y, :, 2]])
        out.extend(_pict_pack_row(planes.tobytes(), row_bytes))
    if (len(out) - 512) & 1:
        out.append(0)
    u16(0x00FF)                              # end of picture
    return bytes(out)
