"""Radiance RGBE (.hdr) bytes, in numpy on the host.

The JAX package reads and writes HDR through OpenCV (``cv2.imdecode``/
``imencode``, whose coder is Bruce Walter's rgbe.c).  The port does not
use OpenCV: this module gives the same bytes and floats.

Writing: the header ``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe``, a blank
line and ``-Y H +X W``; then, for 8 <= W <= 32767, new-style run-length
scanlines (a 2,2,W marker and the four byte planes, each run-length
coded as ``RGBE_WriteBytes_RLE`` codes it), else flat RGBE quadruples.
Each pixel is ``float2rgbe``: v = max(r, g, b); below 1e-32 all four
bytes are 0; else v = frexp(v) * 256 / v (double, rounded to float),
each byte the float product truncated, the exponent byte e + 128.

Reading: a ``#?RGBE`` or ``#?RADIANCE`` file whose header lines reach a
``FORMAT=32-bit_rle_rgbe`` line, a blank line and ``-Y H +X W`` (lines
read as ``fgets`` reads them, 127 bytes at most); scanlines run-length
coded or flat (a scanline without the marker makes the rest flat); each
sample m * 2^(e - 136), 0 where e is 0.  Any read error raises
ValueError("HDR decode failed"), as the JAX function raises where
OpenCV declines the file.
"""

from __future__ import annotations

import re

import numpy as np

_MAGICS = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def _declined() -> ValueError:
    return ValueError("HDR decode failed")


# -- writing ------------------------------------------------------------------

def _float2rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8, rgbe.c's float2rgbe."""
    r, g, b = (rgb[..., k] for k in range(3))
    v = np.where(g > r, g, r)
    v = np.where(b > v, b, v)
    zero = v.astype(np.float64) < 1e-32
    mant, exp = np.frexp(v)
    with np.errstate(all="ignore"):
        scale = (mant.astype(np.float64) * 256.0 /
                 v.astype(np.float64)).astype(np.float32)
        out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
        for k, c in enumerate((r, g, b)):
            # (unsigned char) of a float: the C truncation to a 32-bit
            # int (0x80000000 out of its range), then its low byte
            prod = (c * scale).astype(np.float64)
            prod = np.where((prod >= -2.0 ** 31) & (prod < 2.0 ** 31),
                            prod, -2.0 ** 31)
            out[..., k] = prod.astype(np.int64) & 0xFF
    out[..., 3] = (exp + 128) & 0xFF
    out[zero] = 0
    return out


def _rle_plane(d: np.ndarray) -> bytes:
    """rgbe.c's RGBE_WriteBytes_RLE of one byte plane of a scanline.

    The C loop walks the plane in runs of equal bytes (at most 127 long)
    from the current position: runs of 4 or more are written as runs;
    the bytes before one go out as literals, 128 at a time, unless they
    are a single run of 2 or 3, which is written as a short run."""
    n = len(d)
    starts = np.concatenate(([0], np.flatnonzero(d[1:] != d[:-1]) + 1))
    lens = np.diff(np.append(starts, n))
    if (lens > 127).any():
        reps = -(-lens // 127)
        first = np.repeat(np.cumsum(reps) - reps, reps)
        starts = np.repeat(starts, reps) + 127 * (np.arange(reps.sum())
                                                  - first)
        lens = np.diff(np.append(starts, n))
    out = bytearray()
    cur = 0
    seg = 0          # index of the run that starts at cur
    nseg = len(starts)
    for j in list(np.flatnonzero(lens >= 4)) + [nseg]:
        beg = int(starts[j]) if j < nseg else n
        if j - seg == 1 and lens[seg] > 1:
            out += bytes((128 + int(lens[seg]), int(d[cur])))
            cur = beg
        while cur < beg:
            k = min(beg - cur, 128)
            out.append(k)
            out += d[cur:cur + k].tobytes()
            cur += k
        if j < nseg:
            out += bytes((128 + int(lens[j]), int(d[beg])))
            cur = beg + int(lens[j])
        seg = j + 1
    return bytes(out)


def encode(rgb: np.ndarray) -> bytes:
    """(H, W, 3) float32 RGB -> the bytes ``cv2.imencode(".hdr")`` writes
    for the same pixels (in its BGR order)."""
    h, w = rgb.shape[:2]
    px = _float2rgbe(np.ascontiguousarray(rgb, np.float32))
    out = bytearray(b"#?RADIANCE\n" + _FORMAT + b"\n" +
                    b"-Y %d +X %d\n" % (h, w))
    if w < 8 or w > 0x7FFF:
        out += px.tobytes()
        return bytes(out)
    marker = bytes((2, 2, w >> 8, w & 0xFF))
    planes = np.ascontiguousarray(px.transpose(0, 2, 1))   # (H, 4, W)
    for y in range(h):
        out += marker
        for k in range(4):
            out += _rle_plane(planes[y, k])
    return bytes(out)


# -- reading ------------------------------------------------------------------

def _lines(data: bytes, pos: int):
    """fgets over ``data`` with a 128-byte buffer: (line, next pos)."""
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        stop = pos + 127 if end < 0 else end + 1
        yield data[pos:stop], min(stop, len(data))
        pos = stop


def _header(data: bytes):
    if not data.startswith(_MAGICS):
        raise _declined()
    lines = _lines(data, 0)
    for line, pos in lines:
        if line in (b"", b"\n") or line[:1] == b"\0":
            raise _declined()          # no FORMAT specifier found
        if line == _FORMAT:
            break
    else:
        raise _declined()
    blank = next(lines, (None, 0))
    size = next(lines, (None, 0))
    if blank[0] != b"\n" or size[0] is None:
        raise _declined()
    m = _SIZE.match(size[0])
    if not m or int(m.group(1)) <= 0 or int(m.group(2)) <= 0:
        raise _declined()
    return int(m.group(1)), int(m.group(2)), size[1]


def _rgbe2float(px: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 -> (..., 3) float32, rgbe.c's rgbe2float."""
    e = px[..., 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (px[..., :3].astype(np.float64) * f[..., None]).astype(np.float32)


def _flat(data: bytes, pos: int, count: int) -> np.ndarray:
    if len(data) - pos < 4 * count:
        raise _declined()              # RGBE read error
    return np.frombuffer(data, np.uint8, 4 * count, pos).reshape(count, 4)


def decode(data: bytes) -> np.ndarray:
    """HDR bytes -> (H, W, 3) float32 RGB, unclipped; ValueError where
    OpenCV's reader declines the file."""
    h, w, pos = _header(data)
    px = np.empty((h * w, 4), np.uint8)
    if w < 8 or w > 0x7FFF:
        px[:] = _flat(data, pos, h * w)
        return _rgbe2float(px).reshape(h, w, 3)
    n = len(data)
    line = np.empty(4 * w, np.uint8)
    for y in range(h):
        if n - pos < 4:
            raise _declined()
        head = data[pos:pos + 4]
        pos += 4
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
            # not run-length coded: this pixel and the rest are flat
            px[y * w] = np.frombuffer(head, np.uint8)
            rest = h * w - y * w - 1
            px[y * w + 1:] = _flat(data, pos, rest)
            return _rgbe2float(px).reshape(h, w, 3)
        if (head[2] << 8 | head[3]) != w:
            raise _declined()          # wrong scanline width
        at = 0
        for k in range(4):
            end = (k + 1) * w
            while at < end:
                if n - pos < 2:
                    raise _declined()
                code, value = data[pos], data[pos + 1]
                pos += 2
                if code > 128:
                    count = code - 128
                    if count > end - at:
                        raise _declined()
                    line[at:at + count] = value
                    at += count
                else:
                    if code == 0 or code > end - at:
                        raise _declined()
                    line[at] = value
                    if code > 1:
                        if n - pos < code - 1:
                            raise _declined()
                        line[at + 1:at + code] = np.frombuffer(
                            data, np.uint8, code - 1, pos)
                        pos += code - 1
                    at += code
        px[y * w:(y + 1) * w] = line.reshape(4, w).T
    return _rgbe2float(px).reshape(h, w, 3)
