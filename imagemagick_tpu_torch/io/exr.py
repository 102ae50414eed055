"""OpenEXR, scanline images with NONE, ZIPS or ZIP compression
(coders/exr.c over libopenexr).

Port of ``imagemagick_tpu/io/exr.py``: one part, HALF, FLOAT or UINT
channels (R, G, B, A, Y), NONE, ZIPS (one line a block) and ZIP (16 lines
a block) with the format's delta-and-interleave predictor.  Float samples
go to the image as they are, with no quantization.  The bytes are parsed
and packed on the host with numpy; the predictor is the JAX module's loop
written as array operations (a running sum mod 256 and its difference),
which gives the same bytes.  A decoded image goes to ``device`` once (the
card unless the caller asks for the CPU); an encoded one comes to the
host once.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from ..core.image import Image
from ..core.spec import ImageSpec

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2
_UINT = 0


def _read_str(data: bytes, pos: int) -> Tuple[str, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _attr_reader(data: bytes, pos: int):
    while True:
        name, pos = _read_str(data, pos)
        if not name:
            return
        typ, pos = _read_str(data, pos)
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        stop = yield name, typ, payload, pos
        if stop:
            return


def _postprocess_block(raw: bytes) -> bytes:
    """EXR ZIP predictor decode: un-delta, then de-interleave."""
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    if d.size:
        d[1:] -= 128
    arr = (np.cumsum(d) & 0xFF).astype(np.uint8)
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:half + n // 2]
    return out.tobytes()


def _preprocess_block(raw: bytes) -> bytes:
    """EXR ZIP predictor encode: interleave, then delta."""
    src = np.frombuffer(raw, np.uint8)
    inter = np.concatenate([src[0::2], src[1::2]]).astype(np.int16)
    out = inter.copy()
    out[1:] = inter[1:] - inter[:-1] + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def decode(data: bytes, device="cuda") -> Image:
    """The image of an EXR stream, on ``device``."""
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR stream")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    pos = 8
    channels: List[Tuple[str, int]] = []
    compression = 0
    dw = (0, 0, 0, 0)
    while True:
        name, pos = _read_str(data, pos)
        if not name:
            break
        typ, pos = _read_str(data, pos)
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_str(payload, cpos)
                ptype = struct.unpack_from("<i", payload, cpos)[0]
                cpos += 16  # pixel type + pLinear + reserved + sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", payload)
    x0, y0, x1, y1 = dw
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"unsupported EXR compression {compression}")
    lines_per_block = {0: 1, 2: 1, 3: 16}[compression]
    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)
    # channels sorted alphabetically in the file
    chans_sorted = sorted(channels)
    itemsize = {_HALF: 2, _FLOAT: 4, _UINT: 4}
    dtype_map = {_HALF: np.float16, _FLOAT: np.float32, _UINT: np.uint32}
    planes = {cn: np.zeros((h, w), np.float32) for cn, _ in channels}
    for bi, off in enumerate(offsets):
        y, nbytes = struct.unpack_from("<iI", data, off)
        payload = data[off + 8: off + 8 + nbytes]
        rows = min(lines_per_block, y1 - (y0 + bi * lines_per_block) + 1,
                   h - bi * lines_per_block)
        row_bytes = sum(itemsize[t] for _, t in channels) * w
        expect = row_bytes * rows
        if compression in (2, 3) and len(payload) != expect:
            raw = zlib.decompress(payload)
            if len(raw) != expect:
                raise ValueError("EXR block size mismatch")
            raw = _postprocess_block(raw)
        else:
            raw = payload  # stored uncompressed (or compression didn't help)
        p = 0
        for r in range(rows):
            yy = bi * lines_per_block + r
            for cn, ct in chans_sorted:
                cnt = w * itemsize[ct]
                seg = np.frombuffer(raw, dtype_map[ct], count=w, offset=p)
                planes[cn][yy] = seg.astype(np.float32)
                p += cnt
    names = [c for c, _ in channels]
    if "R" in names and "G" in names and "B" in names:
        stack = [planes["R"], planes["G"], planes["B"]]
        alpha = "A" in names
        if alpha:
            stack.append(planes["A"])
        cs = "rgb"
    elif "Y" in names:
        stack = [planes["Y"]]
        alpha = "A" in names
        if alpha:
            stack.append(planes["A"])
        cs = "linear_gray"
    else:
        stack = [planes[n] for n in names]
        alpha = False
        cs = "rgb"
    arr = np.stack(stack, axis=-1)
    return Image(arr, ImageSpec(colorspace=cs, alpha=alpha, depth=16),
                 device=device)


def encode(img: Image, half: bool = True, compression: str = "zip") -> bytes:
    """Write single-part scanline EXR (RGB[A] half/float)."""
    arr = img.to_numpy()
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    # store linear floats; if image is sRGB-tagged we keep values as-is
    # (HDRI semantics — the reference's exr.c likewise writes raw quanta)
    names = {1: ["Y"], 2: ["Y", "A"], 3: ["B", "G", "R"],
             4: ["A", "B", "G", "R"]}[c]  # alphabetical order on disk
    src_index = {"R": 0, "G": 1, "B": 2, "A": 3 if c == 4 else 1, "Y": 0}
    ptype = _HALF if half else _FLOAT
    dt = np.float16 if half else np.float32
    isz = 2 if half else 4

    head = struct.pack("<iI", _MAGIC, 2)

    def attr(name, typ, payload):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00" +
                struct.pack("<I", len(payload)) + payload)

    chan_payload = b""
    for n in names:
        chan_payload += (n.encode() + b"\x00" + struct.pack("<i", ptype) +
                         b"\x00" * 3 + b"\x00" + struct.pack("<ii", 1, 1))
    chan_payload += b"\x00"
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    head += attr("channels", "chlist", chan_payload)
    head += attr("compression", "compression", bytes([comp_id]))
    head += attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    head += attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    head += attr("lineOrder", "lineOrder", b"\x00")
    head += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    head += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    head += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    head += b"\x00"

    lines_per_block = {0: 1, 2: 1, 3: 16}[comp_id]
    n_blocks = -(-h // lines_per_block)
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        rows = min(lines_per_block, h - y0)
        raw = bytearray()
        for r in range(rows):
            for n in names:
                if n == "Y":
                    plane = arr[y0 + r, :, 0]
                elif n == "A":
                    plane = arr[y0 + r, :, c - 1]
                else:
                    plane = arr[y0 + r, :, src_index[n]]
                raw += plane.astype(dt).tobytes()
        payload = bytes(raw)
        if comp_id in (2, 3):
            comp = zlib.compress(_preprocess_block(payload))
            if len(comp) >= len(payload):
                comp = payload  # EXR stores raw when compression doesn't help
            payload = comp
        blocks.append((y0, payload))

    offset_table_pos = len(head)
    data_start = offset_table_pos + 8 * n_blocks
    offsets = []
    cur = data_start
    for y0, payload in blocks:
        offsets.append(cur)
        cur += 8 + len(payload)
    body = b"".join(struct.pack("<q", o) for o in offsets)
    for y0, payload in blocks:
        body += struct.pack("<iI", y0, len(payload)) + payload
    return head + body
