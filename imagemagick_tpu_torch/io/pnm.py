"""Native PNM (PBM/PGM/PPM/PAM/PFM) codec.

Port of ``imagemagick_tpu/io/pnm.py``: the samples are parsed and written
on the host in numpy with the JAX module's expressions, and a decoded
image goes to ``device`` once.  ImageMagick's coders/pnm.c in pure
Python —
these are trivial headers over raw samples, and having a dependency-free
codec keeps the core framework self-contained (PIL handles them too, but
PFM float maps align with our HDRI pipeline natively).
"""

from __future__ import annotations

import re

import numpy as np

from ..core.image import Image
from ..core.spec import ImageSpec

_WS = re.compile(rb"\s+")
_COMMENT = re.compile(rb"#[^\n]*")


def _read_tokens(data: bytes, count: int, pos: int):
    toks = []
    while len(toks) < count:
        # skip whitespace + comments
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        toks.append(data[start:pos])
    return toks, pos + 1  # consume single whitespace after header


def decode(data: bytes, device="cuda") -> Image:
    magic = data[:2]
    if magic in (b"P1", b"P2", b"P3"):  # ASCII variants
        # a comment runs from '#' to the end of its line; the JAX module
        # drops only the comment's first word, and raises on the next
        toks = _WS.split(_COMMENT.sub(b" ", data[2:]).strip())
        toks = [t for t in toks if t]
        if magic == b"P1":
            w, h = int(toks[0]), int(toks[1])
            vals = np.array([int(t) for t in b"".join(toks[2:]).decode()], np.float32)
            arr = 1.0 - vals.reshape(h, w, 1)
            return Image(arr, ImageSpec(colorspace="gray"), device=device)
        maxv = None
        w, h, maxv = int(toks[0]), int(toks[1]), int(toks[2])
        vals = np.array([int(t) for t in toks[3:]], np.float32) / maxv
        if magic == b"P2":
            return Image(vals.reshape(h, w, 1), ImageSpec(colorspace="gray"), device=device)
        return Image(vals.reshape(h, w, 3), ImageSpec(colorspace="srgb"), device=device)
    if magic == b"P4":
        (wb, hb), pos = _read_tokens(data, 2, 2)
        w, h = int(wb), int(hb)
        rowbytes = (w + 7) // 8
        bits = np.unpackbits(
            np.frombuffer(data, np.uint8, count=rowbytes * h, offset=pos).reshape(h, rowbytes),
            axis=1)[:, :w]
        return Image((1.0 - bits).astype(np.float32)[..., None], ImageSpec(colorspace="gray"), device=device)
    if magic in (b"P5", b"P6"):
        (wb, hb, mb), pos = _read_tokens(data, 3, 2)
        w, h, maxv = int(wb), int(hb), int(mb)
        ch = 1 if magic == b"P5" else 3
        if maxv < 256:
            arr = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos)
            arr = arr.reshape(h, w, ch).astype(np.float32) / maxv
        else:
            arr = np.frombuffer(data, ">u2", count=w * h * ch, offset=pos)
            arr = arr.reshape(h, w, ch).astype(np.float32) / maxv
        cs = "gray" if ch == 1 else "srgb"
        return Image(arr, ImageSpec(colorspace=cs), device=device)
    if magic in (b"PF", b"Pf"):  # PFM float
        (wb, hb, sb), pos = _read_tokens(data, 3, 2)
        w, h, scale = int(wb), int(hb), float(sb)
        ch = 3 if magic == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        arr = np.frombuffer(data, dt, count=w * h * ch, offset=pos).reshape(h, w, ch)
        arr = np.ascontiguousarray(arr[::-1])  # PFM rows are bottom-up
        cs = "gray" if ch == 1 else "rgb"
        return Image(arr.astype(np.float32), ImageSpec(colorspace=cs), device=device)
    if magic == b"P7":  # PAM
        header = data[:data.index(b"ENDHDR") + 7]
        fields = dict()
        for line in header.decode("ascii", "ignore").splitlines():
            parts = line.split()
            if len(parts) >= 2:
                fields[parts[0]] = parts[1]
        w, h = int(fields["WIDTH"]), int(fields["HEIGHT"])
        depth = int(fields["DEPTH"])
        maxv = int(fields["MAXVAL"])
        pos = len(header)  # header includes the ENDHDR trailing newline
        if maxv < 256:
            arr = np.frombuffer(data, np.uint8, count=w * h * depth, offset=pos)
        else:
            arr = np.frombuffer(data, ">u2", count=w * h * depth, offset=pos)
        arr = arr.reshape(h, w, depth).astype(np.float32) / maxv
        tup = fields.get("TUPLTYPE", "RGB")
        alpha = "ALPHA" in tup
        cs = "gray" if depth - int(alpha) == 1 else "srgb"
        return Image(arr, ImageSpec(colorspace=cs, alpha=alpha), device=device)
    raise ValueError("not a PNM stream")


def encode(image: Image, fmt: str = "ppm", depth: int = 8) -> bytes:
    arr = image.to_numpy()
    if arr.ndim == 4:
        arr = arr[0]
    fmt = fmt.lower()
    h, w, c = arr.shape
    if fmt in ("pbm",):
        gray = arr.mean(axis=-1)
        bits = (gray < 0.5).astype(np.uint8)
        packed = np.packbits(bits, axis=1)
        return b"P4\n%d %d\n" % (w, h) + packed.tobytes()
    if fmt in ("pgm",):
        gray = arr if c == 1 else arr.mean(axis=-1, keepdims=True)
        return _gray_or_rgb(b"P5", gray, depth)
    if fmt in ("pfm",):
        rgb = arr[..., :3] if c >= 3 else np.repeat(arr[..., :1], 3, -1)
        head = b"PF\n%d %d\n-1.0\n" % (w, h)
        return head + np.ascontiguousarray(rgb[::-1]).astype("<f4").tobytes()
    if fmt in ("pam",):
        maxv = 255 if depth <= 8 else 65535
        tup = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB", 4: "RGB_ALPHA"}[c]
        head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {c}\nMAXVAL {maxv}\n"
                f"TUPLTYPE {tup}\nENDHDR\n").encode()
        q = (np.clip(arr, 0, 1) * maxv + 0.5).astype(np.uint8 if maxv == 255 else ">u2")
        return head + q.tobytes()
    # ppm / pnm default
    rgb = arr[..., :3] if c >= 3 else np.repeat(arr[..., :1], 3, -1)
    return _gray_or_rgb(b"P6", rgb, depth)


def _gray_or_rgb(magic: bytes, arr: np.ndarray, depth: int) -> bytes:
    h, w = arr.shape[:2]
    maxv = 255 if depth <= 8 else 65535
    head = magic + b"\n%d %d\n%d\n" % (w, h, maxv)
    if maxv == 255:
        q = (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    else:
        q = (np.clip(arr, 0, 1) * 65535.0 + 0.5).astype(">u2")
    return head + q.tobytes()
