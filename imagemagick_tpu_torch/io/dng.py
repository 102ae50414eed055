"""DNG (Digital Negative), uncompressed CFA raws (coders/dng.c, the
dcraw and libraw delegates).

Port of ``imagemagick_tpu/io/dng.py``: the TIFF container's IFDs (with
SubIFDs) are walked on the host, the 8- or 16-bit CFA mosaic is read
from its strips, linearized between the black and white levels and
white-balanced from AsShotNeutral, then demosaiced bilinearly on
``device`` (the card unless the caller asks for the CPU): three masked
3x3 depthwise convolutions (``torch.nn.functional.conv2d``, where the
JAX module runs ``lax.conv_general_dilated``; it is an XLA convolution
there, not a Pallas kernel) and ``num / max(den, 1e-6)``, then the sRGB
transfer.  A compressed DNG raises ValueError naming the dcraw delegate,
which ``io/__init__.py`` then tries.  ``encode_dng`` writes a minimal
16-bit RGGB DNG from an RGB image, on the host.  Tags: DNGVersion
50706, CFARepeatPatternDim 33421, CFAPattern 33422, BlackLevel 50714,
WhiteLevel 50717, AsShotNeutral 50728.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.image import Image
from ..core.spec import ImageSpec

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d"}


def _read_ifd(data: bytes, e: str, off: int) -> Tuple[Dict[int, tuple], int]:
    (n,) = struct.unpack_from(e + "H", data, off)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(e + "HHI4s", data,
                                                  off + 2 + i * 12)
        tags[tag] = (typ, count, raw)
    (nxt,) = struct.unpack_from(e + "I", data, off + 2 + n * 12)
    return tags, nxt


def _values(data: bytes, e: str, entry) -> List:
    typ, count, raw = entry
    size = _TYPE_SIZE.get(typ, 4)
    total = count * size
    src, off = (raw, 0) if total <= 4 else \
        (data, struct.unpack(e + "I", raw)[0])
    out = []
    for i in range(count):
        if typ in (5, 10):      # RATIONAL
            num, den = struct.unpack_from(e + ("II" if typ == 5 else "ii"),
                                          src, off + i * 8)
            out.append(num / den if den else 0.0)
        else:
            fmt = _TYPE_FMT.get(typ, "I")
            out.append(struct.unpack_from(e + fmt, src, off + i * size)[0])
    return out


def is_dng(data: bytes) -> bool:
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        return False
    e = "<" if data[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack_from(e + "I", data, 4)
        tags, _ = _read_ifd(data, e, ifd)
        return 50706 in tags        # DNGVersion
    except Exception:               # noqa: BLE001
        return False


def _collect_ifds(data: bytes, e: str) -> List[Dict[int, tuple]]:
    out = []
    (off,) = struct.unpack_from(e + "I", data, 4)
    seen = set()
    stack = [off]
    while stack:
        off = stack.pop()
        if off == 0 or off in seen or off + 2 > len(data):
            continue
        seen.add(off)
        try:
            tags, nxt = _read_ifd(data, e, off)
        except Exception:           # noqa: BLE001
            continue
        out.append(tags)
        stack.append(nxt)
        if 330 in tags:             # SubIFDs
            stack.extend(_values(data, e, tags[330]))
    return out


def decode_dng(data: bytes, device="cuda") -> Image:
    """Decode an uncompressed-CFA DNG to an sRGB image on ``device``."""
    if not is_dng(data):
        raise ValueError("DNG: missing DNGVersion tag")
    e = "<" if data[:2] == b"II" else ">"
    ifds = _collect_ifds(data, e)

    # the raw IFD: NewSubfileType 0 with PhotometricInterpretation CFA
    raw = None
    for tags in ifds:
        photo = _values(data, e, tags[262])[0] if 262 in tags else None
        sub = _values(data, e, tags[254])[0] if 254 in tags else 0
        if photo == 32803 and sub == 0:
            raw = tags
            break
    if raw is None:                 # fall back: any CFA IFD
        for tags in ifds:
            if 262 in tags and _values(data, e, tags[262])[0] == 32803:
                raw = tags
                break
    if raw is None:
        raise ValueError("DNG: no CFA raw IFD found")

    def val(tag, default=None):
        return _values(data, e, raw[tag])[0] if tag in raw else default

    comp = val(259, 1)
    if comp not in (1,):
        raise ValueError(
            f"DNG: compression {comp} unsupported (only uncompressed CFA; "
            "the reference shells out to dcraw/libraw for these — "
            "delegates.xml.in:70)")
    w, h = val(256), val(257)
    bps = val(258, 16)
    offs = _values(data, e, raw[273])
    counts = _values(data, e, raw[279]) if 279 in raw else None
    rows_per_strip = val(278, h)
    if bps not in (8, 16):
        raise ValueError(f"DNG: {bps}-bit CFA unsupported")
    dt = np.dtype("u2" if bps == 16 else "u1").newbyteorder(e)
    rows = []
    for i, off in enumerate(offs):
        nrows = min(rows_per_strip, h - i * rows_per_strip)
        nbytes = nrows * w * (bps // 8)
        rows.append(np.frombuffer(data, dt, nrows * w, off)
                    .reshape(nrows, w))
    cfa = np.concatenate(rows, 0).astype(np.float32)

    # linearize
    black = val(50714, 0.0)
    white = val(50717, float(2 ** bps - 1))
    cfa = np.clip((cfa - black) / max(white - black, 1.0), 0.0, 1.0)

    # CFA pattern (tag 33422, row-major over the repeat block; 0=R 1=G 2=B)
    pat = _values(data, e, raw[33422]) if 33422 in raw else [0, 1, 1, 2]
    dim = _values(data, e, raw[33421]) if 33421 in raw else [2, 2]
    ph, pw = int(dim[0]), int(dim[1])
    pattern = np.asarray(pat, np.int64).reshape(ph, pw)

    # white balance from AsShotNeutral (camera neutral -> multipliers)
    neutral = None
    for tags in ifds:
        if 50728 in tags:
            neutral = _values(data, e, tags[50728])
            break
    wb = np.asarray([1.0 / max(v, 1e-6) for v in neutral], np.float32) \
        if neutral and len(neutral) == 3 else np.ones(3, np.float32)
    wb = wb / wb[1]

    from ..core.image import checked_device
    from ..ops.colorspace import linear_to_srgb

    rgb = _demosaic_bilinear(cfa, pattern, wb, checked_device(device))
    # simple camera->sRGB rendering: normalize + encode gamma
    out = linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
    return Image(out, ImageSpec(colorspace="srgb", depth=16))


def _demosaic_bilinear(cfa: np.ndarray, pattern: np.ndarray,
                       wb: np.ndarray, device="cpu") -> torch.Tensor:
    """Bilinear demosaic as masked 3x3 depthwise convolutions on
    ``device``: each channel plane is the CFA times the channel's mask,
    and a missing sample is the weighted mean of its neighbours,
    conv(plane, K) / max(conv(mask, K), 1e-6) with K the bilinear 3x3
    weights.  Returns (H, W, 3) float32 on ``device``."""
    h, w = cfa.shape
    ph, pw = pattern.shape
    yy, xx = np.mgrid[0:h, 0:w]
    chan = torch.from_numpy(pattern[yy % ph, xx % pw]).to(device)
    k = torch.tensor([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5],
                      [0.25, 0.5, 0.25]], dtype=torch.float32, device=device)
    x = torch.from_numpy(np.ascontiguousarray(cfa, np.float32)).to(device)
    gains = torch.from_numpy(np.asarray(wb, np.float32)).to(device)
    masks = torch.stack([(chan == c).to(torch.float32) for c in range(3)])
    num = _conv3(x * masks * gains[:, None, None], k)
    den = _conv3(masks, k)
    return (num / torch.clamp(den, min=1e-6)).permute(1, 2, 0).contiguous()


def _conv3(planes: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The same 3x3 correlation over each of (C, H, W) planes, zeros
    outside (XLA's SAME padding)."""
    c = planes.shape[0]
    weight = k[None, None].expand(c, 1, 3, 3)
    return F.conv2d(planes[None], weight, padding=1, groups=c)[0]


def encode_dng(img: Image) -> bytes:
    """Write a minimal uncompressed-CFA DNG (mosaicked from RGB with an
    RGGB pattern) — primarily a test/interchange fixture writer."""
    arr = img.to_numpy()[..., :3].astype(np.float64)
    h, w = arr.shape[:2]
    h -= h % 2
    w -= w % 2
    arr = arr[:h, :w]
    lin = np.where(arr <= 0.0404482362771076, arr / 12.92,
                   ((arr + 0.055) / 1.055) ** 2.4)
    yy, xx = np.mgrid[0:h, 0:w]
    chan = np.where((yy % 2 == 0) & (xx % 2 == 0), 0,
                    np.where((yy % 2 == 1) & (xx % 2 == 1), 2, 1))
    cfa = np.take_along_axis(lin.reshape(h, w, 3),
                             chan[..., None], axis=2)[..., 0]
    raw16 = (np.clip(cfa, 0, 1) * 65535 + 0.5).astype("<u2")

    entries = []        # (tag, type, count, value-bytes or int)

    def ent(tag, typ, vals):
        entries.append((tag, typ, vals))

    strip_data = raw16.tobytes()
    ent(254, 4, [0])                 # NewSubfileType: full-res
    ent(256, 4, [w])
    ent(257, 4, [h])
    ent(258, 3, [16])
    ent(259, 3, [1])                 # uncompressed
    ent(262, 3, [32803])             # CFA
    ent(273, 4, [0])                 # StripOffsets (patched)
    ent(277, 3, [1])
    ent(278, 4, [h])
    ent(279, 4, [len(strip_data)])
    ent(33421, 3, [2, 2])            # CFARepeatPatternDim
    ent(33422, 1, [0, 1, 1, 2])      # RGGB
    ent(50706, 1, [1, 4, 0, 0])      # DNGVersion
    ent(50714, 3, [0])               # BlackLevel
    ent(50717, 3, [65535])           # WhiteLevel
    entries.sort()

    header = struct.pack("<2sHI", b"II", 42, 8)
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    data_off = 8 + ifd_size
    extra = b""
    body = struct.pack("<H", n)
    strip_pos = None
    for tag, typ, vals in entries:
        size = _TYPE_SIZE[typ] * len(vals)
        fmt = _TYPE_FMT[typ] * len(vals)
        packed = struct.pack("<" + fmt, *vals)
        if tag == 273:
            strip_pos = None  # patch below
        if size <= 4:
            raw = packed.ljust(4, b"\x00")
        else:
            raw = struct.pack("<I", data_off + len(extra))
            extra += packed
        body += struct.pack("<HHI", tag, typ, len(vals)) + raw
    body += struct.pack("<I", 0)
    strip_off = data_off + len(extra)
    # patch StripOffsets value (tag 273 entry)
    out = bytearray(header + body + extra + strip_data)
    pos = 8 + 2
    for tag, typ, vals in entries:
        if tag == 273:
            struct.pack_into("<I", out, pos + 8, strip_off)
        pos += 12
    return bytes(out)
