"""Procedural pseudo-coders: xc:, gradient:, plasma:, pattern:, hald:, ...

Port of ``imagemagick_tpu/io/pseudo.py`` (ImageMagick's coders/xc.c,
gradient.c, plasma.c, pattern.c, hald.c, label.c, caption.c, tile.c,
histogram.c, thumbnail.c, vid.c and the built-in images of magick.c).
The generators make their pixels on ``device`` with the JAX module's
float32 expressions: a ramp's positions are ``i * (1 / (n - 1))`` with
the last set to 1, as ``jnp.linspace`` gives them, and a radial
gradient's distances take their square root in float64, rounded to
float32 as XLA's correctly rounded ``sqrt`` gives it.  ``plasma:`` is
made on the host in numpy from its seed, and ``label:``'s text mask and
``histogram:``'s bars on the host, as in the JAX module.  ``stegano:``
reads its host image on ``device`` and extracts the watermark with
``formats4.decode_stegano``.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

from ..core.color import parse_color
from ..core.image import Image
from ..core.spec import ImageSpec


def _rgba(color: str, device) -> torch.Tensor:
    return torch.tensor(parse_color(color), dtype=torch.float32,
                        device=device)


def xc(color: str = "white", width: int = 1, height: int = 1,
       device="cuda") -> Image:
    """xc: / canvas: — constant-color canvas (coders/xc.c)."""
    r, g, b, a = parse_color(color)
    has_alpha = a < 1.0
    ch = 4 if has_alpha else 3
    vals = torch.tensor([r, g, b, a][:ch], dtype=torch.float32,
                        device=device)
    data = vals.expand(height, width, ch).contiguous()
    return Image(data, ImageSpec(colorspace="srgb", alpha=has_alpha))


def _linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: float32 positions times the
    float32 step, the last one exactly 1."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    if n < 2:
        return i
    t = i * torch.tensor(np.float32(1.0) / np.float32(n - 1), device=device)
    t[-1] = 1.0
    return t


def _two_colors(spec: str):
    if "-" in spec:
        c1s, c2s = spec.split("-", 1)
    else:
        c1s, c2s = spec or "white", "black"
    return c1s or "white", c2s or "black"


def _ramp(c1: torch.Tensor, c2: torch.Tensor, t: torch.Tensor) -> Image:
    data = c1 * (1.0 - t) + c2 * t
    has_alpha = bool(c1[3] < 1.0 or c2[3] < 1.0)
    if not has_alpha:
        data = data[..., :3].contiguous()
    return Image(data, ImageSpec(colorspace="srgb", alpha=has_alpha))


def gradient(spec: str = "white-black", width: int = 256, height: int = 256,
             direction: str = "vertical", device="cuda") -> Image:
    """gradient: — linear two-color ramp (coders/gradient.c)."""
    c1s, c2s = _two_colors(spec)
    c1, c2 = _rgba(c1s, device), _rgba(c2s, device)
    # paint.c:545-551: the default diagonal vector collapses to vertical
    # only when rows>1 (y2 != 0); a 1-row gradient runs horizontally
    if direction == "vertical" and height == 1:
        direction = "horizontal"
    if direction == "horizontal":
        t = _linspace(width, device)[None, :, None].expand(height, width, 1)
    else:
        t = _linspace(height, device)[:, None, None].expand(height, width, 1)
    return _ramp(c1, c2, t)


def radial_gradient(spec: str = "white-black", width: int = 256,
                    height: int = 256, device="cuda") -> Image:
    """radial-gradient: (coders/gradient.c radial mode)."""
    c1s, c2s = _two_colors(spec)
    c1, c2 = _rgba(c1s, device), _rgba(c2s, device)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    dy, dx = yy - cy, xx - cx
    r = torch.sqrt((dy * dy + dx * dx).double()).float()
    t = torch.clamp(r / max(math.hypot(cx, cy), 1e-6), 0.0, 1.0)[..., None]
    return _ramp(c1, c2, t)


def plasma(spec: str = "", width: int = 256, height: int = 256,
           seed: int = 0, device="cuda") -> Image:
    """plasma: — fractal clouds (coders/plasma.c), synthesized as in the
    JAX module: band-filtered noise of a power-law spectrum, made on the
    host in numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(height)[:, None]
    fx = np.fft.rfftfreq(width)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    amp = np.where(f > 0, 1.0 / np.maximum(f, 1e-6), 0.0)

    def layer():
        phase = rng.uniform(0.0, 2.0 * math.pi, amp.shape)
        spec_ = amp * np.exp(1j * phase)
        x = np.fft.irfft2(spec_, s=(height, width))
        return (x - x.min()) / max(x.max() - x.min(), 1e-12)

    data = np.stack([layer(), layer(), layer()], axis=-1)
    return Image(data.astype(np.float32), ImageSpec(colorspace="srgb"),
                 device=device)


def hald(level: int = 8, device="cuda") -> Image:
    """hald: — identity Hald CLUT of the given level (coders/hald.c).

    A level-N Hald image is (N³)x(N³) encoding an N²-per-axis identity LUT.
    """
    n = level * level  # samples per channel axis
    side = level ** 3
    idx = torch.arange(side * side, dtype=torch.int32, device=device)
    r = idx % n
    g = (idx // n) % n
    b = idx // (n * n)
    scale = torch.tensor(np.float32(1.0 / (n - 1)), device=device)
    data = torch.stack([r * scale, g * scale, b * scale], dim=-1)
    return Image(data.reshape(side, side, 3), ImageSpec(colorspace="srgb"))


def checkerboard(width: int = 256, height: int = 256, size: int = 16,
                 c1: str = "#CCCCCC", c2: str = "#666666",
                 device="cuda") -> Image:
    """pattern:checkerboard (coders/pattern.c built-in tile)."""
    a = _rgba(c1, device)[:3]
    b = _rgba(c2, device)[:3]
    yy = (torch.arange(height, device=device) // size)[:, None]
    xx = (torch.arange(width, device=device) // size)[None, :]
    mask = ((yy + xx) % 2 == 0)[..., None]
    return Image(torch.where(mask, a, b), ImageSpec(colorspace="srgb"))


_PATTERNS = {"checkerboard": checkerboard}


def pattern(name: str, width: int = 256, height: int = 256,
            device="cuda") -> Image:
    name = name.lower()
    if name in _PATTERNS:
        return _PATTERNS[name](width, height, device=device)
    # gray-percent patterns (pattern:gray50 etc.)
    if name.startswith("gray"):
        pct = int(name[4:]) / 100.0
        return xc(f"gray({pct * 255.0:.0f})", width, height, device)
    raise ValueError(f"unknown pattern {name!r}")


# The built-in images (ImageMagick's coders/magick.c MagickImageList:
# LOGO, GRANITE, ROSE, WIZARD, NETSCAPE) as 8-bit RGB, one zlib stream
# each, in a copy of the JAX package's asset beside this module.
_BUILTIN_CACHE = {}


def _load_builtin(name: str, device) -> Image:
    if name not in _BUILTIN_CACHE:
        path = os.path.join(os.path.dirname(__file__), "builtin_images.bin")
        with open(path, "rb") as f:
            blob = f.read()
        pos = 0
        found = None
        while pos < len(blob):
            end = blob.index(b"\0", pos)
            key = blob[pos:end].decode()
            h, w, clen = struct.unpack_from("<III", blob, end + 1)
            data_off = end + 13
            if key == name:
                raw = zlib.decompress(blob[data_off:data_off + clen])
                arr = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
                found = arr.astype(np.float32) / 255.0
            pos = data_off + clen
        if found is None:
            raise ValueError(f"unknown builtin image {name!r}")
        _BUILTIN_CACHE[name] = found
    return Image(_BUILTIN_CACHE[name], ImageSpec(colorspace="srgb", depth=8),
                 device=device)


def logo(device="cuda") -> Image:
    return _load_builtin("logo", device)


def rose(device="cuda") -> Image:
    return _load_builtin("rose", device)


def wizard(device="cuda") -> Image:
    return _load_builtin("wizard", device)


def granite(device="cuda") -> Image:
    return _load_builtin("granite", device)


def netscape(device="cuda") -> Image:
    return _load_builtin("netscape", device)


def label(text: str, width=None, height=None, settings=None,
          device="cuda") -> Image:
    """label: pseudo-coder (coders/label.c): render text on a canvas sized
    to the text metrics, honoring pointsize/font/fill/background settings.
    The text's coverage mask comes from the port's ``ops/draw.py`` on the
    host, and the canvas is blended there, as in the JAX module."""
    from ..ops.draw import render_text_mask

    s = settings or {}
    size = float(s.get("pointsize", 12) or 12)
    font = s.get("font") or None
    fill = parse_color(s.get("fill", "black"))
    bg = parse_color(s.get("background", "white"))
    mask, _ = render_text_mask(text, font, size,
                               direction=s.get("direction"))
    mh, mw = mask.shape
    w = width or mw
    h = height or mh
    canvas = np.ones((h, w, 3), np.float32) * np.asarray(bg[:3], np.float32)
    m = np.zeros((h, w), np.float32)
    m[:min(mh, h), :min(mw, w)] = mask[:min(mh, h), :min(mw, w)]
    out = canvas * (1 - m[..., None]) + np.asarray(fill[:3]) * m[..., None]
    img = Image(out, ImageSpec(colorspace="srgb", depth=8), device=device)
    img.properties["label"] = text
    return img


def caption(text: str, width=None, height=None, settings=None,
            device="cuda") -> Image:
    """caption: pseudo-coder (coders/caption.c): word-wrapped label."""
    from ..ops.draw import get_type_metrics

    s = settings or {}
    size = float(s.get("pointsize", 12) or 12)
    font = s.get("font") or None
    w = width or 256
    # greedy word wrap to the canvas width
    words = text.split()
    lines, cur = [], ""
    for word in words:
        probe = (cur + " " + word).strip()
        if get_type_metrics(probe, font, size)["width"] > w and cur:
            lines.append(cur)
            cur = word
        else:
            cur = probe
    if cur:
        lines.append(cur)
    return label("\n".join(lines), width, height, settings, device)


def tile_file(filename: str, width=None, height=None, settings=None,
              device="cuda") -> Image:
    """tile: pseudo-coder (coders/tile.c): tile a file to the -size canvas."""
    from . import read_images

    base = read_images(filename, device=device)[0]
    w = width or base.width
    h = height or base.height
    ry = -(-h // base.height)
    rx = -(-w // base.width)
    tiled = base.data.repeat(ry, rx, 1)[:h, :w]
    return Image(tiled, base.spec)


def histogram_file(filename: str, width=None, height=None, settings=None,
                   device="cuda") -> Image:
    """histogram: pseudo-coder (coders/histogram.c): 256x200 channel
    graph, drawn on the host as in the JAX module."""
    from . import read_images

    base = read_images(filename, device=device)[0]
    arr = np.clip(base.to_numpy(), 0, 1)
    if arr.ndim == 4:
        arr = arr[0]
    h_out, w_out = height or 200, width or 256
    c = min(arr.shape[-1], 3)
    canvas = np.zeros((h_out, w_out, 3), np.float32)
    for ci in range(c):
        hist, _ = np.histogram(arr[..., ci], bins=w_out, range=(0.0, 1.0))
        peak = max(hist.max(), 1)
        heights = (hist / peak * (h_out - 1)).astype(np.int64)
        color = np.zeros(3, np.float32)
        color[ci if c == 3 else slice(None)] = 1.0
        for x in range(w_out):
            if heights[x]:
                canvas[h_out - heights[x]:, x, :] = np.maximum(
                    canvas[h_out - heights[x]:, x, :], color)
    img = Image(canvas, ImageSpec(colorspace="srgb", depth=8), device=device)
    img.properties["comment"] = "histogram"
    return img


def thumbnail_file(filename: str, width=None, height=None, settings=None,
                   device="cuda") -> Image:
    """thumbnail: pseudo-coder (coders/thumbnail.c): read + ThumbnailImage."""
    from . import read_images
    from ..ops.resize import thumbnail as thumb_op

    base = read_images(filename, device=device)[0]
    w = width or 106
    h = height or int(round(w * base.height / base.width))
    return base.replace(data=thumb_op(base.data, h, w,
                                      has_alpha=base.spec.alpha))


def stegano_file(filename: str, width=None, height=None, settings=None,
                 device="cuda") -> Image:
    """stegano: pseudo-coder (coders/stegano.c read side): extract the
    LSB watermark from a host image; geometry comes from -size."""
    from . import formats4, read_images

    if not (width and height):
        raise ValueError("stegano: requires -size WxH")
    host = read_images(filename, device=device)[0]
    return formats4.decode_stegano(host, int(width), int(height), device)


def vid_file(pattern: str, width=None, height=None, settings=None,
             device="cuda") -> Image:
    """vid: pseudo-coder (coders/vid.c): visual image directory — a
    thumbnail montage of the files matching a glob."""
    import glob as _glob

    from . import read_images
    from ..ops import montage as mtg
    from ..ops.resize import thumbnail as thumb_op

    names = sorted(_glob.glob(pattern)) or [pattern]
    tiles = []
    for name in names[:64]:
        try:
            im = read_images(name, device=device)[0]
        except Exception:   # noqa: BLE001 — an unreadable file is skipped
            continue
        tw = int(width or 120)
        th = max(1, int(round(tw * im.height / max(1, im.width))))
        tiles.append(Image(thumb_op(im.data, th, tw,
                                    has_alpha=im.spec.alpha), im.spec))
    if not tiles:
        raise FileNotFoundError("vid: no readable files match %r" % pattern)
    return mtg.montage(tiles)
