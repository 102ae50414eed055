"""Coders of their own: farbfeld, the raw sample formats, XBM, XPM,
sixel and an SVG subset.

Port of ``imagemagick_tpu/io/extra_coders.py`` (ImageMagick's
coders/farbfeld.c, gray.c and rgb.c, xbm.c, xpm.c, sixel.c and svg.c's
internal renderer):

* farbfeld: a magic, the extents and big-endian 16-bit RGBA;
* ``gray:``, ``rgb:``, ``rgba:``, ``bgr:``, ``bgra:``, ``cmyk:``,
  ``ycbcr:``: headerless samples at any quantum depth, which need
  ``-size`` (``utils/quantum.py``);
* XBM (C-source bitmaps) and XPM (C-source pixmaps), both ways;
* sixel, written only (terminal graphics);
* SVG, read only: shapes, paths, text, gradients, CSS rules, ``<use>``
  and embedded data-URI images, turned into MVG and rasterized by the
  port's ``ops/draw.py`` on ``device``.

Bytes are parsed and packed on the host.  The colour conversions of
``cmyk:`` and ``ycbcr:``, the k-means palettes of XPM and sixel, and the
SVG raster run on the image's device (the card unless the caller asks
for the CPU); a decoded image goes to ``device`` once.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from ..core.color import parse_color
from ..core.image import Image
from ..core.spec import ImageSpec


# ---------------------------------------------------------------------------
# farbfeld
# ---------------------------------------------------------------------------

def decode_farbfeld(data: bytes, device="cuda") -> Image:
    if data[:8] != b"farbfeld":
        raise ValueError("not farbfeld")
    w = int.from_bytes(data[8:12], "big")
    h = int.from_bytes(data[12:16], "big")
    arr = np.frombuffer(data, ">u2", count=w * h * 4, offset=16)
    f = arr.reshape(h, w, 4).astype(np.float32) / 65535.0
    return Image(f, ImageSpec(colorspace="srgb", alpha=True), device=device)


def encode_farbfeld(img: Image) -> bytes:
    arr = img.to_numpy()
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
    elif arr.shape[-1] == 1:
        arr = np.concatenate([np.repeat(arr, 3, -1), np.ones_like(arr[..., :1])], -1)
    q = (np.clip(arr, 0, 1) * 65535.0 + 0.5).astype(">u2")
    h, w = q.shape[:2]
    return (b"farbfeld" + w.to_bytes(4, "big") + h.to_bytes(4, "big") +
            q.tobytes())


# ---------------------------------------------------------------------------
# raw planes (gray:, rgb:, rgba:, bgr: — require explicit size)
# ---------------------------------------------------------------------------

def _on_device(fn, arr: np.ndarray, device) -> np.ndarray:
    """``fn`` of host pixels on ``device``, back on the host."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    return fn(x).cpu().numpy()


def decode_raw(data: bytes, fmt: str, width: int, height: int,
               depth: Optional[int] = None, device="cuda") -> Image:
    nch = {"gray": 1, "rgb": 3, "rgba": 4, "bgr": 3, "bgra": 4,
           "cmyk": 4, "ycbcr": 3}[fmt]
    if depth is None:  # infer from payload size
        depth = 16 if len(data) >= width * height * nch * 2 else 8
    from ..utils.quantum import import_quantum

    f = import_quantum(data, width, height, nch, depth)
    if fmt in ("bgr", "bgra"):
        f = f[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    cs = {"gray": "gray", "cmyk": "cmyk", "ycbcr": "ycbcr"}.get(fmt, "srgb")
    return Image(f, ImageSpec(colorspace=cs, alpha=fmt in ("rgba", "bgra")),
                 device=device)


def encode_raw(img: Image, fmt: str, depth: int = 8) -> bytes:
    arr = img.to_numpy()
    nch = {"gray": 1, "rgb": 3, "rgba": 4, "bgr": 3, "bgra": 4,
           "cmyk": 4, "ycbcr": 3, "uyvy": 3}[fmt]
    if fmt == "gray" and arr.shape[-1] > 1:
        arr = arr.mean(-1, keepdims=True)
    if arr.shape[-1] < nch:
        if arr.shape[-1] >= 3:        # RGB -> RGBA/CMYK: append opaque
            arr = np.concatenate([arr[..., :3],
                                  np.ones_like(arr[..., :1])], -1)[..., :nch]
        else:                          # gray -> expand channels
            arr = np.concatenate([np.repeat(arr[..., :1], 3, -1),
                                  np.ones_like(arr[..., :1])], -1)[..., :nch]
    arr = arr[..., :nch]
    if fmt == "bgr":
        arr = arr[..., ::-1]
    elif fmt == "bgra":
        arr = np.concatenate([arr[..., 2::-1], arr[..., 3:4]], -1)
    elif fmt == "cmyk":
        from ..ops.colorspace import rgb_to_cmyk
        arr = _on_device(rgb_to_cmyk, arr[..., :3], img.data.device)
    elif fmt in ("ycbcr", "uyvy"):
        from ..ops.colorspace import rgb_to_ycbcr
        arr = _on_device(rgb_to_ycbcr, arr[..., :3], img.data.device)
        if fmt == "uyvy":
            # 4:2:2: pairs of pixels share chroma -> U Y0 V Y1 bytes
            h2, w2, _ = arr.shape
            if w2 % 2:
                arr = arr[:, :w2 - 1]
                w2 -= 1
            y = arr[..., 0]
            cb = arr[:, 0::2, 1]
            cr = arr[:, 0::2, 2]
            out = np.zeros((h2, w2 * 2), np.float32)
            out[:, 0::4] = cb
            out[:, 1::4] = y[:, 0::2]
            out[:, 2::4] = cr
            out[:, 3::4] = y[:, 1::2]
            return (np.clip(out, 0, 1) * 255.0 + 0.5).astype(np.uint8).tobytes()
    from ..utils.quantum import export_quantum

    # full quantum wire-format breadth: 1/2/4/8/16/32-bit, MSB default
    return export_quantum(arr, depth)


# ---------------------------------------------------------------------------
# XBM (C-source 1-bit bitmaps)
# ---------------------------------------------------------------------------

def decode_xbm(data: bytes, device="cuda") -> Image:
    text = data.decode("ascii", "replace")
    w = int(re.search(r"_width\s+(\d+)", text).group(1))
    h = int(re.search(r"_height\s+(\d+)", text).group(1))
    body = re.search(r"\{([^}]*)\}", text).group(1)
    vals = [int(v, 0) for v in re.findall(r"0[xX][0-9a-fA-F]+|\d+", body)]
    rowbytes = (w + 7) // 8
    bits = np.zeros((h, w), np.float32)
    for y in range(h):
        for bx in range(rowbytes):
            byte = vals[y * rowbytes + bx]
            for b in range(8):
                x = bx * 8 + b
                if x < w and (byte >> b) & 1:
                    bits[y, x] = 1.0
    return Image((1.0 - bits)[..., None], ImageSpec(colorspace="gray"),
                 device=device)


def encode_xbm(img: Image, name: str = "image") -> bytes:
    arr = img.to_numpy()
    gray = arr.mean(-1)
    h, w = gray.shape
    bits = (gray < 0.5).astype(np.uint8)
    rowbytes = (w + 7) // 8
    out = [f"#define {name}_width {w}", f"#define {name}_height {h}",
           f"static char {name}_bits[] = {{"]
    vals = []
    for y in range(h):
        for bx in range(rowbytes):
            byte = 0
            for b in range(8):
                x = bx * 8 + b
                if x < w and bits[y, x]:
                    byte |= 1 << b
            vals.append(f"0x{byte:02X}")
    for i in range(0, len(vals), 12):
        out.append("  " + ", ".join(vals[i:i + 12]) + ",")
    out.append("};")
    return "\n".join(out).encode()


# ---------------------------------------------------------------------------
# XPM
# ---------------------------------------------------------------------------

def decode_xpm(data: bytes, device="cuda") -> Image:
    text = data.decode("utf-8", "replace")
    strings = re.findall(r'"([^"]*)"', text)
    w, h, nc, cpp = (int(v) for v in strings[0].split()[:4])
    cmap = {}
    for s in strings[1:1 + nc]:
        key = s[:cpp]
        m = re.search(r"\bc\s+(\S+)", s[cpp:])
        color = m.group(1) if m else "black"
        try:
            cmap[key] = parse_color(color)
        except ValueError:
            cmap[key] = (0, 0, 0, 0) if color.lower() == "none" else (0, 0, 0, 1)
    has_alpha = any(c[3] < 1.0 for c in cmap.values())
    nchan = 4 if has_alpha else 3
    arr = np.zeros((h, w, nchan), np.float32)
    for y, row in enumerate(strings[1 + nc:1 + nc + h]):
        for x in range(w):
            px = cmap.get(row[x * cpp:(x + 1) * cpp], (0, 0, 0, 1))
            arr[y, x] = px[:nchan]
    return Image(arr, ImageSpec(colorspace="srgb", alpha=has_alpha),
                 device=device)


def encode_xpm(img: Image, name: str = "image", max_colors: int = 64) -> bytes:
    from ..ops import quantize as qz

    data = img.data[..., :3]
    pal, labels = qz.kmeans(data, min(max_colors, 64), max_iters=8)
    pal_np = pal.cpu().numpy()
    lab_np = labels.cpu().numpy()
    chars = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "0123456789.#")
    h, w = lab_np.shape[-2:]
    lines = [f"/* XPM */", f"static char *{name}[] = {{",
             f'"{w} {h} {len(pal_np)} 1",']
    for i, c in enumerate(pal_np):
        hexc = "#" + "".join(f"{int(v * 255 + 0.5):02X}" for v in c[:3])
        lines.append(f'"{chars[i % len(chars)]} c {hexc}",')
    for y in range(h):
        row = "".join(chars[int(lab_np[y, x]) % len(chars)] for x in range(w))
        lines.append(f'"{row}",')
    lines.append("};")
    return "\n".join(lines).encode()


# ---------------------------------------------------------------------------
# sixel (encode; terminal graphics)
# ---------------------------------------------------------------------------

def encode_sixel(img: Image, max_colors: int = 16) -> bytes:
    from ..ops import quantize as qz

    pal, labels = qz.kmeans(img.data[..., :3], max_colors, max_iters=8)
    pal_np = pal.cpu().numpy()
    lab = labels.cpu().numpy()
    h, w = lab.shape[-2:]
    out = [b"\x1bPq"]
    for i, c in enumerate(pal_np):
        r, g, b = (int(v * 100) for v in c[:3])
        out.append(f"#{i};2;{r};{g};{b}".encode())
    for band in range(0, h, 6):
        for ci in range(len(pal_np)):
            row = []
            for x in range(w):
                bits = 0
                for dy in range(6):
                    y = band + dy
                    if y < h and lab[y, x] == ci:
                        bits |= 1 << dy
                row.append(63 + bits)
            if any(v != 63 for v in row):
                out.append(f"#{ci}".encode() + bytes(row) + b"$")
        out.append(b"-")
    out.append(b"\x1b\\")
    return b"".join(out)


# ---------------------------------------------------------------------------
# SVG subset (coders/svg.c internal-renderer path -> MVG)
# ---------------------------------------------------------------------------

def _svg_len(v, ref: float) -> float:
    """SVG length: plain number, unit-suffixed, or percentage of `ref`."""
    if v is None:
        return 0.0
    v = str(v).strip()
    if v.endswith("%"):
        return float(v[:-1]) / 100.0 * ref
    m = re.match(r"[-+]?[0-9.]+(?:[eE][-+]?[0-9]+)?", v)
    return float(m.group(0)) if m else 0.0


def _parse_css(text: str) -> List[tuple]:
    """Parse the <style> subset: 'sel1, sel2 { prop: val; ... }' rules.
    Returns (selector, decls) pairs; comments stripped (svg.c's CSS
    handling via the class attribute)."""
    rules = []
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    for m in re.finditer(r"([^{}]+)\{([^}]*)\}", text):
        decls = {}
        for part in m.group(2).split(";"):
            if ":" in part:
                k, v = part.split(":", 1)
                decls[k.strip()] = v.strip()
        for sel in m.group(1).split(","):
            sel = sel.strip()
            if sel:
                rules.append((sel, decls))
    return rules


def _css_decls_for(rules, tag: str, attrs: dict) -> dict:
    """Matching declarations, lowest->highest specificity (tag < class
    < id), so a later dict.update wins correctly."""
    cls = set((attrs.get("class") or "").split())
    eid = attrs.get("id")
    matched = []
    for sel, decls in rules or ():
        if sel == "*" or sel == tag:
            matched.append((0, decls))
        elif sel.startswith(".") and sel[1:] in cls:
            matched.append((1, decls))
        elif sel.startswith("#") and sel[1:] == eid:
            matched.append((2, decls))
        elif re.fullmatch(re.escape(tag) + r"\.[\w-]+", sel) and \
                sel.split(".", 1)[1] in cls:
            matched.append((1, decls))
    out = {}
    for _, decls in sorted(matched, key=lambda t: t[0]):
        out.update(decls)
    return out


def _svg_style(attrs: dict, tag: str = "", css_rules=None) -> List[str]:
    mvg = []
    style = attrs.get("style", "")
    # cascade: presentation attributes < CSS rules < inline style
    merged = dict(attrs)
    merged.update(_css_decls_for(css_rules, tag, attrs))
    for part in style.split(";"):
        if ":" in part:
            k, v = part.split(":", 1)
            merged[k.strip()] = v.strip()
    if "fill" in merged:
        mvg.append(f"fill '{merged['fill']}'")
    if "stroke" in merged:
        mvg.append(f"stroke '{merged['stroke']}'")
    if "stroke-width" in merged:
        mvg.append(f"stroke-width {merged['stroke-width']}")
    if "fill-opacity" in merged:
        mvg.append(f"fill-opacity {merged['fill-opacity']}")
    if "stroke-opacity" in merged:
        mvg.append(f"stroke-opacity {merged['stroke-opacity']}")
    if "fill-rule" in merged:
        mvg.append(f"fill-rule {merged['fill-rule']}")
    if "stroke-dasharray" in merged and merged["stroke-dasharray"] != "none":
        da = " ".join(re.split(r"[\s,]+", merged["stroke-dasharray"].strip()))
        mvg.append(f"stroke-dasharray {da}")
    if "stroke-linecap" in merged:
        mvg.append(f"stroke-linecap {merged['stroke-linecap']}")
    if "stroke-linejoin" in merged:
        mvg.append(f"stroke-linejoin {merged['stroke-linejoin']}")
    if "font-size" in merged:
        mvg.append(f"font-size {re.sub('[a-z]+$', '', merged['font-size'])}")
    return mvg


def decode_svg(data: bytes, width: Optional[int] = None,
               height: Optional[int] = None, device="cuda") -> Image:
    """Rasterize an SVG subset: rect/circle/ellipse/line/polygon/polyline/
    path/text with fill/stroke presentation attributes, on ``device``."""
    import xml.etree.ElementTree as ET

    from ..core.image import checked_device
    from ..ops import draw as dw

    device = checked_device(device)

    text = data.decode("utf-8", "replace")
    text = re.sub(r'xmlns(:\w+)?="[^"]*"', "", text, count=4)
    text = text.replace("xlink:href=", "href=")
    root = ET.fromstring(text)

    def dim(v, default):
        if v is None:
            return default
        m = re.match(r"([0-9.]+)", v)
        return float(m.group(1)) if m else default

    vb = root.get("viewBox")
    if vb:
        _, _, vw, vh = (float(x) for x in re.split(r"[\s,]+", vb.strip()))
    else:
        vw = dim(root.get("width"), 256.0)
        vh = dim(root.get("height"), 256.0)
    w = width or int(dim(root.get("width"), vw))
    h = height or int(dim(root.get("height"), vh))

    mvg_parts: List[str] = []
    overlays: List[tuple] = []
    sx, sy = w / vw, h / vh

    # pre-pass: id registry, <style> CSS rules, gradient definitions
    by_id = {}
    css_rules: List[tuple] = []
    for el in root.iter():
        t = el.tag.split("}")[-1]
        if "id" in el.attrib:
            by_id[el.attrib["id"]] = el
        if t == "style" and el.text:
            css_rules.extend(_parse_css(el.text))

    def grad_stops(el):
        """<stop> list, following href= inheritance to another gradient."""
        stops = list(el)
        stops = [st for st in stops if st.tag.split("}")[-1] == "stop"]
        if not stops:
            ref = (el.get("href") or "").lstrip("#")
            if ref in by_id:
                return grad_stops(by_id[ref])
        return stops

    def emit_gradient(el):
        t = el.tag.split("}")[-1]
        name = el.get("id")
        if not name:
            return
        units = el.get("gradientUnits", "objectBoundingBox")
        # objectBoundingBox approximated against the viewport (exact for
        # full-canvas shapes; svg.c maps these through the bbox)
        fx = (lambda v, d: _svg_len(v, vw) * sx) if units != "objectBoundingBox" \
            else (lambda v, d: _svg_len(v, 1.0) * d)
        if t == "linearGradient":
            x1 = fx(el.get("x1", "0%"), w)
            y1 = fx(el.get("y1", "0%"), h)
            x2 = fx(el.get("x2", "100%"), w)
            y2 = fx(el.get("y2", "0%"), h)
            if units != "objectBoundingBox":
                y1 = _svg_len(el.get("y1", "0%"), vh) * sy
                y2 = _svg_len(el.get("y2", "0%"), vh) * sy
            mvg_parts.append(f"push gradient {name} linear "
                             f"{x1},{y1} {x2},{y2}")
        else:
            cx = fx(el.get("cx", "50%"), w)
            cy = fx(el.get("cy", "50%"), h)
            r = fx(el.get("r", "50%"), min(w, h))
            if units != "objectBoundingBox":
                cy = _svg_len(el.get("cy", "50%"), vh) * sy
            mvg_parts.append(f"push gradient {name} radial "
                             f"{cx},{cy} {cx + r},{cy}")
        for st in grad_stops(el):
            sa = dict(st.attrib)
            for part in (sa.get("style") or "").split(";"):
                if ":" in part:
                    k, v = part.split(":", 1)
                    sa[k.strip()] = v.strip()
            col = sa.get("stop-color", "black")
            off = _svg_len(sa.get("offset", "0"), 1.0)
            mvg_parts.append(f"stop-color '{col}' {off}")
        mvg_parts.append("pop gradient")

    for el in root.iter():
        if el.tag.split("}")[-1] in ("linearGradient", "radialGradient"):
            emit_gradient(el)

    if sx != 1.0 or sy != 1.0:
        mvg_parts.append(f"scale {sx},{sy}")

    _NO_RENDER = {"defs", "style", "linearGradient", "radialGradient",
                  "symbol", "clipPath", "mask", "metadata", "title",
                  "desc", "pattern"}

    def walk(el):
        tag = el.tag.split("}")[-1]
        if tag in _NO_RENDER:
            return
        a = el.attrib
        mvg_parts.append("push graphic-context")
        mvg_parts.extend(_svg_style(a, tag, css_rules))
        tr = a.get("transform", "")
        for m in re.finditer(r"(translate|scale|rotate)\(([^)]*)\)", tr):
            vals = [float(v) for v in re.split(r"[\s,]+", m.group(2).strip()) if v]
            if m.group(1) == "translate":
                mvg_parts.append(f"translate {vals[0]},{vals[1] if len(vals) > 1 else 0}")
            elif m.group(1) == "scale":
                mvg_parts.append(f"scale {vals[0]},{vals[1] if len(vals) > 1 else vals[0]}")
            else:
                mvg_parts.append(f"rotate {vals[0]}")
        if tag == "rect":
            x, y = float(a.get("x", 0)), float(a.get("y", 0))
            rw, rh = float(a.get("width", 0)), float(a.get("height", 0))
            mvg_parts.append(f"rectangle {x},{y} {x + rw},{y + rh}")
        elif tag == "circle":
            cx, cy, r = (float(a.get(k, 0)) for k in ("cx", "cy", "r"))
            mvg_parts.append(f"circle {cx},{cy} {cx + r},{cy}")
        elif tag == "ellipse":
            cx, cy = float(a.get("cx", 0)), float(a.get("cy", 0))
            rx, ry = float(a.get("rx", 0)), float(a.get("ry", 0))
            mvg_parts.append(f"ellipse {cx},{cy} {rx},{ry} 0,360")
        elif tag == "line":
            mvg_parts.append(f"line {a.get('x1', 0)},{a.get('y1', 0)} "
                             f"{a.get('x2', 0)},{a.get('y2', 0)}")
        elif tag in ("polygon", "polyline"):
            pts = a.get("points", "").strip()
            coords = re.split(r"[\s,]+", pts)
            pairs = " ".join(f"{coords[i]},{coords[i + 1]}"
                             for i in range(0, len(coords) - 1, 2))
            mvg_parts.append(f"{tag} {pairs}")
        elif tag == "path":
            mvg_parts.append(f"path '{a.get('d', '')}'")
        elif tag == "use":
            # <defs>/<use> reuse (svg.c SVGStartElement 'use'): render the
            # referenced element translated by x,y in this context
            ref = (a.get("href") or "").lstrip("#")
            ux, uy = float(a.get("x", 0)), float(a.get("y", 0))
            if ref in by_id:
                if ux or uy:
                    mvg_parts.append(f"translate {ux},{uy}")
                target = by_id[ref]
                if target.tag.split("}")[-1] == "symbol":
                    for child in target:
                        walk(child)
                else:
                    walk(target)
        elif tag == "text":
            x, y = float(a.get("x", 0)), float(a.get("y", 0))
            mvg_parts.append(f"text {x},{y} '{(el.text or '').strip()}'")
        elif tag == "image":
            href = a.get("href") or a.get(
                "{http://www.w3.org/1999/xlink}href") or ""
            if href.startswith("data:"):
                import base64 as _b64

                payload = href.split("base64,", 1)[-1]
                try:
                    from . import codecs as _codecs

                    inner = _codecs.decode(_b64.b64decode(payload), None,
                                           device)[0]
                    overlays.append((float(a.get("x", 0)),
                                     float(a.get("y", 0)),
                                     float(a.get("width", inner.width)),
                                     float(a.get("height", inner.height)),
                                     inner))
                except Exception:
                    pass
        for child in el:
            walk(child)
        mvg_parts.append("pop graphic-context")

    for child in root:
        walk(child)

    canvas = torch.ones((h, w, 4), dtype=torch.float32, device=device)
    canvas[..., 3] = 0.0
    out = dw.draw(canvas, " ".join(mvg_parts), has_alpha=True)
    for ox, oy, ow, oh, inner in overlays:
        arr = inner.data.to(device=device, dtype=torch.float32)
        if arr.dim() == 4:
            arr = arr[0]
        if int(ow) != arr.shape[1] or int(oh) != arr.shape[0]:
            from ..ops.resize import resize as _resize

            arr = _resize(arr[None], max(int(oh), 1), max(int(ow), 1),
                          "triangle")[0]
        if arr.shape[-1] == 1:
            arr = arr.repeat_interleave(3, dim=-1)
        if arr.shape[-1] == 3:
            arr = torch.cat([arr, torch.ones_like(arr[..., :1])], -1)
        y0, x0 = int(oy), int(ox)
        hh = min(arr.shape[0], h - y0)
        ww = min(arr.shape[1], w - x0)
        if hh > 0 and ww > 0:
            out = out.clone()
            out[y0:y0 + hh, x0:x0 + ww, :] = arr[:hh, :ww, :4]
    return Image(out, ImageSpec(colorspace="srgb", alpha=True))
