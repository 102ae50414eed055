"""EMF (Enhanced Metafile) reader: EMR record stream -> MVG -> raster.

Port of ``imagemagick_tpu/io/emf.py``.  ImageMagick's coders/emf.c plays
back EMF through the Windows GDI (Windows-only build).  Here the record
stream is parsed directly on the host and rendered through the same MVG
rasterizer the WMF and SVG coders use, on ``device`` (the card unless the
caller asks for the CPU): the canvas is made and drawn there, and the
embedded DIBs are resized and composited there.

Supported EMR records: header/frame sizing, window/viewport/world
transforms, pen/brush/font object tables (incl. ExtCreatePen and the GDI
stock objects), Poly{gon,line,Bezier}{,To}{,16}, PolyPolygon/Polyline{,16},
Rectangle/Ellipse/RoundRect/LineTo/MoveToEx/SetPixelV, path construction
(BeginPath..EndPath with Fill/Stroke/StrokeAndFillPath, CloseFigure),
ExtTextOutA/W, SetTextColor/SetBkColor, and embedded DIBs via
StretchDIBits/BitBlt.

Reference parity: coders/emf.c:894 (record playback + frame sizing at
ReadEnhMetaFile/emf.c:434 which derives pixels from rclFrame 0.01mm units
at the requested density — the same rule used here).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.image import Image

_EMF_SIG = 0x464D4520          # " EMF" dSignature (emf.c header check)

# GDI stock objects (high-bit handles in EMR_SELECTOBJECT)
_STOCK = {
    0: ("brush", "#FFFFFF", 0),     # WHITE_BRUSH
    1: ("brush", "#C0C0C0", 0),     # LTGRAY_BRUSH
    2: ("brush", "#808080", 0),     # GRAY_BRUSH
    3: ("brush", "#404040", 0),     # DKGRAY_BRUSH
    4: ("brush", "#000000", 0),     # BLACK_BRUSH
    5: ("brush", None, 1),          # NULL_BRUSH
    6: ("pen", "#FFFFFF", 0),       # WHITE_PEN
    7: ("pen", "#000000", 0),       # BLACK_PEN
    8: ("pen", None, 5),            # NULL_PEN
}


def _cref(v: int) -> str:
    return "#%02X%02X%02X" % (v & 255, (v >> 8) & 255, (v >> 16) & 255)


def is_emf(data: bytes) -> bool:
    return (len(data) >= 48 and data[:4] == b"\x01\x00\x00\x00"
            and struct.unpack("<I", data[40:44])[0] == _EMF_SIG)


def decode_emf(data: bytes, density: float = 96.0, device="cuda") -> Image:
    """Parse an EMF record stream and rasterize it through the MVG
    renderer on ``device`` (the canvas drawn there, its DIBs resized and
    composited there).  A DIB of a layout the BMP reader declines is
    skipped, as in the JAX function."""
    if not is_emf(data):
        raise ValueError("EMF: bad header signature")
    (l, t, r, b) = struct.unpack("<4i", data[8:24])          # rclBounds px
    (fl, ft, fr, fb) = struct.unpack("<4i", data[24:40])     # rclFrame .01mm
    # canvas size from the frame at the requested density (emf.c sizing
    # rule); fall back to the device bounds when the frame is degenerate
    if fr > fl and fb > ft:
        width = max(1, int(round((fr - fl) * density / 2540.0)))
        height = max(1, int(round((fb - ft) * density / 2540.0)))
    else:
        width, height = max(r - l + 1, 1), max(b - t + 1, 1)
    # device -> canvas scale (bounds rect maps onto the canvas)
    bw = max(r - l, 1)
    bh = max(b - t, 1)
    csx, csy = width / float(bw + 1), height / float(bh + 1)

    # graphics state
    win_org = [0.0, 0.0]
    win_ext = [1.0, 1.0]
    view_org = [0.0, 0.0]
    view_ext = [1.0, 1.0]
    world = np.eye(3)
    objects: Dict[int, dict] = {}
    pen = {"kind": "pen", "color": "#000000", "width": 1.0, "style": 0}
    brush = {"kind": "brush", "color": None, "style": 1}   # null brush
    font = {"size": 12.0, "name": None}
    text_color = "#000000"
    cur = (0.0, 0.0)
    path: Optional[List[str]] = None     # active BeginPath buffer
    path_start: Optional[Tuple[float, float]] = None
    mvg: List[str] = []
    dibs: List[Tuple[Image, float, float, float, float]] = []

    def to_dev(x: float, y: float) -> Tuple[float, float]:
        wx = world[0, 0] * x + world[0, 1] * y + world[0, 2]
        wy = world[1, 0] * x + world[1, 1] * y + world[1, 2]
        dx = (wx - win_org[0]) * (view_ext[0] / win_ext[0]) + view_org[0]
        dy = (wy - win_org[1]) * (view_ext[1] / win_ext[1]) + view_org[1]
        return ((dx - l) * csx, (dy - t) * csy)

    def sw_dev(w: float) -> float:
        # pen width in logical units -> canvas, via the mean |scale|
        sx = abs(world[0, 0]) * abs(view_ext[0] / win_ext[0]) * csx
        sy = abs(world[1, 1]) * abs(view_ext[1] / win_ext[1]) * csy
        return max(w * 0.5 * (sx + sy), 1.0)

    def style(stroke=True, fill=True) -> str:
        st = pen["color"] if (stroke and pen["style"] != 5) else None
        fl_ = brush["color"] if (fill and brush["style"] != 1) else None
        s = (f"stroke-width {sw_dev(pen['width']):g} "
             f"stroke {st or 'none'} fill {fl_ or 'none'}")
        if st and pen["style"] in (1, 2):        # PS_DASH / PS_DOT
            d = (6 if pen["style"] == 1 else 2) * sw_dev(pen["width"])
            s += f" stroke-dasharray {d:g},{d:g}"
        return s

    def pts_str(pts: List[Tuple[float, float]]) -> str:
        return " ".join(f"{x:g},{y:g}" for x, y in pts)

    def read_pts(buf: bytes, off: int, n: int, wide: bool
                 ) -> List[Tuple[float, float]]:
        out = []
        if wide:
            vals = struct.unpack_from("<%di" % (2 * n), buf, off)
        else:
            vals = struct.unpack_from("<%dh" % (2 * n), buf, off)
        for k in range(n):
            out.append(to_dev(vals[2 * k], vals[2 * k + 1]))
        return out

    def emit(s: str) -> None:
        if path is not None:
            path.append(s)
        else:
            mvg.append(f"push graphic-context {s} pop graphic-context")

    def bezier_path(pts, start=None):
        d = []
        if start is not None:
            d.append(f"M {start[0]:g},{start[1]:g}")
        for k in range(0, len(pts) - 2, 3):
            d.append("C " + " ".join(f"{p[0]:g},{p[1]:g}"
                                     for p in pts[k:k + 3]))
        return " ".join(d)

    pos = struct.unpack("<I", data[4:8])[0]     # header nSize -> 1st record
    n = len(data)
    while pos + 8 <= n:
        rtype, rsize = struct.unpack_from("<II", data, pos)
        if rsize < 8 or pos + rsize > n:
            break
        p = data[pos:pos + rsize]
        pos += rsize
        if rtype == 14:                                   # EMR_EOF
            break
        if rtype == 9:                                    # SetWindowExtEx
            win_ext[0], win_ext[1] = [v or 1 for v in
                                      struct.unpack_from("<2i", p, 8)]
        elif rtype == 10:                                 # SetWindowOrgEx
            win_org[0], win_org[1] = struct.unpack_from("<2i", p, 8)
        elif rtype == 11:                                 # SetViewportExtEx
            view_ext[0], view_ext[1] = [v or 1 for v in
                                        struct.unpack_from("<2i", p, 8)]
        elif rtype == 12:                                 # SetViewportOrgEx
            view_org[0], view_org[1] = struct.unpack_from("<2i", p, 8)
        elif rtype == 35 and rsize >= 32:                 # SetWorldTransform
            m = struct.unpack_from("<6f", p, 8)
            world = np.array([[m[0], m[2], m[4]], [m[1], m[3], m[5]],
                              [0, 0, 1]])
        elif rtype == 36 and rsize >= 36:                 # ModifyWorldTransform
            m = struct.unpack_from("<6f", p, 8)
            mode = struct.unpack_from("<I", p, 32)[0]
            xf = np.array([[m[0], m[2], m[4]], [m[1], m[3], m[5]],
                           [0, 0, 1]])
            if mode == 1:                                 # MWT_IDENTITY
                world = np.eye(3)
            elif mode == 2:                               # MWT_LEFTMULTIPLY
                world = world @ xf
            elif mode == 3:                               # MWT_RIGHTMULTIPLY
                world = xf @ world
            else:                                         # MWT_SET
                world = xf
        elif rtype == 37:                                 # SelectObject
            ih = struct.unpack_from("<I", p, 8)[0]
            if ih & 0x80000000:
                stock = _STOCK.get(ih & 0x7FFFFFFF)
                if stock:
                    kind, color, st = stock
                    if kind == "pen":
                        pen = {"kind": "pen", "color": color or "#000000",
                               "width": 1.0, "style": st}
                    else:
                        brush = {"kind": "brush", "color": color,
                                 "style": st}
            else:
                obj = objects.get(ih)
                if obj:
                    if obj["kind"] == "pen":
                        pen = obj
                    elif obj["kind"] == "brush":
                        brush = obj
                    elif obj["kind"] == "font":
                        font = obj
        elif rtype == 40:                                 # DeleteObject
            objects.pop(struct.unpack_from("<I", p, 8)[0], None)
        elif rtype == 38 and rsize >= 28:                 # CreatePen
            ih, st, wx, _wy, cr = struct.unpack_from("<IIiiI", p, 8)
            objects[ih] = {"kind": "pen", "style": st & 15,
                           "width": max(wx, 1), "color": _cref(cr)}
        elif rtype == 95 and rsize >= 36:                 # ExtCreatePen
            ih = struct.unpack_from("<I", p, 8)[0]
            st, wd, _bs, cr = struct.unpack_from("<IIII", p, 28)
            objects[ih] = {"kind": "pen", "style": st & 15,
                           "width": max(wd, 1), "color": _cref(cr)}
        elif rtype == 39 and rsize >= 24:                 # CreateBrushIndirect
            ih, st, cr, _h = struct.unpack_from("<IIII", p, 8)
            objects[ih] = {"kind": "brush", "style": st,
                           "color": None if st == 1 else _cref(cr)}
        elif rtype == 82 and rsize >= 40:                 # ExtCreateFontIndirectW
            ih = struct.unpack_from("<I", p, 8)[0]
            hgt = struct.unpack_from("<i", p, 12)[0]
            name = p[40:104].decode("utf-16le", "replace").split("\0")[0]
            objects[ih] = {"kind": "font", "size": max(abs(hgt), 1),
                           "name": name or None}
        elif rtype == 24:                                 # SetTextColor
            text_color = _cref(struct.unpack_from("<I", p, 8)[0])
        elif rtype == 27 and rsize >= 16:                 # MoveToEx
            x, y = struct.unpack_from("<2i", p, 8)
            cur = to_dev(x, y)
            if path is not None:
                path_start = cur
                path.append(f"M {cur[0]:g},{cur[1]:g}")
        elif rtype == 54 and rsize >= 16:                 # LineTo
            x, y = struct.unpack_from("<2i", p, 8)
            nxt = to_dev(x, y)
            if path is not None:
                path.append(f"L {nxt[0]:g},{nxt[1]:g}")
            else:
                mvg.append(f"push graphic-context {style(fill=False)} "
                           f"line {cur[0]:g},{cur[1]:g} "
                           f"{nxt[0]:g},{nxt[1]:g} pop graphic-context")
            cur = nxt
        elif rtype in (2, 3, 4, 85, 86, 87) and rsize >= 28:
            # Poly{Bezier,gon,line}{,16}
            wide = rtype in (2, 3, 4)
            cnt = struct.unpack_from("<I", p, 24)[0]
            pts = read_pts(p, 28, cnt, wide)
            if not pts:
                continue
            if rtype in (2, 85):                          # PolyBezier
                d = bezier_path(pts[1:], start=pts[0])
                emit(f"{style(fill=False)} path '{d}'")
            elif rtype in (3, 86):                        # Polygon
                if path is not None:
                    path.append("M " + " L ".join(
                        f"{x:g},{y:g}" for x, y in pts) + " Z")
                else:
                    mvg.append(f"push graphic-context {style()} polygon "
                               f"{pts_str(pts)} pop graphic-context")
            else:                                         # Polyline
                if path is not None:
                    path.append("M " + " L ".join(
                        f"{x:g},{y:g}" for x, y in pts))
                else:
                    mvg.append(f"push graphic-context {style(fill=False)} "
                               f"polyline {pts_str(pts)} "
                               f"pop graphic-context")
            cur = pts[-1]
        elif rtype in (5, 6, 88, 89) and rsize >= 28:     # Poly*To
            wide = rtype in (5, 6)
            cnt = struct.unpack_from("<I", p, 24)[0]
            pts = read_pts(p, 28, cnt, wide)
            if not pts:
                continue
            if rtype in (5, 88):                          # PolyBezierTo
                d = bezier_path(pts, start=cur)
                if path is not None:
                    path.append("C " + " ".join(
                        f"{x:g},{y:g}" for x, y in pts))
                else:
                    mvg.append(f"push graphic-context {style(fill=False)} "
                               f"path '{d}' pop graphic-context")
            else:                                         # PolylineTo
                seg = " L ".join(f"{x:g},{y:g}" for x, y in pts)
                if path is not None:
                    path.append(f"L {seg}")
                else:
                    d = f"M {cur[0]:g},{cur[1]:g} L {seg}"
                    mvg.append(f"push graphic-context {style(fill=False)} "
                               f"path '{d}' pop graphic-context")
            cur = pts[-1]
        elif rtype in (8, 91) and rsize >= 32:            # PolyPolygon{,16}
            wide = rtype == 8
            npolys, _total = struct.unpack_from("<II", p, 24)
            counts = struct.unpack_from("<%dI" % npolys, p, 32)
            off = 32 + 4 * npolys
            for cnt in counts:
                pts = read_pts(p, off, cnt, wide)
                off += (8 if wide else 4) * cnt
                emit(f"{style()} polygon {pts_str(pts)}")
        elif rtype in (7, 90) and rsize >= 32:            # PolyPolyline{,16}
            wide = rtype == 7
            npolys, _total = struct.unpack_from("<II", p, 24)
            counts = struct.unpack_from("<%dI" % npolys, p, 32)
            off = 32 + 4 * npolys
            for cnt in counts:
                pts = read_pts(p, off, cnt, wide)
                off += (8 if wide else 4) * cnt
                emit(f"{style(fill=False)} polyline {pts_str(pts)}")
        elif rtype in (42, 43) and rsize >= 24:           # Ellipse/Rectangle
            x0, y0, x1, y1 = struct.unpack_from("<4i", p, 8)
            (dl, dt), (dr, db) = to_dev(x0, y0), to_dev(x1, y1)
            if rtype == 43:
                emit(f"{style()} rectangle {dl:g},{dt:g} {dr:g},{db:g}")
            else:
                cx, cy = (dl + dr) / 2, (dt + db) / 2
                emit(f"{style()} ellipse {cx:g},{cy:g} "
                     f"{abs(dr - dl) / 2:g},{abs(db - dt) / 2:g} 0,360")
        elif rtype == 44 and rsize >= 32:                 # RoundRect
            x0, y0, x1, y1, cw, ch = struct.unpack_from("<6i", p, 8)
            (dl, dt), (dr, db) = to_dev(x0, y0), to_dev(x1, y1)
            (zx, zy) = to_dev(x0 + cw, y0 + ch)
            emit(f"{style()} roundrectangle {dl:g},{dt:g} {dr:g},{db:g} "
                 f"{abs(zx - dl) / 2:g},{abs(zy - dt) / 2:g}")
        elif rtype == 15 and rsize >= 20:                 # SetPixelV
            x, y = struct.unpack_from("<2i", p, 8)
            cr = struct.unpack_from("<I", p, 16)[0]
            dx, dy = to_dev(x, y)
            mvg.append(f"push graphic-context fill {_cref(cr)} stroke none "
                       f"point {dx:g},{dy:g} pop graphic-context")
        elif rtype == 59:                                 # BeginPath
            path = []
            path_start = cur
        elif rtype == 61 and path is not None:            # CloseFigure
            path.append("Z")
        elif rtype in (62, 63, 64) and path is not None:  # Fill/StrokeAndFill/
            d = " ".join(s for s in path if not s.startswith("push"))
            extra = [s for s in path if s.startswith("push")]
            st = style(stroke=rtype != 62, fill=rtype != 64)
            if d.strip():
                mvg.append(f"push graphic-context {st} path '{d}' "
                           f"pop graphic-context")
            mvg.extend(f"push graphic-context {st} "
                       + s[len("push graphic-context "):]
                       for s in extra)
            path = None
        elif rtype == 60:                                 # EndPath (keep buf)
            pass
        elif rtype in (83, 84) and rsize >= 76:           # ExtTextOutA/W
            rx, ry = struct.unpack_from("<2i", p, 36)     # EMRTEXT ptlRef
            nchars, offstr = struct.unpack_from("<II", p, 44)
            enc = "utf-16le" if rtype == 84 else "latin-1"
            nbytes = nchars * (2 if rtype == 84 else 1)
            if offstr + nbytes <= rsize:
                text = p[offstr:offstr + nbytes].decode(enc, "replace")
                if text.strip():
                    dx, dy = to_dev(rx, ry)
                    fs = max(font["size"] * abs(view_ext[1] / win_ext[1])
                             * csy, 1.0)
                    esc = text.replace("\\", "\\\\").replace("'", "\\'")
                    fname = (f"font '{font['name']}' "
                             if font.get("name") else "")
                    mvg.append(f"push graphic-context fill {text_color} "
                               f"stroke none {fname}font-size {fs:g} "
                               f"text {dx:g},{dy + fs:g} '{esc}' "
                               f"pop graphic-context")
        elif rtype == 81 and rsize >= 80:                 # StretchDIBits
            (xd, yd, _xs, _ys, _cxs, _cys, offbmi, cbbmi, offbits, cbbits,
             _usage, _rop, cxd, cyd) = struct.unpack_from("<6i4I2I2i", p, 24)
            try:
                img = _dib_image(p[offbmi:offbmi + cbbmi],
                                 p[offbits:offbits + cbbits], device)
                (ddx, ddy) = to_dev(xd, yd)
                (dex, dey) = to_dev(xd + cxd, yd + cyd)
                dibs.append((img, ddx, ddy, max(dex - ddx, 1.0),
                             max(dey - ddy, 1.0)))
            except Exception:   # noqa: BLE001 — unsupported DIB layout
                pass
        # other records (clip, modes, blits without DIBs) are no-ops

    from .coders_r4b import render_metafile

    return render_metafile(height, width, mvg, dibs, device)


def _dib_image(bmi: bytes, bits: bytes, device) -> Image:
    """Wrap a headerless DIB (BITMAPINFO + pixel bits) as a BMP blob and
    decode through the normal BMP path onto ``device`` (same trick as the
    WMF coder)."""
    if len(bmi) < 16:
        raise ValueError("no DIB header")
    bisize = struct.unpack("<I", bmi[:4])[0]
    bpp = struct.unpack("<H", bmi[14:16])[0]
    ncolors = struct.unpack("<I", bmi[32:36])[0] if bisize >= 36 else 0
    if ncolors == 0 and bpp <= 8:
        ncolors = 1 << bpp
    dataoff = 14 + bisize + 4 * ncolors
    bmp = (b"BM" + struct.pack("<IHHI", 14 + len(bmi) + len(bits), 0, 0,
                               dataoff) + bmi + bits)
    from . import image_from_blob

    return image_from_blob(bmp, "bmp", device)[0]
