"""Geometry-string parsing with ImageMagick semantics.

A copy of ``imagemagick_tpu/core/geometry.py``: ``parse_geometry``,
``parse_meta_geometry`` (ParseGeometry / ParseMetaGeometry,
MagickCore/geometry.c) and ``parse_page_geometry`` (the crop grammar).
Geometry strings look like ``WxH+X+Y`` with modifier flags:

  %   width/height are percentages of the current size
  ^   minimum-fit: cover the box, may exceed one dimension
  !   exact size, ignore aspect ratio
  <   resize only if the image is smaller than the box (enlarge-only)
  >   resize only if the image is larger than the box (shrink-only)
  @   area in pixels (``WH@`` means total pixel count)
  x   separates width/height (either may be omitted)
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple


@dataclasses.dataclass
class Geometry:
    width: Optional[float] = None
    height: Optional[float] = None
    x: Optional[int] = None
    y: Optional[int] = None
    percent: bool = False
    minimum: bool = False       # ^
    exact: bool = False         # !
    less: bool = False          # <
    greater: bool = False      # >
    area: bool = False          # @
    aspect_offset: bool = False  # leading +/- on width means offset-like


_GEOM_RE = re.compile(
    r"""^\s*
    (?P<w>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)?       # width
    (?:[xX:]
       (?P<h>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)?)?  # height
    (?P<x>[-+][0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)?        # x offset
    (?P<y>[-+][0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)?        # y offset
    \s*$""",
    re.VERBOSE,
)


def parse_geometry(geometry: str, offsets_first: bool = False) -> Geometry:
    """Parse a geometry string into raw numbers + flags.

    Mirrors ParseGeometry (MagickCore/geometry.c) — flags may appear
    anywhere in the string and are stripped before number parsing.

    ``offsets_first=True`` selects the GetGeometry/page grammar where a
    LEADING signed number is an offset ("+5+7" -> x=5, y=7), unlike the
    op-argument grammar where a signed first number is rho
    ("-sigmoidal-contrast -3x50%" -> rho=-3).
    """
    if geometry is None:
        raise ValueError("geometry is None")
    g = Geometry()
    s = str(geometry)
    for flag, attr in (
        ("%", "percent"),
        ("^", "minimum"),
        ("!", "exact"),
        ("<", "less"),
        (">", "greater"),
        ("@", "area"),
    ):
        if flag in s:
            setattr(g, attr, True)
            s = s.replace(flag, "")
    s_stripped = s.strip()
    if offsets_first and s_stripped[:1] in ("+", "-"):
        m = re.match(r"^\s*(?P<x>[-+][0-9]*\.?[0-9]+)"
                     r"(?P<y>[-+][0-9]*\.?[0-9]+)?\s*$", s)
        if m:
            g.x = int(float(m.group("x")))
            if m.group("y") is not None:
                g.y = int(float(m.group("y")))
            return g
    m = _GEOM_RE.match(s)
    if not m:
        raise ValueError(f"invalid geometry {geometry!r}")
    if m.group("w") is not None:
        g.width = float(m.group("w"))
    if m.group("h") is not None:
        g.height = float(m.group("h"))
    if m.group("x") is not None:
        g.x = int(float(m.group("x")))
    if m.group("y") is not None:
        g.y = int(float(m.group("y")))
    return g


def parse_meta_geometry(
    geometry: str, width: int, height: int
) -> Tuple[int, int, int, int]:
    """Resolve a geometry string against current dimensions.

    Returns (new_width, new_height, x_offset, y_offset), mirroring
    ParseMetaGeometry semantics (MagickCore/geometry.c):
    aspect-preserving max-fit by default, with %/^/!/</>/@ modifiers.
    """
    g = parse_geometry(geometry)
    x = g.x or 0
    y = g.y or 0

    if g.percent:
        sw = g.width if g.width is not None else (g.height if g.height is not None else 100.0)
        sh = g.height if g.height is not None else sw
        nw = max(1, int(width * sw / 100.0 + 0.5))
        nh = max(1, int(height * sh / 100.0 + 0.5))
        return nw, nh, x, y

    if g.area:
        # "WH@": W (possibly W*H combined) is a pixel-area target.
        area = (g.width or 0.0) * (g.height if g.height is not None else 1.0)
        if area <= 0:
            return width, height, x, y
        scale = math.sqrt(area / float(width * height))
        if (g.greater and scale >= 1.0) or (g.less and scale <= 1.0):
            return width, height, x, y
        nw = max(1, int(width * scale + 0.5))
        nh = max(1, int(height * scale + 0.5))
        return nw, nh, x, y

    tw = int(g.width) if g.width is not None else None
    th = int(g.height) if g.height is not None else None
    if tw is None and th is None:
        return width, height, x, y
    if tw is None:
        # height-only: preserve aspect
        th = max(1, th)
        tw = max(1, int(width * th / float(height) + 0.5))
        nw, nh = tw, th
    elif th is None:
        tw = max(1, tw)
        th = max(1, int(height * tw / float(width) + 0.5))
        nw, nh = tw, th
    elif g.exact:
        nw, nh = max(1, tw), max(1, th)
    else:
        # Aspect-preserving fit.  Default: maximum size inside the box.
        # '^': minimum size covering the box.
        sx = tw / float(width)
        sy = th / float(height)
        scale = max(sx, sy) if g.minimum else min(sx, sy)
        nw = max(1, int(width * scale + 0.5))
        nh = max(1, int(height * scale + 0.5))

    if g.greater and not (width > nw or height > nh):
        # shrink-only: skip unless current exceeds target
        if width <= nw and height <= nh:
            return width, height, x, y
    if g.greater and (width <= tw and height <= th):
        return width, height, x, y
    if g.less and (width >= tw and height >= th):
        return width, height, x, y
    return nw, nh, x, y


def parse_page_geometry(
    geometry: str, width: int, height: int
) -> Tuple[int, int, int, int]:
    """Crop-style geometry: missing W/H default to the full canvas size."""
    g = parse_geometry(geometry, offsets_first=True)
    x = g.x or 0
    y = g.y or 0
    if g.percent:
        w = max(1, int(width * (g.width if g.width is not None else 100.0)
                       / 100.0 + 0.5))
        h = max(1, int(height * (g.height if g.height is not None else 100.0)
                       / 100.0 + 0.5))
        return w, h, x, y
    w = int(g.width) if g.width is not None else width
    h = int(g.height) if g.height is not None else height
    return max(1, w), max(1, h), x, y
