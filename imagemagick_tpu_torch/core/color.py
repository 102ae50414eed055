"""Color-string parsing and the named-color database.

Port of ``imagemagick_tpu/core/color.py``, copied: the behavior of
ImageMagick's MagickCore/color.c (named colors from config/colors.xml):
``#RGB[A]`` hex in 4/8/16-bit per channel widths,
``rgb()/rgba()/hsl()/hsla()/gray()/cmyk()`` functional syntax, and named
colors (W3C/X11 set + ImageMagick extras like ``opaque``).  Returns float
RGBA in [0,1] (sRGB); host code only.
"""

from __future__ import annotations

import re
from typing import Tuple

RGBA = Tuple[float, float, float, float]

# W3C CSS3 + X11 names as shipped in the reference's colors.xml
# (spot-values verified against config/colors.xml).
_NAMED = {
    "aliceblue": "#F0F8FF", "antiquewhite": "#FAEBD7", "aqua": "#00FFFF",
    "aquamarine": "#7FFFD4", "azure": "#F0FFFF", "beige": "#F5F5DC",
    "bisque": "#FFE4C4", "black": "#000000", "blanchedalmond": "#FFEBCD",
    "blue": "#0000FF", "blueviolet": "#8A2BE2", "brown": "#A52A2A",
    "burlywood": "#DEB887", "cadetblue": "#5F9EA0", "chartreuse": "#7FFF00",
    "chocolate": "#D2691E", "coral": "#FF7F50", "cornflowerblue": "#6495ED",
    "cornsilk": "#FFF8DC", "crimson": "#DC143C", "cyan": "#00FFFF",
    "darkblue": "#00008B", "darkcyan": "#008B8B", "darkgoldenrod": "#B8860B",
    "darkgray": "#A9A9A9", "darkgreen": "#006400", "darkgrey": "#A9A9A9",
    "darkkhaki": "#BDB76B", "darkmagenta": "#8B008B", "darkolivegreen": "#556B2F",
    "darkorange": "#FF8C00", "darkorchid": "#9932CC", "darkred": "#8B0000",
    "darksalmon": "#E9967A", "darkseagreen": "#8FBC8F", "darkslateblue": "#483D8B",
    "darkslategray": "#2F4F4F", "darkslategrey": "#2F4F4F", "darkturquoise": "#00CED1",
    "darkviolet": "#9400D3", "deeppink": "#FF1493", "deepskyblue": "#00BFFF",
    "dimgray": "#696969", "dimgrey": "#696969", "dodgerblue": "#1E90FF",
    "firebrick": "#B22222", "floralwhite": "#FFFAF0", "forestgreen": "#228B22",
    "fuchsia": "#FF00FF", "gainsboro": "#DCDCDC", "ghostwhite": "#F8F8FF",
    "gold": "#FFD700", "goldenrod": "#DAA520", "gray": "#7E7E7E",
    "grey": "#7E7E7E", "green": "#008000", "greenyellow": "#ADFF2F",
    "honeydew": "#F0FFF0", "hotpink": "#FF69B4", "indianred": "#CD5C5C",
    "indigo": "#4B0082", "ivory": "#FFFFF0", "khaki": "#F0E68C",
    "lavender": "#E6E6FA", "lavenderblush": "#FFF0F5", "lawngreen": "#7CFC00",
    "lemonchiffon": "#FFFACD", "lightblue": "#ADD8E6", "lightcoral": "#F08080",
    "lightcyan": "#E0FFFF", "lightgoldenrodyellow": "#FAFAD2", "lightgray": "#D3D3D3",
    "lightgreen": "#90EE90", "lightgrey": "#D3D3D3", "lightpink": "#FFB6C1",
    "lightsalmon": "#FFA07A", "lightseagreen": "#20B2AA", "lightskyblue": "#87CEFA",
    "lightslategray": "#778899", "lightslategrey": "#778899", "lightsteelblue": "#B0C4DE",
    "lightyellow": "#FFFFE0", "lime": "#00FF00", "limegreen": "#32CD32",
    "linen": "#FAF0E6", "magenta": "#FF00FF", "maroon": "#800000",
    "mediumaquamarine": "#66CDAA", "mediumblue": "#0000CD", "mediumorchid": "#BA55D3",
    "mediumpurple": "#9370DB", "mediumseagreen": "#3CB371", "mediumslateblue": "#7B68EE",
    "mediumspringgreen": "#00FA9A", "mediumturquoise": "#48D1CC",
    "mediumvioletred": "#C71585", "midnightblue": "#191970", "mintcream": "#F5FFFA",
    "mistyrose": "#FFE4E1", "moccasin": "#FFE4B5", "navajowhite": "#FFDEAD",
    "navy": "#000080", "oldlace": "#FDF5E6", "olive": "#808000",
    "olivedrab": "#6B8E23", "orange": "#FFA500", "orangered": "#FF4500",
    "orchid": "#DA70D6", "palegoldenrod": "#EEE8AA", "palegreen": "#98FB98",
    "paleturquoise": "#AFEEEE", "palevioletred": "#DB7093", "papayawhip": "#FFEFD5",
    "peachpuff": "#FFDAB9", "peru": "#CD853F", "pink": "#FFC0CB",
    "plum": "#DDA0DD", "powderblue": "#B0E0E6", "purple": "#800080",
    "rebeccapurple": "#663399", "red": "#FF0000", "rosybrown": "#BC8F8F",
    "royalblue": "#4169E1", "saddlebrown": "#8B4513", "salmon": "#FA8072",
    "sandybrown": "#F4A460", "seagreen": "#2E8B57", "seashell": "#FFF5EE",
    "sienna": "#A0522D", "silver": "#C0C0C0", "skyblue": "#87CEEB",
    "slateblue": "#6A5ACD", "slategray": "#708090", "slategrey": "#708090",
    "snow": "#FFFAFA", "springgreen": "#00FF7F", "steelblue": "#4682B4",
    "tan": "#D2B48C", "teal": "#008080", "thistle": "#D8BFD8",
    "tomato": "#FF6347", "turquoise": "#40E0D0", "violet": "#EE82EE",
    "wheat": "#F5DEB3", "white": "#FFFFFF", "whitesmoke": "#F5F5F5",
    "yellow": "#FFFF00", "yellowgreen": "#9ACD32",
    # ImageMagick specials (color.c Colormap[] extras)
    "matte": "#BDBDBD", "opaque": "#000000", "freeze": "#0000BD",
}

_TRANSPARENT = ("none", "transparent", "matte")


def _hex_component(s: str) -> float:
    return int(s, 16) / float(16 ** len(s) - 1)


def parse_color(name: str, default_alpha: float = 1.0) -> RGBA:
    """Parse a color string to (r, g, b, a) floats in [0,1]."""
    if name is None:
        raise ValueError("color is None")
    s = str(name).strip().lower()
    if s in _TRANSPARENT:
        return (0.0, 0.0, 0.0, 0.0)
    if s.startswith("#"):
        hexs = s[1:]
        if len(hexs) in (3, 4, 6, 8, 12, 16):
            n = 4 if len(hexs) in (4, 8, 16) else 3
            width = len(hexs) // n
            comps = [_hex_component(hexs[i * width:(i + 1) * width]) for i in range(n)]
            if n == 3:
                return (comps[0], comps[1], comps[2], default_alpha)
            return tuple(comps)  # type: ignore
        raise ValueError(f"bad hex color {name!r}")
    m = re.match(r"(srgba?|rgba?|hsla?|hsba?|hsva?|gray|graya|cmyka?)"
                 r"\s*\(([^)]*)\)", s)
    if m:
        fn, body = m.group(1), m.group(2)
        if fn.startswith("srgb"):          # sRGB(...) == rgb(...) (color.c)
            fn = "rgb" + fn[4:]
        if fn.startswith("hsv"):           # hsv() == hsb()
            fn = "hsb" + fn[3:]
        parts = [p.strip() for p in re.split(r"[,/\s]+", body) if p.strip()]

        def num(p, scale=255.0):
            if p.endswith("%"):
                return float(p[:-1]) / 100.0
            return float(p) / scale

        if fn in ("rgb", "rgba"):
            r, g, b = num(parts[0]), num(parts[1]), num(parts[2])
            a = float(parts[3]) if len(parts) > 3 else default_alpha
            a = a / 1.0 if a <= 1.0 else a / 255.0
            return (min(r, 1.0), min(g, 1.0), min(b, 1.0), min(a, 1.0))
        if fn in ("hsl", "hsla", "hsb", "hsba"):
            h = float(parts[0].rstrip("%")) / 360.0
            sat = num(parts[1], 100.0)
            lig = num(parts[2], 100.0)
            a = float(parts[3]) if len(parts) > 3 else default_alpha
            if fn.startswith("hsl"):
                r, g, b = _hsl_to_rgb(h, sat, lig)
            else:
                r, g, b = _hsv_to_rgb(h, sat, lig)
            return (r, g, b, min(a, 1.0))
        if fn in ("gray", "graya"):
            g = num(parts[0])
            a = float(parts[1]) if len(parts) > 1 else default_alpha
            return (g, g, g, min(a, 1.0))
        if fn in ("cmyk", "cmyka"):
            c, mg, y, k = (num(p, 1.0 if "." in p or p.endswith("%") else 255.0)
                           for p in parts[:4])
            a = float(parts[4]) if len(parts) > 4 else default_alpha
            r = (1.0 - c) * (1.0 - k)
            g = (1.0 - mg) * (1.0 - k)
            b = (1.0 - y) * (1.0 - k)
            return (r, g, b, min(a, 1.0))
    base = s
    alpha = default_alpha
    if base in _NAMED:
        r, g, b, _ = parse_color(_NAMED[base])
        return (r, g, b, alpha)
    # grayNN names (color.c gray0..gray100)
    m = re.match(r"^(gray|grey)(\d{1,3})$", base)
    if m:
        v = min(int(m.group(2)), 100) / 100.0
        return (v, v, v, alpha)
    raise ValueError(f"unrecognized color {name!r}")


def _hsl_to_rgb(h, s, l):
    c = (1.0 - abs(2.0 * l - 1.0)) * s
    h6 = (h % 1.0) * 6.0
    x = c * (1.0 - abs(h6 % 2.0 - 1.0))
    m = l - c / 2.0
    sext = int(h6) % 6
    table = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)]
    r, g, b = table[sext]
    return (r + m, g + m, b + m)


def _hsv_to_rgb(h, s, v):
    c = v * s
    h6 = (h % 1.0) * 6.0
    x = c * (1.0 - abs(h6 % 2.0 - 1.0))
    m = v - c
    sext = int(h6) % 6
    table = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)]
    r, g, b = table[sext]
    return (r + m, g + m, b + m)


def color_names():
    return sorted(_NAMED)
