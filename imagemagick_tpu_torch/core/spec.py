"""ImageSpec: static image semantics.

The reference carries a ~200-field mutable ``Image`` struct
(MagickCore/image.h:131-350) whose pixel storage lives in the virtualized
pixel cache.  Here the pixel payload is a dense tensor and everything that
affects *compute semantics* — colorspace, alpha presence,
premultiplication — is a small frozen, hashable dataclass beside it.

A copy of ``imagemagick_tpu/core/spec.py``: pure Python, shared semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Colorspace names mirror the reference enum ColorspaceType
# (MagickCore/colorspace.h:27-68).  Canonical lowercase keys.
COLORSPACES = (
    "undefined",
    "cmy",
    "cmyk",
    "gray",
    "hcl",
    "hclp",
    "hsb",
    "hsi",
    "hsl",
    "hsv",
    "hwb",
    "lab",
    "lch",
    "lchab",
    "lchuv",
    "log",
    "lms",
    "luv",
    "ohta",
    "rec601ycbcr",
    "rec709ycbcr",
    "rgb",        # linear RGB
    "scrgb",      # linear RGB, alias semantics of RGB in the reference
    "srgb",
    "transparent",
    "xyy",
    "xyz",
    "ycbcr",
    "ycc",
    "ydbdr",
    "yiq",
    "ypbpr",
    "yuv",
    "linear_gray",
    "jzazbz",
    "displayp3",
    "adobe98",
    "prophoto",
    "oklab",
    "oklch",
    "cat02lms",
)

# Number of color channels (excluding alpha) implied by a colorspace.
_CMYK_LIKE = {"cmyk"}
_GRAY_LIKE = {"gray", "linear_gray"}


def colorspace_channels(colorspace: str) -> int:
    cs = colorspace.lower()
    if cs in _CMYK_LIKE:
        return 4
    if cs in _GRAY_LIKE:
        return 1
    return 3


def normalize_colorspace(name: str) -> str:
    """Map user-facing colorspace spellings to canonical keys.

    Mirrors the option-table mnemonics for -colorspace
    (MagickCore/option.c, ColorspaceOptions).
    """
    key = name.strip().lower().replace("-", "").replace("_", "")
    aliases = {
        "srgb": "srgb",
        "rgb": "rgb",
        "scrgb": "scrgb",
        "gray": "gray",
        "grey": "gray",
        "lineargray": "linear_gray",
        "lineargrey": "linear_gray",
        "hsb": "hsb",
        "hsv": "hsv",
        "hsl": "hsl",
        "hsi": "hsi",
        "hwb": "hwb",
        "hcl": "hcl",
        "hclp": "hclp",
        "lab": "lab",
        "cielab": "lab",
        "lch": "lchab",
        "lchab": "lchab",
        "lchuv": "lchuv",
        "luv": "luv",
        "log": "log",
        "lms": "lms",
        "cat02lms": "cat02lms",
        "ohta": "ohta",
        "rec601ycbcr": "rec601ycbcr",
        "rec709ycbcr": "rec709ycbcr",
        "xyy": "xyy",
        "xyz": "xyz",
        "ycbcr": "ycbcr",
        "ycc": "ycc",
        "ydbdr": "ydbdr",
        "yiq": "yiq",
        "ypbpr": "ypbpr",
        "yuv": "yuv",
        "cmy": "cmy",
        "cmyk": "cmyk",
        "jzazbz": "jzazbz",
        "oklab": "oklab",
        "oklch": "oklch",
        "displayp3": "displayp3",
        "adobe98": "adobe98",
        "prophoto": "prophoto",
        "prophotorgb": "prophoto",
        "transparent": "transparent",
        "undefined": "undefined",
    }
    if key not in aliases:
        raise ValueError(f"unrecognized colorspace {name!r}")
    return aliases[key]


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """Static semantics of an image tensor.

    Attributes:
      colorspace: canonical colorspace key (see COLORSPACES).
      alpha: whether the trailing channel is an alpha channel.
      premultiplied: whether color channels are premultiplied by alpha
        (the reference's alpha trait blending; composite.c assumes
        non-premultiplied inputs and handles alpha explicitly).
      depth: advisory bit depth for encoders (reference Q16 default).
      meta_channels: number of extra data channels carried AFTER color and
        alpha (the reference's meta-channel tail, pixel.h:27's 64-channel
        map).  Per-pixel ops pass them through untouched; geometry ops
        slice them with the pixel.
    """

    colorspace: str = "srgb"
    alpha: bool = False
    premultiplied: bool = False
    depth: int = 16
    meta_channels: int = 0

    def __post_init__(self):
        cs = self.colorspace.lower()
        if cs not in COLORSPACES:
            raise ValueError(f"unknown colorspace {self.colorspace!r}")
        object.__setattr__(self, "colorspace", cs)

    @property
    def color_channels(self) -> int:
        return colorspace_channels(self.colorspace)

    @property
    def channels(self) -> int:
        return self.color_channels + (1 if self.alpha else 0) + \
            self.meta_channels

    def with_(self, **kw) -> "ImageSpec":
        return dataclasses.replace(self, **kw)

    def astuple(self) -> Tuple:
        return (self.colorspace, self.alpha, self.premultiplied, self.depth,
                self.meta_channels)
