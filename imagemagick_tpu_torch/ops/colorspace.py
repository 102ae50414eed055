"""Colorspace transforms: the sRGB/linear/gray subset of the port.

Port of ``convert`` from ``imagemagick_tpu/ops/colorspace.py`` (the
reference's TransformImageColorspace, MagickCore/colorspace.c:1751, with
sRGB as the hub: convert(x, a, b) = from_rgb[b](to_rgb[a](x))).  Each
conversion is a function over an ``(..., C)`` float tensor in [0, 1].

This slice ports srgb, gray, linear_gray, rgb and scrgb.  Every other
colorspace of the JAX package raises NotImplementedError until its queue
item ports it; none of them is approximated by another.
"""

from __future__ import annotations

from typing import Dict

import torch

# Rec709 luma coefficients used for gray conversion
# (colorspace.c:886-890 GRAY case, :843 LinearGRAY case).
REC709_LUMA = (0.212656, 0.715158, 0.072186)

# The JAX package's other colorspaces; each waits for its port.
_UNPORTED = frozenset((
    "undefined", "transparent", "xyz", "lab", "lchab", "lch", "luv",
    "lchuv", "xyy", "lms", "cat02lms", "oklab", "oklch", "jzazbz", "hsl",
    "hsv", "hsb", "hwb", "hsi", "hcl", "hclp", "ycbcr", "ypbpr",
    "rec601ycbcr", "rec709ycbcr", "yiq", "yuv", "ydbdr", "ycc", "ohta", "cmy",
    "cmyk", "log", "adobe98", "displayp3", "prophoto"))


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded -> linear, on [0,1] values."""
    p = torch.pow(torch.clamp((v + 0.055) / 1.055, min=1e-12), 2.4)
    return torch.where(v <= 0.0404482362771076, v / 12.92, p)


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """linear -> sRGB-encoded, on [0,1] values."""
    p = torch.pow(torch.clamp(v, min=1e-12), 1.0 / 2.4)
    return torch.where(v <= 0.0031306684425005883, 12.92 * v,
                       1.055 * p - 0.055)


def _luma(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = REC709_LUMA[0] * r + REC709_LUMA[1] * g + REC709_LUMA[2] * b
    return y[..., None]


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> GRAY: Rec709 luma on *encoded* values (colorspace.c:901)."""
    return _luma(x)


def rgb_to_linear_gray(x: torch.Tensor) -> torch.Tensor:
    """sRGB -> LinearGRAY: Rec709 luma on *linear* values (colorspace.c:843)."""
    return _luma(srgb_to_linear(x))


def gray_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(3, dim=-1)


def linear_gray_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return linear_to_srgb(x).repeat_interleave(3, dim=-1)


def _identity(x):
    return x


# colorspace key -> (to_srgb, from_srgb) over color channels only.
_CONVERTERS: Dict[str, tuple] = {
    "srgb": (_identity, _identity),
    "rgb": (linear_to_srgb, srgb_to_linear),
    "scrgb": (linear_to_srgb, srgb_to_linear),
    "gray": (gray_to_rgb, rgb_to_gray),
    "linear_gray": (linear_gray_to_rgb, rgb_to_linear_gray),
}


def supported_colorspaces():
    return sorted(_CONVERTERS)


def _converter(key: str, role: str) -> tuple:
    if key in _CONVERTERS:
        return _CONVERTERS[key]
    if key in _UNPORTED:
        raise NotImplementedError(
            f"colorspace {key!r} is not ported yet (ROADMAP.md Queue 1: "
            f"'ops/colorspace.py, the other colorspaces')")
    raise ValueError(f"unsupported {role} colorspace {key!r}")


def convert(color: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert color channels (no alpha) between colorspaces via the sRGB hub.

    Mirrors TransformImageColorspace (MagickCore/colorspace.c:1751):
    source -> sRGB -> target.  Values may leave [0, 1] (HDRI semantics);
    only encoders clamp.
    """
    src, dst = src.lower(), dst.lower()
    if src == dst:
        return color
    to_rgb_fn = _converter(src, "source")[0]
    from_rgb_fn = _converter(dst, "target")[1]
    return from_rgb_fn(to_rgb_fn(color))
