"""Colorspace transforms: the sRGB/linear/gray/XYZ/Lab subset of the port.

Port of ``convert`` from ``imagemagick_tpu/ops/colorspace.py`` (the
reference's TransformImageColorspace, MagickCore/colorspace.c:1751, with
sRGB as the hub: convert(x, a, b) = from_rgb[b](to_rgb[a](x))).  Each
conversion is a function over an ``(..., C)`` float tensor in [0, 1].

This slice ports srgb, gray, linear_gray, rgb, scrgb, xyz and lab.  Every
other colorspace of the JAX package raises NotImplementedError until its
queue item ports it; none of them is approximated by another.  The sRGB
transfer is ``torch.pow``: the JAX package's split-exponent exp2/log2
forms are a TPU workaround.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Rec709 luma coefficients used for gray conversion
# (colorspace.c:886-890 GRAY case, :843 LinearGRAY case).
REC709_LUMA = (0.212656, 0.715158, 0.072186)

# CIE constants (colorspace-private.h:29-30).
CIE_EPSILON = 216.0 / 24389.0
CIE_K = 24389.0 / 27.0

# D65 illuminant tristimulus (colorspace-private.h:40, entry D65).
D65 = (0.95047, 1.00000, 1.08883)

# The JAX package's other colorspaces; each waits for its port.
_UNPORTED = frozenset((
    "undefined", "transparent", "lchab", "lch", "luv",
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


def _mat3(x: torch.Tensor, M) -> torch.Tensor:
    """3x3 color transform y_d = sum_c M[d, c] x_c in the input's dtype,
    summed in the JAX package's order (M is a host-side (3, 3) array)."""
    M = np.asarray(M, np.float64)
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([M[d, 0] * c0 + M[d, 1] * c1 + M[d, 2] * c2
                        for d in range(3)], dim=-1)


# XYZ hub (D65, sRGB primaries, colorspace-private.h:759-780 / :72-94),
# rounded to float32 as the JAX package holds them.
_RGB2XYZ = np.array([
    [0.4123955889674142161, 0.3575834307637148171, 0.1804926473817015735],
    [0.2125862307855955516, 0.7151703037034108499, 0.07220049864333622685],
    [0.01929721549174694484, 0.1191838645808485318, 0.9504971251315797660],
], np.float32)

_XYZ2RGB = np.array([
    [3.240969941904521, -1.537383177570093, -0.498610760293],
    [-0.96924363628087, 1.87596750150772, 0.041555057407175],
    [0.055630079696993, -0.20397695888897, 1.056971514242878],
], np.float32)


def rgb_to_xyz(x: torch.Tensor) -> torch.Tensor:
    return _mat3(srgb_to_linear(x), _RGB2XYZ)


def xyz_to_rgb(x: torch.Tensor) -> torch.Tensor:
    rgb = _mat3(x, _XYZ2RGB)
    # The reference lifts out-of-gamut negatives before encoding
    # (colorspace-private.h:84-90).
    mn = rgb.amin(dim=-1, keepdim=True)
    rgb = torch.where(mn < 0.0, rgb - mn, rgb)
    return linear_to_srgb(rgb)


# CIE Lab (colorspace-private.h:531-570, :1066-1103)
def xyz_to_lab_raw(x: torch.Tensor, wp=D65) -> torch.Tensor:
    def f(t, w):
        r = t / w
        # torch has no cbrt: a cube root through pow, on r > eps only
        return torch.where(r > CIE_EPSILON,
                           torch.pow(r.clamp(min=0.0), 1.0 / 3.0),
                           (CIE_K * r + 16.0) / 116.0)

    fx, fy, fz = (f(x[..., i], wp[i]) for i in range(3))
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def lab_raw_to_xyz(lab: torch.Tensor, wp=D65) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = (L + 16.0) / 116.0
    x = y + a / 500.0
    z = y - b / 200.0
    x3, z3 = x * x * x, z * z * z
    X = torch.where(x3 > CIE_EPSILON, x3, (116.0 * x - 16.0) / CIE_K)
    Y = torch.where(L > CIE_K * CIE_EPSILON, y * y * y, L / CIE_K)
    Z = torch.where(z3 > CIE_EPSILON, z3, (116.0 * z - 16.0) / CIE_K)
    return torch.stack([X * wp[0], Y * wp[1], Z * wp[2]], dim=-1)


def rgb_to_lab(x: torch.Tensor) -> torch.Tensor:
    lab = xyz_to_lab_raw(rgb_to_xyz(x))
    return torch.stack([lab[..., 0] / 100.0, lab[..., 1] / 255.0 + 0.5,
                        lab[..., 2] / 255.0 + 0.5], dim=-1)


def lab_to_rgb(x: torch.Tensor) -> torch.Tensor:
    raw = torch.stack([100.0 * x[..., 0], 255.0 * (x[..., 1] - 0.5),
                       255.0 * (x[..., 2] - 0.5)], dim=-1)
    return xyz_to_rgb(lab_raw_to_xyz(raw))


# colorspace key -> (to_srgb, from_srgb) over color channels only.
_CONVERTERS: Dict[str, tuple] = {
    "srgb": (_identity, _identity),
    "rgb": (linear_to_srgb, srgb_to_linear),
    "scrgb": (linear_to_srgb, srgb_to_linear),
    "gray": (gray_to_rgb, rgb_to_gray),
    "linear_gray": (linear_gray_to_rgb, rgb_to_linear_gray),
    "xyz": (xyz_to_rgb, rgb_to_xyz),
    "lab": (lab_to_rgb, rgb_to_lab),
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
