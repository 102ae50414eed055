"""Colorspace transforms: the 41 colorspace keys as per-pixel math.

Port of ``imagemagick_tpu/ops/colorspace.py`` (the reference's
TransformImageColorspace, MagickCore/colorspace.c:1751, with sRGB as the
hub: convert(x, a, b) = from_rgb[b](to_rgb[a](x)); the scalar converters
of colorspace-private.h).  Each conversion is a function over an
``(..., C)`` float tensor in [0, 1] on any device.

Conventions (the reference's): arrays are sRGB-encoded unless the
colorspace says otherwise; hue-like channels are stored scaled to [0, 1];
Lab is L*/100, a*/255+0.5, b*/255+0.5; Luv is L/100, (u+134)/354,
(v+140)/262; the chroma channels of the YCbCr family are offset by +0.5.
Branchy scalar code (hue sextants, CIE piecewise curves) becomes
``torch.where`` selects.

The sRGB transfer and the PQ curve of Jzazbz are ``torch.pow``, and a
cube root is ``torch.pow`` of the magnitude by 1/3: the JAX package's
split-exponent exp2/log2 forms are a TPU workaround.  The PhotoYCC decode
ramp is the port's own copy of the table (``_ycc_map.py``).
"""

from __future__ import annotations

import math
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

REC601_LUMA = (0.298839, 0.586811, 0.114350)

# Default absolute white luminance for Jzazbz (colorspace.c:991).
WHITE_LUMINANCE = 10000.0

_EPS = 1e-15


def _prec(x: torch.Tensor) -> torch.Tensor:
    """PerceptibleReciprocal: sign-preserving 1/x that avoids divide-by-0."""
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = x.abs()
    return sign / torch.where(ax < _EPS, _EPS, ax)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt): sign times |x|^(1/3)."""
    return torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)


def _split(x: torch.Tensor):
    return x[..., 0], x[..., 1], x[..., 2]


def _join(a, b, c) -> torch.Tensor:
    return torch.stack([a, b, c], dim=-1)


def _select(conds, values, default):
    """jnp.select: the value of the first true condition, else default."""
    out = default
    for cond, val in zip(reversed(conds), reversed(values)):
        out = torch.where(cond, val, out)
    return out


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


def _matrix_space(to_xyz_mat, from_xyz_mat):
    """Gamma-encoded RGB working space defined by primaries matrices."""

    def from_rgb(x):
        return linear_to_srgb(_mat3(rgb_to_xyz(x), from_xyz_mat))

    def to_rgb(x):
        return xyz_to_rgb(_mat3(srgb_to_linear(x), to_xyz_mat))

    return to_rgb, from_rgb


# Adobe RGB (1998) (colorspace-private.h:53-70, :938-952)
_ADOBE98_TO_XYZ = [
    [0.57666904291013050, 0.18555823790654630, 0.18822864623499470],
    [0.29734497525053605, 0.62736356625546610, 0.07529145849399788],
    [0.02703136138641234, 0.07068885253582723, 0.99133753683763880],
]
_XYZ_TO_ADOBE98 = [
    [2.041587903810746500, -0.56500697427885960, -0.34473135077832956],
    [-0.969243636280879500, 1.87596750150772020, 0.04155505740717557],
    [0.013444280632031142, -0.11836239223101838, 1.01517499439120540],
]

# Display P3 (colorspace-private.h:675-693, :966-980)
_P3_TO_XYZ = [
    [0.4865709486482162, 0.26566769316909306, 0.1982172852343625],
    [0.2289745640697488, 0.69173852183650640, 0.0792869140937450],
    [0.0000000000000000, 0.04511338185890264, 1.0439443689009760],
]
_XYZ_TO_P3 = [
    [2.49349691194142500, -0.93138361791912390, -0.402710784450716840],
    [-0.82948896956157470, 1.76266406031834630, 0.023624685841943577],
    [0.03584583024378447, -0.07617238926804182, 0.956884524007687200],
]

# ProPhoto (colorspace-private.h:719-738, :1197-1211).  The reference
# assigns *X twice; the effective matrix is the second one.
_PROPHOTO_TO_XYZ = [
    [0.7977604896723027, 0.13518583717574031, 0.03134934958152480000],
    [0.2880711282292934, 0.71184321781010140, 0.00008565396060525902],
    [0.0000000000000000, 0.00000000000000000, 0.82510460251046010000],
]
_XYZ_TO_PROPHOTO = [
    [1.3457989731028281, -0.25558010007997534, -0.05110628506753401],
    [-0.5446224939028347, 1.50823274131327810, 0.02053603239147973],
    [0.0000000000000000, 0.0000000000000000, 1.21196754563894540],
]

# CAT02 LMS (colorspace-private.h:751-757, :108-117)
_XYZ_TO_LMS = [
    [0.7328, 0.4296, -0.1624],
    [-0.7036, 1.6975, 0.0061],
    [0.0030, 0.0136, 0.9834],
]
_LMS_TO_XYZ = [
    [1.096123820835514, -0.278869000218287, 0.182745179382773],
    [0.454369041975359, 0.473533154307412, 0.072097803717229],
    [-0.009627608738429, -0.005698031216113, 1.015325639954543],
]


def _lms_from_rgb(x):
    return _mat3(rgb_to_xyz(x), _XYZ_TO_LMS)


def _lms_to_rgb(x):
    return xyz_to_rgb(_mat3(x, _LMS_TO_XYZ))


# -- CIE LCHab / Luv / LCHuv / xyY (colorspace-private.h:531-626,
# :1104-1195) -----------------------------------------------------------

def rgb_to_lchab(x):
    L, a, b = _split(xyz_to_lab_raw(rgb_to_xyz(x)))
    # the reference scales a, b first (ConvertXYZToLCHab,
    # colorspace-private.h:1104: chroma = hypot(a', b') + 0.5)
    a_s, b_s = a / 255.0, b / 255.0
    C = torch.hypot(a_s, b_s) + 0.5
    H = torch.atan2(b_s, a_s) / (2.0 * math.pi)
    H = torch.where(H < 0.0, H + 1.0, H)
    return _join(L / 100.0, C, H)


def lchab_to_rgb(x):
    L, C, H = _split(x)
    hr = 2.0 * math.pi * H
    a = 255.0 * (C - 0.5) * torch.cos(hr)
    b = 255.0 * (C - 0.5) * torch.sin(hr)
    return xyz_to_rgb(lab_raw_to_xyz(_join(100.0 * L, a, b)))


def _luv_consts(wp=D65):
    d = wp[0] + 15.0 * wp[1] + 3.0 * wp[2]
    return 4.0 * wp[0] / d, 9.0 * wp[1] / d


def xyz_to_luv_raw(x, wp=D65):
    X, Y, Z = _split(x)
    un, vn = _luv_consts(wp)
    r = Y / wp[1]
    L = torch.where(r > CIE_EPSILON, 116.0 * _cbrt(r.clamp(min=0.0)) - 16.0,
                    CIE_K * r)
    alpha = _prec(X + 15.0 * Y + 3.0 * Z)
    u = 13.0 * L * (4.0 * alpha * X - un)
    v = 13.0 * L * (9.0 * alpha * Y - vn)
    return _join(L, u, v)


def luv_raw_to_xyz(luv, wp=D65):
    L, u, v = _split(luv)
    un, vn = _luv_consts(wp)
    Y = torch.where(L > CIE_K * CIE_EPSILON,
                    torch.pow((L + 16.0) / 116.0, 3.0), L / CIE_K)
    # ConvertLuvToXYZ (colorspace-private.h:600-626)
    t_u = 52.0 * L * _prec(u + 13.0 * L * un)
    t_v = 39.0 * L * _prec(v + 13.0 * L * vn)
    gamma = _prec((t_u - 1.0) / 3.0 + 1.0 / 3.0)
    X = gamma * (Y * (t_v - 5.0) + 5.0 * Y)
    Z = X * ((t_u - 1.0) / 3.0) - 5.0 * Y
    return _join(X, Y, Z)


def rgb_to_luv(x):
    L, u, v = _split(xyz_to_luv_raw(rgb_to_xyz(x)))
    return _join(L / 100.0, (u + 134.0) / 354.0, (v + 140.0) / 262.0)


def luv_to_rgb(x):
    L, u, v = _split(x)
    return xyz_to_rgb(luv_raw_to_xyz(
        _join(100.0 * L, 354.0 * u - 134.0, 262.0 * v - 140.0)))


def rgb_to_lchuv(x):
    L, u, v = _split(xyz_to_luv_raw(rgb_to_xyz(x)))
    C = torch.hypot(u, v) / 255.0 + 0.5
    H = torch.atan2(v, u) / (2.0 * math.pi)
    H = torch.where(H < 0.0, H + 1.0, H)
    return _join(L / 100.0, C, H)


def lchuv_to_rgb(x):
    L, C, H = _split(x)
    hr = 2.0 * math.pi * H
    u = 255.0 * (C - 0.5) * torch.cos(hr)
    v = 255.0 * (C - 0.5) * torch.sin(hr)
    return xyz_to_rgb(luv_raw_to_xyz(_join(100.0 * L, u, v)))


def rgb_to_xyy(x):
    X, Y, Z = _split(rgb_to_xyz(x))
    g = _prec(X + Y + Z)
    return _join(g * X, g * Y, Y)


def xyy_to_rgb(x):
    lx, ly, Y = _split(x)
    g = _prec(ly)
    return xyz_to_rgb(_join(g * Y * lx, Y, g * Y * (1.0 - lx - ly)))


# -- OkLab / OkLch (colorspace-private.h:1480-1550) ----------------------

def rgb_to_oklab(x):
    R, G, B = _split(srgb_to_linear(x))
    l = _cbrt(0.4122214708 * R + 0.5363325363 * G + 0.0514459929 * B)
    m = _cbrt(0.2119034982 * R + 0.6806995451 * G + 0.1073969566 * B)
    s = _cbrt(0.0883024619 * R + 0.2817188376 * G + 0.6299787005 * B)
    L = 0.2104542553 * l + 0.7936177850 * m - 0.0040720468 * s
    a = 1.9779984951 * l - 2.4285922050 * m + 0.4505937099 * s + 0.5
    b = 0.0259040371 * l + 0.7827717662 * m - 0.8086757660 * s + 0.5
    return _join(L, a, b)


def oklab_to_rgb(x):
    L, a, b = _split(x)
    l = L + 0.3963377774 * (a - 0.5) + 0.2158037573 * (b - 0.5)
    m = L - 0.1055613458 * (a - 0.5) - 0.0638541728 * (b - 0.5)
    s = L - 0.0894841775 * (a - 0.5) - 1.2914855480 * (b - 0.5)
    l, m, s = l * l * l, m * m * m, s * s * s
    R = 4.0767416621 * l - 3.3077115913 * m + 0.2309699292 * s
    G = -1.2684380046 * l + 2.6097574011 * m - 0.3413193965 * s
    B = -0.0041960863 * l - 0.7034186147 * m + 1.7076147010 * s
    return linear_to_srgb(_join(R, G, B))


def rgb_to_oklch(x):
    L, a, b = _split(rgb_to_oklab(x))
    C = torch.sqrt(((a - 0.5) ** 2 + (b - 0.5) ** 2).double()).float()
    h = 0.5 + 0.5 * torch.atan2(-(b - 0.5), -(a - 0.5)) / math.pi
    return _join(L, C, h)


def oklch_to_rgb(x):
    L, C, h = _split(x)
    a = C * torch.cos(2.0 * math.pi * h) + 0.5
    b = C * torch.sin(2.0 * math.pi * h) + 0.5
    return oklab_to_rgb(_join(L, a, b))


# -- Jzazbz (colorspace-private.h:1274-1478).  The reference passes RGB
# with green and blue swapped both ways (ConvertRGBToJzazbz at :1365
# calls ConvertRGBToXYZ(red, blue, green, ...)); kept for parity. --------

_JZ = dict(
    b=1.15, g=0.66,
    c1=3424.0 / 4096.0, c2=2413.0 / 128.0, c3=2392.0 / 128.0,
    n=2610.0 / 16384.0, p=1.7 * 2523.0 / 32.0, d=-0.56,
    d0=1.6295499532821566e-11,
)
_JZ_XYZ2LMS = [
    [0.41478972, 0.579999, 0.0146480],
    [-0.2015100, 1.120649, 0.0531008],
    [-0.0166008, 0.264800, 0.6684799],
]
_JZ_AB = [
    [3.52400, -4.066708, 0.542708],
    [0.199076, 1.096799, -1.295875],
]
_JZ_LMS2XYZ = [
    [1.92422643578761, -1.00479231259537, 0.037651404030618],
    [0.350316762094999, 0.726481193931655, -0.065384422948085],
    [-0.0909828109828476, -0.312728290523074, 1.52276656130526],
]


def _pq_fwd(v):
    g = torch.pow((v / WHITE_LUMINANCE).clamp(min=0.0), _JZ["n"])
    return torch.pow((_JZ["c1"] + _JZ["c2"] * g) / (1.0 + _JZ["c3"] * g),
                     _JZ["p"])


def _pq_inv(v):
    g = torch.pow(v.clamp(min=0.0), 1.0 / _JZ["p"])
    num = g - _JZ["c1"]
    den = _JZ["c2"] - _JZ["c3"] * g
    return WHITE_LUMINANCE * torch.pow((num / den).clamp(min=0.0),
                                       1.0 / _JZ["n"])


def rgb_to_jzazbz(x):
    R, G, B = _split(x)
    X, Y, Z = _split(rgb_to_xyz(_join(R, B, G)))   # the reference's swap
    Xp = Z + _JZ["b"] * (X - Z)
    Yp = X + _JZ["g"] * (Y - X)
    M = _JZ_XYZ2LMS
    L = M[0][0] * Xp + M[0][1] * Yp + M[0][2] * Z
    Mm = M[1][0] * Xp + M[1][1] * Yp + M[1][2] * Z
    S = M[2][0] * Xp + M[2][1] * Yp + M[2][2] * Z
    Lp, Mp, Sp = _pq_fwd(L), _pq_fwd(Mm), _pq_fwd(S)
    Iz = 0.5 * (Lp + Mp)
    J = (Iz + _JZ["d"] * Iz) / (1.0 + _JZ["d"] * Iz) - _JZ["d0"]
    A = _JZ_AB
    a = 0.5 + A[0][0] * Lp + A[0][1] * Mp + A[0][2] * Sp
    b = 0.5 + A[1][0] * Lp + A[1][1] * Mp + A[1][2] * Sp
    J = torch.nan_to_num(J, nan=0.0)
    a = torch.where(torch.isnan(a), 0.5, a)
    b = torch.where(torch.isnan(b), 0.5, b)
    return _join(J, a, b)


def jzazbz_to_rgb(x):
    Jz, az, bz = _split(x)
    g = Jz + _JZ["d0"]
    azz, bzz = az - 0.5, bz - 0.5
    C = 0.138605043271539 * azz + 0.0580473161561189 * bzz
    Sp = g / (1.0 + _JZ["d"] * (1.0 - g))
    Lp = Sp + C
    Mp = Sp - C
    Sp = Sp + (-0.0960192420263189) * azz + (-0.811891896056039) * bzz
    L, M, S = _pq_inv(Lp), _pq_inv(Mp), _pq_inv(Sp)
    T = _JZ_LMS2XYZ
    Xp = T[0][0] * L + T[0][1] * M + T[0][2] * S
    Yp = T[1][0] * L + T[1][1] * M + T[1][2] * S
    Zp = T[2][0] * L + T[2][1] * M + T[2][2] * S
    Zp = torch.nan_to_num(Zp, nan=0.0)
    Xp = torch.nan_to_num(Zp + (Xp - Zp) / _JZ["b"], nan=0.0)
    Yp = torch.nan_to_num(Xp + (Yp - Xp) / _JZ["g"], nan=0.0)
    R, B, G = _split(xyz_to_rgb(_join(Xp, Yp, Zp)))   # the swap back
    return _join(R, G, B)


# -- Hue spaces (colorspace-private.h:149-530, :801-1065; HSL in
# colorspace.c:307/:597) ------------------------------------------------

def _max_min_chroma(x):
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    return mx, mn, mx - mn


def _hue_sextant(x, mx, c):
    """The hue of each pixel in [0, 6)."""
    r, g, b = _split(x)
    safe_c = torch.where(c == 0.0, 1.0, c)
    h_r = torch.remainder((g - b) / safe_c + 6.0, 6.0)
    h_g = (b - r) / safe_c + 2.0
    h_b = (r - g) / safe_c + 4.0
    h = torch.where(r == mx, h_r, torch.where(g == mx, h_g, h_b))
    return torch.where(c == 0.0, 0.0, h)


def _sextant_rgb(h6, c, x_val):
    """(r, g, b) chroma contributions of hue sextant h6 in [0, 6)."""
    i = torch.floor(h6).to(torch.int32)
    z = torch.zeros_like(c)
    first = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r = _select(first, [c, x_val, z, z, x_val], c)
    g = _select(first, [x_val, c, c, x_val, z], z)
    b = _select(first, [z, z, x_val, c, c], x_val)
    return r, g, b


def rgb_to_hsl(x):
    mx, mn, c = _max_min_chroma(x)
    lightness = (mx + mn) / 2.0
    h = _hue_sextant(x, mx, c) / 6.0
    s = torch.where(lightness <= 0.5, c * _prec(2.0 * lightness),
                    c * _prec(2.0 - 2.0 * lightness))
    s = torch.where(c <= 0.0, 0.0, s)
    return _join(h, s, lightness)


def hsl_to_rgb(x):
    h, s, lightness = _split(x)
    c = torch.where(lightness <= 0.5, 2.0 * lightness * s,
                    (2.0 - 2.0 * lightness) * s)
    mn = lightness - 0.5 * c
    h6 = torch.remainder(h * 6.0, 6.0)
    xv = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    r, g, b = _sextant_rgb(h6, c, xv)
    return _join(r + mn, g + mn, b + mn)


def rgb_to_hsv(x):
    mx, mn, c = _max_min_chroma(x)
    h = _hue_sextant(x, mx, c) / 6.0
    s = c * _prec(mx)
    s = torch.where(c <= 0.0, 0.0, s)
    h = torch.where(c <= 0.0, 0.0, h)
    return _join(h, s, mx)


def hsv_to_rgb(x):
    h, s, v = _split(x)
    c = v * s
    mn = v - c
    h6 = torch.remainder(h * 6.0, 6.0)
    xv = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    r, g, b = _sextant_rgb(h6, c, xv)
    return _join(r + mn, g + mn, b + mn)


rgb_to_hsb = rgb_to_hsv  # HSB == HSV (ConvertRGBToHSB, colorspace-private.h:867)
hsb_to_rgb = hsv_to_rgb


def rgb_to_hwb(x):
    """ConvertRGBToHWB (colorspace-private.h:1035)."""
    r, g, b = _split(x)
    w = x.amin(dim=-1)
    v = x.amax(dim=-1)
    blackness = 1.0 - v
    eq = (v - w) < 1e-12
    r_w = (r - w).abs() < 1e-12
    g_w = (g - w).abs() < 1e-12
    f = torch.where(r_w, g - b, torch.where(g_w, b - r, r - g))
    p = torch.where(r_w, 3.0, torch.where(g_w, 5.0, 1.0))
    h = (p - f * _prec(v - w)) / 6.0
    h = torch.where(eq, -1.0, h)
    return _join(h, w, blackness)


def hwb_to_rgb(x):
    h, w, blk = _split(x)
    v = 1.0 - blk
    gray = (h - (-1.0)).abs() < 1e-12
    h6 = 6.0 * h
    i = torch.floor(h6).to(torch.int32)
    f = h6 - i
    f = torch.where((i & 1) != 0, 1.0 - f, f)
    n = w + f * (v - w)
    first = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r = _select(first, [v, n, w, w, n], v)
    g = _select(first, [n, v, v, n, w], w)
    b = _select(first, [w, w, n, v, v], n)
    r = torch.where(gray, v, r)
    g = torch.where(gray, v, g)
    b = torch.where(gray, v, b)
    return _join(r, g, b)


def rgb_to_hsi(x):
    r, g, b = _split(x)
    i = (r + g + b) / 3.0
    s = 1.0 - x.amin(dim=-1) * _prec(i)
    alpha = 0.5 * (2.0 * r - g - b)
    beta = 0.8660254037844385 * (g - b)
    h = torch.atan2(beta, alpha) / (2.0 * math.pi)
    h = torch.where(h < 0.0, h + 1.0, h)
    h = torch.where(i <= 0.0, 0.0, h)
    s = torch.where(i <= 0.0, 0.0, s)
    return _join(h, s, i)


def hsi_to_rgb(x):
    h_, s, i = _split(x)
    h = torch.remainder(360.0 * h_, 360.0)
    rad = math.pi / 180.0

    def branch(hh):
        den = torch.cos((60.0 - hh) * rad)
        prim = i * (1.0 + s * torch.cos(hh * rad) /
                    torch.where(den.abs() < _EPS, _EPS, den))
        return prim, i * (1.0 - s)

    p0, l0 = branch(h)
    p1, l1 = branch(h - 120.0)
    p2, l2 = branch(h - 240.0)
    r = torch.where(h < 120.0, p0,
                    torch.where(h < 240.0, l1, 3.0 * i - l2 - p2))
    g = torch.where(h < 120.0, 3.0 * i - l0 - p0,
                    torch.where(h < 240.0, p1, l2))
    b = torch.where(h < 120.0, l0,
                    torch.where(h < 240.0, 3.0 * i - l1 - p1, p2))
    return _join(r, g, b)


_HCL_LUMA = (0.298839, 0.586811, 0.114350)


def rgb_to_hcl(x):
    r, g, b = _split(x)
    mx, mn, c = _max_min_chroma(x)
    h = _hue_sextant(x, mx, c) / 6.0
    luma = _HCL_LUMA[0] * r + _HCL_LUMA[1] * g + _HCL_LUMA[2] * b
    return _join(h, c, luma)


def _hcl_chroma(h, c):
    h6 = 6.0 * h
    xv = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    r, g, b = _sextant_rgb(h6.clamp(0.0, 5.999999), c, xv)
    inrange = (h6 >= 0.0) & (h6 < 6.0)
    return (torch.where(inrange, r, 0.0), torch.where(inrange, g, 0.0),
            torch.where(inrange, b, 0.0))


def hcl_to_rgb(x):
    h, c, luma = _split(x)
    r, g, b = _hcl_chroma(h, c)
    m = luma - (_HCL_LUMA[0] * r + _HCL_LUMA[1] * g + _HCL_LUMA[2] * b)
    return _join(r + m, g + m, b + m)


rgb_to_hclp = rgb_to_hcl  # identical forward (colorspace-private.h:834)


def hclp_to_rgb(x):
    h, c, luma = _split(x)
    r, g, b = _hcl_chroma(h, c)
    m = luma - (_HCL_LUMA[0] * r + _HCL_LUMA[1] * g + _HCL_LUMA[2] * b)
    z = torch.ones_like(m)
    z = torch.where(m < 0.0, luma * _prec(luma - m), z)
    over = (m + c) > 1.0
    z = torch.where((m >= 0.0) & over, (1.0 - luma) * _prec(m + c - luma), z)
    m = torch.where(m < 0.0, 0.0, torch.where(over, 1.0 - z * c, m))
    return _join(z * r + m, z * g + m, z * b + m)


# -- Broadcast and luma spaces (colorspace-private.h:1551-1587,
# :1637-1703; colorspace.c sRGBTransformImage cases) ---------------------

def _luma_space(fwd_mat, inv_mat):
    """Y + offset-chroma linear space on gamma-encoded RGB; the matrices
    are rounded to float32 as the JAX package holds them."""
    F = np.asarray(fwd_mat, np.float32)
    I = np.asarray(inv_mat, np.float32)

    def from_rgb(x):
        y, c1, c2 = _split(_mat3(x, F))
        return _join(y, c1 + 0.5, c2 + 0.5)

    def to_rgb(x):
        y, c1, c2 = _split(x)
        return _mat3(_join(y, c1 - 0.5, c2 - 0.5), I)

    return to_rgb, from_rgb


# YCbCr == YPbPr (Rec.601 full-range; colorspace-private.h:1567-1580/:1637)
_YCBCR_FWD = [
    [0.298839, 0.586811, 0.114350],
    [-0.1687367, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
]
_YCBCR_INV = [
    [0.99999999999914679361, -1.2188941887145875e-06, 1.4019995886561440468],
    [0.99999975910502514331, -0.34413567816504303521, -0.71413649331646789076],
    [1.00000124040004623180, 1.77200006607230409200, 2.1453384174593273e-06],
]

_YIQ_FWD = [
    [0.298839, 0.586811, 0.114350],
    [0.595716, -0.274453, -0.321263],
    [0.211456, -0.522591, 0.311135],
]
_YIQ_INV = [
    [1.0, 0.9562957197589482261, 0.6210244164652610754],
    [1.0, -0.2721220993185104464, -0.6473805968256950427],
    [1.0, -1.1069890167364901945, 1.7046149983646481374],
]

_YUV_FWD = [
    [0.298839, 0.586811, 0.114350],
    [-0.147, -0.289, 0.436],
    [0.615, -0.515, -0.100],
]
_YUV_INV = [
    [1.0, -3.945707070708279e-05, 1.1398279671717170825],
    [1.0, -0.3946101641414141437, -0.5805003156565656797],
    [1.0, 2.0319996843434342537, -4.813762626262513e-04],
]

_YDBDR_FWD = [
    [0.298839, 0.586811, 0.114350],
    [-0.450, -0.883, 1.333],
    [-1.333, 1.116, 0.217],
]
_YDBDR_INV = [
    [1.0, 9.2303716147657e-05, -0.52591263066186533],
    [1.0, -0.12913289889050927, 0.26789932820759876],
    [1.0, 0.66467905997895482, -7.9202543533108e-05],
]

# OHTA (colorspace.c:1254 forward, :2591 inverse)
_OHTA_FWD = [
    [0.33333, 0.33334, 0.33333],
    [0.5, 0.0, -0.5],
    [-0.25, 0.5, -0.25],
]
_OHTA_INV = [
    [1.0, 1.0, -0.66668],
    [1.0, 0.0, 1.33333],
    [1.0, -1.0, -0.66668],
]

# Rec709 YCbCr (colorspace.c:1316 forward, :2652 inverse)
_R709_FWD = [
    [0.212656, 0.715158, 0.072186],
    [-0.114572, -0.385428, 0.5],
    [0.5, -0.454153, -0.045847],
]
_R709_INV = [
    [1.0, 0.0, 1.574800],
    [1.0, -0.187324, -0.468124],
    [1.0, 1.855600, 0.0],
]

ycbcr_to_rgb, rgb_to_ycbcr = _luma_space(_YCBCR_FWD, _YCBCR_INV)
yiq_to_rgb, rgb_to_yiq = _luma_space(_YIQ_FWD, _YIQ_INV)
yuv_to_rgb, rgb_to_yuv = _luma_space(_YUV_FWD, _YUV_INV)
ydbdr_to_rgb, rgb_to_ydbdr = _luma_space(_YDBDR_FWD, _YDBDR_INV)
ohta_to_rgb, rgb_to_ohta = _luma_space(_OHTA_FWD, _OHTA_INV)
rec709ycbcr_to_rgb, rgb_to_rec709ycbcr = _luma_space(_R709_FWD, _R709_INV)
rec601ycbcr_to_rgb, rgb_to_rec601ycbcr = ycbcr_to_rgb, rgb_to_ycbcr
ypbpr_to_rgb, rgb_to_ypbpr = ycbcr_to_rgb, rgb_to_ycbcr


def rgb_to_ycc(x):
    """PhotoYCC (colorspace.c:1347): piecewise transfer then luma matrix.

    The reference's upper branch computes 0.298839*(1.099*i - 0.099) with
    i in MAP units, so the -0.099 offset is effectively zero
    (0.099/MaxMap): the transfer is 1.099*v."""
    f = torch.where(x <= 0.018, 0.018 * x, 1.099 * x - 0.099 / 65535.0)
    r, g, b = _split(f)
    Y = 0.298839 * r + 0.586811 * g + 0.114350 * b
    C1 = -0.298839 * r - 0.586811 * g + 0.88600 * b + 156.0 / 255.0
    C2 = 0.70100 * r - 0.586811 * g - 0.114350 * b + 137.0 / 255.0
    return _join(Y, C1, C2)


_YCC_RAMPS: Dict[torch.device, torch.Tensor] = {}


def _ycc_ramp(device: torch.device) -> torch.Tensor:
    """The PhotoYCC decode ramp as a float32 tensor on ``device``,
    uploaded once."""
    ramp = _YCC_RAMPS.get(device)
    if ramp is None:
        from ._ycc_map import YCC_MAP

        ramp = torch.tensor(YCC_MAP, dtype=torch.float32, device=device)
        _YCC_RAMPS[device] = ramp
    return ramp


def ycc_to_rgb(x):
    """Inverse PhotoYCC (colorspace.c:2681): linear unmix then the Kodak
    PhotoCD decode ramp (YCCMap, colorspace.c:1829) applied to each
    channel at index round(1024*v), oracle-verified."""
    Y, C1, C2 = _split(x)
    c1 = C1 - 156.0 / 255.0
    c2 = C2 - 137.0 / 255.0
    r = 1.3584 * Y + 1.8215 * c2
    g = 1.3584 * Y - 0.4302726 * c1 - 0.9271435 * c2
    b = 1.3584 * Y + 2.2179 * c1
    ramp = _ycc_ramp(x.device)

    def decode(v):
        idx = torch.round(1024.0 * v).to(torch.int64).clamp(0, 1388)
        return ramp[idx]

    return _join(decode(r), decode(g), decode(b))


def rgb_to_cmy(x):
    return 1.0 - x


def cmy_to_rgb(x):
    return 1.0 - x


_LOG_BLACK, _LOG_WHITE, _FILM_GAMMA = 95.0, 685.0, 0.6


def rgb_to_log(x):
    """Cineon log encode (colorspace.c:1055 region): density == gamma ==
    1/1.7, film gamma 0.6, reference black and white 95 and 685."""
    black = 10.0 ** ((_LOG_BLACK - _LOG_WHITE) * 0.002 / _FILM_GAMMA)
    lin = srgb_to_linear(x)
    return (_LOG_WHITE + torch.log10(black + lin * (1.0 - black)) /
            (0.002 / _FILM_GAMMA)) / 1024.0


def log_to_rgb(x):
    black = 10.0 ** ((_LOG_BLACK - _LOG_WHITE) * 0.002 / _FILM_GAMMA)
    v = 1024.0 * x
    lin = (torch.pow(10.0, (v - _LOG_WHITE) * 0.002 / _FILM_GAMMA) - black) \
        / (1.0 - black)
    lin = torch.where(v < _LOG_BLACK, 0.0,
                      torch.where(v >= _LOG_WHITE, 1.0, lin))
    return linear_to_srgb(lin.clamp(0.0, 1.0))


def rgb_to_cmyk(x):
    """sRGB -> CMYK with max black extraction (colorspace-private.h:1589);
    the reference decodes gamma first (linear CMYK)."""
    r, g, b = _split(srgb_to_linear(x))
    c, m, y = 1.0 - r, 1.0 - g, 1.0 - b
    k = torch.minimum(c, torch.minimum(m, y))
    denom = _prec(1.0 - k)
    zero = (r < 1e-12) & (g < 1e-12) & (b < 1e-12)
    c = torch.where(zero, 0.0, (c - k) * denom)
    m = torch.where(zero, 0.0, (m - k) * denom)
    y = torch.where(zero, 0.0, (y - k) * denom)
    k = torch.where(zero, 1.0, k)
    return torch.stack([c, m, y, k], dim=-1)


def cmyk_to_rgb(x):
    """CMYK -> sRGB (colorspace-private.h:131 + encode, colorspace.c:433)."""
    c, m, y, k = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    r = 1.0 - (c * (1.0 - k) + k)
    g = 1.0 - (m * (1.0 - k) + k)
    b = 1.0 - (y * (1.0 - k) + k)
    return linear_to_srgb(_join(r, g, b))


adobe98_to_rgb, rgb_to_adobe98 = _matrix_space(_ADOBE98_TO_XYZ,
                                               _XYZ_TO_ADOBE98)
displayp3_to_rgb, rgb_to_displayp3 = _matrix_space(_P3_TO_XYZ, _XYZ_TO_P3)
prophoto_to_rgb, rgb_to_prophoto = _matrix_space(_PROPHOTO_TO_XYZ,
                                                 _XYZ_TO_PROPHOTO)


# colorspace key -> (to_srgb, from_srgb) over color channels only.
_CONVERTERS: Dict[str, tuple] = {
    "srgb": (_identity, _identity),
    "undefined": (_identity, _identity),
    "transparent": (_identity, _identity),
    "rgb": (linear_to_srgb, srgb_to_linear),
    "scrgb": (linear_to_srgb, srgb_to_linear),
    "gray": (gray_to_rgb, rgb_to_gray),
    "linear_gray": (linear_gray_to_rgb, rgb_to_linear_gray),
    "xyz": (xyz_to_rgb, rgb_to_xyz),
    "lab": (lab_to_rgb, rgb_to_lab),
    "lchab": (lchab_to_rgb, rgb_to_lchab),
    "lch": (lchab_to_rgb, rgb_to_lchab),
    "luv": (luv_to_rgb, rgb_to_luv),
    "lchuv": (lchuv_to_rgb, rgb_to_lchuv),
    "xyy": (xyy_to_rgb, rgb_to_xyy),
    "lms": (_lms_to_rgb, _lms_from_rgb),
    "cat02lms": (_lms_to_rgb, _lms_from_rgb),
    "oklab": (oklab_to_rgb, rgb_to_oklab),
    "oklch": (oklch_to_rgb, rgb_to_oklch),
    "jzazbz": (jzazbz_to_rgb, rgb_to_jzazbz),
    "hsl": (hsl_to_rgb, rgb_to_hsl),
    "hsv": (hsv_to_rgb, rgb_to_hsv),
    "hsb": (hsb_to_rgb, rgb_to_hsb),
    "hwb": (hwb_to_rgb, rgb_to_hwb),
    "hsi": (hsi_to_rgb, rgb_to_hsi),
    "hcl": (hcl_to_rgb, rgb_to_hcl),
    "hclp": (hclp_to_rgb, rgb_to_hclp),
    "ycbcr": (ycbcr_to_rgb, rgb_to_ycbcr),
    "ypbpr": (ypbpr_to_rgb, rgb_to_ypbpr),
    "rec601ycbcr": (rec601ycbcr_to_rgb, rgb_to_rec601ycbcr),
    "rec709ycbcr": (rec709ycbcr_to_rgb, rgb_to_rec709ycbcr),
    "yiq": (yiq_to_rgb, rgb_to_yiq),
    "yuv": (yuv_to_rgb, rgb_to_yuv),
    "ydbdr": (ydbdr_to_rgb, rgb_to_ydbdr),
    "ycc": (ycc_to_rgb, rgb_to_ycc),
    "ohta": (ohta_to_rgb, rgb_to_ohta),
    "cmy": (cmy_to_rgb, rgb_to_cmy),
    "cmyk": (cmyk_to_rgb, rgb_to_cmyk),
    "log": (log_to_rgb, rgb_to_log),
    "adobe98": (adobe98_to_rgb, rgb_to_adobe98),
    "displayp3": (displayp3_to_rgb, rgb_to_displayp3),
    "prophoto": (prophoto_to_rgb, rgb_to_prophoto),
}


def supported_colorspaces():
    return sorted(_CONVERTERS)


def convert(color: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert color channels (no alpha) between colorspaces via the sRGB hub.

    Mirrors TransformImageColorspace (MagickCore/colorspace.c:1751):
    source -> sRGB -> target.  Values may leave [0, 1] (HDRI semantics);
    only encoders clamp.
    """
    src, dst = src.lower(), dst.lower()
    if src == dst:
        return color
    if src not in _CONVERTERS:
        raise ValueError(f"unsupported source colorspace {src!r}")
    if dst not in _CONVERTERS:
        raise ValueError(f"unsupported target colorspace {dst!r}")
    return _CONVERTERS[dst][1](_CONVERTERS[src][0](color))
