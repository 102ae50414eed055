"""Resize: separable resampling as per-axis weight-matrix contractions.

Port of ``imagemagick_tpu/ops/resize.py`` (the reference's resize engine,
MagickCore/resize.c: ResizeImage at :3761, AcquireResizeFilter at :803,
HorizontalFilter/VerticalFilter at :3333/:3549).

The contribution structure of one axis is a banded matrix built host-side
with numpy (copied verbatim from the JAX package, so the weights are
bit-equal).  The resample is one dense matmul per axis in full float32;
for very large axes, where the dense matrix would waste memory, a windowed
gather takes its place.  ``sample``, ``scale``, ``thumbnail``, ``magnify``
and ``interpolative_resize`` (the -sample, -scale, -thumbnail, -magnify and
-adaptive-resize options) follow; their geometry is computed on the host
in float64, as in the JAX package.  The JAX package's integer-factor
strided path (``_resample_axis_strided``) is never dispatched there and
has no counterpart here.

Filter weights reproduce the reference's table (resize.c:823-940: function,
support, window pairing, B/C coefficients, blur factors) including the
windowed-sinc construction of GetResizeFilterWeight (resize.c:1690-1714) and
the contribution normalization of HorizontalFilter (resize.c:3389-3440).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

_EPSILON = 1.0e-15  # MagickEpsilon analog for bisect math


# ---------------------------------------------------------------------------
# Scalar filter functions (host-side, numpy) — resize.c:150-470
# ---------------------------------------------------------------------------

def _box(x):
    return np.ones_like(x)


def _triangle(x):
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _quadratic(x):
    return np.where(x < 0.5, 0.75 - x * x,
                    np.where(x < 1.5, 0.5 * (x - 1.5) ** 2, 0.0))


def _cubic_bc(B, C):
    p0 = (6.0 - 2.0 * B) / 6.0
    p2 = (-18.0 + 12.0 * B + 6.0 * C) / 6.0
    p3 = (12.0 - 9.0 * B - 6.0 * C) / 6.0
    q0 = (8.0 * B + 24.0 * C) / 6.0
    q1 = (-12.0 * B - 48.0 * C) / 6.0
    q2 = (6.0 * B + 30.0 * C) / 6.0
    q3 = (-B - 6.0 * C) / 6.0

    def f(x):
        return np.where(
            x < 1.0, p0 + x * x * (p2 + x * p3),
            np.where(x < 2.0, q0 + x * (q1 + x * (q2 + x * q3)), 0.0))

    return f


def _gaussian(sigma=0.5):
    inv = 1.0 / (2.0 * sigma * sigma)

    def f(x):
        return np.exp(-inv * x * x)

    return f


def _sinc(x):
    return np.sinc(x)  # sin(pi x)/(pi x)


def _bessel_j1(x):
    """J1 Bessel function (Abramowitz & Stegun 9.4 rational approximations)."""
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    # |x| < 8
    y = x * x
    p1 = x * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1 +
         y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
    q1 = 144725228442.0 + y * (2300535178.0 + y * (18583304.74 +
         y * (99447.43394 + y * (376.9991397 + y))))
    small = p1 / q1
    # |x| >= 8
    z = 8.0 / np.where(ax < 1e-300, 1e-300, ax)
    y2 = z * z
    xx = ax - 2.356194491
    p2 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4 +
         y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    q2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5 +
         y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    big = np.sqrt(0.636619772 / np.where(ax < 1e-300, 1e-300, ax)) * \
        (np.cos(xx) * p2 - z * np.sin(xx) * q2)
    big = np.where(x < 0.0, -big, big)
    return np.where(ax < 8.0, small, big)


def _jinc(x):
    """Jinc(x) = J1(pi x)/x with limit pi/2 at 0 (resize.c:199-214)."""
    x = np.asarray(x, dtype=np.float64)
    safe = np.where(np.abs(x) < 1e-12, 1.0, x)
    return np.where(np.abs(x) < 1e-12, 0.5 * math.pi, _bessel_j1(math.pi * safe) / safe)


def _hann(x):
    return 0.5 + 0.5 * np.cos(math.pi * x)


def _hamming(x):
    return 0.54 + 0.46 * np.cos(math.pi * x)


def _blackman(x):
    c = np.cos(math.pi * x)
    return 0.34 + c * (0.5 + c * 0.16)


def _bohman(x):
    c = np.cos(math.pi * np.minimum(x, 1.0))
    s = np.sqrt(np.maximum(1.0 - c * c, 0.0))
    return (1.0 - np.minimum(x, 1.0)) * c + (1.0 / math.pi) * s


def _cosine(x):
    return np.cos(0.5 * math.pi * x)


def _welch(x):
    return np.where(x < 1.0, 1.0 - x * x, 0.0)


def _i0(x):
    """Modified Bessel I0 (used by Kaiser)."""
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    y1 = (ax / 3.75) ** 2
    small = 1.0 + y1 * (3.5156229 + y1 * (3.0899424 + y1 * (1.2067492 +
        y1 * (0.2659732 + y1 * (0.360768e-1 + y1 * 0.45813e-2)))))
    y2 = 3.75 / np.where(ax < 1e-300, 1.0, ax)
    big = (np.exp(ax) / np.sqrt(np.where(ax < 1e-300, 1.0, ax))) * (
        0.39894228 + y2 * (0.1328592e-1 + y2 * (0.225319e-2 + y2 * (-0.157565e-2 +
        y2 * (0.916281e-2 + y2 * (-0.2057706e-1 + y2 * (0.2635537e-1 +
        y2 * (-0.1647633e-1 + y2 * 0.392377e-2))))))))
    return np.where(ax < 3.75, small, big)


def _kaiser(beta=6.5):
    norm = 1.0 / _i0(np.asarray(beta))

    def f(x):
        return norm * _i0(beta * np.sqrt(np.maximum(1.0 - x * x, 0.0)))

    return f


def _lagrange(support):
    order = int(2.0 * support)

    def f(x):
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros_like(x)
        inside = x <= support
        n = np.floor(support + x).astype(np.int64)
        value = np.ones_like(x)
        for i in range(order):
            mask = (i != n)
            denom = np.where(mask, (n - i).astype(np.float64), 1.0)
            value = np.where(mask, value * (n - i - x) / denom, value)
        out = np.where(inside, value, 0.0)
        return out

    return f


def _cubic_spline(support):
    def f(x):
        x = np.asarray(x, dtype=np.float64)
        if support <= 2.0:
            return np.where(
                x < 1.0, ((x - 9.0 / 5.0) * x - 1.0 / 5.0) * x + 1.0,
                np.where(x < 2.0,
                         ((-1.0 / 3.0 * (x - 1.0) + 4.0 / 5.0) * (x - 1.0) - 7.0 / 15.0) * (x - 1.0),
                         0.0))
        if support <= 3.0:
            return np.where(
                x < 1.0, ((13.0 / 11.0 * x - 453.0 / 209.0) * x - 3.0 / 209.0) * x + 1.0,
                np.where(x < 2.0,
                         ((-6.0 / 11.0 * (x - 1.0) + 270.0 / 209.0) * (x - 1.0) - 156.0 / 209.0) * (x - 1.0),
                np.where(x < 3.0,
                         ((1.0 / 11.0 * (x - 2.0) - 45.0 / 209.0) * (x - 2.0) + 26.0 / 209.0) * (x - 2.0),
                         0.0)))
        return np.where(
            x < 1.0, ((49.0 / 41.0 * x - 6387.0 / 2911.0) * x - 3.0 / 2911.0) * x + 1.0,
            np.where(x < 2.0,
                     ((-24.0 / 41.0 * (x - 1.0) + 4032.0 / 2911.0) * (x - 1.0) - 2328.0 / 2911.0) * (x - 1.0),
            np.where(x < 3.0,
                     ((6.0 / 41.0 * (x - 2.0) - 1008.0 / 2911.0) * (x - 2.0) + 582.0 / 2911.0) * (x - 2.0),
            np.where(x < 4.0,
                     ((-1.0 / 41.0 * (x - 3.0) + 168.0 / 2911.0) * (x - 3.0) - 97.0 / 2911.0) * (x - 3.0),
                     0.0))))

    return f


def _mks2013(x):
    return np.where(x < 0.5, 0.625 + 1.75 * (0.5 - x) * (0.5 + x),
           np.where(x < 1.5, (1.0 - x) * (1.75 - x),
           np.where(x < 2.5, -0.125 * (2.5 - x) * (2.5 - x), 0.0)))


def _mks2021(x):
    return np.where(x < 0.5, 577.0 / 576.0 - 239.0 / 144.0 * x * x,
           np.where(x < 1.5, 35.0 / 36.0 * (x - 1.0) * (x - 239.0 / 140.0),
           np.where(x < 2.5, 1.0 / 6.0 * (x - 2.0) * (65.0 / 24.0 - x),
           np.where(x < 3.5, 1.0 / 36.0 * (x - 3.0) * (x - 3.75),
           np.where(x < 4.5, -1.0 / 288.0 * (x - 4.5) * (x - 4.5), 0.0)))))


# Filter registry: name -> (filter_fn, support, window_fn, window_scale, blur)
# window_scale is the windowing function's first zero crossing
# (the ``scale`` column of the table at resize.c:890-940); weights are
# filter(x) * window(x * window_scale / window_support).
def _build_filters():
    sinc = _sinc
    f = {}
    f["point"] = (_box, 0.0, None, 1.0, 1.0)
    f["box"] = (_box, 0.5, None, 1.0, 1.0)
    f["triangle"] = (_triangle, 1.0, None, 1.0, 1.0)
    f["hermite"] = (_cubic_bc(0.0, 0.0), 1.0, None, 1.0, 1.0)
    f["hann"] = (sinc, 1.0, _hann, 1.0, 1.0)
    f["hanning"] = f["hann"]
    f["hamming"] = (sinc, 1.0, _hamming, 1.0, 1.0)
    f["blackman"] = (sinc, 1.0, _blackman, 1.0, 1.0)
    f["gaussian"] = (_gaussian(), 2.0, None, 1.5, 1.0)
    f["quadratic"] = (_quadratic, 1.5, None, 1.5, 1.0)
    f["cubic"] = (_cubic_bc(1.0, 0.0), 2.0, None, 2.0, 1.0)
    f["catrom"] = (_cubic_bc(0.0, 0.5), 2.0, None, 1.0, 1.0)
    f["mitchell"] = (_cubic_bc(1.0 / 3.0, 1.0 / 3.0), 2.0, None, 8.0 / 7.0, 1.0)
    f["jinc"] = (_jinc, 3.0, None, 1.2196698912665045, 1.0)
    f["sinc"] = (sinc, 4.0, None, 1.0, 1.0)
    f["sincfast"] = (sinc, 4.0, None, 1.0, 1.0)
    f["kaiser"] = (sinc, 1.0, _kaiser(), 1.0, 1.0)
    f["welch"] = (sinc, 3.0, _welch, 1.0, 1.0)
    f["welsh"] = f["welch"]
    f["parzen"] = (sinc, 2.0, _cubic_bc(1.0, 0.0), 2.0, 1.0)
    f["bohman"] = (sinc, 1.0, _bohman, 1.0, 1.0)
    f["bartlett"] = (sinc, 1.0, _triangle, 1.0, 1.0)
    f["lagrange"] = (_lagrange(2.0), 2.0, None, 1.0, 1.0)
    f["lanczos"] = (sinc, 3.0, sinc, 1.0, 1.0)
    f["lanczossharp"] = (sinc, 3.0, sinc, 1.0, 0.9812505644269356)
    f["lanczos2"] = (sinc, 2.0, sinc, 1.0, 1.0)
    f["lanczos2sharp"] = (sinc, 2.0, sinc, 1.0, 0.9549963639785485)
    f["robidoux"] = (_cubic_bc(0.37821575509399867, 0.31089212245300067),
                     2.0, None, 1.1685777620836932, 1.0)
    f["robidouxsharp"] = (_cubic_bc(0.2620145123990142, 0.3689927438004929),
                          2.0, None, 1.105822933719019, 1.0)
    f["cosine"] = (sinc, 3.0, _cosine, 1.0, 1.0)
    f["spline"] = (_cubic_bc(1.0, 0.0), 2.0, None, 2.0, 1.0)
    f["lanczosradius"] = (sinc, 3.0, sinc, 1.0, 1.0)
    f["cubicspline"] = (_cubic_spline(2.0), 2.0, None, 0.5, 1.0)
    f["magickernelsharp2013"] = (_mks2013, 2.5, None, 1.0, 1.0)
    f["magickernelsharp2021"] = (_mks2021, 4.5, None, 1.0, 1.0)
    return f


_FILTERS = _build_filters()


def supported_filters():
    return sorted(_FILTERS)


@lru_cache(maxsize=512)
def _axis_weights(in_size: int, out_size: int, filter_name: str,
                  blur: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-output-pixel contribution windows for one axis.

    Returns (start[out], weights[out, k], k).  Mirrors HorizontalFilter's
    contribution loop (resize.c:3389-3440): bisect at (x+0.5)/factor, window
    of width 2*support, weights normalized to unit density.
    """
    name = filter_name.lower()
    if name == "undefined":
        name = "lanczos"
    if name not in _FILTERS:
        raise ValueError(f"unknown resize filter {filter_name!r}")
    fn, support0, window, window_scale, sharp = _FILTERS[name]
    total_blur = float(blur) * sharp

    factor = out_size / in_size
    scale = max(1.0 / factor + _EPSILON, 1.0)
    support = scale * support0
    if support < 0.5:  # point sampling floor (resize.c:3368-3374)
        support = 0.5
        scale = 1.0
    inv_scale = 1.0 / scale

    k = int(2.0 * support + 3.0)
    starts = np.zeros((out_size,), dtype=np.int32)
    weights = np.zeros((out_size, k), dtype=np.float64)
    xs = np.arange(out_size, dtype=np.float64)
    bisect = (xs + 0.5) / factor + _EPSILON
    start = np.maximum(bisect - support + 0.5, 0.0).astype(np.int64)
    stop = np.minimum(bisect + support + 0.5, float(in_size)).astype(np.int64)
    n_max = int((stop - start).max()) if out_size else 0
    n_max = max(n_max, 1)
    offs = np.arange(n_max, dtype=np.float64)
    pos = start[:, None] + offs[None, :]            # (out, n)
    valid = pos < stop[:, None]
    x_arg = np.abs(inv_scale * (pos - bisect[:, None] + 0.5)) / total_blur
    w = fn(x_arg)
    if window is not None and support0 > 0:
        w = w * window(x_arg * window_scale / support0)
    w = np.where(valid, w, 0.0)
    dens = w.sum(axis=1, keepdims=True)
    dens = np.where(np.abs(dens) < 1e-300, 1.0, dens)
    w = w / dens
    weights[:, :n_max] = w
    starts[:] = start.astype(np.int32)
    return starts, weights, n_max


@lru_cache(maxsize=512)
def resize_matrix(in_size: int, out_size: int, filter_name: str = "lanczos",
                  blur: float = 1.0) -> np.ndarray:
    """Dense (in, out) resampling matrix for one axis."""
    starts, weights, n = _axis_weights(in_size, out_size, filter_name, blur)
    mat = np.zeros((in_size, out_size), dtype=np.float32)
    for j in range(n):
        idx = np.minimum(starts + j, in_size - 1)
        np.add.at(mat, (idx, np.arange(out_size)), weights[:, j].astype(np.float32))
    return mat


_DENSE_LIMIT = 8 * 1024 * 1024  # entries; above this use windowed gather


@lru_cache(maxsize=64)
def _matrix_on(in_size: int, out_size: int, filter_name: str, blur: float,
               device: torch.device) -> torch.Tensor:
    """resize_matrix as a tensor on ``device``, uploaded once per shape."""
    mat = resize_matrix(in_size, out_size, filter_name, blur)
    return torch.from_numpy(mat).to(device)


def _resample_axis(img: torch.Tensor, axis: int, out_size: int,
                   filter_name: str, blur: float) -> torch.Tensor:
    """Resample one spatial axis of an (..., H, W, C) tensor."""
    in_size = img.shape[axis]
    if in_size == out_size and filter_name.lower() in ("undefined", "point"):
        return img
    if in_size * out_size <= _DENSE_LIMIT:
        mat = _matrix_on(in_size, out_size, filter_name, blur, img.device)
        moved = img.movedim(axis, -1)
        # one (rows, in) @ (in, out) product: matmul of the strided N-D
        # view would batch many tiny (C, in) products instead
        out = moved.reshape(-1, in_size) @ mat
        return out.reshape(moved.shape[:-1] + (out_size,)).movedim(-1, axis)
    # Windowed gather path for huge axes: contiguous windows.
    starts, weights, n = _axis_weights(in_size, out_size, filter_name, blur)
    idx = np.clip(starts.astype(np.int64)[:, None] + np.arange(n)[None, :],
                  0, in_size - 1)
    idx = torch.from_numpy(idx.reshape(-1)).to(img.device)
    w = torch.from_numpy(weights[:, :n].astype(np.float32)).to(img.device)
    moved = img.movedim(axis, 0)                               # (in, ...)
    gathered = moved.index_select(0, idx)                      # (out*n, ...)
    gathered = gathered.reshape((out_size, n) + moved.shape[1:])
    out = torch.einsum("on,on...->o...", w, gathered)
    return out.movedim(0, axis)


def _default_filter(in_h, in_w, out_h, out_w, has_alpha: bool) -> str:
    """Default filter selection (ResizeImage, resize.c:3798-3812)."""
    x_factor = out_w / in_w
    y_factor = out_h / in_h
    if x_factor == 1.0 and y_factor == 1.0:
        return "point"
    if has_alpha or (x_factor * y_factor) > 1.0:
        return "mitchell"
    return "lanczos"


def resize(img: torch.Tensor, height: int, width: int,
           filter_name: str = "undefined", blur: float = 1.0,
           has_alpha: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., height, width, C).

    Two-pass separable resampling; pass order follows the reference
    (larger-shrink axis second, resize.c:3845-3865).  With an alpha channel,
    color channels are filtered alpha-weighted and renormalized, matching the
    reference's alpha-blending resample (resize.c:3470-3520 region).
    """
    *_, in_h, in_w, c = img.shape
    if filter_name in ("undefined", "", None):
        filter_name = _default_filter(in_h, in_w, height, width, has_alpha)

    work = img
    if has_alpha and c > 1:
        alpha = work[..., -1:]
        work = torch.cat([work[..., :-1] * alpha, alpha], dim=-1)

    x_factor = width / in_w
    y_factor = height / in_h
    if x_factor > y_factor:
        work = _resample_axis(work, -2, width, filter_name, blur)
        work = _resample_axis(work, -3, height, filter_name, blur)
    else:
        work = _resample_axis(work, -3, height, filter_name, blur)
        work = _resample_axis(work, -2, width, filter_name, blur)

    if has_alpha and c > 1:
        alpha = work[..., -1:]
        safe = torch.where(alpha.abs() < 1e-6, torch.ones_like(alpha), alpha)
        work = torch.cat([work[..., :-1] / safe, alpha], dim=-1)
    return work.clamp(0.0, 1.0)


def sample(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbor point sample (SampleImage, resize.c:3952).

    The reference offsets by 0.5 - MagickEpsilon, so an exact integer
    product floors DOWN (e.g. 60->15 picks rows 1,5,9,... not 2,6,10),
    verified against the built reference binary.  The row and column
    indices are computed on the host in float64."""
    *_, in_h, in_w, c = img.shape
    off = 0.5 - 1e-9
    ys = np.minimum(((np.arange(height) + off) * in_h / height)
                    .astype(np.int64), in_h - 1)
    xs = np.minimum(((np.arange(width) + off) * in_w / width)
                    .astype(np.int64), in_w - 1)
    out = img.index_select(-3, torch.from_numpy(ys).to(img.device))
    return out.index_select(-2, torch.from_numpy(xs).to(img.device))


def scale(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Box-average scale (ScaleImage, resize.c)."""
    return resize(img, height, width, filter_name="box")


def thumbnail(img: torch.Tensor, height: int, width: int,
              has_alpha: bool = False,
              filter_name: str = None) -> torch.Tensor:
    """ThumbnailImage (resize.c:3641-3703): point-sample to 4x the target
    when both shrink factors exceed 4, box-resize to 2x when both exceed
    2, then a final resize whose default filter is LANCZOSSHARP (not the
    usual resize heuristic)."""
    *_, in_h, in_w, _ = img.shape
    work = img
    if (in_w // width) > 4 and (in_h // height) > 4:
        work = sample(work, 4 * height, 4 * width)
    wh, ww = work.shape[-3], work.shape[-2]
    if (ww // width) > 2 and (wh // height) > 2:
        work = resize(work, 2 * height, 2 * width, filter_name="box",
                      has_alpha=has_alpha)
    return resize(work, height, width,
                  filter_name=filter_name or "lanczossharp",
                  has_alpha=has_alpha)


def magnify(img: torch.Tensor) -> torch.Tensor:
    """Pixel-art 2x upscale by the Scale2X/EPX rule (MagnifyImage, resize.c).

    For each pixel P with neighbors A (above), B (right), C (left), D (below):
      1 = C==A and C!=D and A!=B ? A : P   (top-left)
      2 = A==B and A!=C and B!=D ? B : P   (top-right)
      3 = D==C and D!=B and C!=A ? C : P   (bottom-left)
      4 = B==D and B!=A and D!=C ? D : P   (bottom-right)
    Neighbors beyond the border replicate the edge.
    """
    up = torch.cat([img[..., :1, :, :], img[..., :-1, :, :]], dim=-3)
    down = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    left = torch.cat([img[..., :, :1, :], img[..., :, :-1, :]], dim=-2)
    right = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], dim=-2)

    def eq(a, b):
        return torch.all((a - b).abs() < 1e-6, dim=-1, keepdim=True)

    a, b, c, d = up, right, left, down
    p1 = torch.where(eq(c, a) & ~eq(c, d) & ~eq(a, b), a, img)
    p2 = torch.where(eq(a, b) & ~eq(a, c) & ~eq(b, d), b, img)
    p3 = torch.where(eq(d, c) & ~eq(d, b) & ~eq(c, a), c, img)
    p4 = torch.where(eq(b, d) & ~eq(b, a) & ~eq(d, c), d, img)
    top = torch.stack([p1, p2], dim=-2)      # (..., H, W, 2, C)
    bot = torch.stack([p3, p4], dim=-2)
    quad = torch.stack([top, bot], dim=-4)   # (..., H, 2, W, 2, C)
    *lead, h, _, w, _, ch = quad.shape
    return quad.reshape(*lead, h * 2, w * 2, ch)


def _mesh_sample(img: torch.Tensor, u: np.ndarray, v: np.ndarray
                 ) -> torch.Tensor:
    """MeshInterpolatePixel (pixel.c:4689): split the 2x2 cell into two
    triangles along the lower-luma-contrast diagonal and barycentrically
    interpolate within the containing triangle.  u/v are HOST float64
    grids: the triangle tie-breaks (dx<=dy) land exactly on rational
    boundaries and must be decided in double like the reference."""
    h, w, c = img.shape[-3:]
    dev = img.device
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    x0 = np.floor(u)
    y0 = np.floor(v)

    def host(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dx = host((u - x0)[..., None].astype(np.float32))
    dy = host((v - y0)[..., None].astype(np.float32))
    le_diag = host(((u - x0) <= (v - y0))[..., None])
    le_anti = host(((u - x0) <= 1.0 - (v - y0))[..., None])
    x0i = x0.astype(np.int64)
    y0i = y0.astype(np.int64)
    lead = img.shape[:-3]
    flatimg = img.reshape(lead + (h * w, c))

    def at(yi, xi):
        idx = np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)
        out = flatimg.index_select(-2, host(idx.reshape(-1)))
        return out.reshape(lead + idx.shape + (c,))

    p0 = at(y0i, x0i)
    p1 = at(y0i, x0i + 1)
    p2 = at(y0i + 1, x0i)
    p3 = at(y0i + 1, x0i + 1)

    def luma(p):
        if c >= 3:
            return (0.212656 * p[..., 0] + 0.715158 * p[..., 1]
                    + 0.072186 * p[..., 2])[..., None]
        return p[..., :1]

    lx = luma(p0) - luma(p3)
    ly = luma(p1) - luma(p2)
    # NW-SE diagonal (|lx| < |ly|)
    v_bl = dx * p3 + (1.0 - dy) * p0 + (dy - dx) * p2          # dx <= dy
    v_tr = (1.0 - dx) * p0 + dy * p3 + (dx - dy) * p1          # dx > dy
    # NE-SW diagonal
    v_tl = dx * p1 + dy * p2 + (1.0 - dx - dy) * p0            # dx <= 1-dy
    v_br = (1.0 - dx) * p2 + (1.0 - dy) * p1 + (dx + dy - 1.0) * p3
    nwse = lx.abs() < ly.abs()
    return torch.where(nwse, torch.where(le_diag, v_bl, v_tr),
                       torch.where(le_anti, v_tl, v_br))


def interpolative_resize(img: torch.Tensor, height: int, width: int,
                         method: str = "mesh") -> torch.Tensor:
    """InterpolativeResizeImage (resize.c:1208): per-dest-pixel single
    interpolated lookup at ((i+0.5)·scale−0.5), NOT a filtered
    convolution.  AdaptiveResizeImage (resize.c:1331) is this with Mesh
    interpolation."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (height, width):
        return img
    sy = h / float(height)
    sx = w / float(width)
    # geometry in float64 on the host: the mesh triangle tie-breaks
    # (dx<=dy) sit exactly on thirds/halves for rational scales and flip
    # under float32; the reference computes them in double
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    u = (xx + 0.5) * sx - 0.5
    v = (yy + 0.5) * sy - 0.5
    m = method.lower()
    if m in ("mesh", "adaptive"):
        return _mesh_sample(img, u, v)
    wy = _interp_weights(v[:, 0], h, m, img.device)
    wx = _interp_weights(u[0], w, m, img.device)
    c = img.shape[-1]
    if c in (2, 4) and m in ("bilinear", "blend", "catrom", "spline",
                             "undefined", ""):
        # BlendPixelTrait: colors interpolate alpha-premultiplied, the
        # result is un-premultiplied by the interpolated alpha
        # (pixel.c:4540-4555 gamma=PerceptibleReciprocal(alpha_blend))
        a = img[..., -1:]
        pm = torch.cat([img[..., :-1] * a, a], -1)
        out = torch.einsum("yh,...hwc,xw->...yxc", wy, pm, wx)
        ai = out[..., -1:]
        gamma = torch.where(ai.abs() < 1e-12, 0.0, 1.0 / ai)
        return torch.cat([out[..., :-1] * gamma, ai], -1).to(img.dtype)
    return torch.einsum("yh,...hwc,xw->...yxc", wy, img, wx).to(img.dtype)


def _interp_weights(t: np.ndarray, n: int, method: str,
                    device=None) -> torch.Tensor:
    """1-D interpolation weight matrix (n_dst, n_src) for the separable
    InterpolatePixelChannel methods (pixel.c:4433-4830), as float32 on
    ``device`` (the CPU by default).  Taps outside the image clamp to the
    edge (the default virtual-pixel policy); weights are computed on the
    host in float64 exactly as the reference."""
    t = np.asarray(t, np.float64)
    nd = t.shape[0]
    W = np.zeros((nd, n), np.float64)
    f0 = np.floor(t)
    frac = t - f0
    base = f0.astype(np.int64)

    def add(idx, w):
        np.add.at(W, (np.arange(nd), np.clip(idx, 0, n - 1)), w)

    if method in ("integer",):
        add(base, np.ones(nd))
    elif method in ("nearest", "point"):
        add(np.floor(t + 0.5).astype(np.int64), np.ones(nd))
    elif method in ("average", "average4"):
        add(base, np.full(nd, 0.5))
        add(base + 1, np.full(nd, 0.5))
    elif method == "average9":
        b = (np.floor(t + 0.5) - 1.0).astype(np.int64)
        for k in range(3):
            add(b + k, np.full(nd, 1.0 / 3.0))
    elif method == "average16":
        for k in range(4):
            add(base - 1 + k, np.full(nd, 0.25))
    elif method == "blend":
        # pixel.c:4580-4605: one tap outside the [0.25, 0.75) band, an
        # equal two-tap blend inside it
        both = (frac > 0.25) & (frac < 0.75)
        hi = frac >= 0.75
        add(base, np.where(both, 0.5, np.where(hi, 0.0, 1.0)))
        add(base + 1, np.where(both, 0.5, np.where(hi, 1.0, 0.0)))
    elif method in ("catrom", "spline"):
        x = frac
        alpha = 1.0 - x
        if method == "catrom":
            beta = -0.5 * x * alpha
            w0 = alpha * beta
            w3 = x * beta
            gma = w3 - w0
            w1 = alpha - w0 + gma
            w2 = x - w3 - gma
        else:
            w3 = (1.0 / 6.0) * x ** 3
            w0 = (1.0 / 6.0) * alpha ** 3
            beta = w3 - w0
            w1 = alpha - w0 + beta
            w2 = x - w3 - beta
        for k, wk in enumerate((w0, w1, w2, w3)):
            add(base - 1 + k, wk)
    else:  # bilinear default
        add(base, 1.0 - frac)
        add(base + 1, frac)
    return torch.from_numpy(W.astype(np.float32)).to(
        device if device is not None else "cpu")
