"""Morphology: structuring-element ops and the generic neighborhood engine.

Port of ``imagemagick_tpu/ops/morphology.py`` (the reference's
MagickCore/morphology.c: MorphologyImage :4129, MorphologyPrimitive :2566
— convolve/correlate/erode/dilate/hit-and-miss — and the built-in kernel
library AcquireKernelBuiltIn).  The kernel library is the JAX package's
numpy, copied verbatim.  A structuring element is a static (kh, kw) mask;
erode is the minimum and dilate the maximum over its shifted views of the
padded image, one PyTorch op per offset.  Config #3's open and close of a
binary image by ``square:1`` run here on the op route; kernel K5
(``gpu_kernels.fused_bilevel_morph_edge``) runs them fused.

``distance`` is the reference's raster-sweep distance transform: two
chamfer sweeps, each a loop over rows on the host with the in-row
dependency as one ``torch.cummin`` (``distance_transform``).
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.virtual_pixel import pad_spatial

_BIG = 1e6  # a distance no chamfer path reaches (outside the image)

# ---------------------------------------------------------------------------
# Kernel library (AcquireKernelBuiltIn / AcquireKernelInfo)
# ---------------------------------------------------------------------------

def _disk_kernel(radius: float) -> np.ndarray:
    r = int(math.floor(radius))
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    return ((ys * ys + xs * xs) <= radius * radius + 0.25).astype(np.float32)


def _diamond_kernel(radius: int) -> np.ndarray:
    r = radius
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    return ((np.abs(ys) + np.abs(xs)) <= r).astype(np.float32)


def _square_kernel(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    return np.ones((n, n), np.float32)


def _octagon_kernel(radius: int) -> np.ndarray:
    r = radius
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    return ((np.abs(ys) + np.abs(xs)) <= 1.5 * r).astype(np.float32)


def _plus_kernel(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    k = np.zeros((n, n), np.float32)
    k[radius, :] = 1.0
    k[:, radius] = 1.0
    return k


def _cross_kernel(radius: int) -> np.ndarray:
    n = 2 * radius + 1
    k = np.eye(n, dtype=np.float32)
    k = np.maximum(k, k[::-1])
    return k


def _ring_kernel(r1: float, r2: float) -> np.ndarray:
    lo, hi = min(r1, r2), max(r1, r2)
    r = int(math.floor(hi))
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    d2 = ys * ys + xs * xs
    return ((d2 <= hi * hi + 0.25) & (d2 >= lo * lo - 0.25)).astype(np.float32)


def _rectangle_kernel(w: int, h: int) -> np.ndarray:
    return np.ones((h, w), np.float32)


def _gaussian_kernel2d(radius: float, sigma: float) -> np.ndarray:
    from .blur import optimal_kernel_width_2d, _sigma_safe

    width = optimal_kernel_width_2d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    u = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(u[None, :] ** 2 + u[:, None] ** 2) / (2 * s * s))
    return (k / k.sum()).astype(np.float32)


def _log_kernel(radius: float, sigma: float) -> np.ndarray:
    """Laplacian-of-Gaussian (kernel.c LoGKernel)."""
    from .blur import optimal_kernel_width_2d, _sigma_safe

    width = optimal_kernel_width_2d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    u = np.arange(-j, j + 1, dtype=np.float64)
    r2 = u[None, :] ** 2 + u[:, None] ** 2
    k = ((r2 - 2 * s * s) / (s ** 4)) * np.exp(-r2 / (2 * s * s))
    k -= k.mean()
    return k.astype(np.float32)


def _dog_kernel(radius: float, s1: float, s2: float) -> np.ndarray:
    from .blur import optimal_kernel_width_2d

    width = max(optimal_kernel_width_2d(radius, max(s1, 1e-6)),
                optimal_kernel_width_2d(radius, max(s2, 1e-6)))
    j = (width - 1) // 2
    u = np.arange(-j, j + 1, dtype=np.float64)
    r2 = u[None, :] ** 2 + u[:, None] ** 2

    def g(s):
        if s < 1e-12:
            k = np.zeros_like(r2)
            k[j, j] = 1.0
            return k
        k = np.exp(-r2 / (2 * s * s)) / (2 * math.pi * s * s)
        return k / k.sum()

    return (g(s1) - g(s2)).astype(np.float32)


# Edge-detection convolution kernels (kernel.c builtins)
# edge-kernel orientations match AcquireKernelBuiltIn exactly (kernel.c;
# verified against the oracle's -define morphology:showkernel=1 dumps)
_SOBEL = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
_ROBERTS = np.array([[0, 0, 0], [1, -1, 0], [0, 0, 0]], np.float32)
_PREWITT = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float32)
_COMPASS = np.array([[1, 1, -1], [1, -2, -1], [1, 1, -1]], np.float32)
_KIRSCH = np.array([[5, -3, -3], [5, 0, -3], [5, -3, -3]], np.float32)
_LAPLACIAN = {
    0: np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float32),
    1: np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], np.float32),
    2: np.array([[-2, 1, -2], [1, 4, 1], [-2, 1, -2]], np.float32),
    3: np.array([[1, -2, 1], [-2, 4, -2], [1, -2, 1]], np.float32),
    5: np.array([[-4, 2, -4], [2, 8, 2], [-4, 2, -4]], np.float32) / 8.0,
    7: np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32),
}

# Hit-and-miss sets: 1=foreground, 0=background, nan=don't care.
# Bases + rotation steps match the oracle's showkernel dumps exactly
# (kernel.c AcquireKernelBuiltIn).
_NAN = float("nan")
_CORNERS = np.array([[_NAN, 1, _NAN], [0, _NAN, 1], [0, 0, _NAN]],
                    np.float32)                       # @90 x4
_LINE_ENDS = np.array([[0, 0, _NAN], [0, 1, 1], [0, 0, _NAN]],
                      np.float32)                     # @90 x4 (base 1)
_LINE_ENDS2 = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1]],
                       np.float32)                    # @90 x4 (base 2)
_LINE_JUNCTIONS = np.array([[1, _NAN, 1], [_NAN, 1, _NAN],
                            [_NAN, 1, _NAN]], np.float32)   # @45 x8 (Y)
_LINE_JUNCTIONS2 = np.array([[1, _NAN, _NAN], [_NAN, 1, _NAN],
                             [1, _NAN, 1]], np.float32)     # @90 x4 (T)
_EDGES = np.array([[0, _NAN, 1], [0, _NAN, 1], [0, _NAN, 1]],
                  np.float32)                         # @90 x4
# Peaks default: 7x7 — center 1 with a ring of 0s at d^2 in [8, 10]
# (transcribed from the oracle's showkernel dump)
_PEAKS = np.full((7, 7), _NAN, np.float32)
_PEAKS[3, 3] = 1.0
for _py in range(7):
    for _px in range(7):
        _d2 = (_py - 3) ** 2 + (_px - 3) ** 2
        if 8 <= _d2 <= 10:
            _PEAKS[_py, _px] = 0.0

# Distance metrics: (kernel offsets, costs)
_CHEBYSHEV = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)
_MANHATTAN = np.array([[2, 1, 2], [1, 0, 1], [2, 1, 2]], np.float32)
_EUCLIDEAN = np.array([[math.sqrt(2), 1, math.sqrt(2)],
                       [1, 0, 1],
                       [math.sqrt(2), 1, math.sqrt(2)]], np.float32)


def _expand_rot(base: np.ndarray, step45: int) -> list:
    """Rotation-list expansion: step45=1 gives 8 kernels at 45-degree
    increments, step45=2 gives 4 at 90 (kernel.c RotateKernelInfo; the
    per-kernel steps match the oracle's showkernel expansions)."""
    out = []
    cur = base
    n = 8 // step45
    for _ in range(n):
        out.append(cur)
        for _ in range(step45):
            cur = _rotate_kernel_45(cur)
    return out


def _rotate_kernel_45(k: np.ndarray) -> np.ndarray:
    """45° expansion step for '>' rotation lists (kernel.c RotateKernelInfo)."""
    assert k.shape == (3, 3)
    flat = [k[0, 0], k[0, 1], k[0, 2], k[1, 2], k[2, 2], k[2, 1], k[2, 0], k[1, 0]]
    rot = flat[-1:] + flat[:-1]
    out = k.copy()
    (out[0, 0], out[0, 1], out[0, 2], out[1, 2],
     out[2, 2], out[2, 1], out[2, 0], out[1, 0]) = rot
    return out


def get_kernel(spec: str) -> list:
    """AcquireKernelInfo analog: parse 'name[:args]' or explicit 'WxH:v,v,...'.

    Returns a list of kernels (rotation lists expand to multiple) as float32
    arrays; NaN entries mean 'don't care' (hit-and-miss).
    """
    spec = spec.strip()
    # explicit kernel "3x3: 0,1,0 1,-4,1 0,1,0" or "3x3:0,1,0,1,..."
    m = re.match(r"^(\d+)x(\d+)(?:([+-]\d+)([+-]\d+))?\s*:\s*(.*)$", spec)
    if m and ("," in m.group(5) or " " in m.group(5).strip()):
        w, h = int(m.group(1)), int(m.group(2))
        vals = [float("nan") if v.strip() in ("-", "nan") else float(v)
                for v in re.split(r"[,\s]+", m.group(5).strip()) if v != ""]
        return [np.asarray(vals, np.float32).reshape(h, w)]

    name, _, args_s = spec.partition(":")
    name = name.lower().strip()
    expand = name.endswith(">") or args_s.endswith(">")
    name = name.rstrip(">")
    args_s = args_s.rstrip(">")
    args = [float(x) for x in re.split(r"[x,;]", args_s) if x not in ("", "-")] if args_s else []

    def a(i, default):
        return args[i] if len(args) > i else default

    if name in ("unity",):
        k = [np.ones((1, 1), np.float32)]
    elif name == "gaussian":
        k = [_gaussian_kernel2d(a(0, 0.0), a(1, 1.0))]
    elif name == "log":
        k = [_log_kernel(a(0, 0.0), a(1, 1.0))]
    elif name == "dog":
        k = [_dog_kernel(a(0, 0.0), a(1, 1.0), a(2, 2.0))]
    elif name == "blur":
        from .blur import gaussian_kernel_1d

        k = [gaussian_kernel_1d(a(0, 0.0), a(1, 1.0)).reshape(1, -1)]
    elif name == "comet":
        from .blur import gaussian_kernel_1d

        k1 = gaussian_kernel_1d(a(0, 0.0), a(1, 1.0))
        half = k1[k1.shape[0] // 2:]
        k = [(half / half.sum()).reshape(1, -1)]
    elif name == "sobel":
        k = [_SOBEL]
    elif name == "roberts":
        k = [_ROBERTS]
    elif name == "prewitt":
        k = [_PREWITT]
    elif name == "compass":
        k = [_COMPASS]
    elif name == "kirsch":
        k = [_KIRSCH]
    elif name == "freichen":
        s2 = math.sqrt(2.0)
        k = [np.array([[1, 0, -1], [s2, 0, -s2], [1, 0, -1]], np.float32)]
    elif name == "laplacian":
        k = [_LAPLACIAN.get(int(a(0, 0)), _LAPLACIAN[0])]
    elif name == "diamond":
        k = [_diamond_kernel(int(a(0, 1)))]
    elif name == "square":
        k = [_square_kernel(int(a(0, 1)))]
    elif name == "octagon":
        k = [_octagon_kernel(int(a(0, 3)))]
    elif name == "disk":
        k = [_disk_kernel(a(0, 3.5))]
    elif name == "plus":
        k = [_plus_kernel(int(a(0, 2)))]
    elif name == "cross":
        k = [_cross_kernel(int(a(0, 2)))]
    elif name == "ring":
        k = [_ring_kernel(a(0, 1.0), a(1, 3.5))]
    elif name == "rectangle":
        k = [_rectangle_kernel(int(a(0, 3)), int(a(1, 3)))]
    elif name == "corners":
        return _expand_rot(_CORNERS, 2)
    elif name == "lineends":
        return _expand_rot(_LINE_ENDS, 2) + _expand_rot(_LINE_ENDS2, 2)
    elif name == "linejunctions":
        return _expand_rot(_LINE_JUNCTIONS, 1) + \
            _expand_rot(_LINE_JUNCTIONS2, 2)
    elif name == "edges":
        return _expand_rot(_EDGES, 2)
    elif name == "peaks":
        k = [_PEAKS]
    elif name in ("skeleton", "thinse"):
        # Skeleton = the Edges base rotated in 45-degree steps x8
        # (oracle showkernel: Skeleton@45..@315)
        return _expand_rot(_EDGES, 1)
    elif name == "chebyshev":
        k = [_CHEBYSHEV * (a(0, 100.0) / 100.0 if args else 0.01)]
    elif name == "manhattan":
        k = [_MANHATTAN * (a(0, 100.0) / 100.0 if args else 0.01)]
    elif name == "euclidean":
        k = [_EUCLIDEAN * (a(0, 100.0) / 100.0 if args else 0.01)]
    else:
        raise ValueError(f"unknown kernel {spec!r}")

    if expand:
        out = []
        for base in k:
            if base.shape == (3, 3):
                cur = base
                for _ in range(8):
                    out.append(cur)
                    cur = _rotate_kernel_45(cur)
                # dedupe
                dedup = []
                for kk in out:
                    if not any(np.array_equal(kk, d, equal_nan=True) for d in dedup):
                        dedup.append(kk)
                out = dedup
            else:
                out.append(base)
        k = out
    return k


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _shifted_views(img: torch.Tensor, kh: int, kw: int, virtual_pixel: str,
                   pad_value: Optional[float] = None):
    rh, rw = kh // 2, kw // 2
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    if pad_value is not None:
        xp = F.pad(x, (0, 0, rw, kw - 1 - rw, rh, kh - 1 - rh),
                   mode="constant", value=pad_value)
    else:
        xp = pad_spatial(x, (rh, kh - 1 - rh), (rw, kw - 1 - rw),
                         virtual_pixel)

    def view(dy, dx):
        return xp[:, dy:dy + h, dx:dx + w, :].reshape(lead + (h, w, c))

    return view


def erode(img: torch.Tensor, kernel: np.ndarray,
          virtual_pixel: str = "edge") -> torch.Tensor:
    """ErodeMorphology: min over the structuring element's support."""
    kh, kw = kernel.shape
    view = _shifted_views(img, kh, kw, virtual_pixel, pad_value=1.0)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if not np.isnan(kernel[dy, dx]) and kernel[dy, dx] > 0:
                v = view(dy, dx)
                out = v if out is None else torch.minimum(out, v)
    return img if out is None else out


def dilate(img: torch.Tensor, kernel: np.ndarray,
           virtual_pixel: str = "edge") -> torch.Tensor:
    """DilateMorphology: max over the (reflected) structuring element."""
    k = kernel[::-1, ::-1]
    kh, kw = k.shape
    view = _shifted_views(img, kh, kw, virtual_pixel, pad_value=0.0)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if not np.isnan(k[dy, dx]) and k[dy, dx] > 0:
                v = view(dy, dx)
                out = v if out is None else torch.maximum(out, v)
    return img if out is None else out


def convolve_kernel(img: torch.Tensor, kernel: np.ndarray,
                    normalize: bool = False, virtual_pixel: str = "edge",
                    bias: float = 0.0) -> torch.Tensor:
    """ConvolveMorphology: correlate with the reflected kernel."""
    from .blur import _depthwise_conv

    k = np.nan_to_num(np.asarray(kernel, np.float32))[::-1, ::-1]
    if normalize:
        s = k.sum()
        if abs(s) > 1e-12:
            k = k / s
    return _depthwise_conv(img, k, virtual_pixel) + bias


def correlate_kernel(img: torch.Tensor, kernel: np.ndarray,
                     virtual_pixel: str = "edge", bias: float = 0.0
                     ) -> torch.Tensor:
    from .blur import _depthwise_conv

    k = np.nan_to_num(np.asarray(kernel, np.float32))
    return _depthwise_conv(img, k, virtual_pixel) + bias


def hit_and_miss(img: torch.Tensor, kernel: np.ndarray,
                 virtual_pixel: str = "edge") -> torch.Tensor:
    """HitAndMissMorphology: min(fg) - max(bg), clamped at 0."""
    kh, kw = kernel.shape
    view = _shifted_views(img, kh, kw, virtual_pixel)
    fg = None
    bg = None
    for dy in range(kh):
        for dx in range(kw):
            v = kernel[dy, dx]
            if np.isnan(v):
                continue
            pix = view(dy, dx)
            if v > 0:
                fg = pix if fg is None else torch.minimum(fg, pix)
            else:
                bg = pix if bg is None else torch.maximum(bg, pix)
    if fg is None:
        fg = torch.ones_like(img)
    if bg is None:
        bg = torch.zeros_like(img)
    return torch.clamp(fg - bg, min=0.0)


def _distance_pass(img: torch.Tensor, costs: np.ndarray, reverse: bool
                   ) -> torch.Tensor:
    """One chamfer sweep (row scan) of the distance transform.

    MorphologyPrimitiveDirect (morphology.c:3242) does a raster sweep
    where each pixel takes min(self, neighbor+cost) over its visited
    neighbors.  Rows run in order: each row first takes the r rows of
    output above it (all dx), in float32 as the JAX package does, then
    its own left side.  The row costs are exact multiples,
    c(0,-k) = k·c(0,-1), for every distance metric, so the left side is
    d[i] = min_j cand[j] + (i-j)·c = min_j (cand[j] - j·c) + i·c: one
    cumulative minimum along the row, taken in float64 and rounded to
    float32 once.  The JAX package's associative min-plus scan rounds
    after each combine, so the two may differ by float32 ulps of the
    distances where a seed value is not an integer; with integer seeds
    and costs (a binary image under Chebyshev or Manhattan) they are
    equal."""
    r = costs.shape[0] // 2
    x = img.flip(-3, -2) if reverse else img
    c_left = float(costs[r, r - 1])
    w = x.shape[-2]
    taps = [(dy, dx, float(costs[r - dy, r + dx]))
            for dy in range(1, r + 1) for dx in range(-r, r + 1)
            if np.isfinite(costs[r - dy, r + dx])]
    k = torch.arange(w, dtype=torch.float64, device=x.device)[:, None] \
        * c_left
    # the r previous output rows, each padded with r columns of _BIG
    # either side, top to bottom
    row_shape = x.shape[:-3] + (w + 2 * r, x.shape[-1])
    prev = [torch.full(row_shape, _BIG, dtype=x.dtype, device=x.device)
            for _ in range(r)]
    pad = torch.full(x.shape[:-3] + (r, x.shape[-1]), _BIG, dtype=x.dtype,
                     device=x.device)
    rows = []
    for y in range(x.shape[-3]):
        cand = x[..., y, :, :]
        for dy, dx, c in taps:
            p = prev[r - dy]
            cand = torch.minimum(cand, p[..., r + dx:r + dx + w, :] + c)
        vals = (torch.cummin(cand.to(torch.float64) - k, dim=-2).values
                + k).to(x.dtype)
        rows.append(vals)
        prev = prev[1:] + [torch.cat([pad, vals, pad], dim=-2)]
    out = torch.stack(rows, dim=-3)
    return out.flip(-3, -2) if reverse else out


def distance_transform(img: torch.Tensor, metric: str = "euclidean",
                       scale: float = 0.01, radius: int = 1) -> torch.Tensor:
    """DistanceMorphology: distance from background (v==0) to each pixel.

    Two chamfer sweeps (forward + backward) reproduce the reference's
    iterate-until-converged raster passes exactly.  radius>1 builds the
    (2r+1)² kernel of kernel.c:2158 (values σ·metric(u,v)); the radius-1
    Euclidean chamfer is NOT equivalent to the radius-4 one the reference
    uses for "Euclidean:4" (knight's-move distances differ).  Each pixel
    starts at its own value over ``scale`` and the chamfer min-propagates
    value + step cost (grayscale seeding, MorphologyPrimitiveDirect): a
    binary image reduces to the classic distance from background."""
    m = metric.lower()
    if radius <= 1:
        costs = {"chebyshev": _CHEBYSHEV, "manhattan": _MANHATTAN,
                 "euclidean": _EUCLIDEAN}[m]
    else:
        uu, vv = np.meshgrid(np.arange(-radius, radius + 1),
                             np.arange(-radius, radius + 1))
        if m == "chebyshev":
            costs = np.maximum(np.abs(uu), np.abs(vv)).astype(np.float64)
        elif m == "manhattan":
            costs = (np.abs(uu) + np.abs(vv)).astype(np.float64)
        else:
            costs = np.sqrt(uu * uu + vv * vv)
    # a float32 divisor on the image's device: a true division there, as
    # the JAX package divides by jnp.float32(scale)
    s = torch.tensor(max(scale, 1e-12), dtype=img.dtype, device=img.device)
    d = img / s
    d = _distance_pass(d, costs, reverse=False)
    d = _distance_pass(d, costs, reverse=True)
    return torch.clamp(d * scale, 0.0, 1.0)


def _metric_from_spec(spec: str) -> str:
    name = spec.split(":")[0].lower()
    return name if name in ("chebyshev", "manhattan", "euclidean") \
        else "euclidean"


def _spec_args(spec: str) -> list:
    parts = spec.split(":")
    if len(parts) > 1:
        return [p for p in re.split(r"[x,]", parts[1]) if p]
    return []


def _radius_from_spec(spec: str) -> int:
    """Distance-kernel radius: kernel arg1 rho (kernel.c:2160; below 1
    means the default 3x3)."""
    args = _spec_args(spec)
    if args:
        try:
            rho = float(args[0])
        except ValueError:
            return 1
        if rho >= 1.0:
            return int(rho)
    return 1


def _scale_from_spec(spec: str) -> float:
    """Distance-kernel scale: kernel arg2, default 100 quantum units per
    pixel step (kernel.c Euclidean default; oracle: an 8x8 square's
    center reads distance*100 in Q16)."""
    args = _spec_args(spec)
    scale = float(args[1]) if len(args) > 1 else 100.0
    return scale / 65535.0


# ---------------------------------------------------------------------------
# MorphologyImage dispatcher
# ---------------------------------------------------------------------------

def morphology(img: torch.Tensor, method: str, kernel_spec: str,
               iterations: int = 1, virtual_pixel: str = "edge"
               ) -> torch.Tensor:
    """MorphologyImage (morphology.c:4129): method x kernel x iterations.

    iterations <= 0 ("until converged") repeats a round on the host while
    any pixel changed, exactly like the reference's convergence loop —
    bounded by H+W rounds as a safety net (a thinning front moves at least
    one pixel per round).  Each round's test reads one flag back from the
    device.
    """
    method = method.lower().replace("-", "").replace("_", "")
    kernels = get_kernel(kernel_spec)
    if method == "distance":
        return distance_transform(img, _metric_from_spec(kernel_spec),
                                  _scale_from_spec(kernel_spec),
                                  _radius_from_spec(kernel_spec))

    def apply_once(x, k):
        if method in ("convolve",):
            return convolve_kernel(x, k, virtual_pixel=virtual_pixel)
        if method in ("correlate",):
            return correlate_kernel(x, k, virtual_pixel=virtual_pixel)
        if method in ("erode", "erodeintensity"):
            return erode(x, k, virtual_pixel)
        if method in ("dilate", "dilateintensity"):
            return dilate(x, k, virtual_pixel)
        if method in ("open", "openintensity"):
            return dilate(erode(x, k, virtual_pixel), k, virtual_pixel)
        if method in ("close", "closeintensity"):
            return erode(dilate(x, k, virtual_pixel), k, virtual_pixel)
        if method in ("smooth",):
            o = dilate(erode(x, k, virtual_pixel), k, virtual_pixel)
            return erode(dilate(o, k, virtual_pixel), k, virtual_pixel)
        if method in ("edge",):
            return dilate(x, k, virtual_pixel) - erode(x, k, virtual_pixel)
        if method in ("edgein",):
            return x - erode(x, k, virtual_pixel)
        if method in ("edgeout",):
            return dilate(x, k, virtual_pixel) - x
        if method in ("tophat",):
            return x - dilate(erode(x, k, virtual_pixel), k, virtual_pixel)
        if method in ("bottomhat",):
            return erode(dilate(x, k, virtual_pixel), k, virtual_pixel) - x
        if method in ("hitandmiss", "hmt"):
            return hit_and_miss(x, k, virtual_pixel)
        if method in ("thinning",):
            return x - hit_and_miss(x, k, virtual_pixel)
        if method in ("thicken",):
            return x + hit_and_miss(x, k, virtual_pixel)
        raise ValueError(f"unknown morphology method {method!r}")

    def one_round(x):
        # multi-kernel composition (morphology.c:3729): HMT unions the
        # per-kernel results (Lighten); thinning/thicken/erode chains
        # re-iterate sequentially (NoComposite).  Every stage clamps to
        # [0,1] like the reference's per-write ClampToQuantum — without
        # it thinning's x - HMT goes negative at background pixels and
        # poisons later kernels.
        if method in ("hitandmiss", "hmt") and len(kernels) > 1:
            out_ = None
            for k in kernels:
                r_ = torch.clamp(apply_once(x, k), 0.0, 1.0)
                out_ = r_ if out_ is None else torch.maximum(out_, r_)
            return out_
        for k in kernels:
            x = torch.clamp(apply_once(x, k), 0.0, 1.0)
        return x

    out = img
    if iterations <= 0:
        # -1 = iterate until converged (morphology.c:4129 bounds by
        # convergence, not a constant); thinning/skeleton passes move the
        # boundary >=1 pixel per round, so H+W bounds any input, and the
        # counter also guards pathological oscillation
        for _ in range(int(img.shape[-3] + img.shape[-2])):
            nxt = one_round(out)
            changed = bool(torch.any(nxt != out))
            out = nxt
            if not changed:
                break
    else:
        for _ in range(iterations):
            out = one_round(out)
    return torch.clamp(out, 0.0, 1.0)
