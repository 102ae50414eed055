"""Statistics, evaluate/function ops, windowed rank filters (statistic.c).

Port of ``imagemagick_tpu/ops/statistic.py``, whole (the reference's
MagickCore/statistic.c):
  * GetImageStatistics — per-channel min/max/mean/σ/skewness/kurtosis/entropy
  * GetImageMoments — Hu invariant moments + ellipse params
  * GetImagePerceptualHash — phash over the Hu moments in two colorspaces
    (a float64 numpy pipeline on the host, copied)
  * EvaluateImage — 30+ scalar ops applied per pixel
  * FunctionImage — polynomial/sinusoid/arcsin/arctan
  * StatisticImage (:2918) — windowed min/max/mean/median/mode/gradient/
    nonpeak/rms/stddev rank filters over a stack of shifted views

Everything runs as PyTorch ops on the input's device.  Where the JAX
function takes a PRNG key (the noise operators of ``evaluate``) this one
takes a ``torch.Generator`` on that device; without one it seeds a new one
with 0 there.  Medians average the two middle values of an even count, as
``jnp.median`` does (``torch.median`` returns the lower one).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.virtual_pixel import pad_spatial


def _generator(img: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=img.device).manual_seed(0)
    return generator


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded float32 square root, as XLA's: taken in
    float64 and rounded.  The CPU's float32 ``torch.sqrt`` is an ulp off
    on some values, and has been seen off by about 2e-4 in the first
    calls of a few processes (``cpu_phase_probe.py --target sqrt``)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median`` along ``dim``: the sorted middle value, or the mean
    (a + b) * 0.5 of the two middle values of an even count."""
    n = x.shape[dim]
    srt = torch.sort(x, dim=dim).values
    lo = srt.select(dim, (n - 1) // 2)
    hi = srt.select(dim, n // 2)
    return (lo + hi) * 0.5


# ---------------------------------------------------------------------------
# Global statistics
# ---------------------------------------------------------------------------

def get_statistics(img: torch.Tensor, bins: int = 1024
                   ) -> Dict[str, torch.Tensor]:
    """GetImageStatistics: per-channel stats dict (statistic.c)."""
    from .histogram import _histogram_fixed

    axes = tuple(range(img.dim() - 1))
    mean = img.mean(dim=axes)
    mn = img.amin(dim=axes)
    mx = img.amax(dim=axes)
    centered = img - mean
    var = (centered ** 2).mean(dim=axes)
    std = torch.sqrt(var)
    safe = torch.where(std < 1e-12, 1.0, std)
    # constant channels report 0 skewness/kurtosis (statistic.c:2581
    # guards the standard_deviation==0 division)
    skew = torch.where(std < 1e-12, 0.0,
                       (centered ** 3).mean(dim=axes) / safe ** 3)
    kurt = torch.where(std < 1e-12, 0.0,
                       (centered ** 4).mean(dim=axes) / safe ** 4 - 3.0)
    # entropy (statistic.c:2248-2266): per-channel histogram over
    # MaxMap+1 = 65536 quantum bins, normalized by log(count of NONZERO
    # bins) for that channel
    ents = []
    n = img[..., 0].numel()
    for c in range(img.shape[-1]):
        hist = _histogram_fixed(img[..., c], 65536)
        p = hist / n
        nbins = (hist > 0).to(torch.float32).sum()
        log_nbins = torch.log(nbins.clamp(min=1.0))
        ents.append(-torch.where(p > 0, p * torch.log(p.clamp(min=1e-30)),
                                 0.0).sum() / log_nbins.clamp(min=1e-30))
    return {
        "min": mn, "max": mx, "mean": mean, "std": std,
        "variance": var, "skewness": skew, "kurtosis": kurt,
        "entropy": torch.stack(ents),
        "sum": img.sum(dim=axes),
    }


def get_moments(img, xp=torch) -> Dict[str, object]:
    """GetImageMoments: centroid, ellipse params, Hu invariants I1..I8.

    Pass ``xp=numpy`` (with a host ndarray) for float64 moments — the
    reference accumulates in double, and the higher invariants lose
    ~2 decimals in float32 (visible in perceptual-hash distortions)."""
    h, w = img.shape[-3], img.shape[-2]
    if xp is np:
        yy = np.arange(h, dtype=np.float64)[:, None, None]
        xx = np.arange(w, dtype=np.float64)[None, :, None]
    else:
        yy = torch.arange(h, dtype=torch.float32,
                          device=img.device)[:, None, None]
        xx = torch.arange(w, dtype=torch.float32,
                          device=img.device)[None, :, None]
    m00 = img.sum((-3, -2))
    safe = xp.where(m00 < 1e-12, 1.0, m00)
    cx = (img * xx).sum((-3, -2)) / safe
    cy = (img * yy).sum((-3, -2)) / safe

    def mu(p, q):
        dx = xx - cx[..., None, None, :] if cx.ndim > 1 else xx - cx
        dy = yy - cy[..., None, None, :] if cy.ndim > 1 else yy - cy
        return (img * dx ** p * dy ** q).sum((-3, -2))

    def n(p, q):
        return mu(p, q) / safe ** ((p + q) / 2.0 + 1.0)

    n20, n02, n11 = n(2, 0), n(0, 2), n(1, 1)
    n30, n03, n21, n12 = n(3, 0), n(0, 3), n(2, 1), n(1, 2)
    i1 = n20 + n02
    i2 = (n20 - n02) ** 2 + 4 * n11 ** 2
    i3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    i4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    i5 = ((n30 - 3 * n12) * (n30 + n12) *
          ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) +
          (3 * n21 - n03) * (n21 + n03) *
          (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2))
    i6 = ((n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) +
          4 * n11 * (n30 + n12) * (n21 + n03))
    i7 = ((3 * n21 - n03) * (n30 + n12) *
          ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) -
          (n30 - 3 * n12) * (n21 + n03) *
          (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2))
    i8 = (n11 * ((n30 + n12) ** 2 - (n03 + n21) ** 2) -
          (n20 - n02) * (n30 + n12) * (n03 + n21))
    return {
        "centroid": (cx, cy),
        "invariants": xp.stack([i1, i2, i3, i4, i5, i6, i7, i8]),
        "m00": m00,
    }


def perceptual_hash(img: torch.Tensor) -> torch.Tensor:
    """GetImagePerceptualHash (statistic.c:1745): per colorspace in
    {xyY, HSB}, BlurImage(sigma=1) -> colorspace transform -> Hu
    invariants per channel -> -MagickLog10 = -log10(max(|I|, 1e-12)).
    Runs in float64 on the host; returns (2, 8, C) float32 on the
    image's device, as the JAX function returns float32."""
    rgb = img[..., :3].detach().cpu().numpy().astype(np.float64)
    return torch.as_tensor(_phash_host(rgb), dtype=torch.float32,
                           device=img.device)


def _phash_host(rgb: np.ndarray) -> np.ndarray:
    """Float64 host pipeline for the perceptual hash: rank-3 gaussian
    blur (sigma 1, edge virtual pixels) -> xyY / HSB -> Hu moments.
    The reference runs this whole chain in doubles; in float32 the
    higher-order HSB invariants (hue is chaotic on near-gray pixels)
    lose enough precision to triple the PHASH compare distortion."""
    from .blur import gaussian_kernel_1d

    k = gaussian_kernel_1d(0.0, 1.0).astype(np.float64)
    k /= k.sum()
    w = len(k) // 2
    x = np.pad(rgb, [(w, w), (0, 0), (0, 0)], mode="edge")
    x = np.einsum("t,thwc->hwc", k,
                  np.stack([x[i:i + rgb.shape[0]] for i in range(len(k))]))
    x = np.pad(x, [(0, 0), (w, w), (0, 0)], mode="edge")
    x = np.einsum("t,htwc->hwc", k,
                  np.stack([x[:, i:i + rgb.shape[1]] for i in range(len(k))],
                           axis=1))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def prec(v):
        s = np.where(v < 0, -1.0, 1.0)
        return s / np.maximum(np.abs(v), 1e-12)

    # xyY (colorspace.c xyYColorspace: sRGB decompand -> XYZ -> chromaticity)
    lin = np.where(x <= 0.0404482362771076, x / 12.92,
                   ((x + 0.055) / 1.055) ** 2.4)
    m = np.array([[0.4123955889674142161, 0.3575834307637148171,
                   0.1804926473817015735],
                  [0.2125862307855955516, 0.7151703037034108499,
                   0.07220049864333622685],
                  [0.01929721549174694484, 0.1191838645808485318,
                   0.9504971251315797660]])
    xyz = lin @ m.T
    s = prec(xyz.sum(-1))
    xyy = np.stack([s * xyz[..., 0], s * xyz[..., 1], xyz[..., 1]], -1)
    # HSB (gem.c ConvertRGBToHSB semantics)
    mx = x.max(-1)
    c = mx - x.min(-1)
    cr = prec(c)
    h = np.where(mx == r, (g - b) * cr % 6.0,
                 np.where(mx == g, (b - r) * cr + 2.0, (r - g) * cr + 4.0))
    h = np.where(c <= 0.0, 0.0, h / 6.0)
    sat = np.where(c <= 0.0, 0.0, c * prec(mx))
    hsb = np.stack([h, sat, mx], -1)
    out = []
    for conv in (xyy, hsb):
        mom = get_moments(conv, xp=np)["invariants"]  # (8, C) f64
        out.append(-np.log10(np.maximum(np.abs(mom), 1e-12)))
    return np.stack(out)


def phash_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ha, hb = perceptual_hash(a), perceptual_hash(b)
    return ((ha - hb) ** 2).sum()


# ---------------------------------------------------------------------------
# EvaluateImage / FunctionImage
# ---------------------------------------------------------------------------

def evaluate(img: torch.Tensor, operator: str, value: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """EvaluateImage (statistic.c:255-447 ApplyEvaluateOperator).

    The reference evaluates in quantum units (Q16: 0..65535) with the
    operator constant parsed by StringToDoubleInterval(QuantumRange+1) —
    raw numbers are quantum counts, percents are fractions of 65536.
    ``value`` IS that quantum-domain constant; pixels stay normalized
    here, so additive constants are divided by QuantumRange while
    scale-like uses stay raw.  HDRI means no post-op clamp.  The noise
    operators draw from ``generator``."""
    op = operator.lower().replace("-", "").replace("_", "")
    QR = 65535.0
    vq = float(value)    # reference quantum-domain constant
    v = vq / QR          # normalized equivalent
    dev = img.device
    if op == "abs":
        return (img + v).abs()
    if op in ("add", "sum"):
        return img + v
    if op == "addmodulus":
        # floored modulus over QuantumRange+1 (statistic.c:264)
        r = img * QR + vq
        r = r - 65536.0 * torch.floor(r / 65536.0)
        return r / QR
    if op in ("and", "or", "xor"):
        # (ssize_t)pixel OP (ssize_t)(value+0.5) in quantum units
        p = torch.trunc(img * QR).to(torch.int32)
        c = int(vq + 0.5)
        q = (p & c) if op == "and" else (p | c) if op == "or" else (p ^ c)
        return q.to(img.dtype) / QR
    if op == "cosine" or op == "cos":
        return 0.5 + 0.5 * torch.cos(2.0 * math.pi * img * vq)
    if op == "divide":
        return img / (vq if vq != 0 else 1.0)
    if op == "exponential" or op == "exp":
        # QuantumRange*exp(value*QuantumScale*pixel) (statistic.c:293)
        return torch.exp(vq * img)
    if op == "gaussiannoise":
        return img + vq * 0.1 * torch.randn(
            img.shape, generator=_generator(img, generator), device=dev)
    if op == "impulsenoise":
        u = torch.rand(img.shape, generator=_generator(img, generator),
                       device=dev)
        salt = u > 1.0 - 0.5 * vq * 0.05
        pepper = u < 0.5 * vq * 0.05
        return torch.where(salt, 1.0, torch.where(pepper, 0.0, img))
    if op == "uniformnoise":
        return img + vq * 0.1 * (torch.rand(
            img.shape, generator=_generator(img, generator),
            device=dev) - 0.5)
    if op == "laplaciannoise":
        u = torch.rand(img.shape, generator=_generator(img, generator),
                       device=dev) - 0.5
        return img + vq * 0.1 * (-torch.sign(u) *
                                 torch.log(1.0 - 2.0 * u.abs()) / 2.0)
    if op == "poissonnoise":
        lam = torch.clamp(img * 50.0 * max(vq, 1e-3), min=1e-6)
        return torch.poisson(lam, generator=_generator(img, generator)) / \
            (50.0 * max(vq, 1e-3))
    if op == "multiplicativenoise":
        return img * (1.0 + vq * 0.1 * torch.randn(
            img.shape, generator=_generator(img, generator), device=dev))
    if op == "leftshift":
        return img * (2.0 ** int(vq))
    if op == "rightshift":
        return img / (2.0 ** int(vq))
    if op == "log":
        # QR*log(QuantumScale*value*pixel+1)/log(value+1), gated on
        # pixel >= MagickEpsilon (statistic.c:329); result init 0 (:249)
        if vq <= -1.0 or vq == 0.0:
            return img
        r = torch.log(vq * img + 1.0) / math.log(vq + 1.0)
        return torch.where(img >= 1e-12, r, 0.0)
    if op == "max":
        return img.clamp(min=v)
    if op == "min":
        return img.clamp(max=v)
    if op == "mean":
        # single-image form: (pixel+value)/2 (statistic.c:917-918)
        return (img + v) / 2.0
    if op == "median":
        return img + v
    if op == "multiply":
        return img * vq
    if op == "pow":
        # sign-preserving for negative HDRI pixels with fractional
        # exponents (statistic.c:376-384)
        if abs(vq) <= 1e-12:
            return torch.zeros_like(img)  # early break leaves result=0
        mag = torch.pow(img.abs(), vq)
        if abs(vq - round(vq)) > 1e-12:
            return torch.where(img < 0.0, -mag, mag)
        sgn = -1.0 if int(round(vq)) % 2 else 1.0
        return torch.where(img < 0.0, sgn * mag, mag)
    if op in ("rootmeansquare", "rms"):
        # literally pixel^2+value in quantum units (statistic.c:396)
        p = img * QR
        return (p * p + vq) / QR
    if op == "sine" or op == "sin":
        return 0.5 + 0.5 * torch.sin(2.0 * math.pi * img * vq)
    if op == "subtract":
        return img - v
    if op == "set":
        return torch.full_like(img, v)
    if op == "thresholdblack":
        return torch.where(img <= v, 0.0, img)
    if op == "thresholdwhite":
        return torch.where(img > v, 1.0, img)
    if op == "threshold":
        return (img > v).to(img.dtype)
    if op == "inverselog":
        # QR*pow(value+1, QuantumScale*pixel-1)*PerceptibleReciprocal(value)
        # (statistic.c:310)
        recip = (1.0 / vq if abs(vq) >= 1e-12
                 else (1e12 if vq >= 0 else -1e12))
        return torch.pow(vq + 1.0, img - 1.0) * recip
    raise ValueError(f"unknown evaluate operator {operator!r}")


def _bitwise_images(imgs: torch.Tensor, op: str) -> torch.Tensor:
    q = (imgs * 65535).to(torch.int32)
    out = q[0]
    for i in range(1, q.shape[0]):
        out = out & q[i] if op == "and" else \
            out | q[i] if op == "or" else out ^ q[i]
    return out.to(imgs.dtype) / 65535.0


def evaluate_images(imgs: torch.Tensor, operator: str) -> torch.Tensor:
    """EvaluateImages: reduce an (N, H, W, C) stack (statistic.c)."""
    op = operator.lower()
    if op == "mean":
        return imgs.mean(dim=0)
    if op == "max":
        return imgs.amax(dim=0)
    if op == "min":
        return imgs.amin(dim=0)
    if op == "sum" or op == "add":
        return imgs.sum(dim=0)
    if op == "median":
        return _median(imgs, 0)
    if op == "multiply":
        return imgs.prod(dim=0)
    if op in ("and", "or", "xor"):
        return _bitwise_images(imgs, op)
    if op == "rms":
        return _sqrt((imgs ** 2).mean(dim=0))
    raise ValueError(f"unknown evaluate-sequence operator {operator!r}")


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for a Python int y by repeated squaring, in the order of
    ``lax.integer_pow`` (what ``jnp.power`` runs for an int exponent)."""
    if y == 0:
        return torch.ones_like(x)
    recip = y < 0
    y = -y if recip else y
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def function(img: torch.Tensor, func: str, params: Sequence[float]
             ) -> torch.Tensor:
    """FunctionImage (statistic.c FunctionOptions)."""
    f = func.lower()
    p = list(params)
    if f == "polynomial":
        out = torch.zeros_like(img)
        n = len(p)
        for i, coeff in enumerate(p):
            out = out + coeff * _integer_pow(img, n - 1 - i)
        return out
    if f == "sinusoid":
        freq = p[0] if len(p) > 0 else 1.0
        phase = p[1] if len(p) > 1 else 0.0
        amp = p[2] if len(p) > 2 else 0.5
        bias = p[3] if len(p) > 3 else 0.5
        return amp * torch.sin(2.0 * math.pi * (freq * img + phase / 360.0)) \
            + bias
    if f == "arcsin":
        width = p[0] if len(p) > 0 else 1.0
        center = p[1] if len(p) > 1 else 0.5
        rng = p[2] if len(p) > 2 else 1.0
        bias = p[3] if len(p) > 3 else 0.5
        arg = (2.0 / width * (img - center)).clamp(-1.0, 1.0)
        return rng / math.pi * torch.asin(arg) + bias
    if f == "arctan":
        slope = p[0] if len(p) > 0 else 1.0
        center = p[1] if len(p) > 1 else 0.5
        rng = p[2] if len(p) > 2 else 1.0
        bias = p[3] if len(p) > 3 else 0.5
        # result = range/π · atan(π·slope·(x-center)) + bias (statistic.c)
        return rng / math.pi * torch.atan(
            math.pi * slope * (img - center)) + bias
    raise ValueError(f"unknown function {func!r}")


def polynomial_images(imgs: Sequence[torch.Tensor],
                      terms: Sequence[Tuple[float, float]]) -> torch.Tensor:
    """PolynomialImage: sum_i w_i * img_i ^ e_i (statistic.c)."""
    out = None
    for img, (wgt, expo) in zip(imgs, terms):
        term = wgt * (_integer_pow(img, expo) if isinstance(expo, int)
                      else torch.pow(img, expo))
        out = term if out is None else out + term
    return out.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Windowed statistic (rank) filters — StatisticImage (statistic.c:2918)
# ---------------------------------------------------------------------------

def _window_stack(img: torch.Tensor, width: int, height: int,
                  virtual_pixel: str = "edge") -> torch.Tensor:
    """Stack all window shifts: returns (k, ..., H, W, C) with k = w*h."""
    rh, rw = height // 2, width // 2
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    xp = pad_spatial(x, (rh, height - 1 - rh), (rw, width - 1 - rw),
                     virtual_pixel)
    views = [xp[:, dy:dy + h, dx:dx + w, :]
             for dy in range(height) for dx in range(width)]
    return torch.stack(views, 0).reshape((height * width,) + lead +
                                         (h, w, c))


def _mode64(stack: torch.Tensor) -> torch.Tensor:
    """The densest of 64 levels over the window axis, the lowest level
    among ties (``argmax``'s first maximum), counted pairwise over the
    window's own levels instead of one-hot over all 64."""
    q = (stack * 63 + 0.5).to(torch.int32).clamp(0, 63)
    best = None
    for i in range(q.shape[0]):
        count = (q == q[i]).sum(dim=0, dtype=torch.int32)
        key = count * 64 + (63 - q[i])
        best = key if best is None else torch.maximum(best, key)
    return (63 - best % 64).to(stack.dtype) / 63.0


def statistic(img: torch.Tensor, stat: str, width: int = 3, height: int = 3,
              virtual_pixel: str = "edge") -> torch.Tensor:
    """StatisticImage: windowed rank/statistic filter."""
    s = stat.lower()
    if s == "mean":
        from .blur import _depthwise_conv

        box = np.ones((height, width), np.float32) / float(width * height)
        return _depthwise_conv(img, box, virtual_pixel)
    stack = _window_stack(img, width, height, virtual_pixel)
    if s == "minimum" or s == "min":
        return stack.amin(dim=0)
    if s == "maximum" or s == "max":
        return stack.amax(dim=0)
    if s == "median":
        return _median(stack, 0)
    if s == "gradient":
        return stack.amax(dim=0) - stack.amin(dim=0)
    if s == "rootmeansquare" or s == "rms":
        return _sqrt((stack ** 2).mean(dim=0))
    if s == "standarddeviation" or s == "stddev":
        centered = stack - stack.mean(dim=0)
        return _sqrt((centered * centered).mean(dim=0))
    if s == "nonpeak":
        srt = torch.sort(stack, dim=0).values
        lo, mid, hi = srt[0], srt[srt.shape[0] // 2], srt[-1]
        return torch.where((img == lo) | (img == hi), mid, img)
    if s == "mode":
        return _mode64(stack)
    if s == "contrast":
        mx = stack.amax(dim=0)
        mn = stack.amin(dim=0)
        return (mx - mn) / (mx + mn).clamp(min=1e-12)
    raise ValueError(f"unknown statistic {stat!r}")


def median_filter(img: torch.Tensor, radius: int = 1) -> torch.Tensor:
    w = 2 * radius + 1
    return statistic(img, "median", w, w)
