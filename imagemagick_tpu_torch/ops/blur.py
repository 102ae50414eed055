"""Blur, sharpen and convolution effects (the effect.c op family).

Port of ``imagemagick_tpu/ops/blur.py``, whole.  Each effect is a function
over an (..., H, W, C) float32 tensor on the tensor's own device.  The
kernel-width rules and kernel tables are numpy, copied from the JAX
package:
  * GetOptimalKernelWidth1D/2D (MagickCore/gem.c:262-330)
  * the "blur:" 1-D kernel (morphology.c:1140 BlurKernel)
  * GaussianBlurImage (effect.c:1709) as two separable passes
  * the 2-D sharpen kernel: negated Gaussian, center = -2*sum
    (SharpenImage, effect.c:4070-4140)
  * UnsharpMaskImage (effect.c:4256) over BlurImage
  * Edge/Emboss, the adaptive pair, motion, rotational, selective and
    bilateral blurs, despeckle, spread, shade, Kuwahara, local contrast

``_separable_conv`` runs kernel K3 (``gpu_kernels.separable_blur``) for an
odd kernel of at most 33 taps with edge padding, the envelope of the TPU
path, on at most 8 channels (K3's shared memory); other cases take the two
`_depthwise_conv` passes.  On a card K3 carries the blurs of ``blur``,
``gaussian_blur`` and ``unsharp_mask``, the edge map of the adaptive pair,
Kuwahara's pre-blur, and ``local_contrast``'s blur up to 33 taps.  The
other effects are PyTorch ops; the tap loops of the selective, bilateral
and rotational blurs launch a few ops a tap.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.virtual_pixel import pad_spatial
from . import gpu_kernels

_EPSILON = 1.0e-15
_QUANTUM_SCALE = 1.0 / 65535.0  # Q16 QuantumScale; bounds kernel support


def _sigma_safe(sigma: float) -> float:
    return abs(sigma) if abs(sigma) >= _EPSILON else _EPSILON


@lru_cache(maxsize=256)
def optimal_kernel_width_1d(radius: float, sigma: float) -> int:
    """GetOptimalKernelWidth1D (MagickCore/gem.c:262)."""
    if radius > _EPSILON:
        return int(2.0 * math.ceil(radius) + 1.0)
    gamma = abs(sigma)
    if gamma <= _EPSILON:
        return 3
    alpha = 1.0 / (2.0 * gamma * gamma)
    beta = 1.0 / (math.sqrt(2.0 * math.pi) * gamma)
    width = 5
    while True:
        j = (width - 1) // 2
        xs = np.arange(-j, j + 1, dtype=np.float64)
        normalize = float(np.sum(np.exp(-xs * xs * alpha) * beta))
        value = math.exp(-float(j * j) * alpha) * beta / normalize
        if value < _QUANTUM_SCALE or value < _EPSILON:
            break
        width += 2
    return width - 2


@lru_cache(maxsize=256)
def optimal_kernel_width_2d(radius: float, sigma: float) -> int:
    """GetOptimalKernelWidth2D (MagickCore/gem.c:302)."""
    if radius > _EPSILON:
        return int(2.0 * math.ceil(radius) + 1.0)
    gamma = abs(sigma)
    if gamma <= _EPSILON:
        return 3
    alpha = 1.0 / (2.0 * gamma * gamma)
    beta = 1.0 / (2.0 * math.pi * gamma * gamma)
    width = 5
    while True:
        j = (width - 1) // 2
        us = np.arange(-j, j + 1, dtype=np.float64)
        r2 = us[:, None] ** 2 + us[None, :] ** 2
        normalize = float(np.sum(np.exp(-r2 * alpha) * beta))
        value = math.exp(-float(j * j) * alpha) * beta / normalize
        if value < _QUANTUM_SCALE or value < _EPSILON:
            break
        width += 2
    return width - 2


@lru_cache(maxsize=256)
def gaussian_kernel_1d(radius: float, sigma: float) -> np.ndarray:
    """The reference's "blur:" builtin 1-D kernel
    (MagickCore/morphology.c:1140 BlurKernel): the Gaussian is evaluated at
    KernelRank=3 supersampling (sigma*3, 3x the taps) and binned into the
    output taps, then sum-normalized — NOT a directly sampled Gaussian.
    Width: radius>=1 truncates (2*int(r)+1); otherwise
    GetOptimalKernelWidth1D."""
    if radius >= 1.0:
        width = 2 * int(radius) + 1
    else:
        width = optimal_kernel_width_1d(radius, sigma)
    s = abs(sigma)
    k = np.zeros(width, np.float64)
    if s > 1e-12:
        rank = 3
        v = (width * rank - 1) // 2
        s3 = s * rank
        u = np.arange(-v, v + 1, dtype=np.float64)
        samples = np.exp(-(u * u) / (2.0 * s3 * s3)) / (math.sqrt(2.0 * math.pi) * s3)
        np.add.at(k, ((u + v) // rank).astype(np.int64), samples)
    else:
        k[(width - 1) // 2] = 1.0
    k /= k.sum()
    return k.astype(np.float32)


# ---------------------------------------------------------------------------
# Generic convolution
# ---------------------------------------------------------------------------

def _depthwise_conv(img: torch.Tensor, kernel, virtual_pixel: str = "edge"
                    ) -> torch.Tensor:
    """Depthwise 2-D correlation with virtual-pixel padding.

    img: (..., H, W, C); kernel: (kh, kw) host array applied to every
    channel.  Straight correlation, matching -convolve semantics.  Small
    kernels are a sum of shifted slices, taps in row-major order (the
    JAX package's order); larger ones a grouped convolution.
    """
    knp = np.asarray(kernel, np.float64)
    kh, kw = knp.shape
    ph, pw = kh // 2, kw // 2
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    x = pad_spatial(x, (ph, kh - 1 - ph), (pw, kw - 1 - pw), virtual_pixel)
    if kh * kw <= 49:
        out = None
        for dy in range(kh):
            for dx in range(kw):
                wgt = float(knp[dy, dx])
                if wgt == 0.0:
                    continue
                term = wgt * x[:, dy:dy + h, dx:dx + w, :]
                out = term if out is None else out + term
        if out is None:
            out = torch.zeros_like(x[:, :h, :w, :])
        return out.reshape(lead + out.shape[1:])
    k = torch.as_tensor(knp, dtype=img.dtype, device=img.device)
    weight = k[None, None].expand(c, 1, kh, kw)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
    return out.permute(0, 2, 3, 1).reshape(lead + (h, w, c))


def _separable_conv(img: torch.Tensor, k1d, virtual_pixel: str = "edge"
                    ) -> torch.Tensor:
    """Two-pass separable depthwise convolution (rows then columns).

    With edge padding, an odd kernel of at most 33 taps and at most 8
    channels this is kernel K3 (one launch, both passes in shared memory);
    otherwise, and for an empty batch, two `_depthwise_conv` passes.
    """
    k = np.asarray(k1d, dtype=np.float32)
    if (virtual_pixel == "edge" and len(k) % 2 == 1 and img.numel() > 0 and
            1 < len(k) <= gpu_kernels.K3_MAX_TAPS and
            img.ndim in (3, 4) and img.dtype == torch.float32 and
            img.shape[-1] <= gpu_kernels.K3_MAX_CHANNELS):
        x4 = (img if img.ndim == 4 else img[None]).contiguous()
        out = gpu_kernels.separable_blur(x4, k)
        return out if img.ndim == 4 else out[0]
    out = _depthwise_conv(img, k.reshape(1, -1), virtual_pixel)
    return _depthwise_conv(out, k.reshape(-1, 1), virtual_pixel)


def convolve(img: torch.Tensor, kernel, bias: float = 0.0,
             normalize: bool = False, virtual_pixel: str = "edge"
             ) -> torch.Tensor:
    """ConvolveImage (effect.c): correlate with an arbitrary 2-D kernel."""
    k = np.asarray(kernel, dtype=np.float32)
    if normalize:
        s = k.sum()
        if abs(s) > 1e-12:
            k = k / s
    out = _depthwise_conv(img, k, virtual_pixel) + bias
    return out.clamp(0.0, 1.0)


def edge_image(img: torch.Tensor, radius: float = 0.0,
               virtual_pixel: str = "edge") -> torch.Tensor:
    """EdgeImage (effect.c): convolve with flat -1 kernel, center = w*h-1."""
    width = optimal_kernel_width_1d(radius, 0.5)
    k = -np.ones((width, width), dtype=np.float32)
    k[(width - 1) // 2, (width - 1) // 2] = float(width * width) - 1.0
    return _depthwise_conv(img, k, virtual_pixel).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# The effect family (slice subset)
# ---------------------------------------------------------------------------

def blur(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
         virtual_pixel: str = "edge") -> torch.Tensor:
    """BlurImage (MagickCore/effect.c:765): separable Gaussian."""
    if abs(sigma) < _EPSILON:
        return img
    k = gaussian_kernel_1d(radius, sigma)
    return _separable_conv(img, k, virtual_pixel).clamp(0.0, 1.0)


def gaussian_blur(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                  virtual_pixel: str = "edge") -> torch.Tensor:
    """GaussianBlurImage (effect.c:1709).

    The reference builds a full 2-D "gaussian:" kernel; a Gaussian is
    separable, so under edge-replicating pads the two-pass form is
    identical.
    """
    if abs(sigma) < _EPSILON:
        return img
    return _separable_conv(img, gaussian_blur_taps(radius, sigma),
                           virtual_pixel).clamp(0.0, 1.0)


def gaussian_blur_taps(radius: float, sigma: float) -> np.ndarray:
    """The 1-D taps of ``gaussian_blur``'s two passes: the sampled,
    sum-normalized Gaussian of GetOptimalKernelWidth2D's width."""
    width = optimal_kernel_width_2d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * s * s))
    k /= k.sum()
    return k.astype(np.float32)


def unsharp_mask(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                 gain: float = 1.0, threshold: float = 0.05,
                 virtual_pixel: str = "edge") -> torch.Tensor:
    """UnsharpMaskImage (effect.c:4256): where |2 diff| reaches the
    threshold, add gain times the difference from the blur."""
    blurred = blur(img, radius, sigma, virtual_pixel)
    diff = img - blurred
    out = torch.where((2.0 * diff).abs() < threshold, img, img + gain * diff)
    return out.clamp(0.0, 1.0)


@lru_cache(maxsize=128)
def _sharpen_kernel(radius: float, sigma: float) -> np.ndarray:
    """SharpenImage kernel (effect.c:4070-4140): -Gaussian, center=-2*sum."""
    width = optimal_kernel_width_2d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    us = np.arange(-j, j + 1, dtype=np.float64)
    r2 = us[None, :] ** 2 + us[:, None] ** 2
    k = -np.exp(-r2 / (2.0 * s * s)) / (2.0 * math.pi * s * s)
    total = k.sum()
    k[j, j] = -2.0 * total
    k /= k.sum()
    return k.astype(np.float32)


def sharpen(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
            virtual_pixel: str = "edge") -> torch.Tensor:
    """SharpenImage (effect.c:4070).  The kernel is 2-D and not
    separable: a sum of shifted slices up to 49 taps, a grouped
    convolution above."""
    return _depthwise_conv(img, _sharpen_kernel(radius, sigma),
                           virtual_pixel).clamp(0.0, 1.0)


def _auto_level(x: torch.Tensor) -> torch.Tensor:
    """The adaptive pair's AutoLevel: ONE min and max over the whole
    tensor, a batch included (the JAX function's coupling)."""
    lo, hi = x.amin(), x.amax()
    return (x - lo) / torch.clamp(hi - lo, min=1e-30)


def _adaptive_apply(img: torch.Tensor, radius: float, sigma: float,
                    virtual_pixel: str, sharp: bool) -> torch.Tensor:
    """Shared AdaptiveBlur/AdaptiveSharpen machinery (effect.c:118/400).

    edge = AutoLevel(Blur(AutoLevel(EdgeImage(img, radius)))); per pixel
    j = ceil(width*(1 - Rec709luma(edge)) - 0.5) clamped to [0, width]
    and rounded down to even selects the (width-j)^2 kernel of a stack
    built at every even truncation; each kernel is normalized by its own
    sum (gamma=PerceptibleReciprocal(sum k)).  Blur kernels are Gaussians
    with the residual 1-sum added to the center (effect.c:232); sharpen
    kernels are negated Gaussians with the center REPLACED by -2*sum
    (effect.c:551).  The reference build is HDRI, so nothing clips; the
    edge map's blur is K3 on a card.  Each kernel's result replaces the
    output where its level is selected, so at most the output and one
    result are held at once."""
    if abs(sigma) < _EPSILON:
        return img
    width = optimal_kernel_width_2d(radius, sigma)
    ewidth = optimal_kernel_width_1d(radius, 0.5)
    ek = -np.ones((ewidth, ewidth), np.float32)
    ek[(ewidth - 1) // 2, (ewidth - 1) // 2] = float(ewidth * ewidth) - 1.0
    edge = _auto_level(_depthwise_conv(img, ek, virtual_pixel))
    edge = _separable_conv(edge, gaussian_kernel_1d(radius, sigma),
                           virtual_pixel)
    edge = _auto_level(edge)
    i = (0.212656 * edge[..., 0] + 0.715158 * edge[..., 1] +
         0.072186 * edge[..., 2]) if edge.shape[-1] >= 3 else edge[..., 0]
    j = torch.ceil(width * (1.0 - i) - 0.5).to(torch.int32)
    j = j.clamp(0, width)
    level = ((j - (j & 1)) // 2)[..., None]
    s = _sigma_safe(sigma)
    out = None
    for n_idx, w in enumerate(range(0, width, 2)):
        n = width - w
        half = (n - 1) // 2
        u = np.arange(-half, half + 1, dtype=np.float64)
        g = np.exp(-(u[:, None] ** 2 + u[None, :] ** 2) / (2.0 * s * s)) \
            / (2.0 * np.pi * s * s)
        if sharp:
            k = -g
            k[half, half] = -2.0 * k.sum()
        else:
            k = g.copy()
            k[half, half] += 1.0 - k.sum()
        ksum = k.sum()
        gamma = 1.0 / ksum if abs(ksum) >= _EPSILON else 1.0
        res = _depthwise_conv(img, (gamma * k).astype(np.float32),
                              virtual_pixel)
        out = res if out is None else torch.where(level == n_idx, res, out)
    return out


def adaptive_blur(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                  virtual_pixel: str = "edge") -> torch.Tensor:
    """AdaptiveBlurImage (effect.c:118): per-pixel kernel width selected
    by the (auto-leveled, blurred) edge intensity — edges get the widest
    Gaussian, flat regions the 1x1 identity."""
    return _adaptive_apply(img, radius, sigma, virtual_pixel, sharp=False)


def adaptive_sharpen(img: torch.Tensor, radius: float = 0.0,
                     sigma: float = 1.0,
                     virtual_pixel: str = "edge") -> torch.Tensor:
    """AdaptiveSharpenImage (effect.c:400): same selection machinery with
    negated-Gaussian (unsharp) kernels."""
    return _adaptive_apply(img, radius, sigma, virtual_pixel, sharp=True)


def emboss(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
           virtual_pixel: str = "edge") -> torch.Tensor:
    """EmbossImage (effect.c): anti-diagonal signed-Gaussian convolution
    followed by histogram equalization.

    The kernel zeroes everything off the u == -v diagonal, keeps +8g at
    the center and -8g along the rest of the diagonal, and is normalized
    by its sum.  HDRI: the convolution is not clamped, so negatives reach
    EqualizeImage's bin clamp."""
    from .enhance import equalize

    width = optimal_kernel_width_1d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    k = np.zeros((width, width), dtype=np.float64)
    for v in range(-j, j + 1):
        u = -v
        g = math.exp(-(u * u + v * v) / (2.0 * s * s)) / \
            (2.0 * math.pi * s * s)
        k[v + j, u + j] = (-8.0 if (u < 0 or v < 0) else 8.0) * g
    total = k.sum()
    if abs(total) > 1e-15:
        k /= total
    return equalize(_depthwise_conv(img, k.astype(np.float32),
                                    virtual_pixel))


def motion_blur(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                angle: float = 0.0, virtual_pixel: str = "edge"
                ) -> torch.Tensor:
    """MotionBlurImage (effect.c:2100 region): 1-sided Gaussian streak,
    kernel[i] = exp(-i²/(2σ²))/(sqrt(2π)σ) along direction `angle`,
    sampled at unit steps from the pixel outward (offsets rounded to the
    grid, as a sparse 2-D kernel)."""
    width = optimal_kernel_width_1d(radius, sigma)
    s = _sigma_safe(sigma)
    xs = np.arange(width, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * s * s)) / (math.sqrt(2.0 * math.pi) * s)
    k /= k.sum()
    theta = math.radians(angle)
    dx, dy = math.cos(theta), math.sin(theta)
    offs = [(int(round(i * dy)), int(round(i * dx))) for i in range(width)]
    max_y = max(abs(o[0]) for o in offs)
    max_x = max(abs(o[1]) for o in offs)
    k2 = np.zeros((2 * max_y + 1, 2 * max_x + 1), dtype=np.float32)
    for w_, (oy, ox) in zip(k, offs):
        k2[max_y + oy, max_x + ox] += w_
    return _depthwise_conv(img, k2, virtual_pixel).clamp(0.0, 1.0)


def rotational_blur(img: torch.Tensor, angle: float) -> torch.Tensor:
    """RotationalBlurImage (effect.c:3129): per pixel, average NEAREST
    samples along the arc about the image center.

    Center = ((cols-1)/2, (rows-1)/2), blur_radius = hypot(center), n =
    trunc(|4*angle_rad*sqrt(blur_radius) + 2|) angles spanning
    [-angle/2, +angle/2]; each pixel strides them by step =
    trunc(blur_radius/radius) clamped to [1, n-1] (effect.c:3258-3270),
    sampling at trunc(coord + 0.5) with edge-clamped virtual pixels.  The
    source coordinates are float32 with the angle's cosine and sine as
    Python floats, in the JAX function's order of terms, so the nearest
    samples are the same.  One gather and mask per angle."""
    h, w = img.shape[-3], img.shape[-2]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    blur_radius = math.hypot(cx, cy)
    rad = math.radians(angle)
    n = max(int(abs(4.0 * rad * math.sqrt(blur_radius) + 2.0)), 2)
    theta = rad / (n - 1)
    offset = theta * (n - 1) / 2.0

    dev = img.device
    dx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    dy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    dx, dy = dx.expand(h, w), dy.expand(h, w)
    radius = torch.hypot(dx, dy)
    # a true division: torch's ``number / tensor`` is a reciprocal times
    step = torch.where(radius == 0, 1.0, torch.trunc(torch.div(
        torch.tensor(blur_radius, dtype=torch.float32, device=dev),
        torch.clamp(radius, min=1e-30))))
    step = step.clamp(1.0, float(n - 1))

    flat = img.reshape(img.shape[:-3] + (h * w, img.shape[-1]))
    acc = torch.zeros_like(img)
    cnt = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    for j in range(n):
        a = theta * j - offset
        c, s = math.cos(a), math.sin(a)
        sx = torch.trunc(cx + dx * c - dy * s + 0.5).clamp(0, w - 1)
        sy = torch.trunc(cy + dx * s + dy * c + 0.5).clamp(0, h - 1)
        idx = (sy * w + sx).to(torch.int64)
        samp = flat.index_select(-2, idx.reshape(-1)).reshape(img.shape)
        incl = (torch.round(torch.remainder(
            torch.full_like(step, float(j)), step)) == 0).to(
                torch.float32)[..., None]
        acc = acc + incl * samp
        cnt = cnt + incl
    return (acc / torch.clamp(cnt, min=1.0)).clamp(0.0, 1.0)


def selective_blur(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                   threshold: float = 0.1, virtual_pixel: str = "edge"
                   ) -> torch.Tensor:
    """SelectiveBlurImage (effect.c:3323-3544): an UNNORMALIZED 2-D
    Gaussian window where each tap joins the average only if
    |luma(tap) − luma(center)| < threshold; the included weights
    renormalize, and pixels whose gate admits ~nothing keep their value.
    A tap loop of a few ops a tap."""
    from .enhance import grayscale

    width = optimal_kernel_width_1d(radius, _sigma_safe(sigma))
    j = (width - 1) // 2
    s = _sigma_safe(sigma)
    vs = np.arange(-j, j + 1, dtype=np.float64)
    k2 = np.exp(-(vs[:, None] ** 2 + vs[None, :] ** 2) / (2.0 * s * s)) \
        / (2.0 * math.pi * s * s)
    c = img.shape[-1]
    ncol = 3 if c >= 3 else 1
    luma = grayscale(img[..., :ncol]) if ncol == 3 else img[..., :1]
    pad = pad_spatial(img, (j, j), (j, j), virtual_pixel)
    padl = pad_spatial(luma, (j, j), (j, j), virtual_pixel)
    h, w = img.shape[-3], img.shape[-2]
    acc = torch.zeros_like(img)
    gamma = torch.zeros(img.shape[:-1] + (1,), dtype=img.dtype,
                        device=img.device)
    for dv in range(width):
        for du in range(width):
            tap = pad[..., dv:dv + h, du:du + w, :]
            tl = padl[..., dv:dv + h, du:du + w, :]
            inc = ((tl - luma).abs() < threshold).to(img.dtype)
            kw = float(k2[dv, du])
            acc = acc + kw * inc * tap
            gamma = gamma + kw * inc
    good = gamma.abs() >= 1e-12
    out = acc / torch.where(good, gamma, 1.0)
    return torch.where(good, out, img)


def _neighbor(x: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """The value at (+oy, +ox), zero beyond the image border."""
    h, w = x.shape[-3], x.shape[-2]
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return pad[..., 1 + oy:1 + oy + h, 1 + ox:1 + ox + w, :]


def despeckle(img: torch.Tensor) -> torch.Tensor:
    """DespeckleImage (effect.c:1211 Hull, :1308 its loop).

    Each Hull(xoff, yoff, polarity) is two half-steps over a ZERO-padded
    1-px border: (A) v += 1q when the (+off) neighbor >= v + 2q; (B) on
    the result, v += 1q when the (-off) neighbor >= v + 2q AND the (+off)
    neighbor > v.  Negative polarity mirrors both.  The loop runs
    +off/-off/-off/+off with polarities +/+/-/- for each of the four
    directions.  The work is in 255-scaled units, where 8-bit-derived
    quanta are exact float32 integers and the +-2q compares exact."""
    one, two = 1.0, 2.0
    img = img * 255.0

    def hull(f, ox, oy, polarity):
        r = _neighbor(f, oy, ox)
        if polarity > 0:
            g = torch.where(r >= f + two, f + one, f)
        else:
            g = torch.where(r <= f - two, f - one, f)
        r2 = _neighbor(g, oy, ox)
        s2 = _neighbor(g, -oy, -ox)
        if polarity > 0:
            return torch.where((s2 >= g + two) & (r2 > g), g + one, g)
        return torch.where((s2 <= g - two) & (r2 < g), g - one, g)

    X = [0, 1, 1, -1]
    Y = [1, 0, 1, 1]
    out = img
    for k in range(4):
        out = hull(out, X[k], Y[k], 1)
        out = hull(out, -X[k], -Y[k], 1)
        out = hull(out, -X[k], -Y[k], -1)
        out = hull(out, X[k], Y[k], -1)
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, an ulp off the true quotient that the CPU and XLA take
    return out / out.new_tensor(255.0)


def spread_offsets(img: torch.Tensor, radius: float,
                   generator: Optional[torch.Generator] = None):
    """SpreadImage's offsets: (oy, ox), each uniform in [-radius, radius)
    per pixel, of shape img.shape[:-1], drawn from ``generator`` (a
    torch.Generator on the image's device; without one, a new one seeded
    0 there)."""
    if generator is None:
        generator = torch.Generator(device=img.device).manual_seed(0)
    shape = img.shape[:-1]
    oy = torch.rand(shape, generator=generator, device=img.device)
    ox = torch.rand(shape, generator=generator, device=img.device)
    return oy * (2.0 * radius) - radius, ox * (2.0 * radius) - radius


def spread_at(img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor
              ) -> torch.Tensor:
    """Each pixel replaced by the one at its rounded offset (oy, ox),
    clamped to the image."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + oy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + ox
    yi = torch.round(yy).to(torch.int64).clamp(0, h - 1)
    xi = torch.round(xx).to(torch.int64).clamp(0, w - 1)
    lead = img.shape[:-3]
    c = img.shape[-1]
    x2 = img.reshape(lead + (h * w, c))
    flat = (yi * w + xi).reshape(lead + (h * w, 1)).expand(lead + (h * w, c))
    return torch.gather(x2, -2, flat).reshape(img.shape)


def spread(img: torch.Tensor, radius: float,
           generator: Optional[torch.Generator] = None,
           virtual_pixel: str = "edge") -> torch.Tensor:
    """SpreadImage (effect.c): displace each pixel by a uniform random
    offset (``spread_offsets``, then ``spread_at``)."""
    oy, ox = spread_offsets(img, radius, generator)
    return spread_at(img, oy, ox)


def shade(img: torch.Tensor, azimuth: float = 30.0, elevation: float = 30.0,
          gray: bool = True, virtual_pixel: str = "edge") -> torch.Tensor:
    """ShadeImage (effect.c:3746): Lambertian shading from box-3 normals.

    normal.x = the 3 left-neighbor intensities minus the 3 right,
    normal.y = bottom row minus top row, normal.z = 2, light = (cos az cos
    el, sin az cos el, sin el); shade = light.z on flat pixels, else
    max(0, n.l)/|n|, over the clamped Rec709 luma."""
    az = math.radians(azimuth)
    el = math.radians(elevation)
    lx, ly, lz = (math.cos(az) * math.cos(el),
                  math.sin(az) * math.cos(el), math.sin(el))
    if img.shape[-1] >= 3:
        lum = (0.212656 * img[..., 0] + 0.715158 * img[..., 1] +
               0.072186 * img[..., 2])[..., None]
    else:
        lum = img[..., :1]
    lum = lum.clamp(0.0, 1.0)
    kx = np.asarray([[1, 0, -1]] * 3, np.float32)     # left - right
    ky = np.asarray([[-1], [0], [1]], np.float32) * \
        np.ones((1, 3), np.float32)                   # bottom - top
    nx = _depthwise_conv(lum, kx, virtual_pixel)
    ny = _depthwise_conv(lum, ky, virtual_pixel)
    nz = 2.0
    eps = 1e-12
    dot = nx * lx + ny * ly + nz * lz
    mag = torch.sqrt(nx * nx + ny * ny + nz * nz)
    shading = torch.where((nx.abs() <= eps) & (ny.abs() <= eps), lz,
                          torch.where(dot > eps, dot / mag, 0.0))
    if gray:
        return shading.expand(img.shape).clamp(0.0, 1.0)
    return (img * shading).clamp(0.0, 1.0)


def _kuwahara_offsets(pad: int):
    """The four quadrants' origin offsets (dy, dx): NW, NE, SW, SE."""
    return ((-pad, -pad), (-pad, 0), (0, -pad), (0, 0))


def _kuwahara_variances(g: torch.Tensor, radius: float) -> torch.Tensor:
    """The luma variance of each of the four (radius+1)^2 quadrants
    anchored NW/NE/SW/SE of every pixel: (4, ..., H, W), from an
    origin-anchored valid box mean over an edge-padded canvas."""
    w = int(radius) + 1
    pad = w - 1
    h_, w_ = g.shape[-3], g.shape[-2]
    if g.shape[-1] >= 3:
        luma = (0.212656 * g[..., :1] + 0.715158 * g[..., 1:2] +
                0.072186 * g[..., 2:3])
    else:
        luma = g[..., :1]
    lead = luma.shape[:-3]
    lp = pad_spatial(luma.reshape((-1, h_, w_, 1)), (pad, pad), (pad, pad),
                     "edge")
    box = torch.full((1, 1, w, w), 1.0 / (w * w), dtype=g.dtype,
                     device=g.device)

    def valid_box(x):
        return F.conv2d(x.permute(0, 3, 1, 2), box)[:, 0]

    m1 = valid_box(lp)            # (B, H+pad, W+pad) origin-anchored means
    m2 = valid_box(lp * lp)
    var = m2 - m1 * m1
    # quadrant origin offset d in {-(w-1), 0} per axis; var at (y, x)
    # for origin (y+dy, x+dx) lives at var[y+dy+pad, x+dx+pad]
    vstack = torch.stack([var[:, dy + pad:dy + pad + h_,
                              dx + pad:dx + pad + w_]
                          for dy, dx in _kuwahara_offsets(pad)], 0)
    return vstack.reshape((4,) + lead + (h_, w_))


def kuwahara(img: torch.Tensor, radius: float = 1.0,
             sigma: Optional[float] = None, virtual_pixel: str = "edge"
             ) -> torch.Tensor:
    """KuwaharaImage (effect.c:1914) — oracle-matched semantics.

    The reference pre-smooths with BlurImage(radius, sigma) (K3 on a
    card), ranks the four (radius+1)^2 quadrants anchored NW/NE/SW/SE of
    each pixel by LUMA variance, and outputs the smoothed image
    INTERPOLATED AT THE WINNING QUADRANT'S CENTER (origin + width/2).
    Ties take the first quadrant, as ``jnp.argmin`` does."""
    from .distort import sample_bilinear

    if sigma is None:
        sigma = max(radius - 0.5, 0.1)
    g = blur(img, radius, sigma, virtual_pixel)
    w = int(radius) + 1
    pad = w - 1
    h_, w_ = g.shape[-3], g.shape[-2]
    best = torch.argmin(_kuwahara_variances(g, radius), dim=0)
    yy = torch.arange(h_, dtype=g.dtype, device=g.device)[:, None]
    xx = torch.arange(w_, dtype=g.dtype, device=g.device)[None, :]
    yy, xx = yy.expand(h_, w_), xx.expand(h_, w_)
    out = None
    for q, (dy, dx) in enumerate(_kuwahara_offsets(pad)):
        samp = sample_bilinear(g, xx + dx + w / 2.0, yy + dy + w / 2.0)
        out = samp if out is None else torch.where(
            (best == q)[..., None], samp, out)
    return out.clamp(0.0, 1.0)


def bilateral_blur(img: torch.Tensor, width: int = 5, height: int = 5,
                   intensity_sigma: Optional[float] = None,
                   spatial_sigma: Optional[float] = None,
                   virtual_pixel: str = "edge") -> torch.Tensor:
    """BilateralBlurImage (effect.c:894-1120), reference-exact.

    The window is width x height EXACTLY, taps at offsets (mid.x-u,
    mid.y-v).  Each tap weight is BlurGaussian(charI(tap)-charI(center),
    intensity_sigma) * BlurGaussian(sqrt(dx^2+dy^2), spatial_sigma), where
    charI = floor(luma*255 + 0.5) clamped to 0..255 (ScaleQuantumToChar
    of the Rec709Luma intensity), read from a 511-entry LUT built in
    float64 on the host.  Defaults follow operation.c:1856-1861: xi =
    sqrt(w^2+h^2), psi = xi/4.  A tap loop of a few ops a tap."""
    from .enhance import grayscale

    width = max(int(width), 1)
    height = max(int(height), 1)
    if intensity_sigma is None:
        intensity_sigma = math.sqrt(width * width + height * height)
    if spatial_sigma is None:
        spatial_sigma = 0.25 * math.sqrt(width * width + height * height)

    def pr(v):
        return 1.0 / v if abs(v) >= 1e-12 else (1e12 if v >= 0 else -1e12)

    def blur_gaussian(x, sigma):
        a = pr(2.0 * sigma * sigma)
        b = pr(2.0 * math.pi * sigma * sigma)
        return np.exp(-np.asarray(x, np.float64) ** 2 * a) * b

    midx, midy = width // 2, height // 2
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    ncol = 3 if c >= 3 else 1
    luma = grayscale(x[..., :ncol]) if ncol == 3 else x[..., :1]
    chari = torch.floor(luma * 255.0 + 0.5).clamp(0.0, 255.0)
    pady = (height - 1 - midy, midy)     # offsets midy-(H-1) .. midy
    padx = (width - 1 - midx, midx)
    xp = pad_spatial(x, pady, padx, virtual_pixel)
    cp = pad_spatial(chari, pady, padx, virtual_pixel)
    num = torch.zeros_like(x)
    den = torch.zeros((x.shape[0], h, w, 1), dtype=x.dtype, device=x.device)
    ilut = torch.from_numpy(blur_gaussian(np.arange(-255, 256),
                                          intensity_sigma)).to(
                                              device=x.device,
                                              dtype=x.dtype)
    for v in range(height):
        for u in range(width):
            oy, ox = midy - v, midx - u
            sw = float(blur_gaussian(math.sqrt((u - midx) ** 2 +
                                               (v - midy) ** 2),
                                     spatial_sigma))
            ys, xs = oy + pady[0], ox + padx[0]
            nb = xp[:, ys:ys + h, xs:xs + w, :]
            nc = cp[:, ys:ys + h, xs:xs + w, :]
            d = (nc - chari).to(torch.int64) + 255
            wgt = sw * ilut[d.clamp(0, 510)]
            num = num + wgt * nb
            den = den + wgt
    out = num * torch.where(den.abs() >= 1e-12, 1.0 / den, 1e12)
    return out.reshape(img.shape)


def local_contrast(img: torch.Tensor, radius: float = 10.0,
                   strength: float = 12.5, virtual_pixel: str = "edge"
                   ) -> torch.Tensor:
    """LocalContrastImage (effect.c:1977): unsharp on luminance with a big
    radius.  Its blur is K3 on a card up to 33 taps (sigma below about
    4.1); at the default radius 10 it has 41 taps and takes the two
    plain passes, as in the JAX package."""
    sigma = max(abs(radius), 1.0) / 2.0
    blurred = blur(img, 0.0, sigma, virtual_pixel)
    out = img + (img - blurred) * (strength / 100.0) * 10.0
    return out.clamp(0.0, 1.0)
