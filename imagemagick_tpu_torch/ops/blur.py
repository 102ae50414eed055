"""Blur and convolution (the effect.c op family, the slice's subset).

Port of ``imagemagick_tpu/ops/blur.py``.  Each effect is a function over an
(..., H, W, C) float32 tensor.  The kernel-width rules and kernel tables
are numpy, copied from the JAX package:
  * GetOptimalKernelWidth1D/2D (MagickCore/gem.c:262-330)
  * the "blur:" 1-D kernel (morphology.c:1140 BlurKernel)
  * GaussianBlurImage (effect.c:1709) as two separable passes
  * UnsharpMaskImage (effect.c:4256) over BlurImage
  * EdgeImage (effect.c), config #3's last op

``_separable_conv`` runs kernel K3 (``gpu_kernels.separable_blur``) for an
odd kernel of at most 33 taps with edge padding, the envelope of the TPU
path, on at most 8 channels (K3's shared memory); other cases take the two
`_depthwise_conv` passes.
"""

from __future__ import annotations

import math
from functools import lru_cache

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
    width = optimal_kernel_width_2d(radius, sigma)
    s = _sigma_safe(sigma)
    j = (width - 1) // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * s * s))
    k /= k.sum()
    return _separable_conv(img, k.astype(np.float32),
                           virtual_pixel).clamp(0.0, 1.0)


def unsharp_mask(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
                 gain: float = 1.0, threshold: float = 0.05,
                 virtual_pixel: str = "edge") -> torch.Tensor:
    """UnsharpMaskImage (effect.c:4256): where |2 diff| reaches the
    threshold, add gain times the difference from the blur."""
    blurred = blur(img, radius, sigma, virtual_pixel)
    diff = img - blurred
    out = torch.where((2.0 * diff).abs() < threshold, img, img + gain * diff)
    return out.clamp(0.0, 1.0)
