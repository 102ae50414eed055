"""Image comparison metrics (compare.c).

Port of ``imagemagick_tpu/ops/compare.py``, whole: GetImageDistortion
(the reference's MagickCore/compare.c:1571) and its metrics as reductions
over (..., H, W, C) tensors in [0, 1] on the input's device, plus
``mean_error_per_pixel``, ``psnr_db``, ``compare_images`` and
``similarity_image``.

  * ae     — count of pixels differing beyond the fuzz
  * mae/mse/rmse/pae — means/maxima of |d| and d²
  * psnr   — the reference's normalized per-channel PSNR
  * ncc    — normalized cross correlation (dpc dispatches to it)
  * ssim/dssim — SSIM over the sampled 11×11 gaussian (sigma 1.5), through
    ``blur._depthwise_conv`` (121 taps: its grouped convolution)
  * fuzz   — root mean squared error
  * phase  — peak of the normalized cross-power spectrum
  * mepp   — the raw quantum-unit |d| sum
  * phash  — ``statistic.phash_distance`` (its float64 pipeline runs on
    the host, as in the JAX package)

``phase_correlation`` and ``similarity_image`` take ``torch.fft.rfft2``
and ``irfft2`` as the JAX functions take ``jnp.fft``.  Each metric returns
a 0-d float32 tensor on the input's device; ``ae`` counts in int64 and
converts the count, exact past 2^24 pixels where a float32 sum is not.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .blur import _depthwise_conv


def _axes(x: torch.Tensor) -> tuple:
    return tuple(range(x.dim() - 1))


def absolute_error(a, b, fuzz: float = 0.0):
    """AE: number of pixels whose any-channel difference exceeds fuzz."""
    bad = torch.any((a - b).abs() > fuzz, dim=-1)
    return bad.sum().to(torch.float32)


def mean_absolute_error(a, b):
    return (a - b).abs().mean()


def mean_squared_error(a, b):
    return ((a - b) ** 2).mean()


def root_mean_squared_error(a, b):
    return torch.sqrt(mean_squared_error(a, b).double()).float()


def peak_absolute_error(a, b):
    return (a - b).abs().max()


def mean_error_per_pixel(a, b):
    """MEPP triple (compare.c:712 GetMeanErrorPerPixel): the raw
    quantum-unit |d| sum over all samples, the mean of d² over samples
    and the max |d|."""
    diff = (a - b).abs()
    return (diff.sum() * 65535.0, (diff * diff).mean(), diff.max())


def mepp(a, b):
    """MEPP scalar: the raw quantum-domain |d| sum."""
    return (a - b).abs().sum() * 65535.0


def phash_metric(a, b):
    """PHASH (compare.c GetPerceptualHashDistortion): sum of squared
    differences of the perceptual-hash moment vectors."""
    from .statistic import phash_distance

    return phash_distance(a, b)


def psnr(a, b):
    """PSNR as the reference's normalized fraction (compare.c:1201):
    per-channel -10*log10(mse_c)/48.1647, averaged over channels
    (channels with mse below MagickEpsilon add 0 to the sum but count in
    the divisor)."""
    mse_c = ((a - b) ** 2).mean(dim=_axes(a))
    eps = 1.0e-12  # MagickEpsilon
    per = torch.where(mse_c >= eps,
                      (-10.0 * torch.log10(torch.clamp(mse_c, min=eps)))
                      / torch.tensor(48.1647, device=a.device),
                      0.0)
    return per.mean()


def psnr_db(a, b):
    """Pooled-MSE PSNR in dB — a fidelity-gate helper (not the
    reference metric; use :func:`psnr` for compare.c:1201 semantics)."""
    mse = ((a - b) ** 2).mean()
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-30))


def normalized_cross_correlation(a, b):
    """NCC (compare.c:933): per-channel correlation of mean-centered
    samples, averaged over channels."""
    axes = _axes(a)
    am = a - a.mean(dim=axes, keepdim=True)
    bm = b - b.mean(dim=axes, keepdim=True)
    num = (am * bm).sum(dim=axes)
    den = torch.sqrt(((am * am).sum(dim=axes) * (bm * bm).sum(dim=axes))
                     .double()).float()
    return (num / torch.clamp(den, min=1e-30)).mean()


def _ssim_window(radius: float, sigma: float) -> np.ndarray:
    """AcquireKernelInfo("gaussian:5x1.5"): morphology.c's SAMPLED 2-D
    gaussian (morphology.c:1074-1088), width 2*radius+1, float32."""
    u = np.arange(-int(radius), int(radius) + 1, dtype=np.float64)
    k = np.exp(-(u * u) / (2.0 * sigma * sigma))
    k /= k.sum()
    return np.outer(k, k).astype(np.float32)


def _ssim_maps(a, b, radius: float = 5.0, sigma: float = 1.5,
               k1: float = 0.01, k2: float = 0.03):
    k2d = _ssim_window(radius, sigma)

    def win(x):
        return _depthwise_conv(x, k2d, "edge")

    c1 = (k1 * 1.0) ** 2
    c2 = (k2 * 1.0) ** 2
    mu_a = win(a)
    mu_b = win(b)
    var_a = win(a * a) - mu_a * mu_a
    var_b = win(b * b) - mu_b * mu_b
    cov = win(a * b) - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return num / torch.clamp(den, min=1e-30)


def ssim(a, b, radius: float = 5.0, sigma: float = 1.5):
    """Structural similarity (compare.c:1319 constants)."""
    return _ssim_maps(a, b, radius, sigma).mean()


def dssim(a, b):
    return (1.0 - ssim(a, b)) / 2.0


def fuzz_error(a, b):
    """FUZZ metric: sqrt of the mean squared error (compare.c Fuzz)."""
    return torch.sqrt(((a - b) ** 2).mean().double()).float()


def dot_product_correlation(a, b):
    """DPC: whole-image GetImageDistortion dispatches it to the NCC
    default case (compare.c:1634-1640)."""
    return normalized_cross_correlation(a, b)


def phase_correlation(a, b):
    """Peak of the normalized cross-power spectrum (compare.c
    PhaseCorrelation)."""
    fa = torch.fft.rfft2(a.mean(dim=-1))
    fb = torch.fft.rfft2(b.mean(dim=-1))
    cross = fa * torch.conj(fb)
    cross = cross / torch.clamp(cross.abs(), min=1e-30)
    corr = torch.fft.irfft2(cross, s=tuple(a.shape[-3:-1]))
    return corr.max()


_METRICS = {
    "ae": absolute_error,
    "mae": mean_absolute_error,
    "mse": mean_squared_error,
    "rmse": root_mean_squared_error,
    "pae": peak_absolute_error,
    "psnr": psnr,
    "ncc": normalized_cross_correlation,
    "ssim": ssim,
    "dssim": dssim,
    "fuzz": fuzz_error,
    "dpc": dot_product_correlation,
    "phase": phase_correlation,
    "mepp": mepp,
    "phash": phash_metric,
}


def get_distortion(a: torch.Tensor, b: torch.Tensor, metric: str = "rmse"
                   ) -> torch.Tensor:
    """GetImageDistortion analog (compare.c:1571)."""
    m = metric.lower().strip()
    if m not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; have {sorted(_METRICS)}")
    return _METRICS[m](a, b)


def compare_images(a: torch.Tensor, b: torch.Tensor, metric: str = "rmse",
                   highlight=(1.0, 0.0, 0.0), lowlight=None, fuzz: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CompareImages (compare.c:114): (difference image, distortion).
    Differing pixels are painted with the highlight color over a faded
    copy of the first image."""
    distortion = get_distortion(a, b, metric)
    diff_mask = torch.any((a - b).abs() > fuzz, dim=-1, keepdim=True)
    faded = 1.0 - (1.0 - a) * 0.1  # the reference fades via a lowlight tint
    hl = torch.tensor(list(highlight), dtype=a.dtype, device=a.device)
    hl = hl.expand(a.shape[:-1] + (len(highlight),))[..., : a.shape[-1]]
    vis = torch.where(diff_mask, hl, faded)
    return vis, distortion


def similarity_image(image: torch.Tensor, template: torch.Tensor,
                     metric: str = "ncc"
                     ) -> Tuple[Tuple[int, int], torch.Tensor]:
    """SimilarityImage (compare.c): subimage search by FFT
    cross-correlation of one (H, W, C) image with a smaller template.

    Returns ((y, x) best offset as host ints, correlation surface).  The
    offset is the argmax of the unnormalized correlation with the
    mean-removed template, read back once.
    """
    if image.dim() != 3:
        raise ValueError(f"similarity_image takes one (H, W, C) image, not "
                         f"{tuple(image.shape)}")
    ig = image.mean(dim=-1)
    tg = template.mean(dim=-1)
    ih, iw = ig.shape[-2:]
    th, tw = tg.shape[-2:]
    tg = tg - tg.mean()
    pad_t = torch.zeros_like(ig)
    pad_t[:th, :tw] = tg
    fi = torch.fft.rfft2(ig)
    ft = torch.fft.rfft2(pad_t)
    corr = torch.fft.irfft2(fi * torch.conj(ft), s=(ih, iw))
    y, x = divmod(int(torch.argmax(corr)), iw)
    return (y, x), corr
