"""Thresholding ops (threshold.c family): the global thresholds.

Port of ``imagemagick_tpu/ops/threshold.py`` through its point ops (the
reference's MagickCore/threshold.c): the auto-thresholds (Otsu :491, Kapur
:392, Triangle :570) as reductions over 256-bin intensity histograms, and
the bilevel/black/white/range/clamp/perceptible point ops.  The adaptive,
random, ordered-dither and color thresholds wait for their queue item.

``auto_threshold`` thresholds every image of a batch at its own value:
``auto_threshold_values`` takes the N histograms from one launch of kernel
K4 and finds the N values on the device, with no host round trip.  Otsu
and Kapur sum the histograms in exact integers and weigh the classes in
float64, as the reference's doubles do; the JAX package does it in
float32, and the two pick the same bin unless two bins' scores lie
within float32's rounding of each other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gpu_kernels
from .enhance import grayscale

_NBINS = 256  # reference histograms auto-thresholds at 256 bins (threshold.c)
# A bin's threshold value: bin * float32(1/255), the JAX package's value.
# XLA compiles its ``argmax / 255`` inside ``lax.map`` into this product,
# one ulp off j/255 for 126 of the 256 bins (ROADMAP.md Queue 3).
_BIN_STEP = float(np.float32(1.0 / (_NBINS - 1)))


def _intensity_histogram(img: torch.Tensor, bins: int = _NBINS
                         ) -> torch.Tensor:
    """One histogram of the intensity of every pixel of ``img``."""
    from .histogram import _histogram_fixed

    inten = grayscale(img)[..., 0] if img.shape[-1] >= 3 else img[..., 0]
    return _histogram_fixed(inten, bins)


def _bin_value(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.float32) * _BIN_STEP


def _normalized(hist: torch.Tensor) -> torch.Tensor:
    return hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1.0)


def _otsu(hist: torch.Tensor) -> torch.Tensor:
    """OTSUThreshold (threshold.c:491) of (..., 256) histograms: the bin
    that maximizes the between-class variance, as a value in [0, 1].

    With n pixels, c of them at or below the bin and s their sum of
    levels, the variance is (s_t*c - s*n)^2 / (c*(n - c)) over n^2: the
    prefix sums and the difference are exact integers (to 1.9e8 pixels an
    image), so equal variances compare equal and only the square and the
    quotient round, in float64 as the reference computes."""
    counts = hist.to(torch.int64)
    levels = torch.arange(_NBINS, device=hist.device)
    omega = torch.cumsum(counts, dim=-1)
    mu = torch.cumsum(counts * levels, dim=-1)
    n, mu_t = omega[..., -1:], mu[..., -1:]
    d = (mu_t * omega - mu * n).to(torch.float64)
    denom = (omega * (n - omega)).to(torch.float64)
    sigma_b = torch.where(denom > 0.0, d * d / denom.clamp(min=1.0), 0.0)
    return _bin_value(torch.argmax(sigma_b, dim=-1))


def _kapur(hist: torch.Tensor) -> torch.Tensor:
    """KapurThreshold (threshold.c:392) of (..., 256) histograms: the bin
    that maximizes the sum of the two classes' entropies, in float64 as
    the reference computes."""
    p = _normalized(hist.to(torch.float64))
    eps = 1e-12
    plogp = torch.where(p > eps, p * torch.log(torch.clamp(p, min=eps)), 0.0)
    cum = torch.cumsum(p, dim=-1)
    cum_plogp = torch.cumsum(plogp, dim=-1)
    total_plogp = cum_plogp[..., -1:]
    black = cum
    white = 1.0 - cum
    black_c = torch.clamp(black, min=eps)
    white_c = torch.clamp(white, min=eps)
    h_black = torch.where(black > eps,
                          torch.log(black_c) - cum_plogp / black_c, 0.0)
    h_white = torch.where(white > eps, torch.log(white_c) -
                          (total_plogp - cum_plogp) / white_c, 0.0)
    return _bin_value(torch.argmax(h_black + h_white, dim=-1))


def _triangle(hist: torch.Tensor) -> torch.Tensor:
    """TriangleThreshold (threshold.c:570) of (..., 256) histograms —
    exact reference algorithm: normalized histogram, chord from (peak,
    p[peak]) down to (start|end, 0) on the LONGER tail, signed distance
    with the quirky 1/sqrt(a^2+b^2+c^2) normalization, sign-gated scan
    direction."""
    p = _normalized(hist)
    nz = (p > 0).to(torch.int8)
    levels = torch.arange(_NBINS, device=hist.device)
    start = torch.argmax(nz, dim=-1, keepdim=True)
    end = _NBINS - 1 - torch.argmax(nz.flip(-1), dim=-1, keepdim=True)
    peak = torch.argmax(p, dim=-1, keepdim=True)
    x1 = peak.to(torch.float32)
    y1 = torch.gather(p, -1, peak)
    use_start = (peak - start) >= (end - peak)
    x2 = torch.where(use_start, start, end).to(torch.float32)
    a = y1                       # y1 - y2 with y2 = 0
    b = x2 - x1
    c = -(a * x1 + b * y1)
    ir = 1.0 / torch.clamp(torch.sqrt(a * a + b * b + c * c), min=1e-30)
    xs = levels.to(torch.float32)
    seg = ir * (a * xs + b * p + c)
    # left branch scans [start, peak) keeping seg > 0; right branch
    # scans (peak, end] keeping seg < 0
    left_ok = (levels >= start) & (levels < peak) & (seg > 0.0)
    right_ok = (levels > peak) & (levels <= end) & (seg < 0.0)
    ok = torch.where(use_start, left_ok, right_ok)
    dist = torch.where(ok, seg.abs(), -1.0)
    best = torch.argmax(dist, dim=-1)
    found = torch.amax(dist, dim=-1) > 0.0
    return _bin_value(torch.where(found, best, 0))


_METHODS = {"otsu": _otsu, "kapur": _kapur, "triangle": _triangle}


def _method(method: str):
    fn = _METHODS.get(method.lower())
    if fn is None:
        raise ValueError(f"unknown auto-threshold method {method!r}")
    return fn


def otsu_threshold_value(img: torch.Tensor) -> torch.Tensor:
    """OTSUThreshold (threshold.c:491) over every pixel of ``img``."""
    return _otsu(_intensity_histogram(img))


def kapur_threshold_value(img: torch.Tensor) -> torch.Tensor:
    """KapurThreshold (threshold.c:392) over every pixel of ``img``."""
    return _kapur(_intensity_histogram(img))


def triangle_threshold_value(img: torch.Tensor) -> torch.Tensor:
    """TriangleThreshold (threshold.c:570) over every pixel of ``img``."""
    return _triangle(_intensity_histogram(img))


def _intensity_image(img: torch.Tensor) -> torch.Tensor:
    """The values the auto-thresholds measure and compare: the Rec709
    luma of three or more channels, else the image itself."""
    return grayscale(img)[..., 0:1] if img.shape[-1] >= 3 else img


def auto_threshold_values(img: torch.Tensor, method: str = "otsu"
                          ) -> torch.Tensor:
    """The threshold of each image of an (..., H, W, C) batch, shaped
    like the batch's leading axes ((N,) for a batch, () for one image):
    the histograms of all images from one launch of kernel K4, then the
    method on the device."""
    fn = _method(method)
    inten = _intensity_image(img)[..., 0]
    lead, h, w = inten.shape[:-2], inten.shape[-2], inten.shape[-1]
    rows = inten.reshape(-1, h * w).to(torch.float32).contiguous()
    if rows.shape[0] == 0:        # an empty batch: no image, no threshold
        return torch.zeros(lead, dtype=torch.float32, device=img.device)
    return fn(gpu_kernels.histogram256(rows)).reshape(lead)


def auto_threshold(img: torch.Tensor, method: str = "otsu") -> torch.Tensor:
    """AutoThresholdImage (threshold.c:660): global bilevel by method.

    PER IMAGE: a batched (N, H, W, C) input gets N independent thresholds
    (the reference processes one image at a time; a shared batch histogram
    would let one bright image shift every threshold).
    """
    t = auto_threshold_values(img, method)
    inten = _intensity_image(img)
    # the reference compares the UNQUANTIZED intensity against the bin
    # threshold j/255 (AutoThresholdImage -> BilevelImage(Q*t/100)):
    # pixels above the bin EDGE go white even inside the threshold bin
    out = (inten > t.reshape(t.shape + (1, 1, 1))).to(img.dtype)
    return out.expand(img.shape[:-1] + (1,))


def bilevel(img: torch.Tensor, threshold) -> torch.Tensor:
    """BilevelImage (threshold.c:805): thresholds the PIXEL INTENSITY
    (Rec709 luma on encoded values, GetPixelIntensity default) and sets
    every color channel to 0/1 from that one comparison; alpha passes
    through.  Single-channel images threshold the channel directly.
    ``threshold`` is a number or a tensor that broadcasts against the
    batch's leading axes, e.g. (N, 1, 1, 1)."""
    c = img.shape[-1]
    if c < 3:
        return (img > threshold).to(img.dtype)
    luma = (0.212656 * img[..., 0] + 0.715158 * img[..., 1] +
            0.072186 * img[..., 2])[..., None]
    color = (luma > threshold).to(img.dtype).expand(img[..., :3].shape)
    return torch.cat([color, img[..., 3:]], dim=-1) if c > 3 else color


def _intensity(img: torch.Tensor) -> torch.Tensor:
    """GetPixelIntensity default (Rec709 luma on encoded values)."""
    if img.shape[-1] < 3:
        return img[..., 0]
    return (0.212656 * img[..., 0] + 0.715158 * img[..., 1] +
            0.072186 * img[..., 2])


def _set_color(img: torch.Tensor, mask: torch.Tensor, value: float
               ) -> torch.Tensor:
    """Set all color channels where mask, preserving alpha."""
    c = img.shape[-1]
    nc = min(c, 3)
    color = torch.where(mask[..., None], value, img[..., :nc])
    return torch.cat([color, img[..., nc:]], dim=-1) if c > nc else color


def black_threshold(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """BlackThresholdImage (threshold.c): the pixel INTENSITY is compared
    and all color channels zeroed together — oracle-verified."""
    return _set_color(img, _intensity(img) < threshold, 0.0)


def white_threshold(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """WhiteThresholdImage: intensity above the threshold forces the
    whole pixel white — oracle-verified."""
    return _set_color(img, _intensity(img) > threshold, 1.0)


def range_threshold(img: torch.Tensor, low_black: float, low_white: float,
                    high_white: float, high_black: float) -> torch.Tensor:
    """RangeThresholdImage (threshold.c:1160-1230): soft trapezoid over
    the pixel INTENSITY — every updated channel is set from the same
    intensity ramp (the result is gray), not thresholded per-channel."""
    y = _intensity(img)[..., None]
    rise = (y - low_black) / max(low_white - low_black, 1e-12)
    fall = (high_black - y) / max(high_black - high_white, 1e-12)
    ramp = torch.where(y < low_black, 0.0,
           torch.where(y < low_white, rise,
           torch.where(y <= high_white, 1.0,
           torch.where(y <= high_black, fall, 0.0))))
    ncol = 3 if img.shape[-1] >= 3 else 1
    out = ramp.expand(img.shape[:-1] + (ncol,))
    if img.shape[-1] > ncol:
        out = torch.cat([out, img[..., ncol:]], -1)
    return out.to(img.dtype)


def clamp(img: torch.Tensor) -> torch.Tensor:
    """ClampImage: clamp to [0, 1] (HDRI values back into quantum range)."""
    return torch.clamp(img, 0.0, 1.0)


def perceptible(img: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """PerceptibleImage: raise tiny values to epsilon."""
    return torch.where(img.abs() < epsilon,
                       torch.sign(img) * epsilon + (img == 0) * epsilon, img)
