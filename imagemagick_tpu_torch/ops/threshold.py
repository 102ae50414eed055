"""Thresholding ops (threshold.c family).

Port of ``imagemagick_tpu/ops/threshold.py`` (the reference's
MagickCore/threshold.c): the auto-thresholds (Otsu :491, Kapur :392,
Triangle :570) as reductions over 256-bin intensity histograms; the
bilevel/black/white/range/clamp/perceptible point ops; and the adaptive
(local mean), random, ordered-dither and color thresholds.

``auto_threshold`` thresholds every image of a batch at its own value:
``auto_threshold_values`` takes the N histograms from one launch of kernel
K4 and finds the N values on the device, with no host round trip.  Otsu
and Kapur sum the histograms in exact integers and weigh the classes in
float64, as the reference's doubles do; the JAX package does it in
float32, and the two pick the same bin unless two bins' scores lie
within float32's rounding of each other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import gpu_kernels
from .enhance import _intensity, grayscale

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


def adaptive_threshold(img: torch.Tensor, width: int = 3, height: int = 3,
                       bias: float = 0.0) -> torch.Tensor:
    """AdaptiveThresholdImage (threshold.c): local mean minus bias.  A
    pixel at or below its local mean plus ``bias`` goes black
    (``mean=sum/n+bias``: the bias ADDS to the mean)."""
    from .blur import _depthwise_conv

    box = np.ones((height, width), np.float32) / float(width * height)
    mean = _depthwise_conv(img, box, "edge")
    return (img > mean + bias).to(img.dtype)


def random_threshold(img: torch.Tensor, low: float = 0.0, high: float = 1.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """RandomThresholdImage: each value against its own uniform threshold
    in [low, high].

    The thresholds come from ``generator``, a torch.Generator on the
    image's device.  Without one the function seeds a new generator with
    0 on that device, as the JAX function falls back to PRNGKey(0), so a
    run repeats itself; the values differ from JAX's, whose PRNG is
    another.  The CLI's -seed is not ported, so -random-threshold always
    takes that fallback."""
    if generator is None:
        generator = torch.Generator(device=img.device).manual_seed(0)
    t = torch.rand(img.shape, generator=generator, device=img.device,
                   dtype=img.dtype) * (high - low) + low
    return (img > t).to(img.dtype)


# Ordered-dither threshold maps (config/thresholds.xml), a copy of the
# JAX package's table: name -> (divisor, rows).
_THRESHOLD_MAPS = {
    "threshold": (2, [[1]]),
    "checks": (3, [[1, 2], [2, 1]]),
    "o2x2": (5, [[1, 3], [4, 2]]),
    "o3x3": (10, [[3, 7, 4], [6, 1, 9], [2, 8, 5]]),
    "o4x4": (17, [[1, 9, 3, 11], [13, 5, 15, 7], [4, 12, 2, 10],
                  [16, 8, 14, 6]]),
    "o8x8": (65, [
        [1, 49, 13, 61, 4, 52, 16, 64], [33, 17, 45, 29, 36, 20, 48, 32],
        [9, 57, 5, 53, 12, 60, 8, 56], [41, 25, 37, 21, 44, 28, 40, 24],
        [3, 51, 15, 63, 2, 50, 14, 62], [35, 19, 47, 31, 34, 18, 46, 30],
        [11, 59, 7, 55, 10, 58, 6, 54], [43, 27, 39, 23, 42, 26, 38, 22]]),
    "h4x4a": (9, [[4, 2, 7, 5], [3, 1, 8, 6], [7, 5, 4, 2], [8, 6, 3, 1]]),
    "h6x6a": (19, [
        [14, 13, 10, 8, 2, 3], [16, 18, 12, 7, 1, 4], [15, 17, 11, 9, 6, 5],
        [8, 2, 3, 14, 13, 10], [7, 1, 4, 16, 18, 12], [9, 6, 5, 15, 17, 11]]),
    "h8x8a": (33, [
        [13, 7, 8, 14, 17, 21, 22, 18], [6, 1, 3, 9, 28, 31, 29, 23],
        [5, 2, 4, 10, 27, 32, 30, 24], [16, 12, 11, 15, 20, 26, 25, 19],
        [17, 21, 22, 18, 13, 7, 8, 14], [28, 31, 29, 23, 6, 1, 3, 9],
        [27, 32, 30, 24, 5, 2, 4, 10], [20, 26, 25, 19, 16, 12, 11, 15]]),
    "c5x5b": (26, [
        [1, 21, 16, 15, 4], [5, 17, 20, 19, 14], [6, 21, 25, 24, 12],
        [7, 18, 22, 23, 11], [2, 8, 9, 10, 3]]),
    "c6x6b": (37, [
        [1, 5, 14, 13, 12, 4], [6, 22, 28, 27, 21, 11],
        [15, 29, 35, 34, 26, 20], [16, 30, 36, 33, 25, 19],
        [7, 23, 31, 32, 24, 10], [2, 8, 17, 18, 9, 3]]),
    "c7x7b": (50, [
        [3, 9, 18, 28, 17, 8, 2], [10, 24, 33, 39, 32, 23, 7],
        [19, 34, 44, 48, 43, 31, 16], [25, 40, 45, 49, 47, 38, 27],
        [20, 35, 41, 46, 42, 29, 15], [11, 21, 36, 37, 28, 22, 6],
        [4, 12, 13, 26, 14, 5, 1]]),
}
for _alias, _name in (("1x1", "threshold"), ("2x1", "checks"),
                      ("2x2", "o2x2"), ("3x3", "o3x3"), ("4x4", "o4x4"),
                      ("8x8", "o8x8"), ("4x1", "h4x4a"), ("6x1", "h6x6a"),
                      ("8x1", "h8x8a"), ("c5x5", "c5x5b"),
                      ("c6x6", "c6x6b"), ("c7x7", "c7x7b")):
    _THRESHOLD_MAPS[_alias] = _THRESHOLD_MAPS[_name]


def threshold_map_names():
    return sorted(_THRESHOLD_MAPS)


def ordered_dither(img: torch.Tensor, map_name: str = "o8x8",
                   levels: int = 2) -> torch.Tensor:
    """OrderedDitherImage (threshold.c): posterize with a tiled threshold
    map, the integer ladder of threshold.c:1774: i = trunc(v*(L*(D-1)+1)),
    level = i // (D-1), out = (level + (i mod (D-1) >= map)) / L."""
    map_name = map_name.lower()
    if map_name not in _THRESHOLD_MAPS:
        raise ValueError(f"unknown threshold map {map_name!r}")
    divisor, rows = _THRESHOLD_MAPS[map_name]
    m = np.asarray(rows, np.float32)
    mh, mw = m.shape
    h, w = img.shape[-3], img.shape[-2]
    tiled = np.tile(m, (-(-h // mh), -(-w // mw)))[:h, :w]
    t = torch.from_numpy(np.ascontiguousarray(tiled)).to(img.device)[..., None]
    lv = float(levels)
    if abs(lv) >= 1.0:
        lv -= 1.0
    if abs(lv) < 1e-12:
        return img
    d1 = float(divisor - 1)
    ti = torch.floor(img.clamp(0.0, 1.0) * (lv * d1 + 1.0))
    level = torch.floor(ti / d1)
    rem = ti - level * d1
    out = (level + (rem >= t).to(img.dtype)) / lv
    return out.clamp(0.0, 1.0)


def color_threshold(img: torch.Tensor, start: Sequence[float],
                    stop: Sequence[float]) -> torch.Tensor:
    """ColorThresholdImage: white where start <= pixel <= stop, else
    black, as one channel."""
    lo = torch.as_tensor(start, dtype=img.dtype, device=img.device)
    hi = torch.as_tensor(stop, dtype=img.dtype, device=img.device)
    inside = torch.all((img[..., :lo.shape[0]] >= lo) &
                       (img[..., :hi.shape[0]] <= hi), dim=-1, keepdim=True)
    return inside.to(img.dtype)
