"""Enhance ops (the enhance.c family): levels, gamma, histogram
stretches, modulate, CLAHE, LUTs and local filters.

Port of ``imagemagick_tpu/ops/enhance.py`` (the reference's
MagickCore/enhance.c).  Each op is closed-form per-pixel math on the
image's device, or a fixed-bin histogram reduction: ``equalize``,
``contrast_stretch`` and ``linear_stretch`` bin the pixel intensity into
65536 bins (``torch.bincount`` through ``histogram._histogram_fixed``),
``clahe`` its tiles into 128 (``histogram._histogram_fixed_batched``);
none of them reaches kernel K4, which takes 256 bins.  ``clahe_reference``
is the reference's exact integer pipeline on the host, in float64 numpy,
with the Lab conversions on the image's device.

Formulas match the reference: ScaledSigmoidal contrast (enhance.c:4207-
4260), BrightnessContrast slope/intercept, ModulateHSL, Level/Levelize
with gamma (LevelPixel/LevelizeImage), AutoGamma log(0.5)/log(mean)
(AutoGammaImage).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import colorspace as cs

_EPS = 1e-12


def _prec(x: torch.Tensor) -> torch.Tensor:
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = x.abs()
    return sign / torch.where(ax < _EPS, _EPS, ax)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (the JAX package's
    ``jnp.asarray`` of a host number)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Point transforms
# ---------------------------------------------------------------------------

def gamma(img: torch.Tensor, value: float) -> torch.Tensor:
    """GammaImage: out = v^(1/gamma)."""
    if value == 1.0:
        return img
    return torch.pow(img.clamp(min=0.0), 1.0 / value)


def level(img: torch.Tensor, black_point: float = 0.0,
          white_point: float = 1.0, gamma_: float = 1.0) -> torch.Tensor:
    """LevelImage (enhance.c LevelPixel): stretch then gamma."""
    scale = _prec(_f32(white_point - black_point, img))
    out = (img - black_point) * scale
    if gamma_ != 1.0:
        out = torch.pow(out.clamp(min=0.0), 1.0 / gamma_)
    return out


def levelize(img: torch.Tensor, black_point: float = 0.0,
             white_point: float = 1.0, gamma_: float = 1.0) -> torch.Tensor:
    """LevelizeImage: inverse of level (-level / +level pair)."""
    return torch.pow(img.clamp(min=0.0), gamma_) * \
        (white_point - black_point) + black_point


def negate(img: torch.Tensor, grayscale_only: bool = False) -> torch.Tensor:
    """NegateImage."""
    neg = 1.0 - img
    if not grayscale_only:
        return neg
    is_gray = torch.all((img - img[..., :1]).abs() < 1e-6, dim=-1,
                        keepdim=True)
    return torch.where(is_gray, neg, img)


def _sigmoidal(a, b, x):
    return 1.0 / (1.0 + torch.exp(a * (b - x)))


def sigmoidal_contrast(img: torch.Tensor, sharpen: bool = True,
                       contrast: float = 3.0, midpoint: float = 0.5
                       ) -> torch.Tensor:
    """SigmoidalContrastImage (enhance.c:4207-4300)."""
    if abs(contrast) < 4.0 * 1e-10:
        return img
    a, b = contrast, midpoint
    sig0 = _sigmoidal(a, b, _f32(0.0, img))
    sig1 = _sigmoidal(a, b, _f32(1.0, img))
    if sharpen:
        return (_sigmoidal(a, b, img) - sig0) / (sig1 - sig0)
    # inverse (logistic branch; enhance.c InverseScaledSigmoidal)
    arg = torch.clamp((sig1 - sig0) * img + sig0, _EPS, 1.0 - _EPS)
    return b - torch.log(1.0 / arg - 1.0) / a


def brightness_contrast(img: torch.Tensor, brightness: float = 0.0,
                        contrast: float = 0.0) -> torch.Tensor:
    """BrightnessContrastImage: [-100,100] args -> polynomial v*slope+icpt."""
    if contrast < 0.0:
        slope = 0.01 * contrast + 1.0
    else:
        slope = 100.0 / max(100.0 - contrast, _EPS)
    intercept = (0.01 * brightness - 0.5) * slope + 0.5
    return img * slope + intercept


def modulate(img: torch.Tensor, brightness: float = 100.0,
             saturation: float = 100.0, hue: float = 100.0,
             colorspace: str = "hsl") -> torch.Tensor:
    """ModulateImage (enhance.c ModulateHSL & friends)."""
    fwd, inv = {"hsl": (cs.rgb_to_hsl, cs.hsl_to_rgb),
                "hsb": (cs.rgb_to_hsv, cs.hsv_to_rgb),
                "hsv": (cs.rgb_to_hsv, cs.hsv_to_rgb),
                "hwb": (cs.rgb_to_hwb, cs.hwb_to_rgb),
                "lch": (cs.rgb_to_lchab, cs.lchab_to_rgb)}[colorspace.lower()]
    hsx = fwd(img)
    h = hsx[..., 0] + math.fmod(hue - 100.0, 200.0) / 200.0
    h = torch.remainder(h, 1.0)
    s = hsx[..., 1] * (0.01 * saturation)
    l = hsx[..., 2] * (0.01 * brightness)
    return torch.clamp(inv(torch.stack([h, s, l], dim=-1)), 0.0, 1.0)


def grayscale(img: torch.Tensor, method: str = "rec709luma") -> torch.Tensor:
    """GrayscaleImage (enhance.c) with the pixel-intensity method set
    (pixel-accessor.h GetPixelIntensity variants): (..., C >= 3) ->
    (..., 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    m = method.lower()
    if m == "average":
        y = (r + g + b) / 3.0
    elif m == "brightness":
        y = torch.amax(img[..., :3], dim=-1)
    elif m == "lightness":
        y = (torch.amax(img[..., :3], -1) + torch.amin(img[..., :3], -1)) / 2.0
    elif m == "ms":
        # quantum-domain mean square (enhance.c:2569): (r²+g²+b²)/3 in
        # quantum units lands at quantum² scale — normalized that is a
        # ×QuantumRange blow-up (saturates all but near-black pixels)
        y = (r * r + g * g + b * b) / 3.0 * 65535.0
    elif m == "rms":
        y = torch.sqrt(((r * r + g * g + b * b) / 3.0).double()).float()
    elif m == "rec601luma":
        y = 0.298839 * r + 0.586811 * g + 0.114350 * b
    elif m == "rec601luminance":
        lin = cs.srgb_to_linear(img[..., :3])
        y = (0.298839 * lin[..., 0] + 0.586811 * lin[..., 1] +
             0.114350 * lin[..., 2])
    elif m == "rec709luminance":
        lin = cs.srgb_to_linear(img[..., :3])
        y = (0.212656 * lin[..., 0] + 0.715158 * lin[..., 1] +
             0.072186 * lin[..., 2])
    else:  # rec709luma default
        y = 0.212656 * r + 0.715158 * g + 0.072186 * b
    return y[..., None]


# ---------------------------------------------------------------------------
# Histogram-based ops
# ---------------------------------------------------------------------------

_NBINS = 65536  # Q16 histogram resolution (MaxMap analog)


def _intensity(img: torch.Tensor) -> torch.Tensor:
    """GetPixelIntensity default: Rec709 luma on encoded values of three
    or more channels, else the first channel."""
    if img.shape[-1] >= 3:
        return (0.212656 * img[..., 0] + 0.715158 * img[..., 1] +
                0.072186 * img[..., 2])
    return img[..., 0]


def _channel_histogram(ch: torch.Tensor, bins: int = _NBINS
                       ) -> torch.Tensor:
    from .histogram import _histogram_fixed

    return _histogram_fixed(ch, bins)


def equalize(img: torch.Tensor, bins: int = 65536) -> torch.Tensor:
    """EqualizeImage: histogram equalization (enhance.c), default
    SyncChannels semantics: ONE histogram of the pixel INTENSITY, whose
    cumulative map (normalized by black=cdf[0], white=total) is applied
    to each channel's own value.  Default bins = MaxMap+1 = 65536
    (pixel-accessor.h ScaleQuantumToMap)."""
    from .histogram import _bin_index

    hist = _channel_histogram(_intensity(img).clamp(0.0, 1.0), bins)
    cdf = torch.cumsum(hist, dim=0)
    black = cdf[0]
    white = cdf[-1]
    lut = torch.clamp((cdf - black) * _prec(white - black), 0.0, 1.0)
    out = torch.where(white == black, img, lut[_bin_index(img, bins)])
    return out


def contrast_stretch(img: torch.Tensor, black_point: float = 0.0,
                     white_point: Optional[float] = None,
                     bins: int = 65536) -> torch.Tensor:
    """ContrastStretchImage (enhance.c): black/white levels located on
    the pixel-INTENSITY histogram (default SyncChannels semantics):
    black = first bin whose cumulative count exceeds black_point*n,
    white = first bin scanning DOWN whose top-cumulative exceeds
    white_point*n; then every channel maps through the same linear
    stretch.  white_point is the fraction clipped from the TOP."""
    if white_point is None:
        white_point = black_point
    n = img[..., 0].numel()
    hist = _channel_histogram(_intensity(img).clamp(0.0, 1.0), bins)
    cdf = torch.cumsum(hist, dim=0)
    cum_top = n - cdf + hist                 # inclusive cumulative from top
    lo_j = torch.argmax((cdf > black_point * n).to(torch.uint8))
    above = cum_top > white_point * n
    # the largest j with top-cumulative above the clip count
    hi_j = (bins - 1) - torch.argmax(above.flip(0).to(torch.uint8))
    lo = lo_j.to(torch.float32) / (bins - 1)
    hi = hi_j.to(torch.float32) / (bins - 1)
    out = torch.where(hi == lo, img, (img - lo) * _prec(hi - lo))
    return torch.clamp(out, 0.0, 1.0)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """NormalizeImage = ContrastStretch 2%/1% (enhance.c NormalizeImage)."""
    return contrast_stretch(img, 0.02, 0.01)


def auto_level(img: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """AutoLevelImage (MinMaxStretchImage, histogram.c:927): with the
    default AllChannels mask the reference levels every channel with ONE
    global min/max (GetImageRange); per_channel=True gives the
    channel-masked variant.  Oracle-verified."""
    if per_channel:
        flat = img.reshape(-1, img.shape[-1])
        mn, mx = flat.amin(dim=0), flat.amax(dim=0)
    else:
        mn, mx = img.amin(), img.amax()
    return (img - mn) * _prec(mx - mn)


def auto_gamma(img: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """AutoGammaImage (enhance.c:112): gamma = log(mean)/log(0.5) so the
    mean maps to 0.5, then LevelImage(0, QR, gamma).  The default channel
    mask IS AllChannels (pixel.h:75), so the stock CLI path pools ALL
    channels into one mean; per_channel only applies under -channel."""
    if per_channel:
        mean = img.reshape(-1, img.shape[-1]).mean(dim=0)
    else:
        mean = img.mean()
    g = torch.log(mean.clamp(1e-6, 1.0 - 1e-6)) / math.log(0.5)
    return torch.pow(img.clamp(min=0.0), 1.0 / g)


def linear_stretch(img: torch.Tensor, black_point: float = 0.02,
                   white_point: float = 0.01, bins: int = 65536
                   ) -> torch.Tensor:
    """LinearStretchImage: stretch on the intensity histogram (enhance.c)."""
    inten = grayscale(img)[..., 0]
    n = inten.numel()
    cdf = torch.cumsum(_channel_histogram(inten, bins), dim=0)
    lo = torch.argmax((cdf > black_point * n).to(torch.uint8)).to(
        torch.float32) / (bins - 1)
    hi = torch.argmax((cdf >= (1.0 - white_point) * n).to(torch.uint8)).to(
        torch.float32) / (bins - 1)
    return torch.clamp((img - lo) * _prec(hi - lo), 0.0, 1.0)


def _decode_gamma_ref(x: np.ndarray) -> np.ndarray:
    """pixel.c:259 DecodeGamma — the reference's Chebyshev-series x^2.4
    (x·x^(7/5)), replicated bit-for-bit in f64.  The series' approximation
    error IS the reference's sRGB decode curve, so true pow() does not
    match it."""
    coef = (1.7917488588043277509, 0.82045614371976854984,
            0.027694100686325412819, -0.00094244335181762134018,
            0.000064355540911469709545, -5.7224404636060757485e-06,
            5.8767669437311184313e-07, -6.6139920053589721168e-08,
            7.9323242696227458163e-09)
    pot = (1.0, 2.6390158215457883983, 6.9644045063689921093,
           1.8379173679952558018e+01, 4.8502930128332728543e+01)
    m, e = np.frexp(x)
    t1 = 4.0 * m - 3.0
    terms = [np.ones_like(x), t1]
    for _ in range(7):
        terms.append(2.0 * t1 * terms[-1] - terms[-2])
    p = sum(c * t for c, t in zip(coef, terms))
    # div(exponent-1, 5) with C truncation-toward-zero + remainder fixup
    num = e - 1
    quot = np.trunc(num / 5.0).astype(np.int64)
    rem = num - 5 * quot
    fix = rem < 0
    quot = np.where(fix, quot - 1, quot)
    rem = np.where(fix, rem + 5, rem)
    return x * np.ldexp(np.take(np.asarray(pot), rem) * p, 7 * quot)


def _srgb_quantum_to_lab_L_exact(rgb_quantum: np.ndarray) -> np.ndarray:
    """sRGB (quantum scale) -> Lab L, f64, with the reference's exact
    DecodePixelGamma + RGBToXYZ matrix + XYZToLab (colorspace-private.h)."""
    q = rgb_quantum.astype(np.float64)
    lin = np.where(q <= 0.0404482362771076 * 65535.0, q / 12.92,
                   65535.0 * _decode_gamma_ref((q / 65535.0 + 0.055) / 1.055))
    r, g, b = lin[..., 0] / 65535.0, lin[..., 1] / 65535.0, lin[..., 2] / 65535.0
    Y = 0.2125862307855955516 * r + 0.7151703037034108499 * g \
        + 0.07220049864333622685 * b
    eps, kk = 216.0 / 24389.0, 24389.0 / 27.0
    y = np.where(Y > eps, np.power(np.maximum(Y, 1e-300), 1.0 / 3.0),
                 (kk * Y + 16.0) / 116.0)
    return (116.0 * y - 16.0) / 100.0


def _clahe_clip_histograms(hist: np.ndarray, limit: int) -> np.ndarray:
    """ClipCLAHEHistogram (enhance.c:302), vectorized across tiles.

    hist: (T, bins) int64.  Replicates the integer main pass (carry
    cumulative_excess per tile) and the strided redistribution sweeps."""
    T, bins = hist.shape
    h = hist.astype(np.int64).copy()
    cum = np.maximum(h - limit, 0).sum(axis=1)
    step = cum // bins
    excess = limit - step                       # per-tile threshold
    for i in range(bins):
        hi = h[:, i]
        over = hi > limit
        mid = (~over) & (hi > excess)
        low = ~(over | mid)
        cum = cum - np.where(mid, hi - excess, 0) - np.where(low, step, 0)
        h[:, i] = np.where(over | mid, limit, hi + np.where(low, step, 0))
    # strided leftover sweeps (do-while with progress check)
    idx = np.arange(bins)
    prev = cum + 1
    while np.any((cum > 0) & (cum < prev)):
        prev = cum.copy()
        active = cum > 0
        stp = np.maximum(bins // np.maximum(cum, 1), 1)
        onstride = (idx[None, :] % stp[:, None]) == 0
        eligible = onstride & (h < limit) & active[:, None]
        rank = np.cumsum(eligible, axis=1)
        inc = eligible & (rank <= cum[:, None])
        h += inc
        cum = cum - inc.sum(axis=1)
    return h


def clahe_reference(img: torch.Tensor, tile_width: int = 0,
                    tile_height: int = 0, bins: int = 128,
                    clip_limit: float = 3.0) -> torch.Tensor:
    """CLAHEImage (enhance.c:616): the exact integer Zuiderveld pipeline.

    width/height are tile dimensions in PIXELS (0 → dims>>3); the canvas
    is padded to a tile multiple, pad split half-before/half-after with
    edge virtual pixels (enhance.c:706).  L-channel shorts are binned by
    lut[s]=s/(65535/bins+1), per-tile histograms clipped by the integer
    redistribution of ClipCLAHEHistogram, mapped to shorts by truncation
    (MapCLAHEHistogram), and blended on the (tiles+1)² block grid with
    the half-tile border blocks and integer corner weights of
    InterpolateCLAHE (enhance.c:406).  The L channel runs on the host in
    float64 numpy (the products y·x·Q exceed float32's integer range for
    large tiles); the Lab conversions run on the image's device."""
    h, w = img.shape[-3], img.shape[-2]
    tw = int(tile_width) or (w >> 3) or 1
    th = int(tile_height) or (h >> 3) or 1
    if clip_limit == 1.0:
        return img
    bins = min(int(bins) or 128, 256)
    lab = cs.convert(img[..., :3], "srgb", "lab")
    if img.dim() > 3:
        raise ValueError("clahe_reference expects a single image")
    # exact f64 L through the reference's own gamma series; the stored
    # value is an f32 quantum (sRGBTransformImage writes ClampToQuantum),
    # and ScaleQuantumToShort adds 0.5f then truncates
    # (quantum-private.h:517)
    rgbq = img[..., :3].detach().cpu().numpy().astype(np.float64) * 65535.0
    Lq = np.float32(65535.0 * _srgb_quantum_to_lab_L_exact(rgbq))
    px = (tw - (w % tw)) % tw
    py = (th - (h % th)) % th
    lt, tp = px >> 1, py >> 1
    Lp = np.pad(Lq, [(tp, py - tp), (lt, px - lt)], mode="edge")
    Hp, Wp = Lp.shape
    ty, tx = Hp // th, Wp // tw
    shorts = np.clip(np.floor((Lp + np.float32(0.5)).astype(np.float64)),
                     0, 65535).astype(np.int64)
    delta = 65535 // bins + 1
    b = shorts // delta                               # lut[] bin index
    # per-tile histograms
    tiles = b.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(
        ty * tx, th * tw)
    hist = np.zeros((ty * tx, bins), np.int64)
    np.add.at(hist, (np.repeat(np.arange(ty * tx), th * tw),
                     tiles.reshape(-1)), 1)
    limit = max(int(clip_limit * (tw * th) / bins), 1)
    hist = _clahe_clip_histograms(hist, limit)
    # MapCLAHEHistogram: truncated scaled CDF, clamped to the range max
    scale = 65535.0 / (tw * th)
    maps = np.minimum((scale * np.cumsum(hist, axis=1)).astype(np.int64),
                      65535)                          # (T, bins)
    maps = maps.reshape(ty, tx, bins)
    # block grid: (ty+1) x (tx+1); border blocks are half tiles
    Y, X = np.mgrid[0:Hp, 0:Wp]
    h0, w0 = th >> 1, tw >> 1
    by = np.clip((Y - h0) // th + 1, 0, ty)
    bx = np.clip((X - w0) // tw + 1, 0, tx)
    ystart = np.where(by == 0, 0, h0 + (by - 1) * th)
    xstart = np.where(bx == 0, 0, w0 + (bx - 1) * tw)
    Hb = np.where(by == 0, h0, np.where(by == ty, (th + 1) >> 1, th))
    Wb = np.where(bx == 0, w0, np.where(bx == tx, (tw + 1) >> 1, tw))
    yw = Hb - (Y - ystart)                            # InterpolateCLAHE y
    xw = Wb - (X - xstart)                            # InterpolateCLAHE x
    t_y0 = np.clip(by - 1, 0, ty - 1)
    t_y1 = np.clip(by, 0, ty - 1)
    t_x0 = np.clip(bx - 1, 0, tx - 1)
    t_x1 = np.clip(bx, 0, tx - 1)
    mflat = maps.reshape(-1)

    def gather(tyi, txi):
        return mflat[(tyi * tx + txi) * bins + b].astype(np.float64)

    q12, q22 = gather(t_y0, t_x0), gather(t_y0, t_x1)
    q11, q21 = gather(t_y1, t_x0), gather(t_y1, t_x1)
    out_s = np.floor((yw * (xw * q12 + (Wb - xw) * q22)
                      + (Hb - yw) * (xw * q11 + (Wb - xw) * q21))
                     / (Wb.astype(np.float64) * Hb))
    Lnew = (out_s / 65535.0)[tp:tp + h, lt:lt + w]
    Lnew = torch.from_numpy(np.ascontiguousarray(Lnew)).to(
        device=img.device, dtype=img.dtype)
    out = cs.convert(torch.cat([Lnew[..., None], lab[..., 1:]], dim=-1),
                     "lab", "srgb")
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicate padding of the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def clahe(img: torch.Tensor, tiles_x: int = 8, tiles_y: int = 8,
          bins: int = 128, clip_limit: float = 3.0) -> torch.Tensor:
    """CLAHEImage (enhance.c:616): contrast-limited adaptive equalization.

    Works on the L channel of Lab like the reference; the tile
    histograms are one bincount, clipping redistributes the excess, and
    each pixel blends the 4 surrounding tile LUTs bilinearly: the grid
    shifted by half a tile, so every (th, tw) block reads a FIXED set of
    4 corner LUTs.  Zeros mean defaults (CLAHEImage treats 0 bins/limit
    as 128/no-clip).  Takes tile COUNTS; clahe_reference() above maps the
    reference's tile-size arguments onto this."""
    from .histogram import _bin_index, _histogram_fixed_batched

    tiles_x = int(tiles_x) or 8
    tiles_y = int(tiles_y) or 8
    bins = int(bins) or 128
    clip_limit = float(clip_limit) if clip_limit else float(bins)
    lab = cs.convert(img[..., :3], "srgb", "lab")
    L = lab[..., 0]
    h, w = L.shape[-2], L.shape[-1]
    th, tw = -(-h // tiles_y), -(-w // tiles_x)

    Lp = _edge_pad(L, 0, th * tiles_y - h, 0, tw * tiles_x - w)
    lead = Lp.shape[:-2]
    tiles = Lp.reshape(lead + (tiles_y, th, tiles_x, tw)).movedim(-2, -3)
    flat = tiles.reshape(lead + (tiles_y * tiles_x, th * tw))
    hists = _histogram_fixed_batched(
        _bin_index(flat, bins).reshape(-1, th * tw), bins).reshape(
            lead + (tiles_y * tiles_x, bins))

    # clip & redistribute (reference ClipCLAHEHistogram)
    limit = clip_limit * (th * tw) / bins
    excess = torch.sum((hists - limit).clamp(min=0.0), dim=-1, keepdim=True)
    hists = torch.clamp(hists, max=limit) + excess / bins
    cdf = torch.cumsum(hists, dim=-1)
    total = cdf[..., -1:]
    cmin = cdf[..., :1]
    luts = ((cdf - cmin) * _prec(total - cmin)).reshape(
        lead + (tiles_y, tiles_x, bins))

    # the grid shifted by half a tile: block (i, j) reads the LUTs of
    # tiles (i-1, j-1), (i-1, j), (i, j-1) and (i, j), clipped to the grid
    pad_t, pad_l = th // 2, tw // 2
    by, bx = tiles_y + 1, tiles_x + 1
    binp = _edge_pad(_bin_index(L, bins), pad_t, by * th - h - pad_t,
                     pad_l, bx * tw - w - pad_l)
    blocks = binp.reshape(lead + (by, th, bx, tw)).movedim(-2, -3)
    blocks = blocks.reshape(lead + (by, bx, th * tw))
    dev = img.device
    iy = torch.arange(by, device=dev)
    ix = torch.arange(bx, device=dev)
    y0c, y1c = (iy - 1).clamp(0, tiles_y - 1), iy.clamp(0, tiles_y - 1)
    x0c, x1c = (ix - 1).clamp(0, tiles_x - 1), ix.clamp(0, tiles_x - 1)

    def corner(yc, xc):
        lut = luts[..., yc[:, None], xc[None, :], :]  # (..., by, bx, bins)
        return torch.gather(lut, -1, blocks)

    # in-block bilinear weights: with pad = th//2, the global coordinate
    # ty_f = (y+0.5)/th - 0.5 lands at i - 1 + fy inside block i, where
    # fy = (ly + 0.5 + 0.5*(th % 2)) / th (exact for even and odd th)
    fy = (torch.arange(th, dtype=torch.float32, device=dev) + 0.5 +
          0.5 * (th % 2)) / th
    fx = (torch.arange(tw, dtype=torch.float32, device=dev) + 0.5 +
          0.5 * (tw % 2)) / tw
    wy = torch.stack([1.0 - fy, fy], -1)              # (th, 2)
    wx = torch.stack([1.0 - fx, fx], -1)              # (tw, 2)
    wgt = (wy[:, None, :, None] * wx[None, :, None, :]).reshape(th * tw, 4)
    blended = (corner(y0c, x0c) * wgt[:, 0] + corner(y0c, x1c) * wgt[:, 1]
               + corner(y1c, x0c) * wgt[:, 2] + corner(y1c, x1c) * wgt[:, 3])
    blended = blended.reshape(lead + (by, bx, th, tw)).movedim(-2, -3)
    blended = blended.reshape(lead + (by * th, bx * tw))
    Lnew = blended[..., pad_t:pad_t + h, pad_l:pad_l + w]
    out = cs.convert(torch.cat([Lnew[..., None], lab[..., 1:]], dim=-1),
                     "lab", "srgb")
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# LUT application ops
# ---------------------------------------------------------------------------

def clut(img: torch.Tensor, lut_img: torch.Tensor,
         method: str = "bilinear", lut_alpha: bool = False,
         has_alpha: bool = False) -> torch.Tensor:
    """ClutImage (enhance.c:798-990): per-channel lookup through a CLUT
    image sampled along its DIAGONAL — channel value v maps to clut
    position (v·(cols−adjust), v·(rows−adjust)) interpolated by
    ``method`` (adjust = 0 for integer interpolation, 1 otherwise); the
    input is first quantized to Q16 (ScaleQuantumToMap truncation).
    Alpha-carrying cluts interpolate premultiplied (pixel.c
    InterpolatePixelInfo AlphaBlendPixelInfo)."""
    hl, wl = lut_img.shape[-3], lut_img.shape[-2]
    cl = lut_img.shape[-1]
    lut = lut_img
    blend = lut_alpha and cl in (2, 4)
    if blend:
        a = lut[..., -1:]
        lut = torch.cat([lut[..., :-1] * a, a], -1)
    method = (method or "bilinear").lower()
    adjust = 0 if method == "integer" else 1
    c = img.shape[-1]
    t = torch.floor(img.clamp(0.0, 1.0) * 65535.0) / 65535.0
    px = t * (wl - adjust)
    py = t * (hl - adjust)
    if method in ("integer",):
        ix = px.to(torch.int64).clamp(0, wl - 1)
        iy = py.to(torch.int64).clamp(0, hl - 1)
        samp = lut[iy, ix]                       # (..., C, cl)
    elif method in ("nearest", "nearestneighbor", "point"):
        ix = torch.floor(px + 0.5).to(torch.int64).clamp(0, wl - 1)
        iy = torch.floor(py + 0.5).to(torch.int64).clamp(0, hl - 1)
        samp = lut[iy, ix]
    else:                                        # bilinear (default)
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = (px - x0)[..., None]
        fy = (py - y0)[..., None]
        x0 = x0.to(torch.int64)
        y0 = y0.to(torch.int64)
        x0c, y0c = x0.clamp(0, wl - 1), y0.clamp(0, hl - 1)
        x1c, y1c = (x0 + 1).clamp(0, wl - 1), (y0 + 1).clamp(0, hl - 1)
        samp = (lut[y0c, x0c] * (1 - fx) * (1 - fy)
                + lut[y0c, x1c] * fx * (1 - fy)
                + lut[y1c, x0c] * (1 - fx) * fy
                + lut[y1c, x1c] * fx * fy)
    if blend:
        al = samp[..., -1:]
        samp = torch.cat(
            [samp[..., :-1] / torch.where(al.abs() < 1e-12, 1.0, al), al], -1)
    # channel ch of the pixel reads channel ch of the interpolated clut
    # entry at the position driven by the pixel's own channel value
    outs = []
    for ch in range(c):
        if has_alpha and ch == c - 1:
            if blend:
                outs.append(samp[..., ch, cl - 1])
            else:           # clut_map alpha is OpaqueAlpha when clut has none
                outs.append(torch.ones_like(samp[..., ch, 0]))
            continue
        lch = min(ch, cl - 1)
        if blend and lch == cl - 1:
            lch = max(cl - 2, 0)
        outs.append(samp[..., ch, lch])
    return torch.stack(outs, dim=-1)


def hald_clut(img: torch.Tensor, hald: torch.Tensor) -> torch.Tensor:
    """HaldClutImage (enhance.c): trilinear 3-D LUT lookup.

    hald is the (side, side, 3) Hald image; cube size n = cbrt(side²).
    """
    side = hald.shape[-3]
    n = round(side ** (2.0 / 3.0))
    cube = hald.reshape(-1, hald.shape[-1])[: n * n * n].reshape(n, n, n, -1)
    # cube indexed [b, g, r] per hald layout (r fastest)
    pos = img[..., :3].clamp(0.0, 1.0) * (n - 1)
    lo = torch.floor(pos)
    f = pos - lo
    lo = lo.to(torch.int64)
    hi = (lo + 1).clamp(max=n - 1)
    r0, g0, b0 = lo[..., 0], lo[..., 1], lo[..., 2]
    r1, g1, b1 = hi[..., 0], hi[..., 1], hi[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = cube[b0, g0, r0] * (1 - fr) + cube[b0, g0, r1] * fr
    c10 = cube[b0, g1, r0] * (1 - fr) + cube[b0, g1, r1] * fr
    c01 = cube[b1, g0, r0] * (1 - fr) + cube[b1, g0, r1] * fr
    c11 = cube[b1, g1, r0] * (1 - fr) + cube[b1, g1, r1] * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    out = c0 * (1 - fb) + c1 * fb
    if img.shape[-1] > 3:
        out = torch.cat([out[..., :3], img[..., 3:]], dim=-1)
    return out


def color_decision_list(img: torch.Tensor, slope=(1.0, 1.0, 1.0),
                        offset=(0.0, 0.0, 0.0), power=(1.0, 1.0, 1.0),
                        saturation: float = 1.0) -> torch.Tensor:
    """ColorDecisionListImage (ASC CDL, enhance.c)."""
    s = torch.as_tensor(slope, dtype=img.dtype, device=img.device)
    o = torch.as_tensor(offset, dtype=img.dtype, device=img.device)
    p = torch.as_tensor(power, dtype=img.dtype, device=img.device)
    out = torch.pow(torch.clamp(img[..., :3] * s + o, 0.0, 1.0), p)
    luma = (0.2126 * out[..., 0] + 0.7152 * out[..., 1] +
            0.0722 * out[..., 2])[..., None]
    out = luma + saturation * (out - luma)
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def white_balance(img: torch.Tensor) -> torch.Tensor:
    """WhiteBalanceImage (enhance.c): neutralize mean a*/b* in Lab."""
    lab = cs.convert(img[..., :3], "srgb", "lab")
    mean_a = lab[..., 1].mean()
    mean_b = lab[..., 2].mean()
    L = lab[..., 0]
    a = lab[..., 1] - (mean_a - 0.5) * (L / 1.0) * 1.1
    b = lab[..., 2] - (mean_b - 0.5) * (L / 1.0) * 1.1
    out = cs.convert(torch.stack([L, a, b], dim=-1), "lab", "srgb")
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


_ENHANCE_WEIGHTS = np.array([
    [5, 8, 10, 8, 5],
    [8, 20, 40, 20, 8],
    [10, 40, 80, 40, 10],
    [8, 20, 40, 20, 8],
    [5, 8, 10, 8, 5]], np.float32)


def enhance(img: torch.Tensor) -> torch.Tensor:
    """EnhanceImage (enhance.c:1848 EnhancePixel): 5x5 similarity-gated
    weighted mean.  A neighbor is included when the mean-modulated color
    distance (4+mR)dR^2 + (7-mG)dG^2 + (5-mB)dB^2 (+ (5-mA)dA^2) < 0.069;
    output is (sum w*v + W/2)/W in quantum units, the +0.5-quantum bias
    kept.  A single channel uses the red coefficient."""
    from ..core.virtual_pixel import pad_spatial

    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    xp = pad_spatial(x, (2, 2), (2, 2), "edge")
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for dy in range(5):
        for dx in range(5):
            nb = xp[:, dy:dy + h, dx:dx + w, :]
            mean = (nb + x) / 2.0
            dist = nb - x
            if c >= 3:
                d2 = ((4.0 + mean[..., 0]) * dist[..., 0] ** 2 +
                      (7.0 - mean[..., 1]) * dist[..., 1] ** 2 +
                      (5.0 - mean[..., 2]) * dist[..., 2] ** 2)
                for extra in range(3, c):
                    d2 = d2 + (5.0 - mean[..., extra]) * dist[..., extra] ** 2
            else:
                d2 = (4.0 + mean[..., 0]) * dist[..., 0] ** 2
            wgt = (d2 < 0.069).to(x.dtype)[..., None] * \
                float(_ENHANCE_WEIGHTS[dy, dx])
            num = num + wgt * nb
            den = den + wgt
    # +total_weight/2 in quantum units = +0.5/65535 after normalization
    out = torch.where(den > _EPS, (num + den * (0.5 / 65535.0)) /
                      den.clamp(min=_EPS), x)
    return out.reshape(img.shape)


def contrast(img: torch.Tensor, sharpen: bool = True) -> torch.Tensor:
    """ContrastImage (enhance.c:1392): sinusoid on HSB brightness,
    b += 0.5*sign*(0.5*(sin(pi*(b-0.5))+1) - b), clamped (enhance.c:1370).
    """
    sign = 1.0 if sharpen else -1.0
    color = img[..., :3] if img.shape[-1] >= 3 else img

    def curve(b):
        b = b + 0.5 * sign * (0.5 * (torch.sin(math.pi * (b - 0.5)) + 1.0)
                              - b)
        return b.clamp(0.0, 1.0)

    if color.shape[-1] == 1:
        out = curve(color[..., 0])[..., None]
    else:
        hsb = cs.convert(color, "srgb", "hsb")
        hsb = torch.cat([hsb[..., :2], curve(hsb[..., 2])[..., None]], -1)
        out = cs.convert(hsb, "hsb", "srgb")
    if img.shape[-1] > color.shape[-1]:
        out = torch.cat([out, img[..., color.shape[-1]:]], dim=-1)
    return out


def local_contrast(img: torch.Tensor, radius: float = 10.0,
                   strength: float = 10.0) -> torch.Tensor:
    """LocalContrastImage (effect.c:2014): unsharp against a wide
    luma-only blur, replicated exactly.

    width = (ssize_t)(max(cols,rows) * 0.002 * |radius|) — C truncation
    (effect.c:2070).  The blur is a separable ASYMMETRIC triangle filter
    over the Rec709 luma: taps at offsets -width..-1 carry weights
    1..width, the center carries width+1, offsets +1..+width-2 carry
    width..3, and offsets width-1/width are never read (effect.c:2151-
    2163 scanline loops); every pass divides by (width+1)^2 regardless
    of the true tap sum.  The vertical pass reads edge-replicated
    virtual pixels; the horizontal pass reads the vertical result with
    reflect-101 column padding written by the mirror stores at
    effect.c:2173-2177.  Finally mult = (L + (L-blur)*strength/100)/L
    scales R,G,B (effect.c:2245-2259), clamped."""
    h, w = img.shape[-3], img.shape[-2]
    width = int(max(h, w) * 0.002 * abs(radius))
    luma = (0.212656 * img[..., 0] + 0.715158 * img[..., 1]
            + 0.072186 * img[..., 2]).to(torch.float32)
    total = float((width + 1) * (width + 1))
    if width == 0:
        blur = torch.zeros_like(luma)
    else:
        # loop 1 (effect.c:2151): taps -width..-1, weights 1..width;
        # loop 2 (effect.c:2156): width-1 taps starting AT the center,
        # weights width+1 descending — for width==1 loop 2 is empty and
        # the center pixel is never read.
        wts = np.zeros(2 * width + 1, np.float64)
        for i in range(width):
            wts[i] = i + 1.0
        for k in range(width - 1):
            wts[width + k] = width + 1.0 - k
        wts /= total

        def _pass(x, axis, mode):
            n = x.shape[axis]
            pos = np.arange(-width, n + width)
            if mode == "edge":
                idx = np.clip(pos, 0, n - 1)
            else:          # numpy's "reflect": mirror without the edge
                period = max(2 * (n - 1), 1)
                idx = np.abs(pos) % period
                idx = np.where(idx >= n, period - idx, idx)
            xp = x.index_select(axis, torch.from_numpy(idx).to(x.device))
            acc = torch.zeros_like(x)
            for i, wt in enumerate(wts):
                if wt == 0.0:
                    continue
                acc = acc + float(np.float32(wt)) * xp.narrow(axis, i, n)
            return acc

        blur = _pass(luma, luma.dim() - 2, "edge")       # vertical
        blur = _pass(blur, luma.dim() - 1, "reflect")    # horizontal
    mult = (luma + (luma - blur) * (strength / 100.0)) / torch.where(
        luma.abs() < 1e-12, 1e-12, luma)
    return torch.clamp(img * mult[..., None], 0.0, 1.0)
