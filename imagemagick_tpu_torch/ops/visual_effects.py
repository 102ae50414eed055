"""Visual effects: noise, sepia, solarize, vignette, charcoal...
(visual-effects.c).

Port of ``imagemagick_tpu/ops/visual_effects.py``.  Each effect composes
the port's primitive families (warps from distort, convolutions from
blur, color math from colorspace and enhance) as PyTorch ops on the
image's device.  The blurs reach kernel K3 on a card where their taps
fit (``blur._separable_conv``: charcoal at sigma 1, the shadows at sigma
2 and 3); the vignette's sigma 10 takes two depthwise passes.

The random effects are split into a draw and a deterministic function
of the drawn variates: ``noise_variates`` + ``add_noise_from`` and
``sketch_variates`` + ``sketch_from``.  ``add_noise`` and ``sketch``
draw from a ``torch.Generator`` (a new one seeded 0 when none is given,
as the JAX functions default to a fixed key) and call the deterministic
half, so the same variates give the JAX function's result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import blur as bl
from . import enhance as en
from .distort import implode, swirl, wave  # re-exported effect warps
from .statistic import _generator

__all__ = ["add_noise", "add_noise_from", "noise_variates", "blue_shift",
           "charcoal", "colorize", "color_matrix", "sepia_tone", "solarize",
           "stegano", "stereo", "tint", "vignette", "sketch", "sketch_from",
           "sketch_variates", "shadow", "polaroid", "wavelet_denoise",
           "implode", "swirl", "wave"]


def _const(x: torch.Tensor, value) -> torch.Tensor:
    """A float32 constant (scalar or vector) on ``x``'s device."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _noise_kind(noise_type: str) -> str:
    t = noise_type.lower()
    if t in ("impulse", "saltandpepper", "salt-and-pepper"):
        return "impulse"
    if t in ("multiplicative", "multiplicativegaussian"):
        return "multiplicative"
    if t in ("uniform", "gaussian", "laplacian", "poisson", "random"):
        return t
    raise ValueError(f"unknown noise type {noise_type!r}")


def noise_variates(img: torch.Tensor, noise_type: str = "gaussian",
                   attenuate: float = 1.0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """The variates ``add_noise`` draws for ``img``, from ``generator``:
    uniform [0, 1) for uniform, impulse and random; two standard normals
    for gaussian; uniform [-0.4999, 0.4999) for laplacian; one standard
    normal for multiplicative; Poisson counts of mean
    ``max(img * 255 / max(a, 1e-3), 1e-6)`` for poisson."""
    t = _noise_kind(noise_type)
    g = _generator(img, generator)
    shape, dev = img.shape, img.device
    if t in ("uniform", "impulse", "random"):
        return (torch.rand(shape, generator=g, device=dev),)
    if t == "gaussian":
        return (torch.randn(shape, generator=g, device=dev),
                torch.randn(shape, generator=g, device=dev))
    if t == "laplacian":
        u = torch.rand(shape, generator=g, device=dev)
        return (u * 0.9998 - 0.4999,)
    if t == "multiplicative":
        return (torch.randn(shape, generator=g, device=dev),)
    lam = torch.clamp(img * 255.0 / max(attenuate, 1e-3), min=1e-6)
    return (torch.poisson(lam, generator=g),)


def add_noise_from(img: torch.Tensor, noise_type: str, attenuate: float,
                   variates: Sequence[torch.Tensor]) -> torch.Tensor:
    """AddNoiseImage's arithmetic on drawn ``variates`` (as
    ``noise_variates`` returns them).  The reference's quantum-scaled
    amplitudes: SigmaUniform 4, SigmaGaussian 4 with TauGaussian 20,
    SigmaImpulse 0.10, SigmaLaplacian 10, SigmaMultiplicativeGaussian 1
    (here 0.5), SigmaPoisson (gem.c:1604-1610 region)."""
    t = _noise_kind(noise_type)
    a = attenuate
    if t == "uniform":
        return torch.clamp(img + a * (4.0 / 255.0) * (variates[0] - 0.5),
                           0, 1)
    if t == "gaussian":
        n, tau = variates
        noise = img * a * n * 4.0 / 255.0 + a * tau * (20.0 / 255.0)
        return torch.clamp(img + noise, 0, 1)
    if t == "impulse":
        u = variates[0]
        thr = 0.5 * a * 0.10
        return torch.where(u < thr, 0.0,
                           torch.where(u > 1.0 - thr, 1.0, img))
    if t == "laplacian":
        u = variates[0]
        n = -torch.sign(u) * torch.log(1.0 - 2.0 * torch.abs(u))
        return torch.clamp(img + a * (10.0 / 255.0) * n / math.sqrt(2.0),
                           0, 1)
    if t == "multiplicative":
        return torch.clamp(img + img * a * variates[0] * 0.5, 0, 1)
    if t == "poisson":
        p = variates[0].to(img.dtype)
        return torch.clamp(p * max(a, 1e-3) / 255.0, 0, 1)
    return variates[0]


def add_noise(img: torch.Tensor, noise_type: str = "gaussian",
              attenuate: float = 1.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """AddNoiseImage (visual-effects.c; generators in gem.c
    GenerateDifferentialNoise): ``add_noise_from`` on variates drawn
    from ``generator``."""
    return add_noise_from(img, noise_type, attenuate,
                          noise_variates(img, noise_type, attenuate,
                                         generator))


def blue_shift(img: torch.Tensor, factor: float = 1.5) -> torch.Tensor:
    """BlueShiftImage (visual-effects.c): two averaging passes with the
    channel min then the channel max — p1 = (p + f*min)/2, out =
    (p1 + f*max)/2 per channel, clamped."""
    rgb = img[..., :3]
    mn = rgb.amin(dim=-1, keepdim=True)
    mx = rgb.amax(dim=-1, keepdim=True)
    out = 0.5 * (0.5 * (rgb + factor * mn) + factor * mx)
    out = torch.clamp(out, 0.0, 1.0)
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return out


def charcoal(img: torch.Tensor, radius: float = 0.0,
             sigma: float = 1.0) -> torch.Tensor:
    """CharcoalImage: edge -> blur -> normalize -> negate -> gray."""
    e = bl.edge_image(img, radius)
    b = bl.blur(e, radius, sigma)
    n = en.normalize(b)
    neg = 1.0 - n
    c = img.shape[-1]
    return en.grayscale(neg).repeat_interleave(c, dim=-1)[..., :c]


def colorize(img: torch.Tensor, color: Sequence[float],
             amount: Sequence[float]) -> torch.Tensor:
    """ColorizeImage: per-channel blend toward a fill color."""
    c = img.shape[-1]
    col = _const(img, list(color)[:c])
    a = torch.broadcast_to(_const(img, list(np.atleast_1d(amount))),
                           (c,))[:c]
    return torch.clamp(img * (1.0 - a) + col * a, 0, 1)


def color_matrix(img: torch.Tensor, matrix) -> torch.Tensor:
    """ColorMatrixImage (visual-effects.c:717-877): the user matrix fills
    the top-left of a 6x6 identity whose columns are FIXED roles
    [R, G, B, K, A, offset] and rows set [R, G, B, K, A].  A 3x3 matrix
    is therefore a plain RGB mix with no offset; only a 6-column matrix
    carries the affine term (column 5, scaled by QuantumRange).  K rows
    and columns are skipped for non-CMYK images; no clamping (HDRI)."""
    m6 = np.eye(6, dtype=np.float64)
    um = np.asarray(matrix, np.float64)
    n = um.shape[0]
    m6[:min(n, 6), :min(n, 6)] = um[:6, :6]
    m = [[float(v) for v in row] for row in m6]
    c = img.shape[-1]
    has_alpha = c in (2, 4)
    nrgb = 1 if c <= 2 else 3
    cols = [img[..., i] for i in range(nrgb)]
    if nrgb == 1:
        cols = cols * 3                           # gray replicates to RGB
    alpha = img[..., -1] if has_alpha else None
    ones = torch.ones(img.shape[:-1], dtype=img.dtype, device=img.device)
    rows = []
    for h in range(3 if nrgb == 3 else 1):
        s = (m[h][0] * cols[0] + m[h][1] * cols[1] + m[h][2] * cols[2]
             + m[h][5] * ones)                    # offset normalized by QR
        if has_alpha:
            s = s + m[h][4] * alpha
        rows.append(s)
    if has_alpha:
        s = (m[4][0] * cols[0] + m[4][1] * cols[1] + m[4][2] * cols[2]
             + m[4][4] * alpha + m[4][5] * ones)
        rows.append(s)
    return torch.stack(rows, dim=-1).to(img.dtype)


def sepia_tone(img: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """SepiaToneImage (visual-effects.c): per-channel intensity tone
    curves — r/g/b get shifted-and-clipped copies of the pixel intensity
    (offsets 0, t/6, with knees at t and 7t/6), then green/blue are
    floored at t/7 — followed by NormalizeImage + ContrastImage(sharpen)
    (visual-effects.c:1986-1987)."""
    i = (0.212656 * img[..., 0] + 0.715158 * img[..., 1] +
         0.072186 * img[..., 2])
    t = threshold
    r = torch.where(i > t, 1.0, i + 1.0 - t)
    g = torch.where(i > 7.0 * t / 6.0, 1.0, i + 1.0 - 7.0 * t / 6.0)
    b = torch.where(i < t / 6.0, 0.0, i - t / 6.0)
    floor = t / 7.0
    g = torch.clamp(g, min=floor)
    b = torch.clamp(b, min=floor)
    out = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return en.contrast(en.normalize(out), sharpen=True)


def solarize(img: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """SolarizeImage: negate above threshold."""
    return torch.where(img > threshold, 1.0 - img, img)


def stegano(img: torch.Tensor, watermark: torch.Tensor,
            offset: int = 0) -> torch.Tensor:
    """SteganoImage: hide a watermark in the LSBs (visual-effects.c).
    The quantum cast saturates inside int32's range first: a float out of
    an integer's range converts to an undefined value on the card.  A
    watermark larger than the image is cut to it (the JAX function raises
    on one)."""
    from .channel import channel_mean

    q = torch.clamp(img * 255.0 + 0.5, -2.0 ** 31, 2.0 ** 31 - 128) \
        .to(torch.int32)
    h = min(watermark.shape[-3], img.shape[-3])
    w = min(watermark.shape[-2], img.shape[-2])
    wm_bit = (channel_mean(watermark[..., :h, :w, :]) > 0.5) \
        .to(torch.int32)[..., None]
    bits = torch.zeros(img.shape[:-1] + (1,), dtype=torch.int32,
                       device=img.device)
    bits[..., :h, :w, :] = wm_bit
    q = (q & ~1) | bits
    return q.to(img.dtype) / _const(img, 255.0)


def stereo(left: torch.Tensor, right: torch.Tensor,
           x_offset: int = 0, y_offset: int = 0) -> torch.Tensor:
    """StereoAnaglyphImage (visual-effects.c:2626): red from the left
    image sampled at (x - x_offset, y - y_offset) through edge virtual
    pixels; green/blue from the right image in place."""
    h, w = left.shape[-3], left.shape[-2]
    if tuple(right.shape[-3:-1]) != (h, w):
        # the JAX function's stack raises a ValueError here too
        raise ValueError(f"stereo: images of {tuple(left.shape)} and "
                         f"{tuple(right.shape)}")
    ys = torch.clamp(torch.arange(h, device=left.device) - y_offset,
                     0, h - 1)
    xs = torch.clamp(torch.arange(w, device=left.device) - x_offset,
                     0, w - 1)
    shifted = left.index_select(-3, ys).index_select(-2, xs)
    return torch.stack([shifted[..., 0], right[..., 1], right[..., 2]],
                       dim=-1)


def tint(img: torch.Tensor, color: Sequence[float],
         blend: Sequence[float] = (100.0, 100.0, 100.0)) -> torch.Tensor:
    """TintImage (visual-effects.c:3003): per-channel midtone push.

    color = the -fill color (default black: identity); blend = the
    rho[,sigma,xi] percentages of the geometry argument.  Vector
    cv_c = blend_c*fill_c/100 - luma(fill); each channel moves by
    cv_c*(1 - 4*(v - 0.5)^2)."""
    c = [float(x) for x in tuple(color)[:3]]
    b = [float(x) for x in (tuple(blend) + (blend[-1],) * 3)[:3]]
    # GetPixelInfoIntensity: Rec709Luma on the fill color
    inten = 0.212656 * c[0] + 0.715158 * c[1] + 0.072186 * c[2]
    cv = _const(img, [b[i] * c[i] / 100.0 - inten for i in range(3)])
    rgb = img[..., :3]
    w = rgb - 0.5
    out = rgb + cv * (1.0 - 4.0 * w * w)
    if img.shape[-1] > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return torch.clamp(out, 0, 1)


def vignette(img: torch.Tensor, radius: float = 0.0, sigma: float = 10.0,
             x: Optional[float] = None, y: Optional[float] = None,
             background: Sequence[float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """VignetteImage (visual-effects.c): a white-filled ellipse of radii
    (W/2-x, H/2-y) on black, Gaussian-blurred (BlurImage), installed as
    the coverage mask: the result blends toward the BACKGROUND color
    (default white) and is opaque.  CLI defaults x = 0.1*W, y = 0.1*H
    (operation.c:3654)."""
    from .draw import ellipse_fill_stroke_alpha

    h, w = img.shape[-3], img.shape[-2]
    if x is None:
        x = 0.1 * w
    if y is None:
        y = 0.1 * h
    # visual-effects.c:3245 draws "ellipse cx,cy,rx,ry,0,360" with BOTH
    # white fill and white 1px stroke
    mask = ellipse_fill_stroke_alpha(h, w, w / 2.0, h / 2.0,
                                     max(w / 2.0 - x, 1.0),
                                     max(h / 2.0 - y, 1.0),
                                     device=img.device)
    mask = bl.blur(mask[..., None], radius, sigma).to(img.dtype)
    nc = min(img.shape[-1], 3)
    bg = _const(img, list(background)[:nc])
    color = img[..., :nc] * mask + bg * (1.0 - mask)
    return torch.cat([color, img[..., nc:]], dim=-1) \
        if img.shape[-1] > nc else color


def sketch_variates(img: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The uniform gray image of twice ``img``'s size that ``sketch``
    streaks: (..., 2H, 2W, 1), from ``generator``."""
    h, w = img.shape[-3], img.shape[-2]
    return torch.rand(img.shape[:-3] + (2 * h, 2 * w, 1),
                      generator=_generator(img, generator),
                      device=img.device, dtype=img.dtype)


def sketch_from(img: torch.Tensor, val: torch.Tensor, radius: float = 0.0,
                sigma: float = 1.0, angle: float = 0.0,
                has_alpha: bool = False) -> torch.Tensor:
    """SketchImage (visual-effects.c:2094-2213) on a drawn noise image
    ``val``: MotionBlur(radius, sigma, angle) it, EdgeImage(radius),
    clamp + normalize + negate, resize back to 50%, then
    ColorDodge-composite onto the source.  The final Blend(20x80) with a
    transparent clone is an alpha-only identity for opaque sources; for
    alpha sources it mixes 20% of the original premultiplied color."""
    from . import composite as comp
    from . import resize as rz

    h, w = img.shape[-3], img.shape[-2]
    c = img.shape[-1]
    noise = val.repeat_interleave(c, dim=-1)
    streaks = bl.motion_blur(noise, radius, sigma, angle)
    dodge = bl.edge_image(streaks, radius)
    dodge = en.normalize(torch.clamp(dodge, 0.0, 1.0))
    dodge = 1.0 - dodge
    dodge = rz.resize(dodge, h, w)
    out = comp.composite(img, dodge, "colordodge",
                         dst_alpha=has_alpha, src_alpha=False)
    if has_alpha and c in (2, 4):
        # Blend 20x80 with the (alpha-carrying) original clone
        out = comp.composite(out, img, "blend", dst_alpha=True,
                             src_alpha=True, args=(20.0, 80.0))
    return out[..., :c]


def sketch(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
           angle: float = 0.0, generator: Optional[torch.Generator] = None,
           has_alpha: bool = False) -> torch.Tensor:
    """SketchImage: ``sketch_from`` on ``sketch_variates`` drawn from
    ``generator``."""
    return sketch_from(img, sketch_variates(img, generator), radius, sigma,
                       angle, has_alpha)


def shadow(img_alpha: torch.Tensor, alpha_pct: float = 80.0,
           sigma: float = 3.0, x: int = 5, y: int = 5,
           color: Sequence[float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """ShadowImage (visual-effects.c): border the silhouette by
    2*sigma+0.5 px of transparency, set every pixel to the BACKGROUND
    color (the shadow color, default white) with alpha =
    src_alpha*pct/100, then Gaussian-blur the ALPHA channel only.  The
    result is the shadow image alone (the caller composites); x/y only
    move the page offsets, which the raster does not encode."""
    b = int(2.0 * sigma + 0.5)
    a = img_alpha[..., 3:4] if img_alpha.shape[-1] == 4 else \
        torch.ones(img_alpha.shape[:-1] + (1,), dtype=img_alpha.dtype,
                   device=img_alpha.device)
    a0 = torch.nn.functional.pad(a, (0, 0, b, b, b, b)) * (alpha_pct / 100.0)
    sh = bl.blur(a0, 0.0, sigma)
    col = _const(img_alpha, list(tuple(color)[:3]))
    return torch.cat([col.expand(sh.shape[:-1] + (3,)), sh], dim=-1)


def polaroid(img: torch.Tensor, angle: float = 0.0,
             background: Sequence[float] = (1.0, 1.0, 1.0),
             border_color: Sequence[float] = (223 / 255.0,) * 3
             ) -> torch.Tensor:
    """PolaroidImage (visual-effects.c:2297-2442), caption-less path.

    quantum = max(max(W,H)/25, 10); frame the image on a border_color
    canvas (+quantum each side, opaque), bend it (rotate 90 -> WaveImage
    (0.01*rows, 2*columns) -> rotate -90), drop an 80%/sigma 2 shadow
    offset quantum/3, flop the shadow, composite the picture over it at
    trunc(-0.01*W/2), rotate by angle over transparent, and trim.
    Returns RGBA."""
    from .composite import composite_at
    from .distort import rotate
    from .transform import flop, trim

    h, w = img.shape[-3], img.shape[-2]
    c = img.shape[-1]
    q = int(max(max(w, h) / 25.0, 10.0))
    bc = _const(img, list(tuple(border_color)[:3]))
    pic = torch.ones(img.shape[:-3] + (h + 2 * q, w + 2 * q, 4),
                     dtype=img.dtype, device=img.device)
    pic[..., :3] = bc
    rgb = img[..., :3] if c >= 3 else img[..., :1].repeat_interleave(3, -1)
    if c in (2, 4):   # compose over the frame color
        a = img[..., -1:]
        rgb = rgb * a + bc * (1.0 - a)
    pic[..., q:q + h, q:q + w, :3] = rgb
    # bend: rotate 90, wave, rotate back (transparent off-canvas)
    pic = rotate(pic, 90.0)
    # WaveImage forces Background virtual pixels (here "none") and
    # interpolates alpha-premultiplied: wave the premultiplied RGBA and
    # un-premultiply so partially-covered edges keep their color
    al = pic[..., -1:]
    pm = torch.cat([pic[..., :3] * al, al], -1)
    pm = wave(pm, 0.01 * pic.shape[-3], 2.0 * pic.shape[-2],
              background=(0.0, 0.0, 0.0, 0.0))
    al = pm[..., -1:]
    col = pm[..., :3] / torch.where(torch.abs(al) < 1e-12, 1.0, al)
    pic = torch.cat([col, al], -1)
    pic = rotate(pic, -90.0)
    sh = shadow(pic, 80.0, 2.0, q // 3, q // 3, color=tuple(background)[:3])
    sh = flop(sh)
    # CompositeImage places at raw canvas coords (the shadow's page
    # offsets are metadata only); C ssize_t cast truncates toward zero
    px = int(-0.01 * pic.shape[-2] / 2.0)
    out = composite_at(sh, pic, "over", px, 0, dst_alpha=True,
                       src_alpha=True)
    out = rotate(out, angle, background=(0.0, 0.0, 0.0, 0.0))
    return trim(out)


def _reflect_index(n: int, shift: int, device) -> torch.Tensor:
    """Indices of ``x[i + shift]`` for i in [0, n) under numpy's
    ``reflect`` padding (no edge repeat; repeated for shifts past the
    extent)."""
    i = torch.arange(n, device=device) + shift
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i > n - 1, period - i, i)


def _hat_transform(x: torch.Tensor, axis: int, scale: int) -> torch.Tensor:
    """dcraw's a-trous hat filter (visual-effects.c:3478 HatTransform):
    0.25*(2*x[i] + x[i-s] + x[i+s]) with REFLECT (no edge repeat)
    boundaries."""
    n = x.shape[axis]
    left = x.index_select(axis, _reflect_index(n, -scale, x.device))
    right = x.index_select(axis, _reflect_index(n, scale, x.device))
    return 0.25 * (2.0 * x + left + right)


def wavelet_denoise(img: torch.Tensor, threshold: float = 0.05,
                    softness: float = 0.0, levels: int = 5) -> torch.Tensor:
    """WaveletDenoiseImage (visual-effects.c:3515): 5-level a-trous
    transform with dcraw's [1,2,1]/4 hat kernel (stride 2^level, reflect
    boundaries), per-level shrink magnitude = threshold*noise_levels
    [level] (:3542, :3706): coefficients beyond +-m move in by
    m-softness*m, the rest scale by softness; final image = sum of the
    shrunk details + the last smooth."""
    noise_levels = (0.8002, 0.2735, 0.1202, 0.0585, 0.0291, 0.0152, 0.0080)
    hp = img
    acc = None
    low = img
    for level in range(levels):
        s = 1 << level
        low = _hat_transform(_hat_transform(hp, img.dim() - 3, s),
                             img.dim() - 2, s)
        detail = hp - low
        m = float(threshold) * noise_levels[level]
        shrink = float(m - softness * m)
        shrunk = torch.where(detail < -m, detail + shrink,
                             torch.where(detail > m, detail - shrink,
                                         detail * softness))
        acc = shrunk if acc is None else acc + shrunk
        hp = low
    return torch.clamp(acc + low, 0.0, 1.0)
