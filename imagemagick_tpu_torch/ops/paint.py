"""Paint ops: flood fill, opaque/transparent paint, oil paint (paint.c).

Port of ``imagemagick_tpu/ops/paint.py`` (FloodfillPaintImage,
OpaquePaintImage, TransparentPaintImage, OilPaintImage and GradientImage
of MagickCore/paint.c), as PyTorch ops on the image's device.

Flood fill is mask dilation gated by the fuzz-match predicate, repeated
to its fixpoint: steps after the fixpoint change nothing, so the loop
reads the mask back once every ``_CHECK_EVERY`` steps (a host sync)
instead of after every step, and never runs past ``max_iters``.  On a
batch each image floods from its own seed pixel's color.  Oil paint
counts each window's intensity bins in integers, a strip of rows at a
time, so that its (N, rows, W, 256) count table stays bounded.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.image import checked_device
from .channel import channel_mean

_CHECK_EVERY = 32          # dilation steps between fixpoint tests
_OIL_CELLS = 1 << 28       # count-table cells of one oil-paint strip


def _fuzz_match(img: torch.Tensor, target: torch.Tensor, fuzz: float
                ) -> torch.Tensor:
    """IsFuzzyEquivalencePixel analog: squared-distance fuzz compare."""
    d = img - target
    return channel_mean(d * d) <= (fuzz * fuzz + 1e-12)


def _color(values, img: torch.Tensor, n: int) -> torch.Tensor:
    return torch.tensor(list(values), dtype=img.dtype,
                        device=img.device)[:n]


def opaque_paint(img: torch.Tensor, target_color: Sequence[float],
                 fill_color: Sequence[float], fuzz: float = 0.0,
                 invert: bool = False) -> torch.Tensor:
    """OpaquePaintImage: recolor pixels fuzz-matching the target."""
    c = img.shape[-1]
    m = _fuzz_match(img, _color(target_color, img, c), fuzz)
    if invert:
        m = ~m
    return torch.where(m[..., None], _color(fill_color, img, c), img)


def transparent_paint(img: torch.Tensor, target_color: Sequence[float],
                      alpha: float = 0.0, fuzz: float = 0.0,
                      invert: bool = False) -> torch.Tensor:
    """TransparentPaintImage: set alpha where the color fuzz-matches
    (the last channel is alpha)."""
    t = _color(target_color, img, img.shape[-1] - 1)
    m = _fuzz_match(img[..., :-1], t, fuzz)
    if invert:
        m = ~m
    new_a = torch.where(m, torch.tensor(alpha, dtype=img.dtype,
                                        device=img.device), img[..., -1])
    return torch.cat([img[..., :-1], new_a[..., None]], dim=-1)


def _dilate4(m: torch.Tensor) -> torch.Tensor:
    g = m.clone()
    g[..., :-1, :] |= m[..., 1:, :]
    g[..., 1:, :] |= m[..., :-1, :]
    g[..., :, :-1] |= m[..., :, 1:]
    g[..., :, 1:] |= m[..., :, :-1]
    return g


def grow_to_fixpoint(mask: torch.Tensor, step, max_iters: int
                     ) -> torch.Tensor:
    """``mask`` after ``step`` is applied until it no longer changes, or
    ``max_iters`` times: the result of a loop that tests for a change
    after every step, with one host sync every ``_CHECK_EVERY`` steps."""
    it = 0
    while it < max_iters:
        before = mask
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            mask = step(mask)
            it += 1
        if torch.equal(mask, before):
            break
    return mask


def floodfill(img: torch.Tensor, x: int, y: int, fill_color: Sequence[float],
              fuzz: float = 0.0, max_iters: Optional[int] = None,
              target_color: Optional[Sequence[float]] = None) -> torch.Tensor:
    """FloodfillPaintImage (paint.c:112): 4-connected fill from a seed.

    Mask propagation: seed -> repeat (dilate & matchable) until fixpoint.
    The flood target is the explicit ``target_color`` when given (the CLI
    ``-floodfill geometry color`` form, mogrify.c) else the seed pixel of
    each image (the MVG ``color x,y floodfill`` form, draw.c)."""
    h, w, c = img.shape[-3:]
    if target_color is not None:
        target = _color(target_color, img, c)
    else:
        target = img[..., y, x, :][..., None, None, :]
    matchable = _fuzz_match(img, target, fuzz)  # (..., H, W)
    seed = torch.zeros_like(matchable)
    seed[..., y, x] = True
    mask = grow_to_fixpoint(seed & matchable,
                            lambda m: _dilate4(m) & matchable,
                            max_iters or (h + w))
    return torch.where(mask[..., None], _color(fill_color, img, c), img)


def oil_paint(img: torch.Tensor, radius: float = 3.0, sigma: float = 0.0,
              levels: int = 256) -> torch.Tensor:
    """OilPaintImage (paint.c:709): windowed mode of the pixel INTENSITY
    over NumberPaintBins=256 char bins; the output copies the pixel of the
    first bin to reach the window's final maximum, its last contributor
    in raster order (a strict ``>`` running max over the window's scan).
    Window from GetOptimalKernelWidth2D(radius, sigma)."""
    from .blur import optimal_kernel_width_2d

    k = optimal_kernel_width_2d(radius, sigma)
    r = (k - 1) // 2
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c))
    n = x.shape[0]
    if c >= 3:
        inten = (0.212656 * x[..., :1] + 0.715158 * x[..., 1:2] +
                 0.072186 * x[..., 2:3])
    else:
        inten = x[..., :1]
    q = ((inten.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.int32)
         .clamp(0, levels - 1))[..., 0]
    ih = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    iw = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    xp = x.index_select(1, ih).index_select(2, iw)
    qp = q.index_select(1, ih).index_select(2, iw).to(torch.int64)
    ctype = torch.uint8 if k * k < 256 else torch.int32
    rows = max(1, min(h, _OIL_CELLS // max(n * w * levels, 1)))
    out = torch.empty_like(x)
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        sr = y1 - y0
        counts = torch.zeros((n * sr * w * levels,), dtype=ctype,
                             device=img.device)
        base = torch.arange(n * sr * w, device=img.device) * levels
        best_count = torch.zeros((n, sr, w), dtype=ctype, device=img.device)
        best_color = x[:, y0:y1]
        for dy in range(k):
            for dx in range(k):
                nq = qp[:, y0 + dy:y1 + dy, dx:dx + w].reshape(-1)
                idx = base + nq
                cur = counts[idx] + 1
                counts[idx] = cur
                cur = cur.reshape(n, sr, w)
                upd = cur > best_count
                best_count = torch.where(upd, cur, best_count)
                best_color = torch.where(
                    upd[..., None], xp[:, y0 + dy:y1 + dy, dx:dx + w],
                    best_color)
        out[:, y0:y1] = best_color
    return out.reshape(img.shape)


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 as XLA folds it on the CPU:
    ``i * (1 / (n - 1))`` with the last value exactly 1."""
    if n <= 1:
        return torch.zeros((max(n, 0),), dtype=torch.float32, device=device)
    f32 = np.float32
    vals = np.append(np.arange(n - 1, dtype=f32) * (f32(1) / f32(n - 1)),
                     f32(1))
    return torch.from_numpy(vals).to(device)


def gradient_image(height: int, width: int, start: Sequence[float],
                   stop: Sequence[float], gradient_type: str = "linear",
                   angle: float = 0.0, device="cuda") -> torch.Tensor:
    """GradientImage (paint.c): linear/radial two-stop gradient canvas on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    device = checked_device(device, "gradient_image")
    c1 = torch.tensor(list(start), dtype=torch.float32, device=device)
    c2 = torch.tensor(list(stop), dtype=torch.float32, device=device)
    yy = _linspace01(height, device)[:, None]
    xx = _linspace01(width, device)[None, :]
    if gradient_type == "radial":
        dy, dx = yy - 0.5, xx - 0.5
        # a correctly rounded float32 sqrt, on the card and the CPU alike
        dist = torch.sqrt((dy * dy + dx * dx).double()).float()
        t = dist / torch.tensor(math.sqrt(0.5), dtype=torch.float32,
                                device=device)
    else:
        th = math.radians(angle)
        t = yy * math.cos(th) + xx * math.sin(th)
        span = torch.clamp(t.max() - t.min(), min=1e-12)
        t = (t - t.min()) / span
    t = t.clamp(0.0, 1.0)[..., None]
    return c1 * (1.0 - t) + c2 * t
