"""Geometric transforms: crop/flip/roll/extent/... (transform.c family).

Port of ``imagemagick_tpu/ops/transform.py``.  Every op of transform.c is
a row-copy loop; here each is a slice, flip, pad or concatenation of the
tensor on its own device, so each is bit-exact to the JAX function.
Trim is the only data-dependent one: ``trim_bounds`` compares on the
image's device in float64 and reads back only the box; the slice is taken
with those host ints.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _fill(img: torch.Tensor, background: Optional[Sequence[float]]
          ) -> torch.Tensor:
    c = img.shape[-1]
    if background is None:
        return torch.zeros((c,), dtype=img.dtype, device=img.device)
    return torch.tensor(list(background)[:c], dtype=img.dtype,
                        device=img.device)


def _canvas(fill: torch.Tensor, shape) -> torch.Tensor:
    return fill.expand(tuple(shape)).contiguous()


def crop(img: torch.Tensor, x: int, y: int, width: int, height: int,
         background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """CropImage (transform.c): extract a WxH region at +X+Y.

    The full requested geometry is kept (static shapes — `-crop` followed
    by `+repage`).  A region wholly outside the canvas is the background;
    one partly outside is padded by edge replication without a
    background and with zeros with one, as the JAX function pads
    (``jnp.pad``'s constant mode without ``constant_values``).
    """
    h, w, c = img.shape[-3:]
    x0, y0 = int(x), int(y)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + width, w), min(y0 + height, h)
    if sx0 >= sx1 or sy0 >= sy1:
        return _canvas(_fill(img, background),
                       img.shape[:-3] + (height, width, c))
    region = img[..., sy0:sy1, sx0:sx1, :]
    py0, px0 = sy0 - y0, sx0 - x0
    py1 = height - (sy1 - y0)
    px1 = width - (sx1 - x0)
    if py0 or px0 or py1 or px1:
        if background is None:
            rh, rw = region.shape[-3], region.shape[-2]
            iy = torch.arange(-py0, rh + py1, device=img.device)
            ix = torch.arange(-px0, rw + px1, device=img.device)
            region = region.index_select(-3, iy.clamp(0, rh - 1)) \
                .index_select(-2, ix.clamp(0, rw - 1))
        else:
            out = img.new_zeros(img.shape[:-3] + (height, width, c))
            out[..., py0:py0 + region.shape[-3],
                px0:px0 + region.shape[-2], :] = region
            region = out
    return region


def chop(img: torch.Tensor, x: int, y: int, width: int, height: int
         ) -> torch.Tensor:
    """ChopImage: remove a row/column band at the given offset."""
    h, w, _ = img.shape[-3:]
    x0, x1 = max(x, 0), min(x + width, w)
    y0, y1 = max(y, 0), min(y + height, h)
    out = torch.cat([img[..., :y0, :, :], img[..., y1:, :, :]], dim=-3)
    return torch.cat([out[..., :, :x0, :], out[..., :, x1:, :]], dim=-2)


def excerpt(img: torch.Tensor, x: int, y: int, width: int, height: int
            ) -> torch.Tensor:
    """ExcerptImage: raw subregion (no virtual-pixel handling)."""
    return img[..., y:y + height, x:x + width, :]


def extent(img: torch.Tensor, x: int, y: int, width: int, height: int,
           background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """ExtentImage: place the canvas inside a WxH field at -X-Y offset."""
    c = img.shape[-1]
    out = _canvas(_fill(img, background), img.shape[:-3] + (height, width, c))
    h, w = img.shape[-3], img.shape[-2]
    # destination offsets (extent uses -x,-y semantics: crop from (x, y))
    sy0, sx0 = max(-y, 0), max(-x, 0)
    iy0, ix0 = max(y, 0), max(x, 0)
    cy = min(h - iy0, height - sy0)
    cx = min(w - ix0, width - sx0)
    if cy <= 0 or cx <= 0:
        return out
    out[..., sy0:sy0 + cy, sx0:sx0 + cx, :] = \
        img[..., iy0:iy0 + cy, ix0:ix0 + cx, :]
    return out


def flip(img: torch.Tensor) -> torch.Tensor:
    """FlipImage: vertical reflection."""
    return torch.flip(img, (-3,))


def flop(img: torch.Tensor) -> torch.Tensor:
    """FlopImage: horizontal reflection."""
    return torch.flip(img, (-2,))


def roll(img: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """RollImage: circular shift."""
    return torch.roll(img, (y, x), dims=(-3, -2))


def shave(img: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """ShaveImage: trim x columns / y rows from every side."""
    h, w = img.shape[-3], img.shape[-2]
    return img[..., y:h - y, x:w - x, :]


def splice(img: torch.Tensor, x: int, y: int, width: int, height: int,
           background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """SpliceImage: insert a band of background at the offset."""
    c = img.shape[-1]
    fill = _fill(img, background)
    w = img.shape[-2]
    rowband = _canvas(fill, img.shape[:-3] + (height, w, c))
    out = torch.cat([img[..., :y, :, :], rowband, img[..., y:, :, :]],
                    dim=-3)
    colband = _canvas(fill, out.shape[:-3] + (out.shape[-3], width, c))
    return torch.cat([out[..., :, :x, :], colband, out[..., :, x:, :]],
                     dim=-2)


def transpose(img: torch.Tensor) -> torch.Tensor:
    """TransposeImage: flip + rotate270 == mirror across top-left diagonal."""
    return torch.transpose(img, -3, -2)


def transverse(img: torch.Tensor) -> torch.Tensor:
    """TransverseImage: mirror across bottom-right diagonal."""
    return torch.transpose(torch.flip(img, (-3, -2)), -3, -2)


def rotate90(img: torch.Tensor) -> torch.Tensor:
    """IntegralRotateImage(1) — 90° clockwise (shear.c:700)."""
    return torch.flip(torch.transpose(img, -3, -2), (-2,))


def rotate180(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (-3, -2))


def rotate270(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.transpose(img, -3, -2), (-3,))


def _first_last(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first, last) index of True in a 1-D bool tensor, as 0-dim
    tensors on its device (n and -1 when there is none)."""
    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)
    return (torch.where(mask, idx, n).min(),
            torch.where(mask, idx, -1).max())


def trim_bounds(img: torch.Tensor, fuzz: float = 0.0
                ) -> Tuple[int, int, int, int]:
    """GetImageBoundingBox (attribute.c:391-565) for TrimImage.

    Each edge compares against ITS corner pixel (left/top vs top-left,
    right vs top-right, bottom vs bottom-left) with
    IsFuzzyEquivalencePixelInfo (pixel.c:6028): fuzz floored at √½
    quanta, alpha distance gated first, color distances scaled by the
    alpha product (both-transparent pixels compare equal).  A batch is
    trimmed by the bounds of image 0.  The comparisons run in float64 on
    the image's device, in the JAX function's (numpy's) order of
    operations, and only the box comes back to the host: (x, y, width,
    height) as Python ints.
    """
    arr = img[0] if img.dim() == 4 else img
    H, W, C = arr.shape
    QR = 65535.0
    dev = arr.device
    q = arr.to(torch.float64) * QR
    has_alpha = C in (2, 4)
    fz = max(float(fuzz) * QR, math.sqrt(0.5)) ** 2
    qr = torch.tensor(QR, dtype=torch.float64, device=dev)

    def differs(target):
        # vectorized IsFuzzyEquivalencePixelInfo == MagickFalse; the
        # channel sum runs in numpy's order, a true division by a device
        # scalar (CUDA divides by a host scalar through its reciprocal)
        col, tc = (q[..., :-1], target[:-1]) if has_alpha else (q, target)
        if has_alpha:
            ap, at = q[..., -1], target[-1]
            d0 = (ap - at) * (ap - at)
            scale = (ap / qr) * (at / qr)
        s = None
        for k in range(col.shape[-1]):
            d = col[..., k] - tc[k]
            d = d * d * scale if has_alpha else d * d
            s = d if s is None else s + d
        if not has_alpha:
            return s > fz * 3.0
        # alpha distance gated first; both ~transparent compare equal
        return (d0 > fz) | (~(scale <= 1e-12) & (d0 * 3.0 + s > fz * 3.0))

    n0 = differs(q[0, 0])
    n1 = differs(q[0, W - 1])
    n2 = differs(q[H - 1, 0])
    x0, _ = _first_last(n0.any(0))
    y0, _ = _first_last(n0.any(1))
    _, x1 = _first_last(n1.any(0))
    _, y1 = _first_last(n2.any(1))
    x0, y0, x1, y1 = torch.stack([x0, y0, x1, y1]).tolist()
    any1, any2 = x1 >= 0, y1 >= 0
    x1, y1 = max(x1, 0), max(y1, 0)
    if x1 == 0 and not any1 and y1 == 0 and not any2:
        return 0, 0, W, H
    w = x1 - (x0 - 1)
    h = y1 - (y0 - 1)
    if w <= 0 or h <= 0:
        return 0, 0, W, H
    return x0, y0, w, h


def trim(img: torch.Tensor, fuzz: float = 0.0) -> torch.Tensor:
    """TrimImage: crop away constant borders (bounds read back as ints)."""
    x, y, w, h = trim_bounds(img, fuzz)
    return img[..., y:y + h, x:x + w, :]


def auto_orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """AutoOrientImage (transform.c): apply EXIF orientation 1-8."""
    ops = {
        1: lambda x: x,
        2: flop,
        3: rotate180,
        4: flip,
        5: transpose,
        6: rotate90,
        7: transverse,
        8: rotate270,
    }
    return ops.get(int(orientation), lambda x: x)(img)
