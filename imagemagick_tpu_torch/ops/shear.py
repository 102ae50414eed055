"""Shear / deskew (shear.c).

Port of ``imagemagick_tpu/ops/shear.py``: XShearImage/YShearImage,
ShearImage and DeskewImage (shear.c:557), 90° rotations through
transform.py's rotate90/180/270.  A shear is an inverse-mapped warp with
a fixed shift per row or column — one gather on the image's device
instead of a row-copy loop.

Deskew's skew detection runs on the device too: the Radon sums of
``deskew_angle_reference`` are integer work in int64 tensors, one set of
tensor ops per butterfly level, so the angle equals the JAX one exactly;
``deskew_angle``'s projection variances are float64 sums of 0/1 values,
exact in any order.  Only the angle comes back to the host.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .distort import _grid, sample_bilinear


def x_shear(img: torch.Tensor, degrees: float,
            background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """XShearImage: shift rows horizontally by tan(angle)*(y - cy)."""
    h, w = img.shape[-3], img.shape[-2]
    shear = math.tan(math.radians(degrees))
    extra = int(abs(shear) * h + 0.5)
    nw = w + extra
    yy, xx = _grid(h, nw, img.dtype, img.device)
    cy = (h - 1) / 2.0
    u = xx - extra / 2.0 - shear * (yy - cy)
    return sample_bilinear(img, u, yy, background)


def y_shear(img: torch.Tensor, degrees: float,
            background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """YShearImage: shift columns vertically."""
    h, w = img.shape[-3], img.shape[-2]
    shear = math.tan(math.radians(degrees))
    extra = int(abs(shear) * w + 0.5)
    nh = h + extra
    yy, xx = _grid(nh, w, img.dtype, img.device)
    cx = (w - 1) / 2.0
    v = yy - extra / 2.0 - shear * (xx - cx)
    return sample_bilinear(img, xx, v, background)


def _frac_shift(img: torch.Tensor, d: torch.Tensor, axis: int,
                bg: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Paeth fractional shift: resample lines of `img` along `axis` at
    (index - d), linear blend (XShearImage's area-blend transfer,
    shear.c:1228), background outside; `active` masks which lines move.

    d is per-line (shape matches the OTHER spatial axis)."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    if axis == -2:  # horizontal shift, d per row: d shape (h, 1)
        pos = torch.arange(w, dtype=img.dtype, device=dev)[None, :] - d
    else:           # vertical shift, d per column: d shape (1, w)
        pos = torch.arange(h, dtype=img.dtype, device=dev)[:, None] - d
    lo = torch.floor(pos)
    frac = (pos - lo)[..., None]
    loi = lo.to(torch.int64)
    size = w if axis == -2 else h
    flat = img.reshape(img.shape[:-3] + (h * w, img.shape[-1]))
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]

    def at(i):
        ic = i.clamp(0, size - 1)
        idx = (yy * w + ic.clamp(0, w - 1)) if axis == -2 else \
              (ic.clamp(0, h - 1) * w + xx)
        px = flat.index_select(-2, idx.reshape(-1)).reshape(img.shape)
        ok = ((i >= 0) & (i < size))[..., None]
        return torch.where(ok, px, bg)

    out = at(loi) * (1.0 - frac) + at(loi + 1) * frac
    return torch.where(active[..., None], out, img)


def shear(img: torch.Tensor, x_degrees: float, y_degrees: float,
          background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """ShearImage (shear.c:1569): bordered canvas + X then Y Paeth
    fractional shear passes + CropToFitImage.

    Bounds (shear.c:1614): bounds.width = w + round(|shx|·h), border
    bx = ceil(w + (|shx|·h − w)/2 − 0.5), by = ceil(h + (|shy|·bw − h)/2
    − 0.5); X pass shifts rows y∈[0,h) by shx·(y − h/2), Y pass shifts
    columns x∈[0,bw) by shy·(x − bw/2); final crop from the sheared
    source corners (CropToFitImage, shear.c:136-169)."""
    shx = -math.tan(math.radians(math.fmod(x_degrees, 360.0)))
    shy = math.tan(math.radians(math.fmod(y_degrees, 360.0)))
    if shx == 0.0 and shy == 0.0:
        return img
    h, w, c = img.shape[-3:]
    dev = img.device
    bw = w + int(math.floor(abs(shx) * h + 0.5))
    bx = int(math.ceil(w + (abs(shx) * h - w) / 2.0 - 0.5))
    by = int(math.ceil(h + (abs(shy) * bw - h) / 2.0 - 0.5))
    bg = torch.tensor(tuple(background or (1.0,) * c)[:c], dtype=img.dtype,
                      device=dev)
    H, W = h + 2 * by, w + 2 * bx
    canvas = bg.expand(img.shape[:-3] + (H, W, c)).contiguous()
    canvas[..., by:by + h, bx:bx + w, :] = img
    # X pass: active rows [by, by+h), relative y
    yy = torch.arange(H, dtype=img.dtype, device=dev)
    dx_row = (shx * (yy - by - h / 2.0))[:, None]
    active_rows = ((yy >= by) & (yy < by + h))[:, None].expand(H, W)
    canvas = _frac_shift(canvas, dx_row, -2, bg, active_rows)
    # Y pass: active columns [cx, cx+bw), relative x
    cx = (W - bw) // 2
    xx = torch.arange(W, dtype=img.dtype, device=dev)
    dy_col = (shy * (xx - cx - bw / 2.0))[None, :]
    active_cols = ((xx >= cx) & (xx < cx + bw))[None, :].expand(H, W)
    canvas = _frac_shift(canvas, dy_col, -3, bg, active_cols)
    # CropToFitImage
    xs, ys = [], []
    for ex, ey in ((-w / 2.0, -h / 2.0), (w / 2.0, -h / 2.0),
                   (-w / 2.0, h / 2.0), (w / 2.0, h / 2.0)):
        ex2 = ex + shx * ey
        ey2 = ey + shy * ex2
        xs.append(ex2 + W / 2.0)
        ys.append(ey2 + H / 2.0)
    gx = int(math.ceil(min(xs) - 0.5))
    gy = int(math.ceil(min(ys) - 0.5))
    gw = int(math.floor(max(xs) - min(xs) + 0.5))
    gh = int(math.floor(max(ys) - min(ys) + 0.5))
    return canvas[..., gy:gy + gh, gx:gx + gw, :]


def _projection_variance(binary: torch.Tensor, angle: float) -> torch.Tensor:
    """Radon-style row-projection sharpness for one skew angle, as a
    0-dim float64 tensor on the binary image's device: the projection
    sums 0/1 values, so it is exact in any order of the scatter-add."""
    h, w = binary.shape
    dev = binary.device
    shear_px = math.tan(math.radians(angle))
    n = h + int(abs(shear_px) * w) + 2
    xs = np.arange(0, w, max(w // 64, 1))       # subsample columns
    shifts = torch.from_numpy(shear_px * xs).to(dev)
    rows = torch.arange(h, dtype=torch.float64, device=dev)
    idx = (rows[:, None] + shifts[None, :]).to(torch.int64).clamp(0, n - 1)
    cols = binary[:, torch.from_numpy(xs).to(dev)]
    proj = torch.zeros(n, dtype=torch.float64, device=dev)
    proj.index_add_(0, idx.reshape(-1), cols.reshape(-1))
    d = proj[1:] - proj[:-1]
    return (d * d).sum()


def deskew_angle(img: torch.Tensor, threshold: float = 0.4,
                 max_angle: float = 10.0) -> float:
    """DeskewImage angle detection: maximize projection-profile sharpness.

    Each pass of angles (41 coarse, then 11 around the winner) reads its
    variances back once; the first strict maximum wins, as in the JAX
    loop."""
    from .enhance import grayscale

    arr = grayscale(img)[..., 0] if img.shape[-1] >= 3 else img[..., 0]
    binary = (arr < threshold).to(torch.float64)  # text = dark
    best_a, best_v = 0.0, -1.0
    for angles in (np.linspace(-max_angle, max_angle, 41), None):
        if angles is None:
            # refine around the coarse winner
            angles = np.linspace(best_a - 0.5, best_a + 0.5, 11)
        vs = torch.stack([_projection_variance(binary, float(a))
                          for a in angles]).tolist()
        for a, v in zip(angles, vs):
            if v > best_v:
                best_v, best_a = v, float(a)
    return best_a


def _radon_projection(mat: torch.Tensor, sign: int,
                      projection: torch.Tensor) -> None:
    """RadonProjection (shear.c): Götz-Druckmüller butterfly discrete
    Radon over the popcount matrix; accumulates squared row-derivative
    energy per column into projection[width + sign*x - 1].

    ``mat`` is an int64 (rows, width) tensor.  Each butterfly level runs
    as one gather and one add over every column at once: output column
    x + 2i (x + 2i + 1) of a group of 2·step columns is column x + i plus
    column x + i + step read i (i + 1) rows lower, zero past the last
    row — the JAX loop's rolls and row ranges."""
    rows, width = mat.shape
    dev = mat.device
    p = mat
    step = 1
    while step < width:
        col = np.arange(width)
        x = col - col % (2 * step)
        i = (col - x) // 2
        odd = (col - x) % 2
        el = torch.from_numpy(x + i).to(dev)
        nb = torch.from_numpy(x + i + step).to(dev)
        shift = torch.from_numpy(i + odd).to(dev)
        padded = torch.cat([p, p.new_zeros((step, width))], 0)
        r = torch.arange(rows, device=dev)[:, None] + shift[None, :]
        p = p[:, el] + padded.reshape(-1)[(r * width + nb[None, :])]
        step *= 2
    d = p[1:] - p[:-1]
    sums = (d * d).sum(0)
    pos = torch.from_numpy(width + sign * np.arange(width) - 1).to(dev)
    projection[pos] = sums


def deskew_angle_reference(img: torch.Tensor, threshold: float = 0.4
                           ) -> float:
    """DeskewImage's Radon skew detection (shear.c:557): bilevel bits
    (any of r,g,b below threshold), byte-packed popcounts, two Radon
    passes (mirrored byte order, signs -1/+1), first-strict-max bin;
    degrees = -atan(skew/width/8).  One (H, W, C) image; the sums run in
    int64 on its device and only the skew bin comes back."""
    arr = (img[..., :3] if img.shape[-1] >= 3 else
           img[..., :1].expand(img.shape[:-1] + (3,))).to(torch.float64)
    h, w = arr.shape[-3], arr.shape[-2]
    dev = arr.device
    bitsmap = (arr < threshold).any(dim=-1)
    nbytes = (w + 7) // 8
    width = 1
    while width < nbytes:
        width <<= 1
    # pack bits into bytes (last byte left-aligned) and popcount
    padded = torch.zeros((h, nbytes * 8), dtype=torch.int64, device=dev)
    padded[:, :w] = bitsmap.to(torch.int64)
    counts = padded.reshape(h, nbytes, 8).sum(-1)       # (h, nbytes)
    projection = torch.zeros(2 * width - 1, dtype=torch.int64, device=dev)
    m1 = torch.zeros((h, width), dtype=torch.int64, device=dev)
    m1[:, :nbytes] = torch.flip(counts, (1,))           # reversed: --i order
    _radon_projection(m1, -1, projection)
    m2 = torch.zeros((h, width), dtype=torch.int64, device=dev)
    m2[:, :nbytes] = counts                             # forward: i++ order
    _radon_projection(m2, 1, projection)
    best, i = torch.max(projection, 0)
    best, i = torch.stack([best, i]).tolist()
    skew = i - width + 1 if best > 0 else 0
    return math.degrees(-math.atan(skew / width / 8.0))


def deskew(img: torch.Tensor, threshold: float = 0.4,
           background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """DeskewImage (shear.c:557): Radon skew detection + bestfit affine
    rotation correction (AffineTransformImage with background VP)."""
    from .distort import affine_projection_bestfit

    angle = deskew_angle_reference(img, threshold)
    a = math.radians(math.fmod(angle, 360.0))
    matrix = (math.cos(a), math.sin(a), -math.sin(a), math.cos(a), 0.0, 0.0)
    return affine_projection_bestfit(
        img, matrix, background=background or [1.0] * img.shape[-1])
