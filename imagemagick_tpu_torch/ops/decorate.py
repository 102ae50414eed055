"""Decorations: border, 3-D frame, raise (decorate.c).

Port of ``imagemagick_tpu/ops/decorate.py`` (BorderImage, FrameImage,
RaiseImage of MagickCore/decorate.c).  Each is a pad or a slice plus
shading masks, on the image's device.  The frame's bevel rows are
painted on the host in numpy, as the JAX function paints them (every
middle row alike, so once), and copied up once.  Every function is
bit-exact to the JAX one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def border(img: torch.Tensor, width: int, height: int,
           color: Sequence[float] = (0.75, 0.75, 0.75, 1.0)) -> torch.Tensor:
    """BorderImage: surround with a solid border."""
    c = img.shape[-1]
    col = torch.tensor(list(color[:c]), dtype=img.dtype, device=img.device)
    h, w = img.shape[-3], img.shape[-2]
    out = col.expand(img.shape[:-3] + (h + 2 * height, w + 2 * width, c)) \
        .clone()
    out[..., height:height + h, width:width + w, :] = img
    return out


def _frame_rows(h: int, w: int, c: int, width: int, height: int,
                outer_bevel: int, inner_bevel: int,
                matte_color: Sequence[float]):
    """The frame's canvas (decorate.c:169 lighting) as the JAX function
    paints it row by row, in three parts: the matte row, the row every
    middle row gets (the sides and the inner bevel's side strips), and
    the rows the top and bottom bevels paint ({row: (ow, c) float32})."""
    matte = np.asarray(matte_color[:c], np.float32)
    # decorate.c:65-69 modulate constants (ScaleCharToQuantum(v) -> v/255):
    #   accentuate = matte*(1-80/255)+80/255, highlight = *(1-125/255)+125/255,
    #   shadow = matte*135/255, trough = matte*110/255.
    acc = np.clip(matte * (1.0 - 80.0 / 255.0) + 80.0 / 255.0, 0, 1)
    hi = np.clip(matte * (1.0 - 125.0 / 255.0) + 125.0 / 255.0, 0, 1)
    sh = matte * (135.0 / 255.0)
    tr = matte * (110.0 / 255.0)
    ob, ib = outer_bevel, inner_bevel
    bw = ob + ib
    fx, fy = width, height          # frame_info->x / ->y (border per side)
    oh, ow = h + 2 * fy, w + 2 * fx
    xs = np.arange(ow)
    x0 = ob + max(fx - bw, 0)
    inner = (xs >= x0) & (xs < x0 + w + 2 * ib)
    matte_row = np.ones((ow, c), np.float32) * matte
    rows = {}

    def paint(y, masks_colors):
        if -oh <= y < 0:
            y += oh                 # numpy's negative row index
        row = rows.setdefault(y, matte_row.copy())
        for m, col in masks_colors:
            row[m] = col

    sides = [(xs < ob, hi), (xs >= ow - ob, sh)]
    middle = sides + [((xs >= x0) & (xs < x0 + ib), sh),
                      ((xs >= x0 + ib + w) & (xs < x0 + 2 * ib + w), hi)]
    # top: outer bevel (hi wedge / acc / sh), flat matte band, inner bevel
    for y in range(min(ob, oh)):
        paint(y, [(xs < ow - y, acc), (xs < y, hi), (xs >= ow - y, sh)])
    for y in range(ob, min(ob + max(fy - bw, 0), oh)):
        paint(y, sides)
    for k in range(ib):
        y = ob + max(fy - bw, 0) + k
        if y >= oh:
            break
        paint(y, sides + [(inner & (xs >= x0 + w + 2 * ib - k), hi),
                          (inner & (xs < x0 + w + 2 * ib - k), tr),
                          (inner & (xs < x0 + k), sh)])
    # middle rows: the template, and over the top's rows that reach them
    template = matte_row.copy()
    for m, col in middle:
        template[m] = col
    for y in [y for y in rows if fy <= y < fy + h]:
        paint(y, middle)
    # bottom: inner bevel (row base+j carries parameter ib-1-j), flat band,
    # outer bevel (row oh-1-k carries wedge parameter k)
    base = fy + h
    for k in range(ib):
        y = base + (ib - 1 - k)
        if y >= oh:
            continue
        paint(y, sides + [(inner & (xs >= x0 + w + 2 * ib - k), hi),
                          (inner & (xs < x0 + w + 2 * ib - k), acc),
                          (inner & (xs < x0 + k), sh)])
    for y in range(base + ib, base + ib + max(fy - bw, 0)):
        if y >= oh:
            break
        paint(y, sides)
    for k in range(ob):
        paint(oh - 1 - k, [(xs >= k, tr), (xs < k, hi), (xs >= ow - k, sh)])
    return matte_row, template, rows


def frame(img: torch.Tensor, width: int = 6, height: int = 6,
          outer_bevel: int = 2, inner_bevel: int = 2,
          matte_color: Sequence[float] = (0.74, 0.74, 0.74, 1.0)
          ) -> torch.Tensor:
    """FrameImage: 3-D beveled frame (decorate.c:169).

    Highlight, accentuate, shadow and trough are the matte color modulated
    by the reference's AccentuateFactor/ShadowFactor lighting.  The canvas
    is built from its distinct rows, copied up once: the matte row, the
    middle rows' template and the bevels' rows."""
    h, w, c = img.shape[-3:]
    matte_row, template, rows = _frame_rows(
        h, w, c, width, height, outer_bevel, inner_bevel, matte_color)
    oh, ow = h + 2 * height, w + 2 * width
    keys = sorted(rows)
    host = np.concatenate([matte_row[None], template[None]] +
                          [rows[y][None] for y in keys], 0)
    up = torch.from_numpy(host).to(img.device, img.dtype)
    pick = np.zeros(oh, np.int64)
    pick[height:height + h] = 1
    pick[keys] = np.arange(2, 2 + len(keys))
    canvas = up[torch.from_numpy(pick).to(img.device)]
    out = canvas.expand(img.shape[:-3] + canvas.shape).clone()
    out[..., height:height + h, width:width + w, :] = img
    return out


def raise_image(img: torch.Tensor, width: int = 6, height: int = 6,
                raised: bool = True) -> torch.Tensor:
    """RaiseImage (decorate.c:632): four modulated zones.

    Top band: Highlight left wedge (x<y), Accentuate middle, Shadow
    right; middle band: Highlight/Shadow side strips; bottom band:
    Highlight wedge (x<H-y), Trough middle, Shadow right.  Factors
    190/255 (highlight/shadow) and 135/255 (accentuate/trough) against
    foreground=white / background=black (swapped when raised=False)."""
    h, w = img.shape[-3], img.shape[-2]
    ys = torch.arange(h, device=img.device)[:, None].expand(h, w)
    xs = torch.arange(w, device=img.device)[None, :].expand(h, w)
    fg, bg = (1.0, 0.0) if raised else (0.0, 1.0)
    HF = 190.0 / 255.0
    AF = 135.0 / 255.0

    top = ys < height
    bottom = ys >= h - height
    middle = ~top & ~bottom
    hl = (top & (xs < ys)) | (middle & (xs < width)) | \
        (bottom & (xs < h - ys))
    sh = (top & (xs >= w - ys)) | (middle & (xs >= w - width)) | \
        (bottom & (xs >= w - (h - ys)))
    ac = top & ~hl & ~sh
    tr = bottom & ~hl & ~sh

    out = img
    out = torch.where(hl[..., None], img * HF + fg * (1.0 - HF), out)
    out = torch.where(ac[..., None], img * AF + fg * (1.0 - AF), out)
    out = torch.where(tr[..., None], img * AF + bg * (1.0 - AF), out)
    out = torch.where(sh[..., None], img * HF + bg * (1.0 - HF), out)
    return out.clamp(0.0, 1.0)
