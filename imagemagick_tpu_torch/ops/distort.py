"""Distortions: inverse-mapped warps (distort.c / resample.c), the sampler.

Port of ``imagemagick_tpu/ops/distort.py``: so far only its bilinear
sampler, which ``blur.kuwahara`` and composite's displace read through.
The warps themselves (``DistortImage``'s methods, EWA sampling) are
ROADMAP.md Queue 1, 'The other op families under ops/' (distort comes
next).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _make_tap(img: torch.Tensor,
              background: Optional[Sequence[float]] = None,
              vp: str = "edge"):
    """Build a tap(yi, xi) gather honoring the virtual-pixel policy.

    vp='edge' with a background keeps the constant fill outside the
    canvas; any other vp routes through core.virtual_pixel's coordinate
    remapping (cache.c:2928-3066), with vp_constant supplying the fill for
    constant/tile-fill methods.

    Coordinates of shape (H', W') read every image of a batch at the same
    points, as the JAX ``jnp.take`` does; coordinates with the image's
    leading axes read each image at its own points (the JAX function
    raises there: its ``take`` crosses the two batches)."""
    from ..core.virtual_pixel import vp_constant, vp_tap

    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    img2 = img.reshape(lead + (h * w, c))

    def gather(idx: torch.Tensor) -> torch.Tensor:
        if idx.dim() > 2 and lead:
            idx = idx.expand(lead + idx.shape[-2:])
            flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, c))
            return torch.gather(img2, -2, flat).reshape(idx.shape + (c,))
        return img2.index_select(-2, idx.reshape(-1)).reshape(
            lead + idx.shape + (c,))

    m = (vp or "edge").lower()
    if m in ("edge", "undefined", ""):
        def clamped(yi, xi):
            return gather(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))

        if background is None:
            return clamped
        bg = torch.tensor(tuple(background)[:c], dtype=img.dtype,
                          device=img.device)

        def tap(yi, xi):
            valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
            return torch.where(valid, clamped(yi, xi), bg)
        return tap
    const = vp_constant(m, background, c)
    bg = None if const is None else torch.tensor(const, dtype=img.dtype,
                                                 device=img.device)

    def tap(yi, xi):
        yc, xc, mask = vp_tap(yi, xi, h, w, m)
        px = gather(yc * w + xc)
        if mask is not None and bg is not None:
            px = torch.where(mask[..., None], bg, px)
        return px
    return tap


def sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    background: Optional[Sequence[float]] = None,
                    vp: str = "edge") -> torch.Tensor:
    """Bilinear lookup of (..., H, W, C) at fractional coords (u=x, v=y).

    Off-canvas taps contribute the policy's color INSIDE the bilinear
    blend, like the reference's InterpolatePixelChannels over a
    virtual-pixel cache view.
    """
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.to(torch.int32).to(torch.int64)
    y0i = y0.to(torch.int32).to(torch.int64)
    tap = _make_tap(img, background, vp)
    p00 = tap(y0i, x0i)
    p01 = tap(y0i, x0i + 1)
    p10 = tap(y0i + 1, x0i)
    p11 = tap(y0i + 1, x0i + 1)
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy
