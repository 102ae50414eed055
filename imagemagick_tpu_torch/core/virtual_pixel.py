"""Virtual-pixel (edge extension) policies as explicit pads.

The reference resolves out-of-canvas reads per pixel inside the cache layer
(MagickCore/cache.c:2627-2720; policy enum in cache-view.h:27-45).  Here an
edge policy is an explicit pad applied before a windowed op runs.  The
simple modes are index maps along H and W (one gather per axis); the
constant fills pad with a color.  Samplers that read at arbitrary integer
coordinates remap them per policy instead (``vp_tap``, cache.c:2928-3066),
reading ``vp_constant``'s color where the policy falls back to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Virtual pixel methods (cache-view.h:27-45) -> pad strategy.
_SIMPLE_MODES = {
    "undefined": "edge",
    "edge": "edge",
    "mirror": "symmetric",
    "tile": "wrap",
    "random": "edge",       # approximation; true random fill is rarely load-bearing
    "dither": "edge",
}

_CONSTANT_FILLS = {
    "black": 0.0,
    "white": 1.0,
    "gray": 0.5,
    "grey": 0.5,
    "transparent": 0.0,
    "background": None,  # uses the background color argument
}


# cache.c:2625 DitherMatrix — DitherX/Y only index the first 8 entries
_DITHER8 = (0, 48, 12, 60, 3, 51, 15, 63)


def vp_constant(method: str, background=None, channels: int = 3):
    """The virtual-pixel fill color for constant-fill methods, or None.

    Matches cache.c:2851-2896: black/transparent = 0, gray =
    QuantumRange/2 (0.5 in HDRI), white/mask = 1; 'background' uses the
    image background color.  Alpha is opaque for all but transparent."""
    m = (method or "edge").lower()
    alpha = channels in (2, 4)
    nc = channels - 1 if alpha else channels
    if m == "black":
        col = [0.0] * nc + ([1.0] if alpha else [])
    elif m in ("gray", "grey"):
        col = [0.5] * nc + ([1.0] if alpha else [])
    elif m in ("white", "mask"):
        col = [1.0] * nc + ([1.0] if alpha else [])
    elif m == "transparent":
        col = [0.0] * channels
    elif m in ("background", "horizontaltile", "verticaltile",
               "checkertile"):
        # the tile-fill variants use the background color for their
        # outside regions (cache.c:2888 default case)
        if background is None:
            return None
        col = list(background)[:channels]
        while len(col) < channels:
            col.append(1.0)
    else:
        return None
    return tuple(col)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of int64 values (the int32 product of
    the JAX package's hash)."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def vp_tap(yi: torch.Tensor, xi: torch.Tensor, h: int, w: int,
           method: str = "edge"):
    """Remap integer tap coordinates per virtual-pixel policy.

    Returns (yc, xc, const_mask): in-image int64 coordinates plus a bool
    mask of taps that must read the vp_constant color instead (None when
    the method never falls back to a constant).  Mirrors the coordinate
    arithmetic of cache.c:2928-3066 (floored VirtualPixelModulo, mirror
    quotient parity, DitherX/Y clamped offsets, tile-variant fills)."""
    m = (method or "edge").lower()
    yi = yi.to(torch.int64)
    xi = xi.to(torch.int64)
    if m in ("edge", "undefined", ""):
        return yi.clamp(0, h - 1), xi.clamp(0, w - 1), None
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    if m in ("black", "gray", "grey", "white", "mask", "transparent",
             "background"):
        return yi.clamp(0, h - 1), xi.clamp(0, w - 1), ~inside
    qy = torch.div(yi, h, rounding_mode="floor")
    ry = torch.remainder(yi, h)
    qx = torch.div(xi, w, rounding_mode="floor")
    rx = torch.remainder(xi, w)
    if m == "tile":
        return ry, rx, None
    if m == "mirror":
        my = torch.where(qy & 1 == 1, h - 1 - ry, ry)
        mx = torch.where(qx & 1 == 1, w - 1 - rx, rx)
        return my, mx, None
    if m == "horizontaltile":
        return ry, rx, (yi < 0) | (yi >= h)
    if m == "verticaltile":
        return ry, rx, (xi < 0) | (xi >= w)
    if m == "horizontaltileedge":
        return yi.clamp(0, h - 1), rx, None
    if m == "verticaltileedge":
        return ry, xi.clamp(0, w - 1), None
    if m == "checkertile":
        return ry, rx, ((qx ^ qy) & 1) != 0
    if m == "dither":
        # only out-of-range taps take the dithered offset; in-range reads
        # go through the normal path untouched (cache.c:2915-2957)
        d8 = torch.tensor(_DITHER8, dtype=torch.int64, device=yi.device)
        dy = (yi + d8[yi & 7] - 32).clamp(0, h - 1)
        dx = (xi + d8[xi & 7] - 32).clamp(0, w - 1)
        return torch.where(inside, yi.clamp(0, h - 1), dy), \
            torch.where(inside, xi.clamp(0, w - 1), dx), None
    if m == "random":
        # the JAX package's deterministic hash stand-in for the
        # reference's RNG stream (cache.c:2942 RandomX/Y), in int32
        hy = torch.remainder(_wrap_int32(yi * 26544357 + xi * 40503), h)
        hx = torch.remainder(_wrap_int32(xi * 26544357 + yi * 40503), w)
        return torch.where(inside, yi.clamp(0, h - 1), hy), \
            torch.where(inside, xi.clamp(0, w - 1), hx), None
    return yi.clamp(0, h - 1), xi.clamp(0, w - 1), None


def _pad_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of every position of an axis padded by (lo, hi),
    with numpy.pad's 'edge', 'symmetric' and 'wrap' semantics."""
    i = np.arange(-lo, n + hi)
    if mode == "symmetric":
        m = np.mod(i, 2 * n)
        return np.where(m < n, m, 2 * n - 1 - m)
    if mode == "wrap":
        return np.mod(i, n)
    return np.clip(i, 0, n - 1)


def pad_spatial(
    img: torch.Tensor,
    pad_h: Tuple[int, int],
    pad_w: Tuple[int, int],
    method: str = "edge",
    background: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Pad the H and W axes of an (..., H, W, C) tensor per virtual-pixel policy."""
    method = (method or "edge").lower()
    h, w, c = img.shape[-3:]
    if method in _SIMPLE_MODES:
        mode = _SIMPLE_MODES[method]
        ih = torch.from_numpy(_pad_index(h, *pad_h, mode)).to(img.device)
        iw = torch.from_numpy(_pad_index(w, *pad_w, mode)).to(img.device)
        return img.index_select(-3, ih).index_select(-2, iw)
    if method in _CONSTANT_FILLS:
        fill = _CONSTANT_FILLS[method]
        pads = (0, 0, pad_w[0], pad_w[1], pad_h[0], pad_h[1])
        if fill is not None:
            return F.pad(img, pads, mode="constant", value=fill)
        color = torch.zeros((c,), dtype=img.dtype, device=img.device) \
            if background is None else \
            torch.as_tensor(background, dtype=img.dtype, device=img.device)
        shape = img.shape[:-3] + (h + sum(pad_h), w + sum(pad_w), c)
        out = color.expand(shape).clone()
        out[..., pad_h[0]:pad_h[0] + h, pad_w[0]:pad_w[0] + w, :] = img
        return out
    raise ValueError(f"unknown virtual pixel method {method!r}")
