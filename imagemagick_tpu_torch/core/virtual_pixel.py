"""Virtual-pixel (edge extension) policies as explicit pads.

The reference resolves out-of-canvas reads per pixel inside the cache layer
(MagickCore/cache.c:2627-2720; policy enum in cache-view.h:27-45).  Here an
edge policy is an explicit pad applied before a windowed op runs.  The
simple modes are index maps along H and W (one gather per axis); the
constant fills pad with a color.
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
