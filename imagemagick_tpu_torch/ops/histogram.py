"""Histogram ops (histogram.c).

Port of ``imagemagick_tpu/ops/histogram.py`` (the reference's
MagickCore/histogram.c: GetImageHistogram :555, UniqueImageColors,
IdentifyPaletteImage, GetNumberColors).  A fixed-bin histogram is kernel
K4 (``gpu_kernels.histogram256``) for 256 bins of float32 values, and
``torch.bincount`` otherwise; the JAX package's one-hot matrix products
exist for the TPU's matrix unit and are not carried over.  The exact-color
census is a sort over packed color keys.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import gpu_kernels


def _bin_index(values: torch.Tensor, bins: int) -> torch.Tensor:
    """``clip(int(v*(bins-1) + 0.5), 0, bins-1)`` as int64, with the
    saturating float->int cast of the JAX package (NaN -> 0)."""
    v = values.to(torch.float32) * float(bins - 1) + 0.5
    v = torch.where(torch.isnan(v), 0.0, v).clamp(-1.0, float(bins))
    return v.to(torch.int32).clamp(0, bins - 1).to(torch.int64)


def _histogram_fixed(values: torch.Tensor, bins: int) -> torch.Tensor:
    """Fixed-bin histogram of every value of ``values``: (bins,) float32
    counts, exact."""
    if values.numel() == 0:
        return torch.zeros(bins, dtype=torch.float32, device=values.device)
    if bins == 256 and values.dtype == torch.float32:
        # a channel of an image is a strided view; K4 reads dense rows
        return gpu_kernels.histogram256(
            values.reshape(1, -1).contiguous())[0]
    idx = _bin_index(values.reshape(-1), bins)
    return torch.bincount(idx, minlength=bins).to(torch.float32)


def _histogram_fixed_batched(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram of each row of (T, P) int bin indices in [0, bins):
    (T, bins) float32."""
    rows = idx.shape[0]
    flat = idx.to(torch.int64) + bins * torch.arange(
        rows, device=idx.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=rows * bins)
    return counts.reshape(rows, bins).to(torch.float32)


def channel_histogram(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Fixed-bin per-channel histogram: returns (bins, C)."""
    c = img.shape[-1]
    outs = [_histogram_fixed(img[..., ch], bins) for ch in range(c)]
    return torch.stack(outs, dim=-1)


def _pack_colors(img: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """One key per pixel from its first four channels quantized to
    ``bits``, wrapping at 32 bits as the JAX package's uint32 keys do."""
    top = (1 << bits) - 1
    v = img.to(torch.float32) * float(top) + 0.5
    v = torch.where(torch.isnan(v), 0.0, v).clamp(0.0, float(top + 1))
    q = v.to(torch.int64).clamp(0, top)
    key = torch.zeros(img.shape[:-1], dtype=torch.int64, device=img.device)
    for i in range(min(img.shape[-1], 4)):
        key = (key * (1 << bits) + q[..., i]) & 0xFFFFFFFF
    return key.reshape(-1)


def number_colors(img: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """GetNumberColors: count of distinct (quantized) colors."""
    flat = torch.sort(_pack_colors(img, bits)).values
    return 1 + torch.sum(flat[1:] != flat[:-1])


def unique_colors(img: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """UniqueImageColors (histogram.c:1138): (colors, counts) in the
    reference's HCube traversal order — an octree walk whose node id per
    level is (r_bit | g_bit<<1 | b_bit<<2 [| a_bit<<3]) over 8-bit channel
    bits 7..1 MSB-first (ColorToNodeId, histogram.c:163); colors sharing
    all seven levels (leaf lists) stay in first-appearance order."""
    c = img.shape[-1]
    arr = img.detach().cpu().numpy().reshape(-1, c)
    q = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    colors, first, counts = np.unique(q, axis=0, return_index=True,
                                      return_counts=True)
    nb = 4 if c in (2, 4) else 3
    if c == 1:
        r = g = b = colors[:, 0].astype(np.uint64)
        a = None
    elif c == 2:
        r = g = b = colors[:, 0].astype(np.uint64)
        a = colors[:, 1].astype(np.uint64)
    else:
        r = colors[:, 0].astype(np.uint64)
        g = colors[:, 1].astype(np.uint64)
        b = colors[:, 2].astype(np.uint64)
        a = colors[:, 3].astype(np.uint64) if c >= 4 else None
    key = np.zeros(len(colors), np.uint64)
    for idx in range(7, 0, -1):        # levels consume bits 7..1
        digit = ((r >> idx) & 1) | (((g >> idx) & 1) << 1) \
            | (((b >> idx) & 1) << 2)
        if a is not None:
            digit = digit | (((a >> idx) & 1) << 3)
        key = (key << np.uint64(nb)) | digit
    order = np.lexsort((first, key))
    return (colors[order].astype(np.float32) / 255.0, counts[order])


def get_histogram(img: torch.Tensor, max_colors: int = 1024
                  ) -> Dict[tuple, int]:
    """GetImageHistogram: exact color -> count map (host-side dict)."""
    colors, counts = unique_colors(img)
    order = np.argsort(-counts)
    out = {}
    for i in order[:max_colors]:
        out[tuple(np.round(colors[i], 6))] = int(counts[i])
    return out


def is_palette_image(img: torch.Tensor, max_colors: int = 256) -> bool:
    """IdentifyPaletteImage: true if <= 256 unique colors."""
    return int(number_colors(img)) <= max_colors


def histogram_image(img: torch.Tensor, height: int = 200,
                    bins: int = 256) -> torch.Tensor:
    """histogram: pseudo-format — render the channel histogram as bars."""
    hist = channel_histogram(img, bins)  # (bins, C)
    hist = hist / torch.clamp(torch.amax(hist, dim=0, keepdim=True), min=1.0)
    rows = torch.arange(height, dtype=torch.float32,
                        device=img.device).flip(0)[:, None] / height
    chans = []
    for ch in range(3):
        src = hist[:, min(ch, img.shape[-1] - 1)]
        chans.append((rows < src[None, :]).to(torch.float32))
    return torch.stack(chans, dim=-1)
