"""Image attributes: bounding box, depth, type, convex hull (attribute.c).

Port of ``imagemagick_tpu/ops/attribute.py``, whole: GetImageBoundingBox
(``transform.trim_bounds``, on the image's device), GetImageDepth,
IdentifyImageType/SetImageType, GetImageConvexHull and
GetImageMinimumBoundingBox.  Depth, type and the hulls are statistics in
float64 numpy on the host, as in the JAX package, over one read-back of
the image a call.  ``set_image_type`` coerces on the device, but for a
palette: one (H, W, 3) frame is quantized to 256 colors by the native
octree library on the host (Riemersma dither), anything else by
``kmeans_quantize`` on the device, the JAX function's routes by shape.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def _host(img: torch.Tensor) -> np.ndarray:
    return img.detach().cpu().numpy()


def bounding_box(img: torch.Tensor, fuzz: float = 0.0
                 ) -> Tuple[int, int, int, int]:
    """GetImageBoundingBox: (x, y, w, h) of non-border content."""
    from .transform import trim_bounds

    return trim_bounds(img, fuzz)


def image_depth(img: torch.Tensor, max_depth: int = 16) -> int:
    """GetImageDepth: smallest depth that represents all samples exactly."""
    q16 = np.round(_host(img) * 65535.0).astype(np.uint16)
    for depth in range(1, max_depth):
        scale = 65535 // ((1 << depth) - 1)
        if np.all(q16 % scale == 0):
            return depth
    return max_depth


def image_type(img: torch.Tensor, has_alpha: bool = False) -> str:
    """IdentifyImageType: bilevel/grayscale/palette/truecolor (+alpha)."""
    arr = _host(img)
    color = arr[..., :3] if arr.shape[-1] >= 3 else arr
    is_gray = arr.shape[-1] == 1 or bool(
        np.allclose(color, color[..., :1], atol=1.0 / 65535.0))
    suffix = "alpha" if has_alpha else ""
    if is_gray:
        vals = np.unique(np.round(color[..., 0] * 255))
        if set(vals.tolist()) <= {0.0, 255.0}:
            return "bilevel" + suffix
        return "grayscale" + suffix
    # IsPaletteImage counts DISTINCT full-quantum colors (histogram.c at
    # Q16): an 8-bit pack undercounts on 16-bit content
    q = np.round(np.clip(arr, 0.0, 1.0) * 65535.0).astype(np.uint64)
    mult = (65536 ** np.arange(q.shape[-1], dtype=np.uint64))
    packed = (q * mult).sum(axis=-1).reshape(-1)
    if np.unique(packed).size <= 256:
        return "palette" + suffix
    return "truecolor" + suffix


def set_image_type(img: torch.Tensor, target: str,
                   has_alpha: bool = False) -> torch.Tensor:
    """SetImageType: coerce pixels to the requested type."""
    t = target.lower()
    from .enhance import grayscale, normalize
    from .threshold import bilevel

    if t.startswith("bilevel"):
        # attribute.c:2310: gray -> NormalizeImage -> Bilevel(Q/2)
        g = grayscale(img) if img.shape[-1] >= 3 else img
        return bilevel(normalize(g), 0.5)
    if t.startswith("grayscale"):
        return grayscale(img) if img.shape[-1] >= 3 else img
    if t.startswith("palette"):
        # attribute.c:2349: QuantizeImage 256 colors (octree, Riemersma
        # dither by default) for one RGB frame; k-means otherwise
        if img.dim() == 3 and img.shape[-1] == 3:
            from .. import native

            out, _ = native.octree_quantize(_host(img), 256, "riemersma")
            return torch.from_numpy(out).to(img.device)
        from .quantize import kmeans_quantize

        return kmeans_quantize(img, 256, max_iters=8)
    if t.startswith("truecolor"):
        if img.shape[-1] == 1:
            return img.repeat_interleave(3, dim=-1)
        return img
    return img


def convex_hull(img: torch.Tensor, threshold: float = 0.5
                ) -> List[Tuple[float, float]]:
    """GetImageConvexHull: hull vertices of the pixels that differ from
    the top-left one (host)."""
    arr = _host(img)
    mask = np.any(np.abs(arr - arr[0, 0]) > 1e-6, axis=-1)
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return []
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    return [tuple(p) for p in _monotone_chain(pts)]


def _monotone_chain(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain convex hull."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.asarray(lower[:-1] + upper[:-1])


def minimum_bounding_box(img: torch.Tensor) -> dict:
    """GetImageMinimumBoundingBox: rotating-calipers min-area rectangle."""
    hull = convex_hull(img)
    if len(hull) < 3:
        return {"area": 0.0, "width": 0.0, "height": 0.0, "angle": 0.0,
                "points": hull}
    pts = np.asarray(hull)
    best = None
    n = len(pts)
    for i in range(n):
        edge = pts[(i + 1) % n] - pts[i]
        theta = -math.atan2(edge[1], edge[0])
        rot = np.array([[math.cos(theta), -math.sin(theta)],
                        [math.sin(theta), math.cos(theta)]])
        proj = pts @ rot.T
        w = proj[:, 0].max() - proj[:, 0].min()
        h = proj[:, 1].max() - proj[:, 1].min()
        area = w * h
        if best is None or area < best["area"]:
            best = {"area": float(area), "width": float(w),
                    "height": float(h), "angle": float(-math.degrees(theta))}
    best["points"] = hull
    return best
