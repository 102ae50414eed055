"""Feature detection: Canny, Hough lines, mean-shift, Haralick features.

Port of ``imagemagick_tpu/ops/feature.py`` (CannyEdgeImage,
HoughLineImage, MeanShiftImage and GetImageFeatures of
MagickCore/feature.c), as PyTorch ops on the image's device.

Canny's blur is ``blur.blur``, kernel K3 on a CUDA card; its thresholds
are taken over the whole batch, as in the JAX function (the CLI runs it
image by image).  The Hough accumulator works image by image (the JAX
function raises on a batch).  HoughLineImage's votes are counted on the
device in float64 from a host table of cos and sin, each product and sum
its own op, so the bins are the JAX function's numpy bins.  Mean shift
tests for convergence once every ``paint._CHECK_EVERY`` steps (steps
after every pixel has converged change nothing).  The GLCM counts pairs
exactly with ``bincount``; its metrics are float32 sums of the 16x16
matrix on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import blur as bl
from .enhance import _intensity, grayscale
from .paint import _CHECK_EVERY

_HOUGH_CHUNK = 1 << 24     # (pixel, theta) votes of one chunk


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula: max * sqrt(1 + (min / max)^2)."""
    x, y = x.abs(), y.abs()
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    zero = a == 0
    r = b / torch.where(zero, torch.ones_like(a), a)
    return torch.where(zero, a, a * torch.sqrt(1 + r * r))


def _shift0(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = m[y + dy, x + dx], zero outside (matrix reads)."""
    h, w = m.shape[-2], m.shape[-1]
    p = F.pad(m, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def canny_edge(img: torch.Tensor, radius: float = 0.0, sigma: float = 1.0,
               lower_percent: float = 0.1, upper_percent: float = 0.3,
               hysteresis_iters: int = 64) -> torch.Tensor:
    """CannyEdgeImage (feature.c:239): 1-D-rule Gaussian smooth of the
    luma, the 2x2 half-pixel gradient, non-max suppression along the
    gradient's orientation class, thresholds at lower/upper percent of the
    suppressed map's range (over the batch) and ``hysteresis_iters`` steps
    of 8-neighbour hysteresis growth."""
    gray = grayscale(img) if img.shape[-1] >= 3 else img
    smooth = bl.blur(gray, radius, sigma)[..., 0]
    return canny_from_smooth(smooth, lower_percent, upper_percent,
                             hysteresis_iters).to(img.dtype)[..., None]


def canny_from_smooth(smooth: torch.Tensor, lower_percent: float = 0.1,
                      upper_percent: float = 0.3,
                      hysteresis_iters: int = 64) -> torch.Tensor:
    """Canny after its blur: the boolean (..., H, W) edge map of the
    smoothed luma ``smooth``."""
    h, w = smooth.shape[-2], smooth.shape[-1]
    i = torch.cat([smooth, smooth[..., -1:, :]], -2)
    i = torch.cat([i, i[..., :, -1:]], -1)
    i00 = i[..., :h, :w]
    i01 = i[..., :h, 1:w + 1]
    i10 = i[..., 1:h + 1, :w]
    i11 = i[..., 1:h + 1, 1:w + 1]
    dx = 0.5 * (-i00 + i01 - i10 + i11)
    dy = 0.5 * (i00 + i01 - i10 - i11)
    mag = _hypot(dx, dy)

    eps = 1e-15
    flat = dx.abs() < eps
    slope = dy / torch.where(flat, torch.full_like(dx, math.inf), dx)
    # orientation classes (feature.c:155): 0 = N/S, 1 = NW/SE, 2 = E/W,
    # 3 = NE/SW; dx ~ 0 -> 0
    neg = torch.where(slope < -2.41421356237, 0,
                      torch.where(slope < -0.414213562373, 1, 2))
    pos = torch.where(slope > 2.41421356237, 0,
                      torch.where(slope > 0.414213562373, 3, 2))
    o = torch.where(flat, 0, torch.where(slope < 0.0, neg, pos))
    na = torch.where(o == 0, _shift0(mag, -1, 0), torch.where(
        o == 1, _shift0(mag, -1, -1), torch.where(
            o == 2, _shift0(mag, 0, -1), _shift0(mag, 1, -1))))
    nb = torch.where(o == 0, _shift0(mag, 1, 0), torch.where(
        o == 1, _shift0(mag, 1, 1), torch.where(
            o == 2, _shift0(mag, 0, 1), _shift0(mag, -1, 1))))
    nms = torch.where((mag < na) | (mag < nb), torch.zeros_like(mag), mag)

    mn, mx = nms.min(), nms.max()
    lo = lower_percent * (mx - mn) + mn
    hi = upper_percent * (mx - mn) + mn
    s = nms >= hi
    weak = nms >= lo
    x = s.reshape((-1, 1, h, w)).to(torch.float32)
    wk = weak.reshape(x.shape)
    for _ in range(hysteresis_iters):
        x = F.max_pool2d(x, 3, 1, 1) * wk
    return (x > 0).reshape(s.shape)


def hough_accumulator(edges: torch.Tensor, n_theta: int = 180,
                      n_rho: int = 256) -> torch.Tensor:
    """Hough transform accumulator over (rho, theta) bins, of each image:
    (..., n_rho, n_theta) float32 (the JAX function takes one image)."""
    e = edges[..., 0] if edges.dim() >= 3 else edges
    h, w = e.shape[-2], e.shape[-1]
    lead = e.shape[:-2]
    e = e.reshape(-1, h * w)
    dev = e.device
    diag = math.hypot(h, w)
    f32 = np.float32
    # jnp.linspace(0, pi, n, endpoint=False) as XLA folds it
    thetas = np.arange(n_theta, dtype=f32) * (f32(math.pi) *
                                              (f32(1) / f32(n_theta)))
    cos_t = torch.from_numpy(np.cos(thetas.astype(np.float64))
                             .astype(f32)).to(dev)
    sin_t = torch.from_numpy(np.sin(thetas.astype(np.float64))
                             .astype(f32)).to(dev)
    span = torch.tensor(2 * diag, dtype=torch.float32, device=dev)
    acc = torch.zeros((e.shape[0] * n_rho * n_theta,), dtype=torch.float32,
                      device=dev)
    tidx = torch.arange(n_theta, device=dev)
    rows = max(1, _HOUGH_CHUNK // max(w * n_theta, 1))
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        ys = torch.arange(y0, y1, device=dev)[:, None].expand(y1 - y0, w) \
            .reshape(-1, 1).to(torch.float32)
        xs = torch.arange(w, device=dev)[None, :].expand(y1 - y0, w) \
            .reshape(-1, 1).to(torch.float32)
        rho = xs * cos_t + ys * sin_t
        ridx = ((rho + diag) / span * (n_rho - 1)).to(torch.int32) \
            .clamp(0, n_rho - 1).long()
        bins = ridx * n_theta + tidx
        for b in range(e.shape[0]):
            wts = e[b, y0 * w:y1 * w, None].expand(bins.shape)
            acc.index_add_(0, (bins + b * n_rho * n_theta).reshape(-1),
                           wts.reshape(-1))
    return acc.reshape(lead + (n_rho, n_theta))


def hough_lines(img: torch.Tensor, width: int = 5, height: int = 5,
                threshold: int = 40, n_top: int = 16
                ) -> List[Tuple[float, float, float]]:
    """Legacy peak list: (rho, theta, count) from the reference
    accumulator, strongest first, of one image."""
    segs = hough_line_segments(img, width, height, threshold)
    h, w = img.shape[-3], img.shape[-2]
    hough_height = (math.sqrt(2.0) * max(h, w)) / 2.0
    out = []
    for x1, y1, x2, y2, count, theta_deg, ridx in segs[:n_top]:
        out.append((float(ridx) - hough_height, math.radians(theta_deg),
                    float(count)))
    out.sort(key=lambda t: -t[2])
    return out


def _hough_votes(inten: torch.Tensor, h: int, w: int, acc_h: int,
                 hough_height: float) -> torch.Tensor:
    """(180, acc_h) float64 votes of the pixels above half intensity."""
    dev = inten.device
    ys, xs = torch.nonzero(inten > 0.5, as_tuple=True)
    th = np.radians(np.arange(180, dtype=np.float64))
    cos_t = torch.from_numpy(np.cos(th)).to(dev)[None]
    sin_t = torch.from_numpy(np.sin(th)).to(dev)[None]
    tidx = torch.arange(180, device=dev)[None]
    cx = torch.tensor(w / 2.0, dtype=torch.float64, device=dev)
    cy = torch.tensor(h / 2.0, dtype=torch.float64, device=dev)
    counts = torch.zeros((180 * acc_h,), dtype=torch.int64, device=dev)
    step = max(1, _HOUGH_CHUNK // 180)
    for s in range(0, len(xs), step):
        x = xs[s:s + step, None].to(torch.float64)
        y = ys[s:s + step, None].to(torch.float64)
        radius = (x - cx) * cos_t + (y - cy) * sin_t
        # MagickRound: half away from zero
        r = radius + hough_height
        ridx = torch.where(r >= 0, torch.floor(r + 0.5), torch.ceil(r - 0.5))
        ridx = ridx.to(torch.int64).clamp(0, acc_h - 1)
        counts += torch.bincount((tidx * acc_h + ridx).reshape(-1),
                                 minlength=180 * acc_h)
    return counts.reshape(180, acc_h).to(torch.float64)


def hough_line_segments(img: torch.Tensor, width: int = 5, height: int = 5,
                        threshold: int = 40):
    """HoughLineImage (feature.c:1840-2076) accumulator + maxima scan:
    votes from pixels whose intensity exceeds QuantumRange/2, 180 theta
    bins, rho index = MagickRound(radius + hough_height) in an edge-
    clamped matrix; a cell is a line iff count >= line_count and no
    neighbor in the (width x height) window is strictly greater.
    Returns (x1, y1, x2, y2, count, theta_deg, rho_idx) in the
    reference's emission order (rho-major); of a batch, one such list an
    image."""
    if img.dim() == 4:
        return [hough_line_segments(im, width, height, threshold)
                for im in img]
    h, w = img.shape[-3], img.shape[-2]
    hough_height = (math.sqrt(2.0) * max(h, w)) / 2.0
    acc_h = int(2.0 * hough_height)
    inten = _intensity(img[..., :3] if img.shape[-1] >= 3 else img)
    acc = _hough_votes(inten, h, w, acc_h, hough_height)
    line_count = (w // 4) if w > h else (h // 4)
    if threshold != 0:
        line_count = threshold
    # strict local maxima with edge-clamped neighborhood (GetMatrixElement
    # EdgeX/EdgeY semantics)
    dev = acc.device
    neigh = torch.full_like(acc, -math.inf)
    for v in range(-(height // 2), height // 2 + 1):
        for u in range(-(width // 2), width // 2 + 1):
            if u == 0 and v == 0:
                continue
            ti = (torch.arange(180, device=dev) + u).clamp(0, 179)
            ri = (torch.arange(acc_h, device=dev) + v).clamp(0, acc_h - 1)
            neigh = torch.maximum(neigh, acc[ti][:, ri])
    is_line = (acc >= line_count) & (neigh <= acc)
    ry, tx = np.nonzero(is_line.t().cpu().numpy())
    counts = acc[tx, ry].cpu().numpy() if len(tx) else np.zeros(0)
    segs = []
    for y, x, count in zip(ry.tolist(), tx.tolist(), counts.tolist()):
        t = math.radians(x)
        if 45 <= x <= 135:
            x1 = 0.0
            y1 = ((y - acc_h / 2.0) - ((x1 - w / 2.0) * math.cos(t))) \
                / math.sin(t) + h / 2.0
            x2 = float(w)
            y2 = ((y - acc_h / 2.0) - ((x2 - w / 2.0) * math.cos(t))) \
                / math.sin(t) + h / 2.0
        else:
            y1 = 0.0
            x1 = ((y - acc_h / 2.0) - ((y1 - h / 2.0) * math.sin(t))) \
                / math.cos(t) + w / 2.0
            y2 = float(h)
            x2 = ((y - acc_h / 2.0) - ((y2 - h / 2.0) * math.sin(t))) \
                / math.cos(t) + w / 2.0
        segs.append((x1, y1, x2, y2, count, float(x), float(y)))
    return segs


def mean_shift(img: torch.Tensor, width: int = 7, height: int = 7,
               color_distance: float = 0.1, max_iters: int = 100
               ) -> torch.Tensor:
    """MeanShiftImage (feature.c:2158): per pixel, iterate a CIRCULAR window
    whose center FOLLOWS the (x,y) centroid of in-color-range samples; the
    color mean moves with it.  Converges when the squared step (pixels) plus
    the 255-scaled squared rgb delta drops to <= 3 (feature.c:2303-2314),
    capped at MaxMeanShiftIterations=100.  Samples are taken at rounded
    centroid+offset with edge-clamped virtual pixels.  Every image of a
    batch runs at once, each on its own pixels."""
    h, w, c = img.shape[-3:]
    rh, rw = height // 2, width // 2
    # circle gate: (v*v + u*u) <= (width/2)*(height/2)  (feature.c:2268)
    taps = [(u, v) for v in range(-rh, rh + 1) for u in range(-rw, rw + 1)
            if v * v + u * u <= rw * rh]
    cd2 = float(color_distance) * float(color_distance)
    nc = min(c, 3)
    dev = img.device
    x = img.reshape(-1, h * w, c)
    n = x.shape[0]
    flat = x.reshape(-1, c)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    loc = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1) \
        .to(torch.float32).repeat(n, 1)
    base = (torch.arange(n, device=dev) * (h * w))[:, None] \
        .expand(n, h * w).reshape(-1)
    offs = [torch.tensor((u, v), dtype=torch.float32, device=dev)
            for u, v in taps]

    def sqsum(d):
        s = d[:, 0] * d[:, 0]
        for i in range(1, d.shape[1]):
            s = s + d[:, i] * d[:, i]
        return s

    def step(loc, mpix, active):
        sloc = torch.zeros_like(loc)
        spix = torch.zeros_like(mpix)
        cnt = torch.zeros((loc.shape[0],), dtype=torch.float32, device=dev)
        for (u, v), off in zip(taps, offs):
            ix = torch.floor(loc[:, 0] + u + 0.5).clamp(0, w - 1)
            iy = torch.floor(loc[:, 1] + v + 0.5).clamp(0, h - 1)
            p = flat[(iy * w + ix).to(torch.int64) + base]
            ok = (sqsum(mpix[:, :nc] - p[:, :nc]) <= cd2).to(torch.float32)
            sloc = sloc + ok[:, None] * (loc + off)
            spix = spix + ok[:, None] * p
            cnt = cnt + ok
        gamma = torch.where(cnt != 0, 1.0 / torch.clamp(cnt, min=1.0),
                            torch.ones_like(cnt))
        nloc = gamma[:, None] * sloc
        npix = gamma[:, None] * spix
        dist = sqsum(nloc - loc) + sqsum(255.0 * (npix[:, :nc] - mpix[:, :nc]))
        loc = torch.where(active[:, None], nloc, loc)
        mpix = torch.where(active[:, None], npix, mpix)
        return loc, mpix, active & (dist > 3.0)

    mpix = flat
    active = torch.ones((flat.shape[0],), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters:
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            loc, mpix, active = step(loc, mpix, active)
            it += 1
        if not bool(active.any()):
            break
    return mpix.clamp(0.0, 1.0).reshape(img.shape)


def glcm_counts(img: torch.Tensor, levels: int = 16,
                offset: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The gray-level co-occurrence counts (levels, levels) int64 of the
    pixel pairs at ``offset`` over the whole batch, counted exactly."""
    gray = grayscale(img)[..., 0] if img.shape[-1] >= 3 else img[..., 0]
    q = (gray * (levels - 1) + 0.5).to(torch.int32).clamp(0, levels - 1)
    dy, dx = offset
    a = q[..., : q.shape[-2] - dy if dy else None,
          : q.shape[-1] - dx if dx else None]
    b = q[..., dy:, dx:]
    key = (a.reshape(-1).long() * levels + b.reshape(-1).long())
    return torch.bincount(key, minlength=levels * levels) \
        .reshape(levels, levels)


def _sum32(a: np.ndarray) -> np.float32:
    """A float32 sum in raster order, one element after another (the
    order of XLA's reduction on the CPU)."""
    return np.cumsum(a.reshape(-1), dtype=np.float32)[-1]


def glcm_features(img: torch.Tensor, levels: int = 16,
                  offset: Tuple[int, int] = (0, 1)) -> Dict[str, torch.Tensor]:
    """GetImageFeatures: Haralick metrics from the symmetric, normalized
    gray-level co-occurrence matrix, float32 0-d tensors on the image's
    device.  The (levels, levels) matrix is summed on the host in float32,
    element after element."""
    counts = glcm_counts(img, levels, offset).cpu().numpy().astype(np.float32)
    f32 = np.float32
    glcm = (counts + counts.T) / np.maximum(_sum32(counts) * f32(2), f32(1))
    i = np.arange(levels, dtype=f32)
    ii = i[:, None]
    jj = i[None, :]
    mu_i = _sum32(ii * glcm)
    mu_j = _sum32(jj * glcm)
    var_i = _sum32((ii - mu_i) ** 2 * glcm)
    var_j = _sum32((jj - mu_j) ** 2 * glcm)
    eps = f32(1e-12)
    with np.errstate(divide="ignore"):
        ent = np.where(glcm > eps, glcm * np.log(glcm + eps), f32(0))
    out = {
        "contrast": _sum32((ii - jj) ** 2 * glcm),
        "energy": _sum32(glcm * glcm),
        "homogeneity": _sum32(glcm / (f32(1) + np.abs(ii - jj))),
        "entropy": -_sum32(ent.astype(f32)),
        "correlation": _sum32((ii - mu_i) * (jj - mu_j) * glcm) /
        np.maximum(np.sqrt(var_i * var_j), eps),
        "dissimilarity": _sum32(np.abs(ii - jj) * glcm),
    }
    return {k: torch.tensor(f32(v), device=img.device) for k, v in out.items()}
