"""Connected components labeling + region statistics (vision.c).

Port of ``imagemagick_tpu/ops/vision.py`` (ConnectedComponentsImage,
MagickCore/vision.c:786).  Labeling is iterative min-label propagation
(each pixel takes the minimum label among fuzz-equal neighbors, then
adopts its root's label by pointer jumping) on the image's device; steps
after the fixpoint change nothing, so the loop tests for it once every
``paint._CHECK_EVERY`` steps, never past ``max_iters``.  The labels equal
the JAX function's.  The merge of small components is a sequential host
loop, as in the JAX function, with each pass restricted to the
component's box and a one-pixel ring.  ``area_threshold`` counts each
image's areas on its own (the JAX function counts labels across the
images of a batch, where they collide).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .channel import channel_mean
from .paint import grow_to_fixpoint

_OFFS4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
_OFFS8 = _OFFS4 + [(1, 1), (1, -1), (-1, 1), (-1, -1)]


def _shifted(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``x`` rolled by (dy, dx) over its last two axes with the wrapped
    row and column set to ``fill``: out[y, x] = in[y - dy, x - dx]."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def connected_components(img: torch.Tensor, connectivity: int = 4,
                         fuzz: float = 0.0, max_iters: Optional[int] = None
                         ) -> torch.Tensor:
    """Label fuzz-equal regions; returns int32 labels shaped (..., H, W).

    Label values are the flat index of each region's top-left-most pixel
    within its image (deterministic, like the reference's object ids after
    relabeling)."""
    h, w = img.shape[-3], img.shape[-2]
    lead = img.shape[:-3]
    offs = _OFFS8 if connectivity == 8 else _OFFS4
    thr = fuzz * fuzz + 1e-12
    sims = []
    for dy, dx in offs:
        nb = _shifted(img.movedim(-1, 0), dy, dx, 0.0).movedim(0, -1)
        d = img - nb
        sim = channel_mean(d * d) <= thr
        if dy:
            sim[..., 0 if dy == 1 else -1, :] = False
        if dx:
            sim[..., :, 0 if dx == 1 else -1] = False
        sims.append(sim)
    big = h * w + 1
    init = torch.arange(h * w, dtype=torch.int32, device=img.device) \
        .reshape(h, w).expand(lead + (h, w)).contiguous()

    def step(labels):
        best = labels
        for (dy, dx), m in zip(offs, sims):
            nb = _shifted(labels, dy, dx, big)
            best = torch.minimum(best, torch.where(m, nb, big))
        # pointer jumping: adopt the label of your current root pixel
        flat = best.reshape(lead + (h * w,))
        return torch.gather(flat, -1, flat.long()).reshape(best.shape)

    return grow_to_fixpoint(init, step, max_iters or (h + w))


def relabel_sequential(labels: torch.Tensor) -> torch.Tensor:
    """Relabel to the reference's id convention (vision.c:786): ids 0..n-1
    in the order of the labels' values, which is the raster order of each
    component's first pixel.  Like the JAX function it numbers the labels
    of a whole batch together.  int32, on the labels' device."""
    lab = torch.as_tensor(labels)
    _, inv = torch.unique(lab, sorted=True, return_inverse=True)
    return inv.reshape(lab.shape).to(torch.int32)


def _boxes(lab: np.ndarray, uniq: np.ndarray, inv: np.ndarray):
    """Per-label (lo, hi) corner over every axis of ``lab``: (K, ndim)."""
    t = torch.from_numpy(inv.reshape(-1))
    k = len(uniq)
    lo, hi = [], []
    for ax, n in enumerate(lab.shape):
        shape = [1] * lab.ndim
        shape[ax] = n
        coord = torch.arange(n).reshape(shape).expand(lab.shape).reshape(-1)
        lo.append(torch.full((k,), n, dtype=torch.int64)
                  .scatter_reduce_(0, t, coord, "amin"))
        hi.append(torch.full((k,), -1, dtype=torch.int64)
                  .scatter_reduce_(0, t, coord, "amax"))
    return torch.stack(lo, 1).numpy(), torch.stack(hi, 1).numpy()


def merge_small_components(labels, min_area: int,
                           connectivity: int = 4) -> torch.Tensor:
    """connected-components:area-threshold: merge objects smaller than
    ``min_area`` into their dominant adjacent object (vision.c merge
    loop), smallest first, as the JAX function does over the whole
    array.  A sequential host loop: each merge changes later votes.  Each
    pass looks only at the component's box grown by one pixel, which holds
    the component and its ring; a merge grows the winner's box.  Returns
    an int32 tensor on the labels' device (the CPU for a numpy array)."""
    device = labels.device if isinstance(labels, torch.Tensor) else "cpu"
    lab = labels.cpu().numpy().copy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels).copy()
    if min_area <= 1:
        return torch.from_numpy(lab).to(device)
    uniq, inv, counts = np.unique(lab.reshape(-1), return_inverse=True,
                                  return_counts=True)
    lo, hi = _boxes(lab, uniq, inv)
    slot = {int(u): k for k, u in enumerate(uniq)}
    nd = lab.ndim
    h, w = lab.shape[-2], lab.shape[-1]
    order = np.argsort(counts, kind="stable")
    for k in order:
        u, n = uniq[k], counts[k]
        if n >= min_area or hi[k, 0] < 0:
            continue
        box = tuple(slice(lo[k, a], hi[k, a] + 1) for a in range(nd - 2)) + (
            slice(max(lo[k, -2] - 1, 0), min(hi[k, -2] + 2, h)),
            slice(max(lo[k, -1] - 1, 0), min(hi[k, -1] + 2, w)))
        sub = lab[box]
        mask = sub == u
        if not mask.any():
            continue
        ring = np.zeros_like(mask)
        ring[..., :-1, :] |= mask[..., 1:, :]
        ring[..., 1:, :] |= mask[..., :-1, :]
        ring[..., :, :-1] |= mask[..., :, 1:]
        ring[..., :, 1:] |= mask[..., :, :-1]
        if connectivity == 8:
            ring[..., :-1, :-1] |= mask[..., 1:, 1:]
            ring[..., 1:, 1:] |= mask[..., :-1, :-1]
            ring[..., :-1, 1:] |= mask[..., 1:, :-1]
            ring[..., 1:, :-1] |= mask[..., :-1, 1:]
        ring &= ~mask
        nb = sub[ring]
        if nb.size == 0:
            continue
        vals, vc = np.unique(nb, return_counts=True)
        v = vals[np.argmax(vc)]
        sub[mask] = v
        j = slot[int(v)]
        lo[j] = np.minimum(lo[j], lo[k])
        hi[j] = np.maximum(hi[j], hi[k])
        hi[k] = -1
    return torch.from_numpy(lab).to(device)


def component_statistics(img: torch.Tensor, labels,
                         min_area: int = 0) -> List[Dict]:
    """Per-object area/bbox/centroid/mean-color on the host, largest
    first (the -define connected-components:verbose output, vision.c
    CCObjectInfo).  Of a batch it reads image 0 only, as the JAX function
    does."""
    lab = labels.cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)
    arr = img.cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)
    if lab.ndim == 3:
        lab, arr = lab[0], arr[0]
    h, w = lab.shape
    flat = lab.reshape(-1)
    uniq, inv, counts = np.unique(flat, return_inverse=True,
                                  return_counts=True)
    # each component's pixels in raster order, one contiguous run each
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    ys, xs = order // w, order % w
    pix = arr.reshape(h * w, -1)[order]
    out = []
    for k, (u, n) in enumerate(zip(uniq, counts)):
        if n < min_area:
            continue
        run = slice(starts[k], starts[k + 1])
        yy, xx = ys[run], xs[run]
        color = pix[run].mean(axis=0)
        out.append({
            "id": int(u),
            "area": int(n),
            "bbox": (int(xx.min()), int(yy.min()),
                     int(xx.max() - xx.min() + 1),
                     int(yy.max() - yy.min() + 1)),
            "centroid": (float(xx.mean()), float(yy.mean())),
            "mean_color": tuple(float(c) for c in color),
        })
    out.sort(key=lambda o: -o["area"])
    return out


def area_threshold(img: torch.Tensor, labels: torch.Tensor, min_area: int,
                   background: float = 0.0) -> torch.Tensor:
    """Remove components smaller than ``min_area``
    (connected-components:area-threshold).  Labels are flat indices within
    their own image, so each image of a batch counts its own areas."""
    h, w = labels.shape[-2], labels.shape[-1]
    n = h * w
    flat = labels.reshape(-1, n).long()
    key = flat + torch.arange(flat.shape[0], device=flat.device)[:, None] * n
    cnt = torch.bincount(key.reshape(-1), minlength=flat.shape[0] * n)
    keep = (cnt[key] >= min_area).reshape(labels.shape)[..., None]
    return torch.where(keep, img, torch.tensor(background, dtype=img.dtype,
                                               device=img.device))
