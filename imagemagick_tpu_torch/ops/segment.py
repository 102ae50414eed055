"""Scale-space fuzzy c-means image segmentation (segment.c).

Port of ``imagemagick_tpu/ops/segment.py`` (SegmentImage,
MagickCore/segment.c:1796):

1. Per-channel 256-bin histograms (in the requested colorspace), counted
   on the device over the whole batch, as in the JAX function.
2. Scale-space analysis per channel (OptimalTau, segment.c:1509) on the
   host in numpy: this module's own copy of the JAX module's 256-entry
   machinery (zero crossings tracked across Gaussian scales, the interval
   tree, its stable nodes -> the channel's peak/valley extrema map).
3. Classification (Classify, segment.c:246) on the device: candidate
   clusters are the 3-D product of per-channel peak regions; pixels are
   counted into the first matching hexahedron (+/- SafeMargin=3 char
   units), weak clusters are pruned by the reference's running rule, and
   every pixel is assigned to its first matching box, else to the nearest
   center (the argmax of the fuzzy c-means membership).  A box is the
   product of one region of each channel, so the boxes that hold a pixel
   are the product of its channels' regions, read from 256-entry tables:
   the first (kept) box is the least index over that product, with no
   (pixels, boxes) test.  Cluster sums are exact integers; the nearest
   center is searched once for each distinct color that no kept box
   holds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

_TAU_MAX = 5.2
_TAU_MIN = 0.2
_DELTA_TAU = 0.5
_SAFE_MARGIN = 3
_CELLS = 1 << 24           # (pixel, candidate) cells of one chunk


# -- scale-space analysis (host, per 256-bin histogram) ---------------------

def _scale_space(hist: np.ndarray, tau: float) -> np.ndarray:
    """Gaussian-smoothed histogram at scale tau (ScaleSpace, segment.c):
    the kernel table is TRUNCATED at the first entry below MagickEpsilon
    (the reference's early break leaves the rest zero)."""
    x = np.arange(256, dtype=np.float64)
    alpha = 1.0 / (tau * np.sqrt(2.0 * np.pi))
    beta = -1.0 / (2.0 * tau * tau)
    gamma = np.exp(beta * x * x)
    small = np.nonzero(gamma < 1.0e-12)[0]
    if len(small):
        gamma[small[0]:] = 0.0
    diff = np.abs(x[:, None] - x[None, :]).astype(np.int64)
    return alpha * (gamma[diff] @ hist.astype(np.float64))


def _derivative(h: np.ndarray) -> np.ndarray:
    """Central differences with 2nd-order endpoints (DerivativeHistogram)."""
    d = np.empty_like(h)
    d[1:-1] = (h[2:] - h[:-2]) / 2.0
    d[0] = -1.5 * h[0] + 2.0 * h[1] - 0.5 * h[2]
    d[-1] = 0.5 * h[-3] - 2.0 * h[-2] + 1.5 * h[-1]
    return d


def _zero_cross(second: np.ndarray, smooth_threshold: float) -> np.ndarray:
    """Signed zero-crossing marks of the 2nd derivative — the EXACT
    ZeroCrossHistogram loop (segment.c:1897).  Note its parity logic
    marks the 2nd-and-later samples of each same-sign run (s<0 sets
    parity=+1, and -1 is emitted when parity>0), not the documented
    sign transitions; the oracle confirms the output depends on this
    (a 1x1.5 segment of a smooth image collapses to ONE cluster)."""
    s = second.copy()
    s[(s < smooth_threshold) & (s >= -smooth_threshold)] = 0.0
    crossings = np.zeros(256, np.int16)
    parity = 0
    for i in range(256):
        if s[i] < 0.0:
            if parity > 0:
                crossings[i] = -1
            parity = 1
        elif s[i] > 0.0:
            if parity < 0:
                crossings[i] = 1
            parity = -1
    return crossings


def _consolidate(crossings: List[np.ndarray]) -> None:
    """Snap each scale's crossings onto the next-finer scale's so the
    scale-space fingerprints form lines, not loops (ConsolidateCrossings).

    For every crossing j at scale i, find the crossing position at scale
    i+1 (same bin, or nearest left/right neighbor) that keeps an even
    number of finer-scale crossings between the previous coarse crossing
    and the moved one; drop the crossing if none qualifies.
    """
    n = len(crossings) - 1
    for i in range(n - 1, -1, -1):
        cur, fine = crossings[i], crossings[i + 1]
        for j in range(256):
            if cur[j] == 0:
                continue
            k = j - 1
            while k > 0 and fine[k] == 0:
                k -= 1
            left = max(k, 0)
            k = j + 1
            while k < 255 and fine[k] == 0:
                k += 1
            right = min(k, 255)
            k = j - 1
            while k > 0 and cur[k] == 0:
                k -= 1
            k = max(k, 0)

            def even_between(lo, hi):
                return int(np.count_nonzero(fine[lo + 1:hi])) % 2 == 0

            correct = -1
            if fine[j] != 0 and even_between(k, j) and j != k:
                correct = j
            if correct == -1 and even_between(k, left) and left != k:
                correct = left
            if correct == -1 and even_between(k, right) and right != k:
                correct = right
            val = cur[j]
            cur[j] = 0
            if correct != -1:
                cur[correct] = val


@dataclass
class _Node:
    tau: float
    left: int
    right: int
    children: List["_Node"] = field(default_factory=list)
    stability: float = 0.0
    mean_stability: float = 0.0


def _build_tree(crossings: List[np.ndarray], taus: List[float]) -> _Node:
    """Nested interval tree: leaves split at each finer scale's crossing
    positions (InitializeIntervalTree, segment.c:1343)."""
    root = _Node(tau=0.0, left=0, right=255)
    for level in range(len(crossings)):
        # split every current leaf by this level's crossings
        def leaves(node):
            if not node.children:
                yield node
            else:
                for ch in node.children:
                    yield from leaves(ch)

        for leaf in list(leaves(root)):
            left = leaf.left
            parts = []
            for k in range(leaf.left + 1, leaf.right):
                if crossings[level][k] != 0:
                    parts.append(_Node(tau=taus[level], left=left, right=k))
                    left = k
            if left != leaf.left:
                parts.append(_Node(tau=taus[level], left=left,
                                   right=leaf.right))
            leaf.children = parts
    _stability(root)
    return root


def _stability(node: _Node) -> None:
    for ch in node.children:
        _stability(ch)
    node.stability = (node.tau - node.children[0].tau) if node.children \
        else 0.0
    node.mean_stability = (sum(c.stability for c in node.children) /
                           len(node.children)) if node.children else 0.0


def _active_nodes(chain: List[_Node], i: int, out: List[_Node]) -> None:
    """Stable nodes: stability >= mean stability of the children
    (ActiveNodes, segment.c:1483).  A stable node hides its subtree; an
    unstable node's SIBLINGS are visited before its children (the
    reference's recursion order — it decides extrema overwrites at
    shared interval endpoints)."""
    if i >= len(chain):
        return
    node = chain[i]
    if node.stability >= node.mean_stability:
        out.append(node)
        _active_nodes(chain, i + 1, out)
    else:
        _active_nodes(chain, i + 1, out)
        _active_nodes(node.children, 0, out)


def optimal_tau(hist: np.ndarray, smooth_threshold: float = 1.0,
                max_tau: float = _TAU_MAX, min_tau: float = _TAU_MIN,
                delta_tau: float = _DELTA_TAU) -> np.ndarray:
    """Extrema map of a 256-bin histogram via scale-space fingerprint
    analysis (OptimalTau, segment.c:1509).  Positive entries mark peak
    regions (value = peak bin, with bin 0 encoded as 256), negative mark
    valleys."""
    # the reference steps tau as a float32 constant: tau starts at
    # double(5.2f) and the loop stops BEFORE 0.19999981 < 0.2 — 10 taus,
    # not 11 (OptimalTau, segment.c:1571)
    taus = []
    tau = float(np.float32(max_tau))
    dt = float(np.float32(delta_tau))
    while tau >= min_tau:
        taus.append(tau)
        tau -= dt
    smoothed = [_scale_space(hist, t) for t in taus]
    taus.append(0.0)
    smoothed.append(hist.astype(np.float64))
    crossings = [_zero_cross(_derivative(_derivative(h)), smooth_threshold)
                 for h in smoothed]
    _consolidate(crossings)
    # force endpoints to be included in the interval (literal loop —
    # note a nonzero crossings[0] negates ITSELF, like the reference)
    for c in crossings:
        j = 0
        while j < 255 and c[j] == 0:
            j += 1
        c[0] = -c[j]
        j = 255
        while j > 0 and c[j] == 0:
            j -= 1
        c[255] = -c[j]
    root = _build_tree(crossings, taus)
    active: List[_Node] = []
    _active_nodes(root.children, 0, active)
    extrema = np.zeros(256, np.int32)
    for node in active:
        level = len(taus) - 1
        for j, t in enumerate(taus):
            if t == node.tau:
                level = j
        hist_s = smoothed[level]
        # OptimalTau: a peak interval carries the -1 mark at its right
        # boundary (with ZeroCrossHistogram's run-continuation parity)
        peak = crossings[level][node.right] == -1
        span = hist_s[node.left:node.right + 1]
        index = node.left + (int(np.argmax(span)) if peak
                             else int(np.argmin(span)))
        if index == 0:
            index = 256
        extrema[node.left:node.right + 1] = index if peak else -index
    return extrema


def _regions(extrema: np.ndarray) -> List[Tuple[int, int]]:
    """Peak regions [left, right] from an extrema map (DefineRegion)."""
    out = []
    i = 0
    while i <= 255:
        while i <= 255 and extrema[i] <= 0:
            i += 1
        if i > 255:
            break
        left = i
        while i <= 255 and extrema[i] >= 0:
            i += 1
        out.append((left, i - 1))
    return out


# -- classification (device pixel passes) -----------------------------------

def _region_table(regions: List[Tuple[int, int]], device):
    """(256, m) int64: for each char value, the indices of the regions
    whose [left - SafeMargin, right + SafeMargin] holds it, ascending,
    padded with len(regions)."""
    rows = [[i for i, (l, r) in enumerate(regions)
             if l - _SAFE_MARGIN <= v <= r + _SAFE_MARGIN]
            for v in range(256)]
    m = max(1, max(len(r) for r in rows))
    t = np.full((256, m), len(regions), np.int64)
    for v, r in enumerate(rows):
        t[v, :len(r)] = r
    return torch.from_numpy(t).to(device)


def _first_kept(ints: torch.Tensor, tables, sizes, rank: torch.Tensor
                ) -> torch.Tensor:
    """The rank (in ``rank``, the box order restricted to kept boxes; K
    where a box is not kept) of each pixel's first kept box holding it.

    A pixel lies in box (i, j, l) iff each channel lies in its region, so
    the boxes that hold it are the product of its per-channel region
    lists; box index (i * NG + j) * NB + l is ordered like (i, j, l), and
    the first kept box is the least rank over that product."""
    ng, nb = sizes[1], sizes[2]
    k = len(rank) - 1
    step = max(1, _CELLS // int(np.prod([t.shape[1] for t in tables])))
    out = []
    for s in range(0, ints.shape[0], step):
        v = ints[s:s + step]
        ti, tj, tl = (tables[c][v[:, c]] for c in range(3))
        bad = (ti[:, :, None, None] == sizes[0]) | \
            (tj[:, None, :, None] == ng) | (tl[:, None, None, :] == nb)
        box = (ti[:, :, None, None] * ng + tj[:, None, :, None]) * nb + \
            tl[:, None, None, :]
        r = rank[torch.where(bad, k, box)]
        out.append(r.reshape(r.shape[0], -1).amin(-1))
    return torch.cat(out)


def _nearest(flat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of each pixel's nearest center (squared distance, first of
    equals), over chunks of pixels.  Colors and centers are integers, so
    |c|^2 - 2 x.c (the squared distance less |x|^2) is an exact integer in
    float64, whatever the order of its sums."""
    c = centers.to(torch.float64)
    cc = (c * c).sum(-1)
    step = max(1, _CELLS // max(centers.shape[0], 1))
    out = [(cc - 2.0 * (flat[s:s + step].to(torch.float64) @ c.t()))
           .argmin(-1) for s in range(0, flat.shape[0], step)]
    return torch.cat(out) if out else torch.zeros(
        (0,), dtype=torch.int64, device=flat.device)


def segment(img: torch.Tensor, colorspace: str = "srgb",
            cluster_threshold: float = 1.0,
            smooth_threshold: float = 1.5,
            verbose: bool = False) -> torch.Tensor:
    """SegmentImage (segment.c:1796): returns the image with every pixel
    replaced by its cluster's mean color.

    ``colorspace`` selects the analysis space (the reference transforms
    in, classifies, and transforms back); ``cluster_threshold`` is the
    minimum hexahedron population in percent; ``smooth_threshold``
    smooths the histogram second derivative (0 -> 1.0 like the CLI).
    The histograms span every image of a batch, as in the JAX function.
    """
    from . import colorspace as cs

    c = img.shape[-1]
    dev = img.device
    work = img[..., :3] if c >= 3 else img[..., :1].repeat_interleave(3, -1)
    space = (colorspace or "srgb").lower()
    if space not in ("srgb", "rgb", ""):
        work = cs.convert(work, "srgb", space)
    chars = torch.round(work * 255.0).clamp(0, 255)
    ints = chars.reshape(-1, 3).to(torch.int64)
    smooth = smooth_threshold if smooth_threshold > 0 else 1.0

    # per-channel histograms (device) + extrema (host: 256 bins)
    hists = [torch.bincount(ints[:, ch], minlength=256)[:256].cpu().numpy()
             for ch in range(3)]
    regions = [_regions(optimal_tau(hist, smooth)) for hist in hists]
    if not all(regions):
        regions = [[(0, 255)]] * 3
    boxes = [(rr, gg, bb) for rr in regions[0] for gg in regions[1]
             for bb in regions[2]]
    k = len(boxes)
    sizes = [len(r) for r in regions]
    tables = [_region_table(r, dev) for r in regions]

    # count pass: first matching box per pixel (Classify, segment.c:362)
    every = torch.arange(k + 1, device=dev)
    key = _first_kept(ints, tables, sizes, every)      # k: none holds it
    counts = torch.bincount(key, minlength=k + 1)[:k].cpu().numpy()
    sums = torch.zeros((k + 1, 3), dtype=torch.int64, device=dev) \
        .index_add_(0, key, ints)[:k].cpu().numpy()

    # prune weak clusters with the reference's running rule
    # (cluster->count >= #kept-so-far * cluster_threshold / 100)
    kept = []
    for j in range(k):
        if counts[j] > 0 and counts[j] >= len(kept) * cluster_threshold / 100.0:
            kept.append(j)
    if not kept:
        kept = [int(np.argmax(counts))]
    means = np.asarray([sums[j] / max(counts[j], 1) for j in kept],
                       np.float64)
    # (unsigned char)(center+0.5): round-half-UP, not numpy's half-even
    centers = torch.from_numpy(np.floor(means + 0.5).astype(np.float32)) \
        .to(dev)                                            # (K', 3) chars

    # assignment pass: first matching kept box, else fuzzy membership —
    # whose argmax is analytically the nearest center (membership_j =
    # 1/sum_k (d2_j/d2_k)^(1/(we-1)) is monotone decreasing in d2_j)
    rank = np.full(k + 1, len(kept), np.int64)
    rank[kept] = np.arange(len(kept))
    idx = _first_kept(ints, tables, sizes, torch.from_numpy(rank).to(dev))
    free = idx == len(kept)
    # the nearest center depends on the color alone: search it once for
    # each distinct color of the pixels no kept box holds
    v = ints[free]
    colors, inv = torch.unique((v[:, 0] * 256 + v[:, 1]) * 256 + v[:, 2],
                               return_inverse=True)
    rgb = torch.stack([colors // 65536, colors // 256 % 256, colors % 256],
                      1).to(torch.float32)
    idx[free] = _nearest(rgb, centers)[inv]
    out = centers[idx].reshape(chars.shape) / torch.tensor(
        255.0, dtype=torch.float32, device=dev)

    if space not in ("srgb", "rgb", ""):
        out = cs.convert(out, space, "srgb")
    if c > 3:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    elif c < 3:
        out = out[..., :c]
    return out.to(img.dtype)


def number_of_clusters(img: torch.Tensor, colorspace: str = "srgb",
                       cluster_threshold: float = 1.0,
                       smooth_threshold: float = 1.5) -> int:
    """Cluster count the classifier would keep (verbose-stats analog)."""
    out = segment(img, colorspace, cluster_threshold, smooth_threshold)
    return int(torch.unique(out.reshape(-1, out.shape[-1]), dim=0).shape[0])
