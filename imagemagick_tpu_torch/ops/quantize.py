"""Color quantization: k-means, posterize, remap (quantize.c).

Port of ``imagemagick_tpu/ops/quantize.py``: ``posterize`` (every
``dither`` value), ``kmeans``, ``kmeans_quantize``, ``kmeans_reference``,
``remap`` (``dither=True`` runs ``floyd_steinberg``), the palette
error-diffusion walks ``floyd_steinberg`` and ``riemersma``,
``_hilbert_order``, ``ordered_posterize``, ``unique_colors_count`` and
``compress_colormap``.

The walks are sequential along their scan, pixel after pixel, so on the
card each runs as a kernel of its own (``csrc/palette_walk.cu``, one warp
an image); their plain versions (``_floyd_steinberg_plain``,
``_riemersma_plain``) loop over the pixels with the batch as one
dimension, and repeat the JAX functions' float32 arithmetic op for op:
both walks are chaotic in their input, so one rounding apart moves every
later pixel.  The wrappers run the plain version for a CPU tensor and the
kernel for a CUDA tensor, or raise.

Host work, as in the JAX package: the dithered ``posterize`` and
``kmeans_reference``'s seeds run the octree library
(``native/riemersma.cpp``) on the host, frame by frame, and
``kmeans_reference`` iterates in float64 numpy up to 1 << 20 pixels;
``compress_colormap`` runs on the host.  Everything else runs as torch
ops on the input's device.

K-means on the card: squared distances are |x|² − 2x·c + |c|² as in the
JAX function, but each product and sum is an elementwise op in a fixed
order (no matmul, whose summation order differs between the card and the
CPU), the cluster sums are accumulated in float64 and rounded to
float32, and ``kmeans_reference``'s distortion is summed in float64.  So
the card's labels equal the CPU's but where float64 atomics round a sum
otherwise.  The seeds are the JAX function's: a stable argsort of the
pixels' channel mean (``channel.channel_mean``, the JAX function's bits),
sampled at ``jnp.linspace(0, n - 1, k)`` computed
in float32 as JAX computes it (``_seed_indices``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .channel import channel_mean
from .gpu_kernels import LAUNCHES, on_card, stream_of


def posterize(img: torch.Tensor, levels: int, dither=False,
              key=None) -> torch.Tensor:
    """PosterizeImage (quantize.c:2236): reduce to ``levels`` per channel.

    ``dither=True``/"riemersma" runs the native Riemersma walk and
    "floydsteinberg"/"fs" the native Floyd-Steinberg one, each frame on
    the host; "ordered" is the o8x8 threshold map.  The walks take
    ``levels >= 2`` and 1-4 channels: other arguments round, as the JAX
    function does when the library refuses them.
    """
    n = max(levels - 1, 1)
    if dither == "ordered":
        from .threshold import ordered_dither

        return ordered_dither(img, "o8x8", levels)
    if dither and levels >= 2 and 1 <= img.shape[-1] <= 4:
        from .. import native

        fn = native.floyd_steinberg_posterize \
            if dither in ("floydsteinberg", "fs") \
            else native.riemersma_posterize
        arr = img.detach().cpu().numpy().astype(np.float32, copy=False)
        frames = arr if arr.ndim == 4 else arr[None]
        out = np.stack([fn(f, levels) for f in frames])
        return torch.from_numpy(out if arr.ndim == 4 else out[0]).to(
            img.device)
    return torch.round(img * n) / torch.tensor(float(n), device=img.device)


def _seed_indices(n: int, k: int) -> np.ndarray:
    """``jnp.linspace(0, n - 1, k).astype(int32)`` as the JAX function
    gets it: XLA folds ``(n - 1) * (i / (k - 1))`` into ``i * ((n - 1) *
    (1 / (k - 1)))`` in float32 and appends n - 1 (``torch.linspace``
    and the unfolded order round otherwise)."""
    if k <= 1:
        return np.zeros(max(k, 0), np.int64)
    f32 = np.float32
    step = f32(n - 1) * (f32(1) / f32(k - 1))
    out = np.append(np.arange(k - 1, dtype=f32) * step, f32(n - 1))
    return np.clip(out.astype(np.int64), 0, n - 1)


def _sq_dist(flat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances |x|² − 2x·c + |c|², each product and sum
    an elementwise op in channel order."""
    x2 = flat[:, :1] * flat[:, :1]
    c2 = centers[None, :, 0] * centers[None, :, 0]
    xc = flat[:, :1] * centers[None, :, 0]
    for i in range(1, flat.shape[1]):
        x2 = x2 + flat[:, i:i + 1] * flat[:, i:i + 1]
        c2 = c2 + centers[None, :, i] * centers[None, :, i]
        xc = xc + flat[:, i:i + 1] * centers[None, :, i]
    return x2 - 2.0 * xc + c2


def _cluster_sums(flat: torch.Tensor, labels: torch.Tensor, k: int):
    """(counts, sums): int64 counts and float64 sums of each cluster."""
    counts = torch.bincount(labels, minlength=k)
    sums = torch.zeros((k, flat.shape[1]), dtype=torch.float64,
                       device=flat.device)
    sums.index_add_(0, labels, flat.to(torch.float64))
    return counts, sums


def _means(counts: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    return (sums / counts.clamp(min=1)[:, None]).to(torch.float32)


def kmeans(img: torch.Tensor, n_colors: int = 16, max_iters: int = 20,
           tolerance: float = 1e-4, key=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KmeansImage (quantize.c:2483): returns (palette, labels) after
    ``max_iters`` iterations (``tolerance`` is unused, as in the JAX
    function).  Seeds: evenly spaced samples of the pixels sorted by
    their channel mean; an empty cluster keeps its center."""
    c = img.shape[-1]
    flat = img.reshape(-1, c)
    n = flat.shape[0]
    order = torch.argsort(channel_mean(flat), stable=True)
    take = torch.from_numpy(_seed_indices(n, n_colors)).to(flat.device)
    centers = flat[order[take]]
    for _ in range(max_iters):
        labels = torch.argmin(_sq_dist(flat, centers), dim=1)
        counts, sums = _cluster_sums(flat, labels, n_colors)
        centers = torch.where(counts[:, None] > 0, _means(counts, sums),
                              centers)
    labels = torch.argmin(_sq_dist(flat, centers), dim=1)
    return centers, labels.reshape(img.shape[:-1])


def kmeans_quantize(img: torch.Tensor, n_colors: int = 16,
                    max_iters: int = 20) -> torch.Tensor:
    palette, labels = kmeans(img, n_colors, max_iters)
    return palette[labels]


def _kmeans_host(flat: np.ndarray, centers: np.ndarray, max_iters: int,
                 tolerance: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """The JAX function's float64 host iteration, copied: (centers,
    labels, iterations run)."""
    n = flat.shape[0]
    prev = 0.0
    labels = np.zeros(n, np.int64)
    it = 0
    for it in range(1, int(max_iters) + 1):
        d2 = ((flat[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = np.argmin(d2, axis=1)
        mind = d2[np.arange(n), labels]
        distortion = float(mind.sum())
        k = centers.shape[0]
        counts = np.bincount(labels, minlength=k).astype(np.float64)
        sums = np.zeros((k, 3), np.float64)
        np.add.at(sums, labels, flat)
        centers = np.where(counts[:, None] > 0,
                           sums / np.maximum(counts[:, None], 1.0), 0.0)
        if abs(distortion - prev) <= tolerance:
            break
        prev = distortion
    return centers, labels, it


def _kmeans_device(fj: torch.Tensor, cj: torch.Tensor, max_iters: int,
                   tolerance: float):
    """The device iteration: (centers, labels, iterations run), one host
    read of the distortion (summed in float64) per iteration."""
    if fj.shape[1] < cj.shape[1]:    # gray: compare against every column
        fj = fj.expand(-1, cj.shape[1])
    k = cj.shape[0]
    prev = 0.0
    labels = None
    it = 0
    for it in range(1, int(max_iters) + 1):
        d2 = _sq_dist(fj, cj)
        mind, labels = torch.min(d2, dim=1)
        counts, sums = _cluster_sums(fj, labels, k)
        distortion = float(mind.to(torch.float64).sum())
        cj = torch.where(counts[:, None] > 0, _means(counts, sums), 0.0)
        if abs(distortion - prev) <= tolerance:
            break
        prev = distortion
    return cj, labels, it


def kmeans_reference(img: torch.Tensor, n_colors: int,
                     max_iters: int = 300, tolerance: float = 1e-4,
                     seed_palette=None, stats: dict = None) -> torch.Tensor:
    """KmeansImage (quantize.c:2352-2854), reference-exact.

    Seeds the clusters from the octree quantizer (native, on the host) at
    the derived depth (quantize.c:2543), then iterates: assign by
    squared RGB distance, recompute means (empty clusters collapse to
    black), and stop when the summed distortion changes by <=
    ``tolerance``.  Up to 1 << 20 pixels this runs on the host in float64
    numpy, as the JAX function does; larger images iterate on the
    image's device.  A batch is seeded as one tall frame.  ``stats``, when
    given, receives the iterations run and the route."""
    from .. import native

    c = img.shape[-1]
    arr = img.detach().cpu().numpy().astype(np.float32, copy=False)
    if seed_palette is None:
        depth, m = 1, int(n_colors)
        while m != 0:
            m >>= 2
            depth += 1
        seed = arr[..., :3] if c >= 3 else arr
        seed = seed.reshape((-1,) + seed.shape[-2:])
        q = native.octree_quantize(seed, int(n_colors), dither="none",
                                   tree_depth=depth)
        centers = np.asarray(q[1], np.float64)[:, :3]
    else:
        centers = np.asarray(seed_palette, np.float64)[:, :3]
    n = arr.size // c
    if n <= (1 << 20):
        flat = arr.reshape(-1, c)[:, :3].astype(np.float64)
        centers, labels, it = _kmeans_host(flat, centers, max_iters,
                                           tolerance)
        out3 = centers[labels].reshape(img.shape[:-1] + (3,))
        out3 = torch.from_numpy(out3.astype(np.float32)).to(img.device)
        route = "host"
    else:
        cj = torch.tensor(centers, dtype=torch.float32, device=img.device)
        fj = img.reshape(-1, c)[:, :3]
        cj, labels, it = _kmeans_device(fj, cj, max_iters, tolerance)
        out3 = cj[labels].reshape(img.shape[:-1] + (3,))
        route = "device"
    if stats is not None:
        stats.update(iterations=it, route=route)
    if c > 3:
        return torch.cat([out3, img[..., 3:]], -1)
    if c < 3:
        return out3[..., :c]
    return out3


def remap(img: torch.Tensor, palette: torch.Tensor,
          dither: bool = False) -> torch.Tensor:
    """RemapImage: snap each pixel to the nearest palette entry (the
    first of equals); ``dither=True`` diffuses the error
    (``floyd_steinberg``)."""
    if dither:
        return floyd_steinberg(img, palette)
    c = img.shape[-1]
    pal = palette.reshape(-1, c)
    labels = torch.argmin(_sq_dist(img.reshape(-1, c), pal), dim=1)
    return pal[labels].reshape(img.shape)


def _hilbert_order(order: int) -> np.ndarray:
    """Flat visit order of a 2^order x 2^order Hilbert curve (host-side)."""
    n = 1 << order
    idx = np.arange(n * n)
    x = np.zeros_like(idx)
    y = np.zeros_like(idx)
    t = idx.copy()
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x[swap], y[swap] = y_f[swap], x_f[swap]
        x[flip] = s - 1 - x[flip]
        y[flip] = s - 1 - y[flip]
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s *= 2
    return y * n + x


def _nearest(px: torch.Tensor, pal: torch.Tensor) -> torch.Tensor:
    """(N, C) pixels -> (N, C) nearest palette entries: d2 = Σ_c (pal −
    px)², summed in channel order, and the first of equal distances (the
    JAX ``_nearest``, batched)."""
    diff = pal[None] - px[:, None]
    sq = diff * diff
    d2 = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        d2 = d2 + sq[..., c]
    return pal[torch.argmin(d2, dim=1)]


def _as_batch(img: torch.Tensor, palette: torch.Tensor):
    """(N, H, W, C) float32 contiguous view of ``img`` (3-D or 4-D) and
    its palette as (K, C) on its device."""
    x = img if img.dim() == 4 else img[None]
    pal = palette.reshape(-1, img.shape[-1]).to(img.device, img.dtype)
    return x.contiguous(), pal.contiguous()


def _floyd_steinberg_plain(x: torch.Tensor, pal: torch.Tensor
                           ) -> torch.Tensor:
    """The Floyd-Steinberg walk's plain version over an (N, H, W, C)
    batch, the JAX function's arithmetic: a serpentine scan, ``row = inp
    + below_err``, ``old = row[j] + right_err``, ``new =
    nearest(clip(old, 0, 1))``, ``err = old − new``; ``right_err`` is set
    to err·7/16, and err·3/16, err·5/16 and err·1/16 are added to the next
    row's errors at ``jl``, ``j`` and ``jr`` in that order, ``jl`` and
    ``jr`` clipped into the row (so at its ends a neighbour's share lands
    on column ``j``)."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    below = torch.zeros((n, w, c), dtype=x.dtype, device=x.device)
    direction = 1
    for y in range(h):
        row = x[:, y] + below
        below = torch.zeros_like(below)
        right = torch.zeros((n, c), dtype=x.dtype, device=x.device)
        for i in range(w):
            j = i if direction > 0 else w - 1 - i
            old = row[:, j] + right
            new = _nearest(old.clamp(0.0, 1.0), pal)
            err = old - new
            out[:, y, j] = new
            right = err * (7.0 / 16.0)
            jl = min(max(j - direction, 0), w - 1)
            jr = min(max(j + direction, 0), w - 1)
            below[:, jl] += err * (3.0 / 16.0)
            below[:, j] += err * (5.0 / 16.0)
            below[:, jr] += err * (1.0 / 16.0)
        direction = -direction
    return out


def floyd_steinberg(img: torch.Tensor, palette: torch.Tensor
                    ) -> torch.Tensor:
    """Floyd-Steinberg error diffusion onto ``palette`` (quantize.c:391
    region) of an (H, W, C) image or an (N, H, W, C) batch, image by
    image.  Right 7/16; next row left 3/16, center 5/16, right 1/16, on a
    serpentine scan (``_floyd_steinberg_plain``)."""
    x, pal = _as_batch(img, palette)
    if not on_card(x):
        out = _floyd_steinberg_plain(x, pal)
    else:
        out = _walk_fs_kernel(x, pal)
    return out if img.dim() == 4 else out[0]


@lru_cache(maxsize=8)
def _hilbert_walk(h: int, w: int) -> np.ndarray:
    """The flat indices of an (h, w) image in Hilbert order (the curve of
    the smallest power-of-two square that holds it, outside points
    dropped), as int64."""
    side_order = max(int(np.ceil(np.log2(max(h, w, 2)))), 1)
    side = 1 << side_order
    ys, xs = np.divmod(_hilbert_order(side_order), side)
    keep = (ys < h) & (xs < w)
    return (ys[keep] * w + xs[keep]).astype(np.int64)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add rounds it.  In float64 the product is exact and the sum
    rounds once more; the two roundings differ from one only where that
    sum is a float32 midpoint and not the exact value, and there the
    exact value's side (its TwoSum error) picks the neighbour."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf)).double()
    mid = (s != r64) & ((r64 + other) * 0.5 == s)
    pick = torch.where(e > 0, torch.maximum(r64, other),
                       torch.minimum(r64, other))
    return torch.where(mid & (e != 0), pick, r64).float()


def riemersma_decay(history: int = 16) -> float:
    """The error's decay along the curve, as the JAX function computes it
    (a float64 that float32 arithmetic rounds to float32)."""
    return float(np.float32(np.exp(np.log(1.0 / history)
                                   / max(history - 1, 1))))


def _riemersma_plain(x: torch.Tensor, pal: torch.Tensor,
                     order: torch.Tensor, decay: float) -> torch.Tensor:
    """The Riemersma walk's plain version over an (N, H, W, C) batch, the
    JAX function's arithmetic: along ``order`` (flat pixel indices), ``v
    = clip(px + err, 0, 1)``, ``new = nearest(v)``, ``err = (v − new) +
    err·decay``, the last a fused multiply-add as XLA compiles it on the
    CPU (``_fma32``)."""
    n, h, w, c = x.shape
    flat = x.reshape(n, h * w, c)
    out = torch.empty_like(flat)
    err = torch.zeros((n, c), dtype=x.dtype, device=x.device)
    dk = torch.tensor(decay, dtype=x.dtype, device=x.device)
    for t in order.tolist():
        v = (flat[:, t] + err).clamp(0.0, 1.0)
        new = _nearest(v, pal)
        out[:, t] = new
        err = _fma32(err, dk, v - new)
    return out.reshape(n, h, w, c)


def riemersma(img: torch.Tensor, palette: torch.Tensor,
              history: int = 16) -> torch.Tensor:
    """Riemersma Hilbert-curve dithering onto ``palette`` (quantize.c:391
    region) of an (H, W, C) image or an (N, H, W, C) batch, image by
    image: the pixels in Hilbert order, the error decaying along the
    curve by ``riemersma_decay(history)`` (``_riemersma_plain``)."""
    x, pal = _as_batch(img, palette)
    decay = riemersma_decay(history)
    if not on_card(x):
        order = torch.from_numpy(_hilbert_walk(*x.shape[1:3]))
        out = _riemersma_plain(x, pal, order, decay)
    else:
        out = _walk_riemersma_kernel(x, pal, decay)
    return out if img.dim() == 4 else out[0]


# -- the walks' kernel (csrc/palette_walk.cu) --------------------------------

# shared memory a block may use (H100: 227 KB)
WALK_SMEM = 232448
WALK_MAX_CHANNELS = 8


def _walk_check(x: torch.Tensor, pal: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or pal.dtype != torch.float32:
        raise ValueError(f"{what} takes float32, got {x.dtype}, {pal.dtype}")
    n, h, w, c = x.shape
    if not 1 <= c <= WALK_MAX_CHANNELS or pal.shape[0] < 1 or \
            pal.shape[0] * c * 4 > WALK_SMEM or x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {tuple(x.shape)} onto a palette of "
                         f"{tuple(pal.shape)}")


def walk_fs_rows_in_shared(w: int, c: int, k: int) -> bool:
    """Whether the Floyd-Steinberg kernel keeps its two error rows in
    shared memory beside the palette (else in device memory)."""
    return (k * c + 2 * w * c) * 4 <= WALK_SMEM


def _walk_fs_kernel(x: torch.Tensor, pal: torch.Tensor) -> torch.Tensor:
    """Launch the Floyd-Steinberg walk: one warp an image."""
    _walk_check(x, pal, "floyd_steinberg")
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    k = pal.shape[0]
    smem_rows = walk_fs_rows_in_shared(w, c, k)
    scratch = out if smem_rows else torch.empty(
        (n, 2, w, c), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.pw_floyd_steinberg(
            x.data_ptr(), pal.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, h, w, c, k, int(smem_rows),
            stream_of(x))
    _build.check(err, "pw_floyd_steinberg")
    LAUNCHES["walk_fs"] += 1
    return out


@lru_cache(maxsize=8)
def _hilbert_walk_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    """``_hilbert_walk(h, w)`` as int32 on ``device``, uploaded once."""
    return torch.from_numpy(_hilbert_walk(h, w).astype(np.int32)).to(device)


def _walk_riemersma_kernel(x: torch.Tensor, pal: torch.Tensor,
                           decay: float) -> torch.Tensor:
    """Launch the Riemersma walk: one warp an image."""
    _walk_check(x, pal, "riemersma")
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    order = _hilbert_walk_on(h, w, x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.pw_riemersma(x.data_ptr(), order.data_ptr(),
                               pal.data_ptr(), out.data_ptr(), n, h * w, c,
                               pal.shape[0], decay, stream_of(x))
    _build.check(err, "pw_riemersma")
    LAUNCHES["walk_riemersma"] += 1
    return out


def ordered_posterize(img: torch.Tensor, levels: int = 2,
                      map_name: str = "o8x8") -> torch.Tensor:
    from .threshold import ordered_dither

    return ordered_dither(img, map_name, levels)


def unique_colors_count(img: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Unique color count via quantized keys (histogram.c
    UniqueImageColors analog): int64 keys of the first three channels,
    sorted on the device; a 0-d int64 tensor."""
    top = (1 << bits) - 1
    q = torch.clamp((img * float(top) + 0.5).to(torch.int64), 0, top)
    key = torch.zeros(img.shape[:-1], dtype=torch.int64, device=img.device)
    for i in range(min(img.shape[-1], 3)):
        key = key * (1 << bits) + q[..., i]
    flat = torch.sort(key.reshape(-1)).values
    return 1 + (flat[1:] != flat[:-1]).sum()


def compress_colormap(palette: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CompressImageColormap analog: drop unused palette entries
    (host-side); the results go back to the palette's device."""
    pal = palette.detach().cpu().numpy()
    lab = labels.detach().cpu().numpy()
    used = np.unique(lab)
    remapping = np.zeros(pal.shape[0], np.int32)
    remapping[used] = np.arange(used.size)
    return (torch.from_numpy(pal[used]).to(palette.device),
            torch.from_numpy(remapping[lab]).to(labels.device))
