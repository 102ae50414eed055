"""Color quantization: k-means, posterize, remap (quantize.c).

Port of ``imagemagick_tpu/ops/quantize.py`` but for its palette
error-diffusion walks: ``posterize`` (every ``dither`` value), ``kmeans``,
``kmeans_quantize``, ``kmeans_reference``, ``remap`` without dither,
``_hilbert_order``, ``ordered_posterize``, ``unique_colors_count`` and
``compress_colormap``.  ``floyd_steinberg`` and ``riemersma`` (per-pixel
sequential walks over a palette) are not ported yet, and ``remap(...,
dither=True)``, which calls them, raises NotImplementedError naming their
ROADMAP.md entry.

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

from typing import Tuple

import numpy as np
import torch

from .channel import channel_mean

REMAP_DITHER_GAP = (
    "remap with dither needs the palette error-diffusion walks "
    "(floyd_steinberg, riemersma), which are not ported yet: ROADMAP.md "
    "Queue 1, 'The palette error-diffusion walks, with -remap'")


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
    first of equals).  ``dither=True`` raises NotImplementedError."""
    if dither:
        raise NotImplementedError(REMAP_DITHER_GAP)
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
