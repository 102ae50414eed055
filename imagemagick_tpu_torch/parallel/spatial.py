"""Spatially sharded image ops with explicit halo exchange between blocks.

Port of ``imagemagick_tpu/parallel/spatial.py``: a huge image is a
``ShardedArray`` over a (dp, sy, sx) mesh; neighbourhood ops copy
fixed-width boundary halos from the neighbouring blocks onto each
block's device and run locally on block + halo; global reductions
(histograms, statistics) sum the blocks' partial results on the mesh's
first device, and across processes over ``torch.distributed`` for a
mesh made under a started group (``parallel/mesh.py``).

Each function keeps its JAX name and signature and returns a function
over global tensors or ``ShardedArray``s, as the JAX ``shard_map``
wrappers take global arrays.  A tensor given to it is split first
(``mesh.device_put`` with ``in_spec``).  Shape-keeping ops return a
``ShardedArray`` with ``in_spec``; reductions a tensor on the first
device, as JAX's ``P()`` outputs are replicated.

On the card the local steps run the port's kernels: K3 for the blur
(``ops.blur._separable_conv`` of each halo'd block) and K4 for the 256-bin
histograms and Otsu's (``ops.gpu_kernels.histogram256`` over each
block's rows).  The resize's local products are ``torch.einsum`` in full
float32 (TF32 stays off, as the package sets), as the JAX package runs
them outside any kernel.

These differ from the JAX module, on purpose.  Morphology equals the
port's ``ops.morphology.morphology`` (every kernel of a spec, the
neutral border of erode and dilate, n rounds of a method; JAX takes the
first kernel, repeats the edge, runs dilate^n - erode^n and one pass for
n = 0).  Counts are summed in int64 (JAX sums float32 one-hot products,
exact only to 2^24 in a bin, a limit a gigapixel passes); the
statistics' sums are float64 and the square root is taken in float64
and rounded (JAX's float32 ``s2/n - mean^2`` loses digits at a
gigapixel).  Otsu takes the port's own Otsu (``ops.threshold._otsu``:
exact counts, float64 class weights), so the sharded threshold equals
the port's ``auto_threshold``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Tuple

import numpy as np
import torch

from .mesh import (AXIS_NAMES, Mesh, NamedSharding, P, ShardedArray,
                   device_put, sharded_from_blocks)

_BATCH = P("dp", "sy", "sx", None)


def _on_mesh(x, mesh: Mesh, in_spec) -> ShardedArray:
    return device_put(x, NamedSharding(mesh, in_spec))


def _map_blocks(x: ShardedArray, fn: Callable) -> ShardedArray:
    """``fn(index)`` at every local mesh position, as a ShardedArray with
    ``x``'s sharding; each block is made and released before the next."""
    out = np.empty(x.blocks.shape, dtype=object)
    for idx in np.ndindex(x.blocks.shape):
        out[idx] = fn(idx)
    return sharded_from_blocks(out, x.sharding)


def _pointwise(x, fn: Callable):
    """``fn`` on a tensor, or on each block of a ShardedArray."""
    if isinstance(x, ShardedArray):
        return _map_blocks(x, lambda idx: fn(x.blocks[idx]))
    return fn(x)


def _zip_blocks(a: ShardedArray, b: ShardedArray, fn: Callable
                ) -> ShardedArray:
    return _map_blocks(a, lambda idx: fn(a.blocks[idx], b.blocks[idx]))


def _window(blocks: np.ndarray, idx: tuple, exchanges,
            fill=None) -> torch.Tensor:
    """Block ``idx`` of the grid ``blocks`` with halos, in one new tensor
    on its device.  ``exchanges`` lists (grid axis, tensor dim, halo,
    axis name): along each, the block gets the last ``halo`` rows of its
    left neighbour and the first ``halo`` rows of its right neighbour; at
    the global border it repeats its own edge row (the 'edge' virtual
    pixel, cache.c:2627), or holds ``fill`` where one is given.  The
    corners come from the diagonal neighbours, as when the exchanges run
    one after the other on each other's results (the JAX sy-then-sx
    order).  With no exchange, the block itself."""
    own = blocks[idx]
    if not exchanges:
        return own
    shape = list(own.shape)
    for ax, dim, halo, name in exchanges:
        n, ext = blocks.shape[ax], own.shape[dim]
        if n > 1 and ext < halo:
            raise ValueError(
                f"halo width {halo} exceeds the per-device shard extent "
                f"{ext} along {name!r}; a one-hop ppermute cannot provide a "
                f"halo wider than one shard — use fewer devices on this "
                f"axis or a smaller kernel radius")
        shape[dim] += 2 * halo
    out = torch.empty(shape, dtype=own.dtype, device=own.device)
    for steps in itertools.product((-1, 0, 1), repeat=len(exchanges)):
        src = list(idx)
        for (ax, _, _, _), s in zip(exchanges, steps):
            if 0 <= idx[ax] + s < blocks.shape[ax]:
                src[ax] += s
        piece = blocks[tuple(src)]
        dst = [slice(None)] * own.dim()
        for (ax, dim, halo, _), s in zip(exchanges, steps):
            ext = own.shape[dim]
            if s == 0:
                dst[dim] = slice(halo, halo + ext)
            elif not 0 <= idx[ax] + s < blocks.shape[ax]:
                # the global border: the edge row, broadcast by copy_
                dst[dim] = slice(0, halo) if s < 0 else \
                    slice(halo + ext, 2 * halo + ext)
                piece = piece.narrow(dim, 0 if s < 0 else ext - 1, 1)
            else:
                dst[dim] = slice(0, halo) if s < 0 else \
                    slice(halo + ext, 2 * halo + ext)
                piece = piece.narrow(dim, ext - halo if s < 0 else 0, halo)
        target = out[tuple(dst)]
        if not target.numel():
            continue
        if fill is not None and any(
                not 0 <= idx[ax] + s < blocks.shape[ax]
                for (ax, _, _, _), s in zip(exchanges, steps)):
            target.fill_(fill)
        else:
            target.copy_(piece.to(own.device))
    return out


def _exchange_halo_1d(blocks: np.ndarray, axis_name: str, spatial_axis: int,
                      halo: int) -> np.ndarray:
    """Concatenate ``halo`` rows from each neighbour along one sharded
    axis, for every block of the grid ``blocks`` (an object array shaped
    like the mesh's local devices).  Edge blocks replicate their own
    border; an axis of size 1 edge-pads its block."""
    ax = AXIS_NAMES.index(axis_name)
    dim = spatial_axis % blocks.flat[0].dim()
    out = np.empty(blocks.shape, dtype=object)
    for idx in np.ndindex(blocks.shape):
        out[idx] = _window(blocks, idx, [(ax, dim, halo, axis_name)])
    return out


def _exchanges(ndim: int, halo_y: int, halo_x: int) -> list:
    ex = []
    if halo_y:
        ex.append((1, ndim - 3, halo_y, "sy"))
    if halo_x:
        ex.append((2, ndim - 2, halo_x, "sx"))
    return ex


def halo_map(fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh,
             halo_y: int, halo_x: int = 0,
             in_spec: P = _BATCH) -> Callable:
    """Wrap a local neighbourhood op into a spatially sharded op.

    ``fn`` maps an (N, h+2*halo_y, w+2*halo_x, C) block to the block it
    keeps (a VALID op over the halo'd tile).  With no halo this is a
    plain per-block map (``shard_map``)."""

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        ex = _exchanges(x.ndim, halo_y, halo_x)
        return _map_blocks(x, lambda idx: fn(_window(x.blocks, idx, ex)))

    return run


def _crop(out: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    nd = out.dim()
    if ry:
        out = out.narrow(nd - 3, ry, out.shape[nd - 3] - 2 * ry)
    if rx:
        out = out.narrow(nd - 2, rx, out.shape[nd - 2] - 2 * rx)
    return out


def sharded_neighborhood(fn: Callable[[torch.Tensor], torch.Tensor],
                         mesh: Mesh, radius_y: int, radius_x: int,
                         in_spec: P = _BATCH) -> Callable:
    """Shard ANY 'same'-mode neighbourhood op of bounded radius: ``fn``
    maps (N, h, w, C) -> (N, h, w, C) reading only pixels within
    (radius_y, radius_x) of each output pixel; it runs on block + halo
    and the halo is cropped (distribute-cache.c:939's role)."""
    return _bordered(fn, mesh, radius_y, radius_x, in_spec, None)


# primitive-pass decomposition per morphology method: each pass gets its
# OWN halo exchange — edge replication of an intermediate result is NOT
# the same as running the composite over one wide halo (the reference
# re-applies virtual-pixel padding to the current image on every pass)
_METHOD_PRIMS = {
    "erode": ("e",), "dilate": ("d",),
    "erodeintensity": ("e",), "dilateintensity": ("d",),
    "open": ("e", "d"), "close": ("d", "e"),
    "openintensity": ("e", "d"), "closeintensity": ("d", "e"),
    "smooth": ("e", "d", "d", "e"),
    "convolve": ("c",), "correlate": ("x",),
}

# what a primitive's blocks hold beyond the image's border: erode and
# dilate ignore outside pixels (``ops.morphology`` pads them with 1 and
# 0), convolve and correlate repeat the edge (their 'edge' virtual pixel)
_PRIM_FILL = {"e": 1.0, "d": 0.0, "c": None, "x": None}

# the differences: (minuend, subtrahend), each a primitive sequence or
# None for the image itself
_METHOD_DIFFS = {
    "edge": (("d",), ("e",)), "edgein": (None, ("e",)),
    "edgeout": (("d",), None), "tophat": (None, ("e", "d")),
    "bottomhat": (("d", "e"), None),
}


def _bordered(fn: Callable, mesh: Mesh, ry: int, rx: int, in_spec,
              fill) -> Callable:
    """``sharded_neighborhood`` whose blocks hold ``fill`` beyond the
    image's border (the edge where ``fill`` is None)."""

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        ex = _exchanges(x.ndim, ry, rx)
        return _map_blocks(x, lambda idx: _crop(
            fn(_window(x.blocks, idx, ex, fill)), ry, rx))

    return run


def sharded_morphology(mesh: Mesh, method: str, kernel_spec: str,
                       iterations: int = 1,
                       in_spec: P = _BATCH) -> Callable:
    """Spatially sharded MorphologyImage (morphology.c:4129) for bounded
    methods (erode/dilate/open/close/smooth/edge/tophat/bottomhat/
    convolve/correlate): ``iterations`` rounds, each applying every
    kernel of the spec in turn, clipped to [0, 1] after each, with the
    'edge' virtual pixel, as ``ops.morphology.morphology`` runs them.
    Convergence (iterations <= 0) needs a global fixpoint and is not
    shardable this way."""
    from ..ops import morphology as mo

    if iterations <= 0:
        raise ValueError(f"iterations={iterations} (converge) is not "
                         f"shardable")
    m = method.lower().replace("-", "").replace("_", "")
    if m not in _METHOD_PRIMS and m not in _METHOD_DIFFS:
        raise ValueError(f"morphology method {method!r} has no sharded form")
    prim_fns = {"e": mo.erode, "d": mo.dilate, "c": mo.convolve_kernel,
                "x": mo.correlate_kernel}

    def seq(prims, kernel):
        if prims is None:
            return lambda x: x
        ry, rx = kernel.shape[0] // 2, kernel.shape[1] // 2
        fns = [_bordered(lambda b, p=p: prim_fns[p](b, kernel), mesh, ry, rx,
                         in_spec, _PRIM_FILL[p]) for p in prims]

        def run(x):
            for f in fns:
                x = f(x)
            return x

        return run

    def stage(kernel):
        if m in _METHOD_PRIMS:
            return seq(_METHOD_PRIMS[m], kernel)
        a, b = (seq(p, kernel) for p in _METHOD_DIFFS[m])
        return lambda x: _zip_blocks(a(x), b(x), torch.sub)

    stages = [stage(k) for k in mo.get_kernel(kernel_spec)]

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        for _ in range(iterations):
            for f in stages:
                x = _pointwise(f(x), lambda t: t.clamp(0.0, 1.0))
        return x

    return run


def sharded_median(mesh: Mesh, radius: int = 1,
                   in_spec: P = _BATCH) -> Callable:
    """Spatially sharded median / rank filter (StatisticImage,
    statistic.c MedianStatistic) via halo exchange."""
    from ..ops.statistic import median_filter

    return sharded_neighborhood(lambda b: median_filter(b, radius),
                                mesh, radius, radius, in_spec)


def sharded_statistic(mesh: Mesh, stat: str, width: int, height: int,
                      in_spec: P = _BATCH) -> Callable:
    """Spatially sharded windowed statistic (min/max/mean/median/mode/
    gradient...) — the rank-filter family of statistic.c."""
    from ..ops.statistic import statistic

    return sharded_neighborhood(lambda b: statistic(b, stat, width, height),
                                mesh, height // 2, width // 2, in_spec)


def _shard_axis_weights(M: np.ndarray, n: int):
    """Split a dense (out, in) resample operator into per-shard local
    blocks.  Returns (W, h): W[d] is (out/n, in/n + 2h) acting on shard
    d's halo'd rows; h is the uniform halo width (max boundary overreach
    of any shard's output support into its neighbours)."""
    Hout, Hin = M.shape
    if Hout % n or Hin % n:
        raise ValueError(f"axis dims ({Hout}, {Hin}) not divisible by {n}")
    out_loc, in_loc = Hout // n, Hin // n
    h = 1
    for d in range(n):
        rows = M[d * out_loc:(d + 1) * out_loc]
        nz = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        if nz.size:
            h = max(h, d * in_loc - int(nz[0]), int(nz[-1]) + 1
                    - (d + 1) * in_loc)
    if h > in_loc:
        raise ValueError(
            f"resize support halo {h} exceeds shard extent {in_loc}; use "
            f"fewer devices on this axis")
    W = np.zeros((n, out_loc, in_loc + 2 * h), np.float32)
    for d in range(n):
        lo = d * in_loc - h
        for j in range(in_loc + 2 * h):
            col = lo + j
            if 0 <= col < Hin:
                W[d, :, j] = M[d * out_loc:(d + 1) * out_loc, col]
    return W, h


def sharded_resize(mesh: Mesh, in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                   filter_name: str = "lanczos", has_alpha: bool = False,
                   in_spec: P = _BATCH) -> Callable:
    """Spatially sharded separable filter resize (resize.c
    HorizontalFilter/VerticalFilter): each block applies its shard's
    slice of the dense resample operator to its halo'd tile.  Arbitrary
    in/out dims: axes the mesh does not divide are padded to it in
    OPERATOR space (zero rows/columns), the input is zero-padded to
    match, and the padded output rows/columns are cropped after, which
    leaves a tensor on the first device (a ShardedArray when no crop is
    needed).  Alpha inputs get the reference's alpha-weighted resample
    (premultiply / renormalize with a 1e-6 guard), then the final clip."""
    from ..ops.resize import resize_matrix

    Hin, Win = in_hw
    Hout, Wout = out_hw
    ny = mesh.shape["sy"]
    nx = mesh.shape["sx"]

    def _pad_up(v, n):
        return -(-v // n) * n

    HinP, WinP = _pad_up(Hin, ny), _pad_up(Win, nx)
    HoutP, WoutP = _pad_up(Hout, ny), _pad_up(Wout, nx)
    Mv = np.zeros((HoutP, HinP), np.float32)
    Mv[:Hout, :Hin] = np.asarray(resize_matrix(Hin, Hout, filter_name),
                                 np.float32).T
    Mw = np.zeros((WoutP, WinP), np.float32)
    Mw[:Wout, :Win] = np.asarray(resize_matrix(Win, Wout, filter_name),
                                 np.float32).T
    WY, hy = _shard_axis_weights(Mv, ny)
    WX, hx = _shard_axis_weights(Mw, nx)

    def premultiply(t):
        a = t[..., -1:]
        return torch.cat([t[..., :-1] * a, a], dim=-1)

    def finish(t):
        if has_alpha and t.shape[-1] > 1:
            a = t[..., -1:]
            safe = torch.where(a.abs() < 1e-6, torch.ones_like(a), a)
            t = torch.cat([t[..., :-1] / safe, a], dim=-1)
        return t.clamp(0.0, 1.0)   # resize.c clamps the final pass

    def run(x):
        pad = HinP != Hin or WinP != Win
        if pad and isinstance(x, ShardedArray):
            x = x.gather()
        alpha = has_alpha and x.shape[-1] > 1
        if alpha:
            x = _pointwise(x, premultiply)
        if pad:
            # zero pad: the padded operator columns carry zero weight, so
            # the pad value never reaches a real output pixel
            x = torch.nn.functional.pad(
                x, (0, 0, 0, WinP - Win, 0, HinP - Hin))
        x = _on_mesh(x, mesh, in_spec)
        nd = x.ndim

        def vertical(idx):
            b = _window(x.blocks, idx, [(1, nd - 3, hy, "sy")])
            wv = torch.from_numpy(WY[idx[1]]).to(b.device)
            return torch.einsum("oi,...iwc->...owc", wv, b)

        mid = _map_blocks(x, vertical)

        def horizontal(idx):
            b = _window(mid.blocks, idx, [(2, nd - 2, hx, "sx")])
            ww = torch.from_numpy(WX[idx[2]]).to(b.device)
            return torch.einsum("oj,...hjc->...hoc", ww, b)

        out = _map_blocks(mid, horizontal)
        if HoutP != Hout or WoutP != Wout:
            out = out.gather()[..., :Hout, :Wout, :]
        return _pointwise(out, finish)

    return run


def _row_counts(x2d: torch.Tensor) -> torch.Tensor:
    """(R, L) values -> (R, 256) int64 counts of clip(int(v*255+0.5), 0,
    255) per row: one launch of K4 on the card."""
    from ..ops import gpu_kernels

    x2d = x2d.to(torch.float32).contiguous()
    return gpu_kernels.histogram256(x2d).to(torch.int64)


def _local_histogram_256(values: torch.Tensor) -> torch.Tensor:
    """One block's 256-bin histogram as (256,) int64 counts: K4 over the
    block's (H*N, W*C) rows (a row of W*C values stays far below K4's
    2^31 limit where one row of a gigapixel block would not), the rows'
    counts summed in int64."""
    if values.numel() == 0:
        return torch.zeros(256, dtype=torch.int64, device=values.device)
    return _row_counts(values.reshape(
        -1, values.shape[-2] * values.shape[-1])).sum(0)


def _image_histograms(inten: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 1) intensities -> (N, 256) int64 counts per image."""
    n, h, w = inten.shape[0], inten.shape[1], inten.shape[2]
    if inten.numel() == 0:
        return torch.zeros((n, 256), dtype=torch.int64, device=inten.device)
    return _row_counts(inten.reshape(n * h, w)).reshape(n, h, 256).sum(1)


def _all_reduce(t: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """Finish a reduction over dp across the group's processes, for a
    mesh made under the group (``Mesh.reduces_over_group``); a mesh made
    without one holds every dp row, and its reduction is whole."""
    import torch.distributed as dist

    if mesh.reduces_over_group():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "min": dist.ReduceOp.MIN,
                               "max": dist.ReduceOp.MAX}[op])
    return t


def sharded_otsu_threshold(mesh: Mesh, in_spec: P = _BATCH) -> Callable:
    """Sharded -auto-threshold otsu: each image's 256-bin intensity
    histogram summed over its sy/sx blocks (per image: dp carries
    independent images, threshold.c processes one at a time), the port's
    Otsu on it, and the pointwise bilevel of the intensity against
    ``bin * float32(1/255)`` with ``>``.  Returns (N, H, W, 1), sharded."""
    from ..ops.enhance import grayscale
    from ..ops.threshold import _otsu

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        inten = _pointwise(
            x, lambda b: grayscale(b)[..., 0:1] if b.shape[-1] >= 3
            else b[..., 0:1])
        rows = {}
        for idx in np.ndindex(inten.blocks.shape):
            h = _image_histograms(inten.blocks[idx])
            first = idx[0]
            if first in rows:
                rows[first] = rows[first] + h.to(rows[first].device)
            else:
                rows[first] = h
        t = {k: _otsu(h) for k, h in rows.items()}

        def apply(idx):
            b = inten.blocks[idx]
            th = t[idx[0]].to(b.device).reshape(-1, 1, 1, 1)
            return (b > th).to(x.dtype)

        return _map_blocks(inten, apply)

    return run


def sharded_gaussian_blur(mesh: Mesh, sigma: float,
                          in_spec: P = _BATCH) -> Callable:
    """Spatially sharded separable Gaussian blur: each block is blurred
    with a kernel-radius halo from its neighbours (sy, then sx on that
    result), by ``ops.blur._separable_conv`` — kernel K3 on the card for
    at most 33 taps and 8 channels — and the halo cropped.  Not clipped,
    as the JAX function's VALID convolutions are not."""
    from ..ops.blur import gaussian_kernel_1d

    return _sharded_separable(mesh, gaussian_kernel_1d(0.0, sigma), in_spec)


def _sharded_separable(mesh: Mesh, taps, in_spec: P = _BATCH) -> Callable:
    from ..ops.blur import _separable_conv

    taps = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        ex = [(1, 1, r, "sy"), (2, 2, r, "sx")]
        return _map_blocks(x, lambda idx: _crop(
            _separable_conv(_window(x.blocks, idx, ex), taps, "edge"), r, r))

    return run


def sharded_histogram(mesh: Mesh, bins: int = 256,
                      in_spec: P = _BATCH) -> Callable:
    """Global histogram over a sharded image: each block's counts (K4 for
    256 bins; ``clip(int(v*(bins-1) + 0.5), 0, bins-1)`` counted directly
    otherwise), summed in int64 over every block and process, returned as
    float32 on the first device."""

    def local(b):
        if bins == 256:
            return _local_histogram_256(b)
        idx = (b.reshape(-1) * (bins - 1) + 0.5).to(torch.int32)
        idx = idx.clamp(0, bins - 1).to(torch.int64)
        return torch.bincount(idx, minlength=bins)

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        dev = mesh.first_device
        hist = torch.zeros(bins, dtype=torch.int64, device=dev)
        for blk in x.blocks.flat:
            hist += local(blk).to(dev)
        return _all_reduce(hist, "sum", mesh).to(torch.float32)

    return run


def _moments(b: torch.Tensor):
    """float64 per-channel sum and sum of squares of one (..., H, W, C)
    block, over bands of rows of about 2^24 values (no float64 copy of
    the whole block)."""
    dims = tuple(range(b.dim() - 1))
    c = b.shape[-1]
    s = torch.zeros(c, dtype=torch.float64, device=b.device)
    s2 = torch.zeros(c, dtype=torch.float64, device=b.device)
    if b.numel() == 0:
        return s, s2
    axis = b.dim() - 3
    rows = b.shape[axis]
    step = max(1, (1 << 24) // (b.numel() // rows))
    for r0 in range(0, rows, step):
        part = b.narrow(axis, r0, min(step, rows - r0)).to(torch.float64)
        s += part.sum(dim=dims)
        s2 += (part * part).sum(dim=dims)
    return s, s2


def sharded_statistics(mesh: Mesh, in_spec: P = _BATCH) -> Callable:
    """Sharded mean/std/min/max per channel: each block's count, float64
    sums and min/max, reduced over every block and process; the standard
    deviation's square root in float64, rounded to float32."""

    def run(x):
        x = _on_mesh(x, mesh, in_spec)
        dev = mesh.first_device
        c = x.shape[-1]
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        s = torch.zeros(c, dtype=torch.float64, device=dev)
        s2 = torch.zeros(c, dtype=torch.float64, device=dev)
        mn = torch.full((c,), float("inf"), dtype=x.dtype, device=dev)
        mx = torch.full((c,), float("-inf"), dtype=x.dtype, device=dev)
        dims = tuple(range(x.ndim - 1))
        for blk in x.blocks.flat:
            bs, bs2 = _moments(blk)
            cnt += blk.numel() // c
            s += bs.to(dev)
            s2 += bs2.to(dev)
            if blk.numel():
                mn = torch.minimum(mn, blk.amin(dim=dims).to(dev))
                mx = torch.maximum(mx, blk.amax(dim=dims).to(dev))
        for t, op in ((cnt, "sum"), (s, "sum"), (s2, "sum"), (mn, "min"),
                      (mx, "max")):
            _all_reduce(t, op, mesh)
        n = cnt.to(torch.float64)
        mean = s / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        return (mean.to(torch.float32), torch.sqrt(var).to(torch.float32),
                mn, mx)

    return run
