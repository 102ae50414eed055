"""Out-of-core tile executor: the disk-backed pixel cache on one card.

Port of ``imagemagick_tpu/models/outofcore.py``.  ImageMagick processes
images larger than memory through a pixel cache spilled to disk
(MagickCore/cache.c:3479 OpenPixelCacheOnDisk) with per-op row windows.
Here the image lives on the host (a numpy array, an ``np.memmap`` over a
file, or any loader ``loader(y0, y1) -> rows``) and a chain of device
ops streams over OVERLAPPING row bands: each band is read once, uploaded
once, processed on ``device`` (the card unless the caller asks for the
CPU), trimmed of its halo and handed back to the host.  Shape-preserving
neighbourhood ops of radius <= halo are exact in the interior (bands see
real neighbour rows); the global top and bottom edges are edge-replicated
(the 'edge' virtual-pixel policy, cache.c:2627 EdgeY).

On a CUDA band a ``blur`` or ``unsharp`` of a chain is one launch of
kernel K3 (``ops.blur._separable_conv``), and ``reduce_tiled`` with
``ops.histogram.channel_histogram`` one launch of kernel K4 a channel.
The banded resize is two dense float32 products (``torch.matmul``), as
the JAX package computes it outside any kernel; TF32 stays off, as the
package sets it.

The JAX functions jit one executable per band shape; the port has no
executables to cache and takes no ``jit`` flag.  Two faults of the JAX
module are not copied: its ``process_tiled`` reads the first band twice
(a probe it never uses), where the port reads each band once; and its
banded resize leaves values that a Lanczos lobe rings past [0, 1]
unclipped, where ``ops.resize`` (the in-core route) clips them, so a
post-resize op saw other inputs than in core.  The port clips after the
two products, as ``ops.resize`` does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.image import checked_device

Loader = Union[np.ndarray, Callable[[int, int], np.ndarray]]


def _get_rows(src: Loader, y0: int, y1: int) -> np.ndarray:
    if callable(src):
        return np.asarray(src(y0, y1))
    return np.asarray(src[y0:y1])


def _upload(rows: np.ndarray, pad_top: int, pad_bot: int,
            device) -> torch.Tensor:
    """Host rows on ``device`` once, with ``pad_top``/``pad_bot`` edge
    copies of the first and last row added there (``np.pad`` mode
    'edge').  64-bit samples become 32-bit, as JAX's default types make
    them; a band keeps its other dtype."""
    arr = np.asarray(rows)
    if arr.dtype.itemsize == 8 and arr.dtype.kind in "fiu":
        arr = arr.astype(arr.dtype.kind + "4")
    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("="))
    if not arr.flags.writeable:     # a read-only memmap's rows
        arr = arr.copy()
    x = torch.from_numpy(arr).to(checked_device(device, "outofcore"))
    if pad_top or pad_bot:
        n = x.shape[0]
        idx = torch.arange(-pad_top, n + pad_bot, device=x.device)
        x = x.index_select(0, idx.clamp(0, n - 1))
    return x


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def process_tiled(src: Loader, height: int, fn: Callable,
                  halo: int = 0, band_rows: int = 512,
                  out: Optional[np.ndarray] = None,
                  device="cuda") -> np.ndarray:
    """Apply a shape-preserving device op over row bands with halo overlap.

    src: (H, W, C) numpy array / np.memmap, or loader(y0, y1) -> rows.
    fn: (h, W, C) tensor on ``device`` -> (h, W', C'); must keep the rows
        (rows in = rows out) and tolerate halo rows.
    halo: neighbourhood radius the op needs (e.g. a blur kernel's radius).
    out: optional preallocated output (np.memmap for on-disk results).

    Every band is padded (edge rows) to the same extent, band_rows + 2
    halo, as the JAX function pads it for its one executable: the pads
    decide what ``fn`` sees at the bottom edge.
    """
    y = 0
    while y < height:
        y1 = min(y + band_rows, height)
        lo = max(y - halo, 0)
        hi = min(y1 + halo, height)
        band = _get_rows(src, lo, hi)
        full = band_rows + 2 * halo
        pad_top = halo - (y - lo)
        pad_bot = max(full - band.shape[0] - pad_top, 0)
        res = fn(_upload(band, pad_top, pad_bot, device))
        res = _host(res[halo:halo + (y1 - y)])
        if out is None:
            out = np.empty((height,) + res.shape[1:], res.dtype)
        out[y:y1] = res
        y = y1
    return out


def reduce_tiled(src: Loader, height: int, map_fn: Callable,
                 combine: Callable, init, band_rows: int = 512,
                 device="cuda"):
    """Streaming global reduction (histogram/statistics) over row bands.

    map_fn: band tensor on ``device`` -> partial; combine(acc, partial)
    -> acc, where each partial comes back to the host as numpy.  The
    GetImageStatistics-over-disk-cache analog.
    """
    acc = init
    y = 0
    while y < height:
        y1 = min(y + band_rows, height)
        band = _get_rows(src, y, y1)
        acc = combine(acc, _host(map_fn(_upload(band, 0, 0, device))))
        y = y1
    return acc


# ---------------------------------------------------------------------------
# General banded op-chain executor (the "any op over a tera-pixel image"
# tier: cache.c:3479 disk cache + the per-op row windows of cache-view.c,
# generalized to arbitrary chains instead of per-op special cases)
# ---------------------------------------------------------------------------

#: registry: name -> (halo_rows(params) -> int, apply(x, params) -> x).
#: Every op is shape-preserving along H and W; geometry changes go
#: through the dedicated resize stage of run_chain below.
_CHAIN_OPS = {}


def _chain_op(name, halo):
    def deco(fn):
        _CHAIN_OPS[name] = (halo, fn)
        return fn
    return deco


@_chain_op("negate", lambda p: 0)
def _oc_negate(x, p):
    return 1.0 - x


@_chain_op("gamma", lambda p: 0)
def _oc_gamma(x, p):
    from ..ops import enhance

    return enhance.gamma(x, float(p.get("value", 1.0)))


@_chain_op("level", lambda p: 0)
def _oc_level(x, p):
    from ..ops import enhance

    return enhance.level(x, float(p.get("black", 0.0)),
                         float(p.get("white", 1.0)),
                         float(p.get("gamma", 1.0)))


@_chain_op("modulate", lambda p: 0)
def _oc_modulate(x, p):
    from ..ops import enhance

    return enhance.modulate(x, float(p.get("brightness", 100.0)),
                            float(p.get("saturation", 100.0)),
                            float(p.get("hue", 100.0)))


@_chain_op("colorspace", lambda p: 0)
def _oc_colorspace(x, p):
    from ..ops import colorspace as cs

    return cs.convert(x, p.get("src", "srgb"), p["dst"])


@_chain_op("threshold", lambda p: 0)
def _oc_threshold(x, p):
    return (x > float(p.get("value", 0.5))).to(x.dtype)


def _blur_halo(p):
    from ..ops.blur import gaussian_kernel_1d

    k = gaussian_kernel_1d(float(p.get("radius", 0.0)),
                           float(p.get("sigma", 1.0)))
    return max(len(k) // 2, 1)   # the exact kernel support, not 3-sigma


@_chain_op("blur", _blur_halo)
def _oc_blur(x, p):
    from ..ops import blur as bl

    return bl.gaussian_blur(x, float(p.get("radius", 0.0)),
                            float(p.get("sigma", 1.0)))


@_chain_op("unsharp", _blur_halo)
def _oc_unsharp(x, p):
    from ..ops import blur as bl

    return bl.unsharp_mask(x, float(p.get("radius", 0.0)),
                           float(p.get("sigma", 1.0)),
                           float(p.get("amount", 1.0)),
                           float(p.get("threshold", 0.05)))


#: primitive passes per morphology method: each pass widens the halo by
#: the kernel radius (open = erode+dilate, smooth = open+close, ...)
_MORPH_PASSES = {"erode": 1, "dilate": 1, "erodeintensity": 1,
                 "dilateintensity": 1, "hitandmiss": 1, "hmt": 1,
                 "thinning": 1, "thicken": 1, "edgein": 1, "edgeout": 1,
                 "edge": 1, "open": 2, "close": 2, "openintensity": 2,
                 "closeintensity": 2, "tophat": 2, "bottomhat": 2,
                 "smooth": 4, "correlate": 1, "convolve": 1}


def _morph_halo(p):
    from ..ops.morphology import get_kernel

    iters = int(p.get("iterations", 1))
    if iters < 0:
        raise ValueError("outofcore: morphology until-converged "
                         "(iterations=-1) needs the full image in core")
    meth = str(p.get("method", "dilate")).lower().replace("-", "")
    passes = _MORPH_PASSES.get(meth)
    if passes is None:
        raise ValueError(f"outofcore: morphology method {meth!r} is not "
                         "row-local (use the in-core path)")
    k = get_kernel(p.get("kernel", "square:1"))[0]
    return max(k.shape[0] // 2, 1) * passes * max(iters, 1)


@_chain_op("morphology", _morph_halo)
def _oc_morphology(x, p):
    from ..ops import morphology as mo

    return mo.morphology(x, p.get("method", "dilate"),
                         p.get("kernel", "square:1"),
                         iterations=int(p.get("iterations", 1)))


@_chain_op("median", lambda p: int(p.get("radius", 1)))
def _oc_median(x, p):
    from ..ops import statistic as st

    r = int(p.get("radius", 1))
    return st.statistic(x, "median", 2 * r + 1, 2 * r + 1)


def _expand_ops(ops):
    """Expand compound/iterated morphology into primitive single-pass
    stages so the per-op edge re-replication between stages reproduces
    the in-core edge policy exactly (open = erode;dilate, close =
    dilate;erode, smooth = open;close, iterations = repeated stages).
    Methods that combine a neighborhood result with the pre-op input
    pointwise (tophat/bottomhat/edge/hmt) stay single stages."""
    out = []
    for name, params in ops:
        if name != "morphology":
            out.append((name, params))
            continue
        meth = str(params.get("method", "dilate")).lower().replace("-", "")
        iters = max(int(params.get("iterations", 1)), 1)
        seq = {"open": ["erode", "dilate"], "close": ["dilate", "erode"],
               "smooth": ["erode", "dilate", "dilate", "erode"],
               "openintensity": ["erodeintensity", "dilateintensity"],
               "closeintensity": ["dilateintensity", "erodeintensity"],
               }.get(meth)
        if seq is None and meth in ("erode", "dilate", "erodeintensity",
                                    "dilateintensity") and iters > 1:
            seq = [meth]
        if seq is None:
            out.append((name, params))
            continue
        for _ in range(iters):
            for prim in seq:
                out.append(("morphology",
                            dict(params, method=prim, iterations=1)))
    return out


def chain_halo(ops) -> int:
    """Total halo rows a shape-preserving op chain needs."""
    total = 0
    for name, params in ops:
        if name not in _CHAIN_OPS:
            raise ValueError(f"outofcore: unsupported chain op {name!r}")
        total += _CHAIN_OPS[name][0](params)
    return total


def _replicate_edges(x: torch.Tensor, top: int, bot: int) -> torch.Tensor:
    """``x`` with its first ``top`` rows set to row ``top`` and its last
    ``bot`` rows to the row before them."""
    if not (top or bot):
        return x
    n = x.shape[0]
    idx = torch.arange(n, device=x.device).clamp(top, n - bot - 1)
    return x.index_select(0, idx)


def _apply_edges(seq, x: torch.Tensor, top_pad: int, bot_pad: int
                 ) -> torch.Tensor:
    """Apply the chain; at GLOBAL image edges re-replicate each op's own
    output into the pad region between ops, so every op sees
    edge-replication of its *input* exactly like the in-core edge
    virtual-pixel policy (a single input-side replicate diverges for
    chains of 2+ neighborhood ops)."""
    for idx, (name, params) in enumerate(seq):
        x = _CHAIN_OPS[name][1](x, params)
        if idx + 1 < len(seq):
            x = _replicate_edges(x, top_pad, bot_pad)
    return x


def run_chain(src: Loader, in_shape: Tuple[int, int, int], ops,
              resize: Optional[Tuple[int, int, str]] = None,
              post_ops=(), band_rows: int = 512,
              out: Optional[np.ndarray] = None,
              device="cuda") -> np.ndarray:
    """Run [ops] -> optional resize -> [post_ops] over row bands on
    ``device``.

    src: (H, W, C) array/memmap or loader(y0, y1); never fully resident.
    ops/post_ops: [(name, params)] from the registry above — any chain.
    resize: (Hout, Wout, filter) or None.
    out: any object that takes ``out[y0:y1] = rows`` in ascending order
        (host numpy rows, once a band); a numpy array by default.

    The H-resize distributes over bands by slicing the (Hout, Hin) axis
    operator: output band [o0, o1) reads exactly the input rows its
    operator columns touch, extended by the pre-chain halo — the banded
    analog of fused_pipeline._axis_operator.  Exact in the interior;
    global edges are edge-replicated (cache.c:2627 EdgeY policy).  The W
    operator and each band's block of the H operator are uploaded once.
    """
    from ..ops.resize import resize_matrix

    H, W, C = in_shape
    ops = _expand_ops(list(ops))
    post_ops = _expand_ops(list(post_ops))
    pre_halo = chain_halo(ops)
    post_halo = chain_halo(post_ops)

    if resize is None:
        full = list(ops) + list(post_ops)
        halo = pre_halo + post_halo
        y = 0
        while y < H:
            y1 = min(y + band_rows, H)
            lo = max(y - halo, 0)
            hi = min(y1 + halo, H)
            rows = _get_rows(src, lo, hi)
            bsize = band_rows + 2 * halo
            pad_top = max(halo - (y - lo), 0)
            pad_bot = max(bsize - rows.shape[0] - pad_top, 0)
            x = _upload(rows, pad_top, pad_bot, device)
            res = _apply_edges(full, x, pad_top, pad_bot)
            res = _host(res[halo:halo + (y1 - y)])
            if out is None:
                out = np.empty((H,) + res.shape[1:], res.dtype)
            out[y:y1] = res
            y = y1
        return out

    Hout, Wout, filt = resize
    Mv = resize_matrix(H, Hout, filt).astype(np.float32).T   # (Hout, Hin)
    Mw = None    # (Win, Wout) on the bands' device, uploaded once

    # fixed band shapes, as the JAX function's one executable has them.
    # Output bands are extended by post_halo resized rows on each side so
    # the post chain sees real neighbors before the trim.
    ob_rows = min(band_rows, Hout)
    bands = []
    for o0 in range(0, Hout, ob_rows):
        o1 = min(o0 + ob_rows, Hout)
        o0x = max(o0 - post_halo, 0)
        o1x = min(o1 + post_halo, Hout)
        cols = np.nonzero(np.abs(Mv[o0x:o1x]).sum(axis=0) > 0)[0]
        bands.append((o0, o1, o0x, o1x, int(cols[0]), int(cols[-1]) + 1))
    max_span = max(b - a for *_, a, b in bands) + 2 * pre_halo
    ob_ext = ob_rows + 2 * post_halo

    for o0, o1, o0x, o1x, a, b in bands:
        lo = max(a - pre_halo, 0)
        hi = min(b + pre_halo, H)
        rows = _get_rows(src, lo, hi)
        pad_top = max(pre_halo - (a - lo), 0)   # >0 when clipped at row 0
        pad_bot = max(max_span - rows.shape[0] - pad_top, 0)
        # operator block aligned to the padded band: column j of the
        # band is absolute input row (a - pre_halo) + j.  Output rows of
        # the block: the extended band [o0x, o1x), top-aligned at the
        # slot post_halo - (o0 - o0x).
        mv = np.zeros((ob_ext, max_span), np.float32)
        oo = post_halo - (o0 - o0x)
        mv[oo:oo + (o1x - o0x), pre_halo:pre_halo + (b - a)] = \
            Mv[o0x:o1x, a:b]
        # replicate clipped output-edge rows of the operator so post
        # ops see edge-replicated resized rows at the global edges
        if oo:
            mv[:oo] = mv[oo]
        tail = oo + (o1x - o0x)
        if tail < ob_ext:
            mv[tail:] = mv[tail - 1]
        x = _upload(rows, pad_top, pad_bot, device)
        if Mw is None:
            Mw = torch.from_numpy(
                resize_matrix(W, Wout, filt).astype(np.float32)).to(x.device)
        for name, params in ops:
            x = _replicate_edges(_CHAIN_OPS[name][1](x, params), pad_top,
                                 pad_bot)
        mv_t = torch.from_numpy(mv).to(x.device)
        n, w, c = x.shape
        y = (mv_t @ x.reshape(n, w * c)).reshape(-1, w, c)  # H-resize
        y = torch.einsum("wp,owc->opc", Mw, y)   # W-resize (full width)
        y = y.clamp(0.0, 1.0)     # as ops.resize clips its result
        y = _apply_edges(list(post_ops), y, post_halo - (o0 - o0x),
                         post_halo - (o1x - o1))
        res = _host(y[post_halo:post_halo + (o1 - o0)])
        if out is None:
            out = np.empty((Hout,) + res.shape[1:], res.dtype)
        out[o0:o1] = res
    return out
