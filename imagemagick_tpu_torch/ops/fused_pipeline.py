"""Fused pipelines: two banded block products (K1), blur -> unsharp (K2, K2p).

Port of ``imagemagick_tpu/ops/fused_pipeline.py``.  The thumbnail pipeline
— resize (any filter), separable Gaussian blur, and any per-pixel linear
channel mix (e.g. sRGB->Gray luma) — is a composition of LINEAR maps along
H, along W and across C.  The host compiles the whole chain into

    out[n] = clip( WV @ x[n] @ G )

where WV is the (Hout, Hin) vertical resize*blur operator and G the
(Win*C, Wout*Cout) horizontal resize*blur*channel-mix operator.  Both are
banded, so each output row tile needs only a thin input band.  Kernel K1
(``csrc/fused_pipeline.cu``) runs both products per tile with every
intermediate on chip: one read of the input, one write of the output.

The host planner (``blur_band_matrix`` .. ``_plan``) is numpy copied
verbatim from the JAX package, so the kernel's operands are bit-equal to
the Pallas kernel's.  Boundary semantics are exact: edge clipping and
renormalization (resize.c:3389-3440) and the blur's edge-replicate padding
are baked into the host-built matrices.  Arithmetic is full float32.

Config #2 — Gaussian blur, unsharp mask (threshold 0), and optionally an
sRGB->Lab->sRGB round trip — runs as kernel K2 (``csrc/blur_unsharp.cu``)
through ``fused_blur_unsharp_pipeline``: the two blurs as stencils of the
taps the JAX planner derives (``blur_unsharp_taps``) and the rest per
pixel, again one read of the input and one write of the output.  With
``pipelined=True`` and the Lab round trip, the same function runs as
kernel K2p (``csrc/blur_unsharp_pipe.cu``), the counterpart of the JAX
package's software-pipelined ``_kernel_pipe``: a persistent grid whose
producer warps compute the stencils of one tile while its consumer warps
run the Lab epilogue of the tile before and store it.

Reference parity: ResizeImage (MagickCore/resize.c:3761),
GaussianBlurImage (effect.c:1709), UnsharpMaskImage (effect.c:4256),
GrayscaleImage luma (colorspace.c:886-901), sRGBTransformImage Lab
(colorspace.c:722).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .gpu_kernels import LAUNCHES, constant_on, on_card, stream_of
from .resize import resize_matrix


def _align(x: int, m: int) -> int:
    return -(-x // m) * m


def blur_band_matrix(n: int, sigma: float, radius: float = 0.0,
                     width_rule: str = "2d") -> np.ndarray:
    """(n, n) banded separable-Gaussian operator with edge-replicate pads.

    Same taps as ops.blur.gaussian_blur (effect.c:1709 sigma->width rules,
    width_rule='2d') or ops.blur.blur (1-D rule, width_rule='1d'); rows
    are exact including the clamped edge windows.
    """
    from .blur import (gaussian_kernel_1d, optimal_kernel_width_2d)

    if width_rule == "1d":
        k = np.asarray(gaussian_kernel_1d(radius, sigma), np.float64)
        j = (len(k) - 1) // 2
    else:
        width = optimal_kernel_width_2d(radius, sigma)
        j = (width - 1) // 2
        xs = np.arange(-j, j + 1, dtype=np.float64)
        k = np.exp(-(xs * xs) / (2.0 * max(sigma, 1e-12) ** 2))
        k /= k.sum()
    B = np.zeros((n, n), np.float64)
    for o in range(n):
        for t, kv in zip(range(o - j, o + j + 1), k):
            B[o, min(max(t, 0), n - 1)] += kv
    return B


@functools.lru_cache(maxsize=64)
def _axis_operator(in_size: int, out_size: int, filt: str, blur_sigma: float
                   ) -> np.ndarray:
    """(out, in) combined resize (+ optional blur) operator for one axis."""
    M = resize_matrix(in_size, out_size, filt).astype(np.float64).T
    if blur_sigma > 0.0:
        M = blur_band_matrix(out_size, blur_sigma) @ M
    return M


def _v_blocks(Mv: np.ndarray, Hin: int, TO: int
              ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Slice the vertical operator into per-tile (TO, BAND) blocks."""
    Hout = Mv.shape[0]
    ntiles = -(-Hout // TO)
    r0s, spans = [], []
    for t in range(ntiles):
        rows = Mv[t * TO:min((t + 1) * TO, Hout)]
        nz = np.nonzero(np.abs(rows).sum(0) > 0)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1)
        r0s.append((lo // 8) * 8)
        spans.append(hi - (lo // 8) * 8)
    BAND = min(_align(max(spans), 8), _align(Hin, 8))
    if BAND > Hin:
        BAND = Hin - Hin % 8 if Hin % 8 else Hin
    r0s = [max(0, min(r0, Hin - BAND)) for r0 in r0s]
    WV = np.zeros((ntiles, TO, BAND), np.float32)
    for t, r0 in enumerate(r0s):
        rows = Mv[t * TO:min((t + 1) * TO, Hout)]
        WV[t, :rows.shape[0]] = rows[:, r0:r0 + BAND]
    return WV, np.asarray(r0s, np.int32), BAND, ntiles


def _h_blocks(Mw: np.ndarray, C: int, mix: np.ndarray, WINC: int
              ) -> Tuple[np.ndarray, Tuple[int, ...], int, int, int]:
    """Expand the horizontal operator across channels and block by 128 lanes.

    G[w*C+c, o*Cout+c'] = Mw[o, w] * mix[c', c]; blocks cover 128 output
    lanes each with a 128-aligned input-lane window.
    """
    Wout, Win = Mw.shape
    Cout = mix.shape[0]
    OUT = Wout * Cout
    OUTP = _align(OUT, 128)
    G = np.zeros((WINC, OUTP), np.float64)
    MwT = Mw.T  # (Win, Wout)
    for c in range(C):
        for cp in range(Cout):
            if mix[cp, c] == 0.0:
                continue
            G[c:Win * C:C, cp:OUT:Cout] += mix[cp, c] * MwT
    nb = OUTP // 128
    c0s, spans = [], []
    for b in range(nb):
        cols = G[:, b * 128:(b + 1) * 128]
        nz = np.nonzero(np.abs(cols).sum(1) > 0)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 128)
        c0s.append((lo // 128) * 128)
        spans.append(hi - (lo // 128) * 128)
    SPAN = min(_align(max(spans), 128), WINC)
    c0s = [max(0, min(c0, WINC - SPAN)) for c0 in c0s]
    GB = np.zeros((nb, SPAN, 128), np.float32)
    for b, c0 in enumerate(c0s):
        GB[b] = G[c0:c0 + SPAN, b * 128:(b + 1) * 128]
    return GB, tuple(c0s), SPAN, OUT, OUTP


# ---------------------------------------------------------------------------
# Kernel K1 and its plain version
# ---------------------------------------------------------------------------

_LANES = 32        # output lanes per K1 block (LB in csrc/fused_pipeline.cu)
_SLICE = 16        # input lanes per staged slice (KC)
_WARP_LANES = 8    # lanes of a warp in K1's horizontal product (WL)
_WARP_ROWS = 16    # output rows of a warp in K1's vertical product (VR)


class K1Operands(NamedTuple):
    """K1's tensor operands on one device (see ``plan_to_tensors``)."""
    r0: torch.Tensor    # (nprog,) int32 absolute first band row per program
    WV: torch.Tensor    # (T*ntiles, TO, BAND) float32
    GB: torch.Tensor    # (n_unique, SPAN, 128) float32
    kr: torch.Tensor    # (n_unique, 128 // _LANES, 2) int32, _depth_ranges
    hwin: torch.Tensor  # (n_unique, 128 // _WARP_LANES, 2) int32,
                        # _lane_windows
    vwin: torch.Tensor  # (T*ntiles, ceil(TO / _WARP_ROWS), 2) int32,
                        # _row_windows


def _windows(nz: np.ndarray, align: int) -> np.ndarray:
    """[lo, hi) of the True entries along axis 1 of ``nz`` (n, depth,
    groups), widened to multiples of ``align`` (depth is one); (0, 0)
    where a group has none.  Returns (n, groups, 2) int32."""
    depth = nz.shape[1]
    lo = np.argmax(nz, axis=1)
    hi = depth - np.argmax(nz[:, ::-1], axis=1)
    out = np.stack([lo // align * align, -(-hi // align) * align], axis=-1)
    out[~nz.any(axis=1)] = 0
    return out.astype(np.int32)


def _depth_ranges(GB: np.ndarray) -> np.ndarray:
    """[lo, hi) of the non-zero rows of each _LANES-lane chunk of each G
    block, widened to multiples of _SLICE; (0, 0) for an all-zero chunk.

    A G block spans the input lanes that any of its 128 output lanes
    reads, so each chunk reads only part of that depth (about a third for
    config #1).  K1 stages the band and G over this range only."""
    n, span, lanes = GB.shape
    nz = (GB.reshape(n, span, lanes // _LANES, _LANES) != 0).any(axis=3)
    return _windows(nz, _SLICE)


def _lane_windows(GB: np.ndarray) -> np.ndarray:
    """[lo, hi) of the non-zero rows of each _WARP_LANES-lane group of each
    G block, widened to multiples of 4 (inside its chunk's
    _depth_ranges); (0, 0) for an all-zero group.  A warp of K1 multiplies
    over its group's window only: about 238 rows at config #1, of its
    32-lane chunk's 456."""
    n, span, lanes = GB.shape
    nz = (GB.reshape(n, span, lanes // _WARP_LANES, _WARP_LANES) != 0
          ).any(axis=3)
    return _windows(nz, 4)


def _row_windows(WV: np.ndarray) -> np.ndarray:
    """[lo, hi) of the non-zero band columns of each _WARP_ROWS-row group
    of each (term, row tile) block of WV, widened to multiples of 4; (0, 0)
    for an all-zero group.  A warp of K1 folds its rows over this window
    only: about 69 of config #1's 176 band rows."""
    nt, TO, BAND = WV.shape
    groups = -(-TO // _WARP_ROWS)
    pad = np.zeros((nt, groups * _WARP_ROWS, BAND), bool)
    pad[:, :TO] = WV != 0
    nz = pad.reshape(nt, groups, _WARP_ROWS, BAND).any(axis=2)
    return _windows(nz.transpose(0, 2, 1), 4)


def _fused_plain(x: torch.Tensor, ops: K1Operands, c0s: Sequence[int],
                 guids: Sequence[int], ntiles: int, clip: bool = True
                 ) -> torch.Tensor:
    """K1's plain version: gather each program's band, two matmuls, clip.

    Same operands and result as ``fused_kernel`` (the window tables are
    not needed: the terms they skip are zero)."""
    nprog = ops.r0.shape[0]
    _, TO, BAND = ops.WV.shape
    SPAN = ops.GB.shape[1]
    nb = len(c0s)
    nterms = ops.WV.shape[0] // ntiles
    rows = ops.r0.long()[:, None] + torch.arange(BAND, device=x.device)
    band = x[rows]                                    # (nprog, BAND, WINC)
    tt = torch.arange(nprog, device=x.device) % ntiles
    out = None
    for t in range(nterms):
        mid = torch.cat([band[:, :, c0:c0 + SPAN] @ ops.GB[guids[t * nb + b]]
                         for b, c0 in enumerate(c0s)], dim=2)
        term = ops.WV[t * ntiles + tt] @ mid          # (nprog, TO, OUTP)
        out = term if out is None else out + term
    if clip:
        out = out.clamp(0.0, 1.0)
    return out.reshape(nprog * TO, nb * 128)


def fused_kernel(x: torch.Tensor, ops: K1Operands, c0s: Sequence[int],
                 guids: Sequence[int], ntiles: int, clip: bool = True
                 ) -> torch.Tensor:
    """K1, the counterpart of the Pallas ``_kernel`` built by ``_build_call``.

    x (rows, WINC) float32; ``ops`` from ``plan_to_tensors``; c0s / guids
    host integers as the planner made them.  Returns
    (nprog*TO, len(c0s)*128) float32.  The band offsets come from the
    planner, which keeps every band inside x.
    """
    c0s = tuple(int(c) for c in c0s)
    guids = tuple(int(g) for g in guids)
    if not on_card(x):
        return _fused_plain(x, ops, c0s, guids, ntiles, clip)
    r0, WV, GB, kr, hwin, vwin = ops
    nprog = r0.shape[0]
    nt, TO, BAND = WV.shape
    n_unique, SPAN, lanes = GB.shape
    WINC = x.shape[1] if x.dim() == 2 else -1
    nb = len(c0s)
    nterms = nt // ntiles
    for name, t, dtype in (("r0", r0, torch.int32), ("x", x, torch.float32),
                           ("WV", WV, torch.float32),
                           ("GB", GB, torch.float32),
                           ("kr", kr, torch.int32),
                           ("hwin", hwin, torch.int32),
                           ("vwin", vwin, torch.int32)):
        if t.device != x.device or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"fused_kernel: {name} must be a contiguous "
                             f"{dtype} tensor on {x.device}")
    # the kernel reads and writes float4: rows, offsets and bases 16-byte
    # aligned (the planner's BAND is a multiple of 8, c0s of 128)
    if (x.dim() != 2 or r0.dim() != 1 or lanes != 128 or nb < 1 or
            nt != nterms * ntiles or nprog % ntiles or TO > 128 or
            SPAN % 32 or BAND % 4 or WINC % 4 or
            len(guids) != nterms * nb or
            tuple(kr.shape) != (n_unique, 128 // _LANES, 2) or
            tuple(hwin.shape) != (n_unique, 128 // _WARP_LANES, 2) or
            tuple(vwin.shape) != (nt, -(-TO // _WARP_ROWS), 2) or
            any(t.data_ptr() % 16 for t in (x, WV, GB)) or
            not all(0 <= g < n_unique for g in guids) or
            not all(0 <= c and c % 4 == 0 and c + SPAN <= WINC
                    for c in c0s)):
        raise ValueError(
            f"fused_kernel: operands r0 {tuple(r0.shape)}, x "
            f"{tuple(x.shape)}, WV {tuple(WV.shape)}, GB {tuple(GB.shape)}, "
            f"kr {tuple(kr.shape)}, hwin {tuple(hwin.shape)}, vwin "
            f"{tuple(vwin.shape)}, {nb} blocks, {len(guids)} block ids, "
            f"ntiles {ntiles}")
    out = torch.empty((nprog * TO, nb * 128), dtype=torch.float32,
                      device=x.device)
    c0_t = constant_on(c0s, torch.int32, x.device)
    gid_t = constant_on(guids, torch.int32, x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k1_fused_pipeline(
            r0.data_ptr(), x.data_ptr(), WV.data_ptr(), GB.data_ptr(),
            kr.data_ptr(), hwin.data_ptr(), vwin.data_ptr(), c0_t.data_ptr(),
            gid_t.data_ptr(), out.data_ptr(),
            nprog, ntiles, nterms, nb, TO, BAND, SPAN, WINC, nb * 128,
            int(clip), stream_of(x))
    _build.check(err, "k1_fused_pipeline")
    LAUNCHES["k1"] += 1
    return out


def plan_to_tensors(WV: np.ndarray, GB: np.ndarray, r0: np.ndarray,
                    device) -> K1Operands:
    """Planner operands (numpy, this package's or the JAX package's) as
    K1's tensors on ``device``.  ``r0`` is the flat per-program band
    offsets (``flat_r0``); the window tables are derived from ``GB`` and
    ``WV``."""
    r0 = np.asarray(r0)
    if r0.ndim != 1 or (r0.size and r0.min() < 0):
        raise ValueError(f"bad band offsets {r0!r}")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return K1Operands(put(r0, np.int32), put(WV, np.float32),
                      put(GB, np.float32), put(_depth_ranges(GB), np.int32),
                      put(_lane_windows(GB), np.int32),
                      put(_row_windows(WV), np.int32))


def flat_r0(r0s: np.ndarray, N: int, Hin: int) -> np.ndarray:
    """Absolute band offsets of the flat 1-D program grid: program i is
    image i // ntiles, row tile i % ntiles."""
    ntiles = len(r0s)
    return (np.repeat(np.arange(N, dtype=np.int64) * Hin, ntiles) +
            np.tile(np.asarray(r0s, np.int64), N)).astype(np.int32)


class LinearPlan(NamedTuple):
    """A planned chain: kernel operands (numpy) and output geometry."""
    WV: np.ndarray          # (T*ntiles, TO, BAND) float32
    GB: np.ndarray          # (n_unique, SPAN, 128) float32
    r0s: np.ndarray         # (ntiles,) int32 band offset per row tile
    c0s: Tuple[int, ...]    # first input lane per 128-lane output block
    guids: Tuple[int, ...]  # unique block per (term, output block)
    ntiles: int
    Hout: int
    Wout: int
    Cout: int
    OUT: int


def run_plan(x2d: torch.Tensor, N: int, plan: LinearPlan, ops: K1Operands,
             clip: bool = True) -> torch.Tensor:
    """Run K1 on a flat (N*Hin, WINC) input with device operands ``ops``
    (``plan_to_tensors`` of the plan); returns (N, Hout, Wout, Cout)."""
    out = fused_kernel(x2d, ops, plan.c0s, plan.guids, plan.ntiles, clip)
    TO = plan.WV.shape[1]
    out = out.reshape(N, plan.ntiles * TO, out.shape[1])
    return out[:, :plan.Hout, :plan.OUT].reshape(
        N, plan.Hout, plan.Wout, plan.Cout)


def _plan(Hin, Win, C, Hout, Wout, filt, sigma, mix_key, TO):
    mix = np.asarray(mix_key, np.float64)
    Mv = _axis_operator(Hin, Hout, filt, sigma)
    Mw = _axis_operator(Win, Wout, filt, sigma)
    WV, r0s, BAND, ntiles = _v_blocks(Mv, Hin, TO)
    GB, c0s, SPAN, OUT, OUTP = _h_blocks(Mw, C, mix, Win * C)
    return WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP


def linear_plan(terms, C: int, mix: np.ndarray, TO: int, Hin: int,
                WINC: int) -> LinearPlan:
    """Plan a rank-T term list (the planning of the JAX package's
    ``fused_linear_pipeline``, without its VMEM-fit loop): blocks of the
    union banded structure, per-term blocks against the shared windows,
    identical G blocks deduplicated."""
    Hout = terms[0][0].shape[0]
    Wout, Win = terms[0][1].shape
    # union banded structure across terms: plan against sum of |operators|
    Mv_union = sum(np.abs(a) for a, _ in terms)
    Mw_union = sum(np.abs(b) for _, b in terms)
    _, r0s, BAND, ntiles = _v_blocks(Mv_union, Hin, TO)
    _, c0s, SPAN, OUT, OUTP = _h_blocks(Mw_union, C, mix, WINC)
    # per-term blocks sliced with the shared r0s/c0s
    WVs, GBs = [], []
    for Mv, Mw in terms:
        WV = np.zeros((ntiles, TO, BAND), np.float32)
        for t, r0 in enumerate(r0s):
            rows = Mv[t * TO:min((t + 1) * TO, Hout)]
            WV[t, :rows.shape[0]] = rows[:, r0:r0 + BAND]
        WVs.append(WV)
        # rebuild G against the SHARED c0s (a sparser term would
        # otherwise get different block windows)
        GB = np.zeros((len(c0s), SPAN, 128), np.float32)
        Gfull = np.zeros((WINC, OUTP), np.float64)
        MwT = Mw.T
        Cout = mix.shape[0]
        for c in range(C):
            for cp in range(Cout):
                if mix[cp, c] == 0.0:
                    continue
                Gfull[c:Win * C:C, cp:OUT:Cout] += mix[cp, c] * MwT
        for b, c0 in enumerate(c0s):
            GB[b] = Gfull[c0:c0 + SPAN, b * 128:(b + 1) * 128]
        GBs.append(GB)
    WV_all = np.concatenate(WVs, axis=0)    # (T*ntiles, TO, BAND)
    GB_flat = np.concatenate(GBs, axis=0)   # (T*nb, SPAN, 128)
    # dedupe identical blocks: a convolutional G (no resample) is
    # block-Toeplitz, so all interior blocks are one shared matrix
    uniq: dict = {}
    guids = []
    keep = []
    for blk in GB_flat:
        key = blk.tobytes()
        if key not in uniq:
            uniq[key] = len(keep)
            keep.append(blk)
        guids.append(uniq[key])
    return LinearPlan(WV_all, np.stack(keep), r0s, c0s, tuple(guids), ntiles,
                      Hout, Wout, mix.shape[0], OUT)


def fused_linear_pipeline(x: torch.Tensor, terms, C: int,
                          mix: Optional[np.ndarray] = None,
                          clip: bool = True, TO: int = 64,
                          in_shape: Optional[Tuple[int, int, int, int]] = None,
                          pad_align: bool = False,
                          plan_only: bool = False,
                          winc_pad: Optional[int] = None
                          ) -> Optional[torch.Tensor]:
    """General entry: out = clip( sum_t Mv_t @ x @ Mw_t^T , mixed ).

    `terms` is a list of (Mv, Mw) banded operator pairs — a rank-T sum of
    separable operators.  T=1 covers any composed chain of separable ops
    (resize, blur); T=2 covers unsharp/difference-of-gaussians-style
    chains that are sums of separable products.  All terms must share the
    same (Hout, Hin) x (Wout, Win) shapes.  Constraints as
    fused_resize_pipeline; returns None for a shape outside them.

    ``pad_align=True`` (NHWC input only) zero-pads the input to the
    kernel's alignment (rows to %8, flattened W*C to %128) and
    zero-extends the operators to ignore the pad.  ``winc_pad`` names a
    flat input whose rows carry trailing zero lanes beyond Win*C.
    ``plan_only=True`` checks the envelope and returns True without
    running (x may then be a tensor on the ``meta`` device).
    """
    if x.dtype != torch.float32:
        return None
    terms = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in terms]
    Hout, Hin = terms[0][0].shape
    Wout, Win = terms[0][1].shape
    if any(a.shape != (Hout, Hin) or b.shape != (Wout, Win)
           for a, b in terms):
        raise ValueError("all terms must share operator shapes")
    WINC = Win * C
    if winc_pad is not None:
        if winc_pad < WINC:
            return None
        WINC = winc_pad
    if x.dim() == 2:
        if in_shape is None:
            return None
        N = in_shape[0]
        if tuple(x.shape) != (N * Hin, WINC):
            return None
    elif x.dim() == 4:
        N = x.shape[0]
        if tuple(x.shape[1:]) != (Hin, Win, C):
            return None
        if pad_align and (WINC % 128 != 0 or Hin % 8 != 0):
            Hp = _align(Hin, 8)
            WINCp = _align(WINC, 128)
            if not plan_only:
                flat = F.pad(x.reshape(N, Hin, WINC),
                             (0, WINCp - WINC, 0, Hp - Hin))
                x = flat.reshape(N * Hp, WINCp)
            if Hp != Hin:
                terms = [(np.pad(a, ((0, 0), (0, Hp - Hin))), b)
                         for a, b in terms]
                Hin = Hp
            WINC = WINCp
    else:
        return None
    if WINC % 128 != 0 or Hin % 8 != 0:
        return None
    if plan_only:
        return True
    mix = np.asarray(np.eye(C) if mix is None else mix, np.float64)
    plan = linear_plan(terms, C, mix, TO, Hin, WINC)
    ops = plan_to_tensors(plan.WV, plan.GB, flat_r0(plan.r0s, N, Hin),
                          x.device)
    return run_plan(x.reshape(N * Hin, WINC).contiguous(), N, plan, ops,
                    clip)


@functools.lru_cache(maxsize=32)
def _resize_operands(N, Hin, Win, C, Hout, Wout, filt, sigma, mix_key, TO,
                     device):
    """Plan and device operands of one fused_resize_pipeline shape."""
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = _plan(
        Hin, Win, C, Hout, Wout, filt, sigma, mix_key, TO)
    plan = LinearPlan(WV, GB, r0s, c0s, tuple(range(len(c0s))), ntiles,
                      Hout, Wout, len(mix_key), OUT)
    return plan, plan_to_tensors(WV, GB, flat_r0(r0s, N, Hin), device)


def fused_resize_pipeline(x: torch.Tensor, Hout: int, Wout: int,
                          filt: str = "lanczos", sigma: float = 0.0,
                          mix: Optional[np.ndarray] = None,
                          clip: bool = True, TO: int = 64,
                          in_shape: Optional[Tuple[int, int, int, int]] = None
                          ) -> Optional[torch.Tensor]:
    """Fused resize [+ separable blur] [+ linear channel mix], one kernel.

    x: (N, Hin, Win, C) float32, or pre-flattened (N*Hin, Win*C) with
    ``in_shape=(N, Hin, Win, C)`` (the layout a decoder upload produces).
    Returns (N, Hout, Wout, Cout), or None when the shape is outside the
    kernel's envelope (lanes %128, rows %8, downscale only).  Plans and
    device operands are cached per shape and device.
    """
    if x.dtype != torch.float32:
        return None
    if x.dim() == 2:
        if in_shape is None:
            return None
        N, Hin, Win, C = in_shape
        if tuple(x.shape) != (N * Hin, Win * C):
            raise ValueError(f"flat input {tuple(x.shape)} != "
                             f"{(N * Hin, Win * C)}")
    elif x.dim() == 4:
        N, Hin, Win, C = x.shape
    else:
        return None
    WINC = Win * C
    if WINC % 128 != 0 or Hin % 8 != 0 or Hout < 1 or Wout < 1:
        return None
    if Hout > Hin or Wout > Win:      # upscales: dense path is fine
        return None
    mix = np.asarray(np.eye(C) if mix is None else mix, np.float64)
    mix_key = tuple(map(tuple, mix.tolist()))
    plan, ops = _resize_operands(N, Hin, Win, C, Hout, Wout, filt,
                                 float(sigma), mix_key, TO, x.device)
    return run_plan(x.reshape(N * Hin, WINC).contiguous(), N, plan, ops,
                    clip)


def reference_pipeline_f64(x: np.ndarray, Hout: int, Wout: int,
                           filt: str = "lanczos", sigma: float = 0.0,
                           mix: Optional[np.ndarray] = None,
                           clip: bool = True) -> np.ndarray:
    """float64 reference of the same fused math (for fidelity gating)."""
    N, Hin, Win, C = x.shape
    if mix is None:
        mix = np.eye(C)
    Mv = _axis_operator(Hin, Hout, filt, float(sigma))
    Mw = _axis_operator(Win, Wout, filt, float(sigma))
    y = np.einsum("oh,nhwc->nowc", Mv, np.asarray(x, np.float64))
    y = np.einsum("pw,nowc->nopc", Mw, y)
    y = np.einsum("dc,nopc->nopd", np.asarray(mix, np.float64), y)
    return np.clip(y, 0.0, 1.0) if clip else y


# ---------------------------------------------------------------------------
# Config #2: blur -> unsharp -> optional sRGB<->Lab, kernel K2
# ---------------------------------------------------------------------------

# K2's limits on a CUDA tensor (csrc/blur_unsharp.cu)
K2_MAX_BLUR_TAPS = 33
K2_MAX_UNSHARP_TAPS = 17
K2_MAX_CHANNELS = 8


@functools.lru_cache(maxsize=32)
def blur_unsharp_terms(n_v: int, n_w: int, sigma_blur: float,
                       sigma_unsharp: float, gain: float = 1.0):
    """Rank-2 term list for gaussian-blur -> unsharp (threshold 0).

    Unsharp is y + gain*(y - Bu(y)) = (1+gain)*y - gain*Bu(y); composed
    with the 2-D blur Bg this is the sum of two separable products
    (effect.c:4256 UnsharpMaskImage over GaussianBlurImage:1709):

        (1+gain) * (Bgv (x) Bgw)  -  gain * (Buv.Bgv (x) Buw.Bgw)

    The gain threshold (|2 diff| < t keeps the original) is a per-pixel
    nonlinearity and is NOT represented — callers wanting the reference's
    default t=0.05 behavior use the op-composition path.
    """
    Bgv = blur_band_matrix(n_v, sigma_blur)
    Bgw = blur_band_matrix(n_w, sigma_blur)
    Buv = blur_band_matrix(n_v, sigma_unsharp, width_rule="1d")
    Buw = blur_band_matrix(n_w, sigma_unsharp, width_rule="1d")
    return [((1.0 + gain) * Bgv, Bgw),
            (-gain * (Buv @ Bgv), Buw @ Bgw)]


def _middle_taps(B: np.ndarray) -> Tuple[float, ...]:
    """The non-zero run of a band operator's middle row (its pure taps
    when that row is clear of both borders)."""
    row = np.asarray(B[B.shape[0] // 2], np.float64)
    nz = np.nonzero(row)[0]
    return tuple(float(v) for v in row[nz[0]:nz[-1] + 1])


def _edge_stencil(n: int, taps: Sequence[float]) -> np.ndarray:
    """(n, n) operator of the odd stencil ``taps`` with edge-replicate
    pads, summed in blur_band_matrix's order (so equal bit for bit)."""
    j = len(taps) // 2
    rows = np.repeat(np.arange(n), len(taps))
    cols = np.clip(rows - j + np.tile(np.arange(len(taps)), n), 0, n - 1)
    B = np.zeros((n, n), np.float64)
    np.add.at(B, (rows, cols), np.tile(np.asarray(taps, np.float64), n))
    return B


@functools.lru_cache(maxsize=32)
def blur_unsharp_taps(H: int, W: int, sigma_blur: float,
                      sigma_unsharp: float
                      ) -> Optional[Tuple[Tuple[float, ...],
                                          Tuple[float, ...]]]:
    """(blur taps, unsharp taps) of config #2's kernel K2.

    Derived as the JAX planner derives them (``fused_blur_unsharp_pipeline``
    :1170-1235): the unsharp taps from the middle row of the 1-D-rule
    operator Buv (the same taps serve both axes), the blur taps from the
    middle row of Bgw (of Bgv when H > W).  Bgv and Bgw must each be the
    edge-replicating stencil of the blur taps, as the JAX planner's
    interior-Toeplitz check finds them whenever that row is clear of the
    borders; None for an image narrower than its blur on both axes.
    """
    Bgv = blur_band_matrix(H, sigma_blur)
    Bgw = blur_band_matrix(W, sigma_blur)
    Buv = blur_band_matrix(H, sigma_unsharp, width_rule="1d")
    blur = _middle_taps(Bgw if W >= H else Bgv)
    if len(blur) % 2 != 1 or any(
            not np.array_equal(B, _edge_stencil(B.shape[0], blur))
            for B in (Bgv, Bgw)):
        return None
    return blur, _middle_taps(Buv)


def _blur_unsharp_plain(x: torch.Tensor, blur_taps: Sequence[float],
                        unsharp_taps: Sequence[float], gain: float,
                        lab: bool) -> torch.Tensor:
    """K2's plain version: K3's plain blur twice, the unsharp mix, clip,
    then the colorspace module's sRGB->Lab->sRGB and clip."""
    from .colorspace import convert
    from .gpu_kernels import _separable_blur_plain

    z = _separable_blur_plain(x, blur_taps)
    u = _separable_blur_plain(z, unsharp_taps)
    y = ((1.0 + gain) * z - gain * u).clamp(0.0, 1.0)
    if lab:
        y = convert(convert(y, "srgb", "lab"), "lab", "srgb").clamp(0.0, 1.0)
    return y


def blur_unsharp_kernel(x: torch.Tensor, blur_taps: Sequence[float],
                        unsharp_taps: Sequence[float], gain: float,
                        lab: bool = False) -> torch.Tensor:
    """K2, the counterpart of the Pallas ``_kernel`` with the unsharp,
    h-stencil, column-chunk and Lab epilogues.

    x (N, H, W, C) float32; z = blur of x by the odd ``blur_taps`` along
    H and W, u = blur of z by the odd ``unsharp_taps``, both with
    edge-replicate borders; returns clip((1+gain) z - gain u), then with
    ``lab`` clip(lab_to_rgb(rgb_to_lab(.))).  On a CUDA tensor: C <= 8
    (C == 3 with ``lab``), at most 33 blur and 17 unsharp taps.
    """
    bt = tuple(float(t) for t in np.asarray(blur_taps, np.float32))
    ut = tuple(float(t) for t in np.asarray(unsharp_taps, np.float32))
    if not on_card(x):
        return _blur_unsharp_plain(x, bt, ut, float(gain), lab)
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("blur_unsharp_kernel takes a contiguous (N, H, W, "
                         f"C) float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    N, H, W, C = x.shape
    if (len(bt) % 2 != 1 or len(bt) > K2_MAX_BLUR_TAPS or
            len(ut) % 2 != 1 or len(ut) > K2_MAX_UNSHARP_TAPS or
            x.numel() == 0 or C > K2_MAX_CHANNELS or (lab and C != 3)):
        raise ValueError(f"blur_unsharp_kernel: {len(bt)} blur and "
                         f"{len(ut)} unsharp taps, lab={lab}, on "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    # on the host: the C entry copies them into the kernel's arguments
    taps = constant_on(bt + ut, torch.float32, torch.device("cpu"))
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k2_blur_unsharp(x.data_ptr(), y.data_ptr(),
                                  taps.data_ptr(), N, H, W, C, len(bt),
                                  len(ut), float(gain), int(lab),
                                  stream_of(x))
    _build.check(err, "k2_blur_unsharp")
    LAUNCHES["k2"] += 1
    return y


def _blur_unsharp_pipe_plain(x: torch.Tensor, blur_taps: Sequence[float],
                             unsharp_taps: Sequence[float], gain: float
                             ) -> torch.Tensor:
    """K2p's plain version: K2's with the Lab round trip, since the JAX
    ``_kernel_pipe`` computes the function of the sequential kernel."""
    return _blur_unsharp_plain(x, blur_taps, unsharp_taps, gain, True)


def blur_unsharp_pipe_kernel(x: torch.Tensor, blur_taps: Sequence[float],
                             unsharp_taps: Sequence[float], gain: float
                             ) -> torch.Tensor:
    """K2p, the counterpart of the Pallas ``_kernel_pipe``: K2's function
    with the Lab round trip, in a software-pipelined schedule.

    x (N, H, W, 3) float32; returns
    clip(lab_to_rgb(rgb_to_lab(clip((1+gain) z - gain u)))) for z and u as
    ``blur_unsharp_kernel`` computes them.  On a CUDA tensor: C == 3, at
    most 33 blur and 17 unsharp taps.
    """
    bt = tuple(float(t) for t in np.asarray(blur_taps, np.float32))
    ut = tuple(float(t) for t in np.asarray(unsharp_taps, np.float32))
    if not on_card(x):
        return _blur_unsharp_pipe_plain(x, bt, ut, float(gain))
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("blur_unsharp_pipe_kernel takes a contiguous (N, H, "
                         f"W, 3) float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    N, H, W, C = x.shape
    if (len(bt) % 2 != 1 or len(bt) > K2_MAX_BLUR_TAPS or
            len(ut) % 2 != 1 or len(ut) > K2_MAX_UNSHARP_TAPS or
            x.numel() == 0 or C != 3):
        raise ValueError(f"blur_unsharp_pipe_kernel: {len(bt)} blur and "
                         f"{len(ut)} unsharp taps on {tuple(x.shape)}")
    y = torch.empty_like(x)
    # on the host: the C entry copies them into the kernel's arguments
    taps = constant_on(bt + ut, torch.float32, torch.device("cpu"))
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k2p_blur_unsharp_pipe(x.data_ptr(), y.data_ptr(),
                                        taps.data_ptr(), N, H, W, len(bt),
                                        len(ut), float(gain), stream_of(x))
    _build.check(err, "k2p_blur_unsharp_pipe")
    LAUNCHES["k2p"] += 1
    return y


def fused_blur_unsharp_pipeline(x: torch.Tensor, sigma_blur: float,
                                sigma_unsharp: float, gain: float, C: int,
                                in_shape: Optional[Tuple[int, int, int,
                                                         int]] = None,
                                lab_roundtrip: bool = False,
                                pipelined: bool = False
                                ) -> Optional[torch.Tensor]:
    """Blur -> unsharp (threshold 0) [-> sRGB->Lab->sRGB], one launch of K2
    (of K2p with ``pipelined`` and ``lab_roundtrip``).

    ``-gaussian-blur 0x{sigma_blur}`` then ``-unsharp 0x{sigma_unsharp}``
    with ``gain`` and threshold 0, i.e. (1+g)·z − g·Bu(z) for z = Bg(x),
    clipped; with ``lab_roundtrip`` (C == 3) the result goes through
    sRGB->Lab->sRGB and is clipped again.  x: (N, H, W, C) float32, or
    the flat (N*H, W*C) layout with ``in_shape=(N, H, W, C)``.  Returns
    (N, H, W, C), or None wherever the JAX function does (not float32, a
    flat input without its shape or a channel mismatch, W*C % 128, H % 8,
    even unsharp taps or a radius of 0 or over 8, Lab with C != 3) and,
    beyond it, for a blur over 33 taps, more than 8 channels or an image
    narrower than its blur on both axes (ROADMAP.md Queue 2, "A capability
    gap, not a rank").
    ``pipelined=True`` is the counterpart of the JAX package's
    ``IMTPU_PIPE_KERNEL``: with ``lab_roundtrip`` the function runs kernel
    K2p, and without it, as in the JAX function, K2.
    """
    if x.dtype != torch.float32:
        return None
    if x.dim() == 2:
        if in_shape is None:
            return None
        N, Hin, Win, Cs = in_shape
        if Cs != C or tuple(x.shape) != (N * Hin, Win * C):
            return None
    elif x.dim() == 4:
        N, Hin, Win, Cs = x.shape
        if Cs != C:
            return None
    else:
        return None
    if (Win * C) % 128 != 0 or Hin % 8 != 0:
        return None
    taps = blur_unsharp_taps(Hin, Win, float(sigma_blur),
                             float(sigma_unsharp))
    if taps is None:
        return None
    blur, unsharp = taps
    r = len(unsharp) // 2
    if len(unsharp) % 2 != 1 or r == 0 or r > 8:
        return None
    if lab_roundtrip and C != 3:
        return None
    if len(blur) > K2_MAX_BLUR_TAPS or C > K2_MAX_CHANNELS:
        return None
    x = x.reshape(N, Hin, Win, C).contiguous()
    if pipelined and lab_roundtrip:
        return blur_unsharp_pipe_kernel(x, blur, unsharp, gain)
    return blur_unsharp_kernel(x, blur, unsharp, gain, lab_roundtrip)


def _lab_roundtrip_f64(x: np.ndarray) -> np.ndarray:
    """sRGB -> Lab -> sRGB in float64 on (..., 3), clipped
    (``benchmarks.py:315-341``)."""
    from .colorspace import CIE_EPSILON as eps, CIE_K as K, D65
    from .colorspace import _RGB2XYZ, _XYZ2RGB

    M = np.asarray(_RGB2XYZ, np.float64)
    Mi = np.asarray(_XYZ2RGB, np.float64)
    wp = np.asarray(D65, np.float64)
    lin = np.where(x <= 0.0404482362771076, x / 12.92,
                   ((x + 0.055) / 1.055) ** 2.4)
    r = (lin @ M.T) / wp
    fv = np.where(r > eps, np.cbrt(r), (K * r + 16) / 116)
    L = 116 * fv[..., 1] - 16
    a = 500 * (fv[..., 0] - fv[..., 1])
    b = 200 * (fv[..., 1] - fv[..., 2])
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200

    def finv(f):
        return np.where(f ** 3 > eps, f ** 3, (116 * f - 16) / K)

    Y = np.where(L > K * eps, fy ** 3, L / K)
    rgb = (np.stack([finv(fx), Y, finv(fz)], -1) * wp) @ Mi.T
    mn = rgb.min(-1, keepdims=True)
    rgb = np.where(mn < 0, rgb - mn, rgb)
    out = np.where(rgb <= 0.0031306684425005883, 12.92 * rgb,
                   1.055 * np.maximum(rgb, 1e-300) ** (1 / 2.4) - 0.055)
    return np.clip(out, 0.0, 1.0)


def reference_blur_unsharp_f64(x: np.ndarray, sigma_blur: float,
                               sigma_unsharp: float, gain: float = 1.0,
                               lab_roundtrip: bool = False) -> np.ndarray:
    """float64 reference of config #2 on an (N, H, W, C) batch (the
    fidelity check of ``benchmarks.py:299-343``): the rank-2 terms of
    ``blur_unsharp_terms`` as dense products, clip, then with
    ``lab_roundtrip`` sRGB->Lab->sRGB in float64 and clip."""
    x = np.asarray(x, np.float64)
    N, H, W, C = x.shape
    terms = blur_unsharp_terms(H, W, float(sigma_blur),
                               float(sigma_unsharp), float(gain))
    out = np.zeros_like(x)
    for n in range(N):
        for Av, Bw in terms:
            t = (Av @ x[n].reshape(H, W * C)).reshape(H, W, C)
            t = Bw @ t.transpose(1, 0, 2).reshape(W, H * C)
            out[n] += t.reshape(W, H, C).transpose(1, 0, 2)
    out = np.clip(out, 0.0, 1.0)
    return _lab_roundtrip_f64(out) if lab_roundtrip else out
