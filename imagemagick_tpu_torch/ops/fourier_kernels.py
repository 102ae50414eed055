"""The Wiener FFT of BASELINE config #4 as three hand-written CUDA kernels.

Counterpart of ``imagemagick_tpu/ops/fourier_pallas.py`` (its three Pallas
kernels, entered at ``wiener_pallas``).  For a stack of P real (H, W)
planes, each kernel computes in FP32 (``csrc/wiener_fft.cu``):

* K6a, ``w_forward``: the DFT along W of every row, (P, H, W) float32 ->
  (P, H, W) complex64.  A radix FFT over the plan ``_radix_plan(W)`` and
  one table of W roots (``_roots_on``; ``_twiddles_on`` holds its entries
  in the order the passes read them), two real rows packed into one
  complex transform and split by Hermitian symmetry.
* K6b, ``h_mask``: the DFT along H of every column, the Wiener mask
  ``p / (p + noise * pmean)`` with ``p = |F|^2`` and one ``pmean = sum(x^2)``
  per plane read from device memory, and the inverse DFT along H (/H):
  the same radix passes over ``_radix_plan(H)`` and the H roots, down a
  strip of neighbouring columns in shared memory, the mask between the
  two transforms.  The spectrum crosses device memory once each way.
* K6c, ``w_inverse``: the inverse DFT along W (/W), its real part, clipped
  to [0, 1], as the same radix FFT of two packed rows.

``wiener_kernel`` runs the three in turn.  The spectrum between them is
in natural frequency order (so is the TPU kernels', whatever the
docstring of ``fourier_pallas.py`` says), so each stage is held against
its plain version alone.  A wrapper runs its kernel's plain version only
for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
Each plain version follows its kernel's plan, root table and passes
(``_fft_rows``), K6a's and K6c's also its packing of two real rows.

``supported(H, W)``: both extents composite, as the JAX package's
four-step kernels need them, and at most ``MAX_EXTENT``: K6b holds two
buffers of a strip of whole columns in shared memory (four columns up to
H = 3418, two up to 6837, one above), K6a and K6c of one whole row.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .gpu_kernels import LAUNCHES, on_card, stream_of

# K6a and K6c hold two padded buffers of one complex row, 17 bytes per
# element, in shared memory (227 KB a block); K6b as much per element of
# its strip of columns
MAX_EXTENT = 8192
# the radices with a butterfly of their own in csrc/wiener_fft.cu, in the
# order a plan takes them; the kernels take at most MAX_PASSES passes
RADICES = (8, 4, 2, 3, 5, 7)
MAX_PASSES = 16


@functools.lru_cache(maxsize=64)
def _factor(n: int) -> Optional[Tuple[int, int]]:
    n1 = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            n1 = d
    return None if n1 == 1 else (n1, n // n1)


def _extent_ok(n: int) -> bool:
    return 4 <= n <= MAX_EXTENT and _factor(n) is not None


def supported(H: int, W: int) -> bool:
    """True when kernels K6a-K6c take (H, W) planes."""
    return _extent_ok(H) and _extent_ok(W)


@functools.lru_cache(maxsize=32)
def _radix_plan(n: int) -> Tuple[int, ...]:
    """The passes of the kernels' n-point FFT: radix 8 while it divides
    n, then 4 and 2, then 3, 5 and 7; each other prime factor, ascending,
    is one generic pass (4096 -> 8.8.8.8, 384 -> 8.8.2.3, 102 -> 2.3.17)."""
    plan = []
    for r in RADICES:
        while n % r == 0:
            plan.append(r)
            n //= r
    p = 11
    while n > 1:
        while n % p == 0:
            plan.append(p)
            n //= p
        p += 2
    return tuple(plan)


@functools.lru_cache(maxsize=16)
def _roots_on(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The n roots exp(-+2 pi i k / n) as (n, 2) float32 (cos, sin) on
    ``device``, computed in float64: every twiddle of the kernels' forward
    (K6a, K6b) or inverse (K6b, K6c) passes and every root of a generic
    pass."""
    a = (2.0 if inverse else -2.0) * np.pi * np.arange(n) / n
    roots = np.stack([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
    return torch.from_numpy(roots).to(device)


@functools.lru_cache(maxsize=16)
def _twiddles_on(n: int, inverse: bool,
                 device: torch.device) -> torch.Tensor:
    """The twiddles of the kernels' passes in the order they read them,
    as (T, 2) float32 entries of ``_roots_on(n, inverse, device)``: for
    each pass with a butterfly of its own after the first (radix r, after
    passes whose radices multiply to ns), root[t j0 n/(ns r)] at
    (t - 1) ns + j0 for 1 <= t < r, j0 < ns.  Neighbouring butterflies
    read neighbouring entries; a generic pass reads the roots."""
    idx = []
    ns = 1
    for r in _radix_plan(n):
        if r in RADICES and ns > 1:
            t = np.arange(1, r)[:, None]
            idx.append((t * np.arange(ns) * (n // (ns * r))).ravel())
        ns *= r
    idx.append(np.zeros(1, np.int64))   # so that no table is empty
    index = torch.from_numpy(np.concatenate(idx)).to(device)
    return _roots_on(n, inverse, device)[index].contiguous()


@functools.lru_cache(maxsize=16)
def _plan_on_host(n: int) -> torch.Tensor:
    """``_radix_plan(n)`` as a host int32 tensor, read by the C entry."""
    return torch.tensor(_radix_plan(n), dtype=torch.int32)


def _check_planes(x: torch.Tensor, dtype: torch.dtype, name: str,
                  rows_only: bool = False) -> None:
    """Raise unless ``x`` is contiguous (P, H, W) ``dtype`` that the kernel
    takes: both extents ``supported``, or only W for a row kernel."""
    if x.dim() != 3 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (P, H, W) {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    P, H, W = x.shape
    ok = _extent_ok(W) and H >= 1 if rows_only else supported(H, W)
    if P < 1 or not ok or P * max(H, W) >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} not supported")


def _fft_rows(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The unnormalised DFT (or inverse DFT) of each row of a (B, n)
    complex64 tensor, as the kernels' passes compute it in FP32.

    Stockham passes over ``_radix_plan(n)``: after passes whose radices
    multiply to ns, a pass of radix r takes butterfly j < n/r from
    v_q = z[j + q n/r], q < r, and puts output k at
    (j - j mod ns) r + j mod ns + k ns.  Output k is the sum over q of
    v_q root[(q e) mod n], e = (j mod ns) n/(ns r) + k n/r: the twiddle
    and the butterfly's root in one entry of ``_roots_on``.  The last
    pass leaves natural order.  The sum over q is a batched product, in
    chunks of at most 2**22 roots (a generic pass of a large prime)."""
    B, n = z.shape
    dev = z.device
    roots = torch.view_as_complex(_roots_on(n, inverse, dev))
    chunk = max(1, (1 << 22) // n)
    ns = 1
    for r in _radix_plan(n):
        m = n // r
        e = (torch.arange(m, device=dev) % ns) * (n // (ns * r)) + \
            torch.arange(r, device=dev)[:, None] * m
        v = z.reshape(B, r, m)
        acc = torch.zeros_like(v)
        for q0 in range(0, r, chunk):
            q = torch.arange(q0, min(q0 + chunk, r), device=dev)
            acc = acc + torch.einsum("bqm,qkm->bkm", v[:, q0:q0 + len(q)],
                                     roots[(q[:, None, None] * e) % n])
        z = acc.reshape(B, r, m // ns, ns).transpose(1, 2).reshape(B, n)
        ns *= r
    return z


def _row_pairs(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows 0, 2, 4, ... and 1, 3, 5, ... of (R, n) ``rows``; an odd R
    pairs the last row with zeros, as the kernels' last block does."""
    if rows.shape[0] % 2:
        rows = torch.cat([rows, torch.zeros_like(rows[:1])])
    return rows[0::2], rows[1::2]


def _mirror(z: torch.Tensor) -> torch.Tensor:
    """conj(z[(n - k) mod n]) along the last axis."""
    return torch.roll(z.flip(-1), 1, dims=-1).conj()


def _unpair(a: torch.Tensor, b: torch.Tensor, shape) -> torch.Tensor:
    """Rows a[0], b[0], a[1], b[1], ... cut to ``shape``."""
    P, H, W = shape
    return torch.stack([a, b], dim=1).reshape(-1, W)[:P * H].reshape(shape)


# -- K6a ----------------------------------------------------------------------

def _w_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """K6a's plain version: each pair of real rows as one complex row
    z = x_a + i x_b, Z = DFT(z) by ``_fft_rows``, then
    X_a = (Z + conj Z[-k]) / 2 and X_b = (Z - conj Z[-k]) / 2i, in FP32."""
    xa, xb = _row_pairs(x.reshape(-1, x.shape[-1]))
    Z = _fft_rows(torch.complex(xa, xb), inverse=False)
    Zm = _mirror(Z)
    return _unpair((Z + Zm) * 0.5, (Z - Zm) * -0.5j, x.shape)


def w_forward(x: torch.Tensor) -> torch.Tensor:
    """K6a: the DFT along W of (P, H, W) float32 planes, as complex64."""
    if not on_card(x):
        return _w_forward_plain(x)
    _check_planes(x, torch.float32, "w_forward", rows_only=True)
    P, H, W = x.shape
    spec = torch.empty((P, H, W), dtype=torch.complex64, device=x.device)
    roots = _roots_on(W, False, x.device)
    tw = _twiddles_on(W, False, x.device)
    plan = _plan_on_host(W)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k6a_w_forward(x.data_ptr(), spec.data_ptr(),
                                roots.data_ptr(), tw.data_ptr(),
                                plan.data_ptr(), P, H, W, plan.numel(),
                                stream_of(x))
    _build.check(err, "k6a_w_forward")
    LAUNCHES["k6a"] += 1
    return spec


# -- K6b ----------------------------------------------------------------------

def _h_mask_plain(spec: torch.Tensor, pmean: torch.Tensor,
                  noise: float) -> torch.Tensor:
    """K6b's plain version: each column's DFT by ``_fft_rows``, times the
    Wiener mask p / (p + noise * pmean), p = |F|^2, then its inverse DFT
    by ``_fft_rows``, times 1/H, in FP32."""
    P, H, W = spec.shape
    F = _fft_rows(spec.transpose(-1, -2).reshape(P * W, H), inverse=False)
    p = F.real * F.real + F.imag * F.imag
    floor = (noise * pmean.to(torch.float32)).repeat_interleave(W)[:, None]
    m = p / (p + floor)
    g = _fft_rows(torch.complex(F.real * m, F.imag * m), inverse=True)
    g = torch.complex(g.real * (1.0 / H), g.imag * (1.0 / H))
    return g.reshape(P, W, H).transpose(-1, -2).contiguous()


def h_mask(spec: torch.Tensor, pmean: torch.Tensor,
           noise: float) -> torch.Tensor:
    """K6b: DFT along H -> ``p / (p + noise * pmean)`` mask -> inverse DFT
    along H of (P, H, W) complex64 spectra; ``pmean`` is (P,) float32."""
    if not on_card(spec):
        return _h_mask_plain(spec, pmean, noise)
    _check_planes(spec, torch.complex64, "h_mask")
    P, H, W = spec.shape
    if (pmean.shape != (P,) or pmean.dtype != torch.float32 or
            pmean.device != spec.device):
        raise ValueError(f"h_mask: pmean {pmean.dtype} {tuple(pmean.shape)} "
                         f"on {pmean.device} for {P} planes")
    out = torch.empty_like(spec)
    roots_f = _roots_on(H, False, spec.device)
    tw_f = _twiddles_on(H, False, spec.device)
    roots_i = _roots_on(H, True, spec.device)
    tw_i = _twiddles_on(H, True, spec.device)
    plan = _plan_on_host(H)
    pmean = pmean.contiguous()
    lib = _build.load()
    with torch.cuda.device(spec.device):
        err = lib.k6b_h_mask(spec.data_ptr(), pmean.data_ptr(),
                             out.data_ptr(), roots_f.data_ptr(),
                             tw_f.data_ptr(), roots_i.data_ptr(),
                             tw_i.data_ptr(), plan.data_ptr(), P, H, W,
                             plan.numel(), float(noise), stream_of(spec))
    _build.check(err, "k6b_h_mask")
    LAUNCHES["k6b"] += 1
    return out


# -- K6c ----------------------------------------------------------------------

def _w_inverse_plain(g: torch.Tensor) -> torch.Tensor:
    """K6c's plain version: each pair of rows as one complex row
    Z = (h(g_a) + i h(g_b)) / W with h(g) = (g + conj g[-k]) / 2, so that
    IDFT(h(g)) = Re IDFT(g) for any g; z = IDFT(Z) by ``_fft_rows``, then
    clip(Re z) and clip(Im z) to [0, 1], in FP32."""
    W = g.shape[-1]
    ga, gb = _row_pairs(g.reshape(-1, W))
    Z = ((ga + _mirror(ga)) + (gb + _mirror(gb)) * 1j) * (0.5 / W)
    z = _fft_rows(Z, inverse=True)
    return torch.clamp(_unpair(z.real, z.imag, g.shape), 0.0, 1.0)


def w_inverse(g: torch.Tensor) -> torch.Tensor:
    """K6c: clip(Re(inverse DFT along W)) of (P, H, W) complex64 spectra,
    as float32."""
    if not on_card(g):
        return _w_inverse_plain(g)
    _check_planes(g, torch.complex64, "w_inverse", rows_only=True)
    P, H, W = g.shape
    out = torch.empty((P, H, W), dtype=torch.float32, device=g.device)
    roots = _roots_on(W, True, g.device)
    tw = _twiddles_on(W, True, g.device)
    plan = _plan_on_host(W)
    lib = _build.load()
    with torch.cuda.device(g.device):
        err = lib.k6c_w_inverse(g.data_ptr(), out.data_ptr(),
                                roots.data_ptr(), tw.data_ptr(),
                                plan.data_ptr(), P, H, W, plan.numel(),
                                stream_of(g))
    _build.check(err, "k6c_w_inverse")
    LAUNCHES["k6c"] += 1
    return out


def wiener_kernel(planes: torch.Tensor, noise: float) -> torch.Tensor:
    """The Wiener denoise of contiguous (P, H, W) float32 planes, one
    ``pmean = sum(x^2)`` each: K6a -> K6b -> K6c, clipped to [0, 1]."""
    pmean = torch.sum(planes * planes, dim=(-2, -1))
    return w_inverse(h_mask(w_forward(planes), pmean, noise))
