"""The Wiener FFT of BASELINE config #4 as three hand-written CUDA kernels.

Counterpart of ``imagemagick_tpu/ops/fourier_pallas.py`` (its three Pallas
kernels, entered at ``wiener_pallas``).  For a stack of P real (H, W)
planes, each kernel computes in FP32, as a four-step DFT per axis
(N = n1*n2, two dense sub-DFTs and a twiddle, natural order in and out):

* K6a, ``w_forward`` (``csrc/wiener_fft.cu``): the DFT along W of every
  row, (P, H, W) float32 -> (P, H, W) complex64.
* K6b, ``h_mask``: the DFT along H of every column, the Wiener mask
  ``p / (p + noise * pmean)`` with ``p = |F|^2`` and one ``pmean = sum(x^2)``
  per plane read from device memory, and the inverse DFT along H (/H).
  The spectrum crosses device memory three times, not five.
* K6c, ``w_inverse``: the inverse DFT along W (/W), its real part, clipped
  to [0, 1].

``wiener_kernel`` runs the three in turn.  The spectrum between them is
in natural frequency order (so is the TPU kernels', whatever the
docstring of ``fourier_pallas.py`` says), so each stage is held against
its plain version alone.  A wrapper runs its kernel's plain version (the
port's torch four-step, ``fourier._fourstep_axis``) only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.

``supported(H, W)``: both extents composite (a four-step factorization
exists) and at most ``MAX_EXTENT``: K6b holds one or two whole columns
of the spectrum in shared memory, K6a and K6c one whole row.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .gpu_kernels import LAUNCHES, on_card, stream_of

# K6c holds a row and its stage-one output, about 16 bytes per element, in
# shared memory (227 KB a block); K6b as much per column element, for two
# columns up to H = K6B_TWO_COLUMNS and one column above
MAX_EXTENT = 8192
K6B_TWO_COLUMNS = 4096


def _factor(n: int) -> Optional[Tuple[int, int]]:
    n1 = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            n1 = d
    return None if n1 == 1 else (n1, n // n1)


@functools.lru_cache(maxsize=8)
def _axis_consts(n: int, inverse: bool):
    """(n1, n2, C1, S1, C2, S2, Tc, Ts) numpy f32 for one axis; the
    twiddle is indexed (n2, k1)."""
    f = _factor(n)
    if f is None:
        return None
    n1, n2 = f
    sign = 2.0 if inverse else -2.0
    k1 = np.arange(n1, dtype=np.float64)
    k2 = np.arange(n2, dtype=np.float64)
    a1 = sign * np.pi * np.outer(k1, k1) / n1
    a2 = sign * np.pi * np.outer(k2, k2) / n2
    tw = sign * np.pi * np.outer(k2, k1) / n
    f32 = lambda a: np.asarray(a, np.float32)       # noqa: E731
    return (n1, n2, f32(np.cos(a1)), f32(np.sin(a1)),
            f32(np.cos(a2)), f32(np.sin(a2)),
            f32(np.cos(tw)), f32(np.sin(tw)))


def supported(H: int, W: int) -> bool:
    """True when kernels K6a-K6c take (H, W) planes."""
    return (4 <= H <= MAX_EXTENT and 4 <= W <= MAX_EXTENT
            and _factor(H) is not None and _factor(W) is not None)


@functools.lru_cache(maxsize=16)
def _table_on(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """One axis's tables as (n1 + n2 + n, 2) float32 (cos, sin) on
    ``device``, taken from ``_axis_consts``: the n1 roots of the first
    sub-DFT (row 1 of C1, S1; entry (k, m) is root (k*m) mod n1), the n2
    roots of the second, and the twiddle field flattened as n2*n1 + k1."""
    n1, n2, C1, S1, C2, S2, Tc, Ts = _axis_consts(n, inverse)
    cos = np.concatenate([C1[1], C2[1], Tc.ravel()])
    sin = np.concatenate([S1[1], S2[1], Ts.ravel()])
    return torch.from_numpy(np.stack([cos, sin], axis=1)).to(device)


def _check_planes(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.dim() != 3 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (P, H, W) {dtype} "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    P, H, W = x.shape
    if P < 1 or not supported(H, W) or P * max(H, W) >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} not supported")


# -- K6a ----------------------------------------------------------------------

def _w_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """K6a's plain version: the four-step DFT along W in FP32."""
    from .fourier import _fourstep_axis

    return torch.complex(*_fourstep_axis(x, None, inverse=False))


def w_forward(x: torch.Tensor) -> torch.Tensor:
    """K6a: the DFT along W of (P, H, W) float32 planes, as complex64."""
    if not on_card(x):
        return _w_forward_plain(x)
    _check_planes(x, torch.float32, "w_forward")
    P, H, W = x.shape
    n1, n2 = _factor(W)
    spec = torch.empty((P, H, W), dtype=torch.complex64, device=x.device)
    tab = _table_on(W, False, x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k6a_w_forward(x.data_ptr(), spec.data_ptr(),
                                tab.data_ptr(), P, H, W, n1, n2,
                                stream_of(x))
    _build.check(err, "k6a_w_forward")
    LAUNCHES["k6a"] += 1
    return spec


# -- K6b ----------------------------------------------------------------------

def _h_mask_plain(spec: torch.Tensor, pmean: torch.Tensor,
                  noise: float) -> torch.Tensor:
    """K6b's plain version: the four-step DFT along H, the Wiener mask,
    the inverse four-step along H, in FP32."""
    from .fourier import _fourstep_axis

    fr, fi = _fourstep_axis(spec.real.transpose(-1, -2),
                            spec.imag.transpose(-1, -2), inverse=False)
    p = fr * fr + fi * fi
    m = p / (p + noise * pmean.reshape(-1, 1, 1))
    gr, gi = _fourstep_axis(fr * m, fi * m, inverse=True)
    return torch.complex(gr.transpose(-1, -2),
                         gi.transpose(-1, -2)).contiguous()


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
    n1, n2 = _factor(H)
    cols = 2 if H <= K6B_TWO_COLUMNS else 1
    out = torch.empty_like(spec)
    tab_f = _table_on(H, False, spec.device)
    tab_i = _table_on(H, True, spec.device)
    pmean = pmean.contiguous()
    lib = _build.load()
    with torch.cuda.device(spec.device):
        err = lib.k6b_h_mask(spec.data_ptr(), pmean.data_ptr(),
                             out.data_ptr(), tab_f.data_ptr(),
                             tab_i.data_ptr(), P, H, W, n1, n2, cols,
                             float(noise), stream_of(spec))
    _build.check(err, "k6b_h_mask")
    LAUNCHES["k6b"] += 1
    return out


# -- K6c ----------------------------------------------------------------------

def _w_inverse_plain(g: torch.Tensor) -> torch.Tensor:
    """K6c's plain version: the inverse four-step DFT along W in FP32,
    its real part clipped to [0, 1]."""
    from .fourier import _fourstep_axis

    out, _ = _fourstep_axis(g.real, g.imag, inverse=True)
    return torch.clamp(out, 0.0, 1.0)


def w_inverse(g: torch.Tensor) -> torch.Tensor:
    """K6c: clip(Re(inverse DFT along W)) of (P, H, W) complex64 spectra,
    as float32."""
    if not on_card(g):
        return _w_inverse_plain(g)
    _check_planes(g, torch.complex64, "w_inverse")
    P, H, W = g.shape
    n1, n2 = _factor(W)
    out = torch.empty((P, H, W), dtype=torch.float32, device=g.device)
    tab = _table_on(W, True, g.device)
    lib = _build.load()
    with torch.cuda.device(g.device):
        err = lib.k6c_w_inverse(g.data_ptr(), out.data_ptr(), tab.data_ptr(),
                                P, H, W, n1, n2, stream_of(g))
    _build.check(err, "k6c_w_inverse")
    LAUNCHES["k6c"] += 1
    return out


def wiener_kernel(planes: torch.Tensor, noise: float) -> torch.Tensor:
    """The Wiener denoise of contiguous (P, H, W) float32 planes, one
    ``pmean = sum(x^2)`` each: K6a -> K6b -> K6c, clipped to [0, 1]."""
    pmean = torch.sum(planes * planes, dim=(-2, -1))
    return w_inverse(h_mask(w_forward(planes), pmean, noise))
