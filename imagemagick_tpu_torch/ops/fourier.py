"""Fourier-domain ops (fourier.c).

Port of ``imagemagick_tpu/ops/fourier.py``: ForwardFourierTransformImage
(fourier.c:913), InverseFourierTransformImage (:1504), ComplexImages
(:134) and the Wiener filter of BASELINE config #4.

Conventions follow the reference: forward yields a (magnitude, phase) image
pair by default (or (real, imaginary) with modulus=False), both fftshifted
to center DC, magnitude normalized by N, phase mapped to [0,1].

Three transform paths, chosen by ``set_fft_mode("fft"|"matmul"|"fourstep"|
"auto")``: ``torch.fft``; the dense DFT as two FP32 matrix products per
axis; and the four-step factored DFT (two small dense DFT products and a
twiddle per axis).  ``auto`` takes the four-step on a CUDA tensor, as the
JAX package does on its accelerator, and ``torch.fft`` on the CPU.  On a
CUDA tensor the four-step Wiener filter runs the hand-written kernels
K6a -> K6b -> K6c (``fourier_kernels.py``) for every shape they support.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

# -- FFT availability probe + mode selection --------------------------------

_FFT_MODE = "auto"           # "auto" | "fft" | "matmul" | "fourstep"
_FFT_OK: bool | None = None  # cached probe result


def set_fft_mode(mode: str) -> None:
    """Force the transform path: "fft", "matmul", "fourstep", or "auto"
    (auto = the four-step on a CUDA tensor, ``torch.fft`` on the CPU)."""
    global _FFT_MODE
    if mode not in ("auto", "fft", "matmul", "fourstep"):
        raise ValueError(f"bad fft mode {mode!r}")
    _FFT_MODE = mode


def probe_fft(recheck: bool = False) -> bool:
    """True when ``torch.fft`` runs on the CPU (tiny probe, cached)."""
    global _FFT_OK
    if _FFT_OK is None or recheck:
        try:
            v = float(torch.abs(torch.sum(torch.fft.fft(torch.arange(8.0)))))
            _FFT_OK = bool(np.isfinite(v))
        except RuntimeError:
            _FFT_OK = False
    return _FFT_OK


def _resolve_mode(device: torch.device) -> str:
    """The transform path for a tensor on ``device``: "fft" | "matmul" |
    "fourstep"."""
    if _FFT_MODE != "auto":
        return _FFT_MODE
    if device.type == "cuda":
        return "fourstep"
    return "fft" if probe_fft() else "fourstep"


# -- matmul DFT ---------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _dft_mats_np(n: int, inverse: bool):
    """Symmetric n-point DFT matrix as (cos, sin) f32 numpy parts."""
    k = np.arange(n, dtype=np.float64)
    ang = (2.0 if inverse else -2.0) * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int, inverse: bool, device: torch.device):
    c, s = _dft_mats_np(n, inverse)
    return torch.from_numpy(c).to(device), torch.from_numpy(s).to(device)


def _matmul_fft2(xr, xi, inverse: bool = False):
    """Exact 2-D DFT as row and column products in FP32."""
    H, W = xr.shape[-2:]
    Ch, Sh = _dft_mats(H, inverse, xr.device)
    Cw, Sw = _dft_mats(W, inverse, xr.device)
    yr = Ch @ xr - Sh @ xi
    yi = Ch @ xi + Sh @ xr
    zr = yr @ Cw - yi @ Sw     # the DFT matrix is symmetric: F^T = F
    zi = yr @ Sw + yi @ Cw
    if inverse:
        s = 1.0 / float(H * W)
        zr, zi = zr * s, zi * s
    return zr, zi


# -- four-step factored DFT ---------------------------------------------------
#
# N = N1*N2 turns each 1-D transform into two dense DFT products (N1- and
# N2-point) and one elementwise twiddle:
#
#   X[k2*N1+k1] = sum_{n2} W_N^{n2 k1} W_{N2}^{n2 k2}
#                   (sum_{n1} x[n1*N2+n2] W_{N1}^{n1 k1})

@functools.lru_cache(maxsize=16)
def _fourstep_consts(n: int, inverse: bool):
    """(n1, n2, C1, S1, C2, S2, Tc, Ts) for the N=n1*n2 factorization;
    None for a prime n."""
    n1 = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            n1 = d
    # n1 = largest divisor <= sqrt(n); prime n -> n1 == 1 (caller falls
    # back to the dense DFT)
    if n1 == 1:
        return None
    n2 = n // n1
    sign = 2.0 if inverse else -2.0
    k1 = np.arange(n1, dtype=np.float64)
    k2 = np.arange(n2, dtype=np.float64)
    a1 = sign * np.pi * np.outer(k1, k1) / n1
    a2 = sign * np.pi * np.outer(k2, k2) / n2
    tw = sign * np.pi * np.outer(k1, k2) / n      # (k1, n2) twiddles
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return (n1, n2, f32(np.cos(a1)), f32(np.sin(a1)),
            f32(np.cos(a2)), f32(np.sin(a2)),
            f32(np.cos(tw)), f32(np.sin(tw)))


@functools.lru_cache(maxsize=16)
def _fourstep_tensors(n: int, inverse: bool, device: torch.device):
    n1, n2, *mats = _fourstep_consts(n, inverse)
    return (n1, n2, *(torch.from_numpy(m).to(device) for m in mats))


def _fourstep_axis(xr, xi, inverse: bool):
    """Length-N DFT along the LAST axis via the four-step factorization.
    xr/xi: (..., N) f32 (xi may be None for real input).  Returns (re, im).
    """
    n = xr.shape[-1]
    if _fourstep_consts(n, inverse) is None:
        C, S = _dft_mats(n, inverse, xr.device)
        if xi is None:
            zr, zi = xr @ C, xr @ S
        else:
            zr = xr @ C - xi @ S
            zi = xr @ S + xi @ C
        if inverse:
            zr, zi = zr / n, zi / n
        return zr, zi
    n1, n2, C1, S1, C2, S2, Tc, Ts = _fourstep_tensors(n, inverse,
                                                       xr.device)
    shp = xr.shape[:-1]
    a = xr.reshape(shp + (n1, n2))
    if xi is None:
        yr = C1 @ a
        yi = S1 @ a
    else:
        b = xi.reshape(shp + (n1, n2))
        yr = C1 @ a - S1 @ b
        yi = S1 @ a + C1 @ b
    zr = yr * Tc - yi * Ts
    zi = yr * Ts + yi * Tc
    outr = zr @ C2 - zi @ S2
    outi = zr @ S2 + zi @ C2
    # output index k = k2*n1 + k1 -> transpose the (k1, k2) grid
    outr = outr.transpose(-1, -2).reshape(shp + (n,))
    outi = outi.transpose(-1, -2).reshape(shp + (n,))
    if inverse:
        outr, outi = outr / n, outi / n
    return outr, outi


def _fourstep_fft2(xr, xi, inverse: bool = False):
    """2-D DFT over the last two axes via two four-step passes."""
    zr, zi = _fourstep_axis(xr, xi, inverse)
    zr, zi = _fourstep_axis(zr.transpose(-1, -2), zi.transpose(-1, -2),
                            inverse)
    return zr.transpose(-1, -2), zi.transpose(-1, -2)


def _fft2(x):
    """fft2 via the selected path.  x: complex or real."""
    mode = _resolve_mode(x.device)
    if mode == "fft":
        return torch.fft.fft2(x.to(torch.complex64))
    if x.is_complex():
        xr, xi = x.real.float(), x.imag.float()
    else:
        xr, xi = x.float(), None
    if mode == "fourstep":
        zr, zi = _fourstep_fft2(xr, xi, inverse=False)
    else:
        zr, zi = _matmul_fft2(xr, torch.zeros_like(xr) if xi is None else xi,
                              inverse=False)
    return torch.complex(zr, zi)


def _ifft2(f):
    """ifft2 via the selected path.  f: complex."""
    mode = _resolve_mode(f.device)
    if mode == "fft":
        return torch.fft.ifft2(f)
    fr, fi = f.real.float(), f.imag.float()
    if mode == "fourstep":
        zr, zi = _fourstep_fft2(fr, fi, inverse=True)
    else:
        zr, zi = _matmul_fft2(fr, fi, inverse=True)
    return torch.complex(zr, zi)


# -- the ops ----------------------------------------------------------------

def forward_fft(img: torch.Tensor, modulus: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ForwardFourierTransformImage (fourier.c:913).

    Returns (magnitude, phase) images — per channel, DC centered.  The
    reference pads to square even dimensions; this keeps the input shape
    (callers can pad) and normalizes magnitude by the pixel count.
    """
    h, w = img.shape[-3], img.shape[-2]
    x = torch.movedim(img, -1, 0)  # (C, ..., H, W)
    f = torch.fft.fftshift(_fft2(x), dim=(-2, -1))
    n = float(h * w)
    if modulus:
        mag = torch.abs(f) / n
        phase = torch.angle(f) / (2.0 * math.pi) + 0.5  # [0,1]
        return (torch.movedim(mag, 0, -1).to(img.dtype),
                torch.movedim(phase, 0, -1).to(img.dtype))
    return (torch.movedim(f.real / n, 0, -1).to(img.dtype),
            torch.movedim(f.imag / n, 0, -1).to(img.dtype))


def inverse_fft(first: torch.Tensor, second: torch.Tensor,
                modulus: bool = True) -> torch.Tensor:
    """InverseFourierTransformImage (fourier.c:1504)."""
    h, w = first.shape[-3], first.shape[-2]
    n = float(h * w)
    a = torch.movedim(first, -1, 0).float() * n
    b = torch.movedim(second, -1, 0).float()
    if modulus:
        # torch.polar, not torch.cos: on the CPU, torch.cos of a float32
        # tensor comes out to about 12 bits in some processes (about 1 in
        # 100 in one measurement), torch.polar to full precision in all
        f = torch.polar(a, (b - 0.5) * (2.0 * math.pi))
    else:
        f = torch.complex(a, b * n)
    f = torch.fft.ifftshift(f, dim=(-2, -1))
    x = _ifft2(f).real
    return torch.clamp(torch.movedim(x, 0, -1), 0.0, 1.0).to(first.dtype)


def complex_images(a_real: torch.Tensor, a_imag: torch.Tensor,
                   b_real: torch.Tensor, b_imag: torch.Tensor,
                   operator: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """ComplexImages (fourier.c:134): arithmetic on image pairs as complexes."""
    op = operator.lower().replace("-", "")
    ar, ai, br, bi = a_real, a_imag, b_real, b_imag
    if op == "add":
        return ar + br, ai + bi
    if op == "subtract":
        return ar - br, ai - bi
    if op == "multiply":
        return ar * br - ai * bi, ar * bi + ai * br
    if op == "divide":
        d = br * br + bi * bi
        d = torch.where(d < 1e-20, torch.full_like(d, 1e-20), d)
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d
    if op == "magnitudephase":
        return (torch.sqrt((ar * ar + ai * ai).double()).float(),
                torch.atan2(ai, ar) / (2 * math.pi) + 0.5)
    if op == "realimaginary":
        f = torch.polar(ar, (ai - 0.5) * 2.0 * math.pi)   # see inverse_fft
        return f.real, f.imag
    if op == "conjugate":
        return ar, -ai
    raise ValueError(f"unknown complex operator {operator!r}")


def wiener_deconvolve(img: torch.Tensor, kernel_fft: torch.Tensor = None,
                      noise: float = 0.01) -> torch.Tensor:
    """Wiener-style frequency-domain filter (BASELINE config #4 pipeline).

    With no kernel, acts as a Wiener denoiser: F' = F·|F|²/(|F|²+noise·Σx²)
    on each channel of an (H, W, C) image or an (N, H, W, C) batch.
    """
    from . import fourier_kernels as fk

    x = torch.movedim(img, -1, 0)
    mode = _resolve_mode(x.device)
    H, W = x.shape[-2:]
    if kernel_fft is None and mode == "fourstep" and \
            x.device.type == "cuda" and fk.supported(H, W):
        # kernels K6a -> K6b -> K6c on every (channel, image) plane
        planes = x.reshape(-1, H, W).float().contiguous()
        out = fk.wiener_kernel(planes, noise).reshape(x.shape)
        return torch.movedim(out, 0, -1).to(img.dtype)
    # noise scale = spectral mean power; by Parseval mean|F|^2 over the
    # FULL spectrum == sum(x^2), which keeps the filter identical across
    # the rfft2 half-spectrum, fft2, and matmul-DFT paths
    pmean = torch.sum(x.float() ** 2, dim=(-2, -1), keepdim=True)
    if kernel_fft is None and mode == "fourstep":
        # all-real formulation: forward with xi=None, spectral mask on the
        # (re, im) parts, inverse real part only
        fr, fi = _fourstep_fft2(x.float(), None, inverse=False)
        p = fr * fr + fi * fi
        m = p / (p + noise * pmean)
        out, _ = _fourstep_fft2(fr * m, fi * m, inverse=True)
    elif kernel_fft is None and mode == "fft" and H % 2 == 0 and W % 2 == 0:
        # real input: rfft2 computes only the non-redundant half-spectrum
        f = torch.fft.rfft2(x.float())
        p = (f * torch.conj(f)).real
        g = f * (p / (p + noise * pmean))
        out = torch.fft.irfft2(g, s=(H, W))
    elif kernel_fft is None:
        f = _fft2(x)
        p = (f * torch.conj(f)).real
        g = f * (p / (p + noise * pmean))
        out = _ifft2(g).real
    else:
        f = _fft2(x)
        k = kernel_fft
        kp = (k * torch.conj(k)).real
        g = f * torch.conj(k) / (kp + noise)
        out = _ifft2(g).real
    return torch.clamp(torch.movedim(out, 0, -1), 0.0, 1.0).to(img.dtype)
