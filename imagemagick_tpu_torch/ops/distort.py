"""Distortions: inverse-mapped warps (distort.c / resample.c).

Port of ``imagemagick_tpu/ops/distort.py``, the whole module: the
samplers (bilinear, the clamped Gaussian ``sample_ewa`` and the
reference EWA of resample.c with a constant or a per-pixel Jacobian),
``warp``, ``rotate``, the affine transforms, ``distort`` with every
method of DistortImage (distort.c:1754), ``sparse_color``,
``liquid_rescale`` and the visual effects ``swirl``, ``implode`` and
``wave``.  Every distortion is an inverse map from output (i, j) to
source (u, v), evaluated as a dense grid, and a gather with bilinear or
EWA sampling on the image's device.

Geometry that depends only on the arguments and the shapes — control
point fits, the per-pixel ellipses of ``sample_ewa_reference_var`` and
the polar family's maps — is worked out on the host in float64 numpy,
exactly as the JAX module does, so its tables equal the JAX ones bit for
bit; they go to the device once per call (once per EWA bucket).  Pixels
never leave the device.  Float32 expressions keep the JAX order of
operations, and a division by a host scalar that feeds a floor or a
selection divides by a device scalar (``_div``): CUDA divides by a host
scalar through its reciprocal, an ulp off the CPU's and XLA's quotient.
The effects' square roots, sines, cosines and powers run in float64 and
round to float32 (``_f64``), so the card and the CPU take the same
coordinates.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# elements of one block of gathered taps in the per-pixel EWA scan
# (batch x pixels x scanlines x taps x channels: 128 MiB of float32)
_EWA_BLOCK = 1 << 25


def _grid(h, w, dtype=torch.float32, device=None):
    yy = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return yy, xx


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` for a host scalar ``s`` as a true division on every
    device: CUDA divides by a host scalar through its reciprocal."""
    return t / torch.full((), s, dtype=t.dtype, device=t.device)


def _f64(fn, *args) -> torch.Tensor:
    """A float32 square root or transcendental evaluated in float64 and
    rounded to float32.  The card's and the CPU's float32 ``sinf``,
    ``cosf`` and ``powf`` differ by an ulp, and PyTorch's CPU float32
    ``sqrt`` is not correctly rounded (an ulp off on about one value in
    eight of a 1080p map); a displacement of hundreds of pixels turns an
    ulp into 1e-4 under a bilinear blend.  The float64 results round to
    the same float32 on both, the correctly rounded one for ``sqrt``."""
    return fn(*[a.to(torch.float64) if isinstance(a, torch.Tensor) else a
                for a in args]).to(args[0].dtype)


def _index(t: torch.Tensor) -> torch.Tensor:
    """Integer-valued float coordinates as int64 (a truncation, as the
    JAX ``astype(int32)``), saturated inside int32's range."""
    return t.clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)


def _premult_sample(img: torch.Tensor, background, run):
    """Alpha-premultiplied resampling wrapper (resample.c alpha blend):
    colors are weighted by alpha during interpolation and un-premultiplied
    by the interpolated alpha.  `run(pm_img, pm_background)` does the
    actual sampling; no-op for images without alpha."""
    c = img.shape[-1]
    if c not in (2, 4):
        return run(img, background)
    a = img[..., -1:]
    pm = torch.cat([img[..., :-1] * a, a], -1)
    bg = None
    if background is not None:
        bl = list(background)[:c]
        while len(bl) < c:
            bl.append(1.0)
        bg = tuple(x * bl[-1] for x in bl[:-1]) + (bl[-1],)
    out = run(pm, bg)
    al = out[..., -1:]
    col = out[..., :-1] / torch.where(al.abs() < 1e-12, 1.0, al)
    return torch.cat([col, al], -1)


def _make_tap(img: torch.Tensor,
              background: Optional[Sequence[float]] = None,
              vp: str = "edge"):
    """Build a tap(yi, xi) gather honoring the virtual-pixel policy.

    vp='edge' with a background keeps the constant fill outside the
    canvas; any other vp routes through core.virtual_pixel's coordinate
    remapping (cache.c:2928-3066), with vp_constant supplying the fill for
    constant/tile-fill methods.

    Coordinates of shape (H', W') read every image of a batch at the same
    points, as the JAX ``jnp.take`` does; coordinates with the image's
    leading axes read each image at its own points (the JAX function
    raises there: its ``take`` crosses the two batches)."""
    from ..core.virtual_pixel import vp_constant, vp_tap

    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    img2 = img.reshape(lead + (h * w, c))

    def gather(idx: torch.Tensor) -> torch.Tensor:
        if idx.dim() > 2 and lead:
            idx = idx.expand(lead + idx.shape[-2:])
            flat = idx.reshape(lead + (-1, 1)).expand(lead + (-1, c))
            return torch.gather(img2, -2, flat).reshape(idx.shape + (c,))
        return img2.index_select(-2, idx.reshape(-1)).reshape(
            lead + idx.shape + (c,))

    m = (vp or "edge").lower()
    if m in ("edge", "undefined", ""):
        def clamped(yi, xi):
            return gather(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))

        if background is None:
            return clamped
        bg = torch.tensor(tuple(background)[:c], dtype=img.dtype,
                          device=img.device)

        def tap(yi, xi):
            valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
            return torch.where(valid, clamped(yi, xi), bg)
        return tap
    const = vp_constant(m, background, c)
    bg = None if const is None else torch.tensor(const, dtype=img.dtype,
                                                 device=img.device)

    def tap(yi, xi):
        yc, xc, mask = vp_tap(yi, xi, h, w, m)
        px = gather(yc * w + xc)
        if mask is not None and bg is not None:
            px = torch.where(mask[..., None], bg, px)
        return px
    return tap


def sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    background: Optional[Sequence[float]] = None,
                    vp: str = "edge") -> torch.Tensor:
    """Bilinear lookup of (..., H, W, C) at fractional coords (u=x, v=y).

    Off-canvas taps contribute the policy's color INSIDE the bilinear
    blend, like the reference's InterpolatePixelChannels over a
    virtual-pixel cache view.
    """
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.to(torch.int32).to(torch.int64)
    y0i = y0.to(torch.int32).to(torch.int64)
    tap = _make_tap(img, background, vp)
    p00 = tap(y0i, x0i)
    p01 = tap(y0i, x0i + 1)
    p10 = tap(y0i + 1, x0i)
    p11 = tap(y0i + 1, x0i + 1)
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy


def warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
         background: Optional[Sequence[float]] = None,
         sampler: str = "bilinear",
         jac: Optional[Tuple[float, float, float, float]] = None,
         vp: str = "edge") -> torch.Tensor:
    if sampler == "ewa":
        if jac is not None:
            return sample_ewa_reference(img, u, v, jac, background, vp)
        return sample_ewa(img, u, v, background)
    return sample_bilinear(img, u, v, background, vp)


_ROBIDOUX_LUT = None
_LUT_ON = {}


def _robidoux_lut(device=None) -> torch.Tensor:
    """resample.c:1289 filter LUT: 1024 weights of the default cylindrical
    filter (Robidoux Keys cubic, resample.c:1262) sampled at
    r = support*sqrt(Q/1024), support 2; float64 numpy rounded to
    float32, one copy per device."""
    global _ROBIDOUX_LUT
    if _ROBIDOUX_LUT is None:
        b = 12.0 / (19.0 + 9.0 * math.sqrt(2.0))
        c = 113.0 / (58.0 + 216.0 * math.sqrt(2.0))
        # CubicBC coefficients (resize.c CubicBC)
        p0 = (6.0 - 2.0 * b) / 6.0
        p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
        p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
        q0 = (8.0 * b + 24.0 * c) / 6.0
        q1 = (-12.0 * b - 48.0 * c) / 6.0
        q2 = (6.0 * b + 30.0 * c) / 6.0
        q3 = (-b - 6.0 * c) / 6.0
        r = 2.0 * np.sqrt(np.arange(1024, dtype=np.float64) / 1024.0)
        w = np.where(r < 1.0, p0 + r * r * (p2 + r * p3),
                     np.where(r < 2.0, q0 + r * (q1 + r * (q2 + r * q3)), 0.0))
        _ROBIDOUX_LUT = w.astype(np.float32)
    key = torch.device(device or "cpu")
    if key not in _LUT_ON:
        _LUT_ON[key] = torch.from_numpy(_ROBIDOUX_LUT).to(key)
    return _LUT_ON[key]


def _ewa_weight(Q: torch.Tensor, lut: torch.Tensor,
                vmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The LUT weight of each tap's ellipse value Q, 0 outside the filter.

    The JAX code keeps a tap when ``0 <= int32(Q) < 1024``: a truncation,
    so every Q in (-1, 0) reads bin 0.  A float->int cast of an
    out-of-range value is undefined in PyTorch (INT_MIN on the CPU,
    saturated or 0 on CUDA), so the mask comes from Q itself and only
    the values it admits are cast: ``-1 < Q < 1024`` is the set that the
    JAX mask admits."""
    keep = (Q > -1.0) & (Q < 1024.0)
    if vmask is not None:
        keep = keep & vmask
    qi = torch.where(keep, Q, 0.0).to(torch.int64)
    return torch.where(keep, lut[qi], 0.0)


def sample_ewa_reference(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         jac: Tuple[float, float, float, float],
                         background: Optional[Sequence[float]] = None,
                         vp: str = "edge") -> torch.Tensor:
    """Reference-exact EWA resampling for a CONSTANT Jacobian.

    Replicates resample.c: ClampUpAxes (clamped-EWA per Robidoux,
    resample.c:1100) on jac = (du/dx, du/dy, dv/dx, dv/dy), ellipse
    Q = A·U²+B·UV+C·V² < F with F scaled by support², weights from the
    1024-entry Robidoux LUT via (int)Q indexing (resample.c:600), taps on
    the scanline parallelogram v∈[ceil(v0-Vlimit), floor(v0+Vlimit)],
    u from ceil(u0+(v-v0)·slope−Uwidth), uw = (int)(2·Uwidth)+1.
    Off-canvas taps read background virtual pixels (or edge-clamp when
    background is None); an empty hit set falls back to bilinear.  The
    taps run one after another in the JAX order, each over the whole
    grid."""
    J = np.asarray(jac, np.float64).reshape(2, 2)
    # ClampUpAxes: singular values of J clamped up to 1 (unit circle min)
    U_, s, Vt = np.linalg.svd(J)
    major_mag = max(float(s[0]), 1.0)
    minor_mag = max(float(s[1]), 1.0)
    # major/minor axis direction vectors (in source space) × magnitudes
    major = U_[:, 0] * major_mag
    minor = U_[:, 1] * minor_mag
    A = major[1] ** 2 + minor[1] ** 2
    B = -2.0 * (major[0] * major[1] + minor[0] * minor[1])
    C = major[0] ** 2 + minor[0] ** 2
    F_ = (major_mag * minor_mag) ** 2  # resample.c:1098 "F *= F"
    support = 2.0
    F_ *= support * support
    det = A * C - 0.25 * B * B
    Vlimit = math.sqrt(A * F_ / det)
    Uwidth = math.sqrt(F_ / A)
    slope = -B / (2.0 * A)
    scale = 1024.0 / F_
    As, Bs, Cs = float(A * scale), float(B * scale), float(C * scale)

    nv = int(2.0 * Vlimit) + 1 + 1   # max scan lines (v2-v1+1 <= 2V+1)
    uw = int(2.0 * Uwidth) + 1
    lut = _robidoux_lut(img.device)
    tap = _make_tap(img, background, vp)
    c = img.shape[-1]

    v1 = torch.ceil(v - Vlimit)
    v2 = torch.floor(v + Vlimit)
    acc = torch.zeros(u.shape + (c,), dtype=img.dtype, device=img.device)
    den = torch.zeros(u.shape + (1,), dtype=img.dtype, device=img.device)
    for k in range(nv):
        vv = v1 + k
        vmask = vv <= v2
        u1 = u + (vv - v) * slope - Uwidth
        ustart = torch.ceil(u1)
        V = vv - v
        vi = _index(vv)
        for j in range(uw):
            uu = ustart + j
            U = uu - u
            Q = (As * U + Bs * V) * U + Cs * V * V
            wgt = _ewa_weight(Q, lut, vmask)[..., None]
            px = tap(vi, _index(uu))
            acc = acc + wgt * px
            den = den + wgt
    out = acc / torch.where(den == 0.0, 1.0, den)
    fallback = sample_bilinear(img, u, v, background, vp)
    return torch.where(den == 0.0, fallback, out)


def _clamped_ellipse_np(a, b, c, d):
    """Per-pixel ClampUpAxes (resample.c:1100) in closed form, numpy f64.

    Jacobian J = [[a, b], [c, d]] per dest pixel; eigendecompose S = J·Jᵀ,
    clamp eigenvalues up to 1 (unit-circle minimum footprint), and return
    the ellipse quadratic A·U² + B·UV + C·V² < F exactly as the constant-
    Jacobian path derives it from the SVD (singular values = √eigenvalues,
    left singular vectors = eigenvectors of S).
    """
    p = a * a + b * b
    q = a * c + b * d
    r = c * c + d * d
    tr2 = 0.5 * (p + r)
    disc = np.sqrt(np.maximum(0.25 * (p - r) ** 2 + q * q, 0.0))
    l0 = tr2 + disc
    l1 = np.maximum(tr2 - disc, 0.0)
    c0 = np.maximum(l0, 1.0)
    c1 = np.maximum(l1, 1.0)
    # unit eigenvector for l0: pick the better-conditioned candidate
    v1x, v1y = q, l0 - p
    v2x, v2y = l0 - r, q
    n1 = v1x * v1x + v1y * v1y
    n2 = v2x * v2x + v2y * v2y
    use2 = n2 > n1
    ux = np.where(use2, v2x, v1x)
    uy = np.where(use2, v2y, v1y)
    nn = np.sqrt(np.maximum(ux * ux + uy * uy, 1e-300))
    degen = np.maximum(n1, n2) < 1e-300   # S ∝ identity: any axis
    ux = np.where(degen, 1.0, ux / nn)
    uy = np.where(degen, 0.0, uy / nn)
    # S' = c0·u uᵀ + c1·u⊥ u⊥ᵀ  (u⊥ = (-uy, ux))
    Sp = c0 * ux * ux + c1 * uy * uy
    Sq = (c0 - c1) * ux * uy
    Sr = c0 * uy * uy + c1 * ux * ux
    A = Sr
    B = -2.0 * Sq
    C = Sp
    F_ = c0 * c1
    return A, B, C, F_


def _pow2_bucket(n, lo=4):
    b = lo
    while b < n:
        b *= 2
    return b


def _pow2_bucket_np(n: np.ndarray, lo: int = 4) -> np.ndarray:
    """``_pow2_bucket`` of every entry of an int64 array."""
    b = np.full(np.shape(n), lo, np.int64)
    grow = b < n
    while grow.any():
        b = np.where(grow, b * 2, b)
        grow = b < n
    return b


def _ewa_buckets(nv: np.ndarray, uw: np.ndarray, norm: np.ndarray):
    """The pixels of ``norm`` grouped by (pow2(nv), pow2(uw)): a list of
    ((nvb, uwb), ascending pixel indices) sorted by key — the JAX
    function's buckets, built with one stable sort of the packed keys
    instead of a Python loop over the pixels."""
    idx = np.nonzero(norm)[0]
    if not idx.size:
        return []
    key = (_pow2_bucket_np(nv[idx]) << 32) | _pow2_bucket_np(uw[idx])
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    ends = np.r_[starts[1:], ks.size]
    return [((int(ks[a] >> 32), int(ks[a] & 0xFFFFFFFF)), idx[order[a:b]])
            for a, b in zip(starts, ends)]


def _ewa_taps_block(gather, t, k0: int, kb: int, uwb: int, lut):
    """Scanlines k0..k0+kb of one bucket (or of a chunk of its pixels)
    at once, the ``uwb`` taps of each scanline on a tensor axis: the same
    ellipse values, weights and taps as the JAX loop, summed in another
    order.  Returns (acc, den): (..., n, C) and (n, 1)."""
    cu, cv, cAs, cBs, cCs, csl, cUw, v1, v2 = [x[:, None] for x in t]
    n = cu.shape[0]
    kk = torch.arange(k0, k0 + kb, dtype=cu.dtype, device=cu.device)
    vv = v1 + kk                                        # (n, K)
    vmask = vv <= v2
    ustart = torch.ceil(cu + (vv - cv) * csl - cUw)
    V = vv - cv
    BV = (cBs * V)[..., None]
    CVV = (cCs * V * V)[..., None]
    jj = torch.arange(uwb, dtype=cu.dtype, device=cu.device)
    uu = ustart[..., None] + jj                         # (n, K, J)
    U = uu - cu[..., None]
    Q = (cAs[..., None] * U + BV) * U + CVV
    wgt = _ewa_weight(Q, lut, vmask[..., None])
    yi = _index(vv)[..., None].expand(n, kb, uwb).reshape(n * kb, uwb)
    px = gather(yi, _index(uu).reshape(n * kb, uwb))   # (..., n*K, J, C)
    px = px.reshape(px.shape[:-3] + (n, kb * uwb, px.shape[-1]))
    w2 = wgt.reshape(n, kb * uwb)
    acc = (w2[..., None] * px).sum(-2)
    return acc, w2.sum(-1, keepdim=True)


def _ewa_plan(n: int, nbc: int, nvb: int, uwb: int) -> Tuple[int, int]:
    """(pixels, scanlines) of one block of a bucket of ``n`` pixels,
    ``nvb`` scanlines of ``uwb`` taps, ``nbc`` = batch x channels values a
    tap: as many pixels as fit _EWA_BLOCK elements with one scanline
    each, then as many of their scanlines as fit.  A bucket that fits
    whole (the few pixels near the centre of a polar or arc map, which
    scan hundreds of taps a line) is one block of about 25 launches."""
    per_line = max(nbc, 1) * uwb
    chunk = max(1, min(n, _EWA_BLOCK // per_line))
    return chunk, max(1, min(nvb, _EWA_BLOCK // (per_line * chunk)))


def _ewa_bucket(gather, t, nvb: int, uwb: int, lut, nbc: int):
    """One bucket's (acc, den), in the blocks of ``_ewa_plan``."""
    n = t[0].shape[0]
    chunk, kb = _ewa_plan(n, nbc, nvb, uwb)
    accs, dens = [], []
    for p0 in range(0, n, chunk):
        tc = [x[p0:p0 + chunk] for x in t]
        acc = den = None
        for k0 in range(0, nvb, kb):
            a, d = _ewa_taps_block(gather, tc, k0, min(kb, nvb - k0), uwb,
                                   lut)
            acc = a if acc is None else acc + a
            den = d if den is None else den + d
        accs.append(acc)
        dens.append(den)
    if len(accs) == 1:
        return accs[0], dens[0]
    return torch.cat(accs, -2), torch.cat(dens, 0)


def sample_ewa_reference_var(img: torch.Tensor, u, v, jac,
                             background: Optional[Sequence[float]] = None,
                             vp: str = "edge") -> torch.Tensor:
    """Reference EWA resampling with a PER-PIXEL Jacobian (resample.c
    ResamplePixelColor driven by per-pixel ScaleFilter calls, as the
    Arc/Polar/Barrel/Cylinder distorts do — distort.c:2655-2817).

    u, v, and the 4 jac arrays are HOST numpy f64 maps over the output
    grid (u, v in index space = reference s − 0.5).  The ellipse setup,
    scan bounds, and limit tests run host-side in f64, as in the JAX
    function; the device work is a size-class-compacted tap scan: output
    pixels are bucketed by their (scanlines, taps-per-line) requirements
    (the JAX function's power-of-two buckets: a pixel scans all of its
    bucket's taps, and the extra taps can carry weight), each bucket's
    tables go to the device in one copy, and its results scatter into the
    output.  A bucket scans a block of pixels and scanlines at a time
    with the taps of a scanline on a tensor axis, within _EWA_BLOCK
    elements (``_ewa_plan``): the weights and selections equal the JAX
    ones, and a block sums them in another order.

    limit_reached pixels (parallelogram area > 4×image area,
    resample.c:1197) use the 4-neighbour average interpolation the
    reference falls back to under edge virtual pixels (resample.c:427);
    zero-hit pixels fall back to bilinear interpolation (resample.c:657).
    """
    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    dev = img.device
    out_shape = np.shape(u)
    support = 2.0
    A, B, C, F_ = _clamped_ellipse_np(*[np.asarray(j, np.float64)
                                        for j in jac])
    F_ = F_ * (support * support)
    det = A * C - 0.25 * B * B
    det = np.maximum(det, 1e-300)
    Vlimit = np.sqrt(A * F_ / det)
    Uwidth = np.sqrt(F_ / np.maximum(A, 1e-300))
    slope = -B / (2.0 * np.maximum(A, 1e-300))
    limit = (Uwidth * Vlimit) > 4.0 * (h * w)
    scale = 1024.0 / F_
    As, Bs, Cs = A * scale, B * scale, C * scale

    with np.errstate(invalid="ignore"):
        nv = (2.0 * Vlimit).astype(np.int64) + 2
        uw = (2.0 * Uwidth).astype(np.int64) + 1

    uf = np.asarray(u, np.float64).ravel()
    vf = np.asarray(v, np.float64).ravel()

    def flat(a):
        return np.broadcast_to(a, out_shape).ravel()

    flat_ = {k: flat(val) for k, val in
             dict(As=As, Bs=Bs, Cs=Cs, slope=slope, Uwidth=Uwidth,
                  Vlimit=Vlimit, nv=nv, uw=uw).items()}
    limit_f = flat(limit)

    lut = _robidoux_lut(dev)
    _gather = _make_tap(img, background, vp)

    # fallback plane: reference bilinear at the shifted s (the -0.5 is
    # already applied before ResamplePixelColor, distort.c:2856;
    # InterpolatePixelChannel BilinearInterpolatePixel, pixel.c:4769)
    uv = torch.from_numpy(np.stack([uf, vf]).astype(np.float32)).to(dev)
    uv = uv.reshape((2,) + tuple(out_shape))
    out = sample_bilinear(img, uv[0], uv[1], background, vp)
    out = out.reshape(lead + (uf.size, c)).contiguous()
    dim = out.dim() - 2

    # limit-reached pixels: 4-neighbour average at floor(s)
    lim_idx = np.nonzero(limit_f)[0]
    if lim_idx.size:
        xy = torch.from_numpy(np.stack([
            lim_idx, np.floor(uf[lim_idx]).astype(np.int32),
            np.floor(vf[lim_idx]).astype(np.int32)]).astype(np.int64)).to(dev)
        li, x0, y0 = xy
        avg = (_gather(y0, x0) + _gather(y0, x0 + 1) +
               _gather(y0 + 1, x0) + _gather(y0 + 1, x0 + 1)) * 0.25
        out.index_copy_(dim, li, avg)

    # normal pixels: bucket by (pow2(nv), pow2(uw))
    nbc = int(np.prod(lead, dtype=np.int64)) * c
    for (nvb, uwb), idx in _ewa_buckets(flat_["nv"], flat_["uw"],
                                        ~limit_f):
        vl = flat_["Vlimit"][idx]
        tables = np.stack([
            uf[idx], vf[idx], flat_["As"][idx], flat_["Bs"][idx],
            flat_["Cs"][idx], flat_["slope"][idx], flat_["Uwidth"][idx],
            np.ceil(vf[idx] - vl), np.floor(vf[idx] + vl),
            idx.astype(np.float64)])
        tab = torch.from_numpy(tables).to(dev)      # one copy a bucket
        t = list(tab[:9].to(img.dtype))
        li = tab[9].to(torch.int64)
        acc, den = _ewa_bucket(_gather, t, nvb, uwb, lut, nbc)
        good = den > 0.0
        res = acc / torch.where(good, den, 1.0)
        prev = out.index_select(dim, li)
        out.index_copy_(dim, li, torch.where(good, res, prev))
    return out.reshape(lead + tuple(out_shape) + (c,))


def sample_ewa(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               background: Optional[Sequence[float]] = None,
               window: int = 4) -> torch.Tensor:
    """Elliptical-weighted-average resampling with a clamped footprint.

    The reference clamps EWA ellipses to bound work (resample.c:77, per
    N. Robidoux); this uses a static (2*window)² Gaussian-weighted
    footprint around the mapped point, the vectorized equivalent.
    """
    h, w, c = img.shape[-3:]
    x0 = _index(torch.floor(u))
    y0 = _index(torch.floor(v))
    acc = None
    den = None
    sigma2 = 0.5  # unit-scale EWA Gaussian
    tap = _make_tap(img)
    for dy in range(-window // 2 + 1, window // 2 + 1):
        for dx in range(-window // 2 + 1, window // 2 + 1):
            ex = (x0 + dx).to(u.dtype) - u
            ey = (y0 + dy).to(v.dtype) - v
            d2 = ex * ex + ey * ey
            wgt = torch.exp(-d2 / (2.0 * sigma2))[..., None]
            px = tap(y0 + dy, x0 + dx)
            acc = px * wgt if acc is None else acc + px * wgt
            den = wgt if den is None else den + wgt
    out = acc / torch.clamp(den, min=1e-12)
    if background is None:
        return out          # virtual-pixel edge (clamped taps)
    inside = ((u >= -0.5) & (u <= w - 0.5) & (v >= -0.5) &
              (v <= h - 0.5))[..., None]
    bg = torch.tensor(list(background), dtype=img.dtype,
                      device=img.device)[:c]
    return torch.where(inside, out, bg)


def rotate_bilinear(img: torch.Tensor, theta: float,
                    background: Optional[Sequence[float]] = None
                    ) -> torch.Tensor:
    """Rotate about the center by theta radians, same canvas (helper);
    samples with ``sample_bilinear``'s default edge policy.  (The JAX
    function passes an undefined ``vp`` and raises NameError.)"""
    h, w = img.shape[-3], img.shape[-2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _grid(h, w, img.dtype, img.device)
    ct, st = math.cos(theta), math.sin(theta)
    u = ct * (xx - cx) + st * (yy - cy) + cx
    v = -st * (xx - cx) + ct * (yy - cy) + cy
    return sample_bilinear(img, u, v, background)


def rotate(img: torch.Tensor, degrees: float,
           background: Optional[Sequence[float]] = None,
           expand: bool = True, sampler: str = "ewa",
           vp: str = "edge", _pm: bool = True) -> torch.Tensor:
    """RotateImage (shear.c:~1400): arbitrary-angle rotation.

    The reference uses the 3-shear method (paper cited at shear.c:36) for
    quality; an inverse-mapped rotation with high-quality sampling is the
    gather-based equivalent (one gather instead of three passes).
    90-degree multiples take the exact transpose path
    (IntegralRotateImage, shear.c:700).
    """
    from .transform import rotate90, rotate180, rotate270

    deg = degrees % 360.0
    if deg == 0.0:
        return img
    if deg == 90.0:
        return rotate90(img)
    if deg == 180.0:
        return rotate180(img)
    if deg == 270.0:
        return rotate270(img)
    if _pm and img.shape[-1] in (2, 4):
        # alpha images resample premultiplied (resample.c alpha blend)
        return _premult_sample(
            img, background,
            lambda i, b: rotate(i, degrees, b, expand, sampler, vp,
                                _pm=False))
    theta = math.radians(deg)
    h, w = img.shape[-3], img.shape[-2]
    # RotateImage (distort.c:2954) = DistortImage(SRT, bestfit) about
    # center (columns/2, rows/2) with Background virtual pixels.
    # Forward affine dest->src (distort.c:818-824):
    cx, cy = w / 2.0, h / 2.0
    ct, st = math.cos(theta), math.sin(theta)
    c0, c1, c3, c4 = ct, st, -st, ct
    c2 = cx - cx * c0 - cy * c1
    c5 = cy - cx * c3 - cy * c4
    if expand:
        # bestfit viewport: source corners through the INVERSE affine
        # (distort.c:1856-1878), floor/ceil with the 0.5 margins (:2021)
        det = c0 * c4 - c1 * c3
        i0, i1, i2 = c4 / det, -c1 / det, (c1 * c5 - c4 * c2) / det
        i3, i4, i5 = -c3 / det, c0 / det, (c3 * c2 - c0 * c5) / det
        xs, ys = [], []
        for sx_, sy_ in ((0, 0), (w, 0), (0, h), (w, h)):
            xs.append(i0 * sx_ + i1 * sy_ + i2)
            ys.append(i3 * sx_ + i4 * sy_ + i5)
        gx = math.floor(min(xs) - 0.5)
        gy = math.floor(min(ys) - 0.5)
        nw = int(math.ceil(max(xs) - gx + 0.5))
        nh = int(math.ceil(max(ys) - gy + 0.5))
    else:
        gx = gy = 0
        nh, nw = h, w
    yy, xx = _grid(nh, nw, img.dtype, img.device)
    dx = xx + (gx + 0.5)
    dy = yy + (gy + 0.5)
    u = c0 * dx + c1 * dy + c2 - 0.5
    v = c3 * dx + c4 * dy + c5 - 0.5
    if sampler == "bilinear":
        return warp(img, u, v, background, "bilinear")
    return sample_ewa_reference(img, u, v, (c0, c1, c3, c4), background, vp)


def affine_projection_bestfit(img: torch.Tensor, matrix: Sequence[float],
                              background: Optional[Sequence[float]] = None,
                              vp: str = "edge") -> torch.Tensor:
    """AffineTransformImage (distort.c): DistortImage(AffineProjection,
    bestfit) — forward matrix (sx, rx, ry, sy, tx, ty) in the AffineMatrix
    convention x' = sx·x + ry·y + tx ; y' = rx·x + sy·y + ty, background
    virtual pixels, reference EWA resampling."""
    sx, rx, ry, sy, tx, ty = [float(m) for m in matrix]
    h, w = img.shape[-3], img.shape[-2]
    fwd = np.array([[sx, ry, tx], [rx, sy, ty], [0, 0, 1]], np.float64)
    inv = np.linalg.inv(fwd)                     # dest -> src coefficients
    c0, c1, c2 = [float(x) for x in inv[0]]
    c3, c4, c5 = [float(x) for x in inv[1]]
    xs, ys = [], []
    for sxc, syc in ((0, 0), (w, 0), (0, h), (w, h)):
        xs.append(sx * sxc + ry * syc + tx)
        ys.append(rx * sxc + sy * syc + ty)
    gx = math.floor(min(xs) - 0.5)
    gy = math.floor(min(ys) - 0.5)
    nw = int(math.ceil(max(xs) - gx + 0.5))
    nh = int(math.ceil(max(ys) - gy + 0.5))
    yy, xx = _grid(nh, nw, img.dtype, img.device)
    dx = xx + (gx + 0.5)
    dy = yy + (gy + 0.5)
    u = c0 * dx + c1 * dy + c2 - 0.5
    v = c3 * dx + c4 * dy + c5 - 0.5
    return sample_ewa_reference(img, u, v, (c0, c1, c3, c4), background, vp)


def affine_transform(img: torch.Tensor, matrix: Sequence[float],
                     out_shape: Optional[Tuple[int, int]] = None,
                     background: Optional[Sequence[float]] = None,
                     sampler: str = "bilinear",
                     vp: str = "edge") -> torch.Tensor:
    """AffineTransformImage / DistortImage AffineDistortion.

    matrix = (sx, rx, ry, sy, tx, ty) as in the reference's AffineMatrix:
    x' = sx*x + ry*y + tx ; y' = rx*x + sy*y + ty.  We invert it and sample.
    """
    sx, rx, ry, sy, tx, ty = [float(m) for m in matrix]
    det = sx * sy - rx * ry
    if abs(det) < 1e-12:
        raise ValueError("singular affine matrix")
    isx, iry = sy / det, -ry / det
    irx, isy = -rx / det, sx / det
    itx = -(isx * tx + iry * ty)
    ity = -(irx * tx + isy * ty)
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_shape if out_shape else (h, w)
    yy, xx = _grid(oh, ow, img.dtype, img.device)
    u = isx * xx + iry * yy + itx
    v = irx * xx + isy * yy + ity
    return warp(img, u, v, background, sampler, vp=vp)


def _solve_perspective(src_pts, dst_pts):
    """8-dof homography from 4 point pairs (distort.c PerspectiveDistortion)."""
    A = []
    bvec = []
    for (x, y), (X, Y) in zip(src_pts, dst_pts):
        A.append([x, y, 1, 0, 0, 0, -X * x, -X * y])
        bvec.append(X)
        A.append([0, 0, 0, x, y, 1, -Y * x, -Y * y])
        bvec.append(Y)
    coeff = np.linalg.solve(np.asarray(A, np.float64),
                            np.asarray(bvec, np.float64))
    return coeff  # a b c d e f g h


def _bestfit_geometry(corners):
    """distort.c:1997 fix_bounds: output viewport from mapped dest corners."""
    minx = min(p[0] for p in corners)
    maxx = max(p[0] for p in corners)
    miny = min(p[1] for p in corners)
    maxy = max(p[1] for p in corners)
    gx = math.floor(minx - 0.5)
    gy = math.floor(miny - 0.5)
    ow = int(math.ceil(maxx - gx + 0.5))
    oh = int(math.ceil(maxy - gy + 0.5))
    return gx, gy, ow, oh


def _affine_bestfit_grid(c, h, w, img_dtype, device=None):
    """Map source corners through the inverted dest->src affine
    (distort.c:1853 InvertAffineCoefficients + ExpandBounds) and return
    the shifted dest-coordinate grid + viewport."""
    c0, c1, c2, c3, c4, c5 = c
    M = np.array([[c0, c1, c2], [c3, c4, c5], [0.0, 0.0, 1.0]], np.float64)
    inv = np.linalg.inv(M)
    pts = []
    for sx_, sy_ in ((0, 0), (w, 0), (0, h), (w, h)):
        pts.append((inv[0, 0] * sx_ + inv[0, 1] * sy_ + inv[0, 2],
                    inv[1, 0] * sx_ + inv[1, 1] * sy_ + inv[1, 2]))
    gx, gy, ow, oh = _bestfit_geometry(pts)
    yy, xx = _grid(oh, ow, img_dtype, device)
    return xx + float(gx + 0.5), yy + float(gy + 0.5)


def _affine_sample(img, ic, xx, yy, h, w, bestfit, sampler, background, vp):
    """The dest->src affine ``ic`` = (c0..c5) sampled on the input-size
    grid or the bestfit viewport (distort.c:818, :2531, :2858)."""
    ic = tuple(float(x) for x in ic)
    if bestfit:
        dx, dy = _affine_bestfit_grid(ic, h, w, img.dtype, img.device)
    else:
        dx, dy = xx + 0.5, yy + 0.5
    u = ic[0] * dx + ic[1] * dy + ic[2] - 0.5
    v = ic[3] * dx + ic[4] * dy + ic[5] - 0.5
    if sampler == "ewa":
        return sample_ewa_reference(img, u, v, (ic[0], ic[1], ic[3], ic[4]),
                                    background, vp)
    return warp(img, u, v, background, sampler, vp=vp)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for a Python int y by XLA's integer_pow: binary
    exponentiation, the same products in the same order."""
    if y == 0:
        return torch.ones_like(x)
    recip = y < 0
    y = abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def _inverse_coeffs(fwd: np.ndarray):
    inv = np.linalg.inv(fwd)
    return (inv[0, 0], inv[0, 1], inv[0, 2], inv[1, 0], inv[1, 1],
            inv[1, 2])


def distort(img: torch.Tensor, method: str, args: Sequence[float],
            background: Optional[Sequence[float]] = None,
            sampler: str = "ewa", bestfit: bool = False,
            vp: str = "edge", _pm: bool = True) -> torch.Tensor:
    """DistortImage (distort.c:1754) — core methods.

    Supported: srt (scale-rotate-translate), affine (3+ point pairs),
    perspective (4 pairs), affineprojection, perspectiveprojection,
    rigidaffine, bilinearforward, bilinear/bilinearreverse, polynomial,
    shepards, resize, arc, polar, depolar, barrel, barrelinverse,
    cylinder2plane and plane2cylinder.  Control-point methods solve their
    coefficient systems host-side (numpy least squares — the reference's
    Gauss-Jordan in matrix.c), then evaluate the inverse map on the
    image's device.  bestfit=True (the CLI's +distort) resizes the output
    canvas to the mapped source bounds (distort.c:1822-2030).
    """
    method = method.lower()
    if (vp or "").lower() == "transparent":
        # transparent virtual pixels: promote to alpha and sample with a
        # (0,0,0,0) background fill (SetImageVirtualPixelMethod path)
        if img.shape[-1] in (1, 3):
            a = torch.ones(img.shape[:-1] + (1,), dtype=img.dtype,
                           device=img.device)
            img = torch.cat([img, a], -1)
        background = (0.0,) * img.shape[-1]
        vp = "background"
    if _pm and img.shape[-1] in (2, 4):
        # resample.c blends alpha-weighted for images carrying alpha
        return _premult_sample(
            img, background,
            lambda i, b: distort(i, method, args, background=b,
                                 sampler=sampler, bestfit=bestfit, vp=vp,
                                 _pm=False))

    h, w = img.shape[-3], img.shape[-2]
    yy, xx = _grid(h, w, img.dtype, img.device)
    cy, cx = h / 2.0, w / 2.0

    if method == "srt":
        # args variants (distort.c:723 ScaleRotateTranslate): converted to
        # the forward dest->src affine (distort.c:818) and sampled at
        # d=(i+0.5, j+0.5), s-0.5 (distort.c:2531,:2858) like the reference
        a = list(args)
        sx_ = sy_ = 1.0
        if len(a) == 1:
            pcx, pcy, angle, nx, ny = cx, cy, a[0], cx, cy
        elif len(a) == 2:
            pcx, pcy, angle, nx, ny = cx, cy, a[1], cx, cy
            sx_ = sy_ = a[0]
        elif len(a) == 3:
            pcx, pcy, angle, nx, ny = a[0], a[1], a[2], a[0], a[1]
        elif len(a) == 4:
            pcx, pcy, angle, nx, ny = a[0], a[1], a[3], a[0], a[1]
            sx_ = sy_ = a[2]
        elif len(a) == 5:
            pcx, pcy, angle, nx, ny = a[0], a[1], a[4], a[0], a[1]
            sx_, sy_ = a[2], a[3]
        elif len(a) == 6:
            pcx, pcy, angle, nx, ny = a[0], a[1], a[3], a[4], a[5]
            sx_ = sy_ = a[2]
        else:
            pcx, pcy, angle, nx, ny = a[0], a[1], a[4], a[5], a[6]
            sx_, sy_ = a[2], a[3]
        t = math.radians(angle)
        ct, st = math.cos(t), math.sin(t)
        c0, c1 = ct / sx_, st / sx_
        c3, c4 = -st / sy_, ct / sy_
        c2 = pcx - nx * c0 - ny * c1
        c5 = pcy - nx * c3 - ny * c4
        return _affine_sample(img, (c0, c1, c2, c3, c4, c5), xx, yy, h, w,
                              bestfit, sampler, background, vp)

    if method == "affine":
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        src = pts[:, :2]
        dst = pts[:, 2:]
        # least-squares fit: dst = M @ src (reference fits forward, then inverts)
        A = np.concatenate([src, np.ones((len(src), 1))], axis=1)
        mx, *_ = np.linalg.lstsq(A, dst[:, 0], rcond=None)
        my, *_ = np.linalg.lstsq(A, dst[:, 1], rcond=None)
        fwd = np.array([[mx[0], mx[1], mx[2]], [my[0], my[1], my[2]],
                        [0, 0, 1]])
        return _affine_sample(img, _inverse_coeffs(fwd), xx, yy, h, w,
                              bestfit, sampler, background, vp)

    if method == "perspective":
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        coeff = _solve_perspective(pts[:, 2:], pts[:, :2])  # dst->src
        # ground-sky sign from the first dest control point (distort.c:929)
        c8 = coeff[6] * pts[0, 2] + coeff[7] * pts[0, 3] + 1.0
        c8 = -1.0 if c8 < 0.0 else 1.0
        return _perspective_eval(img, coeff, c8, background, bestfit,
                                 sampler, vp)

    if method == "affineprojection":
        # 6 raw forward coefficients sx,rx,ry,sy,tx,ty (distort.h)
        sx, rx, ry, sy, tx, ty = (list(args) + [0.0] * 6)[:6]
        fwd = np.array([[sx, ry, tx], [rx, sy, ty], [0, 0, 1]], np.float64)
        return _affine_sample(img, _inverse_coeffs(fwd), xx, yy, h, w,
                              bestfit, sampler, background, vp)

    if method == "perspectiveprojection":
        # 8 raw forward coefficients inverted (distort.c:948
        # InvertPerspectiveCoefficients), then the normal perspective path
        a, b, c, d, e, f, g, hh = (list(args) + [0.0] * 8)[:8]
        fwd = np.array([[a, b, c], [d, e, f], [g, hh, 1.0]], np.float64)
        inv = np.linalg.inv(fwd)
        inv = inv / inv[2, 2]
        coeff = [inv[0, 0], inv[0, 1], inv[0, 2], inv[1, 0], inv[1, 1],
                 inv[1, 2], inv[2, 0], inv[2, 1]]
        # forward maps source (0,0) to (c, f): sign of r there (distort.c:956)
        c8 = coeff[6] * c + coeff[7] * f + 1.0
        c8 = -1.0 if c8 < 0.0 else 1.0
        return _perspective_eval(img, coeff, c8, background, bestfit,
                                 sampler, vp)

    if method == "rigidaffine":
        # similarity transform: rotation + uniform scale + translation
        # fitted from point pairs (distort.c RigidAffine)
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        src, dst = pts[:, :2], pts[:, 2:]
        sc, dc = src.mean(0), dst.mean(0)
        s0, d0 = src - sc, dst - dc
        num = (d0[:, 0] * s0[:, 0] + d0[:, 1] * s0[:, 1]).sum()
        cross = (d0[:, 1] * s0[:, 0] - d0[:, 0] * s0[:, 1]).sum()
        denom = (s0 ** 2).sum()
        a_, b_ = num / denom, cross / denom
        fwd = np.array([[a_, -b_, dc[0] - a_ * sc[0] + b_ * sc[1]],
                        [b_, a_, dc[1] - b_ * sc[0] - a_ * sc[1]],
                        [0, 0, 1]], np.float64)
        return _affine_sample(img, _inverse_coeffs(fwd), xx, yy, h, w,
                              bestfit, sampler, background, vp)

    if method == "bilinearforward":
        # forward-fitted bilinear i = c0·x+c1·y+c2·xy+c3 (source x,y ->
        # dest i,j), inverted per pixel via the reference quadratic
        # (distort.c:1032 coefficient fit, :2596 reverse mapping)
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        T = np.stack([pts[:, 0], pts[:, 1], pts[:, 0] * pts[:, 1],
                      np.ones(len(pts))], 1)
        ci, *_ = np.linalg.lstsq(T, pts[:, 2], rcond=None)
        cj, *_ = np.linalg.lstsq(T, pts[:, 3], rcond=None)
        c0, c1, c2, c3 = ci
        c4, c5, c6, c7 = cj
        c8 = c0 * c5 - c1 * c4
        c9 = 2.0 * (c2 * c5 - c1 * c6)
        jj2, ii2 = np.mgrid[0:h, 0:w].astype(np.float64)
        dx = ii2 + 0.5 - c3
        dy = jj2 + 0.5 - c7
        b = c6 * dx - c2 * dy + c8
        cc = c4 * dx - c0 * dy
        if abs(c9) < 1e-12:
            validity = np.ones_like(dx)
            sy = -cc / np.where(np.abs(b) < 1e-15, 1e-15, b)
        else:
            disc = b * b - 2.0 * c9 * cc
            validity = np.where(disc < 0.0, 0.0, 1.0)
            sy = (-b + np.sqrt(np.maximum(disc, 0.0))) / c9
        den = c0 + c2 * sy
        sx = (dx - c1 * sy) / np.where(np.abs(den) < 1e-15, 1e-15, den)
        # no ScaleFilter call here (distort.c:2621 FUTURE note): samples
        # with the unit-circle EWA from filter init (resample.c:1316)
        one = np.ones_like(sx)
        zero = np.zeros_like(sx)
        out = sample_ewa_reference_var(img, sx - 0.5, sy - 0.5,
                                       (one, zero, zero, one), background, vp)
        if np.all(validity >= 1.0):
            return out
        return _blend_invalid(out, validity, img.shape[-1], img.dtype)

    if method in ("barrel", "barrelinverse", "arc", "polar", "depolar",
                  "cylinder2plane", "plane2cylinder"):
        return _polar_family(img, method, args, background, bestfit, vp)

    if method == "polynomial":
        # args: order, then x,y,X,Y control points (distort.c Polynomial)
        order = int(args[0])
        pts = np.asarray(args[1:], np.float64).reshape(-1, 4)
        src = pts[:, :2]
        dst = pts[:, 2:]
        terms = [(i, j) for i in range(order + 1)
                 for j in range(order + 1 - i)]

        def basis(p):
            return np.stack([p[:, 0] ** i * p[:, 1] ** j for i, j in terms], 1)

        A = basis(dst)  # inverse fit: dst -> src
        cu, *_ = np.linalg.lstsq(A, src[:, 0], rcond=None)
        cv, *_ = np.linalg.lstsq(A, src[:, 1], rcond=None)

        def poly(coef):
            # float32, term by term in the JAX order: c·x**i·y**j summed
            acc = None
            for cf, (i, j) in zip(coef, terms):
                term = (float(cf) * _integer_pow(xx, i)) * \
                    _integer_pow(yy, j)
                acc = term if acc is None else acc + term
            return acc

        return warp(img, poly(cu), poly(cv), background, sampler, vp=vp)

    if method in ("shepards", "shepard"):
        # inverse-distance-weighted displacement about the DEST control
        # points (distort.c:2817); weight = min(1, d^-2·power), power
        # defaults to 1 (inverse squared, distort.c:1498); sampled with
        # the unit-circle EWA (no ScaleFilter call)
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        power = 1.0
        jj2, ii2 = np.mgrid[0:h, 0:w].astype(np.float64)
        dx = ii2 + 0.5
        dy = jj2 + 0.5
        num_x = np.zeros_like(dx)
        num_y = np.zeros_like(dx)
        den = np.zeros_like(dx)
        for su, sv, px, py in pts:
            d2 = (dx - px) ** 2 + (dy - py) ** 2
            wgt = d2 ** power
            wgt = np.where(wgt < 1.0, 1.0, 1.0 / np.maximum(wgt, 1e-300))
            num_x += (su - px) * wgt
            num_y += (sv - py) * wgt
            den += wgt
        u = num_x / den + dx
        v = num_y / den + dy
        one = np.ones_like(u)
        zero = np.zeros_like(u)
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5,
                                        (one, zero, zero, one), background, vp)

    if method in ("bilineardistortion", "bilinear", "bilinearreverse"):
        # reverse-fitted bilinear s = c0·x+c1·y+c2·xy+c3 over dest control
        # points (distort.c:1013), per-pixel EWA with the bilinear partial
        # derivatives (distort.c:2581-2594)
        pts = np.asarray(args, np.float64).reshape(-1, 4)
        T = np.stack([pts[:, 2], pts[:, 3], pts[:, 2] * pts[:, 3],
                      np.ones(len(pts))], 1)
        cu, *_ = np.linalg.lstsq(T, pts[:, 0], rcond=None)
        cv, *_ = np.linalg.lstsq(T, pts[:, 1], rcond=None)
        jj2, ii2 = np.mgrid[0:h, 0:w].astype(np.float64)
        dx = ii2 + 0.5
        dy = jj2 + 0.5
        u = cu[0] * dx + cu[1] * dy + cu[2] * dx * dy + cu[3]
        v = cv[0] * dx + cv[1] * dy + cv[2] * dx * dy + cv[3]
        jac = (cu[0] + cu[2] * dy, cu[1] + cu[2] * dx,
               cv[0] + cv[2] * dy, cv[1] + cv[2] * dx)
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                        background, vp)

    if method in ("resize", "resizedistortion"):
        from .resize import resize as rz_resize

        nw, nh = int(args[0]), int(args[1] if len(args) > 1 else args[0])
        return rz_resize(img, nh, nw, "robidoux")

    raise ValueError(f"unsupported distort method {method!r}")


_MATTE_GRAY = 189.0 / 255.0  # DefaultMatteColor "#BDBDBD" (image.h)


def _blend_invalid(out, validity, img_channels, dtype):
    """Mix the resampled color with the matte 'invalid' pixel by validity
    (distort.c:2860-2880 CompositePixelInfoBlend)."""
    c = img_channels
    invalid = torch.tensor(([_MATTE_GRAY] * 3 + [1.0])[:c] if c != 2
                           else [_MATTE_GRAY, 1.0], dtype=dtype,
                           device=out.device)
    vmask = torch.from_numpy(np.clip(validity, 0.0, 1.0).astype(
        np.float32)).to(device=out.device, dtype=dtype)[..., None]
    return out * vmask + invalid * (1.0 - vmask)


def _perspective_eval(img: torch.Tensor, coeff, c8: float,
                      background: Optional[Sequence[float]],
                      bestfit: bool, sampler: str = "ewa",
                      vp: str = "edge") -> torch.Tensor:
    """PerspectiveDistortion evaluation (distort.c:2548-2580): ratio of
    affines with sky/ground validity, horizon anti-alias band, and the
    per-pixel EWA derivative matrix; matte-color blend for invalid."""
    h, w = img.shape[-3], img.shape[-2]
    c0, c1, c2, c3, c4, c5, c6, c7 = [float(x) for x in coeff]
    if bestfit:
        # distort.c:1880: map source corners through the inverted
        # (i.e. forward, src->dest) perspective
        M = np.array([[c0, c1, c2], [c3, c4, c5], [c6, c7, 1.0]], np.float64)
        inv = np.linalg.inv(M)
        inv = inv / inv[2, 2]
        pts = []
        for sx_, sy_ in ((0, 0), (w, 0), (0, h), (w, h)):
            sc = inv[2, 0] * sx_ + inv[2, 1] * sy_ + 1.0
            sc = 1.0 / sc if abs(sc) > 1e-15 else 1e15
            pts.append((sc * (inv[0, 0] * sx_ + inv[0, 1] * sy_ + inv[0, 2]),
                        sc * (inv[1, 0] * sx_ + inv[1, 1] * sy_ + inv[1, 2])))
        gx, gy, ow, oh = _bestfit_geometry(pts)
    else:
        gx = gy = 0
        ow, oh = w, h
    jj, ii = np.mgrid[0:oh, 0:ow].astype(np.float64)
    dx = gx + ii + 0.5
    dy = gy + jj + 0.5
    p = c0 * dx + c1 * dy + c2
    n = c3 * dx + c4 * dy + c5
    r = c6 * dx + c7 * dy + 1.0
    validity = np.where(r * c8 < 0.0, 0.0, 1.0)
    abs_r = np.abs(r) * 2.0
    if abs(c6) > abs(c7):
        validity = np.where(abs_r < abs(c6), 0.5 - c8 * r / c6, validity)
    elif abs(c7) > 0:
        validity = np.where(abs_r < abs(c7), 0.5 - c8 * r / c7, validity)
    rs = np.where(np.abs(r) < 1e-15, 1e-15, r)
    scale = 1.0 / rs
    u = p * scale
    v = n * scale
    s2 = scale * scale
    jac = ((r * c0 - p * c6) * s2, (r * c1 - p * c7) * s2,
           (r * c3 - n * c6) * s2, (r * c4 - n * c7) * s2)
    if sampler == "ewa":
        out = sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                       background, vp)
    else:
        # -filter point / interpolated resampling: plain warp, no EWA
        uv = torch.from_numpy(np.stack([u - 0.5, v - 0.5]).astype(
            np.float32)).to(img.device)
        out = warp(img, uv[0], uv[1], background, sampler, vp=vp)
    if np.all(validity >= 1.0):
        return out
    return _blend_invalid(out, validity, img.shape[-1], img.dtype)


def _polar_family(img: torch.Tensor, method: str, args: Sequence[float],
                  background: Optional[Sequence[float]],
                  bestfit: bool = False, vp: str = "edge") -> torch.Tensor:
    """Arc/Polar/DePolar/Barrel/Cylinder distorts, reference-exact.

    Coefficient generation mirrors distort.c GenerateCoefficients
    (Arc distort.c:1177, Polar/DePolar :1250, Cylinder :1342, Barrel
    :1391); per-pixel evaluation and ScaleFilter Jacobians mirror the
    DistortImage mapping switch (distort.c:2655-2817).  All map math runs
    host-side in f64 (it depends only on geometry, not pixels); sampling
    is the per-pixel-Jacobian EWA scan on the image's device.  Arc always
    computes a best-fit output canvas (distort.c:1822); the other methods
    keep the input size under plain -distort.
    """
    h, w = img.shape[-3], img.shape[-2]
    a = list(args)
    na = len(a)
    two_pi = 2.0 * math.pi

    def grid(oh, ow, gx=0.0, gy=0.0):
        jj, ii = np.mgrid[0:oh, 0:ow].astype(np.float64)
        return gx + ii + 0.5, gy + jj + 0.5   # d.x, d.y (distort.c:2531)

    if method == "arc":
        if na >= 1 and a[0] < 1e-10:
            raise ValueError("Arc Angle Too Small")
        if na >= 3 and a[2] < 1e-10:
            raise ValueError("Outer Radius Too Small")
        c0 = -math.pi / 2.0
        c1 = math.radians(a[0]) if na >= 1 else math.pi / 2.0
        if na >= 2:
            c0 += math.radians(a[1])
        c0 /= two_pi
        c0 -= _round_half_even(c0)
        c0 *= two_pi
        c3 = float(h - 1)
        c2 = w / c1 + c3 / 2.0
        if na >= 3:
            if na >= 4:
                c3 = a[2] - a[3]
            else:
                c3 *= a[2] / c2
            c2 = a[2]
        c4 = (w - 1.0) / 2.0
        # best-fit bbox: arc corners + orthogonal extremes (distort.c:1913)
        pts = []
        for ang in (c0 - c1 / 2.0, c0 + c1 / 2.0):
            ca, sa = math.cos(ang), math.sin(ang)
            pts += [(c2 * ca, c2 * sa), ((c2 - c3) * ca, (c2 - c3) * sa)]
        ang = math.ceil((c0 - c1 / 2.0) / (math.pi / 2)) * (math.pi / 2)
        while ang < c0 + c1 / 2.0:
            pts.append((c2 * math.cos(ang), c2 * math.sin(ang)))
            ang += math.pi / 2
        minx = min(p[0] for p in pts)
        maxx = max(p[0] for p in pts)
        miny = min(p[1] for p in pts)
        maxy = max(p[1] for p in pts)
        gx = math.floor(minx - 0.5)
        gy = math.floor(miny - 0.5)
        ow = int(math.ceil(maxx - gx + 0.5))
        oh = int(math.ceil(maxy - gy + 0.5))
        c1s = two_pi * w / c1       # angle->column scale (distort.c:1943)
        c3s = h / c3                # radius->row scale
        dx, dy = grid(oh, ow, gx, gy)
        sx = (np.arctan2(dy, dx) - c0) / two_pi
        sx -= _round_half_away_np(sx)
        r = np.hypot(dx, dy)
        jux = np.where(r > 1e-10, c1s / (two_pi * np.maximum(r, 1e-10)),
                       float(ow) * 2.0)
        jac = (jux, np.zeros_like(jux), np.zeros_like(jux),
               np.full_like(jux, c3s))
        u = sx * c1s + c4 + 0.5
        v = (c2 - r) * c3s
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                        background, vp)

    if method in ("polar", "depolar"):
        if na == 3 or (na > 6 and method == "polar") or na > 8:
            raise ValueError("invalid number of Polar arguments")
        c0 = a[0] if na >= 1 else 0.0
        c1 = a[1] if na >= 2 else 0.0
        if na >= 4:
            c2, c3 = a[2], a[3]
        else:
            c2, c3 = w / 2.0, h / 2.0
        c4 = math.radians(a[4]) if na >= 5 else -math.pi
        c5 = math.radians(a[5]) if na >= 6 else c4
        if abs(c4 - c5) < 1e-10:
            c5 += two_pi
        if c0 < 1e-10:
            if abs(c0) < 1e-10:       # radius 0: closest edge
                c0 = min(abs(c2), abs(c3), abs(c2 - w), abs(c3 - h))
            if abs(-1.0 - c0) < 1e-10:  # radius -1: furthest corner
                c0 = math.sqrt(max(
                    c2 * c2 + c3 * c3, c2 * c2 + (c3 - h) ** 2,
                    (c2 - w) ** 2 + c3 * c3, (c2 - w) ** 2 + (c3 - h) ** 2))
        if c0 < 1e-10 or c1 < -1e-10 or (c0 - c1) < 1e-10:
            raise ValueError("Invalid Radius")
        if method == "polar":
            c6 = w / (c5 - c4)
            c7 = h / (c0 - c1)
            if bestfit:
                # +distort Polar: viewport spans center±Rmax; an implicit
                # center is treated as the origin (distort.c:1947-1956)
                if na < 2:
                    c2 = c3 = 0.0
                gx, gy, ow, oh = _bestfit_geometry(
                    [(c2 - c0, c3 - c0), (c2 + c0, c3 + c0)])
                dx, dy = grid(oh, ow, gx, gy)
            else:
                dx, dy = grid(h, w)
            dx = dx - c2
            dy = dy - c3
            sx = np.arctan2(dx, dy) - (c4 + c5) / 2.0   # 0 is downward
            sx /= two_pi
            sx -= _round_half_away_np(sx)
            sx *= two_pi
            r = np.hypot(dx, dy)
            out_w = dx.shape[1]
            jux = np.where(r > 1e-10, c6 / (two_pi * np.maximum(r, 1e-10)),
                           float(out_w) * 2.0)
            jac = (jux, np.zeros_like(jux), np.zeros_like(jux),
                   np.full_like(jux, c7))
            u = sx * c6 + w / 2.0
            v = (r - c1) * c7
            return sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                            background, vp)
        # depolar: direct polar->cartesian lookup; the reference never
        # rescales the resample filter here, so every pixel samples with
        # the default UNIT-circle EWA set at filter init (distort.c:2705,
        # resample.c:1316 ScaleResampleFilter(...,1,0,0,1))
        if bestfit:
            # +distort DePolar: exact tileable size (distort.c:1959)
            oh = int(math.ceil(c0 - c1))
            ow = int(math.ceil((c0 - c1) * (c5 - c4) * 0.5))
            c6 = (c5 - c4) / max(ow, 1)
            c7 = (c0 - c1) / max(oh, 1)
            dx, dy = grid(oh, ow)
        else:
            c6 = (c5 - c4) / w
            c7 = (c0 - c1) / h
            dx, dy = grid(h, w)
        ang = dx * c6 + c4
        rad = dy * c7 + c1
        u = rad * np.sin(ang) + c2
        v = rad * np.cos(ang) + c3
        one = np.ones_like(u)
        zero = np.zeros_like(u)
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5,
                                        (one, zero, zero, one), background, vp)

    if method in ("barrel", "barrelinverse"):
        if na < 3 or na in (7, 9) or na > 10:
            raise ValueError("invalid number of Barrel arguments")
        rscale = 2.0 / min(w, h)
        cA, cB, cC = a[0], a[1], a[2]
        cD = 1.0 - cA - cB - cC if na in (3, 5) else a[3]
        cA *= rscale ** 3
        cB *= rscale * rscale
        cC *= rscale
        if na >= 8:
            yA, yB, yC, yD = (a[4] * rscale ** 3, a[5] * rscale * rscale,
                              a[6] * rscale, a[7])
        else:
            yA, yB, yC, yD = cA, cB, cC, cD
        if na == 5:
            cx_, cy_ = a[3], a[4]
        elif na == 6:
            cx_, cy_ = a[4], a[5]
        elif na == 10:
            cx_, cy_ = a[8], a[9]
        else:
            cx_, cy_ = w / 2.0, h / 2.0
        dx, dy = grid(h, w)
        dx = dx - cx_
        dy = dy - cy_
        r = np.hypot(dx, dy)
        rs = np.maximum(r, 1e-10)
        fx = ((cA * rs + cB) * rs + cC) * rs + cD
        fy = ((yA * rs + yB) * rs + yC) * rs + yD
        gx = ((3 * cA * rs + 2 * cB) * rs + cC) / rs
        gy = ((3 * yA * rs + 2 * yB) * rs + yC) / rs
        if method == "barrelinverse":
            fx = 1.0 / fx
            fy = 1.0 / fy
            gx = -gx * fx * fx
            gy = -gy * fy * fy
        u = np.where(r > 1e-10, dx * fx + cx_, dx + cx_)
        v = np.where(r > 1e-10, dy * fy + cy_, dy + cy_)
        ctr_x = cD if method == "barrel" else 1.0 / cD
        ctr_y = yD if method == "barrel" else 1.0 / yD
        jac = (np.where(r > 1e-10, gx * dx * dx + fx, ctr_x),
               np.where(r > 1e-10, gx * dx * dy, 0.0),
               np.where(r > 1e-10, gy * dx * dy, 0.0),
               np.where(r > 1e-10, gy * dy * dy + fy, ctr_y))
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                        background, vp)

    # cylinder2plane / plane2cylinder (distort.c:1342, :2715-2770)
    fov = math.radians(a[0]) if a else math.radians(90.0)
    if fov < 1e-10 or fov > math.radians(160.0):
        raise ValueError("Invalid FOV Angle")
    if method == "cylinder2plane":
        radius = w / fov
    else:
        radius = w / (2.0 * math.tan(fov / 2.0))
    c2, c3 = w / 2.0, h / 2.0   # input center
    if bestfit:
        # direct reversible viewport + recentered distortion (distort.c:1977)
        if method == "cylinder2plane":
            ow = int(math.ceil(2.0 * radius * math.tan(fov / 2.0)))
            oh = int(math.ceil(2.0 * c3 / math.cos(fov / 2.0)))
        else:
            ow = int(math.ceil(fov * radius))
            oh = int(2 * c3)
        c4, c5 = ow / 2.0, oh / 2.0
        dx, dy = grid(oh, ow)
    else:
        c4, c5 = c2, c3         # dest center = input center
        dx, dy = grid(h, w)
    dx = dx - c4
    dy = dy - c5
    if method == "cylinder2plane":
        dxr = dx / radius
        ax = np.arctan(dxr)
        cxs = np.cos(ax)
        sy = dy * cxs
        u = radius * ax + c2
        v = sy + c3
        # s.y/d.y == cos(ax) analytically; the literal division is 0/0 at
        # the exact center row (odd heights) — use the limit value
        jac = (1.0 / (1.0 + dxr * dxr), np.zeros_like(dx),
               -dxr * sy * cxs * cxs / radius,
               np.where(np.abs(dy) < 1e-10, cxs, sy /
                        np.where(np.abs(dy) < 1e-10, 1.0, dy)))
        return sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac,
                                        background, vp)
    # plane2cylinder with horizon validity blend (distort.c:2746)
    validity = (radius * math.pi / 2.0 - np.abs(dx)) / 1.0 + 0.5
    dxr = dx / radius
    cos_r = np.cos(dxr)
    cxs = 1.0 / np.where(np.abs(cos_r) < 1e-12, 1e-12, cos_r)
    u = radius * np.tan(dxr) + c2
    v = dy * cxs + c3
    jac = (cxs * cxs, np.zeros_like(dx),
           dy * cxs * cxs / radius, cxs)
    out = sample_ewa_reference_var(img, u - 0.5, v - 0.5, jac, background, vp)
    return _blend_invalid(out, validity, img.shape[-1], img.dtype)


def _round_half_even(x: float) -> float:
    """MagickRound rounds half away from zero (magick-type.h)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def _round_half_away_np(x):
    """Vectorized MagickRound: half rounds away from zero (not to even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def sparse_color(img: torch.Tensor, method: str,
                 points: Sequence[Tuple[float, float, Sequence[float]]],
                 ) -> torch.Tensor:
    """SparseColorImage (distort.c SparseColorImage): interpolate scattered
    color samples over the canvas; an (H, W, C) result on the image's
    device, as the JAX function returns.

    methods: shepards (inverse-distance²), voronoi (nearest point),
    inverse (1/d), barycentric (least-squares plane per channel),
    bilinear (plane + xy term).
    """
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    yy, xx = _grid(h, w, img.dtype, dev)
    c = img.shape[-1]
    px_np = np.asarray([p[0] for p in points], np.float32)
    py_np = np.asarray([p[1] for p in points], np.float32)
    pc_np = np.asarray([list(p[2])[:c] + [1.0] * max(0, c - len(p[2]))
                        for p in points], np.float32)  # (N, C)
    m = method.lower()
    if m in ("barycentric", "bilinear"):
        n = len(points)
        cols = [np.ones(n), px_np, py_np]
        if m == "bilinear":
            cols.append(px_np * py_np)
        A = np.stack(cols, 1)
        outs = []
        for ch in range(c):
            coef, *_ = np.linalg.lstsq(A, pc_np[:, ch], rcond=None)
            val = float(coef[0]) + float(coef[1]) * xx + float(coef[2]) * yy
            if m == "bilinear":
                val = val + float(coef[3]) * xx * yy
            outs.append(val)
        return torch.clamp(torch.stack(outs, -1), 0.0, 1.0)
    pts = torch.from_numpy(np.stack([px_np, py_np])).to(dev)
    ex = xx[..., None] - pts[0]
    ey = yy[..., None] - pts[1]
    d2 = ex * ex + ey * ey                                 # (H, W, N)
    pc = torch.from_numpy(pc_np).to(dev)
    if m == "voronoi":
        return pc[torch.argmin(d2, dim=-1)]
    if m in ("shepards", "shepard"):
        wgt = 1.0 / torch.clamp(d2, min=1e-6)
    elif m == "inverse":
        wgt = 1.0 / torch.clamp(_f64(torch.sqrt, d2), min=1e-6)
    else:
        raise ValueError(f"unknown sparse-color method {method!r}")
    wsum = torch.sum(wgt, dim=-1, keepdim=True)
    out = torch.einsum("hwn,nc->hwc", wgt / wsum, pc)
    return torch.clamp(out, 0.0, 1.0)


def liquid_rescale(img: torch.Tensor, width: int, height: int,
                   delta_x: float = 1.0, rigidity: float = 0.0
                   ) -> torch.Tensor:
    """LiquidRescaleImage (resize.c via liblqr): content-aware seam carving.

    Vertical seams are removed one at a time.  Per seam, the minimal-energy
    path is a DP over the rows, run on the device as a row loop (the JAX
    ``lax.scan``), and its backtrack likewise; removal is a gather.  A
    batch (N, H, W, C) carves each image along its own seams in the same
    loops (the JAX function raises there: its scan runs over the batch
    axis).  The backtrack keeps the JAX function's seam rows: row y takes
    the column chosen from row y + 1's sums, the last two rows the
    column of the bottom row's minimum.  Width reduction only carves
    columns; expansion falls back to resize (as does height, matching
    common usage; liblqr does the same transposed).
    """
    from .blur import _depthwise_conv
    from .resize import resize as rz_resize

    h, w, c = img.shape[-3:]
    n_remove = w - width
    if n_remove <= 0 or width <= 2:
        return rz_resize(img, height, width)

    lead = img.shape[:-3]
    x = img.reshape((-1, h, w, c))
    n = x.shape[0]
    dev = img.device
    sobel = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    big = 1e9
    nc = torch.full((), float(c), dtype=img.dtype, device=dev)

    def energy(x):
        # the channel mean in XLA's order, a true division on every device
        s = x[..., 0]
        for k in range(1, c):
            s = s + x[..., k]
        gray = (s / nc)[..., None]
        gx = _depthwise_conv(gray, sobel, "edge")
        gy = _depthwise_conv(gray, sobel.T, "edge")
        return gx[..., 0].abs() + gy[..., 0].abs()

    col_idx = torch.arange(w, device=dev)
    offs = torch.tensor([-1, 0, 1], device=dev)
    rows = torch.arange(n, device=dev)
    out = x
    cur = w
    for _ in range(n_remove):
        e = torch.where(col_idx < cur, energy(out), big)    # (n, h, w)
        cums = torch.empty_like(e)
        prev = e[:, 0]
        cums[:, 0] = prev
        for y in range(1, h):
            left = F.pad(prev[:, :-1], (1, 0), value=big)
            right = F.pad(prev[:, 1:], (0, 1), value=big)
            prev = e[:, y] + torch.minimum(prev, torch.minimum(left, right))
            cums[:, y] = prev
        # backtrack from the bottom, row by row
        j = torch.argmin(cums[:, h - 1], dim=-1)            # (n,)
        seam = torch.empty((n, h), dtype=torch.int64, device=dev)
        seam[:, h - 1] = j
        if h > 1:
            seam[:, h - 2] = j
        for t in range(1, h - 1):
            cum_row = cums[:, h - 1 - t]
            cand = cum_row[rows[:, None], (j[:, None] + offs).clamp(0, w - 1)]
            off = torch.argmin(cand, dim=-1) - 1 + (j == 0)
            j = (j + off).clamp(0, w - 1)
            seam[:, h - 2 - t] = j
        # remove the seam: each row gathers its columns, skipping seam[y]
        take = (col_idx + (col_idx >= seam[..., None])).clamp(0, w - 1)
        out = torch.gather(out, 2, take[..., None].expand(n, h, w, c))
        cur -= 1
    out = out[..., :width, :].reshape(lead + (h, width, c))
    if height != h:
        out = rz_resize(out, height, width)
    return out


def _radial_setup(h, w, dtype, device=None):
    """Shared swirl/implode geometry (visual-effects.c): elliptical
    aspect correction via per-axis scale, radius = the LARGER half-dim,
    deltas in scaled pixel units around center = 0.5*(W, H)."""
    cy, cx = 0.5 * h, 0.5 * w
    scale_x = scale_y = 1.0
    if w > h:
        scale_y = w / h
    elif w < h:
        scale_x = h / w
    radius = max(cx, cy)
    yy, xx = _grid(h, w, dtype, device)
    dx = scale_x * (xx - cx)
    dy = scale_y * (yy - cy)
    dist = dx * dx + dy * dy
    return cx, cy, scale_x, scale_y, radius, xx, yy, dx, dy, dist


def swirl(img: torch.Tensor, degrees: float,
          background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """SwirlImage (visual-effects.c): rotate by angle scaled with radius.

    factor = 1 - sqrt(dist)/radius inside the ellipse (dist < radius^2),
    rotation angle = radians(degrees) * factor^2; pixels outside copy."""
    h, w = img.shape[-3], img.shape[-2]
    cx, cy, sx, sy, radius, xx, yy, dx, dy, dist = _radial_setup(
        h, w, img.dtype, img.device)
    inside = dist < radius * radius
    factor = 1.0 - _div(_f64(torch.sqrt, dist), radius)
    t = math.radians(degrees) * factor * factor
    ct, st = _f64(torch.cos, t), _f64(torch.sin, t)
    u = torch.where(inside, _div(ct * dx - st * dy, sx) + cx, xx)
    v = torch.where(inside, _div(st * dx + ct * dy, sy) + cy, yy)
    return sample_bilinear(img, u, v, background)


def implode(img: torch.Tensor, amount: float,
            background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """ImplodeImage (visual-effects.c): radial pull toward the center.

    factor = sin(pi * sqrt(dist)/radius / 2)^(-amount) for 0 < dist <
    radius^2 (1 at the exact center); pixels outside the ellipse copy."""
    h, w = img.shape[-3], img.shape[-2]
    cx, cy, sx, sy, radius, xx, yy, dx, dy, dist = _radial_setup(
        h, w, img.dtype, img.device)
    inside = dist < radius * radius
    r = _div(_f64(torch.sqrt, torch.clamp(dist, min=0.0)), radius)
    s = _f64(torch.sin, 0.5 * math.pi * r)
    factor = torch.where(dist > 0.0,
                         _f64(torch.pow, torch.clamp(s, min=1e-30), -amount),
                         1.0)
    u = torch.where(inside, _div(factor * dx, sx) + cx, xx)
    v = torch.where(inside, _div(factor * dy, sy) + cy, yy)
    return sample_bilinear(img, u, v, background)


def wave(img: torch.Tensor, amplitude: float = 25.0,
         wavelength: float = 150.0,
         background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """WaveImage (visual-effects.c): sinusoidal vertical displacement.

    The canvas GROWS to H + 2|A| rows and output (x, y) samples the
    source at (x, y - (|A| + A sin(2pi x / lambda))) — oracle-checked
    canvas semantics."""
    h, w = img.shape[-3], img.shape[-2]
    out_h = int(h + 2.0 * abs(amplitude))
    yy, xx = _grid(out_h, w, img.dtype, img.device)
    sine = abs(amplitude) + amplitude * _f64(
        torch.sin, _div(2.0 * math.pi * xx, max(wavelength, 1e-6)))
    v = yy - sine
    return sample_bilinear(img, xx, v, background)
