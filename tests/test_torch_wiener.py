"""Kernels K6a, K6b and K6c (``ops/fourier_kernels.py``) on the CPU.

On a CPU tensor each wrapper runs its plain version: the kernels' radix
plan, root table and Stockham passes in FP32 (``_fft_rows``), for K6a
and K6c with their two-row packing, for K6b down the columns with the
mask between the two transforms.  Each stage is held against its
float64 numpy meaning (K6a the DFT along W, K6b the DFT along H -> Wiener
mask -> inverse DFT along H, K6c the clipped real part of the inverse DFT
along W): spectra to a relative 1e-5 of max|F|, K6c's [0, 1] output to
1e-6 (4e-6 where a generic pass sums 4093 terms).  The chain is held to
the JAX ``wiener_pallas`` in interpret mode at >= 100 dB (its bf16
three-pass products put it about 108 dB from float64), and to the JAX
four-step ``wiener_deconvolve`` and a float64 numpy Wiener at >= 120 dB.
Float64 numpy replays of the CUDA passes' index arithmetic (twiddles
read from ``_twiddles_on``), of K6a's and K6c's rows and of K6b's strips
of columns, are held to ``np.fft``.  K6b's wrapper is checked against its
C entry's signature with ``_build.load`` stubbed.
"""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import fourier as jff
from imagemagick_tpu.ops import fourier_pallas as jfp
from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import fourier_kernels as fk
from imagemagick_tpu_torch.ops import gpu_kernels as gk

# 48 = 6 x 8, 256 = 16 x 16, 72 = 8 x 9, 384 = 16 x 24, 45 = 5 x 9 and
# 102 = 6 x 17: n1 != n2, odd factors, a width that fills no 4-column chunk
SHAPES = [(2, 48, 256), (1, 72, 384), (3, 45, 102)]
SPEC_REL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _db(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def wiener_f64(x, noise):
    """The Wiener denoise of (P, H, W) planes in float64 numpy."""
    x = x.astype(np.float64)
    f = np.fft.fft2(x)
    p = np.abs(f) ** 2
    pmean = (x * x).sum(axis=(-2, -1), keepdims=True)
    return np.clip(np.fft.ifft2(f * p / (p + noise * pmean)).real, 0.0, 1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_w_forward_plain_is_the_dft_along_w(shape):
    x = _rand(shape, seed=1)
    got = fk.w_forward(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == shape
    assert _rel(got.numpy(), np.fft.fft(x.astype(np.float64), axis=-1)) \
        <= SPEC_REL


@pytest.mark.parametrize("shape", SHAPES)
def test_h_mask_plain_is_dft_mask_idft_along_h(shape):
    rng = np.random.default_rng(2)
    spec = np.fft.fft(rng.random(shape), axis=-1).astype(np.complex64)
    pmean = rng.uniform(50, 200, shape[0]).astype(np.float32)
    got = fk.h_mask(torch.from_numpy(spec), torch.from_numpy(pmean), 0.01)
    f = np.fft.fft(spec.astype(np.complex128), axis=-2)
    p = np.abs(f) ** 2
    ref = np.fft.ifft(f * p / (p + 0.01 * pmean[:, None, None]), axis=-2)
    assert got.dtype == torch.complex64 and got.shape == shape
    assert _rel(got.numpy(), ref) <= SPEC_REL


@pytest.mark.parametrize("shape", SHAPES)
def test_w_inverse_plain_is_the_clipped_real_idft_along_w(shape):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, shape)          # values on both clip sides
    g = np.fft.fft(x, axis=-1).astype(np.complex64)
    got = fk.w_inverse(torch.from_numpy(g))
    ref = np.clip(np.fft.ifft(g.astype(np.complex128), axis=-1).real, 0, 1)
    assert got.dtype == torch.float32 and got.shape == shape
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-6


@pytest.mark.parametrize("hw,noise", [((48, 256), 0.01), ((72, 384), 0.02)])
def test_chain_matches_jax_wiener_pallas(hw, noise):
    x = _rand(hw, seed=sum(hw))
    ref = np.asarray(jfp.wiener_pallas(jnp.asarray(x), noise,
                                       interpret=True))
    got = fk.wiener_kernel(torch.from_numpy(x[None]), noise)[0].numpy()
    assert _db(got, ref) >= 100.0
    # the JAX kernels' bf16 three-pass products lie further from float64
    ref64 = wiener_f64(x[None], noise)[0]
    assert _db(got, ref64) >= _db(ref, ref64) + 10.0


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_matches_jax_fourstep_and_float64(shape):
    x = _rand(shape, seed=4)
    got = fk.wiener_kernel(torch.from_numpy(x), 0.01).numpy()
    assert got.shape == shape and got.dtype == np.float32
    jff.set_fft_mode("fourstep")
    try:
        ref = np.asarray(jff.wiener_deconvolve(
            jnp.asarray(np.moveaxis(x, 0, -1)), noise=0.01))
    finally:
        jff.set_fft_mode("auto")
    assert _db(got, np.moveaxis(ref, -1, 0)) >= 120.0
    assert _db(got, wiener_f64(x, 0.01)) >= 120.0


def test_batched_call_equals_per_plane_calls():
    x = torch.from_numpy(_rand((4, 45, 102), seed=5))
    batched = fk.wiener_kernel(x, 0.01)
    for p in range(x.shape[0]):
        one = fk.wiener_kernel(x[p:p + 1].contiguous(), 0.01)
        np.testing.assert_allclose(batched[p].numpy(), one[0].numpy(),
                                   rtol=0, atol=1e-6)


def test_plain_versions_launch_nothing():
    before = dict(gk.LAUNCHES)
    fk.wiener_kernel(torch.from_numpy(_rand((1, 48, 256), seed=6)), 0.01)
    assert gk.LAUNCHES == before


@pytest.mark.parametrize("hw,ok", [
    ((2160, 4096), True), ((48, 256), True), ((72, 384), True),
    ((45, 102), True), ((8192, 8192), True),
    ((13, 256), False), ((48, 2161), False), ((2, 256), False),
    ((48, 8200), False), ((16384, 64), False),
])
def test_supported(hw, ok):
    """Prime extents have no four-step factorization; extents past
    MAX_EXTENT do not fit the kernels' shared memory."""
    assert fk.supported(*hw) is ok


# the widths of the radix plans: 8.8.8.8, 8.8.8.8.2, 8.8.2.3, 2.3.17,
# 4.5.7, 8.2.3.3.3.5, 2.4093 (a generic pass of a large prime) and 3.3.3.5
# (an odd width: the kernels' scalar row path)
WIDTHS = [4096, 8192, 384, 102, 140, 2160, 8186, 135]


def _k6c_tol(W):
    """K6c's absolute tolerance against float64: a generic pass of a
    prime p sums p float32 terms per output (p = 4093 at W = 8186)."""
    return 4e-6 if max(fk._radix_plan(W)) > 1000 else 1e-6


@pytest.mark.parametrize("n", WIDTHS)
def test_radix_plan_factors_n(n):
    plan = fk._radix_plan(n)
    assert math.prod(plan) == n and len(plan) <= fk.MAX_PASSES
    for r in plan:
        assert r in fk.RADICES or (r > 7 and all(r % d for d in range(2, r)))
    # radix 8 first, then 4 and 2, then 3, 5 and 7, then generic primes
    order = [fk.RADICES.index(r) if r in fk.RADICES else 6 + r for r in plan]
    assert order == sorted(order)


@pytest.mark.parametrize("n,plan", [
    (4096, (8, 8, 8, 8)), (384, (8, 8, 2, 3)), (140, (4, 5, 7)),
    (102, (2, 3, 17)), (8192, (8, 8, 8, 8, 2)), (8186, (2, 4093)),
])
def test_radix_plan_examples(n, plan):
    assert fk._radix_plan(n) == plan


@pytest.mark.parametrize("n", [102, 384, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_roots_are_float64_roots_in_float32(n, inverse):
    roots = fk._roots_on(n, inverse, torch.device("cpu")).numpy()
    ref = np.exp((2j if inverse else -2j) * np.pi * np.arange(n) / n)
    assert roots.dtype == np.float32 and roots.shape == (n, 2)
    # correctly rounded: within half an ulp of 1 of the float64 value
    assert np.abs(roots[:, 0] - ref.real).max() <= 2.0 ** -24
    assert np.abs(roots[:, 1] - ref.imag).max() <= 2.0 ** -24


def _kernel_passes(z, inverse):
    """A float64 numpy replay of ``fft_passes`` in csrc/wiener_fft.cu on
    the rows of z: butterfly j of a radix-r pass after passes of product
    ns reads z[j + q n/r], a pass with a butterfly of its own turns input
    q by ``_twiddles_on``'s entry (q - 1) ns + j mod ns, a generic pass
    takes root[(q e) mod n], and output k goes to
    (j - j mod ns) r + j mod ns + k ns."""
    n = z.shape[-1]
    cpu = torch.device("cpu")
    roots, tw = (t[:, 0].astype(np.float64) + 1j * t[:, 1] for t in (
        fk._roots_on(n, inverse, cpu).numpy(),
        fk._twiddles_on(n, inverse, cpu).numpy()))
    sign = 2j if inverse else -2j
    a, ns, t0 = z.astype(np.complex128), 1, 0
    for r in fk._radix_plan(n):
        m = n // r
        j = np.arange(m)
        j0 = j % ns
        q = np.arange(r)[:, None]
        v = a[..., j + q * m]                                  # (..., r, m)
        b = np.empty_like(a)
        if r in fk.RADICES:
            if ns > 1:
                v[..., 1:, :] *= tw[t0 + (q[1:] - 1) * ns + j0]
                t0 += (r - 1) * ns
            out = np.exp(sign * np.pi * q * q.T / r) @ v       # r-point DFT
        else:
            e = j0 * (n // (ns * r)) + q * m                   # (k, j)
            out = np.einsum("...qj,qkj->...kj", v, roots[(q[:, :, None] *
                                                          e) % n])
        for k in range(r):
            b[..., (j - j0) * r + j0 + k * ns] = out[..., k, :]
        a, ns = b, ns * r
    return a


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_passes_and_twiddle_layout_give_the_dft(n, inverse):
    rng = np.random.default_rng(n)
    z = rng.random((2, n)) + 1j * rng.random((2, n))
    ref = np.fft.ifft(z, axis=-1) * n if inverse else np.fft.fft(z, axis=-1)
    got = _kernel_passes(z, inverse)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-6


@pytest.mark.parametrize("W", WIDTHS)
def test_w_forward_plain_at_the_plan_widths_and_odd_rows(W):
    x = _rand((1, 3, W), seed=W)                  # three rows: one unpaired
    got = fk.w_forward(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (1, 3, W)
    assert _rel(got.numpy(), np.fft.fft(x.astype(np.float64), axis=-1)) \
        <= SPEC_REL


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("hermitian", [True, False])
def test_w_inverse_plain_at_the_plan_widths_and_odd_rows(W, hermitian):
    """Any g, Hermitian (a real row's spectrum, as K6b makes to rounding)
    or not: K6c computes clip(Re IDFT(g))."""
    rng = np.random.default_rng(W)
    u = rng.uniform(-0.2, 1.2, (1, 3, W))          # values on both clip sides
    if not hermitian:
        u = u + 1j * rng.uniform(-1, 1, u.shape)
    g = np.fft.fft(u, axis=-1).astype(np.complex64)
    got = fk.w_inverse(torch.from_numpy(g))
    ref = np.clip(np.fft.ifft(g.astype(np.complex128), axis=-1).real, 0, 1)
    assert got.dtype == torch.float32 and got.shape == (1, 3, W)
    assert float(np.abs(got.numpy() - ref).max()) <= _k6c_tol(W)


def test_row_kernels_round_trip_with_a_prime_row_count():
    x = torch.from_numpy(_rand((1, 7, 384), seed=9))
    np.testing.assert_allclose(
        fk.w_inverse(fk.w_forward(x)).numpy(), x.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,ok", [
    ((1, 7, 384), True), ((1, 1, 4), True), ((2, 13, 256), True),
    ((1, 7, 251), False), ((1, 7, 8200), False), ((1, 7, 2), False),
])
def test_row_kernels_check_only_w(shape, ok):
    """K6a and K6c transform rows: H may be prime; W must be composite
    and at most MAX_EXTENT."""
    x = torch.zeros(shape)
    if ok:
        fk._check_planes(x, torch.float32, "w_forward", rows_only=True)
    else:
        with pytest.raises(ValueError):
            fk._check_planes(x, torch.float32, "w_forward", rows_only=True)


# -- K6b: the radix passes down strips of columns -----------------------------

# H with the plan 8.2.3.3.3.5 (config #4), an odd H (3.3.3.5), a generic
# pass of 4093 (2.4093), the largest extent (8.8.8.8.2), one pass (4) and
# a strip of two columns (4096); W narrow, not a multiple of the strip
HEIGHTS = [(1, 2160, 6), (2, 135, 9), (1, 8186, 4), (1, 8192, 6),
           (3, 4, 6), (1, 4096, 10)]


def _h_mask_f64(spec, pmean, noise):
    f = np.fft.fft(spec.astype(np.complex128), axis=-2)
    p = np.abs(f) ** 2
    return np.fft.ifft(f * p / (p + noise * pmean[:, None, None]), axis=-2)


@pytest.mark.parametrize("shape", HEIGHTS)
def test_h_mask_plain_at_the_plan_heights(shape):
    rng = np.random.default_rng(shape[1])
    spec = np.fft.fft(rng.random(shape), axis=-1).astype(np.complex64)
    pmean = rng.uniform(50, 200, shape[0]).astype(np.float32)
    got = fk.h_mask(torch.from_numpy(spec), torch.from_numpy(pmean), 0.01)
    assert got.dtype == torch.complex64 and got.shape == shape
    assert _rel(got.numpy(), _h_mask_f64(spec, pmean, 0.01)) <= SPEC_REL


def _slot(e):
    return e + (e >> 4)


def _strip_columns(H):
    """The columns of K6b's strip: 4, or 2 or 1 where two padded buffers
    of 4 or 2 columns of H rows exceed a block's 232,448 bytes."""
    for cols in (4, 2):
        if 2 * _slot(H * cols) * 8 <= 232448:
            return cols
    return 1


def _strip_pass(load, store, n, cols, ns, r, tw, t0, roots, inverse):
    """One pass of ``one_pass`` in csrc/wiener_fft.cu over a strip of
    ``cols`` transforms, in float64, every butterfly (or, in a generic
    pass, every output) of every transform at once.  Returns the next
    pass's twiddle offset."""
    m = n // r
    if r in fk.RADICES:
        t = np.arange(m * cols)
        j, c = t // cols, t % cols
        j0 = j % ns
        q = np.arange(r)[:, None]
        v = np.stack([load(j + k * m, c) for k in range(r)])      # (r, T)
        if ns > 1:
            v[1:] *= tw[t0 + (q[1:] - 1) * ns + j0]
            t0 += (r - 1) * ns
        sign = 2j if inverse else -2j
        out = np.exp(sign * np.pi * q * q.T / r) @ v             # r-point DFT
        for k in range(r):
            store((j - j0) * r + j0 + k * ns, c, out[k])
        return t0
    t = np.arange(n * cols)
    o, c = t // cols, t % cols
    k, j = o // m, o % m
    j0 = j % ns
    e = j0 * (n // (ns * r)) + k * m
    acc = np.zeros(len(t), np.complex128)
    for q in range(r):
        acc += load(j + q * m, c) * roots[(q * e) % n]
    store((j - j0) * r + j0 + k * ns, c, acc)
    return t0


def _strip_replay(spec, pmean, noise):
    """A float64 numpy replay of ``h_mask_kernel``: each block's strip of
    columns c0 .. c0 + cols - 1, element (i, c) of the strip at
    slot(i cols + c) of two buffers; the first forward pass reads the
    plane (zeros past W), the first inverse pass loads F times the mask,
    the last one writes g / H for the columns inside W; twiddles and
    roots from the float32 tables of ``_twiddles_on`` and ``_roots_on``."""
    P, H, W = spec.shape
    cols = _strip_columns(H)
    plan = fk._radix_plan(H)
    cpu = torch.device("cpu")
    tabs = {}
    for inverse in (False, True):
        roots, tw = (t[:, 0].astype(np.float64) + 1j * t[:, 1] for t in (
            fk._roots_on(H, inverse, cpu).numpy(),
            fk._twiddles_on(H, inverse, cpu).numpy()))
        tabs[inverse] = roots, tw
    out = np.full(spec.shape, np.nan, np.complex128)
    size = _slot(H * cols)
    for plane in range(P):
        floor = noise * float(pmean[plane])
        for c0 in range(0, W, cols):
            inside = min(cols, W - c0)

            def read(i, c, c0=c0, inside=inside, plane=plane):
                ok = c < inside
                return np.where(ok, spec[plane, i, np.minimum(c0 + c, W - 1)],
                                0)

            def write(i, c, v, c0=c0, inside=inside, plane=plane):
                ok = c < inside
                assert np.isnan(out[plane, i[ok], c0 + c[ok]]).all()
                out[plane, i[ok], c0 + c[ok]] = v[ok] / H

            def loader(buf):
                return lambda i, c: buf[_slot(i * cols + c)]

            def storer(buf):
                def put(i, c, v):
                    idx = _slot(i * cols + c)
                    assert idx.max() < size and np.isnan(buf[idx]).all()
                    buf[idx] = v
                return put

            def masked(buf):
                def get(i, c):
                    f = buf[_slot(i * cols + c)]
                    p = np.abs(f) ** 2
                    return f * p / (p + floor)
                return get

            for inverse in (False, True):
                roots, tw = tabs[inverse]
                ns, t0 = 1, 0
                for s, r in enumerate(plan):
                    first, last = s == 0, s == len(plan) - 1
                    load = (read if not inverse else masked(a)) if first \
                        else loader(a)
                    b = np.full(size, np.nan, np.complex128)
                    store = write if inverse and last else storer(b)
                    t0 = _strip_pass(load, store, H, cols, ns, r, tw, t0,
                                     roots, inverse)
                    ns *= r
                    a = b
    return out


@pytest.mark.parametrize("shape", HEIGHTS)
def test_strip_replay_gives_dft_mask_idft(shape):
    rng = np.random.default_rng(shape[1] + 1)
    spec = np.fft.fft(rng.random(shape), axis=-1)
    pmean = rng.uniform(50, 200, shape[0])
    got = _strip_replay(spec, pmean, 0.01)
    assert not np.isnan(got).any()
    # the float32 roots of a generic pass of 4093 terms, both ways
    tol = 4e-6 if max(fk._radix_plan(shape[1])) > 1000 else 1e-6
    assert _rel(got, _h_mask_f64(spec, pmean, 0.01)) <= tol


class _FakeLib:
    def __init__(self):
        self.calls = []

    def k6b_h_mask(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("shape", [(1, 2160, 8), (2, 135, 9), (1, 8186, 4)])
def test_k6b_wrapper_passes_the_radix_tables(monkeypatch, shape):
    """K6b's card path with ``_build.load`` stubbed: the C entry gets the
    spectrum, pmean, the output, the H roots and twiddles of both
    directions on the spectrum's device, the plan in host memory and the
    shape, in ``_SIGNATURES`` order and types."""
    lib = _FakeLib()
    monkeypatch.setattr(fk, "on_card", lambda x: True)
    monkeypatch.setattr(fk, "stream_of", lambda x: 1234)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    P, H, W = shape
    spec = torch.zeros(shape, dtype=torch.complex64)
    pmean = torch.ones(P)
    before = gk.LAUNCHES["k6b"]
    out = fk.h_mask(spec, pmean, 0.25)
    assert gk.LAUNCHES["k6b"] == before + 1
    (args,) = lib.calls
    sig = _build._SIGNATURES["k6b_h_mask"]
    assert len(args) == len(sig) == 14
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is ctypes.c_float else int)
    (sp, pp, op, rf, tf, ri, ti, radices, P_, H_, W_, passes, noise,
     stream) = args
    cpu = torch.device("cpu")
    assert (sp, pp, op) == (spec.data_ptr(), pmean.data_ptr(),
                            out.data_ptr())
    assert (rf, tf, ri, ti) == (
        fk._roots_on(H, False, cpu).data_ptr(),
        fk._twiddles_on(H, False, cpu).data_ptr(),
        fk._roots_on(H, True, cpu).data_ptr(),
        fk._twiddles_on(H, True, cpu).data_ptr())
    assert (P_, H_, W_, passes, noise, stream) == (
        P, H, W, len(fk._radix_plan(H)), 0.25, 1234)
    got = np.ctypeslib.as_array((ctypes.c_int * passes).from_address(radices))
    assert tuple(got) == fk._radix_plan(H)
