"""``ops/fourier.py``: the port against the JAX package, on the CPU.

Both sides get the same numpy inputs made from a seed, in each of the
transform modes "fft", "matmul" and "fourstep".  On the CPU both compute in
float32 (XLA's CPU matrix products are full float32), so spectra agree to
a relative 1e-5 of max|F| and images in [0, 1] at >= 120 dB.  Phase is
compared through the complex value it encodes (magnitude times
exp(i*phase)): where |F| is tiny its angle means nothing.  The port turns
(magnitude, phase) back into complex values with ``torch.polar``: on the
CPU, ``torch.cos`` of a float32 tensor comes out to about 12 bits in some
processes (``cpu_phase_probe.py`` counts them), which made
``test_inverse_fft_matches_jax[*-True-shape0]`` fall below 120 dB now
and then.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import fourier as jff
from imagemagick_tpu.ops import fourier_pallas as jfp
from imagemagick_tpu_torch.ops import fourier as tff
from imagemagick_tpu_torch.ops import fourier_kernels as fk

MODES = ["fft", "matmul", "fourstep"]
SPEC_REL = 1e-5
MIN_DB = 120.0


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _db(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.fixture(params=MODES)
def mode(request):
    """The same transform mode in both packages."""
    jff.set_fft_mode(request.param)
    tff.set_fft_mode(request.param)
    yield request.param
    jff.set_fft_mode("auto")
    tff.set_fft_mode("auto")


def _polar(mag, phase):
    return np.asarray(mag) * np.exp(2j * np.pi * (np.asarray(phase) - 0.5))


@pytest.mark.parametrize("shape", [(24, 40, 3), (40, 56, 3)])
@pytest.mark.parametrize("modulus", [True, False])
def test_forward_fft_matches_jax(mode, shape, modulus):
    img = _rand(shape, seed=11)
    ja, jb = jff.forward_fft(jnp.asarray(img), modulus=modulus)
    ta, tb = tff.forward_fft(torch.from_numpy(img), modulus=modulus)
    assert ta.shape == tb.shape == shape and ta.dtype == torch.float32
    if modulus:
        assert _rel(ta.numpy(), ja) <= SPEC_REL
        assert float(tb.min()) >= 0.0 and float(tb.max()) <= 1.0
        assert _rel(_polar(ta.numpy(), tb.numpy()), _polar(ja, jb)) <= SPEC_REL
    else:
        ref = np.asarray(ja) + 1j * np.asarray(jb)
        assert _rel(ta.numpy() + 1j * tb.numpy(), ref) <= SPEC_REL


@pytest.mark.parametrize("shape", [(24, 40, 3), (40, 56, 3)])
@pytest.mark.parametrize("modulus", [True, False])
def test_inverse_fft_matches_jax(mode, shape, modulus):
    img = _rand(shape, seed=24)
    a, b = (np.array(v) for v in jff.forward_fft(jnp.asarray(img),
                                                    modulus=modulus))
    ref = np.asarray(jff.inverse_fft(jnp.asarray(a), jnp.asarray(b),
                                     modulus=modulus))
    got = tff.inverse_fft(torch.from_numpy(a), torch.from_numpy(b),
                          modulus=modulus).numpy()
    assert got.shape == shape
    assert _db(got, ref) >= MIN_DB
    # the round trip reconstructs the image (test_fourier's >= 100 dB)
    ta, tb = tff.forward_fft(torch.from_numpy(img), modulus=modulus)
    assert _db(tff.inverse_fft(ta, tb, modulus=modulus).numpy(), img) >= 100


@pytest.mark.parametrize("shape", [(64, 96), (54, 40), (128, 128), (13, 17)])
def test_fft2_matches_numpy_and_jax(mode, shape):
    """Each mode's 2-D transform and its inverse; 13 x 17 (both prime)
    takes the dense fallback in the four-step mode."""
    x = _rand(shape, seed=21)
    ref = np.fft.fft2(x.astype(np.float64))
    got = tff._fft2(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= SPEC_REL
    assert _rel(got, jff._fft2(jnp.asarray(x))) <= SPEC_REL
    back = tff._ifft2(torch.from_numpy(got)).numpy()
    assert np.abs(back.real - x).max() < 1e-5
    assert np.abs(back.imag).max() < 1e-5


@pytest.mark.parametrize("shape", [(64, 96), (54, 40), (13, 17)])
def test_fourstep_fft2_matches_jax(shape):
    x = _rand(shape, seed=22)
    zr, zi = tff._fourstep_fft2(torch.from_numpy(x), None, inverse=False)
    jr, ji = jff._fourstep_fft2(jnp.asarray(x), None, inverse=False)
    ref = np.fft.fft2(x.astype(np.float64))
    assert _rel(zr.numpy() + 1j * zi.numpy(), ref) <= SPEC_REL
    assert _rel(zr.numpy() + 1j * zi.numpy(),
                np.asarray(jr) + 1j * np.asarray(ji)) <= SPEC_REL
    br, bi = tff._fourstep_fft2(zr, zi, inverse=True)
    assert np.abs(br.numpy() - x).max() < 1e-5
    assert np.abs(bi.numpy()).max() < 1e-5


@pytest.mark.parametrize("shape,noise", [
    ((32, 32, 1), 0.05), ((1, 48, 80, 1), 0.01), ((2, 24, 40, 3), 0.01),
    ((13, 17, 2), 0.02), ((1, 15, 20, 1), 0.01),
])
def test_wiener_matches_jax(mode, shape, noise):
    x = _rand(shape, seed=23)
    ref = np.asarray(jff.wiener_deconvolve(jnp.asarray(x), noise=noise))
    got = tff.wiener_deconvolve(torch.from_numpy(x), noise=noise)
    assert got.shape == shape and got.dtype == torch.float32
    assert _db(got.numpy(), ref) >= MIN_DB


def _psf_fft(h, w):
    """The spectrum of a normalized 5 x 5 Gaussian PSF centered at (0, 0)."""
    k = np.exp(-(np.arange(-2, 3) ** 2) / 2.0)
    psf = np.zeros((h, w))
    psf[np.ix_(np.arange(-2, 3) % h, np.arange(-2, 3) % w)] = np.outer(k, k)
    return np.fft.fft2(psf / psf.sum()).astype(np.complex64)


@pytest.mark.parametrize("shape", [(24, 40, 3), (2, 32, 48, 1), (13, 17, 1)])
def test_wiener_with_kernel_matches_jax(mode, shape):
    x = _rand(shape, seed=25)
    k = _psf_fft(*shape[-3:-1])
    ref = np.asarray(jff.wiener_deconvolve(jnp.asarray(x), jnp.asarray(k),
                                           noise=0.01))
    got = tff.wiener_deconvolve(torch.from_numpy(x), torch.from_numpy(k),
                                noise=0.01).numpy()
    assert _db(got, ref) >= MIN_DB


@pytest.mark.parametrize("op", [
    "add", "subtract", "multiply", "divide", "magnitude-phase",
    "real-imaginary", "conjugate", "MagnitudePhase",
])
def test_complex_images_matches_jax(op):
    rng = np.random.default_rng(31)
    a, b, c, d = (rng.uniform(-1, 1, (6, 7, 3)).astype(np.float32)
                  for _ in range(4))
    if op == "divide":
        c[0, 0], d[0, 0] = 0.0, 0.0      # the 1e-20 floor of the divisor
    if op.lower().replace("-", "") == "realimaginary":
        b = (b + 1) / 2                  # a phase in [0, 1]
    ref = jff.complex_images(*(jnp.asarray(v) for v in (a, b, c, d)), op)
    got = tff.complex_images(*(torch.from_numpy(v) for v in (a, b, c, d)), op)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_complex_images_refuses_unknown_operator():
    z = torch.zeros((2, 2, 1))
    with pytest.raises(ValueError):
        tff.complex_images(z, z, z, z, "modulo")


def test_mode_selection():
    with pytest.raises(ValueError):
        tff.set_fft_mode("fastest")
    assert tff.probe_fft()
    assert tff._resolve_mode(torch.device("cpu")) == "fft"
    # the four-step on a CUDA tensor, as the JAX package on its accelerator
    assert tff._resolve_mode(torch.device("cuda", 0)) == "fourstep"
    tff.set_fft_mode("matmul")
    try:
        assert tff._resolve_mode(torch.device("cuda", 0)) == "matmul"
    finally:
        tff.set_fft_mode("auto")


def _uncached(fn, *args):
    """Call an lru-cached table function without keeping its result."""
    return getattr(fn, "__wrapped__", fn)(*args)


@pytest.mark.parametrize("n", [13, 48, 72, 256, 384, 2160, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_tables_equal_jax_bit_for_bit(n, inverse):
    """The port's transform tables are the JAX package's numpy tables:
    an image pipeline carries no weights, these are its state."""
    for port_fn, jax_fn in ((tff._dft_mats_np, jff._dft_mats_np),
                            (tff._fourstep_consts, jff._fourstep_consts)):
        got = _uncached(port_fn, n, inverse)
        ref = _uncached(jax_fn, n, inverse)
        assert (got is None) == (ref is None) == (
            port_fn is not tff._dft_mats_np and n == 13)
        for g, r in zip(got or (), ref or ()):
            if isinstance(r, np.ndarray):
                assert g.dtype == r.dtype == np.float32
                np.testing.assert_array_equal(g, r)
            else:
                assert g == r
    assert fk._factor(n) == jfp._factor(n)
