"""Config #4 (4K Wiener FFT denoise): the port's slice against the JAX one.

``models.pipelines.fft_wiener()`` of both packages on the same numpy
batches, in the "auto" mode (``torch.fft`` / ``jnp.fft`` on the CPU) and
the four-step mode, at >= 120 dB: both sides transform in float32.  One
test keeps a fault of the JAX package visible: its ``wiener_deconvolve``
enters the fused Pallas kernels only for a 3-D (H, W, C) image, never for
the (N, H, W, C) batch that config #4 and ``fft_wiener`` hand it.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagemagick_tpu.models import pipelines as jpipe
from imagemagick_tpu.ops import fourier as jff
from imagemagick_tpu.ops import fourier_pallas as jfp
from imagemagick_tpu_torch.models import pipelines as tpipe
from imagemagick_tpu_torch.ops import fourier as tff
from imagemagick_tpu_torch.ops import fourier_kernels as fk


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _db(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


@pytest.fixture(params=["auto", "fourstep"])
def mode(request):
    jff.set_fft_mode(request.param)
    tff.set_fft_mode(request.param)
    yield request.param
    jff.set_fft_mode("auto")
    tff.set_fft_mode("auto")


@pytest.mark.parametrize("shape", [(2, 48, 256, 3), (1, 72, 384, 1)])
def test_fft_wiener_matches_jax(mode, shape):
    x = _rand(shape, seed=shape[1])
    ref = np.asarray(jpipe.fft_wiener()(jnp.asarray(x)))
    got = tpipe.fft_wiener()(torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    assert _db(got.numpy(), ref) >= 120.0
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_fft_wiener_is_the_kernel_chain_per_plane():
    """What the port runs on the card for a batch: K6 on every (channel,
    image) plane.  Its plain versions agree with the op route."""
    x = _rand((2, 48, 256, 3), seed=7)
    planes = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 0).reshape(-1, 48, 256)))
    chain = fk.wiener_kernel(planes, 0.01).reshape(3, 2, 48, 256)
    got = tpipe.fft_wiener()(torch.from_numpy(x))
    assert _db(torch.movedim(chain, 0, -1).numpy(), got.numpy()) >= 120.0


@pytest.fixture
def pallas_spy(monkeypatch):
    """Shapes given to the JAX ``wiener_pallas``, with the JAX package
    told it runs on a TPU and the kernels run in the interpreter."""
    calls = []
    original = jfp.wiener_pallas

    def record(x, noise, interpret=False):
        calls.append(tuple(x.shape))
        return original(x, noise, interpret=True)

    monkeypatch.setattr(jfp, "wiener_pallas", record)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jff.set_fft_mode("fourstep")
    yield calls
    jff.set_fft_mode("auto")


def test_jax_batch_never_enters_wiener_pallas(pallas_spy):
    """The JAX gate ``x.ndim == 3`` (x = the image, channels first) lets an
    (H, W, C) image through and turns every (N, H, W, C) batch, config
    #4's included, to the XLA four-step.  The port runs K6 on both."""
    img = _rand((48, 256, 1), seed=8)
    jff.wiener_deconvolve(jnp.asarray(img), noise=0.01)
    assert pallas_spy == [(48, 256)]
    jff.wiener_deconvolve(jnp.asarray(img[None]), noise=0.01)
    jpipe.fft_wiener()(jnp.asarray(img[None]))
    assert pallas_spy == [(48, 256)]
