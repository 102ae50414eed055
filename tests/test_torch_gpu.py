"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test skips without a card.  On a machine with one, run
``python -m pytest tests/test_torch_gpu.py --noconftest -q`` (this file
imports neither JAX nor the JAX package, and the suite's conftest does).
Tolerances: K3 sums at most 33 float32 taps in another order (1e-5); K1
sums float32 products of depth up to SPAN in another order (2e-5).
"""

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch.ops import dispatch
from imagemagick_tpu_torch.ops import fused_pipeline as fp
from imagemagick_tpu_torch.ops import gpu_kernels as gk

GRAY = np.array([[0.212656, 0.715158, 0.072186]])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 and K3 run only there")
    return torch.device("cuda", 0)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _taps(n, sigma):
    j = n // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@pytest.mark.parametrize("shape,ntaps", [
    ((1, 1, 1, 1), 3), ((2, 37, 45, 3), 15), ((1, 100, 33, 4), 33),
    ((2, 31, 70, 8), 9), ((1, 5, 300, 2), 31), ((3, 64, 64, 3), 1),
])
def test_k3_matches_plain(dev, shape, ntaps):
    x = _rand(shape)
    k = _taps(ntaps, max(ntaps / 5.0, 0.5))
    before = gk.LAUNCHES["k3"]
    got = gk.separable_blur(torch.from_numpy(x).to(dev), k)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] == before + 1
    ref = gk.separable_blur(torch.from_numpy(x), k)          # plain, CPU
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


def test_k3_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 3), device=dev)
    for bad_x, k in ((x, _taps(35, 6.0)), (x, np.ones(4) / 4),
                     (x.double(), _taps(3, 1.0)),
                     (x.transpose(1, 2), _taps(3, 1.0))):
        with pytest.raises(ValueError):
            gk.separable_blur(bad_x, k)


@pytest.mark.parametrize("N,H,W,C,Hout,Wout,sigma,mix,TO", [
    (2, 64, 128, 3, 32, 32, 1.5, GRAY, 16),
    (3, 96, 256, 1, 40, 100, 1.0, None, 128),
    (1, 200, 384, 3, 57, 77, 2.5, None, 64),
])
def test_k1_matches_plain(dev, N, H, W, C, Hout, Wout, sigma, mix, TO):
    x = _rand((N, H, W, C), seed=1)
    before = gk.LAUNCHES["k1"]
    got = fp.fused_resize_pipeline(torch.from_numpy(x).to(dev), Hout, Wout,
                                   "lanczos", sigma, mix, TO=TO)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k1"] == before + 1
    ref = fp.fused_resize_pipeline(torch.from_numpy(x), Hout, Wout,
                                   "lanczos", sigma, mix, TO=TO)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_k1_two_terms_matches_plain(dev):
    """Rank-2 blur -> unsharp term list: two terms, deduplicated blocks."""
    Bv, Bw = fp.blur_band_matrix(64, 1.0), fp.blur_band_matrix(512, 1.0)
    Uv = fp.blur_band_matrix(64, 0.8, width_rule="1d")
    Uw = fp.blur_band_matrix(512, 0.8, width_rule="1d")
    terms = [(1.7 * Bv, Bw), (-0.7 * (Uv @ Bv), Uw @ Bw)]
    x = _rand((2, 64, 512, 1), seed=2)
    got = fp.fused_linear_pipeline(torch.from_numpy(x).to(dev), terms, 1,
                                   TO=32)
    ref = fp.fused_linear_pipeline(torch.from_numpy(x), terms, 1, TO=32)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_dispatch_unaligned_matches_plain(dev):
    x = _rand((70, 90, 3), seed=3)
    tags = [("resize", (40, 36, "lanczos")), ("gblur", (0.0, 1.5, "2d")),
            ("mix", ((0.212656, 0.715158, 0.072186),))]
    got, n = dispatch.try_fused_chain(torch.from_numpy(x).to(dev), tags)
    ref, _ = dispatch.try_fused_chain(torch.from_numpy(x), tags)
    assert n == 3 and got.shape == (40, 36, 1)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_k1_refuses_bad_operands(dev):
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = fp._plan(
        64, 128, 3, 32, 32, "lanczos", 1.0, ((1.0, 0.0, 0.0),), 16)
    ops = fp.plan_to_tensors(WV, GB, fp.flat_r0(r0s, 1, 64), dev)
    x = torch.zeros((64, 384), device=dev)
    guids = tuple(range(len(c0s)))
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops._replace(WV=ops.WV.double()), c0s, guids,
                        ntiles)
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops._replace(kr=ops.kr[..., :1].contiguous()),
                        c0s, guids, ntiles)
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops, (10_000,) * len(c0s), guids, ntiles)


def test_blur_beyond_k3_channels_takes_plain_path(dev):
    """More than 8 channels exceed K3's shared memory: the op runs the two
    plain passes on the card, as the TPU path declines past its budget."""
    from imagemagick_tpu_torch.ops import blur

    x = _rand((1, 20, 24, 10), seed=4)
    before = gk.LAUNCHES["k3"]
    got = blur.gaussian_blur(torch.from_numpy(x).to(dev), 0.0, 2.0)
    assert gk.LAUNCHES["k3"] == before
    ref = blur.gaussian_blur(torch.from_numpy(x), 0.0, 2.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)
