"""Port parity: the fused pipeline (K1's planner, plain version and entries).

The planner is a numpy copy, so its operands are bit-equal to the JAX
package's.  The JAX kernel runs in the Pallas interpreter with its bf16
three-pass split (>= 100 dB from float64); the port's plain version is
full float32, so outputs agree at atol 2e-5."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import fused_pipeline as jfp
from imagemagick_tpu_torch.ops import fused_pipeline as tfp
from imagemagick_tpu_torch.ops import gpu_kernels as gk

GRAY = np.array([[0.212656, 0.715158, 0.072186]])
GRAY_KEY = tuple(map(tuple, GRAY.tolist()))
EYE3_KEY = tuple(map(tuple, np.eye(3).tolist()))


def _psnr(a, b):
    rms = float(np.sqrt(((np.asarray(a, np.float64) - b) ** 2).mean()))
    return 20 * math.log10(1.0 / max(rms, 1e-12))


@pytest.fixture
def batch():
    rng = np.random.default_rng(42)
    return rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)


@pytest.mark.parametrize("shape,mix_key,TO", [
    ((512, 768, 3, 256, 256, "lanczos", 2.0), GRAY_KEY, 64),   # config #1
    ((512, 768, 3, 256, 256, "lanczos", 2.0), GRAY_KEY, 128),
    ((88, 128, 3, 37, 53, "mitchell", 1.3), EYE3_KEY, 16),
    ((200, 256, 1, 71, 19, "triangle", 0.0), ((1.0,),), 32),
])
def test_planner_bit_equal(shape, mix_key, TO):
    Hin, Win, C, Hout, Wout, filt, sigma = shape
    jplan = jfp._plan(Hin, Win, C, Hout, Wout, filt, sigma, mix_key, TO)
    tplan = tfp._plan(Hin, Win, C, Hout, Wout, filt, sigma, mix_key, TO)
    for j, t in zip(jplan, tplan):
        assert np.array_equal(np.asarray(j), np.asarray(t))
    Mv = tfp._axis_operator(Hin, Hout, filt, sigma)
    Mw = tfp._axis_operator(Win, Wout, filt, sigma)
    assert np.array_equal(Mv, jfp._axis_operator(Hin, Hout, filt, sigma))
    for j, t in zip(jfp._v_blocks(Mv, Hin, TO), tfp._v_blocks(Mv, Hin, TO)):
        assert np.array_equal(np.asarray(j), np.asarray(t))
    mix = np.asarray(mix_key, np.float64)
    for j, t in zip(jfp._h_blocks(Mw, C, mix, Win * C),
                    tfp._h_blocks(Mw, C, mix, Win * C)):
        assert np.array_equal(np.asarray(j), np.asarray(t))


@pytest.mark.parametrize("sigma,mix", [(0.0, None), (1.5, GRAY),
                                       (1.5, None), (0.0, GRAY)])
def test_plain_matches_jax_kernel(batch, sigma, mix):
    ref = np.asarray(jfp.fused_resize_pipeline(
        jnp.asarray(batch), 32, 32, "lanczos", sigma, mix, interpret=True,
        TO=16))
    got = tfp.fused_resize_pipeline(torch.from_numpy(batch), 32, 32,
                                    "lanczos", sigma, mix, TO=16)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    f64 = tfp.reference_pipeline_f64(batch, 32, 32, "lanczos", sigma, mix)
    np.testing.assert_array_equal(
        f64, jfp.reference_pipeline_f64(batch, 32, 32, "lanczos", sigma, mix))
    assert _psnr(got.numpy(), f64) >= 100.0


def test_plain_on_jax_operands(batch):
    """The JAX package's own planner operands through plan_to_tensors."""
    n, h, w, c = batch.shape
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = jfp._plan(
        h, w, c, 32, 32, "lanczos", 1.5, GRAY_KEY, 16)
    ops = tfp.plan_to_tensors(WV, GB, tfp.flat_r0(r0s, n, h), "cpu")
    x2d = torch.from_numpy(batch.reshape(n * h, w * c))
    flat = tfp._fused_plain(x2d, ops, c0s, range(len(c0s)), ntiles)
    got = flat.reshape(n, ntiles * 16, OUTP)[:, :32, :OUT].numpy()
    ref = np.asarray(jfp.fused_resize_pipeline(
        jnp.asarray(batch), 32, 32, "lanczos", 1.5, GRAY, interpret=True,
        TO=16)).reshape(n, 32, OUT)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_flat_input_equals_nhwc(batch):
    n, h, w, c = batch.shape
    x = torch.from_numpy(batch)
    out4 = tfp.fused_resize_pipeline(x, 32, 32, "lanczos", 1.0, TO=16)
    out2 = tfp.fused_resize_pipeline(x.reshape(n * h, w * c), 32, 32,
                                     "lanczos", 1.0, TO=16,
                                     in_shape=(n, h, w, c))
    np.testing.assert_array_equal(out2.numpy(), out4.numpy())


def test_two_term_linear_pipeline(batch):
    """A rank-2 term list (blur then unsharp) with deduplicated G blocks."""
    terms = jfp.blur_unsharp_terms(64, 128, 1.0, 0.8, 0.7)
    ref = np.asarray(jfp.fused_linear_pipeline(
        jnp.asarray(batch), terms, 3, interpret=True, TO=16))
    got = tfp.fused_linear_pipeline(torch.from_numpy(batch), terms, 3,
                                    TO=16)
    assert got.shape == ref.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    # a convolutional G is block-Toeplitz: interior blocks share one id
    wide = jfp.blur_unsharp_terms(64, 1024, 1.0, 0.8, 0.7)
    plan = tfp.linear_plan(wide, 1, np.eye(1), 16, 64, 1024)
    assert len(plan.guids) == 2 * 8 and plan.GB.shape[0] < 16
    assert plan.guids[1] == plan.guids[2] == plan.guids[6]


def test_linear_pipeline_pad_align():
    """An unaligned NHWC input, zero-padded to the kernel's alignment."""
    from imagemagick_tpu_torch.ops.resize import resize_matrix

    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 30, 50, 3)).astype(np.float32)
    terms = [(resize_matrix(30, 12, "lanczos").T,
              resize_matrix(50, 20, "lanczos").T)]
    ref = np.asarray(jfp.fused_linear_pipeline(
        jnp.asarray(x), terms, 3, mix=GRAY, pad_align=True, interpret=True,
        TO=16))
    got = tfp.fused_linear_pipeline(torch.from_numpy(x), terms, 3, mix=GRAY,
                                    pad_align=True, TO=16)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    meta = torch.empty((2, 30, 50, 3), device="meta")
    assert tfp.fused_linear_pipeline(meta, terms, 3, pad_align=True,
                                     plan_only=True) is True
    assert tfp.fused_linear_pipeline(meta, terms, 3, plan_only=True) is None


def test_declines_bad_shapes(batch):
    x = torch.zeros((2, 64, 100, 3))                    # lanes not %128
    assert tfp.fused_resize_pipeline(x, 32, 32) is None
    xb = torch.from_numpy(batch)
    assert tfp.fused_resize_pipeline(xb, 128, 256) is None    # upscale
    assert tfp.fused_resize_pipeline(xb.reshape(128, 384), 32, 32) is None
    assert tfp.fused_resize_pipeline(xb.double(), 32, 32) is None
    with pytest.raises(ValueError):
        tfp.fused_resize_pipeline(xb.reshape(128, 384), 32, 32,
                                  in_shape=(2, 64, 64, 3))
    # and the JAX package declines the same shapes
    assert jfp.fused_resize_pipeline(jnp.zeros((2, 64, 100, 3)), 32, 32,
                                     interpret=True) is None


def test_cpu_wrapper_launches_nothing(batch):
    before = dict(gk.LAUNCHES)
    tfp.fused_resize_pipeline(torch.from_numpy(batch), 32, 32, TO=16)
    assert gk.LAUNCHES == before


@pytest.mark.parametrize("shape,mix_key,TO", [
    ((512, 768, 3, 256, 256, "lanczos", 2.0), GRAY_KEY, 64),   # config #1
    ((88, 128, 3, 37, 53, "mitchell", 1.3), EYE3_KEY, 16),
])
def test_depth_ranges_cover_every_nonzero(shape, mix_key, TO):
    """K1 stages each chunk of its output lanes over the chunk's depth
    range only: the range is aligned to the staged slice, inside SPAN,
    and every row outside it is zero."""
    *_, GB, c0s, SPAN, OUT, OUTP = tfp._plan(*shape, mix_key, TO)
    kr = tfp._depth_ranges(GB)
    lanes, chunks = tfp._LANES, 128 // tfp._LANES
    assert kr.shape == (GB.shape[0], chunks, 2)
    for g in range(GB.shape[0]):
        for q in range(chunks):
            lo, hi = kr[g, q]
            assert lo % tfp._SLICE == 0 and hi % tfp._SLICE == 0
            assert 0 <= lo <= hi <= SPAN
            chunk = GB[g, :, lanes * q:lanes * (q + 1)]
            assert not chunk[:lo].any() and not chunk[hi:].any()
    if shape[0] == 512:
        assert (kr[..., 1] - kr[..., 0]).sum() < 0.4 * kr.size // 2 * SPAN