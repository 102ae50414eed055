"""Config #2 (blur -> unsharp -> sRGB<->Lab): the port against the JAX package.

``fused_blur_unsharp_pipeline`` on a CPU tensor runs K2's plain version,
full float32.  The JAX function runs its Pallas kernel in the interpreter
with the bf16 three-pass split, about 1.5e-5 from float64, so the two
agree at max |d| <= 5e-5; the port alone is held at >= 105 dB and
max |d| <= 3e-5 against the float64 reference.  A spy on the JAX
planner's ``_build_call`` records the operands it hands the kernel, to
check the taps and which of its paths ran.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core.image import Image as JImage
from imagemagick_tpu.ops import fused_pipeline as jfp
import imagemagick_tpu_torch as it
from imagemagick_tpu_torch.ops import fused_pipeline as tfp
from imagemagick_tpu_torch.ops import gpu_kernels as gk


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture
def spy(monkeypatch):
    """Keyword arguments of every JAX ``_build_call`` made in the test."""
    calls = []
    original = jfp._build_call

    def record(*args, **kwargs):
        calls.append(kwargs)
        return original(*args, **kwargs)

    monkeypatch.setattr(jfp, "_build_call", record)
    return calls


@pytest.mark.parametrize("shape,lab,path", [
    ((2, 64, 128, 1), False, "banded"),       # W*C = 128: banded G
    ((2, 64, 128, 3), False, "hstencil"),     # W*C = 384 > 256
    ((2, 64, 128, 3), True, "hstencil"),
    ((1, 64, 512, 3), True, "colchunk"),      # 1536 lanes, 768-lane chunks
])
def test_fused_matches_jax_kernel(spy, shape, lab, path):
    N, H, W, C = shape
    x = _rand(shape, seed=sum(shape))
    ref = jfp.fused_blur_unsharp_pipeline(jnp.asarray(x), 2.0, 1.0, 1.0, C,
                                          TO=32, lab_roundtrip=lab,
                                          interpret=True)
    got = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                          1.0, C, lab_roundtrip=lab)
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)
    # the JAX path that ran, and the taps it was given
    (kw,) = spy
    assert ("hblur" in kw) == (path != "banded")
    assert ("col_chunk" in kw) == (path == "colchunk")
    assert (kw["chan_epilogue"] is not None) == lab
    blur, unsharp = tfp.blur_unsharp_taps(H, W, 2.0, 1.0)
    assert kw["unsharp"] == (unsharp, unsharp, 1.0, C)
    if path != "banded":
        assert kw["hblur"] == (blur, C)


@pytest.mark.parametrize("sigma_blur,sigma_unsharp,gain", [
    (2.0, 1.0, 1.0), (1.0, 0.5, 0.7), (3.0, 2.0, 1.5), (0.8, 1.3, 2.0),
])
def test_taps_equal_jax_planner(spy, sigma_blur, sigma_unsharp, gain):
    """``blur_unsharp_taps`` gives exactly the taps the JAX function hands
    ``_build_call``, and any image wider than the blur gives the same
    (so these widths stand for config #2's 1080 x 1920)."""
    x = _rand((1, 64, 128, 3), seed=3)
    jfp.fused_blur_unsharp_pipeline(jnp.asarray(x), sigma_blur,
                                    sigma_unsharp, gain, 3, TO=32,
                                    interpret=True)
    (kw,) = spy
    blur, unsharp = tfp.blur_unsharp_taps(64, 128, sigma_blur, sigma_unsharp)
    assert kw["unsharp"] == (unsharp, unsharp, gain, 3)
    assert kw["hblur"] == (blur, 3)
    assert tfp.blur_unsharp_taps(1080, 1920, sigma_blur,
                                 sigma_unsharp) == (blur, unsharp)


def test_config2_taps():
    blur, unsharp = tfp.blur_unsharp_taps(1080, 1920, 2.0, 1.0)
    assert len(blur) == 15 and len(unsharp) == 9
    # the unsharp taps are the float32 table of gaussian_kernel_1d
    assert abs(sum(blur) - 1.0) < 1e-12 and abs(sum(unsharp) - 1.0) < 1e-6
    assert blur == blur[::-1] and unsharp == unsharp[::-1]


@pytest.mark.parametrize("shape,lab", [
    ((2, 64, 128, 3), False), ((2, 64, 128, 3), True),
    ((1, 40, 256, 1), False), ((1, 24, 640, 3), True),
])
def test_fused_matches_float64(shape, lab):
    x = _rand(shape, seed=7)
    got = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                          1.0, shape[-1],
                                          lab_roundtrip=lab).numpy()
    ref = tfp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, lab)
    assert _psnr(got, ref) >= 105.0
    assert float(np.abs(got - ref).max()) <= 3e-5


def test_float64_reference_is_the_benchmarks_check():
    """The port's float64 reference composes the JAX package's own terms
    (``blur_unsharp_terms``, bit-equal) and its Lab math on the host."""
    for a, b in zip(tfp.blur_unsharp_terms(24, 40, 2.0, 1.0, 1.0),
                    jfp.blur_unsharp_terms(24, 40, 2.0, 1.0, 1.0)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    x = _rand((1, 24, 40, 3), seed=8)
    ref = tfp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, True)
    from imagemagick_tpu.ops import colorspace as jcs

    lin = tfp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, False)
    lab = np.asarray(jcs.convert(jcs.convert(jnp.asarray(lin, jnp.float32),
                                             "srgb", "lab"), "lab", "srgb"))
    np.testing.assert_allclose(ref, np.clip(lab, 0, 1), atol=5e-5)


@pytest.mark.parametrize("lab", [False, True])
def test_borders(lab):
    """The first and last 4 rows and columns alone: the unsharp blur reads
    z at clamped image coordinates.  A blur through the halo (z evaluated
    outside the image) differs there, by far more than the tolerance."""
    shape = (1, 16, 128, 3)
    x = _rand(shape, seed=9)
    got = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                          1.0, 3, lab_roundtrip=lab).numpy()
    ref = tfp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, lab)
    jax_out = np.asarray(jfp.fused_blur_unsharp_pipeline(
        jnp.asarray(x), 2.0, 1.0, 1.0, 3, TO=8, lab_roundtrip=lab,
        interpret=True))
    edges = [np.s_[:, :4], np.s_[:, -4:], np.s_[:, :, :4], np.s_[:, :, -4:]]
    for sl in edges:
        assert float(np.abs(got[sl] - ref[sl]).max()) <= 3e-5
        np.testing.assert_allclose(got[sl], jax_out[sl], atol=5e-5)
    # the trap: blur z through a halo of clamped x instead
    blur, unsharp = tfp.blur_unsharp_taps(16, 128, 2.0, 1.0)
    xt = torch.from_numpy(x).double()
    r = len(unsharp) // 2
    pad = torch.nn.functional.pad(xt.permute(0, 3, 1, 2), (r, r, r, r),
                                  mode="replicate").permute(0, 2, 3, 1)
    z = gk._separable_blur_plain(pad, blur)
    u = gk._separable_blur_plain(z, unsharp)[:, r:-r, r:-r]
    trap = (2.0 * z[:, r:-r, r:-r] - u).clamp(0, 1).numpy()
    lin = tfp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, False)
    assert float(np.abs(trap[:, 4:-4, 4:-4] - lin[:, 4:-4, 4:-4]).max()) \
        <= 1e-6
    assert all(float(np.abs(trap[sl] - lin[sl]).max()) > 1e-4
               for sl in edges)


def _jax_none(x, *args, **kw):
    return jfp.fused_blur_unsharp_pipeline(x, *args, interpret=True, **kw)


@pytest.mark.parametrize("case", [
    "float16", "flat_no_shape", "flat_channels", "nhwc_channels", "lanes",
    "rows", "even_taps", "radius_0", "radius_9", "lab_c1", "ndim",
])
def test_declines_where_jax_declines(case):
    x = _rand((2, 64, 128, 3), seed=10)
    args, kw = (2.0, 1.0, 1.0, 3), {}
    if case == "float16":
        x = x.astype(np.float16)
    elif case == "flat_no_shape":
        x = x.reshape(128, 384)
    elif case == "flat_channels":
        x, kw = x.reshape(128, 384), {"in_shape": (2, 64, 96, 4)}
    elif case == "nhwc_channels":
        args = (2.0, 1.0, 1.0, 1)
    elif case == "lanes":
        x = x[:, :, :100]
    elif case == "rows":
        x = x[:, :60]
    elif case == "even_taps":            # 9 unsharp taps clamp to 8 at H=8
        x = x[:, :8]
    elif case == "radius_0":             # sigma 0: a single unsharp tap
        args = (2.0, 0.0, 1.0, 3)
    elif case == "radius_9":             # 19 unsharp taps
        args = (2.0, 2.3, 1.0, 3)
    elif case == "lab_c1":
        x, args, kw = x[..., :1].copy(), (2.0, 1.0, 1.0, 1), \
            {"lab_roundtrip": True}
    elif case == "ndim":
        x = x[0]
    x = np.ascontiguousarray(x)
    assert _jax_none(jnp.asarray(x), *args, **kw) is None
    assert tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), *args,
                                           **kw) is None


def test_port_only_limits():
    """K2's limits, where the JAX function still runs (ROADMAP.md Queue 2,
    "A capability gap, not a rank"):
    a blur over 33 taps, more than 8 channels."""
    wide = torch.from_numpy(_rand((1, 64, 128, 3), seed=11))
    assert len(tfp.blur_unsharp_taps(64, 128, 5.0, 1.0)[0]) == 35
    assert tfp.fused_blur_unsharp_pipeline(wide, 5.0, 1.0, 1.0, 3) is None
    assert _jax_none(jnp.asarray(wide.numpy()), 5.0, 1.0, 1.0, 3,
                     TO=32) is not None
    many = torch.from_numpy(_rand((1, 32, 32, 16), seed=12))
    assert tfp.fused_blur_unsharp_pipeline(many, 2.0, 1.0, 1.0, 16) is None
    # narrower than the blur on both axes: no stencil to run
    assert tfp.blur_unsharp_taps(8, 8, 2.0, 1.0) is None


def test_flat_input_equals_nhwc_and_launches_nothing():
    x = _rand((2, 64, 128, 3), seed=13)
    before = dict(gk.LAUNCHES)
    out4 = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                           1.0, 3, lab_roundtrip=True)
    out2 = tfp.fused_blur_unsharp_pipeline(
        torch.from_numpy(x.reshape(128, 384)), 2.0, 1.0, 1.0, 3,
        in_shape=(2, 64, 128, 3), lab_roundtrip=True)
    np.testing.assert_array_equal(out2.numpy(), out4.numpy())
    assert gk.LAUNCHES == before


@pytest.mark.parametrize("lab", [False, True])
def test_plain_version_is_the_op_composition(lab):
    """K2's plain version: K3's plain blur twice, the unsharp mix and the
    colorspace module, as its wrapper takes it on the CPU."""
    x = _rand((1, 20, 30, 3), seed=14)
    blur, unsharp = tfp.blur_unsharp_taps(20, 30, 2.0, 1.0)
    got = tfp.blur_unsharp_kernel(torch.from_numpy(x), blur, unsharp, 0.6,
                                  lab)
    z = gk.separable_blur(torch.from_numpy(x), blur)
    u = gk.separable_blur(z, unsharp)
    want = (1.6 * z - 0.6 * u).clamp(0, 1)
    if lab:
        img = it.Image(want).transform_colorspace("lab") \
            .transform_colorspace("srgb")
        want = img.data.clamp(0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_slice_matches_jax_image_chain():
    """The op route against the JAX package's Image chain, and the fused
    route against the op route (threshold 0 makes them one function)."""
    rng = np.random.default_rng(15)
    yy, xx = np.mgrid[0:64, 0:128].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 7.0)[..., None] * np.cos(xx / 11.0)[..., None]
    x = np.clip(base + 0.08 * rng.standard_normal((2, 64, 128, 3)), 0, 1)
    x = x.astype(np.float32)
    before = dict(gk.LAUNCHES)
    ref = JImage(jnp.asarray(x)).gaussian_blur(0, 2).unsharp_mask(
        0, 1, 1.0, 0.0).transform_colorspace("lab") \
        .transform_colorspace("srgb")
    got = it.Image(torch.from_numpy(x)).gaussian_blur(0, 2).unsharp_mask(
        0, 1, 1.0, 0.0).transform_colorspace("lab") \
        .transform_colorspace("srgb")
    assert got.spec == it.ImageSpec("srgb") and ref.spec.colorspace == "srgb"
    np.testing.assert_allclose(got.to_numpy(), np.asarray(ref.data),
                               atol=5e-5)
    fused = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                            1.0, 3, lab_roundtrip=True)
    assert _psnr(fused.numpy(), got.to_numpy()) >= 60.0
    assert gk.LAUNCHES == before
