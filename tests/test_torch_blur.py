"""Port parity: imagemagick_tpu_torch.ops.blur against the JAX package.

Kernel widths and tables are numpy copies (equal).  Blurs run in float32
on both sides: atol 1e-5 for whole ops (clip included), 1e-6 for the
separable passes alone (at most 33 taps summed in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import blur as jbl
from imagemagick_tpu_torch.ops import blur as tbl
from imagemagick_tpu_torch.ops import gpu_kernels as gk


@pytest.mark.parametrize("radius,sigma", [
    (0.0, 0.5), (0.0, 1.0), (0.0, 2.0), (0.0, 3.7), (1.5, 1.0), (0.0, 0.0),
])
def test_kernel_widths_and_tables_equal(radius, sigma):
    assert tbl.optimal_kernel_width_1d(radius, sigma) == \
        jbl.optimal_kernel_width_1d(radius, sigma)
    assert tbl.optimal_kernel_width_2d(radius, sigma) == \
        jbl.optimal_kernel_width_2d(radius, sigma)
    assert np.array_equal(tbl.gaussian_kernel_1d(radius, sigma),
                          jbl.gaussian_kernel_1d(radius, sigma))


def _image(shape, seed=5):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("op", ["gaussian_blur", "blur"])
@pytest.mark.parametrize("sigma,shape", [
    (1.0, (2, 24, 32, 3)),
    (2.0, (2, 24, 32, 3)),
    (2.0, (24, 32, 1)),       # unbatched
    (8.0, (1, 40, 48, 3)),    # over 33 taps: the plain two-pass path
])
def test_blur_ops_match(op, sigma, shape):
    x = _image(shape)
    ref = np.asarray(getattr(jbl, op)(jnp.asarray(x), 0.0, sigma))
    got = getattr(tbl, op)(torch.from_numpy(x), 0.0, sigma).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("ntaps,sigma", [(3, 0.6), (15, 2.0), (33, 5.0)])
def test_separable_blur_plain_matches_depthwise_passes(ntaps, sigma):
    """K3's plain version == the JAX package's CPU path of
    `_separable_conv` (the two `_depthwise_conv` passes)."""
    j = ntaps // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    x = _image((2, 37, 45, 3))
    ref = jbl._depthwise_conv(jnp.asarray(x), k.reshape(1, -1), "edge")
    ref = np.asarray(jbl._depthwise_conv(ref, k.reshape(-1, 1), "edge"))
    got = gk._separable_blur_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the CPU wrapper takes the plain version and launches nothing
    before = dict(gk.LAUNCHES)
    np.testing.assert_array_equal(
        gk.separable_blur(torch.from_numpy(x), k).numpy(), got)
    assert gk.LAUNCHES == before


@pytest.mark.parametrize("vp", ["edge", "mirror", "tile", "black"])
def test_convolve_matches(vp):
    kern = np.array([[0.0, 1.0, 0.0], [1.0, 4.0, 1.0], [0.0, 1.0, 0.0]])
    x = _image((2, 20, 26, 3))
    ref = np.asarray(jbl.convolve(jnp.asarray(x), kern, 0.01, True, vp))
    got = tbl.convolve(torch.from_numpy(x), kern, 0.01, True, vp).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("threshold", [0.05, 0.0])
@pytest.mark.parametrize("radius,sigma,gain,shape", [
    (0.0, 1.0, 1.0, (2, 24, 32, 3)),
    (0.0, 0.5, 0.7, (24, 32, 1)),       # unbatched
    (2.0, 1.5, 2.0, (1, 40, 48, 3)),
])
def test_unsharp_mask_matches(threshold, radius, sigma, gain, shape):
    """UnsharpMaskImage with the reference's threshold semantics.  Pixels
    whose |2 diff| lies within 1e-5 of the threshold are left out: the
    two sides' blurs differ in the last bits and may pick either branch."""
    x = _image(shape, seed=17)
    ref = np.asarray(jbl.unsharp_mask(jnp.asarray(x), radius, sigma, gain,
                                      threshold))
    got = tbl.unsharp_mask(torch.from_numpy(x), radius, sigma, gain,
                           threshold).numpy()
    assert got.shape == ref.shape
    diff = x - tbl.blur(torch.from_numpy(x), radius, sigma).numpy()
    keep = np.abs(np.abs(2.0 * diff) - threshold) > 1e-5
    assert keep.mean() > 0.9
    if threshold:
        assert (np.abs(2.0 * diff) < threshold).any()
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)


def test_image_unsharp_mask_runs_k3_plain():
    """``Image.unsharp_mask`` blurs through `_separable_conv` (K3 on a
    card); on the CPU its wrapper takes the plain version."""
    from imagemagick_tpu.core.image import Image as JImage
    from imagemagick_tpu_torch import Image

    x = _image((2, 20, 26, 3), seed=18)
    before = dict(gk.LAUNCHES)
    got = Image(torch.from_numpy(x)).unsharp_mask(0.0, 1.0).to_numpy()
    ref = np.asarray(JImage(jnp.asarray(x)).unsharp_mask(0.0, 1.0).data)
    diff = x - tbl.blur(torch.from_numpy(x), 0.0, 1.0).numpy()
    keep = np.abs(np.abs(2.0 * diff) - 0.05) > 1e-5
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)
    assert gk.LAUNCHES == before


# -- blur's effects ------------------------------------------------------
# Each effect on the same seeded inputs through both packages.  Sums of
# the same taps in the same order (the shift-and-add convolutions, the
# tap loops) agree to a few ulps; XLA's and PyTorch's grouped convolutions
# (kernels over 49 taps) and K3's plain passes within 1e-6.  The bound is
# atol 1e-5 on values in [0, 1] (the unclamped adaptive pair's too).
# Where an effect selects (the adaptive level, the rotational and spread
# samples, the bilateral intensity byte, despeckle's compares), the
# selection is made from equal values on both sides here, so the bound
# holds on every pixel.  Kuwahara's quadrant comes from variances of box
# means, which XLA's and PyTorch's convolutions sum in other orders: a
# pixel whose two smallest variances lie within 1e-6 may take the other
# quadrant (at most 1 % of the pixels); the bound holds on the rest.

EFFECT_VPS = ["edge", "mirror", "tile", "black", "white", "gray"]

EFFECTS = [
    ("sharpen", (0.0, 1.0), {}),            # 9x9: the grouped convolution
    ("sharpen", (0.0, 0.5), {}),            # 5x5: shifted slices
    ("adaptive_blur", (0.0, 2.0), {}),
    ("adaptive_blur", (1.0, 1.0), {}),
    ("adaptive_sharpen", (0.0, 1.0), {}),
    ("adaptive_sharpen", (0.0, 2.0), {}),
    ("emboss", (1.0, 1.0), {}),
    ("emboss", (0.0, 0.7), {}),
    ("motion_blur", (0.0, 3.0, 45.0), {}),
    ("motion_blur", (2.0, 1.0, 200.0), {}),
    ("selective_blur", (0.0, 1.0, 0.1), {}),
    ("selective_blur", (2.0, 1.0, 0.3), {}),
    ("shade", (30.0, 30.0), {}),
    ("shade", (120.0, 45.0, False), {}),
    ("kuwahara", (3.0,), {}),
    ("kuwahara", (1.0, 0.6), {}),
    ("bilateral_blur", (5, 5), {}),
    ("bilateral_blur", (4, 3, 10.0, 1.5), {}),
    ("local_contrast", (), {}),             # 41 taps: the plain passes
    ("local_contrast", (4.0, 30.0), {}),    # 17 taps: K3's plain version
]


def _effect_pair(name, args, kw, x):
    ref = np.asarray(getattr(jbl, name)(jnp.asarray(x), *args, **kw))
    got = getattr(tbl, name)(torch.from_numpy(x), *args, **kw).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    return got, ref


@pytest.mark.parametrize("vp", EFFECT_VPS)
@pytest.mark.parametrize("name,args,kw", EFFECTS,
                         ids=[f"{n}{a}" for n, a, _ in EFFECTS])
def test_effects_match(name, args, kw, vp):
    kw = dict(kw, virtual_pixel=vp)
    x = _image((2, 24, 32, 3), seed=21)
    got, ref = _effect_pair(name, args, kw, x)
    if name == "kuwahara":
        g = tbl.blur(torch.from_numpy(x), args[0],
                     args[1] if len(args) > 1 else max(args[0] - 0.5, 0.1),
                     vp)
        v = np.sort(tbl._kuwahara_variances(g, args[0]).numpy(), 0)
        flipped = np.abs(got - ref).max(-1) > 1e-5
        assert flipped.mean() <= 0.01
        assert ((v[1] - v[0])[flipped] <= 1e-6).all()
        got, ref = got[~flipped], ref[~flipped]
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("rotational_blur", (10.0,)), ("rotational_blur", (90.0,)),
    ("rotational_blur", (-35.0,)), ("despeckle", ())])
@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (25, 33, 1)])
def test_effects_without_virtual_pixel_match(name, args, shape):
    """rotational_blur samples edge-clamped, despeckle pads with zeros;
    on 8-bit pixels despeckle's compares are exact and it is bit-exact."""
    x = _image(shape, seed=22)
    if name == "despeckle":
        x = np.round(x * 255.0).astype(np.float32) / np.float32(255.0)
    got, ref = _effect_pair(name, args, {}, x)
    if name == "despeckle":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (20, 30, 1),
                                   (1, 20, 30, 4)])
def test_effects_on_other_shapes_match(shape):
    x = _image(shape, seed=23)
    for name, args, kw in EFFECTS[::3]:
        got, ref = _effect_pair(name, args, kw, x)
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("radius", [1.0, 2.5])
def test_spread_through_jax_offsets(radius):
    """``spread_at`` fed the JAX function's own offsets (the same key
    split and uniforms) equals the JAX ``spread`` on every value."""
    import jax

    x = _image((2, 24, 32, 3), seed=24)
    key = jax.random.PRNGKey(7)
    kx, ky = jax.random.split(key)
    oy = np.asarray(jax.random.uniform(ky, x.shape[:-1], minval=-radius,
                                       maxval=radius))
    ox = np.asarray(jax.random.uniform(kx, x.shape[:-1], minval=-radius,
                                       maxval=radius))
    ref = np.asarray(jbl.spread(jnp.asarray(x), radius, key))
    got = tbl.spread_at(torch.from_numpy(x), torch.from_numpy(oy),
                        torch.from_numpy(ox)).numpy()
    assert np.array_equal(got, ref)


def test_spread_draws_from_its_generator():
    """The same seed gives the same output; every output pixel is an
    input pixel of its own image within the radius; without a generator
    the draw is seeded 0."""
    x = torch.from_numpy(_image((2, 24, 32, 3), seed=25))
    a = tbl.spread(x, 2.0, torch.Generator().manual_seed(3))
    b = tbl.spread(x, 2.0, torch.Generator().manual_seed(3))
    c = tbl.spread(x, 2.0, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(tbl.spread(x, 2.0),
                       tbl.spread(x, 2.0, torch.Generator().manual_seed(0)))
    oy, ox = tbl.spread_offsets(x, 2.0, torch.Generator().manual_seed(3))
    assert oy.shape == ox.shape == x.shape[:-1]
    assert float(oy.abs().max()) <= 2.0 and float(ox.abs().max()) <= 2.0
    assert torch.equal(a, tbl.spread_at(x, oy, ox))


def test_adaptive_level_is_batch_coupled():
    """The adaptive pair auto-levels the edge map with ONE min and max
    over the whole input, a batch included (the JAX function does too):
    image 0 alone differs from image 0 in a batch, on both sides."""
    x = _image((2, 24, 32, 3), seed=26)
    x[0] *= 0.3                  # a narrower edge range than image 1's
    for name in ("adaptive_blur", "adaptive_sharpen"):
        t_batch = getattr(tbl, name)(torch.from_numpy(x), 0.0, 2.0)[0]
        t_alone = getattr(tbl, name)(torch.from_numpy(x[:1]), 0.0, 2.0)[0]
        j_batch = np.asarray(getattr(jbl, name)(jnp.asarray(x), 0.0, 2.0))
        j_alone = np.asarray(getattr(jbl, name)(jnp.asarray(x[:1]), 0.0,
                                                2.0))
        assert float((t_batch - t_alone).abs().max()) > 1e-3
        assert np.abs(j_batch[0] - j_alone[0]).max() > 1e-3
        np.testing.assert_allclose(t_batch.numpy(), j_batch[0], atol=1e-5)
        np.testing.assert_allclose(t_alone.numpy(), j_alone[0], atol=1e-5)


@pytest.mark.parametrize("name,args,calls", [
    ("adaptive_blur", (0.0, 2.0), 1), ("adaptive_sharpen", (0.0, 1.0), 1),
    ("kuwahara", (3.0,), 1), ("local_contrast", (4.0,), 1),
    ("local_contrast", (), 0), ("sharpen", (0.0, 1.0), 0)])
def test_effects_reach_k3_where_the_jax_ones_do(monkeypatch, name, args,
                                                 calls):
    """The adaptive pair's edge-map blur, Kuwahara's pre-blur and
    local_contrast's blur up to 33 taps go through ``separable_blur``
    (K3 on a card; its plain version here, launching nothing)."""
    seen = []
    orig = gk.separable_blur
    monkeypatch.setattr(gk, "separable_blur",
                        lambda x, t: seen.append(len(t)) or orig(x, t))
    before = dict(gk.LAUNCHES)
    getattr(tbl, name)(torch.from_numpy(_image((2, 20, 26, 3), seed=27)),
                       *args)
    assert len(seen) == calls
    assert gk.LAUNCHES == before


def test_image_sharpen_matches():
    from imagemagick_tpu.core.image import Image as JImage
    from imagemagick_tpu_torch import Image

    x = _image((2, 20, 26, 3), seed=28)
    for r, s in ((0.0, 1.0), (2.0, 0.8)):
        got = Image(torch.from_numpy(x)).sharpen(r, s).to_numpy()
        ref = np.asarray(JImage(jnp.asarray(x)).sharpen(r, s).data)
        np.testing.assert_allclose(got, ref, atol=1e-5)
