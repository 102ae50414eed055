"""Port parity: spec, geometry, virtual-pixel pads and the Image class's
members against the JAX package.  The members slice, concatenate and
scale pixels by powers of ten and two, so they are held to equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core import geometry as jgeo
from imagemagick_tpu.core import spec as jspec
from imagemagick_tpu.core import virtual_pixel as jvp
from imagemagick_tpu.core.image import Image as JImage
from imagemagick_tpu_torch.core import geometry as tgeo
from imagemagick_tpu_torch.core import spec as tspec
from imagemagick_tpu_torch.core import virtual_pixel as tvp
from imagemagick_tpu_torch.core.image import Image as TImage


def test_spec_tables_equal():
    assert tspec.COLORSPACES == jspec.COLORSPACES
    for name in ("sRGB", "grey", "Linear-Gray", "CIELab", "cmyk", "YCbCr"):
        key = tspec.normalize_colorspace(name)
        assert key == jspec.normalize_colorspace(name)
        assert tspec.colorspace_channels(key) == \
            jspec.colorspace_channels(key)
        assert tspec.ImageSpec(key, alpha=True).astuple() == \
            jspec.ImageSpec(key, alpha=True).astuple()
    with pytest.raises(ValueError):
        tspec.normalize_colorspace("no-such-space")


@pytest.mark.parametrize("geometry", [
    "256x256", "256x256!", "50%", "x128", "128", "300x200^", "100x100>",
    "1000x1000<", "4096@", "120x80+5+7",
])
def test_parse_meta_geometry_equal(geometry):
    for w, h in ((768, 512), (64, 96)):
        assert tgeo.parse_meta_geometry(geometry, w, h) == \
            jgeo.parse_meta_geometry(geometry, w, h)


@pytest.mark.parametrize("method", ["edge", "mirror", "tile", "undefined",
                                    "black", "white", "gray", "background"])
def test_pad_spatial_matches(method):
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    bg = (0.25, 0.5, 0.75)
    pads = ((2, 9), (3, 1))       # wider than the axis: mirror/tile repeat
    ref = np.asarray(jvp.pad_spatial(jnp.asarray(x), *pads, method, bg))
    got = tvp.pad_spatial(torch.from_numpy(x), *pads, method, bg).numpy()
    np.testing.assert_array_equal(got, ref)


def _pair(shape, spec_kw, seed=9, lo=0.0, hi=1.0):
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    meta = {"comment": "c"}
    j = JImage(jnp.asarray(x), jspec.ImageSpec(**spec_kw), properties=meta,
               page=(9, 8, 1, 2), delay=3)
    t = TImage(torch.from_numpy(x), tspec.ImageSpec(**spec_kw),
               properties=meta, page=(9, 8, 1, 2), delay=3)
    return j, t


def _same(t, j):
    """A port Image equal to a JAX Image: pixels, spec and metadata."""
    assert isinstance(t.data, torch.Tensor)
    assert np.array_equal(t.data.numpy(), np.asarray(j.data))
    assert t.spec == tspec.ImageSpec(*j.spec.astuple())
    assert (t.properties, t.page, t.delay) == (j.properties, j.page,
                                               j.delay)


SPECS = [((5, 6, 3), {}), ((2, 5, 6, 4), dict(alpha=True)),
         ((5, 6, 2), dict(colorspace="gray", alpha=True)),
         ((5, 6, 5), dict(colorspace="cmyk", meta_channels=1)),
         ((5, 6, 6), dict(alpha=True, meta_channels=2))]


@pytest.mark.parametrize("shape,spec_kw", SPECS)
def test_image_properties_and_channel_views(shape, spec_kw):
    j, t = _pair(shape, spec_kw)
    assert (t.colorspace, t.alpha, t.batched) == (j.colorspace, j.alpha,
                                                  j.batched)
    for name in ("alpha_data", "meta_data", "color_data"):
        jv, tv = getattr(j, name)(), getattr(t, name)()
        assert (jv is None) == (tv is None)
        if jv is not None:
            assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape,spec_kw", SPECS)
def test_image_with_meta_color_and_alpha(shape, spec_kw):
    j, t = _pair(shape, spec_kw)
    meta = np.random.default_rng(10).uniform(
        0, 1, shape[:-1] + (3,)).astype(np.float32)
    _same(t.with_meta(torch.from_numpy(meta)),
          j.with_meta(jnp.asarray(meta)))
    _same(t.with_meta(None), j.with_meta(None))
    color = np.full(shape[:-1] + (t.spec.color_channels,), 0.25, np.float32)
    _same(t.with_color(torch.from_numpy(color)),
          j.with_color(jnp.asarray(color)))
    for enable, value in ((True, 0.5), (False, 1.0)):
        _same(t.set_alpha(enable, value), j.set_alpha(enable, value))


def test_transform_colorspace_keeps_metadata():
    j, t = _pair((5, 6, 4), dict(alpha=True))
    for key in ("cmyk", "hsl", "gray", "ycc"):
        jo, to = j.transform_colorspace(key), t.transform_colorspace(key)
        assert to.spec == tspec.ImageSpec(*jo.spec.astuple())
        assert (to.properties, to.page, to.delay) == (jo.properties,
                                                      jo.page, jo.delay)
        np.testing.assert_allclose(to.data.numpy(), np.asarray(jo.data),
                                   atol=1e-5)


def test_to_uint8_and_uint16():
    j, t = _pair((2, 5, 6, 3), {}, lo=-0.2, hi=1.2)
    assert np.array_equal(t.to_uint8(), j.to_uint8())
    assert np.array_equal(t.to_uint16(), j.to_uint16())
    assert t.to_uint8().dtype == np.uint8
    assert t.to_uint16().dtype == np.uint16


@pytest.mark.parametrize("shape", [(5, 6), (5, 6, 1), (5, 6, 2), (5, 6, 3),
                                   (5, 6, 4), (2, 5, 6, 5)])
def test_from_uint16_and_uint8(shape):
    rng = np.random.default_rng(11)
    a16 = rng.integers(0, 65536, shape).astype(np.uint16)
    _same(TImage.from_uint16(a16, device="cpu"), JImage.from_uint16(a16))
    a8 = rng.integers(0, 256, shape).astype(np.uint8)
    _same(TImage.from_uint8(a8, device="cpu"), JImage.from_uint8(a8))
    spec = tspec.ImageSpec("gray", alpha=False)
    assert TImage.from_uint16(a16[..., :1], spec, device="cpu").spec is spec


def test_from_uint16_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TImage.from_uint16(np.zeros((2, 2, 3), np.uint16)).data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TImage.from_uint16(np.zeros((2, 2, 3), np.uint16))


VP_METHODS = ["edge", "undefined", "black", "gray", "grey", "white", "mask",
              "transparent", "background", "tile", "mirror",
              "horizontaltile", "verticaltile", "horizontaltileedge",
              "verticaltileedge", "checkertile", "dither", "random",
              "no-such-mode"]


@pytest.mark.parametrize("method", VP_METHODS)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_vp_constant_equal(method, channels):
    for bg in (None, (0.25, 0.5), (0.1, 0.2, 0.3, 0.4, 0.5)):
        assert tvp.vp_constant(method, bg, channels) == \
            jvp.vp_constant(method, bg, channels)


@pytest.mark.parametrize("method", VP_METHODS)
def test_vp_tap_equal(method):
    """Integer taps far outside the canvas (several periods, negative)
    remap to the same coordinates and constant masks; the random mode's
    int32 hash wraps as the JAX package's does."""
    h, w = 7, 11
    yy, xx = np.meshgrid(np.arange(-40, 47), np.arange(-60, 73),
                         indexing="ij")
    yy = yy.astype(np.int32) * 3
    xx = xx.astype(np.int32) * 5
    ref = jvp.vp_tap(jnp.asarray(yy), jnp.asarray(xx), h, w, method)
    got = tvp.vp_tap(torch.from_numpy(yy), torch.from_numpy(xx), h, w,
                     method)
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("method", VP_METHODS)
@pytest.mark.parametrize("shape", [(9, 13, 3), (2, 9, 13, 4)])
def test_sample_bilinear_matches(method, shape):
    """distort.sample_bilinear at fractional points in and far outside
    the canvas, with and without a background: float32 blends of the
    same four taps in the same order (atol 1e-6)."""
    from imagemagick_tpu.ops import distort as jdt
    from imagemagick_tpu_torch.ops import distort as tdt

    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    u = rng.uniform(-20, 33, (15, 17)).astype(np.float32)
    v = rng.uniform(-15, 24, (15, 17)).astype(np.float32)
    for bg in (None, (0.2, 0.4, 0.6, 0.8)):
        ref = np.asarray(jdt.sample_bilinear(jnp.asarray(x), jnp.asarray(u),
                                             jnp.asarray(v), bg, method))
        got = tdt.sample_bilinear(torch.from_numpy(x), torch.from_numpy(u),
                                  torch.from_numpy(v), bg, method).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sample_bilinear_reads_each_image_at_its_own_points():
    """Points with the batch axis read each image at its own points (the
    JAX ``take`` crosses the batches there); shared points read every
    image at the same ones."""
    from imagemagick_tpu_torch.ops import distort as tdt

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 9, 13, 2)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, 15, (3, 5, 6)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, 11, (3, 5, 6)).astype(np.float32))
    got = tdt.sample_bilinear(x, u, v)
    assert got.shape == (3, 5, 6, 2)
    for i in range(3):
        assert torch.equal(got[i], tdt.sample_bilinear(x[i], u[i], v[i]))
    shared = tdt.sample_bilinear(x, u[0], v[0])
    assert torch.equal(shared[2], tdt.sample_bilinear(x[2], u[0], v[0]))


@pytest.mark.parametrize("geometry", ["3x4+1+2", "50%", "10x10-2-3", "4x3",
                                      "+2+1", "20x20+10+10"])
@pytest.mark.parametrize("shape,spec_kw", SPECS[:3])
def test_image_crop_equals_jax(shape, spec_kw, geometry):
    j, t = _pair(shape, spec_kw)
    _same(t.crop(geometry), j.crop(geometry))


@pytest.mark.parametrize("shape,spec_kw", SPECS)
def test_image_flip_and_flop_equal_jax(shape, spec_kw):
    j, t = _pair(shape, spec_kw)
    _same(t.flip(), j.flip())
    _same(t.flop(), j.flop())
    _same(t.flip().flop(), j.flop().flip())


@pytest.mark.parametrize("degrees", [0, 90, 180, 270, -90, 25.0])
@pytest.mark.parametrize("shape,spec_kw", SPECS[:2])
def test_image_rotate_equals_jax(shape, spec_kw, degrees):
    """90° multiples are exact transposes; an arbitrary angle resamples
    (EWA, premultiplied with alpha) and equals the JAX values here."""
    j, t = _pair(shape, spec_kw)
    bg = (1.0,) * shape[-1]
    jo, to = j.rotate(degrees, bg), t.rotate(degrees, bg)
    assert tuple(to.data.shape) == tuple(jo.data.shape)
    np.testing.assert_allclose(to.data.numpy(), np.asarray(jo.data),
                               atol=1e-5)
    assert to.spec == tspec.ImageSpec(*jo.spec.astuple())
    assert (to.properties, to.page, to.delay) == (jo.properties, jo.page,
                                                  jo.delay)


def test_image_has_31_of_the_jax_members():
    """The JAX class defines 33 members besides its slots (``__init__``
    and ``__repr__`` among them); the port has all but the two pytree
    hooks."""
    def members(cls):
        return {n for n in cls.__dict__ if n not in cls.__slots__ and
                (not n.startswith("__") or n in ("__init__", "__repr__"))}

    want, got = members(JImage), members(TImage)
    assert want - got == {"tree_flatten", "tree_unflatten"}
    assert len(want) == 33 and len(want & got) == 31
