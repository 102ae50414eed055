"""Port parity: ops/visual_effects.py against the JAX package.

Seeded inputs through both packages.  The per-pixel effects (blue shift,
colorize, color matrix, solarize, stegano, stereo, tint) and the
wavelet denoise are float32 expressions in the same order: atol 1e-6.
The effects that blur, normalize or resample (charcoal, sepia tone,
vignette, shadow, sketch, polaroid) go through the port's blur, enhance,
resize and distort functions, each held to the JAX ones in their own
files: atol 1e-5.

The random effects are held on the JAX variates: each test draws them
with the JAX function's own key and split, hands them to the port's
deterministic half (``add_noise_from``, ``sketch_from``) and holds the
result to the JAX function's (atol 1e-6; sketch 1e-5).  The port's draw
(``noise_variates``, ``sketch_variates``) is held by its moments (5
standard errors) and by seed equality."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagemagick_tpu.ops import visual_effects as jv
from imagemagick_tpu_torch.ops import distort as tdt
from imagemagick_tpu_torch.ops import visual_effects as tv


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _natural(h, w, c=3, seed=0):
    """Smooth shading, texture and a flat block: content for the
    normalizing effects (a uniform noise image has no tails)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 7.0)[..., None] * np.cos(
        xx[..., None] / 9.0 + np.arange(c))
    x = np.clip(base + 0.05 * rng.standard_normal((h, w, c)), 0, 1)
    x[h // 3:h // 2, w // 4:w // 2] = 0.9
    return x.astype(np.float32)


def _close(got, want, atol=1e-6):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


SHAPES = [(20, 26, 3), (2, 12, 17, 4), (9, 11, 1)]

# -- noise ---------------------------------------------------------------

NOISE_TYPES = ("uniform", "gaussian", "impulse", "saltandpepper",
               "salt-and-pepper", "laplacian", "multiplicative",
               "multiplicativegaussian", "poisson", "random")


def _jax_variates(x, t, a, key):
    """The variates the JAX ``add_noise`` draws from ``key``."""
    t = t.lower()
    if t in ("uniform", "impulse", "saltandpepper", "salt-and-pepper",
             "random"):
        return (jax.random.uniform(key, x.shape),)
    if t == "gaussian":
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, x.shape),
                jax.random.normal(k2, x.shape))
    if t == "laplacian":
        return (jax.random.uniform(key, x.shape, minval=-0.4999,
                                   maxval=0.4999),)
    if t in ("multiplicative", "multiplicativegaussian"):
        return (jax.random.normal(key, x.shape),)
    lam = jnp.maximum(x * 255.0 / jnp.maximum(a, 1e-3), 1e-6)
    return (jax.random.poisson(key, lam).astype(x.dtype),)


@pytest.mark.parametrize("t", NOISE_TYPES)
@pytest.mark.parametrize("a", [1.0, 0.3, 2.5])
def test_add_noise_on_jax_variates_equals_jax(t, a):
    x = _img((2, 14, 19, 3), 1)
    key = jax.random.PRNGKey(3)
    want = jv.add_noise(jnp.asarray(x), t, attenuate=a, key=key)
    vs = [torch.from_numpy(np.array(v))
          for v in _jax_variates(jnp.asarray(x), t, a, key)]
    _close(tv.add_noise_from(torch.from_numpy(x), t, a, vs), want)


def test_add_noise_unknown_type_raises_as_jax():
    x = _img((4, 4, 3))
    with pytest.raises(ValueError):
        jv.add_noise(jnp.asarray(x), "bogus")
    with pytest.raises(ValueError):
        tv.add_noise(torch.from_numpy(x), "bogus")


@pytest.mark.parametrize("t", ["uniform", "gaussian", "laplacian",
                               "multiplicative", "poisson"])
def test_noise_variates_moments_and_seeds(t):
    """Uniform [0, 1): mean 1/2, variance 1/12; normals: mean 0,
    variance 1; laplacian's uniform on +-0.4999; Poisson counts of mean
    lam with variance lam; each within 5 standard errors.  The same seed
    draws the same variates, another seed others."""
    x = torch.from_numpy(_img((64, 96, 3), 2))
    g = torch.Generator().manual_seed(11)
    vs = tv.noise_variates(x, t, 1.0, g)
    n = x.numel()
    for v in vs:
        assert v.shape == x.shape
        if t == "uniform":
            mean, var = 0.5, 1.0 / 12.0
        elif t == "laplacian":
            assert float(v.min()) >= -0.4999 and float(v.max()) < 0.4999
            mean, var = 0.0, 0.9998 ** 2 / 12.0
        elif t == "poisson":
            lam = torch.clamp(x * 255.0, min=1e-6).double()
            z = (v.double() - lam).sum() / lam.sum().sqrt()
            assert abs(float(z)) < 5.0
            continue
        else:
            mean, var = 0.0, 1.0
        assert abs(float(v.double().mean()) - mean) < 5 * math.sqrt(var / n)
        assert abs(float(v.double().var()) - var) < 5 * var * math.sqrt(
            2.0 / n) + 5e-3 * var
    again = tv.noise_variates(x, t, 1.0, torch.Generator().manual_seed(11))
    other = tv.noise_variates(x, t, 1.0, torch.Generator().manual_seed(12))
    assert all(torch.equal(p, q) for p, q in zip(vs, again))
    assert not all(torch.equal(p, q) for p, q in zip(vs, other))
    assert torch.equal(tv.add_noise(x, t), tv.add_noise(x, t))


# -- per-pixel effects -----------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
@pytest.mark.parametrize("factor", [1.5, 0.5, 3.0])
def test_blue_shift_equals_jax(shape, factor):
    x = _img(shape, 3)
    _close(tv.blue_shift(torch.from_numpy(x), factor),
           jv.blue_shift(jnp.asarray(x), factor))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("color,amount", [
    ((1.0, 0.0, 0.0, 1.0), 0.3), ((0.2, 0.5, 0.9, 1.0), (0.1, 0.5, 0.9)),
    ((0.0, 0.0, 0.0), 1.0)], ids=str)
def test_colorize_equals_jax(shape, color, amount):
    x = _img(shape, 4)
    if np.ndim(amount) and len(amount) != shape[-1]:
        amount = amount[0]
    if len(color) < shape[-1]:     # a color short of the channels
        with pytest.raises((TypeError, ValueError)):
            jv.colorize(jnp.asarray(x), color, amount)
        with pytest.raises(RuntimeError):
            tv.colorize(torch.from_numpy(x), color, amount)
        return
    _close(tv.colorize(torch.from_numpy(x), color, amount),
           jv.colorize(jnp.asarray(x), color, amount))


MATRICES = [
    np.array([[0.5, 0.3, 0.2], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]]),
    np.array([[1.2, 0, 0, 0, 0, 0.1], [0, 0.9, 0, 0, 0, -0.05],
              [0, 0, 1.1, 0, 0, 0], [0, 0, 0, 1, 0, 0],
              [0.1, 0.1, 0.1, 0, 0.7, 0], [0, 0, 0, 0, 0, 1]]),
    np.array([[0.9, 0.1], [0.2, 0.8]]),
    np.array([[1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
              [0, 0, 0, 1, 0], [0.3, 0.3, 0.3, 0, 0.1]]),
]


@pytest.mark.parametrize("shape", [(20, 26, 3), (2, 12, 17, 4), (9, 11, 1),
                                   (7, 8, 2)], ids=str)
@pytest.mark.parametrize("m", range(len(MATRICES)))
def test_color_matrix_equals_jax(shape, m):
    x = _img(shape, 5)
    _close(tv.color_matrix(torch.from_numpy(x), MATRICES[m]),
           jv.color_matrix(jnp.asarray(x), MATRICES[m]))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("thr", [0.5, 0.1, 0.9])
def test_solarize_equals_jax(shape, thr):
    x = _img(shape, 6)
    _close(tv.solarize(torch.from_numpy(x), thr),
           jv.solarize(jnp.asarray(x), thr))


@pytest.mark.parametrize("shape,wm", [((20, 26, 3), (8, 10, 3)),
                                      ((2, 12, 17, 4), (12, 17, 1)),
                                      ((9, 11, 1), (3, 11, 4))], ids=str)
def test_stegano_equals_jax(shape, wm):
    x = _img(shape, 7)
    w = _img(wm, 8)
    got = tv.stegano(torch.from_numpy(x), torch.from_numpy(w), 0)
    _close(got, jv.stegano(jnp.asarray(x), jnp.asarray(w), 0), atol=0)


def test_stegano_keeps_its_cast_in_range():
    """Values far outside [0, 1] saturate before the integer cast (an
    out-of-range cast is undefined on the card)."""
    x = torch.tensor([[[1e12, -1e12, 0.5]]])
    out = tv.stegano(x, torch.ones(1, 1, 3))
    assert bool(torch.isfinite(out).all())
    assert float(out[0, 0, 0]) > 8e6 and float(out[0, 0, 1]) < -8e6


@pytest.mark.parametrize("shape", [(20, 26, 3), (2, 12, 17, 3)], ids=str)
@pytest.mark.parametrize("off", [(0, 0), (3, -2), (-5, 4), (40, 30)],
                         ids=str)
def test_stereo_equals_jax(shape, off):
    a, b = _img(shape, 9), _img(shape, 10)
    _close(tv.stereo(torch.from_numpy(a), torch.from_numpy(b), *off),
           jv.stereo(jnp.asarray(a), jnp.asarray(b), *off), atol=0)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
@pytest.mark.parametrize("color,blend", [
    ((1.0, 0.5, 0.0), (100.0, 100.0, 100.0)), ((0.0, 0.0, 0.0), (50.0,)),
    ((0.2, 0.9, 0.4, 1.0), (80.0, 20.0, 60.0))], ids=str)
def test_tint_equals_jax(shape, color, blend):
    x = _img(shape, 11)
    _close(tv.tint(torch.from_numpy(x), color, blend),
           jv.tint(jnp.asarray(x), color, blend))


# -- blurs, normalizations and warps ---------------------------------------

@pytest.mark.parametrize("shape", [(24, 30, 3), (2, 16, 20, 4)], ids=str)
@pytest.mark.parametrize("rs", [(0.0, 1.0), (1.0, 0.5), (2.0, 1.5)],
                         ids=str)
def test_charcoal_equals_jax(shape, rs):
    x = np.stack([_natural(*shape[-3:], seed=s)
                  for s in range(shape[0])]) if len(shape) == 4 else \
        _natural(*shape)
    _close(tv.charcoal(torch.from_numpy(x), *rs),
           jv.charcoal(jnp.asarray(x), *rs), atol=1e-5)


@pytest.mark.parametrize("shape", [(24, 30, 3), (16, 20, 4)], ids=str)
@pytest.mark.parametrize("thr", [0.8, 0.4])
def test_sepia_tone_equals_jax(shape, thr):
    x = _natural(*shape, seed=1)
    _close(tv.sepia_tone(torch.from_numpy(x), thr),
           jv.sepia_tone(jnp.asarray(x), thr), atol=1e-5)


@pytest.mark.parametrize("shape", [(24, 30, 3), (2, 16, 20, 4),
                                   (18, 22, 1)], ids=str)
@pytest.mark.parametrize("args", [
    (0.0, 10.0, None, None), (0.0, 3.0, 4.0, 2.0), (2.0, 1.5, 0.0, 0.0)],
    ids=str)
def test_vignette_equals_jax(shape, args):
    x = _img(shape, 12)
    bg = (0.1, 0.2, 0.3)
    _close(tv.vignette(torch.from_numpy(x), *args, background=bg),
           jv.vignette(jnp.asarray(x), *args, background=bg), atol=1e-5)


@pytest.mark.parametrize("shape", [(14, 18, 4), (2, 10, 12, 4), (9, 11, 3)],
                         ids=str)
@pytest.mark.parametrize("args", [(80.0, 3.0, 5, 5), (50.0, 1.0, 2, -3),
                                  (100.0, 2.0, 0, 0)], ids=str)
def test_shadow_equals_jax(shape, args):
    x = _img(shape, 13)
    color = (0.2, 0.3, 0.4)
    _close(tv.shadow(torch.from_numpy(x), *args, color=color),
           jv.shadow(jnp.asarray(x), *args, color=color), atol=1e-5)


@pytest.mark.parametrize("shape,alpha", [((16, 20, 3), False),
                                         ((12, 14, 4), True),
                                         ((12, 14, 4), False)], ids=str)
@pytest.mark.parametrize("args", [(0.0, 1.0, 0.0), (2.0, 1.5, 30.0)],
                         ids=str)
def test_sketch_on_jax_variates_equals_jax(shape, alpha, args):
    x = _natural(*shape, seed=2)
    h, w = shape[-3], shape[-2]
    val = jax.random.uniform(jax.random.PRNGKey(7), (2 * h, 2 * w, 1),
                             jnp.float32)
    want = jv.sketch(jnp.asarray(x), *args, has_alpha=alpha)
    got = tv.sketch_from(torch.from_numpy(x),
                         torch.from_numpy(np.array(val)), *args,
                         has_alpha=alpha)
    _close(got, want, atol=1e-5)


def test_sketch_draw_moments_and_seeds():
    x = torch.from_numpy(_natural(30, 40))
    v = tv.sketch_variates(x, torch.Generator().manual_seed(5))
    assert v.shape == (60, 80, 1)
    n = v.numel()
    assert abs(float(v.double().mean()) - 0.5) < 5 * math.sqrt(1 / 12 / n)
    assert torch.equal(tv.sketch(x), tv.sketch(x))
    assert not torch.equal(
        tv.sketch(x, generator=torch.Generator().manual_seed(1)),
        tv.sketch(x, generator=torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("shape", [(24, 32, 3), (20, 18, 4), (16, 16, 1)],
                         ids=str)
@pytest.mark.parametrize("angle", [0.0, 12.0, -30.0])
def test_polaroid_equals_jax(shape, angle):
    x = _natural(*shape, seed=3)
    bg = (0.9, 0.8, 0.7)
    _close(tv.polaroid(torch.from_numpy(x), angle, background=bg),
           jv.polaroid(jnp.asarray(x), angle, background=bg), atol=1e-5)


@pytest.mark.parametrize("n,shift", [(9, 1), (9, 4), (9, 16), (2, 3),
                                     (1, 8), (17, 16)])
def test_hat_transform_equals_jax(n, shift):
    x = _img((3, n, 2), 14)
    for axis in (0, 1):
        if x.shape[axis] != n:
            continue
        _close(tv._hat_transform(torch.from_numpy(x), axis, shift),
               jv._hat_transform(jnp.asarray(x), axis, shift))


@pytest.mark.parametrize("shape", [(24, 30, 3), (2, 12, 17, 4),
                                   (5, 40, 1)], ids=str)
@pytest.mark.parametrize("args", [(0.05, 0.0, 5), (0.2, 0.3, 5),
                                  (0.1, 0.0, 2)], ids=str)
def test_wavelet_denoise_equals_jax(shape, args):
    x = _img(shape, 15)
    _close(tv.wavelet_denoise(torch.from_numpy(x), *args),
           jv.wavelet_denoise(jnp.asarray(x), *args))


def test_warps_are_the_distort_module_ones():
    assert (tv.implode, tv.swirl, tv.wave) == \
        (tdt.implode, tdt.swirl, tdt.wave)
    assert {"implode", "swirl", "wave"} <= set(dir(jv))


def test_every_public_jax_function_is_ported():
    public = {k for k, v in vars(jv).items()
              if callable(v) and not k.startswith("_")
              and getattr(v, "__module__", "").startswith("imagemagick_tpu")}
    assert public <= set(dir(tv)), public - set(dir(tv))
