"""Port parity: ops/fx.py against the JAX module.

Each expression runs through the JAX ``fx`` and the port's on the same
images (a numpy seed, at most 96x128, a batch of 2 where the JAX function
takes one) and is held to it within 1e-6 relative and 1e-6 absolute: the
transcendentals of XLA and of PyTorch's CPU kernels may differ by an ulp.
``rand`` comes from torch's generator, not JAX's PRNG: it is held by its
moments (mean 1/2, variance 1/12), equal channels and its seed.  The
cases of tests/test_analysis_ops.py run as one parametrised test.  Three
JAX faults stay visible: ``gcd`` returns its first argument, a channel
suffix drops a pixel reference's offset, and pixel references on a
batch index the batch axis with the row."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.ops import fx as tfx

jfx = importlib.import_module("imagemagick_tpu.ops.fx")

RTOL = ATOL = 1e-6


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _both(images, expr):
    got = tfx.fx([torch.from_numpy(x) for x in images], expr)
    want = np.asarray(jfx.fx([jnp.asarray(x) for x in images], expr))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    return got.numpy(), want


# (expression, what the JAX test expects of it on checker_rgb)
ANALYSIS_CASES = [
    ("u/2+0.25", lambda x, h: x / 2 + 0.25),
    ("u.g", lambda x, h: np.repeat(x[..., 1:2], 3, -1)),
    ("u>0.5?1.0:0.0", lambda x, h: (x > 0.5).astype(np.float32)),
    ("i/w", lambda x, h: np.broadcast_to(
        (np.arange(32, dtype=np.float32) / 32.0)[None, :, None], x.shape)),
    ("(u+v)/2", lambda x, h: x * 0.75),
    ("p[1,0]", None),
    ("sqrt(u)*sin(pi/2)", lambda x, h: np.sqrt(x)),
    ("t=u*2; t-u", lambda x, h: x),
]


@pytest.mark.parametrize("expr,expect", ANALYSIS_CASES,
                         ids=[c[0] for c in ANALYSIS_CASES])
def test_analysis_cases_match_jax(checker_rgb, expr, expect):
    """tests/test_analysis_ops.py's fx cases, on its checker image (and a
    half-bright copy for ``v``), against the JAX function and against
    what that test expects."""
    half = checker_rgb * 0.5
    got, want = _both([checker_rgb, half], expr)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if expect is None:        # p[1,0]: the right neighbour
        np.testing.assert_allclose(got[:, :-1], checker_rgb[:, 1:],
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got, expect(checker_rgb, half),
                                   atol=1e-5)


EXPRS = [
    # arithmetic, precedence, unary and percent literals
    "u*2-v/3", "-u+1", "+u", "2^3^0.5", "u^2", "(u+0.1)%0.3", "50%*u",
    "u/0", "u/(v-v)", "1e-2*u+.5", "!u", "~(u>0.5)",
    # comparisons, logic, ternaries
    "u<v", "u<=0.5", "u>=v", "u==u", "u!=v", "u>0.3&&v<0.7",
    "u>0.8||v<0.2",
    "u>0.5?v:u<0.2?0:1", "if(u>v, u, v)",
    # symbols
    "i/w+j/h", "w*h/1e4", "u.r+u.g*2-u.b", "v.g", "s", "v", "u[1]",
    "u[0]*v[1]", "u.a", "v.k", "r+g+b", "cyan*magenta", "intensity",
    "luma", "u.intensity", "v.luma", "luminance", "hue", "saturation",
    "lightness", "u.w/u.h", "quantumrange*quantumscale", "e*phi/pi",
    "epsilon+opaque-transparent", "maxrgb/65535",
    # pixel references
    "p[1,0]", "p[-2,3]", "p[0.6,-0.5]", "p[i,j]", "p{3,4}", "p{i/2,j/2}",
    "p{w,h}", "s[2,-1]", "s{1,1}",
    # functions
    "abs(u-v)", "acos(u)", "acosh(u+1)", "asin(u)", "asinh(u)", "atan(u)",
    "atanh(u*0.9)", "atan2(u,v-0.5)", "ceil(u*4)", "clamp(u*2-0.5)",
    "cos(u*pi)", "cosh(u)", "drc(u,0.5)", "erf(u-0.5)", "exp(-u)",
    "floor(u*4)", "gauss(u)", "hypot(u,v)", "int(u*3)", "isnan(u)",
    "ln(u)", "log(u)", "logtwo(u)", "max(u,v)", "min(u,v)", "mod(u*7,3)",
    "not(u)", "pow(u,2.2)", "round(u*5)/5", "sign(u-0.5)", "sin(u)",
    "sinc(u*2)", "sinh(u)", "sqrt(u-0.3)", "squish(u*4-2)", "tan(u)",
    "tanh(u)", "trunc(u*3-1)", "alt(i)", "debug(u)",
    # statements and variables
    "a=u*2; b=v+1; a*b", "x=1; y=x+u; y*y", "k2 = u; k2 > 0.5 ? k2 : 0;",
    "unset*2+u",
]


@pytest.mark.parametrize("expr", EXPRS)
def test_expression_matches_jax(expr):
    u, v = _img((48, 64, 3), 1), _img((48, 64, 3), 2)
    got, want = _both([u, v], expr)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("expr", ["u*2-v/3", "hue", "pow(u,2.2)",
                                  "u>0.5?v:u", "i/w+j/h", "u[1]"])
def test_batch_matches_jax(expr):
    u, v = _img((2, 40, 56, 3), 3), _img((2, 40, 56, 3), 4)
    got, want = _both([u, v], expr)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [1, 4])
def test_channel_counts_match_jax(channels):
    u = _img((40, 56, channels), 5)
    for expr in ("u*0.5+p[1,1]", "u.a", "intensity", "u.b"):
        got, want = _both([u], expr)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("expr", ["j0(u)", "j1(u)", "jinc(u)", "airy(u)",
                                  "nosuch(u)"])
def test_dropped_functions_raise_in_both(expr):
    x = _img((8, 8, 3))
    with pytest.raises(ValueError, match="unknown function"):
        tfx.fx(torch.from_numpy(x), expr)
    with pytest.raises(ValueError, match="unknown function"):
        jfx.fx(jnp.asarray(x), expr)


@pytest.mark.parametrize("expr,match", [
    ("u+", "unexpected end"), ("(u", "expected"), ("u $ v", "bad token"),
    ("u v", "trailing"), ("p[1 2]", "expected"),
    ("(u>0.5)|(v>0.5)", "bad token"), ("(u>0.5)&(v>0.5)", "bad token"),
    ("v[2,-1]", "expected"), ("p[1,0].r", "bad token")])
def test_syntax_errors_raise_in_both(expr, match):
    x = _img((8, 8, 3))
    with pytest.raises(ValueError, match=match):
        tfx.fx(torch.from_numpy(x), expr)
    with pytest.raises(ValueError, match=match):
        jfx.fx(jnp.asarray(x), expr)


def test_rand_by_moments_channels_and_seed():
    """``rand`` is uniform on [0, 1): mean 1/2 and variance 1/12 within
    five standard errors; every channel draws the same numbers (the
    generator is rewound for each); the same seed repeats them, another
    seed does not."""
    x = torch.from_numpy(_img((96, 128, 3), 6))
    out = tfx.fx(x, "rand()")
    n = out[..., 0].numel()
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0
    assert abs(float(out[..., 0].mean()) - 0.5) < 5 * (1 / 12 / n) ** 0.5
    assert abs(float(out[..., 0].var()) - 1 / 12) < 5 * (1 / 180 / n) ** 0.5
    assert torch.equal(out[..., 0], out[..., 1])
    assert torch.equal(out[..., 1], out[..., 2])
    assert torch.equal(out, tfx.fx(x, "rand()"))
    other = tfx.fx(x, "rand()", torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    # two draws in one expression differ; the JAX function's too
    two = tfx.fx(x, "rand()-rand()")[..., 0]
    assert float(two.abs().max()) > 0.5
    jtwo = np.asarray(jfx.fx(jnp.asarray(x.numpy()), "rand()-rand()"))
    assert np.abs(jtwo).max() > 0.5
    jout = np.asarray(jfx.fx(jnp.asarray(x.numpy()), "rand()"))
    np.testing.assert_array_equal(jout[..., 0], jout[..., 1])


def test_gcd_is_euclid_where_jax_returns_its_first_argument():
    x = torch.zeros(4, 4, 3)
    got = tfx.fx(x, "gcd(12, 18)")
    assert torch.equal(got, torch.full_like(got, 6.0))
    assert float(tfx.fx(x, "gcd(12.4, 17.6)")[0, 0, 0]) == 6.0
    assert float(tfx.fx(x, "gcd(-8, 0)")[0, 0, 0]) == 8.0
    assert float(tfx.fx(x, "gcd(7, 13)")[0, 0, 0]) == 1.0
    jgot = np.asarray(jfx.fx(jnp.asarray(x.numpy()), "gcd(12, 18)"))
    assert (jgot == 12.0).all()


def test_channel_suffix_keeps_the_offset_where_jax_drops_it():
    u = _img((24, 32, 3), 7)
    got = tfx.fx(torch.from_numpy(u), "p.r[1,0]").numpy()
    np.testing.assert_array_equal(got[:, :-1, 1], u[:, 1:, 0])
    jgot = np.asarray(jfx.fx(jnp.asarray(u), "p.r[1,0]"))
    np.testing.assert_array_equal(jgot[..., 1], u[..., 0])


def test_pixel_references_on_a_batch_gather_each_image():
    """The JAX function indexes the batch axis with the row: a relative
    reference raises and an absolute one reads another pixel."""
    u = _img((2, 24, 32, 3), 8)
    got = tfx.fx(torch.from_numpy(u), "p[1,0]").numpy()
    np.testing.assert_array_equal(got[:, :, :-1], u[:, :, 1:])
    one = tfx.fx(torch.from_numpy(u), "p{5,3}").numpy()
    for k in range(2):
        assert (one[k] == u[k, 3, 5]).all()
    with pytest.raises(ValueError, match="broadcast"):
        jfx.fx(jnp.asarray(u), "p[1,0]")
    jone = np.asarray(jfx.fx(jnp.asarray(u), "p{5,3}"))
    assert not (jone[1] == u[1, 3, 5]).all()


def test_compile_fx_and_environment():
    prog = tfx.compile_fx("t = u * 2; t + v")
    u = torch.from_numpy(_img((8, 10, 3), 9))
    v = torch.from_numpy(_img((8, 10, 3), 10))
    env = tfx._Env([u, v], 1, torch.Generator().manual_seed(0), {})
    out = prog(env)
    assert torch.equal(out, u[..., 1] * 2 + v[..., 1])
    assert torch.equal(env.vars["t"], u[..., 1] * 2)
    # a channel name reads the channel, also after an assignment to it
    a = tfx.compile_fx("a = 0; a")(env)
    assert torch.equal(a, u[..., 2])
    assert env.const(0.5).dim() == 0 and env.const(0.5).dtype == torch.float32
