"""Port parity: ops/layer.py against the JAX package.

Animations of seeded frames with page offsets, alpha and delays through
both packages.  Coalesce, flatten, mosaic and optimize-transparency
composite with the port's ``composite_at`` (held to the JAX one in its
own file): atol 1e-6.  Deconstruct's boxes, the pages, delays, specs and
frame counts are held equal; smush and append are copies and Over blends
in the JAX numpy arithmetic's order: atol 1e-6.  The JAX
``remove_duplicate_layers`` adds the dropped frames' delays to the
caller's own frame; the port does not, and a test keeps that visible."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core.image import Image as JImage
from imagemagick_tpu.core.spec import ImageSpec as JSpec
from imagemagick_tpu.ops import layer as jl
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
from imagemagick_tpu_torch.ops import layer as tl


def _frames(n=6, h=18, w=24, c=4, seed=0, sprite=(5, 7), still_every=0):
    """A still background with a sprite at a seeded place in each frame;
    with ``still_every``, every frame at a multiple of it repeats its
    predecessor."""
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    if c in (2, 4):
        bg[..., -1] = 1.0
    sh, sw = sprite
    out = []
    prev = bg
    for k in range(n):
        if still_every and k and k % still_every == 0:
            fr = prev.copy()
        else:
            fr = bg.copy()
            y, x = rng.integers(0, h - sh), rng.integers(0, w - sw)
            fr[y:y + sh, x:x + sw] = rng.uniform(0, 1, (sh, sw, c))
        prev = fr
        out.append(fr)
    return out


def _pair(arrays, alpha, pages=None, delays=None, gray=False):
    cs = "gray" if gray else "srgb"
    js, ts = [], []
    for i, a in enumerate(arrays):
        page = pages[i] if pages else None
        delay = delays[i] if delays else 0
        js.append(JImage(jnp.asarray(a), JSpec(colorspace=cs, alpha=alpha),
                         {"n": i}, None, page, delay))
        ts.append(TImage(torch.from_numpy(a), TSpec(colorspace=cs,
                                                     alpha=alpha),
                         {"n": i}, None, page, delay))
    return js, ts


def _same(got, want, atol=1e-6):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, atol)
        return
    assert repr(got.spec) == repr(want.spec)
    assert got.page == want.page and got.delay == want.delay
    assert got.properties == want.properties
    w = np.asarray(want.data)
    assert tuple(got.data.shape) == w.shape
    np.testing.assert_allclose(got.data.numpy(), w, atol=atol, rtol=0)


def _sprites(n=6, c=4, seed=0):
    """Frames of an export: frame 0 the full background, the others
    sprites of 5x7 at page offsets (some partly transparent)."""
    full = _frames(1, c=c, seed=seed)[0]
    rng = np.random.default_rng(seed + 1)
    arrays, pages = [full], [None]
    for k in range(1, n):
        s = rng.uniform(0, 1, (5, 7, c)).astype(np.float32)
        if c == 4:
            s[..., -1] = rng.choice([0.0, 0.5, 1.0], (5, 7))
        arrays.append(s)
        pages.append((int(rng.integers(-2, 20)), int(rng.integers(-2, 15)),
                      24, 18))
    return arrays, pages


CASES = [(4, True), (3, False)]


@pytest.mark.parametrize("c,alpha", CASES, ids=str)
def test_coalesce_and_dispose_equal_jax(c, alpha):
    arrays, pages = _sprites(6, c)
    js, ts = _pair(arrays, alpha, pages, [10, 0, 5, 5, 0, 20])
    _same(tl.coalesce(ts), jl.coalesce(js))
    _same(tl.dispose_images(ts), jl.dispose_images(js))
    assert tl.coalesce([]) == []


@pytest.mark.parametrize("c,alpha", CASES, ids=str)
@pytest.mark.parametrize("fuzz", [0.0, 0.3])
def test_deconstruct_and_optimize_equal_jax(c, alpha, fuzz):
    arrays = _frames(7, c=c, seed=1, still_every=3)
    js, ts = _pair(arrays, alpha, delays=[4] * 7)
    _same(tl.deconstruct(ts, fuzz), jl.deconstruct(js, fuzz))
    arrays, pages = _sprites(6, c, seed=2)
    js, ts = _pair(arrays, alpha, pages, [3] * 6)
    _same(tl.optimize_layers(ts, fuzz), jl.optimize_layers(js, fuzz))
    one_j, one_t = _pair(arrays[:1], alpha)
    _same(tl.deconstruct(one_t), jl.deconstruct(one_j))


@pytest.mark.parametrize("c,alpha", CASES, ids=str)
@pytest.mark.parametrize("fuzz", [0.0, 0.05])
def test_remove_duplicates_and_zero_delays_equal_jax(c, alpha, fuzz):
    arrays = _frames(8, c=c, seed=4, still_every=2)
    arrays[5] = arrays[4] + 0.01           # a near duplicate, within fuzz
    delays = [10, 20, 0, 5, 7, 0, 3, 0]
    js, ts = _pair(arrays, alpha, delays=delays)
    _same(tl.remove_duplicate_layers(ts, fuzz),
          jl.remove_duplicate_layers(js, fuzz))
    js, ts = _pair(arrays, alpha, delays=delays)
    _same(tl.remove_zero_delay_layers(ts), jl.remove_zero_delay_layers(js))
    js, ts = _pair(arrays[:3], alpha, delays=[0, 0, 0])
    _same(tl.remove_zero_delay_layers(ts), jl.remove_zero_delay_layers(js))
    assert tl.remove_duplicate_layers([]) == []


def test_jax_remove_duplicates_changes_the_callers_delay():
    """The JAX function adds each dropped frame's delay to the caller's
    own first frame of the run; the port returns a new frame and leaves
    the caller's frames as they were."""
    arrays = _frames(4, seed=5, still_every=1)      # four equal frames
    js, ts = _pair(arrays, True, delays=[10, 20, 30, 40])
    want = jl.remove_duplicate_layers(js)
    got = tl.remove_duplicate_layers(ts)
    assert [f.delay for f in js] == [100, 20, 30, 40]
    assert [f.delay for f in ts] == [10, 20, 30, 40]
    assert got[0].delay == want[0].delay == 100
    assert got[0] is not ts[0]


@pytest.mark.parametrize("c,alpha", CASES + [(1, False)], ids=str)
@pytest.mark.parametrize("bg", [None, (0.2, 0.4, 0.6, 1.0)], ids=str)
def test_flatten_and_mosaic_equal_jax(c, alpha, bg):
    arrays, pages = _sprites(5, c if c != 1 else 3, seed=6)
    if c == 1:
        arrays = [a[..., :1] for a in arrays]
    js, ts = _pair(arrays, alpha, pages, gray=c == 1)
    _same(tl.flatten(ts, bg), jl.flatten(js, bg))
    _same(tl.mosaic(ts, bg), jl.mosaic(js, bg))
    for f in (tl.flatten, tl.mosaic):
        with pytest.raises(ValueError):
            f([])


@pytest.mark.parametrize("c,alpha", CASES, ids=str)
@pytest.mark.parametrize("fuzz", [0.0, 0.2])
def test_optimize_transparency_equals_jax(c, alpha, fuzz):
    arrays, pages = _sprites(6, c, seed=7)
    js, ts = _pair(arrays, alpha, pages, [2] * 6)
    _same(tl.optimize_transparency(ts, fuzz),
          jl.optimize_transparency(js, fuzz))
    one_j, one_t = _pair(arrays[:1], alpha)
    _same(tl.optimize_transparency(one_t), jl.optimize_transparency(one_j))


GRAVITIES = ["northwest", "north", "northeast", "west", "center", "east",
             "southwest", "south", "southeast"]


def _list(seed, alpha_of=(True, False, True)):
    """Three images of different sizes, some with alpha whose borders are
    transparent (the smush gap)."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (h, w) in enumerate(((9, 14), (12, 8), (7, 11))):
        c = 4 if alpha_of[k] else 3
        a = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
        if c == 4:
            a[..., -1] = 1.0
            a[:2, :, -1] = 0.0
            a[:, -3:, -1] = 0.0
            a[-1, :4, -1] = 0.0
        out.append(a)
    return out


def _mixed_pair(arrays, gray=False):
    js, ts = [], []
    for a in arrays:
        alpha = a.shape[-1] in (2, 4)
        cs = "gray" if gray else "srgb"
        js.append(JImage(jnp.asarray(a), JSpec(colorspace=cs, alpha=alpha)))
        ts.append(TImage(torch.from_numpy(a), TSpec(colorspace=cs,
                                                     alpha=alpha)))
    return js, ts


@pytest.mark.parametrize("gravity", GRAVITIES)
@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("offset", [0, 3, -2])
def test_smush_equals_jax(gravity, stack, offset):
    js, ts = _mixed_pair(_list(8))
    bg = (0.1, 0.5, 0.9, 1.0)
    _same(tl.smush(ts, stack, offset, bg, gravity),
          jl.smush(js, stack, offset, bg, gravity))


@pytest.mark.parametrize("gravity", GRAVITIES)
@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("alpha_of", [(True, False, True),
                                      (False, False, False)], ids=str)
def test_append_equals_jax(gravity, stack, alpha_of):
    js, ts = _mixed_pair(_list(9, alpha_of))
    bg = (0.3, 0.2, 0.1, 1.0)
    _same(tl.append(ts, stack, bg, gravity),
          jl.append(js, stack, bg, gravity))


@pytest.mark.parametrize("c", [1, 2])
def test_append_gray_lists_equal_jax(c):
    rng = np.random.default_rng(10)
    arrays = [rng.uniform(0, 1, (h, w, c)).astype(np.float32)
              for h, w in ((5, 6), (7, 3))]
    js, ts = _mixed_pair(arrays, gray=True)
    for stack in (True, False):
        _same(tl.append(ts, stack), jl.append(js, stack))
    with pytest.raises(ValueError):
        tl.append([], True)
    with pytest.raises(ValueError):
        tl.smush([], True, 0)


def test_smush_and_append_keep_the_device_and_leave_inputs_alone():
    js, ts = _mixed_pair(_list(11))
    before = [t.data.clone() for t in ts]
    out = tl.smush(ts, False, 1)
    out2 = tl.append(ts, True)
    assert out.data.device == out2.data.device == ts[0].data.device
    assert all(torch.equal(b, t.data) for b, t in zip(before, ts))


def test_every_public_jax_function_is_ported():
    public = {k for k, v in vars(jl).items()
              if callable(v) and not k.startswith("_")
              and getattr(v, "__module__", "") == jl.__name__}
    assert public <= set(dir(tl)), public - set(dir(tl))
