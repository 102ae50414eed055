"""Port parity: the palette error-diffusion walks of ops/quantize.py
(``floyd_steinberg``, ``riemersma``, ``remap(..., dither=True)``) against
the JAX functions, and the host side of their kernel.

Tolerance 0: the walks are chaotic in their input (one rounding apart
moves every later pixel), so their plain versions repeat the JAX
functions' float32 arithmetic op for op and are held to them bit for
bit, at small sizes (2 x 12x17 and a few odd shapes), on palettes of 2, 8
and 256 entries, at C = 1, 3 and 4, on inputs inside and outside [0, 1].
XLA compiles Riemersma's ``(v - new) + err * decay`` on the CPU into a
fused multiply-add; ``_fma32`` rounds it once, and is held to exact
rational arithmetic, at the float32 midpoints where rounding twice
would differ too.  The kernel (``csrc/palette_walk.cu``) is held to the
plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here its wrappers are checked against their C
signatures with ``_build.load`` stubbed.
"""

import contextlib
import ctypes
import importlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import quantize as tq

jq = importlib.import_module("imagemagick_tpu.ops.quantize")

SHAPES = [(2, 12, 17), (1, 9, 5), (1, 1, 7), (3, 4, 1)]


def _case(shape, c, k, spread, seed):
    """Pixels in [0, 1] (spread 1) or in [-0.3, 1.3] (spread 1.6), and a
    palette of ``k`` entries, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.random((*shape, c)) * spread - (spread - 1.0) / 2.0
    return x.astype(np.float32), rng.random((k, c)).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spread", [1.0, 1.6])
@pytest.mark.parametrize("k", [2, 8, 256])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_floyd_steinberg_equals_jax(c, k, spread):
    for seed, shape in enumerate(SHAPES):
        x, pal = _case(shape, c, k, spread, seed)
        _eq(tq.floyd_steinberg(torch.from_numpy(x), torch.from_numpy(pal)),
            jq.floyd_steinberg(jnp.asarray(x), jnp.asarray(pal)))


@pytest.mark.parametrize("spread", [1.0, 1.6])
@pytest.mark.parametrize("k", [2, 8, 256])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_riemersma_equals_jax(c, k, spread):
    for seed, shape in enumerate(SHAPES):
        x, pal = _case(shape, c, k, spread, seed + 10)
        _eq(tq.riemersma(torch.from_numpy(x), torch.from_numpy(pal)),
            jq.riemersma(jnp.asarray(x), jnp.asarray(pal)))


@pytest.mark.parametrize("history", [1, 2, 16, 33])
def test_riemersma_history_equals_jax(history):
    x, pal = _case((1, 9, 13), 3, 16, 1.6, history)
    _eq(tq.riemersma(torch.from_numpy(x), torch.from_numpy(pal), history),
        jq.riemersma(jnp.asarray(x), jnp.asarray(pal), history))


@pytest.mark.parametrize("k", [2, 8, 256])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_remap_with_dither_equals_jax(c, k):
    """RemapImage under a dither is the Floyd-Steinberg walk, on a frame
    and on a batch; the palette may come as (K, 1, C)."""
    for seed, shape in enumerate([(2, 12, 17), (12, 17)]):
        x, pal = _case(shape, c, k, 1.6, seed + 20)
        pal3 = pal.reshape(k, 1, c)
        for dither in (True, 1):
            _eq(tq.remap(torch.from_numpy(x), torch.from_numpy(pal3),
                         dither),
                jq.remap(jnp.asarray(x), jnp.asarray(pal3), dither))


def test_single_image_equals_its_batch_of_one():
    x, pal = _case((1, 6, 11), 3, 8, 1.6, 5)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pal)
    for fn in (tq.floyd_steinberg, tq.riemersma):
        _eq(fn(xt[0], pt), fn(xt, pt)[0].numpy())


def test_hilbert_walk_visits_each_pixel_once():
    for h, w in [(1, 1), (1, 7), (12, 17), (33, 5), (64, 64)]:
        order = tq._hilbert_walk(h, w)
        assert sorted(order.tolist()) == list(range(h * w))


def _fma_exact(a, b, c) -> np.float32:
    """round(a*b + c) to float32, ties to even, in rational arithmetic."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(v.view(np.uint32)) & 1))


def test_fma32_rounds_once():
    """Random operands, and two whose float64 sum is a float32 midpoint
    but not the exact value: (1 + 2^-23) + (2^-24 - 2^-70) rounds down to
    1 + 2^-23 and (1 + 3·2^-23) - (2^-24 - 2^-70) up to 1 + 3·2^-23, where
    two roundings give the even neighbours 1 + 2^-22 both times."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    f = np.float32
    a = np.append(a, [f(2.0 ** -24 * (1 + 2.0 ** -23))] * 2)
    b = np.append(b, [f(1 - 2.0 ** -23), f(-(1 - 2.0 ** -23))])
    c = np.append(c, [f(1 + 2.0 ** -23), f(1 + 3 * 2.0 ** -23)])
    got = tq._fma32(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[-2] == f(1 + 2.0 ** -23) and got[-1] == f(1 + 3 * 2.0 ** -23)
    twice = ((a.astype(np.float64) * b) + c).astype(np.float32)
    assert twice[-2] != got[-2] and twice[-1] != got[-1]


def test_decay_is_the_jax_float32():
    for history in (1, 2, 16, 33):
        want = np.float32(np.exp(np.log(1.0 / history) /
                                 max(history - 1, 1)))
        assert tq.riemersma_decay(history) == float(want)


# -- the kernel's host side ---------------------------------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def pw_floyd_steinberg(self, *args):
        self.calls.append(("pw_floyd_steinberg", args))
        return 0

    def pw_riemersma(self, *args):
        self.calls.append(("pw_riemersma", args))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The walks take their card path for CPU tensors, with a library
    that records each call."""
    lib = _FakeLib()
    monkeypatch.setattr(tq, "on_card", lambda x: True)
    monkeypatch.setattr(tq, "stream_of", lambda x: 4321)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


def _typed(args, name):
    sig = _build._SIGNATURES[name]
    assert len(args) == len(sig)
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is ctypes.c_float else int)


@pytest.mark.parametrize("shape,k,shared", [
    ((4, 2, 1920, 3), 256, True), ((2, 48, 63, 4), 16, True),
    ((1, 2, 7500, 4), 256, False), ((1, 3, 5, 1), 2, True)])
def test_fs_wrapper_passes_its_signature(fake_card, shape, k, shared):
    x = torch.empty(shape)
    pal = torch.zeros(k, shape[-1])
    before = tq.LAUNCHES["walk_fs"]
    out = tq.floyd_steinberg(x, pal)
    assert tq.LAUNCHES["walk_fs"] == before + 1
    ((name, args),) = fake_card.calls
    _typed(args, name)
    xp, pp, op, sp, n, h, w, c, kk, rows, stream = args
    assert (xp, pp, op) == (x.data_ptr(), pal.data_ptr(), out.data_ptr())
    assert (n, h, w, c, kk, rows, stream) == (*shape, k, int(shared), 4321)
    assert rows == tq.walk_fs_rows_in_shared(shape[2], shape[3], k)
    assert out.shape == x.shape
    if not shared:   # two error rows an image in device memory
        assert sp != op


def test_riemersma_wrapper_passes_its_signature(fake_card):
    x = torch.empty(2, 12, 17, 3)
    pal = torch.zeros(8, 3)
    before = tq.LAUNCHES["walk_riemersma"]
    out = tq.riemersma(x, pal, 16)
    assert tq.LAUNCHES["walk_riemersma"] == before + 1
    ((name, args),) = fake_card.calls
    _typed(args, name)
    xp, order_p, pp, op, n, hw, c, k, decay, stream = args
    assert (xp, pp, op) == (x.data_ptr(), pal.data_ptr(), out.data_ptr())
    assert (n, hw, c, k, stream) == (2, 12 * 17, 3, 8, 4321)
    assert decay == tq.riemersma_decay(16)
    order = tq._hilbert_walk_on(12, 17, x.device)
    assert order_p == order.data_ptr() and order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), tq._hilbert_walk(12, 17))


@pytest.mark.parametrize("shape,k", [((1, 4, 4, 9), 2), ((1, 4, 4, 3), 20000)])
def test_kernel_refuses_what_it_does_not_take(fake_card, shape, k):
    with pytest.raises(ValueError):
        tq.floyd_steinberg(torch.zeros(shape), torch.zeros(k, shape[-1]))
    with pytest.raises(ValueError):
        tq.riemersma(torch.zeros(shape), torch.zeros(k, shape[-1]))
    with pytest.raises(ValueError):
        tq.floyd_steinberg(torch.zeros(1, 4, 4, 3, dtype=torch.float64),
                           torch.zeros(2, 3, dtype=torch.float64))
    assert fake_card.calls == []


def test_rows_in_shared_at_the_limit():
    # W = 1920 at C = 4 with a 256-entry palette: 65 KB, in shared memory
    assert tq.walk_fs_rows_in_shared(1920, 4, 256)
    w = (tq.WALK_SMEM // 4 - 256 * 4) // 8
    assert tq.walk_fs_rows_in_shared(w, 4, 256)
    assert not tq.walk_fs_rows_in_shared(w + 1, 4, 256)
