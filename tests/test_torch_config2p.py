"""Config #2's pipelined route (kernel K2p): the port against the JAX package.

``fused_blur_unsharp_pipeline(..., lab_roundtrip=True, pipelined=True)`` is
the port's counterpart of the JAX function under ``IMTPU_PIPE_KERNEL``,
which builds the software-pipelined ``_kernel_pipe`` (``_build_call_pipe``).
On a CPU tensor the port runs K2p's plain version, full float32.  The JAX
``_kernel_pipe`` runs only with ``IMTPU_NO_HSTENCIL`` set as well: every
shape its Lab path takes otherwise goes through the h-stencil rewrite,
which cuts the kernel's G blocks to two, and ``_kernel_pipe`` then indexes
past them (``test_jax_pipe_kernel_fails_with_the_hstencil``).  With both
variables it runs in the interpreter with the bf16 three-pass split, as
the sequential kernel does, so the port agrees with it at max |d| <= 5e-5,
the tolerance of ``test_torch_config2.py``.  A spy on ``_build_call_pipe``
shows that the pipelined kernel ran.

K2p's CUDA schedule is replayed here too: its persistent walk over the
tiles (every tile once, a short last round), the handovers of its two x
slots and two stage slots between the load, compute and Lab warps
(mbarrier phases, run as one generator per role), its shared memory
against the 232,448 bytes a block may use, and its wrapper against the C
entry's signature (taps in host memory; ``_build.load`` stubbed).  The
kernel itself is held to K2 on every value on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import contextlib
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagemagick_tpu.ops import fused_pipeline as jfp
from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import fused_pipeline as tfp
from imagemagick_tpu_torch.ops import gpu_kernels as gk


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture
def pipe_spy(monkeypatch):
    """Both variables under which the JAX function builds ``_kernel_pipe``,
    and the arguments of every ``_build_call_pipe`` made in the test."""
    monkeypatch.setenv("IMTPU_PIPE_KERNEL", "1")
    monkeypatch.setenv("IMTPU_NO_HSTENCIL", "1")
    calls = []
    original = jfp._build_call_pipe

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    monkeypatch.setattr(jfp, "_build_call_pipe", record)
    return calls


def _jax(x, lab, **kw):
    return np.asarray(jfp.fused_blur_unsharp_pipeline(
        jnp.asarray(x), 2.0, 1.0, 1.0, 3, TO=32, lab_roundtrip=lab,
        interpret=True, **kw))


@pytest.mark.parametrize("shape,nprog", [
    ((2, 64, 128, 3), 4),
    ((3, 32, 128, 3), 3),
    ((1, 32, 128, 3), 1),     # one program: _kernel_pipe's last step alone
])
def test_pipelined_matches_jax_pipe_kernel(pipe_spy, shape, nprog):
    x = _rand(shape, seed=sum(shape) + 20)
    ref = _jax(x, True)
    before = dict(gk.LAUNCHES)
    got = tfp.fused_blur_unsharp_pipeline(torch.from_numpy(x), 2.0, 1.0,
                                          1.0, 3, lab_roundtrip=True,
                                          pipelined=True)
    assert gk.LAUNCHES == before
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    # the JAX kernel that ran: _kernel_pipe over N * ntiles programs, with
    # the unsharp and Lab epilogues and the taps of blur_unsharp_taps
    ((args, kw),) = pipe_spy
    N, Hin, TO, ntiles = args[0], args[1], args[3], args[5]
    assert (N * ntiles, TO, Hin) == (nprog, 32, shape[1])
    assert kw["chan_epilogue"] is jfp._lab_roundtrip_rows
    _, unsharp = tfp.blur_unsharp_taps(shape[1], shape[2], 2.0, 1.0)
    assert kw["unsharp"] == (unsharp, unsharp, 1.0, 3)
    assert len(kw["guids"]) == args[6] == 3     # every G block, no h-stencil


def test_pipelined_without_lab_is_k2(pipe_spy):
    """Without Lab the JAX function ignores ``IMTPU_PIPE_KERNEL`` and the
    port ignores ``pipelined``: both give the sequential kernel's result."""
    x = _rand((2, 64, 128, 3), seed=21)
    ref = _jax(x, False)
    assert pipe_spy == []
    xt = torch.from_numpy(x)
    got = tfp.fused_blur_unsharp_pipeline(xt, 2.0, 1.0, 1.0, 3,
                                          pipelined=True)
    want = tfp.fused_blur_unsharp_pipeline(xt, 2.0, 1.0, 1.0, 3)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def test_jax_pipe_kernel_fails_with_the_hstencil(monkeypatch):
    """The JAX ``_kernel_pipe`` never runs on a shape its Lab path takes
    unless the h-stencil is switched off: the rewrite cuts ``guids`` to two
    G blocks, and ``_mxu_stage`` still walks every one of ``c0s``
    (``fused_pipeline.py:435-438``).  Kept visible here, not copied."""
    monkeypatch.setenv("IMTPU_PIPE_KERNEL", "1")
    monkeypatch.delenv("IMTPU_NO_HSTENCIL", raising=False)
    x = _rand((2, 64, 128, 3), seed=23)
    with pytest.raises(IndexError):
        _jax(x, True)
    with pytest.raises(IndexError):       # config #2's batch, traced only
        jax.eval_shape(
            lambda v: jfp.fused_blur_unsharp_pipeline(
                v, 2.0, 1.0, 1.0, 3, lab_roundtrip=True, interpret=True),
            jax.ShapeDtypeStruct((8, 1080, 1920, 3), jnp.float32))
    # the port runs that batch's shape on the pipelined route
    small = torch.from_numpy(x)
    assert tfp.fused_blur_unsharp_pipeline(
        small, 2.0, 1.0, 1.0, 3, lab_roundtrip=True,
        pipelined=True).shape == x.shape


@pytest.mark.parametrize("gain", [1.0, 0.6])
def test_pipe_kernel_on_cpu_is_the_plain_version(gain):
    x = torch.from_numpy(_rand((2, 37, 45, 3), seed=24))
    blur, unsharp = tfp.blur_unsharp_taps(37, 45, 2.0, 1.0)
    before = dict(gk.LAUNCHES)
    got = tfp.blur_unsharp_pipe_kernel(x, blur, unsharp, gain)
    assert gk.LAUNCHES == before
    want = tfp._blur_unsharp_plain(x, blur, unsharp, gain, lab=True)
    assert torch.equal(got, want)
    assert torch.equal(tfp._blur_unsharp_pipe_plain(x, blur, unsharp, gain),
                       want)


@pytest.mark.parametrize("case", [
    "float16", "flat_no_shape", "flat_channels", "nhwc_channels", "lanes",
    "rows", "even_taps", "radius_0", "radius_9", "lab_c1", "ndim",
    "blur_35", "channels_16",
])
def test_pipelined_declines_where_sequential_declines(case):
    x = _rand((2, 64, 128, 3), seed=25)
    args, kw = (2.0, 1.0, 1.0, 3), {"lab_roundtrip": True}
    if case == "float16":
        x = x.astype(np.float16)
    elif case == "flat_no_shape":
        x = x.reshape(128, 384)
    elif case == "flat_channels":
        x, kw["in_shape"] = x.reshape(128, 384), (2, 64, 96, 4)
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
        x, args = x[..., :1], (2.0, 1.0, 1.0, 1)
    elif case == "ndim":
        x = x[0]
    elif case == "blur_35":              # K2's and K2p's tap limit
        args = (5.0, 1.0, 1.0, 3)
    elif case == "channels_16":
        x, args = _rand((1, 32, 32, 16), seed=26), (2.0, 1.0, 1.0, 16)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    assert tfp.fused_blur_unsharp_pipeline(xt, *args, **kw) is None
    assert tfp.fused_blur_unsharp_pipeline(xt, *args, pipelined=True,
                                           **kw) is None


# -- K2p's schedule, shared memory and wrapper, replayed on the CPU ---------

_PIPE_SRC = (_build._SRC / "blur_unsharp_pipe.cu").read_text()


def _pipe_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _PIPE_SRC).group(1))


def _geometry(TW, TH, C, rb, ru):
    """``bu::geometry`` of ``csrc/blur_unsharp.cuh``: (xh, xa, zh, zp, xp,
    sp, a, b) in floats."""
    xw, xh = TW + 2 * (ru + rb), TH + 2 * (ru + rb)
    zw, zh = TW + 2 * ru, TH + 2 * ru
    xa = (xw * C + 6) // 4 * 4
    xp, zp, sp = (xw * C) | 1, (zw * C) | 1, (TW * C) | 1
    a = max(xh * xa, zh * zp)
    b = max(zh * xp, TH * zp, TH * sp)
    return a, b, sp


def _pipe_smem(TW, TH, nb, nu):
    """Bytes of K2p's shared memory: 8 mbarriers, two x slots (16-byte
    aligned), B, two stage slots of TH rows."""
    a, b, sp = _geometry(TW, TH, 3, nb // 2, nu // 2)
    return 4 * (2 * _pipe_const("BARRIERS") + 2 * (-(-a // 4) * 4) + b +
                2 * TH * sp)


def _pipe_plan(N, H, W, nb, nu, sms=132):
    """The C entry's choice: (TW, TH, compute, Lab threads), tiles and
    the persistent grid (one block an SM)."""
    if (nb, nu) == (15, 9):
        TW, TH = 64, 32
        ntc, ntl = _pipe_const("CONFIG2_COMPUTE"), _pipe_const("CONFIG2_LAB")
    else:
        TW, TH = 32, 32
        ntc, ntl = _pipe_const("GENERIC_COMPUTE"), _pipe_const("GENERIC_LAB")
    tiles_x = -(-W // TW)
    per_image = tiles_x * -(-H // TH)
    ntiles = N * per_image
    return TW, TH, ntc, ntl, tiles_x, per_image, ntiles, min(ntiles, sms)


def _tile_at(b, li, grid, tiles_x, per_image, TW, TH):
    t = b + li * grid
    n, r = divmod(t, per_image)
    ty, tx = divmod(r, tiles_x)
    return n, ty * TH, tx * TW


def _run_block(mine, ntc, ntl, loaders):
    """One block's three roles as generators over K2p's mbarriers, run
    in turn, a role stepping whenever its wait is met: returns, for each
    wait, the local tile whose arrivals completed the phase it waited
    for.  Raises on a deadlock."""
    phase = {name: [0, 0] for name in ("x_full", "x_empty", "s_full",
                                       "s_empty")}
    count = {"x_full": loaders, "x_empty": ntc, "s_full": ntc,
             "s_empty": ntl}
    pending = {name: [count[name]] * 2 for name in phase}
    last = {name: [[], []] for name in phase}   # tile that closed each phase
    seen = []

    def arrive(name, s, li, n):
        pending[name][s] -= n
        assert pending[name][s] >= 0
        if pending[name][s] == 0:
            phase[name][s] += 1
            pending[name][s] = count[name]
            last[name][s].append(li)

    def wait(name, s, parity):
        return (phase[name][s] & 1) != parity

    def loader():
        for li in range(mine):
            s, u = li & 1, li >> 1
            if u > 0:
                while not wait("x_empty", s, (u - 1) & 1):
                    yield
                seen.append(("load", li, last["x_empty"][s][u - 1]))
            arrive("x_full", s, li, loaders)

    def compute():
        for li in range(mine):
            s, u = li & 1, li >> 1
            while not wait("x_full", s, u & 1):
                yield
            seen.append(("compute x", li, last["x_full"][s][u]))
            arrive("x_empty", s, li, ntc)
            if u > 0:
                while not wait("s_empty", s, (u - 1) & 1):
                    yield
                seen.append(("compute stage", li, last["s_empty"][s][u - 1]))
            arrive("s_full", s, li, ntc)

    def lab():
        for li in range(mine):
            s, u = li & 1, li >> 1
            while not wait("s_full", s, u & 1):
                yield
            seen.append(("lab", li, last["s_full"][s][u]))
            arrive("s_empty", s, li, ntl)

    roles = [loader(), compute(), lab()]
    done = [False] * 3
    while not all(done):
        moved = False
        for i, role in enumerate(roles):
            if done[i]:
                continue
            before = len(seen), tuple(tuple(v) for v in phase.values())
            try:
                next(role)
            except StopIteration:
                done[i] = True
                moved = True
                continue
            after = len(seen), tuple(tuple(v) for v in phase.values())
            moved |= before != after
        assert moved or all(done), "the roles wait on one another"
    return seen


@pytest.mark.parametrize("shape,taps", [
    ((8, 1080, 1920), (15, 9)),    # config #2: 8160 tiles, 62 rounds
    ((2, 37, 45), (15, 9)),        # 4 tiles: fewer than the SMs
    ((1, 8, 128), (15, 9)),        # one tile row
    ((2, 300, 500), (15, 9)),      # 160 tiles: a short second round
    ((1, 40, 50), (33, 17)),       # the generic kernel's 32 x 32 tiles
    ((3, 130, 1400), (7, 3)),      # 495 generic tiles, a tail round
])
def test_pipe_tile_walk_covers_every_tile_once(shape, taps):
    N, H, W = shape
    TW, TH, ntc, ntl, tiles_x, per_image, ntiles, grid = _pipe_plan(
        N, H, W, *taps)
    seen = np.zeros((N, -(-H // TH), tiles_x), np.int64)
    rounds = []
    for b in range(grid):
        mine = (ntiles - 1 - b) // grid + 1
        rounds.append(mine)
        for li in range(mine):
            n, y0, x0 = _tile_at(b, li, grid, tiles_x, per_image, TW, TH)
            assert y0 < H and x0 < W
            seen[n, y0 // TH, x0 // TW] += 1
    assert (seen == 1).all()
    # the last round leaves some blocks one tile short, none more
    assert max(rounds) - min(rounds) <= 1
    assert sum(rounds) == ntiles and grid == min(ntiles, 132)


@pytest.mark.parametrize("mine", [1, 2, 3, 4, 7, 62])
def test_pipe_slots_hand_over_in_order(mine):
    """Each wait of each role is met by the phase its own tile's partner
    closed: the loader refills slot s after the compute warps' tile li-2,
    the compute warps read tile li's window and reuse stage slot s after
    the Lab warps' tile li-2, the Lab warps read tile li's stage."""
    ntc, ntl = _pipe_const("CONFIG2_COMPUTE"), _pipe_const("CONFIG2_LAB")
    seen = _run_block(mine, ntc, ntl, _pipe_const("LOADERS"))
    for what, li, by in seen:
        want = li if what in ("compute x", "lab") else li - 2
        assert by == want, (what, li, by)
    assert len([w for w in seen if w[0] == "lab"]) == mine


@pytest.mark.parametrize("TW,TH,nb,nu,stated", [
    (64, 32, 15, 9, 204960), (32, 32, 33, 17, 227328)])
def test_pipe_shared_memory_fits(TW, TH, nb, nu, stated):
    """Config #2's tile and the generic tile at its largest taps fit the
    232,448 bytes a block may use, as the source's header reckons them."""
    smem = _pipe_smem(TW, TH, nb, nu)
    assert smem == stated <= 232448
    assert f"{stated:,}" in _PIPE_SRC
    # the generic tile at every tap count it takes
    for b in range(1, 34, 2):
        for u in range(1, 18, 2):
            assert _pipe_smem(32, 32, b, u) <= 232448


class _FakeLib:
    def __init__(self):
        self.calls = []

    def k2p_blur_unsharp_pipe(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(tfp, "on_card", lambda x: True)
    monkeypatch.setattr(tfp, "stream_of", lambda x: 5678)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


@pytest.mark.parametrize("shape,nb,nu", [
    ((2, 30, 40, 3), 15, 9), ((1, 20, 20, 3), 33, 17),
    ((1, 8, 9, 3), 1, 1)])
def test_k2p_wrapper_passes_taps_by_value(fake_card, shape, nb, nu):
    x = torch.zeros(shape)
    bt = np.linspace(0.1, 1.0, nb).astype(np.float32)
    ut = np.linspace(1.0, 0.2, nu).astype(np.float32)
    before = gk.LAUNCHES["k2p"]
    y = tfp.blur_unsharp_pipe_kernel(x, bt, ut, 0.75)
    assert gk.LAUNCHES["k2p"] == before + 1
    (args,) = fake_card.calls
    sig = _build._SIGNATURES["k2p_blur_unsharp_pipe"]
    assert len(args) == len(sig) == 10
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is ctypes.c_float else int)
    xp, yp, tp, N, H, W, n_b, n_u, gain, stream = args
    assert (xp, yp) == (x.data_ptr(), y.data_ptr())
    assert (N, H, W, n_b, n_u, gain, stream) == (*shape[:3], nb, nu, 0.75,
                                                  5678)
    got = np.ctypeslib.as_array(
        (ctypes.c_float * (nb + nu)).from_address(tp))
    np.testing.assert_array_equal(got, np.concatenate([bt, ut]))
