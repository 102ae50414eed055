"""Kernel K5's word algorithm and host side, on the CPU.

``csrc/morph_edge.cu`` packs 32 pixels of a row into a word by warp
ballots (four interleaved words a float4 load where W % 4 == 0), runs the five 3x3 stages as shifts, shuffles, ANDs and ORs of
words, and streams strips of rows down the image with a 5-row halo.
``replay`` below does the same on uint32 words held in int64 tensors,
lane for lane: the warp's groups of words with their halo words, the bit
copied over the bits beyond W before each stage, pixel 0 standing in for
its own left neighbour, each stage's first and last row standing in for
the rows above and below, and the rows and lanes a strip writes.  It must
equal K5's plain version (``gpu_kernels._morph_edge_reference``, held to
the JAX package in ``test_torch_config3.py``) bit for bit.  The kernel
itself is held to its plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  K5's wrapper is checked against its C entry's
signature with ``_build.load`` stubbed.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import gpu_kernels as gk

M32 = 0xFFFFFFFF
HALO, GROUP = 5, 30      # as in csrc/morph_edge.cu


def _lanes(a, shift):
    """The word of lane l + shift at lane l; a lane past the warp's end
    gets its own word, as __shfl_up_sync / __shfl_down_sync give it."""
    if shift < 0:
        return torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _fix(a, p, keep):
    top = (a >> p) & 1
    return torch.where(top == 1, a | (~keep & M32), a & keep)


def _hred(a, op, first, last, p, keep):
    a = _fix(a, p, keep)
    wl = torch.where(first, (a << 31) & M32, _lanes(a, -1))
    wr = torch.where(last, a >> 31, _lanes(a, 1))
    left = ((a << 1) & M32) | (wl >> 31)
    right = (a >> 1) | ((wr << 31) & M32)
    return a & left & right if op == 0 else a | left | right


def replay(x, thr, S):
    """K5 on an (N, H, W) float32 tensor, thresholds (N,), strips of S
    output rows, as the CUDA kernel computes it."""
    N, H, W = x.shape
    nw = -(-W // 32)
    ngroups = 1 if nw <= 32 else -(-nw // GROUP)
    base = torch.tensor([0] if ngroups == 1 else
                        [GROUP * g - 1 for g in range(ngroups)])
    lane = torch.arange(32)
    wi = base[:, None] + lane                               # (G, 32)
    first, last = wi == 0, wi == nw - 1
    p = torch.where(last, torch.tensor((W - 1) % 32), torch.tensor(31))
    keep = torch.where(p == 31, torch.tensor(M32), (1 << (p + 1)) - 1)
    mine = (wi >= 0) & (wi < nw)
    if ngroups > 1:
        mine &= (lane >= 1) & (lane <= GROUP)
    # stage 0: pixel (wb * 32 + b) of each lane's word, 0.0 outside the
    # image as the kernel loads it, compared with the image's threshold
    cols = wi[..., None] * 32 + lane                       # (G, 32, 32)
    inside = (wi[..., None] >= 0) & (wi[..., None] < nw) & (cols < W)
    pix = torch.where(inside, x[:, :, cols.clamp(0, W - 1)],
                      torch.zeros(()))                      # (N,H,G,32,32)
    bits = (pix > thr.view(N, 1, 1, 1, 1)).long()
    words = (bits << lane).sum(-1)                          # (N, H, G, 32)
    y = torch.zeros(N, H, W)
    for strip in range(-(-H // S)):
        r0, r1 = strip * S, min(strip * S + S, H)
        R0 = max(r0 - HALO, 0)
        L = min(r1 + HALO, H) - R0
        st = [dict() for _ in range(5)]
        for i in range(L + HALO):
            a = words[:, R0 + i] if i < L else None
            out = None
            for k, op in zip(range(1, 6), (0, 1, 1, 0, 2)):
                s = st[k - 1]
                r = 1 if op == 1 else 0
                emitted = None
                if i == k - 1:
                    s["hp"] = s["hc"] = _hred(a, r, first, last, p, keep)
                    s["c"] = a
                elif k <= i <= k + L - 1:
                    hn = s["hc"] if i == k + L - 1 else \
                        _hred(a, r, first, last, p, keep)
                    m = (s["hp"] & s["hc"] & hn) if r == 0 else \
                        (s["hp"] | s["hc"] | hn)
                    emitted = s["c"] & (~m & M32) if op == 2 else m
                    s["hp"], s["hc"], s["c"] = s["hc"], hn, a
                a = emitted
                out = emitted
            row = R0 + i - HALO
            if out is not None and r0 <= row < r1:
                px = ((out[..., None] >> lane) & 1).float()  # (N, G, 32, 32)
                ok = mine[..., None] & (cols < W)
                y[:, row, cols[ok]] = px[:, ok]
    return y


def _batch(N, H, W, seed):
    """Uniform pixels, per-image thresholds, some pixels exactly on their
    image's threshold and some NaN."""
    rng = np.random.default_rng(seed)
    x = rng.random((N, H, W)).astype(np.float32)
    t = rng.uniform(0.3, 0.7, N).astype(np.float32)
    on = rng.random((N, H, W)) < 0.1
    x[on] = np.broadcast_to(t[:, None, None], x.shape)[on]
    x[rng.random((N, H, W)) < 0.03] = np.nan
    return torch.from_numpy(x), torch.from_numpy(t)


@pytest.mark.parametrize("W", [1, 31, 32, 33, 61, 816, 1025])
@pytest.mark.parametrize("H", [1, 2, 5, 6, 11, 77])
def test_word_replay_equals_plain(H, W):
    x, t = _batch(2, H, W, seed=H * 10007 + W)
    want = gk._morph_edge_reference(x, t)
    for S in (1, 8, 64):
        got = replay(x, t, S)
        assert torch.equal(got, want), (H, W, S)


def _spread4(x):
    x = (x | (x << 12)) & 0x000F000F
    x = (x | (x << 6)) & 0x03030303
    return (x | (x << 3)) & 0x11111111


@pytest.mark.parametrize("seed", range(3))
def test_vector_packing_equals_words(seed):
    """Where W % 4 == 0 the kernel reads 128 pixels a float4 load: ballot
    c of segment s has bit l = pixel 128 s + 4 l + c, and lane L (segment
    L // 4, byte k = L % 4) ORs spread4(byte k of ballot c) << c.  That is
    word L, bit i = pixel 32 L + i, for every lane of a 1024-pixel row."""
    bits = np.random.default_rng(seed).random(1024) < 0.5
    ballots = [[sum(int(bits[128 * s + 4 * lane + c]) << lane
                    for lane in range(32)) for c in range(4)]
               for s in range(8)]
    for L in range(32):
        k = 8 * (L % 4)
        v = 0
        for c in range(4):
            v |= _spread4((ballots[L // 4][c] >> k) & 0xFF) << c
        word = sum(int(bits[32 * L + i]) << i for i in range(32))
        assert v == word, L


def test_edge_is_v_and_not_erode():
    """clip(9 v - sum, 0, 1) == v & ~erode(v) on all 512 binary 3x3
    windows."""
    w = ((np.arange(512)[:, None] >> np.arange(9)) & 1).astype(np.float32)
    v = w[:, 4]
    edge = np.clip(9.0 * v - w.sum(1), 0.0, 1.0)
    want = v.astype(int) & ~w.min(1).astype(int) & 1
    np.testing.assert_array_equal(edge, want.astype(np.float32))


# -- K5's wrapper against the C entry's signature ----------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def k5_morph_edge(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gk, "on_card", lambda x: True)
    monkeypatch.setattr(gk, "stream_of", lambda x: 5150)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


@pytest.mark.parametrize("shape", [(16, 1056, 816, 1), (2, 77, 61),
                                   (1, 1, 1), (70000, 2, 3)])
def test_k5_wrapper_matches_the_entry(fake_card, shape):
    x = torch.zeros(shape)
    t = torch.linspace(0.2, 0.8, shape[0])
    before = gk.LAUNCHES["k5"]
    y = gk.fused_bilevel_morph_edge(x, t)
    assert gk.LAUNCHES["k5"] == before + 1
    assert y.shape == x.shape
    (args,) = fake_card.calls
    sig = _build._SIGNATURES["k5_morph_edge"]
    assert len(args) == len(sig) == 7
    for arg in args:
        assert isinstance(arg, int)
    xp, tp, yp, N, H, W, stream = args
    assert (N, H, W) == shape[:3] and stream == 5150
    assert xp == x.data_ptr() and yp == y.data_ptr()
    got = np.ctypeslib.as_array((ctypes.c_float * N).from_address(tp))
    np.testing.assert_array_equal(got, t.numpy())
