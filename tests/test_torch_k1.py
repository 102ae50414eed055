"""Kernel K1's window tables and host side, on the CPU.

K1 (``csrc/fused_pipeline.cu``) stages each chunk of its output lanes
over the chunk's range ``kr``, multiplies each warp's 8 output lanes over
the rows of its G block that ``hwin`` names, and folds each warp's 16
output rows over the band columns that ``vwin`` names.  A window
narrower than the operator's non-zeros would change the result silently,
so for every plan the tests and the chip run use: every entry of GB and
WV outside the windows is exactly 0.0, every window is aligned and lies
inside its chunk's range (and inside BAND, and inside the 32-lane range
K1 multiplied over before it had windows), and no window is wider than it
must be.  K1's wrapper
is checked against its C entry's signature with ``_build.load`` stubbed.
The kernel itself is held to its plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``) and to the K1 of another
commit on every value (``k1_k5_ab.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import dispatch
from imagemagick_tpu_torch.ops import fused_pipeline as fp
from imagemagick_tpu_torch.ops import gpu_kernels as gk
from imagemagick_tpu_torch.ops.resize import resize_matrix

GRAY = ((0.212656, 0.715158, 0.072186),)
EYE3 = tuple(map(tuple, np.eye(3).tolist()))


def _resize_plan(H, W, C, Hout, Wout, sigma, mix, TO):
    WV, r0s, BAND, ntiles, GB, c0s, *_ = fp._plan(H, W, C, Hout, Wout,
                                                  "lanczos", sigma, mix, TO)
    return WV, GB


def _thumbnail_plan(h, w, winc_pad=None):
    """Config #5's step: Lanczos to 256x256x3 on the staged flat layout
    (rows to %8, lanes to %128), identity mix, no blur."""
    h8 = -(-h // 8) * 8
    wcp = winc_pad or -(-w * 3 // 128) * 128
    Mv = np.pad(resize_matrix(h, 256, "lanczos").astype(np.float64).T,
                ((0, 0), (0, h8 - h)))
    Mw = resize_matrix(w, 256, "lanczos").astype(np.float64).T
    plan = fp.linear_plan([(Mv, Mw)], 3, np.eye(3), 64, h8, wcp)
    return plan.WV, plan.GB


def _thumbnailer_step_plan(grayscale):
    """The plan the port's thumbnailer step makes at config #5's real
    staged layout: a 768x512 JPEG decoded at 1/2 (256 rows of 1152
    lanes, an H resize of 256 -> 256) to 256x256."""
    from imagemagick_tpu_torch.models import thumbnailer as tn

    cfg = tn.ThumbnailerConfig(grayscale=grayscale)
    plan = tn.make_flat_step(cfg, 256, 384, device="cpu").plan
    return plan.WV, plan.GB


def _two_term_plan():
    Bv, Bw = fp.blur_band_matrix(64, 1.0), fp.blur_band_matrix(512, 1.0)
    Uv = fp.blur_band_matrix(64, 0.8, width_rule="1d")
    Uw = fp.blur_band_matrix(512, 0.8, width_rule="1d")
    plan = fp.linear_plan([(1.7 * Bv, Bw), (-0.7 * (Uv @ Bv), Uw @ Bw)], 1,
                          np.eye(1), 32, 64, 512)
    return plan.WV, plan.GB


def _dispatch_plan(H=70, W=90, Hout=40, Wout=36, sigma=1.5):
    tags = (("resize", (Hout, Wout, "lanczos")),
            ("gblur", (0.0, sigma, "2d")), ("mix", GRAY))
    Mv, Mw, mix, *_ = dispatch._plan_chain(H, W, 3, tags)
    Hp, Wp = dispatch._aligned_dims(H, W, 3)
    Mv = np.pad(Mv, ((0, 0), (0, Hp - H)))
    Mw = np.pad(Mw, ((0, 0), (0, Wp - W)))
    plan = fp.linear_plan([(Mv, Mw)], 3, mix, dispatch._TO, Hp, Wp * 3)
    return plan.WV, plan.GB


PLANS = {
    "config1": lambda: _resize_plan(512, 768, 3, 256, 256, 2.0, GRAY, 64),
    "config5": lambda: _thumbnail_plan(512, 768),
    "config5_winc_pad": lambda: _thumbnail_plan(500, 100, winc_pad=512),
    "config5_staged": lambda: _thumbnailer_step_plan(False),
    "config5_staged_gray": lambda: _thumbnailer_step_plan(True),
    # the CLI's and the serve sessions' plan at config #1's shape
    "config1_cli": lambda: _dispatch_plan(512, 768, 256, 256, 2.0),
    # the shapes of test_torch_gpu.py's test_k1_matches_plain
    "gpu_a": lambda: _resize_plan(64, 128, 3, 32, 32, 1.5, GRAY, 16),
    "gpu_b": lambda: _resize_plan(96, 256, 1, 40, 100, 1.0, ((1.0,),), 128),
    "gpu_c": lambda: _resize_plan(200, 384, 3, 57, 77, 2.5, EYE3, 64),
    "gpu_d": lambda: _resize_plan(64, 512, 1, 24, 200, 2.5, ((1.0,),), 32),
    "two_terms": _two_term_plan,
    "dispatch": _dispatch_plan,
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_lane_windows_hold_every_nonzero(name):
    WV, GB = PLANS[name]()
    n, span, _ = GB.shape
    kr, hwin = fp._depth_ranges(GB), fp._lane_windows(GB)
    old = fp._windows((GB.reshape(n, span, 4, 32) != 0).any(axis=3), 32)
    assert hwin.shape == (n, 128 // fp._WARP_LANES, 2)
    per_chunk = fp._LANES // fp._WARP_LANES
    for g in range(n):
        for h in range(hwin.shape[1]):
            lo, hi = map(int, hwin[g, h])
            lanes = GB[g, :, h * fp._WARP_LANES:(h + 1) * fp._WARP_LANES]
            assert lo % 4 == 0 and hi % 4 == 0 and 0 <= lo <= hi <= span
            assert not lanes[:lo].any() and not lanes[hi:].any()
            rows = np.nonzero(lanes.any(axis=1))[0]
            if len(rows):       # the window is the non-zeros, 4-aligned
                assert lo == rows[0] // 4 * 4
                assert hi == -(-(rows[-1] + 1) // 4) * 4
            else:
                assert (lo, hi) == (0, 0)
            klo, khi = map(int, kr[g, h // per_chunk])
            assert lo == hi == 0 or klo <= lo <= hi <= khi
            # and inside the range K1 multiplied over before its windows:
            # the 32-lane chunk's non-zero rows, 32-aligned
            olo, ohi = map(int, old[g, h // 4])
            assert lo == hi == 0 or olo <= lo <= hi <= ohi


@pytest.mark.parametrize("name", sorted(PLANS))
def test_row_windows_hold_every_nonzero(name):
    WV, GB = PLANS[name]()
    nt, TO, BAND = WV.shape
    vwin = fp._row_windows(WV)
    assert vwin.shape == (nt, -(-TO // fp._WARP_ROWS), 2)
    for t in range(nt):
        for g in range(vwin.shape[1]):
            lo, hi = map(int, vwin[t, g])
            rows = WV[t, g * fp._WARP_ROWS:(g + 1) * fp._WARP_ROWS]
            assert lo % 4 == 0 and hi % 4 == 0 and 0 <= lo <= hi <= BAND
            assert not rows[:, :lo].any() and not rows[:, hi:].any()
            cols = np.nonzero(rows.any(axis=0))[0]
            assert (lo, hi) == ((cols[0] // 4 * 4,
                                 -(-(cols[-1] + 1) // 4) * 4)
                                if len(cols) else (0, 0))


def test_windows_cut_config1_arithmetic():
    """Config #1: the warps' windows are about half the depth K1 took
    before them (a 32-lane chunk's 456 rows), and a warp's 16 rows fold
    over about 70 of the 176 band rows."""
    WV, GB = PLANS["config1"]()
    n, span, _ = GB.shape
    old = fp._windows((GB.reshape(n, span, 4, 32) != 0).any(axis=3), 32)
    hwin, vwin = fp._lane_windows(GB), fp._row_windows(WV)
    depth = (hwin[..., 1] - hwin[..., 0]).mean()
    assert 200 < depth < 0.55 * (old[..., 1] - old[..., 0]).mean()
    assert (vwin[..., 1] - vwin[..., 0]).mean() < 0.45 * WV.shape[2]


# -- K1's wrapper against the C entry's signature ----------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def k1_fused_pipeline(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(fp, "on_card", lambda x: True)
    monkeypatch.setattr(fp, "stream_of", lambda x: 2718)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


@pytest.mark.parametrize("N,clip", [(2, True), (1, False)])
def test_k1_wrapper_matches_the_entry(fake_card, N, clip):
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = fp._plan(
        64, 128, 3, 32, 32, "lanczos", 1.5, GRAY, 16)
    ops = fp.plan_to_tensors(WV, GB, fp.flat_r0(r0s, N, 64), "cpu")
    x = torch.zeros((N * 64, 384))
    guids = tuple(range(len(c0s)))
    before = gk.LAUNCHES["k1"]
    out = fp.fused_kernel(x, ops, c0s, guids, ntiles, clip)
    assert gk.LAUNCHES["k1"] == before + 1
    (args,) = fake_card.calls
    sig = _build._SIGNATURES["k1_fused_pipeline"]
    assert len(args) == len(sig) == 21
    assert all(isinstance(a, int) for a in args)
    (r0p, xp, wvp, gbp, krp, hwp, vwp, c0p, gidp, outp, nprog, nt, nterms,
     nb, TO, band, span, winc, outp_, clip_, stream) = args
    assert (r0p, xp, wvp, gbp, krp, hwp, vwp, outp) == tuple(
        t.data_ptr() for t in (ops.r0, x, ops.WV, ops.GB, ops.kr, ops.hwin,
                               ops.vwin, out))
    assert (nprog, nt, nterms, nb, TO, band, span, winc, outp_, clip_,
            stream) == (N * ntiles, ntiles, 1, len(c0s), 16, BAND, SPAN,
                        384, OUTP, int(clip), 2718)
    assert out.shape == (N * ntiles * 16, OUTP)
    for ptr, want in ((c0p, c0s), (gidp, guids)):
        got = np.ctypeslib.as_array(
            (ctypes.c_int32 * len(want)).from_address(ptr))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ops.hwin.numpy(), fp._lane_windows(GB))
    np.testing.assert_array_equal(ops.kr.numpy(), fp._depth_ranges(GB))
    np.testing.assert_array_equal(ops.vwin.numpy(), fp._row_windows(WV))


def test_k1_wrapper_refuses_bad_tables(fake_card):
    WV, r0s, BAND, ntiles, GB, c0s, *_ = fp._plan(
        64, 128, 3, 32, 32, "lanczos", 1.5, GRAY, 16)
    ops = fp.plan_to_tensors(WV, GB, fp.flat_r0(r0s, 1, 64), "cpu")
    x = torch.zeros((64, 384))
    guids = tuple(range(len(c0s)))
    for bad in (ops._replace(hwin=ops.hwin[:, :8].contiguous()),
                ops._replace(vwin=ops.vwin.long()),
                ops._replace(vwin=ops.vwin[:, :0].contiguous()),
                ops._replace(kr=ops.kr[:, :1].contiguous())):
        with pytest.raises(ValueError):
            fp.fused_kernel(x, bad, c0s, guids, ntiles)
    assert fake_card.calls == []
