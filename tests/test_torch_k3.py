"""Kernel K3's host side, on the CPU.

K3's wrapper (``gpu_kernels.separable_blur``) hands the C entry
``k3_separable_blur`` its taps in host memory (the C entry copies them
into the kernel's arguments), in the order and with the types of
``_build._SIGNATURES``; ``_build.load`` is stubbed, so nothing is
compiled or launched.  The kernel itself is held to its plain version on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``) and to the
kernel of another commit on every value (``k2_ab.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import gpu_kernels as gk


def _taps(n, sigma):
    j = n // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def k3_separable_blur(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K3's wrapper takes its card path for CPU tensors, with a library
    that records each call."""
    lib = _FakeLib()
    monkeypatch.setattr(gk, "on_card", lambda x: True)
    monkeypatch.setattr(gk, "stream_of", lambda x: 4321)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


@pytest.mark.parametrize("shape,ntaps", [
    ((8, 30, 40, 3), 15), ((2, 30, 40, 3), 9), ((1, 8, 9, 1), 1),
    ((1, 20, 20, 8), 33), ((3, 17, 70, 2), 7), ((1, 5, 7, 4), 3)])
def test_k3_wrapper_passes_taps_by_value(fake_card, shape, ntaps):
    x = torch.zeros(shape)
    taps = _taps(ntaps, max(ntaps / 5.0, 0.5))
    before = gk.LAUNCHES["k3"]
    y = gk.separable_blur(x, taps)
    assert gk.LAUNCHES["k3"] == before + 1
    (args,) = fake_card.calls
    sig = _build._SIGNATURES["k3_separable_blur"]
    assert len(args) == len(sig) == 9
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is ctypes.c_float else int)
    xp, yp, tp, N, H, W, C, n, stream = args
    assert (xp, yp) == (x.data_ptr(), y.data_ptr())
    assert y.shape == x.shape and y.dtype == torch.float32
    assert (N, H, W, C, n, stream) == (*shape, ntaps, 4321)
    # the host buffer: the taps as float32, nothing after them
    host = gk.constant_on(tuple(float(t) for t in taps), torch.float32,
                          torch.device("cpu"))
    assert tp == host.data_ptr() and host.numel() == ntaps
    assert host.device.type == "cpu"
    got = np.ctypeslib.as_array((ctypes.c_float * ntaps).from_address(tp))
    np.testing.assert_array_equal(got, taps)


@pytest.mark.parametrize("shape,ntaps", [
    ((1, 8, 8, 3), 35), ((1, 8, 8, 3), 4), ((1, 8, 8, 9), 3),
    ((1, 0, 8, 3), 3)])
def test_k3_wrapper_refuses_before_the_entry(fake_card, shape, ntaps):
    """What K3 does not take (over 33 taps, an even count, more than 8
    channels, an empty batch) raises before the C entry is called."""
    before = gk.LAUNCHES["k3"]
    with pytest.raises(ValueError):
        gk.separable_blur(torch.zeros(shape), np.ones(ntaps) / ntaps)
    assert fake_card.calls == [] and gk.LAUNCHES["k3"] == before
