"""Kernel K2's host side, on the CPU.

* ``gpu_kernels.constant_on`` makes one tensor per (values, dtype,
  device).
* K2's wrapper hands the C entry ``k2_blur_unsharp`` its taps in host
  memory (the C entry copies them into the kernel's arguments), in the
  order and with the counts of ``_build._SIGNATURES``; ``_build.load`` is
  stubbed, so nothing is compiled or launched.  The kernel itself is held
  to its plain version and to K2p on the card (``tests/test_torch_gpu.py``,
  ``chip_smoke.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import fused_pipeline as fp
from imagemagick_tpu_torch.ops import gpu_kernels as gk


def _taps(n, sigma):
    j = n // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


# -- constant_on -------------------------------------------------------------

@pytest.mark.parametrize("values,dtype", [
    ((0.25, 0.5, 0.25), torch.float32), ((3, 1, 4, 1, 5), torch.int32),
    ((), torch.float32)])
def test_constant_on_makes_one_tensor(values, dtype):
    a = gk.constant_on(values, dtype, torch.device("cpu"))
    b = gk.constant_on(tuple(values), dtype, torch.device("cpu"))
    assert a is b
    assert a.dtype == dtype and a.shape == (len(values),)
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(values, a.numpy().dtype))


def test_constant_on_tells_values_apart():
    cpu = torch.device("cpu")
    a = gk.constant_on((1.0, 2.0), torch.float32, cpu)
    assert gk.constant_on((1.0, 2.5), torch.float32, cpu) is not a
    assert gk.constant_on((1.0, 2.0), torch.int32, cpu) is not a


# -- K2's wrapper against the C entry's signature ----------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def k2_blur_unsharp(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K2's wrapper takes its card path for CPU tensors, with a library
    that records each call."""
    lib = _FakeLib()
    monkeypatch.setattr(fp, "on_card", lambda x: True)
    monkeypatch.setattr(fp, "stream_of", lambda x: 1234)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    return lib


@pytest.mark.parametrize("shape,nb,nu,lab", [
    ((2, 30, 40, 3), 15, 9, True), ((1, 8, 9, 1), 1, 1, False),
    ((1, 20, 20, 8), 33, 17, False), ((3, 17, 70, 3), 15, 9, False),
    ((1, 5, 7, 5), 7, 3, False)])
def test_k2_wrapper_passes_taps_by_value(fake_card, shape, nb, nu, lab):
    x = torch.zeros(shape)
    bt, ut = _taps(nb, nb / 7.0), _taps(nu, nu / 9.0)
    before = gk.LAUNCHES["k2"]
    y = fp.blur_unsharp_kernel(x, bt, ut, 0.75, lab)
    assert gk.LAUNCHES["k2"] == before + 1
    (args,) = fake_card.calls
    sig = _build._SIGNATURES["k2_blur_unsharp"]
    assert len(args) == len(sig) == 12
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is ctypes.c_float else int)
    xp, yp, tp, N, H, W, C, n_b, n_u, gain, lab_arg, stream = args
    assert (xp, yp) == (x.data_ptr(), y.data_ptr())
    assert (N, H, W, C, n_b, n_u) == (*shape, nb, nu)
    assert (gain, lab_arg, stream) == (0.75, int(lab), 1234)
    # the host buffer: the blur taps, then the unsharp taps, as float32,
    # nothing between or after them
    host = gk.constant_on(tuple(float(t) for t in bt) +
                          tuple(float(t) for t in ut), torch.float32,
                          torch.device("cpu"))
    assert tp == host.data_ptr() and host.numel() == nb + nu
    got = np.ctypeslib.as_array(
        (ctypes.c_float * (nb + nu)).from_address(tp))
    np.testing.assert_array_equal(got, np.concatenate([bt, ut]))

