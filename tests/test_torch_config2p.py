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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagemagick_tpu.ops import fused_pipeline as jfp
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
