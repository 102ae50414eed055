"""Port parity: ops/channel.py against the JAX module.

Every op is a slice, an index, a concatenation or (``set_alpha``'s
``copy`` and ``remove``) a few elementwise float32 ops in the JAX
function's order, so each output is held to the JAX one bit for bit.
Inputs come from a numpy seed: batches of 2 images of at most 96x128."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.ops import channel as tc

jc = importlib.import_module("imagemagick_tpu.ops.channel")


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


SHAPES = [(2, 48, 64, 3), (96, 128, 4), (2, 33, 17, 1), (2, 20, 30, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("channel", ["r", "green", "B", "alpha", "k", "gray"])
def test_separate_equals_jax(shape, channel):
    x = _img(shape, 1)
    _eq(tc.separate(torch.from_numpy(x), channel),
        jc.separate(jnp.asarray(x), channel))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_separate_all_and_combine_equal_jax(shape):
    x = _img(shape, 2)
    got = tc.separate_all(torch.from_numpy(x))
    want = jc.separate_all(jnp.asarray(x))
    assert len(got) == len(want) == shape[-1]
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(tc.combine(got), jc.combine(want))
    # combine takes the first channel of each member
    _eq(tc.combine([torch.from_numpy(x)] * 2),
        jc.combine([jnp.asarray(x)] * 2))


@pytest.mark.parametrize("order", [(2, 1, 0), (0, 0, 1), (1,)])
def test_swap_channels_equals_jax(order):
    x = _img((2, 24, 32, 3), 3)
    _eq(tc.swap_channels(torch.from_numpy(x), order),
        jc.swap_channels(jnp.asarray(x), order))


FX = ["red=>blue", "rgb=>bgr", "rgba=>bgra", "r<=>b", "g=>r,b=>g",
      "alpha=>red", "Red <=> Green, blue=>red", "r=>g, bgr=>rgb",
      "gray=>b", "a<=>r", "cyan=>yellow"]


@pytest.mark.parametrize("expr,channels", [
    (e, c) for e in FX for c in (3, 4) if not ("rgba" in e and c == 3)])
def test_channel_fx_equals_jax(expr, channels):
    x = _img((2, 40, 56, channels), 4)
    _eq(tc.channel_fx(torch.from_numpy(x), expr),
        jc.channel_fx(jnp.asarray(x), expr))


def test_channel_fx_does_not_write_its_input():
    x = torch.from_numpy(_img((8, 8, 3), 5))
    before = x.clone()
    tc.channel_fx(x, "r<=>b")
    tc.channel_fx(x, "red=>green")
    assert torch.equal(x, before)


def test_channel_fx_raises_on_a_missing_channel_where_jax_clamps():
    """The JAX function reads a channel past the last one clamped to the
    last and drops the write (``jnp`` out-of-range indexing); the port
    raises."""
    x = _img((8, 8, 3), 6)
    with pytest.raises(ValueError, match="not in a 3-channel"):
        tc.channel_fx(torch.from_numpy(x), "k=>red")
    with pytest.raises(ValueError, match="unknown channel"):
        tc.channel_fx(torch.from_numpy(x), "bogus=>red")
    clamped = np.asarray(jc.channel_fx(jnp.asarray(x), "k=>red"))
    np.testing.assert_array_equal(clamped[..., 0], x[..., 2])


ALPHA_OPS = ["set", "on", "activate", "opaque", "off", "deactivate",
             "remove", "flatten", "extract", "copy", "transparent",
             "Set", "OFF"]


@pytest.mark.parametrize("op", ALPHA_OPS)
@pytest.mark.parametrize("has_alpha", [False, True])
@pytest.mark.parametrize("background", [None, (0.2, 0.4, 0.6, 1.0)])
def test_set_alpha_equals_jax(op, has_alpha, background):
    x = _img((2, 48, 64, 4 if has_alpha else 3), 7)
    bg = None if background is None else background[:3]
    _eq(tc.set_alpha(torch.from_numpy(x), op, has_alpha, bg),
        jc.set_alpha(jnp.asarray(x), op, has_alpha, bg))


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
def test_channel_mean_is_jax_mean(channels):
    """``channel_mean`` has ``jnp.mean(x, -1)``'s bits: XLA sums the
    channels in order and multiplies by the reciprocal of their count."""
    x = _img((96, 128, channels), 8)
    np.testing.assert_array_equal(
        tc.channel_mean(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.mean(jnp.asarray(x), axis=-1)))


def test_unknown_alpha_operation_raises():
    with pytest.raises(ValueError, match="unknown alpha operation"):
        tc.set_alpha(torch.zeros(4, 4, 3), "sideways", False)
