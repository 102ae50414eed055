"""Port parity: chain dispatch onto K1 against the JAX package's dispatch.

The JAX dispatch runs its kernel in the Pallas interpreter (bf16
three-pass split); the port's CPU path is the float32 plain version, so
outputs agree at atol 2e-5."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu_torch.ops import dispatch as tdsp

jdsp = importlib.import_module("imagemagick_tpu.ops.dispatch")

GRAY_TAG = ("mix", ((0.212656, 0.715158, 0.072186),))


@pytest.fixture()
def jax_interpret(monkeypatch):
    monkeypatch.setattr(jdsp, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jdsp, "STRICT", True)


def _natural(h, w, seed=0):
    """Smooth gradient + modest texture + a hard-edged block (the content
    of the JAX package's dispatch tests)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 17.0)[..., None] * np.cos(
        xx / 23.0)[..., None]
    tex = 0.08 * rng.standard_normal((h, w, 3)).astype(np.float32)
    img = np.clip(base + tex, 0.0, 1.0).astype(np.float32)
    img[h // 3:h // 2, w // 4:w // 2] = 0.95
    return img


@pytest.mark.parametrize("prefix", [
    (("resize", (24, 32, "lanczos")), ("gblur", (0.0, 1.5, "2d")),
     ("mix", ((0.25, 0.5, 0.25),))),
    (("gblur", (0.0, 1.0, "1d")), ("resize", (20, 20, "mitchell"))),
    (GRAY_TAG, ("resize", (10, 30, "triangle"))),
    (("resize", (80, 80, "lanczos")),),                 # upscale: None
    (("mix", ((1.0, 0.0),)),),                         # wrong width: None
])
def test_plan_chain_equal(prefix):
    j = jdsp._plan_chain(40, 56, 3, prefix)
    t = tdsp._plan_chain(40, 56, 3, prefix)
    if j is None:
        assert t is None
        return
    for a, b in zip(j, t):
        if a is None:
            assert b is None
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_helpers_equal():
    for H, W, C in ((64, 96, 3), (70, 90, 1), (500, 750, 4)):
        assert tdsp._aligned_dims(H, W, C) == jdsp._aligned_dims(H, W, C)
    t_resize = ("resize", (10, 10, "lanczos"))
    t_blur = ("gblur", (0.0, 2.0, "2d"))
    for tags in ([t_resize, t_blur, GRAY_TAG], [GRAY_TAG], [None, t_resize],
                 [t_blur, None, GRAY_TAG]):
        assert tdsp.match_prefix(tags) == jdsp.match_prefix(tags)


def test_try_fused_batch_array_matches(jax_interpret):
    x = np.stack([_natural(64, 96, seed=i) for i in range(3)])
    tags = [("resize", (32, 48, "lanczos")), ("gblur", (0.0, 1.0, "2d")),
            GRAY_TAG]
    ref = np.asarray(jdsp.try_fused_batch_array(jnp.asarray(x), tags))
    before = tdsp.COUNTS["fused"]
    got = tdsp.try_fused_batch_array(torch.from_numpy(x), tags)
    assert tdsp.COUNTS["fused"] == before + 1
    assert got.shape == ref.shape == (3, 32, 48, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_try_fused_chain_matches_prefix(jax_interpret):
    x = _natural(64, 96, seed=4)
    tags = [("resize", (40, 60, "lanczos")), ("gblur", (0.0, 1.5, "2d")),
            None, GRAY_TAG]
    ref, jn = jdsp.try_fused_chain(jnp.asarray(x), tags)
    got, tn = tdsp.try_fused_chain(torch.from_numpy(x), tags)
    assert tn == jn == 2
    assert got.shape == ref.shape == (40, 60, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_non_expressible_chains_decline():
    x = torch.from_numpy(np.stack([_natural(64, 96, seed=i)
                                   for i in range(2)]))
    assert tdsp.try_fused_batch_array(x, [None]) is None
    assert tdsp.try_fused_batch_array(x, [GRAY_TAG]) is None
    assert tdsp.try_fused_batch_array(
        x, [("resize", (128, 128, "lanczos"))]) is None          # upscale
    assert tdsp.try_fused_batch_array(
        x, [("resize", (32, 48, "lanczos")), None]) is None      # partial
    assert tdsp.try_fused_chain(x[0], [("sharpen", (1.0,))]) is None
    assert tdsp.try_fused_chain(x[0, :4], [("resize", (2, 2, "box"))]) \
        is None                                                 # too small


def test_alpha_requires_opaque():
    rgb = _natural(32, 48, seed=2)
    tag = ("resize", (16, 24, "lanczos"))
    semi = np.concatenate([rgb, np.full((32, 48, 1), 0.5, np.float32)], -1)
    assert tdsp.try_fused_chain(torch.from_numpy(semi), [tag],
                                alpha=True) is None
    opaque = np.concatenate([rgb, np.ones((32, 48, 1), np.float32)], -1)
    out, n = tdsp.try_fused_chain(torch.from_numpy(opaque), [tag],
                                  alpha=True)
    assert n == 1 and out.shape == (16, 24, 4)
    np.testing.assert_allclose(out[..., 3].numpy(), 1.0, atol=1e-5)
