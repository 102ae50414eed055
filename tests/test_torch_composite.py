"""Port parity: imagemagick_tpu_torch.ops.composite against the JAX package.

Every operator name ``composite`` takes, on seeded pairs with and without
alpha and gray against color, through both packages.  The operators are
the same float32 expressions in the same order: atol 1e-6 on values in
[0, 1].  An operator that raises on one side raises the same error on the
other.  ``composite_at`` under every gravity, with offsets that crop the
overlay, is held to equality (placement only copies)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import composite as jc
from imagemagick_tpu_torch.ops import composite as tc


def _pixels(shape, seed):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if shape[-1] in (2, 4):
        x[..., :3, :4, -1] = 0.0             # transparent corner
        x[..., 5:7, 5:9, -1] = 1.0           # opaque block
    return x


# (dst channels, dst alpha, src channels, src alpha)
PAIRS = [(4, True, 4, True), (3, False, 3, False), (3, False, 4, True),
         (4, True, 3, False), (3, False, 1, False), (1, False, 3, False),
         (2, True, 4, True), (1, False, 1, False)]
ARGS = [(), (35.0,), (150.0, 40.0), (0.5, 0.25, -0.3, 0.1)]


def _run(fn_j, fn_t, *a, **kw):
    try:
        ref = np.asarray(fn_j(*[jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v for v in a], **kw))
    except Exception as e:          # noqa: BLE001 - compared below
        ref = e
    try:
        got = fn_t(*[torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v for v in a], **kw)
        got = got.numpy()
    except Exception as e:          # noqa: BLE001
        got = e
    return ref, got


def test_operator_list_is_every_name_the_dispatcher_takes():
    """OPERATORS holds the 48 named operators and the 33 blend modes; the
    JAX dispatcher takes every one and rejects another name."""
    assert len(tc.OPERATORS) == len(set(tc.OPERATORS)) == 81
    assert set(tc._BLEND_FNS) == set(jc._BLEND_FNS)
    x = _pixels((4, 5, 3), 0)
    for op in tc.OPERATORS:
        jc.composite(jnp.asarray(x), jnp.asarray(x), op)
    for side in (jc, tc):
        arr = jnp.asarray(x) if side is jc else torch.from_numpy(x)
        with pytest.raises(ValueError, match="unsupported composite"):
            side.composite(arr, arr, "no-such-op")


@pytest.mark.parametrize("op", tc.OPERATORS)
@pytest.mark.parametrize("pair", PAIRS, ids=[f"d{p[0]}{'a' * p[1]}-s{p[2]}"
                                             f"{'a' * p[3]}" for p in PAIRS])
def test_composite_matches(op, pair):
    dc, da, sc, sa = pair
    dst = _pixels((2, 12, 16, dc), 1)
    src = _pixels((2, 12, 16, sc), 2)
    if op in ("displace", "distort"):
        dst, src = dst[0], src[0]     # the JAX function takes one image
    for args in ARGS:
        ref, got = _run(jc.composite, tc.composite, dst, src, op, da, sa,
                        args)
        if isinstance(ref, Exception) or isinstance(got, Exception):
            assert type(ref) is type(got), (op, args, ref, got)
            continue
        assert got.shape == ref.shape, (op, args)
        np.testing.assert_allclose(got, ref, atol=1e-6,
                                   err_msg=f"{op} {args}")


@pytest.mark.parametrize("op", ["blend", "mathematics", "dissolve",
                                "threshold", "modulate"])
def test_composite_args_match(op):
    """The argument forms each operator reads (composite.c's defines)."""
    dst = _pixels((12, 16, 4), 3)
    src = _pixels((12, 16, 4), 4)
    for args in [(), (0.0,), (100.0,), (250.0,), (30.0, 80.0),
                 (-20.0, 50.0), (1.0, -1.0, 0.5, 0.0), (0.3,)]:
        ref, got = _run(jc.composite, tc.composite, dst, src, op, True,
                        True, args)
        np.testing.assert_allclose(got, ref, atol=1e-6,
                                   err_msg=f"{op} {args}")


def test_modulus_wraps_with_a_floored_modulus():
    """jnp.mod is floored: the blend function of modulussubtract maps a
    negative difference into [0, 1), as torch.remainder does (fmod would
    keep it negative)."""
    s = np.array([0.1, 0.9, 0.5, 0.0], np.float32)
    d = np.array([0.8, 0.2, 0.5, 1.0], np.float32)
    for name in ("modulusadd", "modulussubtract"):
        ref = np.asarray(jc._BLEND_FNS[name](jnp.asarray(s), jnp.asarray(d)))
        got = tc._BLEND_FNS[name](torch.from_numpy(s),
                                  torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)
        assert (got >= 0).all()


@pytest.mark.parametrize("gravity", tc.GRAVITIES + ("SouthEast", None))
@pytest.mark.parametrize("offset", [(0, 0), (3, 2), (-4, -3), (20, 30)])
def test_composite_at_matches(gravity, offset):
    dst = _pixels((2, 12, 16, 3), 5)
    src = _pixels((5, 7, 4), 6)
    assert tc.gravity_offset(gravity, 16, 12, 7, 5, *offset) == \
        jc.gravity_offset(gravity, 16, 12, 7, 5, *offset)
    ref, got = _run(jc.composite_at, tc.composite_at, dst, src, "over",
                    *offset, gravity, False, True)
    np.testing.assert_array_equal(got, ref)
    ref, got = _run(jc.composite_at, tc.composite_at, dst, src[..., :3],
                    "dissolve", *offset, gravity, False, False, (35.0,))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("xy", [(0, 0), (-3, -2), (10, 8), (-10, 0),
                                (16, 0)])
def test_place_matches(xy):
    dst = _pixels((2, 12, 16, 3), 7)
    src = _pixels((2, 5, 7, 4), 8)
    ref = np.asarray(jc.place(jnp.asarray(dst), jnp.asarray(src), *xy))
    got = tc.place(torch.from_numpy(dst), torch.from_numpy(src), *xy)
    assert np.array_equal(got.numpy(), ref)


def test_displace_samples_each_image_at_its_own_map():
    """A batch of displacement maps samples each canvas at its own map in
    the port; the JAX function raises on a batch (its sampler's ``take``
    crosses the two batch axes, and the result no longer concatenates
    with the alpha)."""
    dst = _pixels((2, 12, 16, 4), 9)
    src = _pixels((2, 12, 16, 4), 10)
    ref, got = _run(jc.composite, tc.composite, dst, src, "displace", True,
                    True, (30.0,))
    assert isinstance(ref, Exception)
    assert got.shape == (2, 12, 16, 4)
    for i in range(2):
        want = np.asarray(jc.composite(jnp.asarray(dst[i]),
                                       jnp.asarray(src[i]), "displace",
                                       True, True, (30.0,)))
        np.testing.assert_allclose(got[i], want, atol=1e-6)
