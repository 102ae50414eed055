"""Port parity: ops/distort.py's samplers against the JAX package —
every virtual-pixel mode, alpha through ``_premult_sample``, ``rotate``
and the affine transforms, the EWA tables and buckets, the
``limit_reached`` path, the blocked scan of wide buckets, ``swirl``,
``implode`` and ``wave``, every ``sparse_color`` method and
``liquid_rescale`` — on images of at most 2 x 48x64x4.

Bound: as in ``test_torch_distort.py``, every value within 1e-5 of the
JAX one but at most 0.1 % of the pixels, where a selection differs (an
EWA bin, a scan bound, a bilinear floor moved by an ulp of a
transcendental).  The float64 ellipse tables and the bucket keys are
held to equality, and so are the liquid-rescale seams (the carved
image, with no resize after it, equals the JAX one)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import distort as jd
from imagemagick_tpu_torch.ops import distort as td

TOL = 1e-5
SELECT_SHARE = 1e-3
QUAD = [0, 0, 3, 2, 63, 0, 60, 5, 0, 47, 2, 44, 63, 47, 58, 40]


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def assert_close(got, want, tol=TOL):
    """Within ``tol`` but for at most 0.1 % of the pixels."""
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - want)
    px = d.reshape(-1, d.shape[-1])
    n_off = int((px > tol).any(-1).sum())
    assert n_off <= SELECT_SHARE * px.shape[0], (n_off, float(d.max()))

VPS = ["edge", "undefined", "mirror", "tile", "black", "gray", "white",
       "mask", "transparent", "background", "horizontaltile",
       "verticaltile", "horizontaltileedge", "verticaltileedge",
       "checkertile", "dither", "random"]


@pytest.mark.parametrize("vp", VPS)
def test_virtual_pixels_match_jax(vp):
    """Each virtual-pixel mode through the constant-Jacobian EWA (srt,
    bestfit), the per-pixel EWA (barrel) and the bilinear warp."""
    x = _img((2, 48, 64, 3), 2)
    bg = (0.1, 0.2, 0.3, 1.0)
    for method, args, sampler in (("srt", [0.7, 25], "ewa"),
                                  ("barrel", [0.2, 0.0, 0.0], "ewa"),
                                  ("srt", [0.7, 25], "bilinear")):
        got = td.distort(torch.from_numpy(x), method, args, background=bg,
                         sampler=sampler, bestfit=method == "srt", vp=vp)
        want = jd.distort(jnp.asarray(x), method, args, background=bg,
                          sampler=sampler, bestfit=method == "srt", vp=vp)
        assert got.shape[-1] == (4 if vp == "transparent" else 3)
        assert_close(got, want)


@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("method,args", [("srt", [0.8, 20]),
                                         ("barrel", [0.05, 0.0, 0.0]),
                                         ("perspective", QUAD)])
def test_alpha_resamples_premultiplied(method, args, c):
    """Images with alpha go through ``_premult_sample``."""
    x = _img((2, 48, 64, c), 3)
    x[..., -1] = np.where(x[..., -1] < 0.2, 0.0, x[..., -1])
    bg = (0.5,) * (c - 1) + (0.25,)
    for bestfit in (False, True):
        assert_close(td.distort(torch.from_numpy(x), method, args,
                                background=bg, bestfit=bestfit,
                                vp="background"),
                     jd.distort(jnp.asarray(x), method, args, background=bg,
                                bestfit=bestfit, vp="background"))


@pytest.mark.parametrize("deg", [0, 30, -17.5, 90, 180, 270, 450])
@pytest.mark.parametrize("c", [3, 4])
def test_rotate_matches_jax(deg, c):
    x = _img((2, 48, 64, c), 4)
    bg = (1.0,) * c
    for expand, sampler in ((True, "ewa"), (False, "ewa"),
                            (True, "bilinear")):
        assert_close(td.rotate(torch.from_numpy(x), deg, bg, expand,
                               sampler),
                     jd.rotate(jnp.asarray(x), deg, bg, expand, sampler))


@pytest.mark.parametrize("matrix", [(1.1, 0.1, -0.2, 0.9, 3, -2),
                                    (0.5, 0.0, 0.0, 0.5, 0, 0),
                                    (2.0, 0.3, 0.0, 1.5, -4, 7)])
def test_affine_transforms_match_jax(matrix):
    x = _img((2, 48, 64, 3), 5)
    assert_close(td.affine_transform(torch.from_numpy(x), matrix),
                 jd.affine_transform(jnp.asarray(x), matrix))
    assert_close(td.affine_transform(torch.from_numpy(x), matrix, (30, 40),
                                     (0.0, 0.5, 1.0), "ewa"),
                 jd.affine_transform(jnp.asarray(x), matrix, (30, 40),
                                     (0.0, 0.5, 1.0), "ewa"))
    assert_close(td.affine_projection_bestfit(torch.from_numpy(x), matrix,
                                              (1.0, 1.0, 1.0)),
                 jd.affine_projection_bestfit(jnp.asarray(x), matrix,
                                              (1.0, 1.0, 1.0)))


def _jac_maps(h, w, seed):
    """Per-pixel Jacobians: rotations, shears, scalings up and down and
    a degenerate (identity-like) block."""
    rng = np.random.default_rng(seed)
    a, b, c, d = [rng.uniform(-2.5, 2.5, (h, w)) for _ in range(4)]
    a[:4], b[:4], c[:4], d[:4] = 1.0, 0.0, 0.0, 1.0
    a[4:8], b[4:8], c[4:8], d[4:8] = 0.3, 0.0, 0.0, 0.3
    return a, b, c, d


def test_clamped_ellipse_tables_equal_jax():
    jac = _jac_maps(40, 50, 7)
    for got, want in zip(td._clamped_ellipse_np(*jac),
                         jd._clamped_ellipse_np(*jac)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert td._robidoux_lut().numpy().tobytes() == \
        np.asarray(jd._robidoux_lut()).tobytes()


def _jax_buckets(nv, uw, norm):
    """The JAX function's bucket loop (distort.py:343-347)."""
    keys = {}
    for i in np.nonzero(norm)[0]:
        k = (jd._pow2_bucket(int(nv[i])), jd._pow2_bucket(int(uw[i])))
        keys.setdefault(k, []).append(i)
    return [(k, np.asarray(v, np.int64)) for k, v in sorted(keys.items())]


@pytest.mark.parametrize("seed", [7, 8])
def test_ewa_bucket_keys_equal_jax(seed):
    a, b, c, d = _jac_maps(40, 50, seed)
    A, B, C, F = td._clamped_ellipse_np(a * 3, b * 5, c, d * 9)
    F = F * 4.0
    det = np.maximum(A * C - 0.25 * B * B, 1e-300)
    nv = (2.0 * np.sqrt(A * F / det)).astype(np.int64).ravel() + 2
    uw = (2.0 * np.sqrt(F / np.maximum(A, 1e-300))).astype(
        np.int64).ravel() + 1
    norm = np.random.default_rng(seed).uniform(size=nv.shape) > 0.1
    got = td._ewa_buckets(nv, uw, norm)
    want = _jax_buckets(nv, uw, norm)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(want) > 3
    for (_, gi), (_, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
    for n in (0, 1, 3, 4, 5, 8, 9, 1000):
        assert td._pow2_bucket(n) == jd._pow2_bucket(n) == \
            int(td._pow2_bucket_np(np.asarray([n]))[0])


@pytest.mark.parametrize("c", [1, 3, 4])
def test_ewa_reference_var_matches_jax(c):
    """Per-pixel Jacobians with buckets from 4x4 to wide ones, offsets
    off the canvas, under a background virtual pixel."""
    x = _img((2, 24, 32, c), 9)
    h, w = 20, 26
    rng = np.random.default_rng(10)
    u = rng.uniform(-6, 37, (h, w))
    v = rng.uniform(-6, 29, (h, w))
    jac = _jac_maps(h, w, 11)
    bg = (0.3,) * c
    assert_close(td.sample_ewa_reference_var(torch.from_numpy(x), u, v, jac,
                                             bg),
                 jd.sample_ewa_reference_var(jnp.asarray(x), u, v, jac, bg))


def test_limit_reached_pixels_match_jax():
    """Pixels whose ellipse covers more than 4x the image take the
    4-neighbour average (resample.c:1197)."""
    x = _img((2, 24, 32, 3), 12)
    h, w = 12, 16
    rng = np.random.default_rng(13)
    u = rng.uniform(0, 31, (h, w))
    v = rng.uniform(0, 23, (h, w))
    a, b, c, d = _jac_maps(h, w, 14)
    a[::3, ::2], b[::3, ::2], c[::3, ::2], d[::3, ::2] = 200.0, 0, 0, 150.0
    s = np.sqrt(4.0 * 200 * 150 * 4)
    assert s * s > 4.0 * 24 * 32
    for vp in ("edge", "tile"):
        assert_close(td.sample_ewa_reference_var(torch.from_numpy(x), u, v,
                                                 (a, b, c, d), vp=vp),
                     jd.sample_ewa_reference_var(jnp.asarray(x), u, v,
                                                 (a, b, c, d), vp=vp))


@pytest.mark.parametrize("block,scan", [
    (1 << 25, "one block"), (6 * 16 * 18 * 3, "scanline blocks"),
    (6 * 8 * 5, "pixel chunks"), (1, "pixel chunks")],
    ids=["one-block", "scanline-blocks", "chunks", "single-rows"])
def test_ewa_scan_paths_match_the_jax_loop(monkeypatch, block, scan):
    """Every bucket as one block, in blocks of a few scanlines, or in
    chunks of a few pixels (down to one pixel and one scanline a block):
    the JAX loop's weights and taps, summed in another order."""
    x = _img((2, 24, 32, 3), 15)
    h, w = 16, 20
    rng = np.random.default_rng(16)
    u = rng.uniform(-3, 34, (h, w))
    v = rng.uniform(-3, 26, (h, w))
    jac = _jac_maps(h, w, 17)
    want = jd.sample_ewa_reference_var(jnp.asarray(x), u, v, jac)
    plan, scans = td._ewa_plan, set()

    def spy(n, nbc, nvb, uwb):
        chunk, kb = plan(n, nbc, nvb, uwb)
        scans.add("pixel chunks" if chunk < n else
                  "scanline blocks" if kb < nvb else "one block")
        return chunk, kb

    monkeypatch.setattr(td, "_EWA_BLOCK", block)
    monkeypatch.setattr(td, "_ewa_plan", spy)
    got = td.sample_ewa_reference_var(torch.from_numpy(x), u, v, jac)
    assert scan in scans
    assert_close(got, want)


def test_ewa_weight_mask_is_the_jax_mask():
    """``-1 < Q < 1024`` admits exactly the taps whose int32 truncation
    lies in [0, 1024), with the same LUT bin."""
    q = np.array([-2.0, -1.0, -0.9999999, -0.5, -1e-7, 0.0, 0.5, 1.0,
                  511.5, 1022.9999, 1023.0, 1023.9999, 1024.0, 1024.5,
                  3e9, -3e9], np.float32)
    lut = np.asarray(jd._robidoux_lut())
    qi = q.astype(np.int64)
    ok = (qi >= 0) & (qi < 1024)
    want = np.where(ok, lut[np.clip(qi, 0, 1023)], 0.0)
    got = td._ewa_weight(torch.from_numpy(q), td._robidoux_lut()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [2, 4])
def test_sample_ewa_and_warp_match_jax(window):
    x = _img((2, 24, 32, 3), 18)
    rng = np.random.default_rng(19)
    u = rng.uniform(-5, 36, (20, 26)).astype(np.float32)
    v = rng.uniform(-5, 28, (20, 26)).astype(np.float32)
    U, V = torch.from_numpy(u), torch.from_numpy(v)
    for bg in (None, (0.1, 0.2, 0.3)):
        assert_close(td.sample_ewa(torch.from_numpy(x), U, V, bg, window),
                     jd.sample_ewa(jnp.asarray(x), jnp.asarray(u),
                                   jnp.asarray(v), bg, window))
        for sampler, jac in (("bilinear", None), ("ewa", None),
                             ("ewa", (0.8, 0.3, -0.2, 1.7))):
            assert_close(td.warp(torch.from_numpy(x), U, V, bg, sampler,
                                 jac),
                         jd.warp(jnp.asarray(x), jnp.asarray(u),
                                 jnp.asarray(v), bg, sampler, jac))


def test_rotate_bilinear_works_where_the_jax_function_raises():
    """The JAX ``rotate_bilinear`` passes an undefined ``vp`` and raises
    NameError on every call; the port samples with the edge policy, the
    default of ``sample_bilinear``, which the JAX sampler matches."""
    x = _img((2, 24, 32, 3), 20)
    with pytest.raises(NameError):
        jd.rotate_bilinear(jnp.asarray(x), 0.3)
    h, w = 24, 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ct, st = math.cos(0.3), math.sin(0.3)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    u = ct * (jnp.asarray(xx) - cx) + st * (jnp.asarray(yy) - cy) + cx
    v = -st * (jnp.asarray(xx) - cx) + ct * (jnp.asarray(yy) - cy) + cy
    for bg in (None, (1.0, 1.0, 1.0)):
        assert_close(td.rotate_bilinear(torch.from_numpy(x), 0.3, bg),
                     jd.sample_bilinear(jnp.asarray(x), u, v, bg))


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (40, 30, 4)], ids=str)
def test_swirl_implode_wave_match_jax(shape):
    x = _img(shape, 21)
    X, J = torch.from_numpy(x), jnp.asarray(x)
    bg = (0.2, 0.3, 0.4, 1.0)
    for deg in (60.0, -200.0):
        assert_close(td.swirl(X, deg), jd.swirl(J, deg))
        assert_close(td.swirl(X, deg, bg), jd.swirl(J, deg, bg))
    for amount in (0.5, -1.0, 2.0):
        assert_close(td.implode(X, amount), jd.implode(J, amount))
    for amp, lam in ((5.0, 20.0), (-3.0, 7.0), (2.5, 0.0)):
        assert_close(td.wave(X, amp, lam, bg), jd.wave(J, amp, lam, bg))


POINTS = [(5, 5, (1.0, 0.0, 0.0, 1.0)), (50, 10, (0.0, 1.0, 0.0, 1.0)),
          (20, 40, (0.0, 0.0, 1.0, 0.5)), (60, 45, (1.0, 1.0, 0.0, 1.0)),
          (33.5, 21.25, (0.2, 0.4, 0.6))]


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("method", ["shepards", "shepard", "voronoi",
                                    "inverse", "barycentric", "bilinear"])
def test_sparse_color_matches_jax(method, c):
    x = _img((48, 64, c), 22)
    got = td.sparse_color(torch.from_numpy(x), method, POINTS)
    assert got.shape == (48, 64, c)
    assert_close(got, jd.sparse_color(jnp.asarray(x), method, POINTS))
    with pytest.raises(ValueError):
        td.sparse_color(torch.from_numpy(x), "nosuch", POINTS)


def test_liquid_rescale_seams_equal_jax():
    """No resize after the carve, so equal outputs are equal seams."""
    x = _img((20, 24, 3), 23)
    got = td.liquid_rescale(torch.from_numpy(x), 20, 20)
    want = jd.liquid_rescale(jnp.asarray(x), 20, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a resize after the carve, and the resize fallback
    assert_close(td.liquid_rescale(torch.from_numpy(x), 21, 14),
                 jd.liquid_rescale(jnp.asarray(x), 21, 14))
    assert_close(td.liquid_rescale(torch.from_numpy(x), 30, 25),
                 jd.liquid_rescale(jnp.asarray(x), 30, 25))


def test_liquid_rescale_carves_each_image_of_a_batch():
    """The JAX function raises on a batch (its scan runs over the batch
    axis); the port carves each image along its own seams, as the JAX
    function carves that image alone."""
    x = _img((2, 20, 24, 3), 24)
    with pytest.raises(TypeError):
        jd.liquid_rescale(jnp.asarray(x), 20, 20)
    got = td.liquid_rescale(torch.from_numpy(x), 20, 20)
    assert got.shape == (2, 20, 20, 3)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jd.liquid_rescale(jnp.asarray(x[i]), 20, 20)))
