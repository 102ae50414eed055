"""Port parity: the morphology module against the JAX package, bit-exact
on binary and 8-bit images (min, max and small-integer sums are exact;
the convolutions add their taps in the JAX package's order).

The distance transform takes each row's left side as one cumulative
minimum rounded once, where the JAX package's min-plus scan rounds after
each combine: with integer seeds and costs (a binary image under
Chebyshev or Manhattan) every value is an integer and the two are held
to equality; otherwise (Euclidean's sqrt(2), 8-bit seeds) to 2.5e-7 of
the [0, 1] result, two float32 ulps of a distance near 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import morphology as jmo
from imagemagick_tpu_torch.ops import morphology as tmo

SPECS = [
    "unity", "gaussian:0x1", "log:0x1", "dog:0,1,2", "blur:0x1",
    "comet:0x1", "sobel", "roberts", "prewitt", "compass", "kirsch",
    "freichen", "laplacian:1", "laplacian:5", "diamond:2", "square:1",
    "octagon:2", "disk:2.5", "plus:1", "cross:2", "ring:1,3",
    "rectangle:3x2", "corners", "lineends", "linejunctions", "edges",
    "peaks", "skeleton", "thinse", "chebyshev", "manhattan:50",
    "euclidean", "sobel>", "3x3: 0,1,0 1,-4,1 0,1,0", "2x3:1,-,1,1,nan,0",
]

METHODS = ["erode", "dilate", "erodeintensity", "dilateintensity", "open",
           "close", "openintensity", "closeintensity", "smooth", "edge",
           "edgein", "edgeout", "tophat", "bottomhat", "convolve",
           "correlate"]


def _image(kind, seed, shape=(2, 23, 29, 1)):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        x = (rng.random(shape) < 0.45).astype(np.float32)
        x[:, 8:14, 6:20] = 1.0             # a block that survives opening
        return x
    return (rng.integers(0, 256, shape) / 255.0).astype(np.float32)


@pytest.mark.parametrize("spec", SPECS)
def test_get_kernel_tables_equal(spec):
    ref = jmo.get_kernel(spec)
    got = tmo.get_kernel(spec)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["binary", "8bit"])
@pytest.mark.parametrize("spec", ["square:1", "diamond:2", "rectangle:4x1",
                                  "plus:1"])
def test_morphology_methods(method, kind, spec):
    x = _image(kind, len(method) + len(spec))
    ref = np.asarray(jmo.morphology(jnp.asarray(x), method, spec))
    got = tmo.morphology(torch.from_numpy(x), method, spec)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("method,spec", [
    ("hitandmiss", "corners"), ("hmt", "peaks"), ("hitandmiss", "edges"),
    ("thinning", "skeleton"), ("thinning", "lineends"),
    ("thicken", "linejunctions"), ("erode", "corners"),
])
@pytest.mark.parametrize("kind", ["binary", "8bit"])
def test_hit_and_miss_family(method, spec, kind):
    x = _image(kind, 5, (1, 21, 26, 1))
    ref = np.asarray(jmo.morphology(jnp.asarray(x), method, spec))
    got = tmo.morphology(torch.from_numpy(x), method, spec)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("method,spec,iterations", [
    ("thinning", "skeleton", -1), ("erode", "square:1", 3),
    ("dilate", "disk:1.5", 0), ("close", "diamond:1", 2),
])
def test_iterations(method, spec, iterations):
    x = _image("binary", 6, (2, 18, 22, 1))
    ref = np.asarray(jmo.morphology(jnp.asarray(x), method, spec,
                                    iterations=iterations))
    got = tmo.morphology(torch.from_numpy(x), method, spec,
                         iterations=iterations)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("virtual_pixel", ["edge", "black", "white",
                                           "mirror", "tile"])
def test_virtual_pixel_and_channels(virtual_pixel):
    x = _image("8bit", 7, (19, 23, 3))         # one unbatched RGB image
    for method, spec in (("hitandmiss", "corners"), ("close", "square:2"),
                         ("convolve", "sobel")):
        ref = np.asarray(jmo.morphology(jnp.asarray(x), method, spec,
                                        virtual_pixel=virtual_pixel))
        got = tmo.morphology(torch.from_numpy(x), method, spec,
                             virtual_pixel=virtual_pixel)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_primitives_direct():
    x = _image("8bit", 8, (2, 15, 16, 2))
    k = jmo.get_kernel("disk:2")[0]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jmo.erode(jx, k), tmo.erode(tx, k)),
        (jmo.dilate(jx, k), tmo.dilate(tx, k)),
        (jmo.convolve_kernel(jx, k, normalize=True, bias=0.1),
         tmo.convolve_kernel(tx, k, normalize=True, bias=0.1)),
        (jmo.correlate_kernel(jx, jmo.get_kernel("sobel")[0]),
         tmo.correlate_kernel(tx, tmo.get_kernel("sobel")[0])),
        (jmo.hit_and_miss(jx, jmo.get_kernel("corners")[1]),
         tmo.hit_and_miss(tx, tmo.get_kernel("corners")[1])),
    ]
    for ref, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("metric", ["chebyshev", "manhattan", "euclidean"])
@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("kind", ["binary", "8bit"])
def test_distance_transform_matches(metric, radius, kind):
    x = _image(kind, 40, (2, 23, 29, 2))
    x[0, :, :3] = 0.0                     # a background strip
    for scale in (0.01, 0.1):
        ref = np.asarray(jmo.distance_transform(jnp.asarray(x), metric,
                                                scale, radius))
        got = tmo.distance_transform(torch.from_numpy(x), metric, scale,
                                     radius).numpy()
        assert got.shape == x.shape
        if kind == "binary" and metric != "euclidean":
            assert np.array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=2.5e-7)


@pytest.mark.parametrize("spec", ["euclidean", "chebyshev:1,500",
                                  "manhattan:3", "euclidean:4,200",
                                  "octagon:2"])
def test_morphology_distance_matches(spec):
    """The ``distance`` method reads metric, radius and scale from the
    kernel spec (an unknown metric name means Euclidean)."""
    x = _image("binary", 41)
    ref = np.asarray(jmo.morphology(jnp.asarray(x), "distance", spec))
    got = tmo.morphology(torch.from_numpy(x), "distance", spec).numpy()
    if spec.startswith(("chebyshev", "manhattan")):
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=2.5e-7)
    assert got.max() > 0.0


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        tmo.morphology(torch.zeros((1, 4, 4, 1)), "no-such", "square:1")


def test_roadmap_pointers_name_live_entries():
    """The port's pointers into ROADMAP.md name entries by title, and
    each title is still there."""
    from pathlib import Path

    from imagemagick_tpu_torch.ops import fused_pipeline as tfp

    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md"
               ).read_text()
    doc = " ".join(tfp.fused_blur_unsharp_pipeline.__doc__.split())
    assert '"A capability gap, not a rank"' in doc
    assert "**A capability gap, not a rank.**" in roadmap
