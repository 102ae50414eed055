"""Port parity: ops/vision.py against the JAX package.

Connected-component labels are held to equality (int32), at 4 and 8
neighbours, with fuzz, on batches, and at iteration caps around the
port's fixpoint-test stride; so are the sequential relabeling, the merge
of small components (the port's passes look only at each component's box
and ring), the statistics of image 0 and ``area_threshold`` of one image.
The JAX ``area_threshold`` counts labels across the images of a batch,
where equal labels of different images collide; the port counts each
image's own."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.ops import vision as jv
from imagemagick_tpu_torch.ops import vision as tv


def _blobs(shape, seed=0, p=0.6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape) > p).astype(np.float32)


def _levels(shape, seed=0, n=3):
    x = np.random.default_rng(seed).uniform(0, 1, shape)
    return (np.round(x * n) / n).astype(np.float32)


def _equal(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.int32 or got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


INPUTS = [("blobs", (24, 32, 1), 0.0), ("batch", (3, 24, 32, 1), 0.0),
          ("levels", (20, 28, 3), 0.0), ("fuzzy", (2, 20, 28, 3), 0.2),
          ("fine", (40, 40, 1), 0.0)]


def _input(kind, shape, seed):
    return _levels(shape, seed) if kind in ("levels", "fuzzy") else \
        _blobs(shape, seed, 0.45 if kind == "fine" else 0.6)


@pytest.mark.parametrize("kind,shape,fuzz", INPUTS, ids=[i[0] for i in INPUTS])
@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("seed", range(2))
def test_connected_components_equal_jax(kind, shape, fuzz, conn, seed):
    x = _input(kind, shape, seed)
    got = tv.connected_components(torch.from_numpy(x), conn, fuzz)
    assert got.dtype == torch.int32
    _equal(got, jv.connected_components(jnp.asarray(x), conn, fuzz))


@pytest.mark.parametrize("max_iters", [1, 2, 31, 32, 33])
def test_connected_components_caps_equal_jax(max_iters):
    x = _blobs((30, 30, 1), 3, 0.4)
    _equal(tv.connected_components(torch.from_numpy(x), 4,
                                   max_iters=max_iters),
           jv.connected_components(jnp.asarray(x), 4, max_iters=max_iters))


@pytest.mark.parametrize("shape", [(24, 32, 1), (2, 24, 32, 1)], ids=str)
def test_relabel_sequential_equals_jax(shape):
    lab = jv.connected_components(jnp.asarray(_blobs(shape, 4)), 4)
    got = tv.relabel_sequential(torch.from_numpy(np.asarray(lab)))
    assert got.dtype == torch.int32
    _equal(got, jv.relabel_sequential(lab))


@pytest.mark.parametrize("shape", [(24, 32, 1), (40, 40, 1), (2, 24, 32, 1)],
                         ids=str)
@pytest.mark.parametrize("min_area", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("conn", [4, 8])
def test_merge_small_components_equals_jax(shape, min_area, conn):
    seq = jv.relabel_sequential(jv.connected_components(
        jnp.asarray(_blobs(shape, 5, 0.5)), conn))
    got = tv.merge_small_components(torch.from_numpy(seq), min_area, conn)
    _equal(got, jv.merge_small_components(seq, min_area, conn))
    _equal(tv.merge_small_components(seq, min_area, conn),
           jv.merge_small_components(seq, min_area, conn))


@pytest.mark.parametrize("min_area", [0, 3])
@pytest.mark.parametrize("c", [1, 3])
def test_component_statistics_equal_jax(min_area, c):
    x = _levels((2, 20, 28, c), 6)
    lab = jv.relabel_sequential(jv.connected_components(jnp.asarray(x), 4))
    got = tv.component_statistics(torch.from_numpy(x), torch.from_numpy(lab),
                                  min_area)
    assert got == jv.component_statistics(jnp.asarray(x), jnp.asarray(lab),
                                          min_area)
    # of a batch, image 0 only
    assert got == tv.component_statistics(torch.from_numpy(x[0]),
                                          torch.from_numpy(lab[0]), min_area)


@pytest.mark.parametrize("min_area", [1, 3, 6])
def test_area_threshold_of_one_image_equals_jax(min_area):
    x = _blobs((24, 32, 1), 7)
    lab = jv.connected_components(jnp.asarray(x), 4)
    _equal(tv.area_threshold(torch.from_numpy(x),
                             torch.from_numpy(np.asarray(lab)), min_area, 0.5),
           jv.area_threshold(jnp.asarray(x), lab, min_area, 0.5))


def test_jax_area_threshold_counts_across_the_batch():
    """Image 0 holds a 2x2 object at the top-left, image 1 a single pixel
    there: both carry label 0.  The JAX function counts 5 pixels of label
    0 and keeps image 1's pixel at min_area=2; the port counts each
    image's own and removes it, as the JAX function does on image 1
    alone."""
    x = np.zeros((2, 6, 6, 1), np.float32)
    x[0, :2, :2] = 1.0
    x[1, 0, 0] = 1.0
    x[:, 4, 4] = 1.0
    lab = jv.connected_components(jnp.asarray(x), 4)
    want = np.asarray(jv.area_threshold(jnp.asarray(x), lab, 2))
    assert want[1, 0, 0, 0] == 1.0              # kept by image 0's area
    got = tv.area_threshold(torch.from_numpy(x),
                            torch.from_numpy(np.asarray(lab)), 2)
    assert got[1, 0, 0, 0].item() == 0.0
    for i in range(2):
        _equal(got[i], jv.area_threshold(jnp.asarray(x[i]), lab[i], 2))
