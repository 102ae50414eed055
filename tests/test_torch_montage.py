"""Port parity: ops/montage.py against the JAX package.

Lists of seeded images of several sizes and channel counts through both
packages' ``montage``: the grid, the thumbnails (the port's
``thumbnail``), the borders (``decorate.border``) and the labels
(``draw.annotate``, the same font) composited onto the canvas.  Pixels
within atol 1e-6 (the thumbnails' resamples are float32 sums held to
the JAX ones in their own files); shapes and specs equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core.image import Image as JImage
from imagemagick_tpu.core.spec import ImageSpec as JSpec
from imagemagick_tpu.ops import montage as jmo
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
from imagemagick_tpu_torch.ops import montage as tmo


def _images(n, c=3, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for k in range(n):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        cc = c if isinstance(c, int) else c[k % len(c)]
        a = rng.uniform(0, 1, (h, w, cc)).astype(np.float32)
        alpha = cc in (2, 4)
        cs = "gray" if cc in (1, 2) else "srgb"
        props = {"label": f"img{k}"} if labels else {}
        js.append(JImage(jnp.asarray(a), JSpec(colorspace=cs, alpha=alpha),
                         props))
        ts.append(TImage(torch.from_numpy(a), TSpec(colorspace=cs,
                                                     alpha=alpha), props))
    return js, ts


def _same(got, want, atol=1e-6):
    assert repr(got.spec) == repr(want.spec)
    w = np.asarray(want.data)
    assert tuple(got.data.shape) == w.shape
    np.testing.assert_allclose(got.data.numpy(), w, atol=atol, rtol=0)


@pytest.mark.parametrize("n", [1, 5, 9])
@pytest.mark.parametrize("tile", ["", "3x2", "4x", "2x5"])
@pytest.mark.parametrize("geometry", ["30x30+2+1", "24x16+0+0", "20x"])
def test_grid_equals_jax(n, tile, geometry):
    js, ts = _images(n, seed=n)
    _same(tmo.montage(ts, tile, geometry),
          jmo.montage(js, tile, geometry))


@pytest.mark.parametrize("c", [4, 1, (3, 4), (4, 1, 3)], ids=str)
@pytest.mark.parametrize("border", [0, 2])
def test_channels_and_borders_equal_jax(c, border):
    js, ts = _images(5, c, seed=3)
    bg = (0.2, 0.3, 0.4)
    _same(tmo.montage(ts, "3x2", "28x28+3+2", bg, border_width=border),
          jmo.montage(js, "3x2", "28x28+3+2", bg, border_width=border))


@pytest.mark.parametrize("label_height", [0, 14, 20])
def test_labels_equal_jax(label_height):
    js, ts = _images(4, seed=5, labels=True)
    got = tmo.montage(ts, "2x2", "40x40+4+3", label_height=label_height)
    want = jmo.montage(js, "2x2", "40x40+4+3", label_height=label_height)
    _same(got, want)
    if label_height:
        bare = tmo.montage(ts, "2x2", "40x40+4+3")
        assert got.data.shape[0] == bare.data.shape[0] + 2 * label_height


def test_empty_list_raises_as_jax():
    with pytest.raises(ValueError):
        jmo.montage([])
    with pytest.raises(ValueError):
        tmo.montage([])
