"""Helpers shared by the wand parity tests (``test_torch_wand.py``,
``test_torch_wandtest.py``): a JAX wand and a port wand over the same
images, and the bounds their pixels are held to.

* ``EXACT`` (0): both wands run the same op, and the op's test holds it
  bit for bit;
* ``FUNC`` (1e-6, ``tests/test_torch_enhance.py``): float32 pow, exp and
  log;
* ``LAB`` (2e-5, the same file): a Lab round trip;
* ``RESAMPLE`` (1e-5, the resize, distort, blur, visual-effects and
  quantize tests): float32 resamples, trigonometry and sums in another
  order;
* ``FUSED``: the port's fused route (K1's plain version on a CPU tensor)
  against the JAX wand's op route, >= ``MIN_DB``.
"""

import math

import numpy as np
import torch

from imagemagick_tpu.core.image import Image as JImage
from imagemagick_tpu.core.spec import ImageSpec as JSpec
from imagemagick_tpu.wand import api as ja
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
from imagemagick_tpu_torch.wand import api as ta

EXACT = 0.0
FUNC = 1e-6
LAB = 2e-5
RESAMPLE = 1e-5
FUSED = "fused"
MIN_DB = 60.0
SPEC_REL = 1e-5


def _img(h=48, w=64, c=3, seed=7):
    """A soft checkerboard with gradients and a little noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 6 + xx // 6) % 2).astype(np.float32)
    chans = [np.clip(0.6 * base + 0.3 * xx / (w - 1)
                     + rng.uniform(0, 0.08, (h, w)), 0, 1),
             np.clip(0.5 * yy / (h - 1) + 0.3 * base, 0, 1),
             np.clip(1 - 0.7 * xx / (w - 1) + 0.1 * base, 0, 1),
             np.clip(0.4 + 0.6 * yy / (h - 1), 0, 1)]
    return np.stack(chans[:c], -1).astype(np.float32)


def _pair(*arrays, alpha=False):
    """A JAX wand and a port wand holding the same images (copies); with
    ``alpha`` the last channel is the images' alpha."""
    j, t = ja.MagickWand(), ta.MagickWand(device="cpu")
    for arr in arrays:
        j.add_image(JImage(arr.copy(), JSpec(alpha=alpha)))
        t.add_image(TImage(arr.copy(), TSpec(alpha=alpha), device="cpu"))
    return j, t


def _side(arr, side):
    return _pair(arr)[0 if side == "j" else 1]


def _arrays(w):
    return [np.asarray(im.data) if not isinstance(im.data, torch.Tensor)
            else im.data.numpy() for im in w.images]


def _db(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def _assert_same(jw, tw, tol):
    """The wands hold as many images, of the same shapes and specs, and
    their pixels lie within ``tol`` (or >= MIN_DB apart for FUSED)."""
    a, b = _arrays(jw), _arrays(tw)
    assert len(a) == len(b)
    for x, y, jm, tm in zip(a, b, jw.images, tw.images):
        assert x.shape == tuple(y.shape)
        assert (jm.spec.colorspace, jm.spec.alpha) == \
            (tm.spec.colorspace, tm.spec.alpha)
        assert y.dtype == np.float32
        if tol == FUSED:
            assert _db(y, x) >= MIN_DB
        elif tol == EXACT:
            np.testing.assert_array_equal(y, x)
        else:
            np.testing.assert_allclose(y, x, atol=tol, rtol=0)


KUWAHARA = "kuwahara"


def assert_kuwahara(before, jw, tw, radius, sigma):
    """Kuwahara as ``tests/test_torch_blur.py`` holds it: a pixel may take
    another quadrant where the two smallest quadrant variances tie within
    1e-6 (at most 1 % of the pixels), the others within 1e-5."""
    from imagemagick_tpu_torch.ops import blur as tbl

    (x,), (y,) = _arrays(jw), _arrays(tw)
    assert x.shape == y.shape
    g = tbl.blur(before, radius, sigma)
    v = np.sort(tbl._kuwahara_variances(g, radius).numpy(), 0)
    flipped = np.abs(y - x).max(-1) > 1e-5
    assert flipped.mean() <= 0.01
    assert ((v[1] - v[0])[flipped] <= 1e-6).all()
    np.testing.assert_allclose(y[~flipped], x[~flipped], atol=1e-5)
