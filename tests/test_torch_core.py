"""Port parity: spec, geometry and virtual-pixel pads against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core import geometry as jgeo
from imagemagick_tpu.core import spec as jspec
from imagemagick_tpu.core import virtual_pixel as jvp
from imagemagick_tpu_torch.core import geometry as tgeo
from imagemagick_tpu_torch.core import spec as tspec
from imagemagick_tpu_torch.core import virtual_pixel as tvp


def test_spec_tables_equal():
    assert tspec.COLORSPACES == jspec.COLORSPACES
    for name in ("sRGB", "grey", "Linear-Gray", "CIELab", "cmyk", "YCbCr"):
        key = tspec.normalize_colorspace(name)
        assert key == jspec.normalize_colorspace(name)
        assert tspec.colorspace_channels(key) == \
            jspec.colorspace_channels(key)
        assert tspec.ImageSpec(key, alpha=True).astuple() == \
            jspec.ImageSpec(key, alpha=True).astuple()
    with pytest.raises(ValueError):
        tspec.normalize_colorspace("no-such-space")


@pytest.mark.parametrize("geometry", [
    "256x256", "256x256!", "50%", "x128", "128", "300x200^", "100x100>",
    "1000x1000<", "4096@", "120x80+5+7",
])
def test_parse_meta_geometry_equal(geometry):
    for w, h in ((768, 512), (64, 96)):
        assert tgeo.parse_meta_geometry(geometry, w, h) == \
            jgeo.parse_meta_geometry(geometry, w, h)


@pytest.mark.parametrize("method", ["edge", "mirror", "tile", "undefined",
                                    "black", "white", "gray", "background"])
def test_pad_spatial_matches(method):
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    bg = (0.25, 0.5, 0.75)
    pads = ((2, 9), (3, 1))       # wider than the axis: mirror/tile repeat
    ref = np.asarray(jvp.pad_spatial(jnp.asarray(x), *pads, method, bg))
    got = tvp.pad_spatial(torch.from_numpy(x), *pads, method, bg).numpy()
    np.testing.assert_array_equal(got, ref)
