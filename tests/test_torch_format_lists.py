"""The faults of the JAX package's format lists that the port's lists do
not copy (``torch_format_faults``).

``-list format``, ``/formats`` and ``magick_query_formats`` print the
lists of ``io.supported_read_formats`` and ``supported_write_formats``.
The port's equal the JAX package's but for these names, and each test here
shows the JAX list wrong about its name, and the port's list right: the
JAX package reads or writes a file under a name its list leaves out (or
marks write-only), or lists as readable a format it cannot read back.
"""

import importlib
import os
import shutil

import numpy as np
import pytest

from imagemagick_tpu_torch import io as tio
from imagemagick_tpu_torch.core.image import Image as TImage

from torch_format_faults import (LISTED_UNREADABLE, READ_ALIASES,
                                 READ_WITH_A_SIZE, RECORDED_FORMATS,
                                 WRITE_ALIASES)

jio = importlib.import_module("imagemagick_tpu.io")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def _pixels(h=12, w=16, c=3, seed=4):
    """8-bit levels, so that every 8-bit coder keeps them."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, c)) / 255.0).astype(np.float32)


def _pair(c=3):
    x = _pixels(c=c)
    return JImage(x), TImage(x, device="cpu"), x


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def test_recorded_names_are_the_lists_differences():
    """Every difference between the two packages' lists is a recorded
    name, and every recorded name is a difference."""
    diff = set()
    for t, j in ((tio.supported_read_formats(), jio.supported_read_formats()),
                 (tio.supported_write_formats(),
                  jio.supported_write_formats())):
        diff |= set(t) ^ set(j)
    assert {n.upper() for n in diff} == RECORDED_FORMATS


@pytest.mark.parametrize("name", READ_WITH_A_SIZE)
def test_jax_list_leaves_out_a_sized_raw_format_it_reads(name, tmp_path):
    """With ``-size`` the JAX package reads BGRA, CMYK, YCBCR and R
    (``io/__init__.py:288-291``), which its list marks write-only or
    leaves out; the port lists them readable and reads them the same."""
    j, _, x = _pair(c=1 if name == "r" else 3)
    written = "gray" if name == "r" else name
    path = tmp_path / f"x.{written}"
    jio.write_image(j, str(path))
    if name == "r":
        path = path.rename(tmp_path / "x.r")
    assert name not in jio.supported_read_formats()
    assert name in tio.supported_read_formats()
    got = tio.read_images(str(path), size="16x12", device="cpu")
    want = jio.read_images(str(path), size="16x12")
    _same(got, want)
    assert got[0].width == 16 and got[0].height == 12


def _alias_file(name, tmp_path):
    """A file whose extension is ``name``, written by the JAX package."""
    j, _, _ = _pair()
    if name == "ttc":
        shutil.copy(FONT, tmp_path / "x.ttc")
    elif name == "text":
        jio.write_image(j, str(tmp_path / "x.txt"))
        os.rename(tmp_path / "x.txt", tmp_path / "x.text")
    else:
        jio.write_image(j, str(tmp_path / f"x.{name}"))
    return str(tmp_path / f"x.{name}")


@pytest.mark.parametrize("name", READ_ALIASES)
def test_jax_list_leaves_out_an_alias_it_reads(name, tmp_path):
    path = _alias_file(name, tmp_path)
    assert name not in jio.supported_read_formats()
    want = jio.read_images(path)
    assert name in tio.supported_read_formats()
    got = tio.read_images(path, device="cpu")
    _same(got, want)


@pytest.mark.parametrize("name", WRITE_ALIASES)
def test_jax_list_leaves_out_an_alias_it_writes(name, tmp_path):
    j, t, _ = _pair()
    jio.write_image(j, str(tmp_path / f"j.{name}"))
    assert os.path.getsize(tmp_path / f"j.{name}") > 0
    assert name not in jio.supported_write_formats()
    assert name in tio.supported_write_formats()
    tio.write_image(t, str(tmp_path / f"t.{name}"))
    assert (tmp_path / f"t.{name}").read_bytes() == \
        (tmp_path / f"j.{name}").read_bytes()


@pytest.mark.parametrize("name", LISTED_UNREADABLE)
def test_jax_lists_sixel_readable_and_reads_none(name, tmp_path):
    """The JAX list marks SIX and SIXEL readable; neither package reads
    back the sixel file it writes.  The port lists them write-only."""
    j, t, _ = _pair()
    jio.write_image(j, str(tmp_path / f"j.{name}"))
    tio.write_image(t, str(tmp_path / f"t.{name}"))
    assert name in jio.supported_read_formats()
    assert name not in tio.supported_read_formats()
    assert name in tio.supported_write_formats()
    with pytest.raises(OSError, match="cannot identify image file"):
        jio.read_images(str(tmp_path / f"j.{name}"))
    with pytest.raises(OSError, match="cannot identify image file"):
        tio.read_images(str(tmp_path / f"t.{name}"), device="cpu")
