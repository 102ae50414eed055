"""Port parity: ``wand/perl_compat.py``, PerlMagick's method names and
attributes over the wand, against the JAX module.

Every name in the JAX ``apply``'s table (read from its source, so that a
name added there shows here) is called on a JAX wand and a port wand
(``device="cpu"``) over the same seeded image with the same keywords;
what comes back and the images the wands then hold are compared within
the bound of the wand method's own parity test (``tests/test_torch_wand.py``
and the op tests it cites; stated per name: EXACT unless listed).  A name
that raises in the JAX module raises the same error in the port, but for
the faults recorded below with a ``test_jax_*`` case.  Names that draw
random numbers are held by shape and by the size of the change they make,
as ``test_torch_wand.py`` holds them.  ``get_attribute`` and
``set_attribute`` are compared for every name of their tables.
"""

import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imagemagick_tpu.wand import api as ja
from imagemagick_tpu.wand import perl_compat as jpc
from imagemagick_tpu_torch.wand import api as ta
from imagemagick_tpu_torch.wand import perl_compat as tpc

from torch_wand_pairs import (EXACT, FUNC, FUSED, LAB, RESAMPLE, _arrays,
                              _assert_same, _db, _img, _pair)

JAX_SOURCE = Path(jpc.__file__).read_text()
A = _img(24, 32)
S = _img(8, 10, seed=3)
B = _img(24, 32, seed=11)
NUM_REL, NUM_ABS = 1e-5, 5e-5     # tests/test_torch_io.py's bounds


def _table_names():
    """The PerlMagick names of the JAX ``apply``: every string ``n`` is
    compared with."""
    fn = next(f for f in ast.parse(JAX_SOURCE).body
              if isinstance(f, ast.FunctionDef) and f.name == "apply")
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and node.left.id == "n":
            for c in node.comparators:
                elts = c.elts if isinstance(c, ast.Tuple) else [c]
                names |= {e.value for e in elts}
    return sorted(names)


NAMES = _table_names()

# keywords for the names whose defaults do nothing or need an input;
# "@S", "@A", "@B" stand for a wand over S, A or B, "@IN" for a PPM of A, "@OUT"
# for a file to write
KWARGS = {
    "adaptiveresize": {"geometry": "40x30"},
    "affinetransform": {"affine": "1,0.1,0,1,2,3"},
    "annotate": {"text": "Hi", "pointsize": 10, "geometry": "+2+2"},
    "clut": {"image": "@S"},
    "colormatrix": {"matrix": "0.5,0.3,0.2,0.1,0.8,0.1,0.2,0.2,0.6"},
    "compare": {"image": "@B", "metric": "mae"},
    "composite": {"image": "@S", "gravity": "Center", "compose": "Over"},
    "convolve": {"coefficients": "0,1,0,1,-4,1,0,1,0"},
    "copypixels": {"image": "@S", "geometry": "4x4+0+0", "x": 2, "y": 2},
    "crop": {"geometry": "20x16+3+1"},
    "difference": {"image": "@A"},
    "distort": {"method": "srt", "points": "0.9,10"},
    "draw": {"primitive": "rectangle", "points": "5,5 20,20",
             "fill": "red"},
    "encipher": {"passphrase": "pw"},
    "decipher": {"passphrase": "pw"},
    "evaluate": {"operator": "add", "value": 0.1},
    "extent": {"geometry": "40x30"},
    "function": {"function": "polynomial", "parameters": "2,-1,0.5"},
    "fx": {"expression": "u*0.5"},
    "haldclut": {"image": "@S"},
    "inversefouriertransform": {"image": "@B"},
    "map": {"image": "@S"},
    "ping": {"filename": "@IN"},
    "poly": {"terms": "1.0,0.5"},
    "read": {"filename": "@IN"},
    "remap": {"image": "@S", "dither": True},
    "resample": {"density": 144},
    "resize": {"geometry": "40x30"},
    "sample": {"geometry": "50%"},
    "scale": {"geometry": "50%"},
    "sparsecolor": {"method": "shepards",
                    "points": "5,5,1,0,0,20,10,0,1,0,12,20,0,0,1"},
    "splice": {"geometry": "2x2+1+1"},
    "stegano": {"image": "@S"},
    "stereo": {"image": "@A"},
    "texture": {"image": "@S"},
    "thumbnail": {"geometry": "20x15"},
    "write": {"filename": "@OUT"},
    "zoom": {"geometry": "40x30"},
}

# bounds of the wand methods' parity tests where they are not EXACT
BOUNDS = {
    "adaptiveresize": FUSED, "resize": FUSED, "zoom": FUSED, "blur": FUSED,
    "gaussianblur": FUSED,
    "autogamma": FUNC, "contrast": FUNC, "sigmoidalcontrast": FUNC,
    "clahe": LAB, "whitebalance": LAB,
    "distort": RESAMPLE, "implode": RESAMPLE, "kmeans": RESAMPLE,
    "polaroid": RESAMPLE, "resample": RESAMPLE, "sepiatone": RESAMPLE,
    "shade": RESAMPLE, "sharpen": RESAMPLE, "thumbnail": RESAMPLE,
    "vignette": RESAMPLE, "sparsecolor": RESAMPLE, "montage": RESAMPLE,
    "swirl": RESAMPLE, "wave": RESAMPLE, "rotate": RESAMPLE,
    "shear": RESAMPLE, "deskew": RESAMPLE, "liquidrescale": RESAMPLE,
    "affinetransform": RESAMPLE, "poly": FUNC,
}
# the inverse DFT of a magnitude and a phase image, held at 120 dB as
# test_torch_wand.py holds inverse_fourier_transform_image
IFFT_DB = {"inversefouriertransform": 120.0}
RANDOM = {"addnoise", "randomthreshold", "sketch", "spread"}
# the JAX module's faults, each with a test_jax_* case below
JAX_FAULTS = {"histogram"}
TEXT = {"describe", "identify"}
# the float32 error of the JAX module's two cumsums: an output is a sum
# of at most H + W partial sums, each within an ulp of the largest value
INTEGRAL_ULPS = A.shape[0] + A.shape[1]


def _resolve(kw, side, tmp_path):
    out = {}
    for k, v in kw.items():
        if v == "@S":
            v = _pair(S)[side]
        elif v == "@A":
            v = _pair(A)[side]
        elif v == "@B":
            v = _pair(B)[side]
        elif v == "@IN":
            v = str(tmp_path / "in.ppm")
        elif v == "@OUT":
            v = str(tmp_path / f"out-{side}.ppm")
        out[k] = v
    return out


def _numbers_match(want: str, got: str):
    """The verbose text as ``tests/test_torch_wand.py`` holds it: the same
    words, numbers within NUM_REL and NUM_ABS, the version line naming
    each package."""
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if g.startswith("  Version:"):
            assert "imagemagick_tpu_torch" in g
            continue
        assert num.sub("#", g) == num.sub("#", w), (g, w)
        for a, b in zip(num.findall(g), num.findall(w)):
            assert float(a) == pytest.approx(float(b), rel=NUM_REL,
                                             abs=NUM_ABS), (g, w)


def _same_result(rj, rt, name):
    if isinstance(rj, ja.MagickWand):
        assert isinstance(rt, ta.MagickWand) and rt.device.type == "cpu"
        _assert_same(rj, rt, BOUNDS.get(name, EXACT))
    elif name in TEXT:
        _numbers_match(rj, rt)
    elif isinstance(rj, float):
        assert rt == pytest.approx(rj, rel=1e-6, abs=1e-7)
    else:
        assert rt == rj


def test_public_names_match_jax():
    def public(m):
        return {n for n, v in vars(m).items() if not n.startswith("_")
                and inspect.isfunction(v) and v.__module__ == m.__name__}

    assert public(tpc) == public(jpc) == {"apply", "get_attribute",
                                          "set_attribute"}
    assert len(NAMES) == 174


@pytest.mark.parametrize("name", [n for n in NAMES if n not in JAX_FAULTS])
def test_name_matches_jax(name, tmp_path):
    _pair(A)[0].write_image(str(tmp_path / "in.ppm"))
    j, t = _pair(A)
    kw = KWARGS.get(name, {})
    try:
        rj = jpc.apply(j, name, **_resolve(kw, 0, tmp_path))
    except Exception as e:  # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(e)) as got:
            tpc.apply(t, name, **_resolve(kw, 1, tmp_path))
        assert str(got.value) == str(e)
        return
    rt = tpc.apply(t, name, **_resolve(kw, 1, tmp_path))
    assert all(im.data.device.type == "cpu" for im in t.images)
    if name in RANDOM:
        (x,), (y,) = _arrays(j), _arrays(t)
        assert x.shape == y.shape and np.isfinite(y).all()
        dj, dt = float(np.abs(x - A).mean()), float(np.abs(y - A).mean())
        assert abs(dt - dj) <= 0.2 * dj
        return
    _same_result(rj, rt, name)
    if name in IFFT_DB:
        (x,), (y,) = _arrays(j), _arrays(t)
        assert x.shape == y.shape and _db(y, x) >= IFFT_DB[name]
    elif name == "integral":
        (x,), (y,) = _arrays(j), _arrays(t)
        ulp = np.spacing(np.float32(x.max()))
        np.testing.assert_allclose(y, x, atol=INTEGRAL_ULPS * ulp, rtol=0)
    else:
        _assert_same(j, t, BOUNDS.get(name, EXACT))
    if name == "write":
        assert (tmp_path / "out-1.ppm").read_bytes() == \
            (tmp_path / "out-0.ppm").read_bytes()


def test_every_name_has_a_case():
    """Every name is a case of test_name_matches_jax or a recorded JAX
    fault, and the keyword and bound tables name only names of the
    table."""
    assert set(KWARGS) | set(BOUNDS) | RANDOM | JAX_FAULTS | TEXT | \
        set(IFFT_DB) <= set(NAMES)


def test_unknown_name_raises_as_jax():
    j, t = _pair(A)
    with pytest.raises(ValueError, match="not supported") as e:
        jpc.apply(j, "NoSuchMethodEver")
    with pytest.raises(ValueError) as got:
        tpc.apply(t, "NoSuchMethodEver")
    assert str(got.value) == str(e.value)


def test_jax_histogram_raises_on_every_image():
    """The JAX ``Histogram`` slices the dict that ``get_image_histogram``
    returns (``perl_compat.py:570-571``) and raises KeyError on every
    image; the port returns the 64 most frequent colors with their
    counts, the JAX histogram's own entries."""
    j, t = _pair(A)
    with pytest.raises(KeyError):
        jpc.apply(j, "Histogram")
    got = tpc.apply(t, "Histogram")
    want = list(j.get_image_histogram().items())[:64]
    assert got == [[list(map(float, c)), int(n)] for c, n in want]
    assert len(got) == 64


def test_sortpixels_keeps_tied_lumas_in_order():
    """Pixels of equal luma keep their order within a row (a stable
    argsort, as ``jnp.argsort``), and the luma is the JAX mean: rows of
    permuted colors with one sum sort as the JAX module sorts them."""
    rng = np.random.default_rng(5)
    base = np.array([[0.2, 0.3, 0.5], [0.5, 0.3, 0.2], [0.3, 0.5, 0.2],
                     [0.1, 0.1, 0.8], [0.8, 0.1, 0.1], [0.6, 0.2, 0.2]],
                    np.float32)
    rows = np.stack([base[rng.permutation(6)] for _ in range(5)])
    j, t = _pair(rows)
    jpc.apply(j, "SortPixels")
    tpc.apply(t, "SortPixels")
    _assert_same(j, t, EXACT)
    # the ties: every row holds the same colors in its first-seen order
    (y,) = _arrays(t)
    for r, src in zip(y, rows):
        luma = src.sum(-1)
        order = sorted(range(6), key=lambda i: luma[i])
        np.testing.assert_array_equal(r, src[order])


def test_sortpixels_gray_and_batch_match_jax():
    g = _img(6, 9, c=1, seed=8)
    j, t = _pair(g)
    jpc.apply(j, "SortPixels")
    tpc.apply(t, "SortPixels")
    _assert_same(j, t, EXACT)
    a2 = _img(6, 9, c=2, seed=9)
    j, t = _pair(a2)
    jpc.apply(j, "SortPixels")
    tpc.apply(t, "SortPixels")
    _assert_same(j, t, EXACT)


def test_integral_is_the_float64_sum_rounded():
    """The port's integral is the float64 double cumsum rounded to
    float32, the value the card computes too (its own order of float64
    partial sums rounds to the same float32 but at a float64 tie)."""
    _, t = _pair(A)
    tpc.apply(t, "Integral")
    want = np.cumsum(np.cumsum(A.astype(np.float64), 0), 1).astype(
        np.float32)
    np.testing.assert_array_equal(_arrays(t)[0], want)


ATTRS = ["width", "columns", "height", "rows", "depth", "magick", "format",
         "colorspace", "signature", "colors", "filesize", "delay", "scene",
         "filename", "type", "matte", "alpha", "gamma", "orientation",
         "label", "comment", "fuzz", "pointsize", "font", "quality",
         "gravity", "density", "page", "images", "n", "pixel[3,4]",
         "pixel[0,0]", "no-such-property"]


@pytest.mark.parametrize("attr", ATTRS)
def test_get_attribute_matches_jax(attr):
    j, t = _pair(A)
    rj, rt = jpc.get_attribute(j, attr), tpc.get_attribute(t, attr)
    if isinstance(rj, float):
        assert rt == pytest.approx(rj, rel=1e-6)
    else:
        assert rt == rj


SETS = [("quality", 80), ("fuzz", "10%"), ("fuzz", 6553.5),
        ("font", "Helvetica"), ("pointsize", 14), ("gravity", "Center"),
        ("magick", "PNG"), ("depth", 8), ("colorspace", "Gray"),
        ("background", "navy"), ("bordercolor", "red"), ("delay", 12),
        ("scene", 3), ("filename", "x.png"), ("label", "a label"),
        ("comment", "a comment"), ("size", "20x10"), ("type", "Grayscale"),
        ("orientation", 3), ("alpha", 1), ("matte", 0),
        ("x:custom", "value")]     # page: test_jax_set_page_raises_...


@pytest.mark.parametrize("attr,value", SETS,
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(SETS)])
def test_set_attribute_matches_jax(attr, value):
    j, t = _pair(A)
    jpc.set_attribute(j, attr, value)
    tpc.set_attribute(t, attr, value)
    _assert_same(j, t, EXACT)
    for a in ("quality", "fuzz", "font", "pointsize", "gravity", "depth",
              "delay", "scene", "filename", "label", "comment", "page",
              "magick", "orientation", "type", "matte"):
        assert tpc.get_attribute(t, a) == jpc.get_attribute(j, a), a
    assert t.settings == j.settings
    assert tpc.get_attribute(t, "x:custom") == \
        jpc.get_attribute(j, "x:custom")


def test_set_attribute_keeps_the_cpu():
    _, t = _pair(A)
    tpc.set_attribute(t, "colorspace", "Lab")
    assert t.current.data.device.type == "cpu"
    assert isinstance(t.current.data, torch.Tensor)


def test_jax_set_page_raises_on_every_page():
    """The JAX ``Set(page => ...)`` calls ``parse_page_geometry`` without
    the canvas size it takes (``perl_compat.py:848-850``) and raises
    TypeError on every value; the port parses the page against the
    image's size, as ``-page`` does."""
    j, t = _pair(A)
    with pytest.raises(TypeError, match="width"):
        jpc.set_attribute(j, "page", "100x80+5+6")
    tpc.set_attribute(t, "page", "100x80+5+6")
    assert tpc.get_attribute(t, "page") == "100x80+5+6"
    tpc.set_attribute(t, "page", "+7+9")
    assert tpc.get_attribute(t, "page") == "32x24+7+9"
