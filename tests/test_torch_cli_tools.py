"""Port parity: the CLI's other tools (mogrify, composite, montage,
conjure/MSL, identify, compare, stream, import, display/animate), -region
and -bench, against the JAX CLI.

Each case runs one command through the port's ``main`` (``device="cpu"``)
and through the JAX ``main``, on the same files (PNGs of a few dozen
pixels a side made from a numpy seed), each side writing into its own
directory, and compares the exit codes, the stdout and stderr text (with
the directory names made equal, and timings matched by a regex) and the
files written, byte for byte.  The options are chosen from those that
both packages compute bit for bit (flips, negates, crops, thresholds,
composites); a blur or a resize appears only where its result is held to
one 8-bit level and said so.  ``display``'s file route writes a fixed
path, which another test may write at the same moment: here each side
writes into its own output directory instead.
"""

import importlib
import os
import re

import numpy as np
import pytest

from PIL import Image as PImage

from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.cli import tools as tt

jm = importlib.import_module("imagemagick_tpu.cli.main")


def _write_png(path, h, w, c, seed):
    rng = np.random.default_rng(seed)
    arr = (rng.random((h, w, c)) * 255).astype(np.uint8)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[c]
    PImage.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
    return arr


@pytest.fixture
def files(tmp_path):
    """a.png and b.png (24x32 RGB, b = a with a block changed), c.png
    (RGBA), g.png (gray), p.png (a 6x8 patch of a at +5+4) and t.png
    (24x32, a's twin), in ``tmp_path``; ``t/`` and ``j/`` for the two
    sides' outputs."""
    a = _write_png(tmp_path / "a.png", 24, 32, 3, 1)
    b = a.copy()
    b[3:9, 10:20] = 255 - b[3:9, 10:20]
    PImage.fromarray(b).save(tmp_path / "b.png")
    PImage.fromarray(a).save(tmp_path / "t.png")
    PImage.fromarray(a[4:10, 5:13]).save(tmp_path / "p.png")
    _write_png(tmp_path / "c.png", 24, 32, 4, 2)
    _write_png(tmp_path / "g.png", 17, 23, 1, 3)
    _write_png(tmp_path / "w.png", 20, 40, 3, 4)
    for side in "tj":
        (tmp_path / side).mkdir()
    return tmp_path


def _mains():
    return (("t", lambda argv: tm.main(argv, device="cpu")),
            ("j", jm.main))


def _both(d, argv, cap, binary=False):
    """Run ``argv`` (``{o}`` standing for the side's output directory,
    ``{d}`` for the inputs') through both CLIs; returns [(rc, out, err)]
    for the port and the JAX CLI, with the output directory written as
    ``{o}`` in the text."""
    res = []
    for side, main in _mains():
        o = str(d / side)
        args = [a.replace("{o}", o).replace("{d}", str(d)) for a in argv]
        rc = main(args)
        out, err = cap.readouterr()
        if binary:
            out, err = out, err.decode()
        res.append((rc, out, err.replace(o, "{o}")))
    return res


def _same_files(d):
    """The two sides wrote the same files, with the same bytes."""
    t = sorted(os.listdir(d / "t"))
    assert t == sorted(os.listdir(d / "j")) and t
    for name in t:
        if (d / "t" / name).is_dir():
            _same_files_in(d / "t" / name, d / "j" / name)
        else:
            assert (d / "t" / name).read_bytes() == \
                (d / "j" / name).read_bytes(), name


def _same_files_in(t, j):
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    for name in os.listdir(t):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name


# -- mogrify ------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    ["-negate", "-flip"],
    ["-gravity", "center", "-crop", "10x8+0+0", "+repage"],
    ["-threshold", "50%", "-define", "png:x=1", "-label", "L"],
    ["-size", "4x4", "-rotate", "90", "-depth", "8"],
    ["-virtual-pixel", "edge", "-flop", "-solarize", "40%"],
], ids=["negate", "crop", "threshold", "rotate", "setting"])
@pytest.mark.parametrize("where", ["format-path", "format", "inplace"])
def test_mogrify_equals_jax(files, capsys, opts, where):
    """-format and -path pick the same file names, and the heuristic
    counts the same arguments (a setting's one, -define's and -size's
    one), so the same files are read and written."""
    d = files
    outs = {}
    for side, main in _mains():
        o = d / side
        for name in ("a.png", "g.png"):
            (o / name).write_bytes((d / name).read_bytes())
        argv = ["mogrify"]
        if where == "format-path":
            (o / "out").mkdir()
            argv += ["-format", "ppm", "-path", str(o / "out")]
        elif where == "format":
            argv += ["-format", "PPM"]
        argv += opts + [str(o / "a.png"), str(o / "g.png")]
        assert main(argv) == 0
        text = capsys.readouterr()
        assert text.err == "" and text.out == ""
        outs[side] = o
    _same_files(d)
    if where == "format-path":
        assert sorted(os.listdir(d / "t" / "out")) == ["a.ppm", "g.ppm"]


@pytest.mark.parametrize("opt", [["-clone", "0"], ["-region", "8x6+2+3"]])
def test_mogrify_heuristic_miscounts_as_jax(files, capsys, opt):
    """An option outside its tables counts no argument (-clone, -region),
    so its argument is taken for a file: both tools report it and go on
    with the others."""
    res = _both(files, ["mogrify", "-path", "{o}", *opt, "-negate",
                        "{d}/a.png"], capsys)
    assert res[0] == res[1]
    assert res[0][0] == 1 and res[0][2].startswith("mogrify: ")
    assert os.listdir(files / "t") == os.listdir(files / "j")


# -- composite ----------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    [], ["-compose", "multiply"], ["-gravity", "center"],
    ["-geometry", "+3+2"], ["-gravity", "southeast", "-geometry", "+1+2"],
    ["-dissolve", "50"], ["-compose", "difference", "-negate"],
], ids=["over", "multiply", "gravity", "geometry", "gravity-geometry",
        "dissolve", "option"])
def test_composite_equals_jax(files, capsys, opts):
    res = _both(files, ["composite", *opts, "{d}/p.png", "{d}/a.png",
                        "{o}/out.png"], capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)


def test_composite_stereo_equals_jax(files, capsys):
    """-stereo: the anaglyph of two images of one size; of two sizes, a
    ValueError in both packages, ``composite: ...`` and exit 1."""
    res = _both(files, ["composite", "-stereo", "+2+1", "{d}/b.png",
                        "{d}/a.png", "{o}/out.png"], capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)
    res = _both(files, ["composite", "-stereo", "+2+0", "{d}/p.png",
                        "{d}/a.png", "{o}/x.png"], capsys)
    assert res[0][0] == res[1][0] == 1
    assert res[0][2].startswith("composite: ") and \
        res[1][2].startswith("composite: ")


def test_composite_with_a_mask_path_and_usage(files, capsys):
    """A mask between source and destination is skipped as in the JAX
    tool; fewer than three files is its usage error, exit 2."""
    res = _both(files, ["composite", "{d}/p.png", "{d}/g.png", "{d}/a.png",
                        "{o}/out.png"], capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)
    res = _both(files, ["composite", "{d}/p.png", "{o}/out.png"], capsys)
    assert res[0] == res[1] == (
        2, "", "composite: usage: composite src dst out\n")
    res = _both(files, ["composite", "{d}/none.png", "{d}/a.png",
                        "{o}/x.png"], capsys)
    assert res[0][0] == res[1][0] == 1
    assert res[0][2].startswith("composite: ")


# -- montage ------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    ["-tile", "2x2", "-geometry", "24x24+2+2"],
    ["-geometry", "16x16+1+1"],
    ["-tile", "3x1"],
], ids=["tile-geometry", "geometry", "tile"])
def test_montage_equals_jax(files, capsys, opts):
    """The tiles' thumbnails are float32 resamples that the port sums in
    another order (test_torch_montage.py: within 1e-6): the written
    8-bit samples within one level, the sizes equal."""
    res = _both(files, ["montage", "{d}/a.png", "{d}/w.png", "{d}/c.png",
                        *opts, "{o}/m.png"], capsys)
    assert res[0] == res[1] == (0, "", "")
    t = np.asarray(PImage.open(files / "t" / "m.png")).astype(int)
    j = np.asarray(PImage.open(files / "j" / "m.png")).astype(int)
    assert t.shape == j.shape and np.abs(t - j).max() <= 1


def test_montage_usage_equals_jax(files, capsys):
    res = _both(files, ["montage", "{o}/m.png"], capsys)
    assert res[0] == res[1] == (2, "", "montage: need inputs and an output\n")


# -- conjure (MSL) --------------------------------------------------------------

MSL_EXACT = [
    '<image><read filename="{d}/a.png"/><negate/><flip/><flop/>'
    '<write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><crop geometry="10x8+2+3"/>'
    '<rotate degrees="90"/><write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><trim/><magnify/><equalize/>'
    '<normalize/><write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><colorspace colorspace="gray"/>'
    '<set comment="x" label="y"/><get width="w"/>'
    '<write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><threshold geometry="40%"/>'
    '<no-such-option x="1"/><solarize threshold="30%"/>'
    '<write filename="{o}/m.png"/></image>',
    '<msl><image><read filename="{d}/a.png"/><negate/>'
    '<write filename="{o}/m1.png"/></image><image size="4x4">'
    '<read filename="xc:red"/><write filename="{o}/m2.png"/></image></msl>',
    '<group><read filename="{d}/a.png"/><flip/><image><negate/></image>'
    '<write filename="{o}/m.png"/></group>',
    '<msl><read filename="{d}/a.png"/><flop/><write filename="{o}/m.png"/>'
    '</msl>',
    '<image><read filename="{d}/a.png"/><despeckle/>'
    '<write filename="{o}/m.png"/></image>',
]
MSL_NEAR = [
    '<image><read filename="{d}/a.png"/><resize geometry="50%"/>'
    '<write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><blur radius="0" sigma="1.5"/>'
    '<write filename="{o}/m.png"/></image>',
    '<image><read filename="{d}/a.png"/><gaussian-blur geometry="0x1"/>'
    '<gaussianblur radius="0" sigma="2"/><write filename="{o}/m.png"/>'
    '</image>',
    '<image><read filename="{d}/a.png"/><sharpen geometry="0x1"/>'
    '<write filename="{o}/m.png"/></image>',
]


def _conjure(d, capsys, xml):
    res = []
    for side, main in _mains():
        o = d / side
        script = o / "s.msl"
        script.write_text(xml.replace("{d}", str(d)).replace("{o}", str(o)))
        rc = main(["conjure", "-verbose", str(script)])
        out, err = capsys.readouterr()
        res.append((rc, out, err.replace(str(o), "{o}")))
        script.unlink()
    return res


@pytest.mark.parametrize("k", range(len(MSL_EXACT)))
def test_conjure_equals_jax(files, capsys, k):
    """Each element of the JAX interpreter's table, a generic one (an
    option of the CLI, or none: skipped), <msl> and <group> roots."""
    res = _conjure(files, capsys, MSL_EXACT[k])
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)


@pytest.mark.parametrize("k", range(len(MSL_NEAR)))
def test_conjure_resamples_within_a_level(files, capsys, k):
    """Resizes and blurs: float32 sums in another order, the 8-bit
    samples within one level (test_torch_resize.py, test_torch_blur.py)."""
    res = _conjure(files, capsys, MSL_NEAR[k])
    assert res[0] == res[1] == (0, "", "")
    t = np.asarray(PImage.open(files / "t" / "m.png")).astype(int)
    j = np.asarray(PImage.open(files / "j" / "m.png")).astype(int)
    assert t.shape == j.shape and np.abs(t - j).max() <= 1


def test_conjure_errors_equal_jax(files, capsys):
    """A bad document or a missing file: ``conjure: ...`` and exit 1."""
    for xml in ("<image><read", '<image><read filename="{d}/no.png"/>'
                "</image>", '<image><write filename="{o}/x.png"/></image>'):
        res = _conjure(files, capsys, xml)
        assert res[0][0] == res[1][0] == 1
        assert res[0][2].startswith("conjure: ") and \
            res[1][2].startswith("conjure: ")
        assert res[0] == res[1]


def test_jax_msl_generic_element_missing_its_argument_fails(files, capsys):
    """A fault of the JAX interpreter, not copied (ROADMAP.md Queue 3): a
    generic element naming an option of one argument, with no attribute,
    raises IndexError inside the JAX ``process`` (it reads past the end
    of its arguments), which escapes the interpreter's CLIError and ends
    the script; in the port the missing argument is a CLIError, and the
    element is skipped as the interpreter skips what the CLI refuses."""
    xml = ('<image><read filename="{d}/a.png"/><level/><negate/>'
           '<write filename="{o}/m.png"/></image>')
    res = _conjure(files, capsys, xml)
    assert res[1] == (1, "", "conjure: list index out of range\n")
    assert res[0] == (0, "", "")
    want = np.asarray(PImage.open(files / "a.png"))
    np.testing.assert_array_equal(
        np.asarray(PImage.open(files / "t" / "m.png")), 255 - want)


# -- identify -----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["identify", "{d}/a.png", "{d}/c.png", "{d}/g.png"],
    ["identify", "-format", "%w x %h %m %z\\n", "{d}/a.png", "{d}/c.png"],
    ["identify", "-format", "%f:%[fx:w*2] ", "{d}/g.png"],
], ids=["plain", "format", "format-fx"])
def test_identify_equals_jax(files, capsys, argv):
    res = _both(files, argv, capsys)
    assert res[0] == res[1] and res[0][0] == 0 and res[0][1]


# -- compare ------------------------------------------------------------------

METRICS = ["ae", "mae", "mse", "rmse", "pae", "psnr", "ncc", "ssim",
           "dssim", "fuzz", "dpc", "phase", "mepp", "phash"]


@pytest.mark.parametrize("metric", METRICS)
def test_compare_equals_jax(files, capsys, metric):
    """Every metric: its printed numbers (``65535·d (d)``, ``1 - corr``
    for ncc, dpc and phase, MEPP's three), the exit code (1 above 1e-6)
    and the difference image; and equal images, exit 0."""
    res = _both(files, ["compare", "-metric", metric, "{d}/a.png",
                        "{d}/b.png", "{o}/diff.png"], capsys)
    assert res[0] == res[1]
    assert res[0][0] == 1 and res[0][2]
    _same_files(files)
    res = _both(files, ["compare", "-metric", metric.upper(), "{d}/a.png",
                        "{d}/t.png"], capsys)
    assert res[0] == res[1]


def test_compare_subimage_search_and_sizes(files, capsys):
    """A smaller second image, or -subimage-search, is located inside the
    first; a larger one exits 2; fewer than two files exits 2."""
    for argv in (["compare", "{d}/a.png", "{d}/p.png"],
                 ["compare", "-subimage-search", "{d}/a.png", "{d}/t.png"],
                 ["compare", "-metric", "rmse", "-subimage-search",
                  "{d}/w.png", "{d}/p.png"]):
        res = _both(files, argv, capsys)
        assert res[0][:2] == res[1][:2] and res[0][0] == 0
        # the offset equal; the score, the peak of a float32 FFT
        # correlation that the two packages sum in another order, within
        # 1e-5 of it
        got, want = (re.fullmatch(r"(\S+) @ (\d+,\d+)\n", e).groups()
                     for _, _, e in res)
        assert got[1] == want[1]
        assert abs(float(got[0]) - float(want[0])) <= \
            1e-5 * abs(float(want[0]))
    res = _both(files, ["compare", "{d}/a.png", "{d}/p.png"], capsys)
    assert res[0][2].endswith(" @ 5,4\n")
    res = _both(files, ["compare", "{d}/p.png", "{d}/a.png"], capsys)
    assert res[0] == res[1] == (2, "", "compare: image sizes differ\n")
    res = _both(files, ["compare", "{d}/a.png"], capsys)
    assert res[0] == res[1] == (2, "", "compare: need two images\n")


# -- stream -------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["char", "short", "uint16", "float"])
@pytest.mark.parametrize("cmap,src", [("rgb", "a"), ("i", "a"),
                                      ("rgba", "c"), ("rgb", "c"),
                                      ("rgb", "g"), ("RGBA", "a")])
def test_stream_equals_jax(files, capsys, storage, cmap, src):
    res = _both(files, ["stream", "-map", cmap, "-storage-type", storage,
                        "-extract", "10x7+3+2", f"{{d}}/{src}.png",
                        "{o}/s.raw"], capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)


def test_stream_usage_equals_jax(files, capsysbinary):
    """One file is the usage error, exit 2; so is ``-`` for the output,
    which the tool's loop takes for an option, as the JAX tool does."""
    for argv in (["stream", "{d}/a.png"], ["stream", "{d}/c.png", "-"]):
        res = _both(files, argv, capsysbinary, binary=True)
        assert res[0] == res[1] == (
            2, b"", "stream: usage: stream input output\n")


# -- import ---------------------------------------------------------------------

def test_import_refuses_as_jax(files, capsys):
    res = _both(files, ["import", "-window", "root", "{o}/x.png"], capsys)
    assert res[0] == res[1]
    assert res[0][0] == 1 and "X11 screen capture is not supported" in \
        res[0][2]
    assert os.listdir(files / "t") == []


# -- display / animate ----------------------------------------------------------

@pytest.mark.parametrize("tool,inputs,path", [
    ("display", ["{d}/a.png"], tt.DISPLAY_FILE),
    ("display", ["{d}/a.png", "{d}/g.png"], tt.DISPLAY_FILE),
    ("animate", ["{d}/a.png", "{d}/t.png"], tt.ANIMATE_FILE),
    ("animate", ["{d}/a.png"], tt.DISPLAY_FILE),
])
def test_display_file_route_equals_jax(files, capsys, monkeypatch, tool,
                                       inputs, path):
    """No terminal and no IMTPU_SIXEL: the images go to the fixed file and
    stderr names it.  Each side's file is moved into its own output
    directory (the port's through its module constants, the JAX one's
    through the ``io.write_image`` its tool looks up at call time), so
    that no other process writing the fixed path can meet this test."""
    import imagemagick_tpu.io as jio

    monkeypatch.delenv("IMTPU_SIXEL", raising=False)
    t, j = str(files / "t"), str(files / "j")
    for name in ("DISPLAY_FILE", "ANIMATE_FILE"):
        fixed = getattr(tt, name)
        monkeypatch.setattr(tt, name, fixed.replace(
            os.path.dirname(fixed), t))
    jax_write = jio.write_image

    def write_in_j(img, out, *a, **k):
        return jax_write(img, out.replace(os.path.dirname(out), j), *a, **k)

    monkeypatch.setattr(jio, "write_image", write_in_j)
    args = [a.replace("{d}", str(files)) for a in inputs]
    errs = []
    for side, main in _mains():
        assert main([tool, *args, "-negate"]) == 0
        out, err = capsys.readouterr()
        assert out == ""
        errs.append(err.replace(t, os.path.dirname(path)))
    assert errs == [f"{tool}: no sixel terminal; wrote {path}\n"] * 2
    _same_files(files)


@pytest.mark.parametrize("width", [None, "16"])
@pytest.mark.parametrize("tool", ["display", "animate"])
def test_display_sixel_route_equals_jax(files, capsysbinary, monkeypatch,
                                        tool, width):
    """IMTPU_SIXEL=1: sixel escapes on stdout, every frame under animate,
    each scaled to IMTPU_DISPLAY_WIDTH columns (a triangle resample: where
    it runs the sixel bytes may differ, so the frames' count and sizes are
    compared, and the bytes where no resample runs)."""
    monkeypatch.setenv("IMTPU_SIXEL", "1")
    monkeypatch.setattr("time.sleep", lambda s: None)
    if width:
        monkeypatch.setenv("IMTPU_DISPLAY_WIDTH", width)
    else:
        monkeypatch.delenv("IMTPU_DISPLAY_WIDTH", raising=False)
    res = _both(files, [tool, "{d}/a.png", "{d}/b.png", "-flip"],
                capsysbinary, binary=True)
    assert res[0][0] == res[1][0] == 0 and res[0][2] == res[1][2] == ""
    t, j = res[0][1], res[1][1]
    assert t.count(b"\x1bP") == j.count(b"\x1bP") == \
        (2 if tool == "animate" else 1)
    raster = re.compile(rb'"1;1;(\d+);(\d+)')
    assert raster.findall(t) == raster.findall(j)
    if width is None:
        assert t == j


def test_display_without_images_equals_jax(files, capsys):
    res = _both(files, ["display", "-negate"], capsys)
    assert res[0] == res[1]


# -- -region ------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    ["-region", "10x6+3+2", "-negate"],
    ["-gravity", "center", "-region", "10x6+3+2", "-negate"],
    ["-gravity", "southeast", "-region", "12x5+1+1", "-threshold", "50%"],
    ["-region", "10x6+3+2", "-negate", "+region", "-flip"],
    ["-region", "50x50-4-4", "-negate"],
    ["-region", "10x6+3+2", "-flip"],
], ids=["plain", "center", "southeast", "plus", "beyond", "flip"])
def test_region_equals_jax(files, capsys, opts):
    """A write mask on the gravity-adjusted rectangle: the options after
    it change only its pixels (a shape-changing one ignores it); +region
    removes it."""
    res = _both(files, ["{d}/a.png", "{d}/c.png", *opts, "{o}/r-%d.png"],
                capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)


@pytest.mark.parametrize("out", ["mask:{o}/m.png", "{o}/r.miff",
                                 "{o}/r.mpc"], ids=["mask", "miff", "mpc"])
def test_region_mask_reaches_the_coders_as_jax(files, capsys, out):
    """The mask that -region sets is a property the coders see: mask:
    writes it as a gray image, MIFF renders it in its header as the JAX
    package's host array, MPC leaves it out."""
    res = _both(files, ["{d}/a.png", "-gravity", "center", "-region",
                        "10x6+3+2", "-negate", out], capsys)
    assert res[0] == res[1] == (0, "", "")
    _same_files(files)


@pytest.mark.parametrize("opts", [
    ["-print", "%[wand:mask]"],
    ["-verbose", "-identify"],
], ids=["print", "verbose"])
def test_region_mask_in_text_as_jax(files, capsys, opts):
    """-print and -identify after -region print the mask as the JAX
    package's host array (of the verbose text, its Properties section:
    the statistics above it are float32 sums in another order)."""
    res = _both(files, ["{d}/a.png", "-region", "3x2+1+0", *opts, "null:"],
                capsys)
    if "-verbose" in opts:
        props = re.compile(r"  Properties:\n(?:    .*\n)+")
        res = [(rc, props.search(out).group(0), err) for rc, out, err in res]
    assert res[0] == res[1] and res[0][0] == 0
    assert "[[0. 1. 1. 1. 0." in res[0][1]


def test_region_blur_within_a_level(files, capsys):
    """A blur under a region: its op route (K3's plain version here),
    float32 sums in another order: within one level inside, equal
    outside."""
    res = _both(files, ["{d}/a.png", "-region", "12x9+4+5",
                        "-gaussian-blur", "0x2", "{o}/r.png"], capsys)
    assert res[0] == res[1] == (0, "", "")
    t = np.asarray(PImage.open(files / "t" / "r.png")).astype(int)
    j = np.asarray(PImage.open(files / "j" / "r.png")).astype(int)
    a = np.asarray(PImage.open(files / "a.png")).astype(int)
    assert np.abs(t - j).max() <= 1
    inside = np.zeros(a.shape[:2], bool)
    inside[5:14, 4:16] = True
    assert np.array_equal(t[~inside], a[~inside])
    assert not np.array_equal(t[inside], a[inside])


def test_region_mask_lives_on_the_image_device():
    import torch

    from imagemagick_tpu_torch.core.image import Image as TImage

    st = tm.CLIState("cpu")
    st.images.append(tm.LazyImage(TImage(torch.zeros(8, 9, 3))))
    tm.process(["-gravity", "center", "-region", "3x2+1+0"], st)
    m = st.images[0].image.properties["wand:mask"]
    assert isinstance(m, torch.Tensor) and m.device.type == "cpu"
    want = np.zeros((8, 9), np.float32)
    want[3:5, 4:7] = 1.0
    np.testing.assert_array_equal(m.numpy(), want)
    tm.process(["+region"], st)
    assert "wand:mask" not in st.images[0].image.properties


# -- -bench -------------------------------------------------------------------

PERF_MAIN = re.compile(
    r"Performance\[1\]: (\d+)i \d+\.\d{3}ips 1\.000e \d+\.\d{3}u "
    r"\d+:\d{2}\.\d{3}\n")
PERF_INLINE = re.compile(r"Performance: (\d+)i \d+\.\d{3}ips \d+\.\d{3}u\n")


@pytest.mark.parametrize("argv", [
    ["-bench", "3", "{d}/a.png", "-negate", "{o}/b.png"],
    ["{d}/a.png", "-bench", "2", "-concurrent", "-flip", "{o}/b.png"],
    ["-bench", "1", "{d}/none.png", "{o}/b.png"],
], ids=["three", "concurrent", "missing"])
def test_bench_in_main_equals_jax(files, capsys, argv):
    """-bench N in the command: the whole command N times (-concurrent
    dropped), one Performance[1] line; a run that fails prints its error
    each time and the exit code is the last run's."""
    res = _both(files, argv, capsys)
    assert res[0][:2] == res[1][:2]
    lines = [PERF_MAIN.sub("PERF", e) for _, _, e in res]
    assert lines[0] == lines[1] and lines[0].endswith("PERF")
    n = int(argv[argv.index("-bench") + 1])
    assert PERF_MAIN.search(res[0][2]).group(1) == str(n)
    if res[0][0] == 0:
        _same_files(files)


def test_bench_inside_a_script_equals_jax(files, capsys):
    """-bench N inside a script runs through ``process``: the rest of the
    command N - 1 times in new states, then once more in this one, with
    a Performance line over the N - 1."""
    for side in "tj":
        (files / side / "s.txt").write_text(
            f"-bench 3 {files}/a.png -negate {files}/{side}/b.png\n")
    res = []
    for side, main in _mains():
        rc = main(["-script", str(files / side / "s.txt")])
        out, err = capsys.readouterr()
        res.append((rc, out, PERF_INLINE.sub("PERF", err)))
        (files / side / "s.txt").unlink()
    assert res[0] == res[1] == (0, "", "PERF")
    _same_files(files)


def test_bench_in_process_continues_in_the_callers_state(files, capsys):
    import torch

    from imagemagick_tpu_torch.core.image import Image as TImage

    st = tm.CLIState("cpu")
    st.settings["gravity"] = "center"
    st.images.append(tm.LazyImage(TImage(torch.zeros(4, 4, 3))))
    tm.process(["-bench", "2", str(files / "a.png"), "-negate"], st)
    assert PERF_INLINE.fullmatch(capsys.readouterr().err).group(1) == "2"
    assert len(st.images) == 2 and st.images[1].width == 32
    tm.process(["-bench", "1", str(files / "a.png"), "-flip"], st)
    assert capsys.readouterr().err == "" and len(st.images) == 3


def test_tool_functions_take_the_device(files, capsys, monkeypatch):
    """Every tool builds its states on the device it is given."""
    seen = []

    class Spy(tm.CLIState):
        def __init__(self, device="cuda"):
            seen.append(str(device))
            super().__init__(device)

    monkeypatch.setattr(tt, "CLIState", Spy)
    monkeypatch.setenv("IMTPU_SIXEL", "1")      # display writes no file
    d = files
    msl = d / "s.msl"
    msl.write_text(f'<image><read filename="{d}/a.png"/><negate/>'
                   f'<write filename="{d}/t/m.png"/></image>')
    assert tt.mogrify_main(["-path", str(d / "t"), str(d / "a.png")],
                           device="cpu") == 0
    assert tt.montage_main([str(d / "a.png"), str(d / "t/m2.png")],
                           device="cpu") == 0
    assert tt.composite_main([str(d / "p.png"), str(d / "a.png"),
                              str(d / "t/o.png")], device="cpu") == 0
    assert tt.conjure_main([str(msl)], device="cpu") == 0
    assert tt.bench_run([str(d / "a.png"), str(d / "t/b.png")], 2,
                        device="cpu") == 0
    assert tt.display_main([str(d / "a.png"), "-write",
                            str(d / "t/w.png")], device="cpu") == 0
    capsys.readouterr()
    assert len(seen) == 7 and set(seen) == {"cpu"}
