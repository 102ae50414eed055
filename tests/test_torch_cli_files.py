"""Port parity: the CLI from files to files, ``main(argv, device="cpu")``
against the JAX CLI's ``main(argv)`` on the same files.

Inputs are made from a seed with numpy and encoded with PIL into a
temporary directory; each side writes its own outputs, which are decoded
with PIL and compared.  Config #1's chain runs on the port as one call of
K1's plain version for the group and on the JAX side as XLA ops that clip
after every op: its written samples are held within 1 level and at >= 60
dB (the route gate of test_torch_cli.py).  Config #3's chain makes 0/1
pages, held to at most 0.1 % of the pixels differing (test_torch_cli.py's
bound for 0/1 outputs).  The other options that read or write files give
equal samples, and equal bytes where both sides write with the same
codec; printed statistics agree within 1e-5 relative or 5e-5 absolute
(float32 reductions in another order, test_torch_io.py)."""

import importlib
import io as _io
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image as PImage

from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.cli import main as tm
from imagemagick_tpu_torch.ops import dispatch as tdsp

jm = importlib.import_module("imagemagick_tpu.cli.main")
jnat = importlib.import_module("imagemagick_tpu.native")

CONFIG1 = ["-resize", "32x32!", "-gaussian-blur", "0x2", "-colorspace",
           "gray"]
CONFIG3 = ["-auto-threshold", "otsu", "-morphology", "open", "square:1",
           "-morphology", "close", "square:1", "-edge", "1"]
GATE_DB = 60.0
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
BINARY_SHARE = 1e-3


def _natural(h, w, seed=0, c=3):
    """Smooth gradient + modest texture + a hard-edged block, u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 11.0)[..., None] * np.cos(
        xx[..., None] / 13.0 + np.arange(c))
    img = np.clip(base + 0.08 * rng.standard_normal((h, w, c)), 0.0, 1.0)
    img[h // 3:h // 2, w // 4:w // 2] = 0.95
    return (img * 255.0 + 0.5).astype(np.uint8)


def _page(h, w, seed):
    """A scanned letter page: light paper, dark strokes, a little noise."""
    rng = np.random.default_rng(seed)
    page = 0.92 + 0.04 * rng.standard_normal((h, w))
    for _ in range(12):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 12)
        page[y:y + 3, x:x + rng.integers(4, 12)] = 0.12
    return (np.clip(page, 0, 1) * 255 + 0.5).astype(np.uint8)


def _read(path) -> np.ndarray:
    return np.asarray(PImage.open(path)).astype(np.int64)


def _psnr(a, b) -> float:
    rms = np.sqrt(np.mean(((a - b) / 255.0) ** 2))
    return 20.0 * np.log10(1.0 / max(rms, 1e-12))


@pytest.fixture
def files(tmp_path):
    """8 PNGs of 48x64x3 and 4 PGM pages of 66x51."""
    pngs, pgms = [], []
    for k in range(8):
        p = str(tmp_path / f"in{k}.png")
        PImage.fromarray(_natural(48, 64, k)).save(p)
        pngs.append(p)
    for k in range(4):
        p = str(tmp_path / f"page{k}.pgm")
        PImage.fromarray(_page(66, 51, 10 + k), "L").save(p)
        pgms.append(p)
    return tmp_path, pngs, pgms


@pytest.fixture(autouse=True)
def _keep_limits():
    """-limit changes each package's process-wide resource limits: they
    are put back after each test."""
    from imagemagick_tpu.core.resource import resources as jres
    from imagemagick_tpu_torch.core.resource import resources as tres

    saved = dict(jres.limits), dict(tres.limits)
    yield
    jres.limits.update(saved[0])
    tres.limits.update(saved[1])


def _run_both(argv_port, argv_jax=None):
    assert tm.main(argv_port, device="cpu") == 0
    assert jm.main(argv_port if argv_jax is None else argv_jax) == 0


def test_config1_chain_on_8_pngs_matches_jax(files):
    d, pngs, _ = files
    fused = tdsp.COUNTS["fused"]
    _run_both(pngs + CONFIG1 + [str(d / "port-%d.png")],
              pngs + CONFIG1 + [str(d / "jax-%d.png")])
    assert tdsp.COUNTS["fused"] == fused + 1      # one group, one call
    for k in range(8):
        a, b = _read(d / f"port-{k}.png"), _read(d / f"jax-{k}.png")
        assert a.shape == b.shape == (32, 32)
        assert np.abs(a - b).max() <= 1 and _psnr(a, b) >= GATE_DB


def test_config3_chain_on_4_pgms_matches_jax(files):
    """The port writes one PBM a page under a %d name; the JAX writer
    writes only the first page of a PBM list (test_torch_io.py), so it
    runs page by page here."""
    d, _, pgms = files
    assert tm.main(pgms + CONFIG3 + [str(d / "port-%d.pbm")],
                   device="cpu") == 0
    for k, p in enumerate(pgms):
        assert jm.main([p] + CONFIG3 + [str(d / f"jax-{k}.pbm")]) == 0
    for k in range(4):
        a, b = _read(d / f"port-{k}.pbm"), _read(d / f"jax-{k}.pbm")
        assert a.shape == b.shape == (66, 51)
        assert np.mean(a != b) <= BINARY_SHARE


def test_print_and_identify_match_jax(files, capsys):
    d, pngs, _ = files
    fmt = "%w %h %m %[colorspace] %k %#\\n"
    for argv in ([pngs[0], "-print", fmt],
                 [pngs[0], "-resize", "50%", "-identify"],
                 [pngs[0], pngs[1], "-format", "%w", "-identify"]):
        tm.main(argv, device="cpu")
        got = capsys.readouterr().out
        jm.main(argv)
        assert got == capsys.readouterr().out and got
    for argv in ([pngs[0], "-print", "%[mean] %[max] %[min]\\n"],
                 [pngs[2], "-verbose", "-identify"]):
        tm.main(argv, device="cpu")
        got = capsys.readouterr().out.splitlines()
        jm.main(argv)
        want = capsys.readouterr().out.splitlines()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            if g.startswith("  Version:"):
                continue      # names the package
            assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
            for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
                assert float(a) == pytest.approx(float(b), rel=1e-5,
                                                 abs=5e-5), (g, w)


def test_profile_and_plus_profile_match_jax(files):
    from PIL import ImageCms

    d, pngs, _ = files
    icc = str(d / "srgb.icc")
    with open(icc, "wb") as f:
        f.write(ImageCms.ImageCmsProfile(
            ImageCms.createProfile("sRGB")).tobytes())
    _run_both([pngs[0], "-profile", icc, str(d / "port.png")],
              [pngs[0], "-profile", icc, str(d / "jax.png")])
    # an embedded profile takes both writers to PIL: equal bytes
    assert (d / "port.png").read_bytes() == (d / "jax.png").read_bytes()
    _run_both([str(d / "port.png"), "+profile", "*", str(d / "p2.png")],
              [str(d / "jax.png"), "+profile", "*", str(d / "j2.png")])
    assert np.array_equal(_read(d / "p2.png"), _read(d / "j2.png"))
    assert "icc_profile" not in PImage.open(d / "p2.png").info


def test_mask_applies_where_the_jax_cli_raises(files):
    """-mask FILE: the port keeps the file's intensity as an (H, W) write
    mask; the JAX CLI keeps its every channel, which no per-pixel option
    can broadcast, so -negate after it fails there."""
    d, pngs, _ = files
    m = np.zeros((48, 64), np.uint8)
    m[:, 32:] = 255
    mpath = str(d / "m.png")
    PImage.fromarray(m).save(mpath)
    assert jm.main([pngs[0], "-mask", mpath, "-negate",
                    str(d / "jax.png")]) == 1
    assert tm.main([pngs[0], "-mask", mpath, "-negate", str(d / "port.png")],
                   device="cpu") == 0
    src, out = _read(pngs[0]), _read(d / "port.png")
    assert np.array_equal(out[:, 32:], 255 - src[:, 32:])
    assert np.array_equal(out[:, :32], src[:, :32])
    assert tm.main([pngs[0], "-mask", mpath, "+mask", "-negate",
                    str(d / "all.png")], device="cpu") == 0
    assert np.array_equal(_read(d / "all.png"), 255 - src)


def test_jax_plus_mask_takes_the_next_option_the_port_takes_none(files):
    """+mask takes no argument in ImageMagick; the JAX CLI gives it one,
    so ``+mask -negate`` loses the -negate there."""
    d, pngs, _ = files
    assert jm.main([pngs[0], "+mask", "-negate", str(d / "jax.png")]) == 0
    assert tm.main([pngs[0], "+mask", "-negate", str(d / "port.png")],
                   device="cpu") == 0
    src = _read(pngs[0])
    assert np.array_equal(_read(d / "jax.png"), src)
    assert np.array_equal(_read(d / "port.png"), 255 - src)


def test_clip_path_matches_jax(files):
    d, pngs, _ = files
    path = "M 8 4 L 56 10 L 40 44 Z"
    for side, main in (("port", lambda a: tm.main(a, device="cpu")),
                       ("jax", jm.main)):
        assert main([pngs[1], "-set", "clip-path", path, "-clip", "-blur",
                     "0x1.5", str(d / f"{side}.png")]) == 0
    a, b = _read(d / "port.png"), _read(d / "jax.png")
    src = _read(pngs[1])
    assert np.abs(a - b).max() <= 1
    assert np.array_equal(a[0, 0], src[0, 0]) and not np.array_equal(a, src)


def test_encipher_then_decipher_matches_jax(files):
    d, pngs, _ = files
    _run_both([pngs[2], "-encipher", "correct horse", str(d / "port.png")],
              [pngs[2], "-encipher", "correct horse", str(d / "jax.png")])
    enc = _read(d / "port.png")
    assert np.array_equal(enc, _read(d / "jax.png"))
    assert not np.array_equal(enc, _read(pngs[2]))
    assert tm.main([str(d / "port.png"), "-decipher", "correct horse",
                    str(d / "back.png")], device="cpu") == 0
    assert np.array_equal(_read(d / "back.png"), _read(pngs[2]))


def test_write_and_scene_names_match_jax(files):
    d, pngs, _ = files
    for side, main in (("port", lambda a: tm.main(a, device="cpu")),
                       ("jax", jm.main)):
        assert main(pngs[:3] + ["-write", str(d / f"{side}-mid-%d.png"),
                                "-negate", str(d / f"{side}.jpg")]) == 0
    for k in range(3):
        assert np.array_equal(_read(d / f"port-mid-{k}.png"),
                              _read(d / f"jax-mid-{k}.png"))
        assert np.abs(_read(d / f"port-{k}.jpg") -
                      _read(d / f"jax-{k}.jpg")).max() <= 1


class _Buf:
    def __init__(self, data=b""):
        self.buffer = _io.BytesIO(data)

    def write(self, s):
        self.buffer.write(s.encode() if isinstance(s, str) else s)

    def flush(self):
        pass


def test_stdin_to_stdout_matches_jax(files, monkeypatch):
    d, pngs, _ = files
    monkeypatch.setattr(jnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "png_available", lambda: False)
    body = open(pngs[3], "rb").read()
    outs = []
    for main in (lambda a: tm.main(a, device="cpu"), jm.main):
        out = _Buf()
        monkeypatch.setattr(sys, "stdin", _Buf(body))
        monkeypatch.setattr(sys, "stdout", out)
        assert main(["-", "-flip", "-negate", "ppm:-"]) == 0
        outs.append(out.buffer.getvalue())
    monkeypatch.undo()
    assert outs[0] == outs[1] and outs[0].startswith(b"P6\n64 48\n255\n")


def test_readers_settings_match_jax(files):
    """-size with raw samples and pseudo images, -depth, -extract, -read,
    -texture, -script and -layers composite with its null: separator."""
    d, pngs, _ = files
    raw = str(d / "x.gray")
    with open(raw, "wb") as f:
        f.write(np.random.default_rng(1).integers(
            0, 256, 10 * 6, dtype=np.uint8).tobytes())
    script = str(d / "s.mgk")
    with open(script, "w") as f:
        f.write("# a script\n-resize 20x20! -flop\n")
    cases = [
        ["-size", "10x6", "-depth", "8", raw, "-negate", "{o}.pgm"],
        ["-size", "12x9", "gradient:red-blue", "-depth", "8", "{o}.ppm"],
        ["-extract", "20x10+5+6", pngs[0], "{o}.ppm"],
        ["-read", pngs[1], "-flip", "{o}.ppm"],
        [pngs[0], "-texture", "rose:", "{o}.ppm"],
        [pngs[0], "-script", script],
        ["-size", "16x12", "xc:navy", "null:", "-size", "8x6", "xc:gold",
         "-gravity", "center", "-layers", "composite", "{o}.ppm"],
        [pngs[4], "+dither", "-remap", "netscape:", "{o}.ppm"],
        ["-size", "8x8", "xc:gray50", "-limit", "area", "1kp", "{o}.ppm"],
    ]
    for k, argv in enumerate(cases):
        outs = []
        for side, main in (("port", lambda a: tm.main(a, device="cpu")),
                           ("jax", jm.main)):
            o = str(d / f"c{k}-{side}")
            args = [a.replace("{o}", o) for a in argv]
            if argv[1] == "-script":
                args = args + ["-write", o + ".ppm"]
            assert main(args) == 0, (side, argv)
            outs.append(o)
        if argv[1] == "-script":
            continue     # the JAX main drops the options after -script
        assert os.path.getsize(outs[0] + argv[-1][3:]) > 0
        assert (d / f"c{k}-port{argv[-1][3:]}").read_bytes() == \
            (d / f"c{k}-jax{argv[-1][3:]}").read_bytes(), argv


@pytest.mark.parametrize("defines", [
    ["-define", "tpu:mesh=abc"], ["-define", "tpu:mesh=2"],
    ["-define", "tpu:mesh=1x2x3x4"], ["-define", "tpu:mesh=x"],
    ["-define", "tpu:mesh=4x4"], ["-define", "tpu:mesh=2x4x4"],
    ["-define", "tpu:mesh=1x1", "-define", "tpu:shard-threshold=abc"],
    ["-define", "tpu:shard-threshold=abc", "-define", "tpu:mesh=1,1"],
    ["-define", "tpu:mesh=1x1"],
    ["-define", "tpu:mesh=1x1x1", "-define", "tpu:shard-threshold=100"],
    ["-define", "tpu:mesh=4x4", "+define", "tpu:mesh"],
    ["-define", "tpu:mesh="],
], ids=["abc", "one-part", "four-parts", "x", "4x4", "2x4x4",
        "bad-threshold", "threshold-first", "fits", "fits-threshold",
        "cleared", "empty"])
def test_tpu_mesh_define_fails_as_the_jax_cli_fails(files, capsys,
                                                     defines):
    """``-define tpu:mesh`` and ``tpu:shard-threshold`` as the JAX CLI
    checks them: the exit code and the stderr text, where a mesh's
    device count names each side's own (the JAX tests' 8 virtual CPU
    devices, the port's one CPU); a mesh that fits writes the same bytes
    as no define, and ``+define`` clears the mesh."""
    d, pngs, _ = files
    out = []
    for side, main, have in (("t", lambda a: tm.main(a, device="cpu"), 1),
                             ("j", jm.main, 8)):
        o = str(d / f"mesh-{side}.ppm")
        rc = main([pngs[0]] + defines + ["-negate", o])
        err = capsys.readouterr().err.replace(f"have {have}", "have N")
        out.append((rc, err, os.path.exists(o) and
                    open(o, "rb").read()))
    assert out[0] == out[1]
    if out[0][0] == 0:
        assert tm.main([pngs[0], "-negate", str(d / "plain.ppm")],
                       device="cpu") == 0
        assert out[0][2] == (d / "plain.ppm").read_bytes()
    else:
        assert out[0][1].startswith("tmagick: ") and out[0][2] is False


def test_informational_options_and_errors(files, capsys):
    """``-list format`` equals the JAX CLI's text but for the lines of the
    names its list gets wrong (``torch_format_faults``, each shown by a
    ``test_jax_*`` test); the other registries equal it whole."""
    from torch_format_faults import RECORDED_FORMATS

    d, pngs, _ = files
    assert tm.main(["-list", "format"], device="cpu") == 0
    listed = capsys.readouterr().out
    assert "PNG          rw" in listed and "MIFF         rw" in listed
    assert "DPX          rw" in listed and "AAI          rw" in listed
    assert "HDR          rw" in listed and "WMF          r-" in listed
    from imagemagick_tpu_torch import native as tnat

    assert ("\nJBIG " in listed) == tnat.jbig_available()
    assert jm.main(["-list", "format"]) == 0
    jax_listed = capsys.readouterr().out

    def unrecorded(text):
        return [ln for ln in text.splitlines()
                if ln.split()[0] not in RECORDED_FORMATS]

    assert unrecorded(listed) == unrecorded(jax_listed)
    assert len(unrecorded(listed)) > 150
    recorded = [ln for ln in listed.splitlines()
                if ln.split()[0] in RECORDED_FORMATS]
    assert "BGRA         rw" in recorded and "SHTML        -w" in recorded
    assert "SIXEL        -w" in recorded and "SIX          -w" in recorded
    for what in ("resource", "policy", "colorspace", "compose", "kernel"):
        tm.main(["-list", what], device="cpu")
        got = capsys.readouterr().out
        jm.main(["-list", what])
        assert got == capsys.readouterr().out
    tm.main(["-version"], device="cpu")
    assert "imagemagick_tpu_torch" in capsys.readouterr().out
    assert tm.main([pngs[0], "-process", "x", "out.png"], device="cpu") == 1
    assert tm.main(["nosuch.png", "out.png"], device="cpu") == 1
    assert tm.main([pngs[0], "-exit", "-negate", str(d / "e.png")],
                   device="cpu") == 0
    assert not (d / "e.png").exists()
    # the tools and -bench run (test_torch_cli_tools.py holds them to the
    # JAX CLI)
    capsys.readouterr()
    assert tm.main(["identify", pngs[0]], device="cpu") == 0
    assert capsys.readouterr().out.startswith(f"{pngs[0]} PNG ")
    assert tm.main([pngs[0], "-bench", "2", str(d / "b.png")],
                   device="cpu") == 0
    assert capsys.readouterr().err.startswith("Performance[1]: 2i ")


def test_jax_seed_is_ignored_the_port_seeds(files):
    """-seed: the JAX CLI stores it and nothing reads it, so -spread draws
    the same offsets whatever the seed; the port seeds its generators
    with it (0 by default, as before)."""
    d, pngs, _ = files
    runs = {}
    for side, main in (("port", lambda a: tm.main(a, device="cpu")),
                       ("jax", jm.main)):
        for seed in ("4", "5", "4"):
            o = str(d / f"{side}-{seed}-{len(runs)}.png")
            assert main([pngs[5], "-seed", seed, "-spread", "3", o]) == 0
            runs[(side, seed, len(runs))] = _read(o)
    port = [v for k, v in runs.items() if k[0] == "port"]
    jax_ = [v for k, v in runs.items() if k[0] == "jax"]
    assert np.array_equal(jax_[0], jax_[1]) and \
        np.array_equal(jax_[0], jax_[2])
    assert not np.array_equal(port[0], port[1])
    assert np.array_equal(port[0], port[2])
    o = str(d / "default.png")
    assert tm.main([pngs[5], "-spread", "3", o], device="cpu") == 0
    assert tm.main([pngs[5], "-seed", "0", "-spread", "3",
                    str(d / "zero.png")], device="cpu") == 0
    assert np.array_equal(_read(o), _read(d / "zero.png"))


def test_files_land_on_the_state_device(files):
    d, pngs, _ = files
    st = tm.process([pngs[0], "rose:"], tm.CLIState(device="cpu"))
    assert [li.image.data.device.type for li in st.images] == ["cpu", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.process([pngs[0]], tm.CLIState())


@pytest.mark.parametrize("dither", [None, "none", "Riemersma",
                                    "FloydSteinberg"])
@pytest.mark.parametrize("opt", ["-remap", "-map"])
def test_remap_under_each_dither_matches_jax_bytes(files, opt, dither):
    """-remap/-map FILE under the default dither (Riemersma), +dither's
    "none", Riemersma and FloydSteinberg: the native octree library on the
    host on both sides, so the written PNGs are equal byte for byte (both
    sides' native libpng, or both PIL where it does not build)."""
    d, pngs, _ = files
    pal = str(d / "palette.png")
    PImage.fromarray(np.array([[[0, 0, 0], [255, 255, 255], [200, 40, 40],
                                [30, 90, 200]]], np.uint8)).save(pal)
    setting = [] if dither is None else (
        ["+dither"] if dither == "none" else ["-dither", dither])
    outs = []
    for side, main in (("port", lambda a: tm.main(a, device="cpu")),
                       ("jax", jm.main)):
        o = str(d / f"{side}-{opt[1:]}-{dither}.png")
        assert main([pngs[2], *setting, opt, pal, o]) == 0
        outs.append(open(o, "rb").read())
    assert outs[0] == outs[1]
    colors = {tuple(px) for px in _read(d / f"port-{opt[1:]}-{dither}.png")
              .reshape(-1, 3)}
    assert colors <= {(0, 0, 0), (255, 255, 255), (200, 40, 40),
                      (30, 90, 200)}
