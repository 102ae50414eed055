"""Port parity: the native JPEG codec against the JAX package's.

Both compile the same ``miniio.cpp`` against the same libjpeg, so decodes
are byte-equal on the same JPEG bytes."""

import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from imagemagick_tpu_torch import native as tn

jn = importlib.import_module("imagemagick_tpu.native")

REPO = Path(__file__).resolve().parent.parent


def _smooth(h, w, seed=0):
    """A smooth gradient with a little texture, as u8 (h, w, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 17.0)[..., None] * np.cos(
        xx[..., None] / 23.0 + np.arange(3))
    img = base + 0.01 * rng.standard_normal((h, w, 3))
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _noise(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)


def test_both_available():
    assert tn.available() and jn.available()
    assert tn.build_error() is None
    assert tn.library_path().exists()


@pytest.mark.parametrize("shape", [(48, 64), (37, 50), (512, 768)])
def test_decode_equals_jax(shape):
    blob = tn.encode_jpeg(_noise(*shape, seed=shape[0]), 90)
    got = tn.decode_jpeg(blob)
    want = jn.decode_jpeg(blob)
    assert got.shape == shape + (3,) and got.dtype == np.uint8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("source,hint", [
    ((512, 768), (256, 256)), ((512, 768), (100, 60)),
    ((512, 768), (768, 512)), ((64, 96), (8, 8)), ((37, 50), (4, 4))])
def test_scaled_decode_equals_jax(source, hint):
    blob = tn.encode_jpeg(_noise(*source, seed=1), 90)
    got = tn.decode_jpeg_scaled(blob, *hint)
    want = jn.decode_jpeg_scaled(blob, *hint)
    assert np.array_equal(got, want)
    # the largest 1/{1,2,4,8} scale still covering the hint
    assert got.shape[1] >= hint[0] and got.shape[0] >= hint[1]


def test_scaled_decode_picks_half_at_config5():
    """A 768x512 source with a 256x256 hint decodes at 1/2: 384x256, the
    thumbnailer's staged (256, 1152) layout."""
    blob = tn.encode_jpeg(_noise(512, 768), 90)
    assert tn.decode_jpeg_scaled(blob, 256, 256).shape == (256, 384, 3)


@pytest.mark.parametrize("channels", [1, 3])
def test_encode_equals_jax(channels):
    img = _smooth(40, 56)[..., :channels]
    assert tn.encode_jpeg(img, 87) == jn.encode_jpeg(img, 87)


@pytest.mark.parametrize("quality,min_db", [(95, 38.0), (75, 35.0)])
def test_round_trip(quality, min_db):
    img = _smooth(64, 96, seed=2)
    out = tn.decode_jpeg(tn.encode_jpeg(img, quality))
    assert out.shape == img.shape
    rms = np.sqrt(np.mean((out.astype(np.float64) - img) ** 2)) / 255.0
    assert 20.0 * np.log10(1.0 / max(rms, 1e-12)) >= min_db


def test_gray_round_trip_decodes_to_rgb():
    gray = _smooth(32, 48)[..., :1]
    out = tn.decode_jpeg(tn.encode_jpeg(gray, 95))
    assert out.shape == (32, 48, 3)
    assert np.abs(out.astype(int) - gray.astype(int)).max() <= 8


@pytest.mark.parametrize("blob", [b"", b"garbage", b"\xff\xd8\xff\xe0junk",
                                  b"\x89PNG\r\n\x1a\n"])
def test_bad_input_returns_none(blob):
    assert tn.decode_jpeg(blob) is None
    assert tn.decode_jpeg_scaled(blob, 16, 16) is None


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it at once into the same
    directory; each loads a whole library and leaves no temporary file."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import numpy as np
        sys.path.insert(0, {str(REPO)!r})
        from imagemagick_tpu_torch import native
        native._OUT = Path({str(tmp_path)!r})
        ok = native.available()
        blob = native.encode_jpeg(np.full((8, 8, 3), 128, np.uint8))
        print(ok, native.decode_jpeg(blob).shape, native.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[:4] == ["True", "(8,", "8,", "3)"], out
    names = {out.split()[-1] for out, _ in outs}
    assert [p.name for p in tmp_path.iterdir()] == list(names)


# -- the octree quantizer (riemersma.cpp): the same source built with the
# same flags (g++ -O2 -fPIC -shared) as the JAX package's, so the same
# float32 input gives the same bits

def _frame(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_quantizer_builds_under_a_hashed_name():
    assert tn.riemersma_available()
    path = tn._RIEMERSMA.path()
    assert path.exists() and path.parent == tn._OUT
    assert path.name.startswith("libriemersma_") and tn._RIEMERSMA.error is None
    # the port's copy differs from the JAX package's only in comments
    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.lstrip().startswith("//")]

    assert code(tn._HERE / "riemersma.cpp") == \
        code(REPO / "imagemagick_tpu" / "native" / "riemersma.cpp")


@pytest.mark.parametrize("colors", [2, 16, 256])
@pytest.mark.parametrize("dither", ["none", "riemersma", "fs",
                                    "FloydSteinberg", ""])
@pytest.mark.parametrize("shape", [(48, 64, 3), (40, 56, 1), (33, 47, 4)],
                         ids=str)
def test_octree_quantize_equals_jax(colors, dither, shape):
    x = _frame(shape, colors)
    out, pal = tn.octree_quantize(x, colors, dither)
    jout, jpal = jn.octree_quantize(x, colors, dither)
    assert out.dtype == np.float32 and pal.shape[1] == 4
    assert len(pal) <= colors
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(pal, jpal)


@pytest.mark.parametrize("depth", [2, 3, 5, 8])
def test_octree_quantize_tree_depth_equals_jax(depth):
    x = _frame((48, 64, 3), 3)
    for got, want in zip(tn.octree_quantize(x, 8, "none", depth),
                         jn.octree_quantize(x, 8, "none", depth)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [2, 3, 8])
@pytest.mark.parametrize("shape", [(48, 64, 3), (40, 56), (33, 47, 4)],
                         ids=str)
def test_dithered_posterize_equals_jax(levels, shape):
    x = _frame(shape, levels)
    np.testing.assert_array_equal(tn.riemersma_posterize(x, levels),
                                  jn.riemersma_posterize(x, levels))
    np.testing.assert_array_equal(tn.floyd_steinberg_posterize(x, levels),
                                  jn.floyd_steinberg_posterize(x, levels))
    np.testing.assert_array_equal(tn.riemersma_posterize(x, levels, 0.5),
                                  jn.riemersma_posterize(x, levels, 0.5))


@pytest.mark.parametrize("dither", ["none", "riemersma", "fs"])
@pytest.mark.parametrize("pal_c", [3, 4, 1])
def test_octree_remap_equals_jax(dither, pal_c):
    x = _frame((40, 56, 3), 5)
    pal = _frame((9, pal_c), 6)
    np.testing.assert_array_equal(tn.octree_remap(x, pal, dither),
                                  jn.octree_remap(x, pal, dither))


def test_refused_arguments_raise_where_jax_returns_none():
    x = _frame((8, 8, 3))
    with pytest.raises(ValueError, match="arguments refused"):
        tn.riemersma_posterize(x, 1)
    assert jn.riemersma_posterize(x, 1) is None
    with pytest.raises(ValueError, match="arguments refused"):
        tn.octree_quantize(_frame((8, 8, 5)), 4)
    assert jn.octree_quantize(_frame((8, 8, 5)), 4) is None
    with pytest.raises(ValueError, match="one"):
        tn.octree_quantize(_frame((2, 8, 8, 3)), 4)


def test_quantizer_inputs_stay_untouched():
    x = _frame((24, 32, 3), 7)
    before = x.copy()
    tn.octree_quantize(x, 8)
    tn.riemersma_posterize(x, 4)
    np.testing.assert_array_equal(x, before)


# -- the PNG half of miniio.cpp, heifjxl.cpp and jbigio.cpp: each its own
# library, built from the port's copies; each held to the JAX package's
# function where its system library loads here

def _need(flag: bool, what: str):
    if not flag:
        pytest.skip(f"{what} does not load here")


def test_each_codec_is_its_own_library():
    """The JPEG and PNG halves of miniio.cpp are two libraries (one
    linked with -ljpeg, the other with -lpng), the HEIF/JPEG XL and JBIG
    codecs two more, all under _build/; the port's miniio.cpp is the JAX
    package's with two guards added."""
    libs = (tn._MINIIO, tn._MINIIO_PNG, tn._HEIFJXL, tn._JBIG)
    assert len({lib.path() for lib in libs}) == 4
    assert all(lib.path().parent == tn._OUT for lib in libs)
    assert tn._MINIIO.libs == ("-ljpeg",) and tn._MINIIO_PNG.libs == \
        ("-lpng",)

    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if ln.strip() and not ln.lstrip().startswith(("//", "#if",
                                                               "#endif"))]

    for name in ("miniio.cpp", "heifjxl.cpp", "jbigio.cpp"):
        assert code(tn._HERE / name) == \
            code(REPO / "imagemagick_tpu" / "native" / name), name


def test_a_missing_libpng_leaves_the_jpeg_codec(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "_OUT", tmp_path)
    lib = tn._Library("miniio_png", "miniio.cpp",
                      ("g++", "-no-such-option"), ("-lpng",),
                      tn._bind_miniio_png)
    monkeypatch.setattr(tn, "_MINIIO_PNG", lib)
    assert not tn.png_available()
    assert tn.decode_png(b"\x89PNG\r\n\x1a\n") is None
    assert tn.encode_png(np.zeros((2, 2, 3), np.uint8)) is None
    _need(tn.available(), "libjpeg")
    blob = tn.encode_jpeg(_smooth(16, 24), 90)
    assert tn.decode_jpeg(blob).shape == (16, 24, 3)


@pytest.mark.parametrize("channels,depth", [(1, 8), (2, 8), (3, 8), (4, 8),
                                            (1, 16), (3, 16), (4, 16)])
def test_png_equals_jax(channels, depth):
    _need(tn.png_available() and jn.available(), "libpng")
    rng = np.random.default_rng(channels * depth)
    top = 65535 if depth == 16 else 255
    arr = rng.integers(0, top + 1, (19, 27, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)
    blob = tn.encode_png(arr, depth)
    assert blob == jn.encode_png(arr, depth)
    got, want = tn.decode_png(blob), jn.decode_png(blob)
    assert got[1] == want[1] == depth
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0].astype(np.int64), arr)


@pytest.mark.parametrize("blob", [b"", b"garbage", b"\xff\xd8\xff\xe0junk"])
def test_bad_png_returns_none(blob):
    _need(tn.png_available(), "libpng")
    assert tn.decode_png(blob) is None


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_jxl_equals_jax(channels):
    _need(tn.jxl_available() and jn.jxl_available(), "libjxl 0.7")
    arr = _smooth(21, 30)[..., :channels] if channels <= 3 else \
        np.concatenate([_smooth(21, 30), _smooth(21, 30, 1)[..., :1]], -1)
    blob = tn.encode_jxl(arr)
    assert blob is not None and blob == jn.encode_jxl(arr)
    np.testing.assert_array_equal(tn.decode_jxl(blob), jn.decode_jxl(blob))


def test_heif_equals_jax():
    _need(tn.heif_available() and jn.heif_available(), "libheif")
    arr = _smooth(32, 48)
    blob = jn.encode_heif(arr, 80)
    if blob is None:                    # no HEVC encoder plugin here
        assert tn.encode_heif(arr, 80) is None
        return
    assert tn.encode_heif(arr, 80) is not None
    np.testing.assert_array_equal(tn.decode_heif(blob), jn.decode_heif(blob))
    assert tn.decode_heif(b"garbage") is None


@pytest.mark.parametrize("shape", [(9, 13), (32, 64), (5, 1)])
def test_jbig_equals_jax(shape):
    _need(tn.jbig_available() and jn.jbig_available(), "libjbig")
    bm = (np.random.default_rng(shape[0]).random(shape) > 0.6) \
        .astype(np.uint8)
    blob = tn.jbig_encode(bm)
    assert blob == jn.jbig_encode(bm)
    np.testing.assert_array_equal(tn.jbig_decode(blob), bm)
    np.testing.assert_array_equal(tn.jbig_decode(blob), jn.jbig_decode(blob))
    assert tn.jbig_decode(b"garbage") is None
