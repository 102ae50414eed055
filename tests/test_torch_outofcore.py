"""Port parity: models/outofcore.py and io/stream.py against the JAX
package, on the CPU.

Inputs are float32 images made from a numpy seed, tens of rows tall, and
PNM, MIFF and raw files built from them.  Tolerances, stated per case:
pointwise chains within 1e-6 (float32 ops in another order at most an
ulp apart), neighbourhood chains within 1e-5 (float32 sums of the blur
taps in another order, as the JAX tests hold the banded chain to the
in-core one), chains through the banded resize within 2e-5 (float32 dot
products of the resize operators in another order), streamed rows and
streaming writers' bytes exact.  The three faults of the JAX reference
that the port does not copy are kept visible in ``test_jax_*`` tests:
``read_stream`` reads a whole MIFF file to parse its header,
``process_tiled`` reads its first band twice, and ``run_chain``'s banded
resize leaves values that ring past [0, 1] unclipped."""

import builtins
import importlib

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch.core.policy import PolicyError, no_host_files
from imagemagick_tpu_torch.io import stream as tst
from imagemagick_tpu_torch.models import outofcore as toc

joc = importlib.import_module("imagemagick_tpu.models.outofcore")
jst = importlib.import_module("imagemagick_tpu.io.stream")
jhist = importlib.import_module("imagemagick_tpu.ops.histogram")
jblur = importlib.import_module("imagemagick_tpu.ops.blur")
thist = importlib.import_module("imagemagick_tpu_torch.ops.histogram")
tblur = importlib.import_module("imagemagick_tpu_torch.ops.blur")

POINTWISE_TOL = 1e-6
NEIGHBOUR_TOL = 1e-5
RESIZE_TOL = 2e-5


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(5).random((60, 24, 3)).astype(np.float32)


def _both(src, shape, ops, **kw):
    got = toc.run_chain(src, shape, ops, device="cpu", **kw)
    want = joc.run_chain(src, shape, ops, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max())


# -- run_chain --------------------------------------------------------------

# the JAX tests' cases (tests/test_outofcore_chain.py), on a smaller image
@pytest.mark.parametrize("ops,kw,tol", [
    ([("negate", {}), ("gamma", {"value": 1.8}),
      ("level", {"black": 0.1, "white": 0.9})], {"band_rows": 17},
     POINTWISE_TOL),
    ([("median", {"radius": 1}), ("unsharp", {"sigma": 1.0})],
     {"band_rows": 16}, NEIGHBOUR_TOL),
    ([("blur", {"sigma": 1.5})],
     {"resize": (31, 16, "lanczos"), "band_rows": 8,
      "post_ops": [("blur", {"sigma": 1.0}),
                   ("colorspace", {"dst": "gray"})]}, RESIZE_TOL),
], ids=["pointwise", "median-unsharp", "blur-resize-blur-gray"])
def test_run_chain_matches_jax(img, ops, kw, tol):
    assert _both(img, img.shape, ops, **kw) <= tol


def test_memmap_source_and_band_smaller_than_halo(img, tmp_path):
    f = tmp_path / "big.raw"
    mm = np.memmap(str(f), dtype=np.float32, mode="w+", shape=img.shape)
    mm[:] = img
    mm.flush()
    ro = np.memmap(str(f), dtype=np.float32, mode="r", shape=img.shape)
    assert _both(ro, img.shape, [("morphology", {
        "method": "open", "kernel": "square:1"})], band_rows=25) <= \
        POINTWISE_TOL
    # a band of 4 rows under a halo of 9 (sigma 3)
    assert _both(img[:20], (20,) + img.shape[1:], [("blur", {"sigma": 3.0})],
                 band_rows=4) <= NEIGHBOUR_TOL


# every op of the registry, on bands of 7 rows
REGISTRY = [
    ("negate", {}, POINTWISE_TOL),
    ("gamma", {"value": 0.7}, POINTWISE_TOL),
    ("level", {"black": 0.2, "white": 0.8, "gamma": 1.3}, POINTWISE_TOL),
    ("modulate", {"brightness": 110, "saturation": 80, "hue": 120},
     NEIGHBOUR_TOL),
    ("colorspace", {"dst": "lab"}, NEIGHBOUR_TOL),
    ("threshold", {"value": 0.4}, 0.0),
    ("blur", {"radius": 2, "sigma": 1.2}, NEIGHBOUR_TOL),
    ("unsharp", {"sigma": 0.8, "amount": 1.5, "threshold": 0.0},
     NEIGHBOUR_TOL),
    ("morphology", {"method": "close", "kernel": "diamond:1"},
     POINTWISE_TOL),
    ("median", {"radius": 2}, POINTWISE_TOL),
]


@pytest.mark.parametrize("name,params,tol", REGISTRY,
                         ids=[r[0] for r in REGISTRY])
def test_every_registry_op_matches_jax(img, name, params, tol):
    assert sorted(toc._CHAIN_OPS) == sorted(joc._CHAIN_OPS)
    assert _both(img, img.shape, [(name, params)], band_rows=7) <= tol


@pytest.mark.parametrize("band_rows", [1, 7, 90])
def test_band_sizes_match_jax(img, band_rows):
    """Bands of one row, of 7, and one band over the whole height; a
    morphology of two iterations expands to four stages."""
    ops = [("blur", {"sigma": 0.8}),
           ("morphology", {"method": "erode", "kernel": "square:1",
                           "iterations": 2})]
    assert _both(img[:12], (12,) + img.shape[1:], ops,
                 band_rows=band_rows) <= NEIGHBOUR_TOL


# -- process_tiled, reduce_tiled --------------------------------------------

class _Loader:
    def __init__(self, arr):
        self.arr, self.calls = arr, []

    def __call__(self, y0, y1):
        self.calls.append((y0, y1))
        return self.arr[y0:y1]


def test_process_tiled_matches_jax_reading_each_band_once(img):
    import jax.numpy as jnp

    tl, jl = _Loader(img), _Loader(img)
    got = toc.process_tiled(
        tl, img.shape[0], lambda x: tblur.gaussian_blur(x, 0.0, 1.0),
        halo=3, band_rows=16, device="cpu")
    want = joc.process_tiled(
        jl, img.shape[0], lambda x: jblur.gaussian_blur(x, 0.0, 1.0),
        halo=3, band_rows=16)
    assert np.abs(got - want).max() <= NEIGHBOUR_TOL
    assert tl.calls == [(0, 19), (13, 35), (29, 51), (45, 60)]
    assert jl.calls == [(0, 16)] + tl.calls
    # numpy output, dtype kept
    out = np.zeros(img.shape, np.float32)
    assert toc.process_tiled(img, img.shape[0], lambda x: 1.0 - x,
                             band_rows=25, out=out, device="cpu") is out
    assert np.array_equal(out, 1.0 - img)
    assert np.array_equal(
        joc.process_tiled(img, img.shape[0], lambda x: jnp.negative(x) + 1.0,
                          band_rows=25), out)


def test_reduce_tiled_histograms_match_jax(img):
    def combine(acc, part):
        return acc + part

    got = toc.reduce_tiled(img, img.shape[0], thist.channel_histogram,
                           combine, np.zeros((256, 3), np.float32),
                           band_rows=13, device="cpu")
    want = joc.reduce_tiled(img, img.shape[0], jhist.channel_histogram,
                            combine, np.zeros((256, 3), np.float32),
                            band_rows=13)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert got.sum() == img.shape[0] * img.shape[1] * 3


# -- halos, expansion, errors -----------------------------------------------

@pytest.mark.parametrize("ops", [
    [("blur", {"sigma": 2.0}), ("unsharp", {"radius": 3})],
    [("morphology", {"method": "smooth", "kernel": "square:2",
                     "iterations": 2}), ("median", {"radius": 3})],
    [("morphology", {"method": "tophat", "kernel": "disk:2.5"}),
     ("morphology", {"method": "dilate", "iterations": 3})],
    [("negate", {}), ("threshold", {})],
])
def test_chain_halo_and_expansion_match_jax(ops):
    assert toc._expand_ops(ops) == joc._expand_ops(ops)
    assert toc.chain_halo(ops) == joc.chain_halo(ops)


@pytest.mark.parametrize("ops", [
    [("definitely-not-an-op", {})],
    [("morphology", {"method": "thinning", "iterations": -1})],
    [("morphology", {"method": "distance"})],
], ids=["unknown-op", "until-converged", "not-row-local"])
def test_errors_match_jax(img, ops):
    with pytest.raises(Exception) as want:
        joc.run_chain(img, img.shape, ops)
    with pytest.raises(want.type) as got:
        toc.run_chain(img, img.shape, ops, device="cpu")
    assert str(got.value) == str(want.value)


# -- read_stream, open_rows -------------------------------------------------

def _u8(seed, h, w, c):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _files(tmp_path):
    """name -> (path, size): P5/P6 at 8 and 16 bits, MIFF at 8, 16 and
    float, raw RGB (with -size), and a PNG (the fallback)."""
    from PIL import Image as PImage

    out = {}
    a8 = _u8(1, 23, 17, 3)
    a16 = np.random.default_rng(2).integers(0, 65536, (23, 17, 1), np.uint16)
    p = tmp_path / "p6.ppm"
    p.write_bytes(b"P6\n# c\n17 23\n255\n" + a8.tobytes())
    out["p6-8"] = (p, None)
    p = tmp_path / "p5.pgm"
    p.write_bytes(b"P5 17 23 65535\n" + a16.astype(">u2").tobytes())
    out["p5-16"] = (p, None)
    p = tmp_path / "p6-16.ppm"
    p.write_bytes(b"P6\n17 23\n1023\n" +
                  (a8.astype(np.uint16) * 4).astype(">u2").tobytes())
    out["p6-16"] = (p, None)
    for name, depth, body, extra, alpha in (
            ("miff-8", 8, a8.tobytes(), "", "False"),
            ("miff-16", 16, np.concatenate(
                [a8.astype(">u2") * 257, a8[..., :1].astype(">u2") * 3], -1
            ).tobytes(), "", "True"),
            ("miff-float", 32, (a8 / 255.0).astype(">f4").tobytes(),
             "quantum:format=floating-point\n", "False")):
        head = (f"id=ImageMagick  version=1.0\nclass=DirectClass  "
                f"colors=0  alpha={alpha}\ncolumns=17  rows=23  "
                f"depth={depth}\ncolorspace=sRGB\n{extra}"
                f"compression=None\n\x0c\n:\x1a").encode()
        p = tmp_path / f"{name}.miff"
        p.write_bytes(head + body)
        out[name] = (p, None)
    p = tmp_path / "raw.rgb"
    p.write_bytes(a8.tobytes())
    out["raw"] = (p, "17x23")
    p = tmp_path / "fallback.png"
    PImage.fromarray(a8).save(p)
    out["png"] = (p, None)
    return out


STREAMS = ["p6-8", "p5-16", "p6-16", "miff-8", "miff-16", "miff-float",
           "raw", "png"]


def _collect(read_stream, path, size, stop_at=None, rows=5):
    got = []

    def handler(batch, y):
        got.append((y, np.array(batch)))
        if stop_at is not None and y >= stop_at:
            return False
        return None

    n = read_stream(str(path), handler, rows_per_batch=rows, size=size)
    return n, got


@pytest.mark.parametrize("name", STREAMS)
def test_read_stream_and_open_rows_match_jax(tmp_path, name):
    path, size = _files(tmp_path)[name]
    for stop in (None, 9):
        n, got = _collect(tst.read_stream, path, size, stop)
        jn, want = _collect(jst.read_stream, path, size, stop)
        assert n == jn and len(got) == len(want)
        for (y, a), (jy, b) in zip(got, want):
            assert y == jy and a.dtype == b.dtype and np.array_equal(a, b)
    if name == "png":
        with pytest.raises(ValueError) as want:
            jst.open_rows(str(path))
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            tst.open_rows(str(path))
        return
    loader, shape = tst.open_rows(str(path), size=size)
    jloader, jshape = jst.open_rows(str(path), size=size)
    assert shape == jshape
    for y0, y1 in ((0, 23), (4, 11), (22, 23)):
        a, b = loader(y0, y1), jloader(y0, y1)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_short_file_stops_where_jax_stops(tmp_path):
    a8 = _u8(3, 20, 9, 3)
    p = tmp_path / "short.ppm"
    p.write_bytes(b"P6\n9 20\n255\n" + a8.tobytes()[:9 * 3 * 13 + 5])
    n, got = _collect(tst.read_stream, p, None, rows=4)
    jn, want = _collect(jst.read_stream, p, None, rows=4)
    assert n == jn == 12 and len(got) == len(want) == 3
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b)


def test_jax_read_stream_reads_a_whole_miff_file(tmp_path, monkeypatch):
    """The JAX read_stream reads a whole MIFF to parse its header (its
    `data = f.read()`), against its own one-range-a-batch contract; the
    port reads the first 64 KiB, as open_rows does, and the batches."""
    rows, width = 300, 100
    path = tmp_path / "big.miff"
    path.write_bytes(
        b"id=ImageMagick  version=1.0\nclass=DirectClass  colors=0  "
        b"alpha=True\ncolumns=100  rows=300  depth=16\ncolorspace=sRGB\n"
        b"compression=None\n\x0c\n:\x1a" + bytes(rows * width * 8))
    size = path.stat().st_size
    counts = {}
    real_open = builtins.open

    class _Counting:
        def __init__(self, f, key):
            self.f, self.key = f, key

        def read(self, n=-1):
            data = self.f.read(n)
            counts[self.key] = counts.get(self.key, 0) + len(data)
            return data

        def __getattr__(self, attr):
            return getattr(self.f, attr)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return self.f.__exit__(*exc)

    for key, mod in (("jax", jst), ("port", tst)):
        monkeypatch.setattr(builtins, "open", lambda *a, k=key, **kw:
                            _Counting(real_open(*a, **kw), k))
        mod.read_stream(str(path), lambda batch, y: False,
                        rows_per_batch=2)
        monkeypatch.setattr(builtins, "open", real_open)
    batch = 2 * width * 4 * 2
    assert counts["jax"] == 16 + size + batch
    assert counts["port"] == 16 + 64 * 1024 + batch


def test_jax_process_tiled_reads_its_first_band_twice(img):
    """The JAX process_tiled reads rows 0..band_rows once more than its
    bands need (an unused probe); the port reads each band once."""
    jl, tl = _Loader(img), _Loader(img)
    joc.process_tiled(jl, 40, lambda x: x, band_rows=20)
    toc.process_tiled(tl, 40, lambda x: x, band_rows=20, device="cpu")
    assert jl.calls == [(0, 20), (0, 20), (20, 40)]
    assert tl.calls == [(0, 20), (20, 40)]


def test_jax_banded_resize_leaves_ringing_unclipped():
    """The JAX run_chain's banded resize leaves the values that a Lanczos
    lobe rings past [0, 1] unclipped, where ops.resize (the in-core route)
    clips them; the port clips after its two products, as ops.resize does,
    and gives the in-core resize."""
    jrz = importlib.import_module("imagemagick_tpu.ops.resize")
    img = np.zeros((40, 24, 3), np.float32)
    img[:, 9:15] = 1.0
    img[17:23] = 1.0 - img[17:23]
    kw = dict(resize=(20, 12, "lanczos"), band_rows=8)
    want = joc.run_chain(img, img.shape, [], **kw)
    assert want.min() < -1e-3 and want.max() > 1.0 + 1e-3
    got = toc.run_chain(img, img.shape, [], device="cpu", **kw)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(got - np.clip(want, 0.0, 1.0)).max() <= RESIZE_TOL
    incore = np.asarray(jrz.resize(img, 20, 12, "lanczos"))
    assert np.abs(got - incore).max() <= RESIZE_TOL


# -- convert_streaming ------------------------------------------------------

def _inputs(tmp_path):
    """A P6, a P5 and an RGBA MIFF of 16-bit samples, 37x21."""
    a8 = _u8(9, 37, 21, 3)
    p6 = tmp_path / "in.ppm"
    p6.write_bytes(b"P6\n21 37\n255\n" + a8.tobytes())
    p5 = tmp_path / "in.pgm"
    p5.write_bytes(b"P5\n21 37\n255\n" + a8[..., :1].tobytes())
    rgba = np.concatenate([a8, a8[..., 1:2] // 2 + 60], -1)
    m4 = tmp_path / "in.miff"
    m4.write_bytes(
        b"id=ImageMagick  version=1.0\nclass=DirectClass  colors=0  "
        b"alpha=True\ncolumns=21  rows=37  depth=16\ncolorspace=sRGB\n"
        b"compression=None\n\x0c\n:\x1a" +
        (rgba.astype(">u2") * 257).tobytes())
    return {1: p5, 3: p6, 4: m4}


# the writer of each name of _WRITER_EXT, with the channels of its input
WRITERS = [("pnm", 3), ("ppm", 3), ("pgm", 1), ("miff", 4), ("png", 3),
           ("gray", 1), ("rgb", 3), ("rgba", 4)]


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ext,channels", WRITERS,
                         ids=[w[0] for w in WRITERS])
def test_convert_streaming_bytes_match_jax(tmp_path, ext, channels, depth):
    assert sorted(tst._WRITER_EXT) == sorted(jst._WRITER_EXT)
    src = _inputs(tmp_path)[channels]
    ops = [("negate", {}), ("gamma", {"value": 0.8})]
    kw = dict(ops=ops, band_rows=8, depth=depth)
    if ext == "png":
        kw["resize"] = (19, 11, "triangle")
    tst.convert_streaming(str(src), str(tmp_path / f"t.{ext}"),
                          device="cpu", **kw)
    jst.convert_streaming(str(src), str(tmp_path / f"j.{ext}"), **kw)
    assert (tmp_path / f"t.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("out,channels", [
    ("o.ppm", 4), ("o.pgm", 4), ("o.jpg", 3), ("o.png", 5)])
def test_convert_streaming_errors_match_jax(tmp_path, out, channels):
    if channels == 5:
        # a five-channel raw source: PNG cannot carry it
        src = tmp_path / "x.miff"
        src.write_bytes(
            b"id=ImageMagick\nclass=DirectClass alpha=True\ncolumns=4 "
            b"rows=3 depth=8\ncolorspace=CMYK\ncompression=None\n\x0c\n:\x1a"
            + bytes(4 * 3 * 5))
    else:
        src = _inputs(tmp_path)[channels]
    with pytest.raises(Exception) as want:
        jst.convert_streaming(str(src), str(tmp_path / ("j" + out)))
    with pytest.raises(want.type) as got:
        tst.convert_streaming(str(src), str(tmp_path / ("t" + out)),
                              device="cpu")
    assert str(got.value) == str(want.value)
    assert (tmp_path / ("t" + out)).exists() == \
        (tmp_path / ("j" + out)).exists()


def test_streams_refused_inside_no_host_files(tmp_path):
    src = _inputs(tmp_path)[3]
    with no_host_files():
        for call in (lambda: tst.open_rows(str(src)),
                     lambda: tst.read_stream(str(src), lambda b, y: None),
                     lambda: tst.convert_streaming(
                         str(src), str(tmp_path / "o.ppm"), device="cpu")):
            with pytest.raises(PolicyError):
                call()


def test_run_chain_raises_without_a_card(img):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        toc.run_chain(img, img.shape, [("negate", {})])
