"""The kernel library's name: a hash of the flags, the sources and headers.

``_build.load()`` names the library it builds by ``_build.digest()`` and
reuses a library of that name when one exists, so every file that goes
into a build must go into the hash.  These tests compile nothing.
"""

import shutil

import numpy as np
import pytest

from imagemagick_tpu_torch import _build


def _copy_sources(tmp_path):
    for path in [*_build._SRC.glob("*.cu"), *_build._SRC.glob("*.cuh")]:
        shutil.copy(path, tmp_path / path.name)
    return tmp_path


def test_digest_covers_the_headers(tmp_path):
    src = _copy_sources(tmp_path)
    assert _build.digest(src) == _build.digest()
    header = src / "lab_roundtrip.cuh"
    before = _build.digest(src)
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.digest(src) != before


def test_digest_covers_sources_and_their_names(tmp_path):
    src = _copy_sources(tmp_path)
    before = _build.digest(src)
    (src / "error.cu").rename(src / "error_text.cu")
    renamed = _build.digest(src)
    assert renamed != before
    kernel = src / "blur_unsharp_pipe.cu"
    kernel.write_bytes(kernel.read_bytes() + b"// edited\n")
    edited = _build.digest(src)
    assert edited not in (before, renamed)
    (src / "notes.txt").write_text("not a source")
    assert _build.digest(src) == edited



def test_digest_covers_the_stencil_header(tmp_path):
    """stencil.cuh, included by K2's and K3's sources, names a new
    library when it changes."""
    src = _copy_sources(tmp_path)
    header = src / "stencil.cuh"
    assert header.exists()
    before = _build.digest(src)
    header.write_bytes(header.read_bytes() + b"// edited\n")
    assert _build.digest(src) != before


def test_threads_loading_at_once_build_once(tmp_path, monkeypatch):
    """A server's first requests reach ``load()`` from several threads at
    once: one of them builds, the others wait for its library (two builds
    in one process share their temporary files' names)."""
    import threading
    import time

    builds = []

    def fake_compile(sources, so):
        builds.append(so)
        time.sleep(0.2)
        so.write_bytes(b"")

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_OUT", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)


def _quantizer(tmp_path, cmd=("g++", "-O2", "-fPIC", "-shared")):
    from imagemagick_tpu_torch import native

    return native._Library("riemersma", "riemersma.cpp", cmd, (),
                           native._bind_riemersma)


def test_threads_loading_the_quantizer_at_once_build_once(tmp_path,
                                                          monkeypatch):
    """The native libraries share one build helper: threads that reach
    the quantizer at once build it once (into an empty directory) and
    all load that library."""
    import threading

    from imagemagick_tpu_torch import native

    monkeypatch.setattr(native, "_OUT", tmp_path)
    lib = _quantizer(tmp_path)
    builds = []
    orig = lib._build
    monkeypatch.setattr(lib, "_build",
                        lambda so: builds.append(so) or orig(so))
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib.load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 8
    assert got[0] is not None and all(g is got[0] for g in got)
    assert [p.name for p in tmp_path.iterdir()] == [lib.path().name]


def test_a_failed_quantizer_build_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    """Unlike the codec (whose callers fall back to PIL), the quantizer
    must build: a failed build raises RuntimeError carrying what the
    compiler said, and leaves no file behind."""
    from imagemagick_tpu_torch import native

    monkeypatch.setattr(native, "_OUT", tmp_path)
    lib = _quantizer(tmp_path, ("g++", "-O2", "-fPIC", "-shared",
                                "-DNOT_A_FLAG", "-no-such-option"))
    monkeypatch.setattr(native, "_RIEMERSMA", lib)
    with pytest.raises(RuntimeError, match="no-such-option"):
        native.octree_quantize(np.zeros((4, 4, 3), np.float32), 4)
    assert lib.failed and "no-such-option" in lib.error
    assert list(tmp_path.iterdir()) == []


def test_the_codec_still_returns_none_when_it_does_not_build(tmp_path,
                                                            monkeypatch):
    from imagemagick_tpu_torch import native

    monkeypatch.setattr(native, "_OUT", tmp_path)
    lib = native._Library("miniio", "miniio.cpp",
                          ("g++", "-no-such-option"), ("-ljpeg",),
                          native._bind_miniio)
    monkeypatch.setattr(native, "_MINIIO", lib)
    assert not native.available()
    assert native.decode_jpeg(b"\xff\xd8") is None
    assert "no-such-option" in native.build_error()
