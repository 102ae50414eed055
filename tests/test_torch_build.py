"""The kernel library's name: a hash of the flags, the sources and headers.

``_build.load()`` names the library it builds by ``_build.digest()`` and
reuses a library of that name when one exists, so every file that goes
into a build must go into the hash.  These tests compile nothing.
"""

import shutil

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
