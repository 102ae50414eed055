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
