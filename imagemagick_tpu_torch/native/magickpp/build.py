"""Builder of the port's Magick++ library and of the programs that use it.

Port of ``imagemagick_tpu/native/magickpp/build.py``.  ``build()``
compiles ``magickpp.cpp`` (with ``Magick++.h`` and ``Drawable.h``) into
``imagemagick_tpu_torch/_build/libmagickpp_<hash>.so``, the hash taken over
the three sources and the command, as ``native._Library`` names its
libraries: the compiler writes a file of its own, which is then renamed
into place, so processes that build at once each load a whole library.
A failed build raises RuntimeError with the compiler's text.

The library embeds the Python interpreter that built it
(``MAGICKPP_PYTHON``, so that its packages, torch among them, are the
embedded interpreter's); a program must run with the repository's root
on ``PYTHONPATH`` so that it can import ``imagemagick_tpu_torch``.

``compile_program(source, out, device=...)`` links a C++ program against
the library (rpath into ``_build/``).  The device is the program's:
``InitializeMagick(path)`` takes its default from ``MAGICKPP_DEVICE``,
``"cuda"`` unless ``device`` names another, which the program is then
compiled with (``-DMAGICKPP_DEVICE="cpu"``).  From the shell::

    g++ prog.cpp -I<this dir> $(python3-config --includes) \
        -L<_build> -l:libmagickpp_<hash>.so -Wl,-rpath,<_build> \
        $(python3-config --embed --ldflags) [-DMAGICKPP_DEVICE='"cpu"'] \
        -o prog
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

_HERE = Path(__file__).resolve().parent
_OUT = _HERE.parent.parent / "_build"
_SOURCES = ("magickpp.cpp", "Magick++.h", "Drawable.h")
_lock = threading.Lock()


def _py_link_flags() -> List[str]:
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var(
        "VERSION")
    flags = []
    if libdir:
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}"]
    flags += [f"-lpython{ver}", "-ldl", "-lm"]
    return flags


def include_dir() -> str:
    return str(_HERE)


def _command() -> List[str]:
    """The library's compile command, without its output file."""
    return (["g++", "-O1", "-fPIC", "-shared", "-std=c++11",
             f'-DMAGICKPP_PYTHON="{sys.executable}"',
             str(_HERE / "magickpp.cpp"), f"-I{sysconfig.get_path('include')}",
             f"-I{_HERE}"] + _py_link_flags())


def library_path() -> Path:
    """Where the library for these sources and this command lives."""
    h = hashlib.sha256(" ".join(_command()).encode())
    for name in _SOURCES:
        h.update((_HERE / name).read_bytes())
    return _OUT / f"libmagickpp_{h.hexdigest()[:16]}.so"


def build() -> str:
    """The library's path, compiled first if it is not there; raises
    RuntimeError with the compiler's text if the build fails."""
    with _lock:
        so = library_path()
        if so.exists():
            return str(so)
        _OUT.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
        cmd = _command() + [f"-Wl,-soname,{so.name}", "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"magickpp build failed: {exc}") from exc
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("magickpp build failed:\n" + r.stderr)
        os.replace(tmp, so)
        return str(so)


def compile_program(source_path: str, out_path: str,
                    device: Optional[str] = None) -> str:
    """Compile a user C++ program against the Magick++ layer; ``device``
    (None: the header's ``"cuda"``) is what its ``InitializeMagick(path)``
    takes.  Raises RuntimeError with the compiler's text on failure."""
    so = Path(build())
    cmd = ["g++", "-O0", "-std=c++11", str(source_path), f"-I{_HERE}",
           f"-I{sysconfig.get_path('include')}"]
    if device is not None:
        cmd.append(f'-DMAGICKPP_DEVICE="{device}"')
    cmd += [f"-L{so.parent}", f"-l:{so.name}", f"-Wl,-rpath,{so.parent}"]
    cmd += _py_link_flags() + ["-o", str(out_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("program build failed:\n" + r.stderr)
    return str(out_path)
