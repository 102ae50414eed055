"""Build and load the package's CUDA kernels.

On first use, ``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
stores it under ``_build/`` keyed by a hash of the sources and flags, and
loads it with ``ctypes``.  Nothing includes PyTorch's headers, so a build
takes seconds.  Each C entry launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    # r0, x, wv, gb, kr, c0s, guids, out, nprog, ntiles, nterms, nb, TO,
    # BAND, SPAN, WINC, OUTP, clip, stream
    "k1_fused_pipeline": [_P] * 8 + [_I] * 10 + [_P],
    # x, y, taps, N, H, W, C, ntaps, stream
    "k3_separable_blur": [_P] * 3 + [_I] * 5 + [_P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_SRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    so = _OUT / f"libimtpu_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _OUT.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.imtpu_error_string.argtypes = [ctypes.c_int]
    lib.imtpu_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        text = load().imtpu_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
