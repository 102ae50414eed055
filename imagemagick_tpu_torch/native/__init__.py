"""Native JPEG codec (ctypes over ``miniio.cpp``).

Port of ``imagemagick_tpu/native/__init__.py``, the JPEG part that the
thumbnailer needs: ``available``, ``decode_jpeg``, ``decode_jpeg_scaled``
and ``encode_jpeg``.  ``miniio.cpp`` is the JAX package's source, copied.

On first use the library is compiled with ``g++ -O3 -fPIC -shared``
against the system libjpeg and libpng into ``imagemagick_tpu_torch/_build/``,
under a name that holds a hash of the source and the command, and loaded
with ``ctypes``.  The compiler writes a file of its own, which is then
renamed into place, so processes that build at once each load a whole
library.  Without ``g++``, libjpeg or libpng the build fails, ``available()``
is False and every call returns None: callers (``models/thumbnailer.py``)
then decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "miniio.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build"
_CMD = ("g++", "-O3", "-fPIC", "-shared")
_LIBS = ("-ljpeg", "-lpng")
ABI_VERSION = 2

_lib = None
_lock = threading.Lock()
_build_failed = False
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and command lives."""
    h = hashlib.sha256(" ".join(_CMD + _LIBS).encode() + _SRC.read_bytes())
    return _OUT / f"libminiio_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    global _build_error
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
    cmd = [*_CMD, str(_SRC), *_LIBS, "-o", str(tmp)]
    try:
        _OUT.mkdir(exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _build_error = f"{' '.join(cmd)}: {exc}"
        tmp.unlink(missing_ok=True)
        return False
    if res.returncode != 0:
        _build_error = res.stderr.strip() or f"exit code {res.returncode}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib, _build_failed, _build_error
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            _build_error = str(exc)
            _build_failed = True
            return None
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_ip = ctypes.POINTER(ctypes.c_int)
        lib.miniio_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(c_u8p),
            c_ip, c_ip, c_ip]
        lib.miniio_decode_jpeg.restype = ctypes.c_int
        lib.miniio_decode_jpeg_scaled.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(c_u8p), c_ip, c_ip, c_ip]
        lib.miniio_decode_jpeg_scaled.restype = ctypes.c_int
        lib.miniio_encode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(c_u8p),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.miniio_encode_jpeg.restype = ctypes.c_int
        lib.miniio_free.argtypes = [ctypes.c_void_p]
        lib.miniio_free.restype = None
        lib.miniio_abi_version.argtypes = []
        lib.miniio_abi_version.restype = ctypes.c_int
        if lib.miniio_abi_version() != ABI_VERSION:
            _build_error = f"{so.name}: ABI version " \
                f"{lib.miniio_abi_version()}, not {ABI_VERSION}"
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """What the compiler said when the library failed to build, else None."""
    return _build_error


def _take(lib, out, w, h, c) -> np.ndarray:
    """Copy a decoded (h, w, c) buffer out of the library and free it."""
    n = w.value * h.value * c.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.miniio_free(out)
    return arr.reshape(h.value, w.value, c.value)


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG bytes -> (H, W, 3) uint8, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.miniio_decode_jpeg(data, len(data), ctypes.byref(out),
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c))
    if rc != 0:
        return None
    return _take(lib, out, w, h, c)


def decode_jpeg_scaled(data: bytes, min_w: int, min_h: int
                       ) -> Optional[np.ndarray]:
    """DCT-scaled JPEG decode (``-define jpeg:size`` semantics,
    coders/jpeg.c): decode at the largest 1/{1,2,4,8} scale whose output
    still covers (min_w, min_h).  -> (H, W, 3) uint8, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.miniio_decode_jpeg_scaled(data, len(data), min_w, min_h,
                                       ctypes.byref(out), ctypes.byref(w),
                                       ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        return None
    return _take(lib, out, w, h, c)


def encode_jpeg(arr: np.ndarray, quality: int = 92) -> Optional[bytes]:
    """Encode (H, W, 1|3) uint8 -> JPEG bytes, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.miniio_encode_jpeg(arr.ctypes.data_as(ctypes.c_char_p),
                                w, h, c, quality,
                                ctypes.byref(out), ctypes.byref(size))
    if rc != 0:
        return None
    data = ctypes.string_at(out, size.value)
    lib.miniio_free(out)
    return data
