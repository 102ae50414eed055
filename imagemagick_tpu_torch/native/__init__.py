"""Native host libraries (ctypes over the C++ sources of this folder).

Port of ``imagemagick_tpu/native/__init__.py``.  Each library is its own
``_Library``, so that a missing system library takes down only its own
formats:

- the JPEG codec, ``miniio.cpp`` built with ``-DMINIIO_NO_PNG`` and
  linked with ``-ljpeg`` (``available``, ``decode_jpeg``,
  ``decode_jpeg_scaled``, ``encode_jpeg``);
- the PNG codec, the same source built with ``-DMINIIO_NO_JPEG`` and
  linked with ``-lpng`` (``png_available``, ``decode_png``,
  ``encode_png``);
- the HEIF and JPEG XL codecs, ``heifjxl.cpp`` linked with ``-ldl``
  only: it opens ``libheif.so.1`` and ``libjxl.so.0.7`` with ``dlopen``
  at run time (``heif_available``, ``jxl_available``, ``decode_heif``,
  ``decode_jxl``, ``encode_heif``, ``encode_jxl``);
- the JBIG codec, ``jbigio.cpp`` linked with ``-ljbig``
  (``jbig_available``, ``jbig_decode``, ``jbig_encode``);
- the octree quantizer with its error-diffusion dithers,
  ``riemersma.cpp``, which needs only the C++ standard library
  (``riemersma_available``, ``riemersma_posterize``,
  ``floyd_steinberg_posterize``, ``octree_quantize``, ``octree_remap``).

The sources are the JAX package's, copied (``miniio.cpp`` with the two
guards that split it).  One helper, ``_Library``, builds each on first use
with ``g++`` into ``imagemagick_tpu_torch/_build/``, under a name that
holds a hash of the source and the command, and loads it with ``ctypes``.
The compiler writes a file of its own, which is then renamed into place,
so processes that build at once each load a whole library.

The codecs are built with the JAX package's flags.  Where ``g++`` or a
codec's system library is missing, its build fails, its ``*available()``
is False and every call of it returns None, as in the JAX package: the
callers (``io/codecs.py``, ``io/coders_r4b.py``, ``models/thumbnailer.py``)
then take PIL or report the format as unavailable.  The quantizer is
built with the JAX package's ``g++ -O2 -fPIC -shared`` (no
``-march=native``, no ``-ffast-math``), so the same float32 input gives
the same bits in both packages.  Its build must succeed: if it fails,
every quantizer call raises RuntimeError with the compiler's message.
Everything here runs on the host, on numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_OUT = _HERE.parent / "_build"
ABI_VERSION = 2


class _Library:
    """One C++ source, built on first use into ``_OUT`` under a hashed
    name and loaded once a process.  ``bind`` declares the C entries'
    types on the loaded library and returns an error text, or None."""

    def __init__(self, name: str, source: str, cmd: Tuple[str, ...],
                 libs: Tuple[str, ...], bind: Callable):
        self.name, self.src = name, _HERE / source
        self.cmd, self.libs, self.bind = cmd, libs, bind
        self.lock = threading.Lock()
        self.lib = None
        self.failed = False
        self.error: Optional[str] = None

    def path(self) -> Path:
        """Where the library for this source and command lives."""
        h = hashlib.sha256(" ".join(self.cmd + self.libs).encode() +
                           self.src.read_bytes())
        return _OUT / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def _build(self, so: Path) -> bool:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
        cmd = [*self.cmd, str(self.src), *self.libs, "-o", str(tmp)]
        try:
            _OUT.mkdir(exist_ok=True)
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired) as exc:
            self.error = f"{' '.join(cmd)}: {exc}"
            tmp.unlink(missing_ok=True)
            return False
        if res.returncode != 0:
            self.error = res.stderr.strip() or f"exit code {res.returncode}"
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, so)
        return True

    def load(self):
        """The loaded library, or None when it failed to build or load
        (``error`` says why).  Threads that call at once build once."""
        with self.lock:
            if self.lib is not None or self.failed:
                return self.lib
            so = self.path()
            if not so.exists() and not self._build(so):
                self.failed = True
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as exc:
                self.error = str(exc)
                self.failed = True
                return None
            err = self.bind(lib)
            if err is not None:
                self.error = f"{so.name}: {err}"
                self.failed = True
                return None
            self.lib = lib
            return lib


# ---------------------------------------------------------------------------
# The JPEG codec (miniio.cpp without its PNG half)
# ---------------------------------------------------------------------------

def _bind_miniio(lib) -> Optional[str]:
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
        return f"ABI version {lib.miniio_abi_version()}, not {ABI_VERSION}"
    return None


_MINIIO = _Library("miniio", "miniio.cpp",
                   ("g++", "-O3", "-fPIC", "-shared", "-DMINIIO_NO_PNG"),
                   ("-ljpeg",), _bind_miniio)


def library_path() -> Path:
    """Where the JPEG codec's library for this source and command lives."""
    return _MINIIO.path()


def _load():
    return _MINIIO.load()


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """What the compiler said when the JPEG codec failed to build, else
    None."""
    return _MINIIO.error


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


# ---------------------------------------------------------------------------
# The PNG codec (miniio.cpp without its JPEG half)
# ---------------------------------------------------------------------------

def _bind_miniio_png(lib) -> Optional[str]:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_ip = ctypes.POINTER(ctypes.c_int)
    lib.miniio_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(c_u8p),
        c_ip, c_ip, c_ip, c_ip]
    lib.miniio_decode_png.restype = ctypes.c_int
    lib.miniio_encode_png.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(c_u8p),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.miniio_encode_png.restype = ctypes.c_int
    lib.miniio_free.argtypes = [ctypes.c_void_p]
    lib.miniio_free.restype = None
    lib.miniio_abi_version.argtypes = []
    lib.miniio_abi_version.restype = ctypes.c_int
    if lib.miniio_abi_version() != ABI_VERSION:
        return f"ABI version {lib.miniio_abi_version()}, not {ABI_VERSION}"
    return None


_MINIIO_PNG = _Library("miniio_png", "miniio.cpp",
                       ("g++", "-O3", "-fPIC", "-shared", "-DMINIIO_NO_JPEG"),
                       ("-lpng",), _bind_miniio_png)


def png_available() -> bool:
    return _MINIIO_PNG.load() is not None


def decode_png(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode PNG bytes -> ((H, W, C) uint8 or big-endian uint16 array,
    bit depth), or None on failure."""
    lib = _MINIIO_PNG.load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    depth = ctypes.c_int()
    rc = lib.miniio_decode_png(data, len(data), ctypes.byref(out),
                               ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(c), ctypes.byref(depth))
    if rc != 0:
        return None
    nbytes = w.value * h.value * c.value * (depth.value // 8)
    raw = np.ctypeslib.as_array(out, shape=(nbytes,)).copy()
    lib.miniio_free(out)
    if depth.value == 16:
        arr = raw.view(">u2").reshape(h.value, w.value, c.value)
    else:
        arr = raw.reshape(h.value, w.value, c.value)
    return arr, depth.value


def encode_png(arr: np.ndarray, bit_depth: int = 8) -> Optional[bytes]:
    """Encode (H, W, C) uint8 (or uint16 at ``bit_depth`` 16) -> PNG
    bytes, or None on failure."""
    lib = _MINIIO_PNG.load()
    if lib is None:
        return None
    if bit_depth == 16:
        arr = np.ascontiguousarray(arr.astype(">u2"))
        raw = arr.view(np.uint8)
    else:
        arr = np.ascontiguousarray(arr, np.uint8)
        raw = arr
    h, w, c = arr.shape[:3]
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.miniio_encode_png(raw.ctypes.data_as(ctypes.c_char_p),
                               w, h, c, bit_depth,
                               ctypes.byref(out), ctypes.byref(size))
    if rc != 0:
        return None
    data = ctypes.string_at(out, size.value)
    lib.miniio_free(out)
    return data


# ---------------------------------------------------------------------------
# The HEIF and JPEG XL codecs (heifjxl.cpp: dlopen over the system libheif
# and libjxl, the libraries coders/heic.c and coders/jxl.c use)
# ---------------------------------------------------------------------------

def _bind_heifjxl(lib) -> Optional[str]:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_ip = ctypes.POINTER(ctypes.c_int)
    for name in ("hj_decode_heif", "hj_decode_jxl"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                       ctypes.POINTER(c_u8p), c_ip, c_ip, c_ip]
        fn.restype = ctypes.c_int
    lib.hj_encode_heif.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.hj_encode_heif.restype = ctypes.c_int
    lib.hj_encode_jxl.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.hj_encode_jxl.restype = ctypes.c_int
    lib.hj_free.argtypes = [ctypes.c_void_p]
    lib.hj_free.restype = None
    for name in ("hj_heif_available", "hj_jxl_available", "hj_abi_version"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.hj_abi_version() != 1:
        return f"ABI version {lib.hj_abi_version()}, not 1"
    return None


_HEIFJXL = _Library("heifjxl", "heifjxl.cpp",
                    ("g++", "-O3", "-fPIC", "-shared"), ("-ldl",),
                    _bind_heifjxl)


def heif_available() -> bool:
    """True where the library builds and ``libheif.so.1`` opens."""
    lib = _HEIFJXL.load()
    return bool(lib and lib.hj_heif_available())


def jxl_available() -> bool:
    """True where the library builds and libjxl 0.7 opens."""
    lib = _HEIFJXL.load()
    return bool(lib and lib.hj_jxl_available())


def _hj_decode(fn_name: str, data: bytes) -> Optional[np.ndarray]:
    lib = _HEIFJXL.load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(data, len(data), ctypes.byref(out),
                               ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(c))
    if rc != 0:
        return None
    n = w.value * h.value * c.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.hj_free(out)
    return arr.reshape(h.value, w.value, c.value)


def decode_heif(data: bytes) -> Optional[np.ndarray]:
    """HEIC/HEIF decode -> (H, W, 3|4) uint8, or None."""
    return _hj_decode("hj_decode_heif", data)


def decode_jxl(data: bytes) -> Optional[np.ndarray]:
    """JPEG XL decode -> (H, W, C) uint8, or None."""
    return _hj_decode("hj_decode_jxl", data)


def _hj_blob(lib, out, size) -> bytes:
    data = ctypes.string_at(out, size.value)
    lib.hj_free(out)
    return data


def encode_heif(arr: np.ndarray, quality: int = 75) -> Optional[bytes]:
    """HEIC encode; None where no HEVC encoder plugin is installed."""
    lib = _HEIFJXL.load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.hj_encode_heif(arr.ctypes.data_as(ctypes.c_char_p), w, h, c,
                            quality, ctypes.byref(out), ctypes.byref(size))
    return None if rc != 0 else _hj_blob(lib, out, size)


def encode_jxl(arr: np.ndarray) -> Optional[bytes]:
    """JPEG XL encode (libjxl's default effort and distance), or None."""
    lib = _HEIFJXL.load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.hj_encode_jxl(arr.ctypes.data_as(ctypes.c_char_p), w, h, c,
                           ctypes.byref(out), ctypes.byref(size))
    return None if rc != 0 else _hj_blob(lib, out, size)


# ---------------------------------------------------------------------------
# The JBIG codec (jbigio.cpp over jbig-kit, the library coders/jbig.c uses)
# ---------------------------------------------------------------------------

def _bind_jbig(lib) -> Optional[str]:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jb_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.POINTER(c_u8p),
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.jb_decode.restype = ctypes.c_int
    lib.jb_encode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(c_u8p),
                              ctypes.POINTER(ctypes.c_size_t)]
    lib.jb_encode.restype = ctypes.c_int
    lib.jb_free.argtypes = [c_u8p]
    lib.jb_free.restype = None
    return None


_JBIG = _Library("jbigio", "jbigio.cpp", ("g++", "-O2", "-fPIC", "-shared"),
                 ("-ljbig",), _bind_jbig)


def jbig_available() -> bool:
    return _JBIG.load() is not None


def jbig_decode(data: bytes) -> Optional[np.ndarray]:
    """JBIG blob -> (H, W) uint8 {0, 1} bitmap (1 = black), or None."""
    lib = _JBIG.load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.jb_decode(data, len(data), ctypes.byref(out), ctypes.byref(w),
                       ctypes.byref(h))
    if rc != 0:
        return None
    stride = (w.value + 7) // 8
    buf = np.ctypeslib.as_array(out, shape=(h.value * stride,)).copy()
    lib.jb_free(out)
    bits = np.unpackbits(buf.reshape(h.value, stride), axis=1)
    return bits[:, :w.value]


def jbig_encode(bitmap: np.ndarray) -> Optional[bytes]:
    """(H, W) {0, 1} bitmap (1 = black) -> JBIG blob, or None."""
    lib = _JBIG.load()
    if lib is None:
        return None
    bm = np.asarray(bitmap, np.uint8)
    h, w = bm.shape
    packed = np.packbits(bm, axis=1).tobytes()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    rc = lib.jb_encode(packed, w, h, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        return None
    blob = ctypes.string_at(out, n.value)
    lib.jb_free(out)
    return blob


# ---------------------------------------------------------------------------
# The octree quantizer and its dithers (riemersma.cpp): host-sequential
# classify / reduce / assign and error diffusion along a Hilbert curve or
# a serpentine scan
# ---------------------------------------------------------------------------

def _bind_riemersma(lib) -> Optional[str]:
    f32p, clong = ctypes.POINTER(ctypes.c_float), ctypes.c_long
    for fn in ("rz_riemersma_posterize", "rz_floyd_steinberg_posterize"):
        f = getattr(lib, fn)
        f.argtypes = [f32p, clong, clong, clong, ctypes.c_int,
                      ctypes.c_double]
        f.restype = ctypes.c_int
    lib.rz_quantize.argtypes = [
        f32p, clong, clong, clong, clong, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, f32p, ctypes.POINTER(clong)]
    lib.rz_quantize.restype = ctypes.c_int
    lib.rz_remap.argtypes = [f32p, clong, clong, clong, f32p, clong, clong,
                             ctypes.c_int, ctypes.c_double]
    lib.rz_remap.restype = ctypes.c_int
    return None


_RIEMERSMA = _Library("riemersma", "riemersma.cpp",
                      ("g++", "-O2", "-fPIC", "-shared"), (), _bind_riemersma)
_DITHERS = {"none": 0, "": 0, "riemersma": 1, "floydsteinberg": 2, "fs": 2}


def _rz_load():
    """The quantizer library; raises RuntimeError with the compiler's
    message when it does not build."""
    lib = _RIEMERSMA.load()
    if lib is None:
        raise RuntimeError(f"native/riemersma.cpp did not build or load: "
                           f"{_RIEMERSMA.error}")
    return lib


def riemersma_available() -> bool:
    """True once the quantizer library is built and loaded; it raises
    RuntimeError with the compiler's message when it does not build."""
    return _rz_load() is not None


def _frame(arr: np.ndarray) -> Tuple[np.ndarray, int, int, int]:
    """A float32 copy of an (H, W) or (H, W, C) frame and its extents."""
    out = np.ascontiguousarray(arr, dtype=np.float32).copy()
    if out.ndim not in (2, 3):
        raise ValueError(f"native quantizer: one (H, W[, C]) frame, not "
                         f"{out.shape}")
    c = 1 if out.ndim == 2 else out.shape[2]
    return out, out.shape[0], out.shape[1], c


def _check(rc: int, fname: str) -> None:
    if rc != 0:
        raise ValueError(f"native {fname}: arguments refused (levels < 2, "
                         f"colors < 1, or not 1-4 channels)")


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dither_posterize(arr, levels, diffusion, fname) -> np.ndarray:
    lib = _rz_load()
    out, h, w, c = _frame(arr)
    _check(getattr(lib, fname)(_f32p(out), h, w, c, int(levels),
                               float(diffusion)), fname)
    return out


def riemersma_posterize(arr: np.ndarray, levels: int,
                        diffusion: float = 1.0) -> np.ndarray:
    """Dither ``arr`` ((H, W[, C]) float32 in [0, 1], C <= 4) to a
    ``levels``-per-channel lattice along a Hilbert curve."""
    return _dither_posterize(arr, levels, diffusion,
                             "rz_riemersma_posterize")


def floyd_steinberg_posterize(arr: np.ndarray, levels: int,
                              diffusion: float = 1.0) -> np.ndarray:
    """Serpentine Floyd-Steinberg posterize via the same octree/cache
    color assignment as the Riemersma path."""
    return _dither_posterize(arr, levels, diffusion,
                             "rz_floyd_steinberg_posterize")


def octree_quantize(arr: np.ndarray, max_colors: int, dither: str = "riemersma",
                    tree_depth: int = 0, diffusion: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-semantics octree quantization (quantize.c QuantizeImage):
    classify / reduce / colormap / assign, with optional Riemersma or
    Floyd-Steinberg dithering.  Returns (out_image, palette), the palette
    as (n, 4) float32 RGBA."""
    lib = _rz_load()
    meth = _DITHERS.get(str(dither).lower(), 1)
    out, h, w, c = _frame(arr)
    pal = np.zeros((max(int(max_colors), 256), 4), np.float32)
    n = ctypes.c_long(0)
    _check(lib.rz_quantize(_f32p(out), h, w, c, int(max_colors), meth,
                           int(tree_depth), float(diffusion), _f32p(pal),
                           ctypes.byref(n)), "rz_quantize")
    return out, pal[:n.value]


def octree_remap(arr: np.ndarray, palette: np.ndarray,
                 dither: str = "riemersma", diffusion: float = 1.0
                 ) -> np.ndarray:
    """RemapImage with reference octree/cache semantics.  ``palette`` is
    (N, C) float32 in [0, 1].  Returns the remapped image."""
    lib = _rz_load()
    meth = _DITHERS.get(str(dither).lower(), 1)
    out, h, w, c = _frame(arr)
    pal = np.ascontiguousarray(palette, dtype=np.float32)
    pc = 1 if pal.ndim == 1 else pal.shape[1]
    _check(lib.rz_remap(_f32p(out), h, w, c, _f32p(pal), pal.shape[0], pc,
                        meth, float(diffusion)), "rz_remap")
    return out
