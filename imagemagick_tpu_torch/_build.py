"""Build and load the package's CUDA kernels.

On first use, ``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, links
the objects into one shared library with a plain C interface, stores it
under ``_build/`` keyed by a hash of the flags, the sources and the headers
they include (``csrc/*.cuh``), and loads it with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  Each C entry
launches on the stream it is given and returns ``cudaGetLastError()``;
``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    # r0, x, wv, gb, kr, hwin, vwin, c0s, guids, out, nprog, ntiles,
    # nterms, nb, TO, BAND, SPAN, WINC, OUTP, clip, stream
    "k1_fused_pipeline": [_P] * 10 + [_I] * 10 + [_P],
    # x, y, taps (host), N, H, W, C, nblur, nunsharp, gain, lab, stream
    "k2_blur_unsharp": [_P] * 3 + [_I] * 6 + [_F, _I, _P],
    # x, y, taps (host), N, H, W, nblur, nunsharp, gain, stream
    "k2p_blur_unsharp_pipe": [_P] * 3 + [_I] * 5 + [_F, _P],
    # x, y, taps (host), N, H, W, C, ntaps, stream
    "k3_separable_blur": [_P] * 3 + [_I] * 5 + [_P],
    # x, counts, scratch, scratch_rows, nrows, rowlen, stream
    "k4_histogram256": [_P] * 3 + [_I] * 3 + [_P],
    # x, thr, y, N, H, W, stream
    "k5_morph_edge": [_P] * 3 + [_I] * 3 + [_P],
    # x, spec, roots, twiddles, radices (host), P, H, W, passes, stream
    "k6a_w_forward": [_P] * 5 + [_I] * 4 + [_P],
    # spec, pmean, out, forward roots and twiddles, inverse roots and
    # twiddles, radices (host), P, H, W, passes, noise, stream
    "k6b_h_mask": [_P] * 8 + [_I] * 4 + [_F, _P],
    # g, out, roots, twiddles, radices (host), P, H, W, passes, stream
    "k6c_w_inverse": [_P] * 5 + [_I] * 4 + [_P],
    # x, pal, out, scratch, N, H, W, C, K, rows_in_shared, stream
    "pw_floyd_steinberg": [_P] * 4 + [_I] * 6 + [_P],
    # x, order, pal, out, N, HW, C, K, decay, stream
    "pw_riemersma": [_P] * 4 + [_I] * 4 + [_F, _P],
    # pal, steps, cycles, stream (the walks' step latency, for their bound)
    "pw_step_cycles": [_P, _I, _P, _P],
}

_lib = None
_lock = threading.Lock()   # one build per process: threads share its files


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _compile(sources, so: Path) -> None:
    """One nvcc per source, all started together, then one link into
    ``so``; every step's output (ptxas's register and shared-memory
    report included) goes to ``so``'s ``.log``."""
    tag = f"{so.stem}.{os.getpid()}"
    objs = [_OUT / f"{tag}.{src.stem}.o" for src in sources]
    logs = [obj.with_suffix(".log") for obj in objs]
    procs = []
    for src, obj, log in zip(sources, objs, logs):
        cmd = [_nvcc(), *FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as out:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT)))
    failed = [(cmd, log) for (cmd, proc), log in zip(procs, logs)
              if proc.wait() != 0]
    text = "".join(log.read_text() for log in logs)
    tmp = so.with_name(f"{tag}.so.tmp")
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        text += res.stdout + res.stderr
        if res.returncode != 0:
            failed = [(link, None)]
    so.with_suffix(".log").write_text(text)
    for path in objs + logs:
        path.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(cmd) for cmd, _ in failed) + f"\n{text}")
    os.replace(tmp, so)


def digest(src_dir: Path = _SRC) -> str:
    """Hash of the flags and of every ``*.cu`` and ``*.cuh`` in ``src_dir``:
    a change to a source or to a header it includes names a new library."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use.  Threads that call it
    at once (a server's first requests) wait for one build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _OUT / f"libimtpu_kernels_{digest()}.so"
        if not so.exists():
            _OUT.mkdir(exist_ok=True)
            _compile(sorted(_SRC.glob("*.cu")), so)
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
