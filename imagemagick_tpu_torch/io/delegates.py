"""External delegates (delegate.c, config/delegates.xml.in).

Port of ``imagemagick_tpu/io/delegates.py``: the formats that no coder
of the package decodes go through external programs, run with
``subprocess`` on temporary files: ghostscript for PS, EPS and PDF,
ffmpeg for video, Graphviz's ``dot``, ``gpcl6`` for PCL, ``gxps`` for
XPS, LibreOffice for office documents and dcraw or darktable for camera
raws.  Each call is gated by the policy's "delegate" domain, as in the
JAX package, and refused by ``core.policy.enforce_program`` inside
``no_host_files`` (the serve daemon's requests).  Where its program is
missing, each raises DelegateError with the JAX module's text.  The
programs' pages come back as PNG and decode through ``image_from_blob``
onto ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

from ..core.policy import enforce_program, policy


class DelegateError(Exception):
    pass


def _which(*names: str) -> Optional[str]:
    for n in names:
        p = shutil.which(n)
        if p:
            return p
    return None


def has_ghostscript() -> bool:
    return _which("gs", "gsc") is not None


def has_ffmpeg() -> bool:
    return _which("ffmpeg") is not None


def decode_postscript(data: bytes, fmt: str, density: int = 96,
                      device="cuda") -> List:
    """PS/EPS/PDF via ghostscript -> PNG frames (delegates.xml.in gs rules)."""
    policy.enforce("delegate", "gs", "execute")
    enforce_program("gs")
    gs = _which("gs", "gsc")
    if gs is None:
        raise DelegateError(
            f"no decode delegate for {fmt!r} (ghostscript not installed)")
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, f"in.{fmt}")
        with open(src, "wb") as f:
            f.write(data)
        out_pat = os.path.join(td, "page%03d.png")
        cmd = [gs, "-q", "-dQUIET", "-dSAFER", "-dBATCH", "-dNOPAUSE",
               "-sDEVICE=png16m", f"-r{density}",
               f"-sOutputFile={out_pat}", src]
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            raise DelegateError(f"ghostscript failed: {r.stderr[:200]!r}")
        from . import image_from_blob

        images = []
        for name in sorted(os.listdir(td)):
            if name.startswith("page"):
                with open(os.path.join(td, name), "rb") as f:
                    images.extend(image_from_blob(f.read(), "png", device))
        if not images:
            raise DelegateError("ghostscript produced no pages")
        return images


def decode_video_frames(path: str, max_frames: int = 16, fps: float = 1.0,
                        device="cuda") -> List:
    """Video via ffmpeg -> PNG frames (delegates.xml.in ffmpeg rules)."""
    policy.enforce("delegate", "ffmpeg", "execute")
    enforce_program("ffmpeg")
    ff = _which("ffmpeg")
    if ff is None:
        raise DelegateError("no video delegate (ffmpeg not installed)")
    with tempfile.TemporaryDirectory() as td:
        out_pat = os.path.join(td, "f%04d.png")
        cmd = [ff, "-i", path, "-vf", f"fps={fps}", "-frames:v",
               str(max_frames), out_pat, "-y", "-loglevel", "error"]
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            raise DelegateError(f"ffmpeg failed: {r.stderr[:200]!r}")
        from . import image_from_blob

        images = []
        for name in sorted(os.listdir(td)):
            with open(os.path.join(td, name), "rb") as f:
                images.extend(image_from_blob(f.read(), "png", device))
        return images


def has_graphviz() -> bool:
    return _which("dot") is not None


def has_pcl() -> bool:
    return _which("gpcl6", "pcl6") is not None


def has_xps() -> bool:
    return _which("gxps") is not None


def has_office() -> bool:
    return _which("libreoffice", "soffice") is not None


def has_dcraw() -> bool:
    return _which("dcraw_emu", "dcraw", "darktable-cli") is not None


def decode_dot(data: bytes, device="cuda") -> List:
    """Graphviz dot/gv via the dot binary (delegates.xml.in:75 region
    'dot' rule: dot -Tsvg -> svg pipeline; we render to PNG directly)."""
    policy.enforce("delegate", "dot", "execute")
    enforce_program("dot")
    dot = _which("dot")
    if dot is None:
        raise DelegateError("no dot delegate (graphviz not installed)")
    r = subprocess.run([dot, "-Tpng"], input=data, capture_output=True,
                       timeout=120)
    if r.returncode != 0:
        raise DelegateError(f"dot failed: {r.stderr[:200]!r}")
    from . import image_from_blob

    return image_from_blob(r.stdout, "png", device)


def _gs_like(data: bytes, fmt: str, prog_names, density: int = 96,
             device="cuda") -> List:
    """The page rasterizer shared by the ghostscript-family binaries
    (gpcl6 for PCL, gxps for XPS — delegates.xml.in pcl:/xps: rules)."""
    policy.enforce("delegate", prog_names[0], "execute")
    enforce_program(prog_names[0])
    prog = _which(*prog_names)
    if prog is None:
        raise DelegateError(
            f"no decode delegate for {fmt!r} ({prog_names[0]} not installed)")
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, f"in.{fmt}")
        with open(src, "wb") as f:
            f.write(data)
        out_pat = os.path.join(td, "page%03d.png")
        cmd = [prog, "-dQUIET", "-dBATCH", "-dNOPAUSE", "-sDEVICE=png16m",
               f"-r{density}", f"-sOutputFile={out_pat}", src]
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            raise DelegateError(f"{prog_names[0]} failed: "
                                f"{r.stderr[:200]!r}")
        from . import image_from_blob

        images = []
        for name in sorted(os.listdir(td)):
            if name.startswith("page"):
                with open(os.path.join(td, name), "rb") as f:
                    images.extend(image_from_blob(f.read(), "png", device))
        if not images:
            raise DelegateError(f"{prog_names[0]} produced no pages")
        return images


def decode_pcl(data: bytes, density: int = 96, device="cuda") -> List:
    return _gs_like(data, "pcl", ("gpcl6", "pcl6"), density, device)


def decode_xps(data: bytes, density: int = 96, device="cuda") -> List:
    return _gs_like(data, "xps", ("gxps",), density, device)


def decode_office(data: bytes, fmt: str, device="cuda") -> List:
    """doc/docx/odt/... via libreoffice -> PDF -> ghostscript
    (delegates.xml.in:68-70)."""
    policy.enforce("delegate", "libreoffice", "execute")
    enforce_program("libreoffice")
    lo = _which("libreoffice", "soffice")
    if lo is None:
        raise DelegateError(
            f"no decode delegate for {fmt!r} (libreoffice not installed)")
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, f"in.{fmt}")
        with open(src, "wb") as f:
            f.write(data)
        cmd = [lo, "--headless", "--convert-to", "pdf", "--outdir", td, src]
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        pdf = os.path.join(td, "in.pdf")
        if r.returncode != 0 or not os.path.exists(pdf):
            raise DelegateError(f"libreoffice failed: {r.stderr[:200]!r}")
        with open(pdf, "rb") as f:
            return decode_postscript(f.read(), "pdf", device=device)


def decode_dcraw(data: bytes, fmt: str, device="cuda") -> List:
    """Camera-raw fallback via dcraw, then darktable-cli
    (delegates.xml.in:70 dng:decode rule chain: dcraw first, darktable
    as the alternate) — used when the native DNG demosaic path declines."""
    policy.enforce("delegate", "dcraw", "execute")
    enforce_program("dcraw")
    prog = _which("dcraw_emu", "dcraw")
    dt = _which("darktable-cli")
    if prog is None and dt is None:
        raise DelegateError(
            f"no raw delegate for {fmt!r} (dcraw/darktable not installed)")
    from . import image_from_blob

    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, f"in.{fmt}")
        with open(src, "wb") as f:
            f.write(data)
        if prog is not None:
            r = subprocess.run([prog, "-w", "-T", src], capture_output=True,
                               timeout=300, cwd=td)
            if r.returncode == 0:
                for name in os.listdir(td):
                    if name.endswith((".tiff", ".tif")) and name != \
                            os.path.basename(src):
                        with open(os.path.join(td, name), "rb") as f:
                            return image_from_blob(f.read(), "tiff", device)
        if dt is not None:
            out = os.path.join(td, "out.png")
            r = subprocess.run([dt, src, out, "--core", "--conf",
                                "plugins/lighttable/export/iccintent=0"],
                               capture_output=True, timeout=300, cwd=td)
            if r.returncode == 0 and os.path.exists(out):
                with open(out, "rb") as f:
                    return image_from_blob(f.read(), "png", device)
        raise DelegateError(f"raw delegates failed for {fmt!r}")


def list_delegates() -> dict:
    """Delegate availability report (identify -list delegate analog)."""
    return {
        "gs (ps/eps/pdf)": has_ghostscript(),
        "ffmpeg (video read/write)": has_ffmpeg(),
        "dot (graphviz dot/gv)": has_graphviz(),
        "gpcl6 (pcl)": has_pcl(),
        "gxps (xps)": has_xps(),
        "libreoffice (doc/docx/odt)": has_office(),
        "dcraw (camera raw fallback)": has_dcraw(),
    }
