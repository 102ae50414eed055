"""Format registry + read/write entry points.

Port of the part of ``imagemagick_tpu/io/__init__.py`` that the ported
coders serve: ImageMagick's constitute layer (ReadImage, WriteImage) and
coder registry.  Filenames may carry an explicit ``fmt:`` prefix,
otherwise the extension and then the magic bytes decide.

Ported: the pseudo formats (``pseudo.py``, with ``kernel:`` and
``pango:``), ``mpr:``, ``null:``, ``mask:`` and ``clip:``, PNM
(``pnm.py``), MIFF (``miff.py``), MPC (``mpc.py``), OpenEXR
(``exr.py``), DNG (``dng.py``), farbfeld, XBM, XPM, sixel (written),
SVG (read; written as a wrapper around a PNG) and the raw sample
formats with ``-size`` (``extra_coders.py``), ORA and KERNEL
(``coders_r4.py``), the formats Pillow reads and writes (``codecs.py``;
JPEG and PNG through the port's native codecs, HEIF and JPEG XL through
its ``heifjxl`` library, where they build), ``info:``/``json:``/
``yaml:``/``txt:`` (``identify.py``), and the delegates
(``delegates.py``: PS, EPS and PDF through ghostscript, video through
ffmpeg, ``dot``/``gv``, PCL, XPS, office documents, and dcraw for a DNG
that the native reader declines), the film, medical, scientific, print
and fax formats of ``formats2.py`` (DPX, CIN, DICOM, XCF, FITS, WBMP,
AVS, MTV, FL32, VICAR, SUN, OTB, MONO with ``-size``, G3 and G4, and the
PSD and PDF writers), ``formats3.py`` (MAT, VIFF, RLA, Palm, PICT) and
``formats4.py`` (16-bit TIFF both ways, VIPS, CALS, XWD, UYVY, YUV, Bayer
and MAP with ``-size``, WPG, ``.cube`` LUTs, ``stegano:``, the PS, PS2
and PS3 writers through the EPS writer, and the rest of its small raster,
legacy and text formats), ``coders_r4b.py`` (``strimg:``, DEBUG, MATTE,
the META profiles with their text grammars, ``dmr:`` repositories, WMF
and JBIG, where libjbig builds), ``emf.py`` (EMF), Radiance HDR
(``_rgbe.py``, numpy in place of the JAX package's OpenCV) and
``url:``/``http:``/``https:``/``ftp:``/``file:`` reads (urllib, under
the policy's ``delegate`` rights).  ``stream.py`` streams row bands of
PNM, MIFF and raw files through ``models.outofcore``.  A decoded image is
made on the host (a DNG's demosaic, an SVG's, a PES's, an MVG's and a
WMF's or EMF's raster on ``device``) and goes to ``device`` once (the
card unless the caller asks for the CPU); an encoded one comes to the
host and is quantized there, with the JAX package's expressions (HRZ's
resize, YUV's colour conversion and MAP's and WPG's k-means run on the
image's device first).

A color TIFF of samples deeper than 8 bits that the native deep reader
declines (compressed, planar, or in strips that do not follow one
another) raises ValueError: Pillow would narrow its samples to 8 bits,
which is what the JAX package does with it.

Where the JAX ``write_image`` writes several images to one name, it
ignores a ``%d`` in the name for the formats it marks as adjoining and
writes only the first image of a PNM list; the port expands a ``%d``
name for every format, as ImageMagick's WriteImages does, and writes
every image of a PNM list, one after another.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.geometry import parse_geometry
from ..core.image import Image
from ..core.policy import enforce_path
from ..core.spec import ImageSpec
from . import (_rgbe, codecs, coders_r4, coders_r4b, delegates, dng, emf,
               exr, extra_coders, formats2, formats3, formats4, miff, mpc,
               pnm, pseudo)

__all__ = ["read_image", "read_images", "write_image", "image_from_blob",
           "image_to_blob", "detect_format", "supported_read_formats",
           "supported_write_formats"]

# magic-byte sniffing table (magic.c analog)
_MAGIC = [
    (b"\x89PNG\r\n\x1a\n", "png"),
    (b"\xff\xd8\xff", "jpeg"),
    (b"GIF87a", "gif"),
    (b"GIF89a", "gif"),
    (b"BM", "bmp"),
    (b"II*\x00", "tiff"),
    (b"MM\x00*", "tiff"),
    (b"RIFF", "webp"),
    (b"id=ImageMagick", "miff"),
    (b"P1", "pnm"), (b"P2", "pnm"), (b"P3", "pnm"), (b"P4", "pnm"),
    (b"P5", "pnm"), (b"P6", "pnm"), (b"P7", "pam"), (b"PF", "pfm"), (b"Pf", "pfm"),
    (b"qoif", "qoi"),
    (b"8BPS", "psd"),
    # ICO handled below with a count-field sanity check (the 4-byte
    # magic alone collides with e.g. 1-wide ART headers)
    (b"SDPX", "dpx"),
    (b"XPDS", "dpx"),
    (b"\x80\x2a\x5f\xd7", "cin"),
    (b"\xd7\x5f\x2a\x80", "cin"),
    (b"gimp xcf ", "xcf"),
    (b"SIMPLE", "fits"),
    (b"L32F", "fl32"),
    (b"LBLSIZE=", "vicar"),
    (b"\x59\xa6\x6a\x95", "sun"),
    (b"MATLAB 5.0 MAT-file", "mat"),
    (b"\xab\x01", "viff"),
    (b"\xb6\xa6\xf2\x08", "vips"),
    (b"\x08\xf2\xa6\xb6", "vips"),
    (b"PG ", "pgx"),
    (b"data:", "inline"),
    (b"# ImageMagick pixel enumeration", "txt"),
    (b"srcdocid:", "cals"),
    (b"\x52\xcc", "rle"),
    (b"\xc5\xd0\xd3\xc6", "ept"),
    (b"\xff\x57\x50\x43", "wpg"),
    (b"iiii", "ipl"),
    (b"mmmm", "ipl"),
    (b"TIM2", "tim2"),
    (b"#PES", "pes"),
    (b"\xd7\xcd\xc6\x9a", "wmf"),   # placeable metafile key (wmf.c)
    (b"AT&TFORM", "djvu"),
    (b"FLIF", "flif"),
]


_PSEUDO = {
    "xc": lambda arg, w, h, d: pseudo.xc(arg or "white", w or 1, h or 1, d),
    "canvas": lambda arg, w, h, d: pseudo.xc(arg or "white", w or 1, h or 1,
                                             d),
    "gradient": lambda arg, w, h, d: pseudo.gradient(
        arg or "white-black", w or 256, h or 256, device=d),
    "radial-gradient": lambda arg, w, h, d: pseudo.radial_gradient(
        arg or "white-black", w or 256, h or 256, d),
    "plasma": lambda arg, w, h, d: pseudo.plasma(arg or "", w or 256,
                                                 h or 256, device=d),
    "pattern": lambda arg, w, h, d: pseudo.pattern(
        arg or "checkerboard", w or 256, h or 256, d),
    "hald": lambda arg, w, h, d: pseudo.hald(int(arg) if arg else 8, d),
    "logo": lambda arg, w, h, d: pseudo.logo(d),
    "rose": lambda arg, w, h, d: pseudo.rose(d),
    "wizard": lambda arg, w, h, d: pseudo.wizard(d),
    "granite": lambda arg, w, h, d: pseudo.granite(d),
    "netscape": lambda arg, w, h, d: pseudo.netscape(d),
    "null": lambda arg, w, h, d: _null_image(w, h, d),
    "label": lambda arg, w, h, d: pseudo.label(arg or "", w, h,
                                               _CURRENT_SETTINGS, d),
    "caption": lambda arg, w, h, d: pseudo.caption(arg or "", w, h,
                                                   _CURRENT_SETTINGS, d),
    "tile": lambda arg, w, h, d: pseudo.tile_file(arg, w, h,
                                                  _CURRENT_SETTINGS, d),
    "histogram": lambda arg, w, h, d: pseudo.histogram_file(
        arg, w, h, _CURRENT_SETTINGS, d),
    "thumbnail": lambda arg, w, h, d: pseudo.thumbnail_file(
        arg, w, h, _CURRENT_SETTINGS, d),
    "stegano": lambda arg, w, h, d: pseudo.stegano_file(
        arg, w, h, _CURRENT_SETTINGS, d),
    "vid": lambda arg, w, h, d: pseudo.vid_file(arg, w, h,
                                                _CURRENT_SETTINGS, d),
    # coders/kernel.c's inverse, coders/pango.c
    "kernel": lambda arg, w, h, d: coders_r4.kernel_pseudo(arg or "unity",
                                                           d),
    "pango": lambda arg, w, h, d: coders_r4.pango_pseudo(
        arg or "", w, h, _CURRENT_SETTINGS, d),
    # strimg.c: the filename string as a 1-row image
    "strimg": lambda arg, w, h, d: coders_r4b.strimg_pseudo(arg or "", d),
}


def _null_image(w, h, device):
    img = pseudo.xc("transparent", w or 1, h or 1, device)
    img.properties["null-separator"] = "1"   # -layers composite marker
    return img


# settings context for pseudo-coders (pointsize/font/fill/background);
# set per read_images call — the image_info analog label.c reads from.
_CURRENT_SETTINGS: dict = {}

_NATIVE_EXT = {"miff": "miff", "mif": "miff",
               "ppm": "pnm", "pgm": "pnm", "pbm": "pnm", "pnm": "pnm",
               "pam": "pnm", "pfm": "pnm",
               "ff": "ff", "farbfeld": "ff", "xbm": "xbm", "xpm": "xpm",
               "svg": "svg", "sixel": "sixel", "six": "sixel",
               "gray": "raw", "rgb": "raw", "rgba": "raw", "bgr": "raw",
               "exr": "exr", "hdr": "hdr", "mpc": "mpc"}

# in-memory registry for mpr: (registry.c:457 SetImageRegistry analog)
_MPR_REGISTRY = {}

_PNM = ("pnm", "ppm", "pgm", "pbm", "pam", "pfm")
_RAW = ("gray", "rgb", "rgba", "bgr", "bgra", "cmyk", "ycbcr")

# The names of the JAX package's native coders (formats2.py, formats3.py
# and formats4.py), which its filename prefixes take.
_FORMATS2_READ = {"dpx", "cin", "dcm", "dicom", "xcf", "fits", "fts",
                  "wbmp", "avs", "mtv", "fl32", "vicar", "vic", "otb",
                  "fax", "g3", "g4", "mat", "viff", "xv", "rla", "palm",
                  "pict", "pct",
                  "aai", "hrz", "scr", "rgf", "txt", "inline", "pgx",
                  "vips", "mono", "uyvy", "cals", "cal", "art", "sct",
                  "xwd", "sfw", "pdb", "tim", "cube", "pwp", "mvg", "ttf",
                  "otf", "cut", "rle", "mac", "pix", "yuv", "bayer",
                  "ept", "wpg", "ipl", "ftxt", "map", "magick", "tim2",
                  "uhdr", "jnx", "raw", "pes"}
_FORMATS2_WRITE = {"dpx", "psd", "pdf", "fits", "fts", "wbmp", "avs", "mtv",
                   "fl32", "vicar", "vic", "sun", "otb", "mono", "bgra",
                   "cmyk", "ycbcr", "uyvy", "fax", "g3", "g4", "mat",
                   "viff", "xv", "rla", "palm", "pict", "pct",
                   "aai", "hrz", "rgf", "cip", "pgx", "vips", "inline",
                   "cals", "cal", "art", "xwd", "braille", "brf", "ubrl",
                   "ubrl6", "isobrl", "isobrl6", "uil", "html", "htm",
                   "pdb", "tim", "yuv", "bayer", "ps", "ps2", "ps3",
                   "ept", "ipl", "ftxt", "map", "ashlar", "magick",
                   "dcx", "cur", "raw", "wpg"}
_META_PROFILE = set(coders_r4b._META_PROFILE)
_VIDEO_FMTS = {"mp4", "mkv", "webm", "avi", "mov", "mpeg", "mpg", "wmv"}
_URL = ("url", "http", "https", "ftp", "file")


def _one(decode):
    return lambda data, device: [decode(data, device=device)]


# formats2.py's and formats3.py's decoders by name (a MAT file may hold
# several images)
_DECODE23 = {
    "dpx": _one(formats2.decode_dpx), "cin": _one(formats2.decode_cin),
    "dcm": _one(formats2.decode_dcm), "dicom": _one(formats2.decode_dcm),
    "xcf": _one(formats2.decode_xcf), "sun": _one(formats2.decode_sun),
    "fits": _one(formats2.decode_fits), "fts": _one(formats2.decode_fits),
    "wbmp": _one(formats2.decode_wbmp), "avs": _one(formats2.decode_avs),
    "mtv": _one(formats2.decode_mtv), "fl32": _one(formats2.decode_fl32),
    "vicar": _one(formats2.decode_vicar),
    "vic": _one(formats2.decode_vicar), "otb": _one(formats2.decode_otb),
    "fax": _one(formats2.decode_fax), "g3": _one(formats2.decode_fax),
    "g4": _one(formats2.decode_g4_image),
    "mat": lambda data, device: formats3.decode_mat(data, device),
    "viff": _one(formats3.decode_viff), "xv": _one(formats3.decode_viff),
    "vif": _one(formats3.decode_viff), "rla": _one(formats3.decode_rla),
    "palm": _one(formats3.decode_palm), "pict": _one(formats3.decode_pict),
    "pct": _one(formats3.decode_pict),
}
# their encoders of one image with no options
_ENCODE23 = {
    "otb": formats2.encode_otb, "mono": formats2.encode_mono,
    "fax": formats2.encode_fax, "g3": formats2.encode_fax,
    "g4": formats2.encode_g4_image, "fits": formats2.encode_fits,
    "fts": formats2.encode_fits, "wbmp": formats2.encode_wbmp,
    "avs": formats2.encode_avs, "mtv": formats2.encode_mtv,
    "fl32": formats2.encode_fl32, "vicar": formats2.encode_vicar,
    "vic": formats2.encode_vicar, "sun": formats2.encode_sun,
    "viff": formats3.encode_viff, "xv": formats3.encode_viff,
    "vif": formats3.encode_viff, "rla": formats3.encode_rla,
    "palm": formats3.encode_palm, "pict": formats3.encode_pict,
    "pct": formats3.encode_pict,
}
# the names that formats2.py and formats3.py read (``mono`` with -size,
# in read_images) and write (DPX, PSD, PDF and MAT with options, in
# image_to_blob)
_FORMATS23_READ = set(_DECODE23) | {"mono"}
_FORMATS23_WRITE = set(_ENCODE23) | {"dpx", "psd", "pdf", "mat"}


def _many(decode):
    return lambda data, device: decode(data, device=device)


# formats4.py's decoders by name, with the JAX dispatch's aliases (TXT,
# INLINE, SFW, TIM, PWP, EPT, IPL, MAGICK, TIM2 and JNX give several
# images)
_DECODE4 = {
    "aai": _one(formats4.decode_aai), "hrz": _one(formats4.decode_hrz),
    "scr": _one(formats4.decode_scr), "rgf": _one(formats4.decode_rgf),
    "txt": _one(formats4.decode_txt), "text": _one(formats4.decode_txt),
    "inline": _many(formats4.decode_inline),
    "pgx": _one(formats4.decode_pgx), "vips": _one(formats4.decode_vips),
    "v": _one(formats4.decode_vips), "cals": _one(formats4.decode_cals),
    "cal": _one(formats4.decode_cals), "art": _one(formats4.decode_art),
    "sct": _one(formats4.decode_sct), "xwd": _one(formats4.decode_xwd),
    "sfw": _many(formats4.decode_sfw), "pdb": _one(formats4.decode_pdb),
    "tim": _many(formats4.decode_tim), "cube": _one(formats4.decode_cube),
    "pwp": _many(formats4.decode_pwp), "mvg": _one(formats4.decode_mvg),
    "ttf": _one(formats4.decode_ttf), "otf": _one(formats4.decode_ttf),
    "ttc": _one(formats4.decode_ttf), "cut": _one(formats4.decode_cut),
    "rle": _one(formats4.decode_rle), "mac": _one(formats4.decode_mac),
    "pix": _one(formats4.decode_pix), "ept": _many(formats4.decode_ept),
    "ept2": _many(formats4.decode_ept), "ept3": _many(formats4.decode_ept),
    "wpg": _one(formats4.decode_wpg), "ipl": _many(formats4.decode_ipl),
    "ftxt": _one(formats4.decode_ftxt),
    "magick": _many(formats4.decode_magick),
    "h": _many(formats4.decode_magick), "tim2": _many(formats4.decode_tim2),
    "jnx": _many(formats4.decode_jnx), "pes": _one(formats4.decode_pes),
}
# its encoders of one image with no options
_ENCODE4 = {
    "aai": formats4.encode_aai, "hrz": formats4.encode_hrz,
    "rgf": formats4.encode_rgf, "cip": formats4.encode_cip,
    "inline": formats4.encode_inline, "cals": formats4.encode_cals,
    "cal": formats4.encode_cals, "art": formats4.encode_art,
    "xwd": formats4.encode_xwd, "uil": formats4.encode_uil,
    "html": formats4.encode_html, "htm": formats4.encode_html,
    "shtml": formats4.encode_html, "pdb": formats4.encode_pdb,
    "tim": formats4.encode_tim, "yuv": formats4.encode_yuv,
    "ept": formats4.encode_ept, "ept2": formats4.encode_ept,
    "ept3": formats4.encode_ept, "map": formats4.encode_map,
    "ftxt": formats4.encode_ftxt, "magick": formats4.encode_magick,
    "h": formats4.encode_magick, "cur": formats4.encode_cur,
    "wpg": formats4.encode_wpg,
}
_BRAILLE = ("braille", "brf", "ubrl", "ubrl6", "isobrl", "isobrl6")
# the -size reads of formats4 (in read_images) and the writers that take
# the depth or the whole list (in image_to_blob)
_SIZED4 = {"uyvy": formats4.decode_uyvy, "yuv": formats4.decode_yuv,
           "bayer": formats4.decode_bayer, "map": formats4.decode_map}
_FORMATS4_READ = set(_DECODE4) | set(_SIZED4)
_FORMATS4_WRITE = (set(_ENCODE4) | set(_BRAILLE)
                   | {"pgx", "vips", "v", "ipl", "bayer", "ashlar", "dcx",
                      "ps", "ps2", "ps3"})
_JBIG = ("jbig", "jbg", "bie")
_OFFICE = ("doc", "docx", "odt", "ppt", "pptx", "xls", "xlsx")


def detect_format(data: bytes) -> Optional[str]:
    for magic, fmt in _MAGIC:
        if data[: len(magic)] == magic:
            if fmt == "webp" and data[8:12] != b"WEBP":
                continue
            return fmt
    if data[:4] == b"\x01\x00\x00\x00" and data[40:44] == b" EMF":
        return "emf"   # EMR_HEADER iType + dSignature (emf.c IsEMF)
    if data[:4] == b"\x00\x00\x01\x00" and len(data) > 6:
        count = data[4] | (data[5] << 8)
        if 0 < count <= 0x40:
            return "ico"
    if data[4:12] in (b"ftypavif", b"ftypheic", b"ftypheix", b"ftypmif1",
                      b"ftypmsf1", b"ftypheim", b"ftyphevc"):
        return "avif" if b"avif" in data[4:12] else "heic"
    if data[:2] == b"\xff\x0a" or \
            data[:12] == b"\x00\x00\x00\x0cJXL \r\n\x87\n":
        return "jxl"
    if data[:4] == b"PK\x03\x04" and b"image/openraster" in data[:128]:
        return "ora"   # zip whose stored-first mimetype entry is ORA
    if data[:8] == b"farbfeld":
        return "ff"
    if data[:4] == b"\x76\x2f\x31\x01":
        return "exr"
    if data[:11] == b"#?RADIANCE\n" or data[:7] == b"#?RGBE\n":
        return "hdr"
    head = data[:512].lstrip()
    if head.startswith(b"/* XPM */"):
        return "xpm"
    if head.startswith(b"#define") and b"_bits[]" in data[:4096]:
        return "xbm"
    if head.startswith(b"<?xml") and b"<svg" in data[:4096] or head.startswith(b"<svg"):
        return "svg"
    if data[:4] == b"%PDF":
        return "pdf"
    if data[:2] == b"%!":
        return "ps"
    if data[128:132] == b"DICM":
        return "dcm"
    if data[:5] == b"SFW95":
        return "pwp"
    if data[:3] == b"SFW":
        return "sfw"
    if data[:4] in (b"\x00\x01\x00\x00", b"OTTO", b"true", b"ttcf") \
            and len(data) > 512:
        return "ttf"
    if data[60:68] == b"vIMGView":
        return "pdb"
    if data[80:82] == b"CT" and len(data) > 2048 and data[:4] != b"\x00\x00\x00\x00":
        # Scitex CT parameter block (sct.c IsSCT probes offset 80)
        try:
            int(float(data[1056:1068].split(b"\x00")[0] or b"x"))
            return "sct"
        except ValueError:
            pass
    if data[4:8] == b"\x00\x00\x00\x07" and len(data) >= 100:
        import struct as _s

        if _s.unpack(">I", data[:4])[0] >= 100:
            return "xwd"
    return None


_PREFIXES = (set(_PSEUDO) | set(_NATIVE_EXT)
             | set(codecs._PIL_FORMATS) | _FORMATS2_READ | _FORMATS2_WRITE
             | {"mpr", "info", "txt", "json", "dng", "mask", "clip", "ora",
                "debug", "matte", "dmr", "wmf", "emf"}
             | set(_URL) | _META_PROFILE | _VIDEO_FMTS)


def _split_filename(filename: str):
    """'fmt:rest' prefix split (SetImageInfo filename syntax)."""
    m = re.match(r"^([A-Za-z][A-Za-z0-9_+-]*):(.*)$", filename)
    if m and m.group(1).lower() in _PREFIXES:
        return m.group(1).lower(), m.group(2)
    return None, filename


def _fetch_url(url: str, timeout: float = 30.0) -> bytes:
    """Fetch a url:/http:/https:/ftp:/file: blob (the reference's curl
    delegate, delegates.xml.in:66-67), honoring the policy 'delegate'
    domain before touching the network (constitute.c:733 analog).
    Inside ``no_host_files`` every URL is refused before anything is
    opened (a ``file:`` URL names a host file)."""
    from urllib.error import URLError
    from urllib.request import urlopen

    from ..core.policy import enforce_program
    from ..core.policy import policy as _pol

    scheme = url.split(":", 1)[0].lower()
    if scheme == "file":
        enforce_path(url)
    enforce_program("url")
    _pol.enforce("delegate", scheme.upper(), "read")
    try:
        with urlopen(url, timeout=timeout) as r:
            return r.read()
    except URLError as exc:
        raise IOError(f"url fetch failed for {url!r}: {exc}") from exc


def read_images(filename: str, size: Optional[str] = None,
                settings: Optional[dict] = None,
                device="cuda") -> List[Image]:
    """The images a name reads, on ``device``: a pseudo format, ``mpr:``,
    ``dmr:``, ``mask:``/``clip:`` of a file, a URL, ``-`` for stdin, or a
    file (the raw sample formats need ``size``)."""
    fmt, rest = _split_filename(str(filename))
    if rest == "-":   # stdin (cli-pipe.tap semantics)
        return image_from_blob(sys.stdin.buffer.read(), fmt, device)
    w = h = None
    if size:
        g = parse_geometry(size)
        w = int(g.width) if g.width else None
        h = int(g.height) if g.height else None
    if fmt in _PSEUDO:
        global _CURRENT_SETTINGS
        prev = _CURRENT_SETTINGS
        _CURRENT_SETTINGS = settings or prev
        try:
            return [_PSEUDO[fmt](rest, w, h, device)]
        finally:
            _CURRENT_SETTINGS = prev
    if fmt == "mpr":
        enforce_path(filename)
        if rest not in _MPR_REGISTRY:
            raise FileNotFoundError(f"no mpr registry entry {rest!r}")
        return list(_MPR_REGISTRY[rest])
    if fmt == "dmr":
        # dmr.c:101 ReadDMRImage: repository IRI -> resource
        return coders_r4b.read_dmr(rest, settings, device)
    if fmt in ("mask", "clip"):
        # coders/mask.c:236 / coders/clip.c: decode the underlying file,
        # then surface the grayscale raster / rasterized 8BIM clip path
        inner = read_images(rest, size, settings, device)
        return coders_r4.read_mask(inner) if fmt == "mask" \
            else coders_r4.read_clip(inner)
    ext = fmt or os.path.splitext(rest)[1].lstrip(".").lower()
    if ext in _VIDEO_FMTS:
        # coders/video.c's read side: frames through the ffmpeg delegate
        path = rest.split("[")[0]
        enforce_path(path)
        if os.path.exists(path):
            return delegates.decode_video_frames(path, device=device)
    if fmt in _URL:
        # url.c / the curl delegate rule (delegates.xml.in:66-67): the
        # blob into the normal decode path, under the policy's "delegate"
        # rights (policy.c:623)
        target = rest if fmt == "url" else f"{fmt}:{rest}"
        return image_from_blob(_fetch_url(target), device=device)
    enforce_path(rest)
    if (fmt == "mpc" or rest.lower().endswith(".mpc")) and \
            os.path.exists(rest):
        return mpc.read_mpc(rest, device)
    with open(rest, "rb") as f:
        data = f.read()
    if ext in _META_PROFILE:
        # meta.c:1198 ReadMETAImage: the blob as a 1x1 image's profile
        return [coders_r4b.decode_meta(data, ext, device)]
    if ext in ("dot", "gv"):
        return delegates.decode_dot(data, device)
    if ext == "pcl":
        return delegates.decode_pcl(data, device=device)
    if ext == "xps":
        return delegates.decode_xps(data, device=device)
    if ext in _OFFICE:
        return delegates.decode_office(data, ext, device)
    if ext in _RAW and w and h:
        return [extra_coders.decode_raw(data, ext, w, h, device=device)]
    if ext in ("raw", "r") and w and h:
        # raw.c: single-channel quantum stream
        return [extra_coders.decode_raw(data, "gray", w, h, device=device)]
    if ext == "mono" and w and h:
        return [formats2.decode_mono(data, w, h, device=device)]
    if ext in _SIZED4 and w and h:
        return [_SIZED4[ext](data, w, h, device=device)]
    return image_from_blob(data, ext, device)


def read_image(filename: str, size: Optional[str] = None,
               device="cuda") -> Image:
    return read_images(filename, size, device=device)[0]


def _check_tiff(data: bytes) -> None:
    """Raise ValueError for a TIFF that the native deep reader
    (``formats4.decode_tiff16``) declined and Pillow would narrow: samples
    deeper than 8 bits in a color image."""
    import io as _io

    from PIL import Image as PILImage

    with PILImage.open(_io.BytesIO(data)) as pim:
        tags = getattr(pim, "tag_v2", {})
        bps = tags.get(258, (8,))
        bps = bps if isinstance(bps, tuple) else (bps,)
        if max(bps) > 8 and pim.mode not in ("I;16", "I;16B", "I;16L", "I",
                                             "F"):
            raise ValueError(
                f"tiff of {max(bps)}-bit {pim.mode} samples: the native "
                f"deep reader takes only uncompressed interleaved samples "
                f"in one strip (or in strips that follow one another), and "
                f"Pillow would narrow these to 8 bits")


def _deep_tiff(data: bytes, device) -> Optional[List[Image]]:
    """The TIFF as ``formats4.decode_tiff16`` reads it, or None where it
    declines the file."""
    import struct

    try:
        return [formats4.decode_tiff16(data, device=device)]
    except (ValueError, TypeError, IndexError, struct.error):
        return None


def image_from_blob(data: bytes, fmt: Optional[str] = None,
                    device="cuda") -> List[Image]:
    """The images a blob holds, decoded on the host and moved to
    ``device`` once."""
    from ..core.policy import policy
    from ..core.resource import resources

    sniffed = detect_format(data)
    use = sniffed or (fmt.lower() if fmt else None)
    if use is None:
        raise ValueError("cannot determine image format")
    policy.enforce("coder", use.upper(), "read")
    if use == "miff":
        images = miff.decode(data, device)
    elif use in _PNM:
        images = [pnm.decode(data, device)]
    elif use in ("ff", "farbfeld"):
        images = [extra_coders.decode_farbfeld(data, device)]
    elif use == "xbm":
        images = [extra_coders.decode_xbm(data, device)]
    elif use == "xpm":
        images = [extra_coders.decode_xpm(data, device)]
    elif use == "svg":
        images = [extra_coders.decode_svg(data, device=device)]
    elif use == "ora":
        images = coders_r4.decode_ora(data, device)
    elif use == "kernel":
        # ReadKERNELImage, the inverse of WriteKERNELImage (coders/
        # kernel.c): the written 'WxH:v,v,...' text is itself a kernel
        # spec, read back through the pseudo-coder
        images = [coders_r4.kernel_pseudo(
            data.decode("ascii", "replace").strip(), device)]
    elif use in ("djvu", "flif", "fpx"):
        # recognized but delegate-library-gated, like an ImageMagick built
        # without libdjvu, libflif or libfpx
        raise ValueError(
            f"DelegateLibrarySupportNotBuiltIn `{use.upper()}'")
    elif use == "exr":
        images = [exr.decode(data, device)]
    elif use in _DECODE23:
        images = _DECODE23[use](data, device)
    elif use in _DECODE4:
        images = _DECODE4[use](data, device)
    elif use == "wmf":
        images = [coders_r4b.decode_wmf(data, device=device)]
    elif use == "emf":
        images = [emf.decode_emf(data, device=device)]
    elif use in _JBIG:
        images = [coders_r4b.decode_jbig(data, device)]
    elif use == "strimg":
        images = [coders_r4b.strimg_pseudo(
            data.decode("utf-8", "replace").rstrip("\n"), device)]
    elif use in _META_PROFILE:
        images = [coders_r4b.decode_meta(data, use, device)]
    elif use == "hdr":
        images = [_decode_hdr(data, device)]
    elif use == "uhdr":
        # Ultra HDR is a JPEG with an embedded gainmap; decode the base
        images = codecs.decode(data, "jpeg", device)
    elif use in ("pdf", "ps", "eps"):
        images = delegates.decode_postscript(data, use, device=device)
    elif use == "dng":
        # the native CFA demosaic first; a raw it declines (compressed,
        # lossy, a vendor raw named .dng) goes to the dcraw delegate
        # where one is installed (delegates.xml.in:68-70)
        try:
            images = [dng.decode_dng(data, device)]
        except ValueError:
            if not delegates.has_dcraw():
                raise
            images = delegates.decode_dcraw(data, "dng", device)
    elif use in ("tiff", "tif") and dng.is_dng(data):
        # DNG shares the TIFF magic: a CFA raw goes to the DNG reader
        images = [dng.decode_dng(data, device)]
    else:
        images = None
        if use in ("tiff", "tif"):
            # the native deep reader first (Pillow narrows 48-bit RGB to
            # 8 bits); what it declines goes to Pillow, unless Pillow
            # would narrow it
            images = _deep_tiff(data, device)
            if images is None:
                _check_tiff(data)
        if images is None:
            images = codecs.decode(data, use, device)
    if use in ("jpeg", "jpg", "png", "tiff", "tif"):
        from ..core.metadata import extract_metadata

        meta = extract_metadata(data, use)
        for im in images:
            for k, v in meta.items():
                im.properties.setdefault(k, v)
    for im in images:
        im.properties.setdefault("format", use.upper())
        resources.check_image_size(im.width, im.height)
    return images


# WriteImages (constitute.c): formats that hold several frames in a file
_ADJOIN = {"gif", "tif", "tiff", "miff", "mng", "pdf", "ps", "ps2",
           "ps3", "webp", "ico", "dcm", "heic", "heif", "avif",
           "apng", "mpc", "fax", "g3", "g4", "pbm", "pgm", "ppm",
           "pnm", "pam", "mpeg", "mp4", "avi", "mkv", "mov", "ype",
           "null", "txt", "json", "yaml", "info"}
_SCENE = re.compile(r"%0?\d*d")


def write_image(image: Union[Image, List[Image]], filename: str,
                quality: int = 92, depth: Optional[int] = None,
                settings: Optional[dict] = None) -> None:
    """Write one image or a list under ``filename``: a file, ``-`` for
    stdout (looked up at the call), ``mpr:``, ``null:``, ``mask:`` or
    ``info:``/``json:``/``txt:`` to stdout.  Several images go to one
    file where the format adjoins them, else to ``%d``-expanded names or
    ``stem-N.ext``."""
    fmt, rest = _split_filename(str(filename))
    images = image if isinstance(image, list) else [image]
    if fmt == "mpr":
        enforce_path(filename)
        _MPR_REGISTRY[rest] = list(images)
        return
    if fmt in ("null",):
        return
    if fmt == "dmr":
        coders_r4b.write_dmr(images, rest, settings)
        return
    if fmt == "mpc" or (fmt is None and rest.lower().endswith(".mpc")):
        mpc.write_mpc(images, rest)
        return
    if fmt == "mask":
        # coders/mask.c:311 WriteMASKImage: write the image's mask raster
        # in the format the remaining filename implies
        write_image([coders_r4.write_mask_image(im) for im in images],
                    rest, quality=quality, depth=depth)
        return
    if fmt in ("info", "json", "yaml", "txt") and rest in ("", "-"):
        from . import identify as ident

        for im in images:
            if fmt == "json":
                print(ident.to_json(im, rest))
            elif fmt == "txt":
                print(_enumerate_pixels(im))
            else:
                print(ident.describe(im, rest, verbose=True))
        return
    if fmt is None:
        fmt = os.path.splitext(rest)[1].lstrip(".").lower()
    from ..core.policy import policy as _policy

    _policy.enforce("coder", fmt.upper(), "write")
    if rest != "-":
        enforce_path(rest)
    if len(images) > 1 and rest != "-" and (
            _SCENE.search(rest) or fmt not in _ADJOIN):
        if _SCENE.search(rest):
            names = [_SCENE.sub(lambda m, i=i: ("%" + m.group(0)[1:]) % i,
                                rest) for i in range(len(images))]
        else:
            stem, ext = os.path.splitext(rest)
            names = [f"{stem}-{i}{ext}" for i in range(len(images))]
        for im, name in zip(images, names):
            blob = image_to_blob([im], fmt, quality=quality, depth=depth)
            with open(name, "wb") as f:
                f.write(blob)
        return
    blob = image_to_blob(images, fmt, quality=quality, depth=depth)
    if rest == "-":   # stdout (cli-pipe.tap semantics)
        sys.stdout.buffer.write(blob)
        sys.stdout.buffer.flush()
        return
    with open(rest, "wb") as f:
        f.write(blob)


def _enumerate_pixels(im) -> str:
    """txt: coder — pixel enumeration (coders/txt.c)."""
    arr = im.to_numpy()
    if arr.ndim == 4:
        arr = arr[0]
    h, w, c = arr.shape
    lines = [f"# ImageMagick pixel enumeration: {w},{h},255,srgb"]
    for y in range(h):
        for x in range(w):
            px = arr[y, x]
            rgb = ",".join(str(int(v * 255 + 0.5)) for v in px[:3])
            lines.append(f"{x},{y}: ({rgb})")
    return "\n".join(lines)


# IssRGBCompatibleColorspace (colorspace-private.h:1763): colorspaces a
# raster coder can store verbatim; anything else is transformed to sRGB
# at write time (e.g. png.c:8283)
_SRGB_COMPAT = {"srgb", "rgb", "adobe98", "prophoto", "displayp3",
                "scrgb", "transparent", "gray", "lineargray",
                "linear-gray", "linear_gray"}
# formats that persist the colorspace tag (or support CMYK) themselves
_RAW_CS_FORMATS = {"miff", "mif", "mpc", "info", "json", "yaml", "txt",
                   "pfm", "null", "ype"}


def _to_srgb_for_write(images: List[Image], fmt: str) -> List[Image]:
    """Each image whose colorspace the format cannot store, converted to
    sRGB on its device."""
    out = []
    for im in images:
        cs_name = (im.spec.colorspace or "srgb").lower()
        if cs_name in _SRGB_COMPAT or fmt in _RAW_CS_FORMATS:
            out.append(im)
            continue
        if cs_name == "cmyk" and fmt in ("jpeg", "jpg", "tiff", "tif",
                                         "psd", "pdf", "eps"):
            out.append(im)
            continue
        from ..ops import colorspace as cs_ops

        nc = im.spec.color_channels
        color = cs_ops.convert(im.data[..., :nc], cs_name, "srgb")
        rest = im.data[..., nc:]
        data = torch.cat([color[..., :3], rest], -1) \
            if rest.shape[-1] else color[..., :3]
        out.append(im.replace(data=data,
                              spec=im.spec.with_(colorspace="srgb")))
    return out


def image_to_blob(image: Union[Image, List[Image]], fmt: str,
                  quality: int = 92, depth: Optional[int] = None) -> bytes:
    """The bytes of one image or a list in ``fmt``; the pixels come to the
    host and are quantized there."""
    images = image if isinstance(image, list) else [image]
    fmt = fmt.lower()
    depth = depth or images[0].spec.depth
    images = _to_srgb_for_write(images, fmt)
    if fmt in ("info", "json", "yaml", "txt"):
        from . import identify as ident

        parts = []
        for im in images:
            if fmt == "json":
                parts.append(ident.to_json(im, ""))
            elif fmt == "txt":
                parts.append(_enumerate_pixels(im))
            else:
                parts.append(ident.describe(im, "", verbose=True))
        return ("\n".join(parts) + "\n").encode()
    if fmt in ("miff", "mif"):
        return miff.encode(images, depth=16 if depth > 8 else 8,
                           compression="zip")
    if fmt in _PNM:
        return b"".join(pnm.encode(im, fmt, depth=depth) for im in images)
    if fmt in ("ff", "farbfeld"):
        return extra_coders.encode_farbfeld(images[0])
    if fmt == "xbm":
        return extra_coders.encode_xbm(images[0])
    if fmt == "xpm":
        return extra_coders.encode_xpm(images[0])
    if fmt in ("sixel", "six"):
        return extra_coders.encode_sixel(images[0])
    if fmt in _RAW + ("uyvy",):
        return extra_coders.encode_raw(images[0], fmt, depth=depth or 8)
    if fmt == "exr":
        return exr.encode(images[0])
    if fmt == "dng":
        return dng.encode_dng(images[0])
    if fmt == "raw":
        return extra_coders.encode_raw(images[0], "gray", depth=depth)
    if fmt == "ora":
        return coders_r4.encode_ora(images)
    if fmt == "kernel":
        return coders_r4.encode_kernel(images[0])
    if fmt in _VIDEO_FMTS:
        return coders_r4.encode_video(images, fmt)
    if fmt == "dpx":
        return formats2.encode_dpx(images[0], bits=10 if depth > 8 else 8)
    if fmt == "psd":
        # 8-bit for the readers' sake, as the JAX package writes it
        return formats2.encode_psd(images[0], depth=8)
    if fmt == "pdf":
        return formats2.encode_pdf(images)
    if fmt == "mat":
        return formats3.encode_mat(images[0], depth=depth)
    if fmt in _ENCODE23:
        return _ENCODE23[fmt](images[0])
    if fmt == "hdr":
        return _encode_hdr(images[0])
    if fmt == "strimg":
        return coders_r4b.encode_strimg(images[0])
    if fmt == "debug":
        return coders_r4b.encode_debug(images)
    if fmt == "matte":
        return coders_r4b.encode_matte(images[0])
    if fmt in _JBIG:
        return coders_r4b.encode_jbig(images[0])
    if fmt in _META_PROFILE:
        return coders_r4b.encode_meta(images[0], fmt)
    if fmt in ("tiff", "tif") and depth > 8 and len(images) == 1 \
            and not images[0].profiles:
        # Pillow cannot save 48-bit RGB: the native deep writer
        return formats4.encode_tiff16(images[0])
    if fmt == "pgx":
        return formats4.encode_pgx(images[0], depth=16 if depth > 8 else 8)
    if fmt in ("vips", "v"):
        return formats4.encode_vips(images[0], depth=depth)
    if fmt == "ipl":
        return formats4.encode_ipl(images[0], depth=depth)
    if fmt == "bayer":
        return formats4.encode_bayer(images[0], depth=depth)
    if fmt in _BRAILLE:
        return formats4.encode_braille(
            images[0], "ubrl" if fmt == "braille" else fmt)
    if fmt == "ashlar":
        return formats4.encode_ashlar(images)
    if fmt == "dcx":
        return formats4.encode_dcx(images)
    if fmt in ("ps", "ps2", "ps3"):
        # the PostScript levels share the EPS writer (coders/ps2.c, ps3.c)
        return codecs.encode(images, "eps", quality=quality, depth=depth)
    if fmt in _ENCODE4:
        return _ENCODE4[fmt](images[0])
    if fmt == "svg":
        # raster-in-SVG wrapper (the reference embeds the raster too
        # unless a tracing delegate like autotrace is installed)
        import base64 as _b64

        png = image_to_blob(images[0], "png")
        w0, h0 = images[0].width, images[0].height
        return (
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'xmlns:xlink="http://www.w3.org/1999/xlink" '
            f'width="{w0}" height="{h0}">\n'
            f'<image width="{w0}" height="{h0}" '
            f'xlink:href="data:image/png;base64,'
            f'{_b64.b64encode(png).decode()}"/>\n</svg>\n').encode()
    return codecs.encode(images, fmt, quality=quality, depth=depth)


def _pil_formats(registry: str) -> set:
    """The names of ``codecs._PIL_FORMATS`` whose Pillow plugin this
    host's Pillow registers for reading (``OPEN``) or writing
    (``SAVE``)."""
    from PIL import Image as PILImage

    PILImage.init()
    have = getattr(PILImage, registry)
    return {k for k, v in codecs._PIL_FORMATS.items() if v in have}


# Pillow reads these from the blob too (codecs.decode's PIL.Image.open)
_PIL_READ_EXTRA = {"psd", "sun", "pcd", "dcx", "cur", "fli", "flc", "msp",
                   "pixar", "pxr", "spider", "wal", "gbr", "mpo", "blp",
                   "icns", "ftc", "ftu"}


def _heifjxl_formats() -> set:
    """HEIF and JPEG XL where the port's ``heifjxl`` library opens their
    system libraries, and JBIG where its ``jbigio`` library builds."""
    from .. import native

    out = set()
    if native.heif_available():
        out |= {"heic", "heif"}
    if native.jxl_available():
        out.add("jxl")
    if native.jbig_available():
        out |= set(_JBIG)
    return out


def _delegate_formats() -> set:
    """The formats that a delegate installed on this host reads."""
    out = set()
    if delegates.has_ghostscript():
        out |= {"pdf", "ps", "eps"}
    if delegates.has_ffmpeg():
        out |= _VIDEO_FMTS
    if delegates.has_graphviz():
        out |= {"dot", "gv"}
    if delegates.has_pcl():
        out.add("pcl")
    if delegates.has_xps():
        out.add("xps")
    if delegates.has_office():
        out |= {"doc", "docx", "odt", "pptx", "xlsx"}
    return out


# the port's coders of their own (miff.py, mpc.py, exr.py, dng.py,
# extra_coders.py, coders_r4.py, formats2.py, formats3.py, formats4.py,
# coders_r4b.py, emf.py, _rgbe.py)
_CODERS_READ = ({"miff", "mif", "mpc", "exr", "dng", "ff", "farbfeld",
                 "xbm", "xpm", "svg", "ora", "kernel", "dmr", "wmf", "emf",
                 "hdr"} | _META_PROFILE | _FORMATS23_READ | _FORMATS4_READ)
_CODERS_WRITE = ({"miff", "mif", "mpc", "exr", "dng", "ff", "farbfeld",
                  "xbm", "xpm", "sixel", "six", "ora", "kernel", "hdr",
                  "strimg", "debug", "matte", "dmr"} | _META_PROFILE
                 | _FORMATS23_WRITE | _FORMATS4_WRITE)


def supported_read_formats():
    """The formats the port reads: the JAX package's list, and the names
    that the JAX package reads but its list leaves out (BGRA, CMYK and
    YCBCR, which it lists as write-only, and R, given a size; TEXT, TTC,
    V, VIF, EPT2, EPT3 and H, aliases its reader takes), but not SIX and
    SIXEL, which the JAX list names and neither package reads back."""
    out = (set(_PSEUDO) | set(_PNM) | set(_RAW)
           | {"raw", "r", "mpr", "mask", "clip", "uhdr"} | _CODERS_READ
           | ((_pil_formats("OPEN") | _PIL_READ_EXTRA) - {"heic", "jxl"})
           | _heifjxl_formats() | _delegate_formats())
    return sorted(out)


def supported_write_formats():
    """The formats the port writes: the JAX package's list, and the
    aliases that the JAX package writes but its list leaves out (EPT2,
    EPT3, H, SHTML, V and VIF)."""
    out = (set(_PNM) | set(_RAW) | {"raw", "uyvy", "mpr", "null", "info",
                                    "json", "txt", "yaml", "mask", "svg"}
           | _CODERS_WRITE
           | (_pil_formats("SAVE") - {"heic", "jxl"})
           | _heifjxl_formats()
           | (_VIDEO_FMTS if delegates.has_ffmpeg() else set()))
    return sorted(out)


def known_write_formats():
    """The formats the port writes and those it writes with a codec or
    delegate missing here (writing one raises): the names a CLI's last
    token may carry as an output prefix."""
    return sorted(set(supported_write_formats()) | _VIDEO_FMTS
                  | {"heic", "heif", "jxl"} | set(_JBIG))


def _decode_hdr(data: bytes, device) -> Image:
    """Radiance HDR (coders/hdr.c analog): float32 RGB, unclipped, on
    ``device``."""
    return Image(_rgbe.decode(data), ImageSpec(colorspace="rgb", depth=16),
                 device=device)


def _encode_hdr(image: Image) -> bytes:
    """Radiance HDR of the first frame: a gray image's channel written
    three times (its alpha dropped, as a colour image's is; the JAX
    function raises IndexError on gray with alpha)."""
    arr = image.to_numpy().astype(np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[-1] < 3:
        arr = np.repeat(arr[..., :1], 3, -1)
    return _rgbe.encode(arr[..., :3])
