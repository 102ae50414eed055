"""Host-side standard-format codecs (PNG/JPEG/GIF/TIFF/WebP/BMP/...).

Port of ``imagemagick_tpu/io/codecs.py``, the bridge to Pillow's bindings
of libpng, libjpeg, libtiff and the rest (ImageMagick links the same C
libraries per coder).  Codecs stay on the host: a decoded image is made
float32 there with the JAX module's expression (levels over 255 or 65535)
and goes to ``device`` once; an encoded one comes to the host and is
quantized there with the JAX module's expression, so equal pixels give
equal bytes.  As in the JAX bridge, JPEG and PNG take the port's native
codecs (``native/miniio.cpp``'s two halves) first where they build, and
HEIF and JPEG XL the ``heifjxl`` library (``dlopen`` of the system
libheif and libjxl): a HEIF or JPEG XL blob that it cannot decode falls
to Pillow, and a write without its encoder raises ValueError.  Each
native codec is its own library, so one missing system library leaves
the others working.
"""

from __future__ import annotations

import io as _io
from typing import List, Optional

import numpy as np

from ..core.image import Image, _infer_spec
from ..core.spec import ImageSpec

try:
    from PIL import Image as PILImage
    from PIL import ImageSequence

    HAVE_PIL = True
except Exception:  # pragma: no cover
    HAVE_PIL = False


_MODE_SPECS = {
    "1": ("gray", False),
    "L": ("gray", False),
    "LA": ("gray", True),
    "I": ("gray", False),
    "I;16": ("gray", False),
    "F": ("gray", False),
    "P": ("srgb", False),
    "RGB": ("srgb", False),
    "RGBA": ("srgb", True),
    "CMYK": ("cmyk", False),
    "YCbCr": ("srgb", False),
}


def _pil_to_image(pim, device="cuda") -> Image:
    mode = pim.mode
    if mode == "P":
        pim = pim.convert("RGBA" if "transparency" in pim.info else "RGB")
        mode = pim.mode
    if mode == "YCbCr":
        pim = pim.convert("RGB")
        mode = "RGB"
    if mode == "1":
        pim = pim.convert("L")
        mode = "L"
    cs, alpha = _MODE_SPECS.get(mode, ("srgb", False))
    arr = np.asarray(pim)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype == np.uint8:
        f = arr.astype(np.float32) / 255.0
        depth = 8
    elif arr.dtype in (np.uint16, np.dtype(">u2")):
        f = arr.astype(np.float32) / 65535.0
        depth = 16
    elif arr.dtype == np.int32:
        f = arr.astype(np.float32) / 65535.0
        depth = 16
    else:
        f = arr.astype(np.float32)
        depth = 16
    props = {}
    for k, v in getattr(pim, "info", {}).items():
        if isinstance(v, (str, int, float)):
            props[str(k)] = v
    img = Image(f, ImageSpec(colorspace=cs, alpha=alpha, depth=depth),
                properties=props, device=device)
    if "icc_profile" in pim.info and pim.info["icc_profile"]:
        img.profiles["icc"] = pim.info["icc_profile"]
    exif = pim.getexif() if hasattr(pim, "getexif") else None
    if exif and 274 in exif:
        img.properties["exif:Orientation"] = int(exif[274])
    return img


def _attach_density(img: Image, data: bytes, fmt: str) -> Image:
    """Parse resolution + units from PNG pHYs / JPEG JFIF APP0 headers
    into properties (png.c:2108 pHYs handling, jpeg.c JFIF density) —
    drives identify's Units:/Resolution: lines and -units/-density."""
    import struct as _s

    try:
        if fmt == "png":
            pos = 8
            while pos + 8 <= len(data):
                (ln,) = _s.unpack_from(">I", data, pos)
                typ = data[pos + 4:pos + 8]
                if typ == b"pHYs" and ln == 9:
                    x, y = _s.unpack_from(">II", data, pos + 8)
                    unit = data[pos + 16]
                    if unit == 1:   # pixels per meter
                        img.properties["units"] = "PixelsPerCentimeter"
                        img.properties["resolution"] = (x / 100.0, y / 100.0)
                    break
                if typ == b"IDAT":
                    break
                pos += 12 + ln
        elif fmt in ("jpeg", "jpg") and data[2:4] == b"\xff\xe0" \
                and data[6:10] == b"JFIF":
            unit = data[13]
            x, y = _s.unpack_from(">HH", data, 14)
            if unit == 1:
                img.properties["units"] = "PixelsPerInch"
                img.properties["resolution"] = (float(x), float(y))
            elif unit == 2:
                img.properties["units"] = "PixelsPerCentimeter"
                img.properties["resolution"] = (float(x), float(y))
    except Exception:   # noqa: BLE001 — malformed headers stay undefined
        pass
    return img


def decode(data: bytes, fmt: Optional[str] = None, device="cuda"
           ) -> List[Image]:
    from .. import native

    # HEIC/JXL: the dlopen layer over the system libheif/libjxl that
    # coders/heic.c and coders/jxl.c link (Pillow lacks both)
    if fmt in ("heic", "heif", "jxl"):
        arr = native.decode_jxl(data) if fmt == "jxl" else \
            native.decode_heif(data)
        if arr is not None:
            return [Image(arr.astype(np.float32) / 255.0,
                          _infer_spec(arr.shape[-1]).with_(depth=8),
                          device=device)]
        # fall through to PIL (a plugin may read it elsewhere)
    # native fast paths (GIL-free libjpeg and libpng; native/miniio.cpp)
    if fmt in ("jpeg", "jpg") and native.available():
        arr = native.decode_jpeg(data)
        if arr is not None:
            img = Image(arr.astype(np.float32) / 255.0,
                        _infer_spec(arr.shape[-1]).with_(depth=8),
                        device=device)
            return [_attach_density(img, data, fmt)]
    if fmt == "png" and native.png_available():
        res = native.decode_png(data)
        if res is not None:
            arr, depth = res
            scale = 65535.0 if depth == 16 else 255.0
            img = Image(arr.astype(np.float32) / scale,
                        _infer_spec(arr.shape[-1]), device=device)
            img.spec = img.spec.with_(depth=min(depth, 16))
            return [_attach_density(img, data, fmt)]
    if not HAVE_PIL:
        raise RuntimeError("Pillow unavailable for standard-format decode")
    pim = PILImage.open(_io.BytesIO(data))
    frames = []
    try:
        for frame in ImageSequence.Iterator(pim):
            img = _pil_to_image(frame.copy(), device)
            dur = frame.info.get("duration", 0)
            img.delay = int(dur / 10) if dur else 0  # ticks of 1/100 s
            frames.append(img)
    except Exception:
        if not frames:
            frames = [_pil_to_image(pim, device)]
    return frames


_PIL_FORMATS = {
    "png": "PNG", "jpg": "JPEG", "jpeg": "JPEG", "gif": "GIF",
    "bmp": "BMP", "tiff": "TIFF", "tif": "TIFF", "webp": "WEBP",
    "ico": "ICO", "tga": "TGA", "pcx": "PCX", "ppm": "PPM",
    "dib": "DIB", "im": "IM", "xbm": "XBM", "eps": "EPS",
    "sgi": "SGI", "dds": "DDS", "qoi": "QOI", "avif": "AVIF",
    "heic": "HEIF", "jp2": "JPEG2000", "j2k": "JPEG2000",
}


def encodable_formats():
    return sorted(_PIL_FORMATS)


def encode(images, fmt: str, quality: int = 92, depth: int = 8) -> bytes:
    if isinstance(images, Image):
        images = [images]
    from .. import native

    if fmt.lower() in ("heic", "heif", "jxl"):
        arr = images[0].to_numpy()
        q = (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        if q.ndim == 2:
            q = q[..., None]
        if fmt.lower() == "jxl":
            blob = native.encode_jxl(q)
        else:
            if q.shape[-1] in (1, 2):   # heif interleaved wants RGB(A)
                q = np.concatenate([np.repeat(q[..., :1], 3, -1),
                                    q[..., 1:]], -1)
            blob = native.encode_heif(q, quality)
        if blob is not None:
            return blob
        raise ValueError(
            f"no {fmt} encoder available (libheif HEVC plugin / libjxl "
            "missing on this host; format is read-only here)")
    # native fast paths: one frame, no embedded profile
    fmt_n = fmt.lower()
    if fmt_n in ("jpeg", "jpg", "png") and len(images) == 1 \
            and not images[0].profiles and (
                native.available() if fmt_n != "png"
                else native.png_available()):
        arr = images[0].to_numpy()
        if arr.ndim == 3:
            blob = _native_encode(native, arr, fmt_n, quality, depth)
            if blob is not None:
                return blob
    if not HAVE_PIL:
        raise RuntimeError("Pillow unavailable for standard-format encode")
    fmt_l = fmt.lower()
    pil_fmt = _PIL_FORMATS.get(fmt_l)
    if pil_fmt is None:
        raise ValueError(f"no encoder for format {fmt!r}")
    pil_frames = []
    for img in images:
        arr = img.to_numpy()
        if arr.ndim == 4:
            for i in range(arr.shape[0]):
                pil_frames.append(_to_pil(arr[i], img.spec, pil_fmt, depth))
        else:
            pil_frames.append(_to_pil(arr, img.spec, pil_fmt, depth))
    buf = _io.BytesIO()
    kwargs = {}
    if pil_fmt == "JPEG":
        kwargs["quality"] = quality
        kwargs["subsampling"] = 0 if quality >= 90 else 2
    if pil_fmt == "PNG" and depth > 8:
        pass  # 16-bit PNG handled in _to_pil via mode I;16
    if pil_fmt == "ICO":
        # PIL's default sizes list drops every entry larger than the
        # source, which can produce an empty (6-byte) ICO — pin the
        # actual frame size (<=256 per the format)
        w0, h0 = pil_frames[0].size
        kwargs["sizes"] = [(min(w0, 256), min(h0, 256))]
    icc = images[0].profiles.get("icc")
    if icc:
        kwargs["icc_profile"] = icc
    if len(pil_frames) > 1 and pil_fmt in ("GIF", "TIFF", "WEBP", "PNG"):
        durations = [max(im_.delay, 0) * 10 for im_ in images] or [0]
        pil_frames[0].save(buf, format=pil_fmt, save_all=True,
                           append_images=pil_frames[1:],
                           duration=durations[0] or 100, loop=0, **kwargs)
    else:
        pil_frames[0].save(buf, format=pil_fmt, **kwargs)
    return buf.getvalue()


def _native_encode(native, arr: np.ndarray, fmt: str, quality: int,
                   depth: int) -> Optional[bytes]:
    """One (H, W, C) frame through the native JPEG or PNG encoder, with
    the JAX bridge's channel and depth choices; None where it declines."""
    if fmt in ("jpeg", "jpg"):
        q = (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        if q.shape[-1] == 4:
            q = q[..., :3]
        elif q.shape[-1] == 2:
            q = q[..., :1]
        return native.encode_jpeg(q, quality)
    if arr.shape[-1] not in (1, 2, 3, 4):
        return None
    if arr.shape[-1] == 3 and arr.shape[0] * arr.shape[1] <= 1 << 22 and \
            (arr[..., 0] == arr[..., 1]).all() and \
            (arr[..., 1] == arr[..., 2]).all():
        # png.c auto-reduces equal-channel images to gray
        arr = arr[..., :1]
    if depth > 8:
        q16 = (np.clip(arr, 0, 1) * 65535.0 + 0.5).astype(np.uint16)
        # png.c ok_to_reduce: drop to 8 bits when every sample is a
        # 257-multiple (exactly 8-bit)
        if (q16 % 257 == 0).all():
            return native.encode_png((q16 // 257).astype(np.uint8), 8)
        return native.encode_png(q16, 16)
    q8 = (np.clip(arr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    return native.encode_png(q8, 8)


def _to_pil(arr: np.ndarray, spec: ImageSpec, pil_fmt: str, depth: int):
    arr = np.clip(arr, 0.0, 1.0)
    c = arr.shape[-1]
    if pil_fmt == "PNG" and c == 3 and arr.shape[0] * arr.shape[1] <= 1 << 22:
        # png.c auto-reduces equal-channel images to grayscale PNGs
        if (arr[..., 0] == arr[..., 1]).all() and \
                (arr[..., 1] == arr[..., 2]).all():
            arr = arr[..., :1]
            c = 1
    if pil_fmt == "PNG" and depth > 8 and c == 1:
        q = (arr[..., 0] * 65535.0 + 0.5).astype(np.uint16)
        if (q % 257 == 0).all():       # png.c ok_to_reduce depth drop
            return PILImage.fromarray((q // 257).astype(np.uint8),
                                      mode="L")
        return PILImage.fromarray(q)  # uint16 -> I;16 inferred
    q = (arr * 255.0 + 0.5).astype(np.uint8)
    if c == 1:
        im = PILImage.fromarray(q[..., 0], mode="L")
    elif c == 2:
        im = PILImage.fromarray(q, mode="LA")
    elif c == 3:
        im = PILImage.fromarray(q, mode="RGB")
    elif c == 4 and spec.alpha:
        im = PILImage.fromarray(q, mode="RGBA")
    elif c == 4:
        im = PILImage.fromarray(q, mode="CMYK")
    else:
        im = PILImage.fromarray(q[..., :3], mode="RGB")
    if pil_fmt == "JPEG" and im.mode in ("RGBA", "CMYK"):
        im = im.convert("RGB")
    if pil_fmt == "JPEG" and im.mode == "LA":
        im = im.convert("L")
    if pil_fmt == "GIF":
        im = im.convert("P", palette=PILImage.ADAPTIVE)
    return im
