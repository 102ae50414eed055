"""ORA, KERNEL, MASK, CLIP, PANGO and the video writer.

Port of ``imagemagick_tpu/io/coders_r4.py`` (ImageMagick's coders/ora.c,
kernel.c, mask.c, clip.c, pango.c and video.c):

* ORA: read ``mergedimage.png`` from the zip (or composite the layer
  stack over each other); write a whole OpenRaster archive, its
  thumbnail a box resize by the port's ``ops/resize.py`` on the image's
  device.
* KERNEL: write ``WxH:`` and the pixels' intensities; ``kernel:SPEC``
  reads a kernel spec back as an image.
* MASK and CLIP: a mask is kept, as in the JAX package, as the image
  property ``wand:mask``, an (H, W) array (on the host, or a tensor on
  the image's device after -region); the clip path is rasterized by the port's ``ops/draw.py`` on the image's device.
* PANGO: the markup stripped to plain text and rendered by the port's
  ``pseudo.caption``, as the JAX function does without the pango library.
* video: frames piped as PNGs to ffmpeg (a delegate, ``io/delegates.py``).

Decoded images go to ``device`` (the card unless the caller asks for the
CPU); the zip and the text are read and written on the host.
"""

from __future__ import annotations

import io as _io
import re
import zipfile
from typing import List, Optional

import numpy as np
import torch

from ..core.image import Image
from ..core.spec import ImageSpec


# ---------------------------------------------------------------------------
# ORA (OpenRaster)
# ---------------------------------------------------------------------------

def decode_ora(data: bytes, device="cuda") -> List[Image]:
    """ReadORAImage (ora.c:105): extract mergedimage.png from the zip."""
    from . import image_from_blob

    with zipfile.ZipFile(_io.BytesIO(data)) as z:
        names = z.namelist()
        if "mergedimage.png" in names:
            return image_from_blob(z.read("mergedimage.png"), "png", device)
        # fall back to compositing the layer stack bottom-up
        layers = [n for n in names
                  if n.startswith("data/") and n.lower().endswith(".png")]
        if not layers:
            raise ValueError("ORA archive has no mergedimage.png or layers")
        stack = None
        offsets = {}
        if "stack.xml" in names:
            xml = z.read("stack.xml").decode("utf-8", "replace")
            for m in re.finditer(r"<layer[^>]*>", xml):
                tag = m.group(0)
                src = re.search(r'src="([^"]+)"', tag)
                if not src:
                    continue
                gx = re.search(r'x="(-?\d+)"', tag)
                gy = re.search(r'y="(-?\d+)"', tag)
                offsets[src.group(1)] = (int(gx.group(1)) if gx else 0,
                                         int(gy.group(1)) if gy else 0)
        from ..ops.composite import composite_at as _comp

        for name in reversed(layers):    # stack.xml lists top-first
            img = image_from_blob(z.read(name), "png", device)[0]
            if stack is None:
                stack = img
                continue
            x, y = offsets.get(name, (0, 0))
            data2 = _comp(stack.data, img.data, "over", x, y,
                          src_alpha=img.spec.alpha,
                          dst_alpha=stack.spec.alpha)
            stack = Image(data2, stack.spec.with_(alpha=True))
        return [stack]


def encode_ora(images: List[Image]) -> bytes:
    """Spec-complete OpenRaster writer: mimetype (stored first entry),
    stack.xml, data/layerN.png, mergedimage.png, Thumbnails/thumbnail.png."""
    from . import image_to_blob

    buf = _io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(zipfile.ZipInfo("mimetype"), b"image/openraster",
                   zipfile.ZIP_STORED)
        base = images[0]
        w, h = base.width, base.height
        layers_xml = []
        for i, im in enumerate(images):
            png = image_to_blob([im], "png")
            z.writestr(f"data/layer{i}.png", png)
            layers_xml.append(
                f'    <layer name="layer{i}" src="data/layer{i}.png" '
                f'x="0" y="0" opacity="1.0" visibility="visible"/>')
        z.writestr("stack.xml",
                   '<?xml version="1.0" encoding="UTF-8"?>\n'
                   f'<image version="0.0.3" w="{w}" h="{h}">\n'
                   '  <stack>\n' + "\n".join(layers_xml) +
                   "\n  </stack>\n</image>\n")
        z.writestr("mergedimage.png", image_to_blob([base], "png"))
        # thumbnail <= 256 on the long edge, a box resize on the device
        from ..ops.resize import resize as _rz

        scale = 256.0 / max(w, h)
        if scale < 1.0:
            tw, th = max(1, int(w * scale)), max(1, int(h * scale))
            thumb = Image(_rz(base.data, th, tw, "box"), base.spec)
        else:
            thumb = base
        z.writestr("Thumbnails/thumbnail.png", image_to_blob([thumb], "png"))
    return buf.getvalue()


# ---------------------------------------------------------------------------
# KERNEL
# ---------------------------------------------------------------------------

def encode_kernel(image: Image) -> bytes:
    """WriteKERNELImage (kernel.c:160): 'WxH:' + comma list of pixel
    intensities (QuantumScale), '-' where alpha < OpaqueAlpha/2."""
    arr = image.to_numpy().astype(np.float64)
    h, w = arr.shape[0], arr.shape[1]
    c = arr.shape[2]
    if c >= 3:
        inten = (0.212656 * arr[..., 0] + 0.715158 * arr[..., 1] +
                 0.072186 * arr[..., 2])
    else:
        inten = arr[..., 0]
    alpha = arr[..., -1] if image.spec.alpha else np.ones((h, w))
    parts = []
    for y in range(h):
        for x in range(w):
            if alpha[y, x] < 0.5:
                parts.append("-")
            else:
                parts.append("%.*g" % (6, inten[y, x]))
    return (f"{w}x{h}:" + ",".join(parts) + "\n").encode()


def kernel_pseudo(spec: str, device="cuda") -> Image:
    """kernel: pseudo-read — render a builtin kernel spec
    (AcquireKernelInfo grammar, morphology.c) to a grayscale image with
    values min-max normalized; undefined (nan) taps become transparent."""
    from ..ops.morphology import get_kernel

    k = np.asarray(get_kernel(spec)[0], np.float32).astype(np.float64)
    finite = np.isfinite(k)
    vals = k[finite]
    lo = float(vals.min()) if vals.size else 0.0
    hi = float(vals.max()) if vals.size else 1.0
    norm = (k - lo) / (hi - lo) if hi > lo else np.where(finite, 1.0, 0.0)
    norm = np.where(finite, norm, 0.0)
    alpha = finite.astype(np.float64)
    data = np.stack([norm, alpha], axis=-1).astype(np.float32)
    return Image(data, ImageSpec(colorspace="gray", alpha=True),
                 device=device)


# ---------------------------------------------------------------------------
# MASK / CLIP
# ---------------------------------------------------------------------------

def read_mask(images: List[Image]) -> List[Image]:
    """ReadMASKImage (mask.c:236): the decoded image, grayscaled."""
    from ..ops.enhance import grayscale

    out = []
    for im in images:
        g = grayscale(im.data)
        out.append(Image(g, im.spec.with_(colorspace="gray", alpha=False),
                         im.properties, im.profiles, im.page, im.delay))
    return out


def write_mask_image(image: Image) -> Image:
    """WriteMASKImage (mask.c:311): the image's mask raster as a
    grayscale image; CoderError when the image carries no mask."""
    m = image.properties.get("wand:mask")
    if m is None:
        raise ValueError("MASK write: ImageDoesNotHaveAMaskChannel")
    arr = m.to(torch.float32) if isinstance(m, torch.Tensor) else \
        np.asarray(m, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return Image(arr, ImageSpec(colorspace="gray", alpha=False),
                 device=image.data.device)


def read_clip(images: List[Image]) -> List[Image]:
    """ReadCLIPImage (clip.c): rasterize the image's 8BIM clip path
    (ClipImage -> write mask); CoderError when none exists."""
    out = []
    for im in images:
        mask = _clip_path_mask(im)
        if mask is None:
            raise ValueError("CLIP read: ImageDoesNotHaveAClipMask")
        out.append(Image(mask[..., None].astype(np.float32),
                         ImageSpec(colorspace="gray", alpha=False),
                         device=im.data.device))
    return out


def _clip_path_mask(im: Image) -> Optional[np.ndarray]:
    """Rasterize the first 8BIM clip path (property '8BIM:1999,2998' or
    an SVG path stored as 'clip-path') to a (H, W) 0/1 mask on the host."""
    svg_path = None
    for key in ("clip-path", "8BIM:1999,2998:#1"):
        if key in im.properties:
            svg_path = im.properties[key]
            break
    if svg_path is None:
        prof = im.profiles.get("8bim")
        if prof is not None:
            try:
                from ..core.metadata import clip_path_from_8bim

                svg_path = clip_path_from_8bim(bytes(prof), im.width,
                                               im.height)
            except Exception:   # noqa: BLE001 — malformed resource block
                svg_path = None
    if not svg_path:
        return None
    from ..ops.draw import draw as _draw

    canvas = torch.zeros((im.height, im.width, 1), dtype=torch.float32,
                         device=im.data.device)
    mvg = f"fill white path '{svg_path}'"
    out = _draw(canvas, mvg, has_alpha=False)
    return (out[..., 0] > 0.5).to(torch.float32).cpu().numpy()


# ---------------------------------------------------------------------------
# PANGO
# ---------------------------------------------------------------------------

_PANGO_TAG = re.compile(r"</?(?:b|i|u|s|tt|big|small|sub|sup|markup|span)"
                        r"(?:\s[^>]*)?>", re.IGNORECASE)


def pango_pseudo(markup: str, width, height, settings,
                 device="cuda") -> Image:
    """pango: rich-text caption (pango.c).  Without the pango library the
    markup subset is stripped to plain text (entities decoded) and
    rendered by the caption: engine — word-wrapped to the -size box."""
    from . import pseudo

    text = _PANGO_TAG.sub("", markup)
    text = (text.replace("&lt;", "<").replace("&gt;", ">")
            .replace("&amp;", "&").replace("&quot;", '"')
            .replace("&apos;", "'"))
    return pseudo.caption(text, width, height, settings, device)


# ---------------------------------------------------------------------------
# Video write (ffmpeg delegate)
# ---------------------------------------------------------------------------

def encode_video(images: List[Image], fmt: str, fps: float = 25.0) -> bytes:
    """WriteVIDEOImage (video.c / delegates.xml.in ffmpeg encode rule):
    pipe frames as PNGs through ffmpeg image2pipe into the container."""
    import subprocess
    import tempfile

    from . import image_to_blob
    from ..core.policy import enforce_program, policy
    from .delegates import DelegateError, _which

    policy.enforce("delegate", "ffmpeg", "execute")
    enforce_program("ffmpeg")
    ffmpeg = _which("ffmpeg")
    if ffmpeg is None:
        raise DelegateError(
            f"no encode delegate for {fmt!r} (ffmpeg not installed)")
    codec = {"webm": "libvpx-vp9", "mkv": "libx264", "mp4": "libx264",
             "mov": "libx264", "avi": "mpeg4", "mpeg": "mpeg2video",
             "mpg": "mpeg2video", "wmv": "msmpeg4v3"}.get(fmt, "libx264")
    blob = b"".join(image_to_blob([im], "png") for im in images)
    with tempfile.NamedTemporaryFile(suffix=f".{fmt}") as tf:
        cmd = [ffmpeg, "-y", "-loglevel", "error", "-framerate", str(fps),
               "-f", "image2pipe", "-vcodec", "png", "-i", "-",
               "-vcodec", codec, "-pix_fmt", "yuv420p", tf.name]
        r = subprocess.run(cmd, input=blob, capture_output=True, timeout=300)
        if r.returncode != 0:
            raise DelegateError(f"ffmpeg encode failed: {r.stderr[:200]!r}")
        tf.seek(0)
        return tf.read()
