"""The MASK and CLIP coders (coders/mask.c, coders/clip.c).

Port of ``read_mask``, ``write_mask_image``, ``read_clip`` and
``_clip_path_mask`` of ``imagemagick_tpu/io/coders_r4.py``.  A mask is
kept, as in the JAX package, as the image property ``wand:mask``: an
(H, W) array on the host.  The clip path is rasterized by the port's
``ops/draw.py`` on the image's device.  The module's other coders (ORA,
kernel:, pango:, video) are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.image import Image
from ..core.spec import ImageSpec


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
    arr = np.asarray(m, np.float32)
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
