"""Raw sample coders: gray:, rgb:, rgba:, bgr:, bgra:, cmyk:, ycbcr:.

Port of ``decode_raw`` and ``encode_raw`` of
``imagemagick_tpu/io/extra_coders.py`` (ImageMagick's coders/gray.c and
rgb.c): headerless samples at any quantum depth, which need ``-size``.
The samples are parsed and packed on the host with ``utils/quantum.py``;
the color conversions of ``cmyk:`` and ``ycbcr:`` run on the image's
device.  The module's other coders (farbfeld, XBM, XPM, sixel, SVG) are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.image import Image
from ..core.spec import ImageSpec


def _on_device(fn, arr: np.ndarray, device) -> np.ndarray:
    """``fn`` of host pixels on ``device``, back on the host."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    return fn(x).cpu().numpy()


def decode_raw(data: bytes, fmt: str, width: int, height: int,
               depth: Optional[int] = None, device="cuda") -> Image:
    nch = {"gray": 1, "rgb": 3, "rgba": 4, "bgr": 3, "bgra": 4,
           "cmyk": 4, "ycbcr": 3}[fmt]
    if depth is None:  # infer from payload size
        depth = 16 if len(data) >= width * height * nch * 2 else 8
    from ..utils.quantum import import_quantum

    f = import_quantum(data, width, height, nch, depth)
    if fmt in ("bgr", "bgra"):
        f = f[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    cs = {"gray": "gray", "cmyk": "cmyk", "ycbcr": "ycbcr"}.get(fmt, "srgb")
    return Image(f, ImageSpec(colorspace=cs, alpha=fmt in ("rgba", "bgra")),
                 device=device)


def encode_raw(img: Image, fmt: str, depth: int = 8) -> bytes:
    arr = img.to_numpy()
    nch = {"gray": 1, "rgb": 3, "rgba": 4, "bgr": 3, "bgra": 4,
           "cmyk": 4, "ycbcr": 3, "uyvy": 3}[fmt]
    if fmt == "gray" and arr.shape[-1] > 1:
        arr = arr.mean(-1, keepdims=True)
    if arr.shape[-1] < nch:
        if arr.shape[-1] >= 3:        # RGB -> RGBA/CMYK: append opaque
            arr = np.concatenate([arr[..., :3],
                                  np.ones_like(arr[..., :1])], -1)[..., :nch]
        else:                          # gray -> expand channels
            arr = np.concatenate([np.repeat(arr[..., :1], 3, -1),
                                  np.ones_like(arr[..., :1])], -1)[..., :nch]
    arr = arr[..., :nch]
    if fmt == "bgr":
        arr = arr[..., ::-1]
    elif fmt == "bgra":
        arr = np.concatenate([arr[..., 2::-1], arr[..., 3:4]], -1)
    elif fmt == "cmyk":
        from ..ops.colorspace import rgb_to_cmyk
        arr = _on_device(rgb_to_cmyk, arr[..., :3], img.data.device)
    elif fmt in ("ycbcr", "uyvy"):
        from ..ops.colorspace import rgb_to_ycbcr
        arr = _on_device(rgb_to_ycbcr, arr[..., :3], img.data.device)
        if fmt == "uyvy":
            # 4:2:2: pairs of pixels share chroma -> U Y0 V Y1 bytes
            h2, w2, _ = arr.shape
            if w2 % 2:
                arr = arr[:, :w2 - 1]
                w2 -= 1
            y = arr[..., 0]
            cb = arr[:, 0::2, 1]
            cr = arr[:, 0::2, 2]
            out = np.zeros((h2, w2 * 2), np.float32)
            out[:, 0::4] = cb
            out[:, 1::4] = y[:, 0::2]
            out[:, 2::4] = cr
            out[:, 3::4] = y[:, 1::2]
            return (np.clip(out, 0, 1) * 255.0 + 0.5).astype(np.uint8).tobytes()
    from ..utils.quantum import export_quantum

    # full quantum wire-format breadth: 1/2/4/8/16/32-bit, MSB default
    return export_quantum(arr, depth)
