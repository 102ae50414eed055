"""MPC, the Magick Persistent Cache: a checkpoint that reads back without
decoding (coders/mpc.c, PersistPixelCache in cache.c).

Port of ``imagemagick_tpu/io/mpc.py``, byte for byte the same file: an
8-byte magic, the length of a JSON header (8 bytes, little-endian), the
header (each frame's shape, offset, colorspace, alpha, depth, simple
properties, page and delay), then every frame's float32 samples.  A read
maps the file and moves each frame's samples to ``device`` as they lie
(the card unless the caller asks for the CPU): no parsing and no
dequantization, one host copy.  Both ends name a host file, so ``core.policy.
enforce_path`` guards them (``no_host_files`` refuses them).
"""

from __future__ import annotations

import json
import mmap
from typing import List

import numpy as np

from ..core.image import Image
from ..core.policy import enforce_path
from ..core.spec import ImageSpec

_MAGIC = b"TPUMPC01"


def write_mpc(images, path: str) -> None:
    """Write one image or a list to ``path``; the pixels come to the host
    once an image."""
    enforce_path(path)
    if isinstance(images, Image):
        images = [images]
    header = {"frames": []}
    offset = 0
    payloads = []
    for im in images:
        arr = np.ascontiguousarray(im.to_numpy(), np.float32)
        header["frames"].append({
            "shape": list(arr.shape),
            "offset": offset,
            "colorspace": im.spec.colorspace,
            "alpha": im.spec.alpha,
            "depth": im.spec.depth,
            "properties": {k: v for k, v in im.properties.items()
                           if isinstance(v, (str, int, float))},
            "page": list(im.page) if im.page else None,
            "delay": im.delay,
        })
        payloads.append(arr)
        offset += arr.nbytes
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for arr in payloads:
            f.write(arr.tobytes())


def read_mpc(path: str, device="cuda") -> List[Image]:
    """The frames of the MPC file ``path``, each on ``device``."""
    enforce_path(path)
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError("not a TPU-MPC file")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
        base = f.tell()
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    out = []
    try:
        for fr in header["frames"]:
            shape = tuple(fr["shape"])
            n = int(np.prod(shape))
            # a copy: the mapping is closed below, and torch takes no
            # read-only buffer
            arr = np.frombuffer(mm, np.float32, count=n,
                                offset=base + fr["offset"]).reshape(shape)
            arr = arr.copy()
            out.append(Image(arr, ImageSpec(colorspace=fr["colorspace"],
                                            alpha=fr["alpha"],
                                            depth=fr["depth"]),
                             properties=fr.get("properties") or {},
                             page=tuple(fr["page"]) if fr.get("page")
                             else None,
                             delay=fr.get("delay", 0), device=device))
    finally:
        mm.close()
    return out
