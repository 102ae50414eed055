"""Montage: thumbnail grids with labels and frames (montage.c).

Port of ``imagemagick_tpu/ops/montage.py``: MontageImageList
(montage.c:321) as a composition of the port's thumbnail (resize),
border, annotate and grid compositing, on the images' device.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from ..core.geometry import parse_geometry
from ..core.image import Image
from . import decorate
from . import resize as rz
from .composite import composite_at


def montage(images: List[Image], tile: str = "",
            geometry: str = "120x120+4+3",
            background: Sequence[float] = (1.0, 1.0, 1.0),
            border_width: int = 0, label_height: int = 0,
            shadow: bool = False) -> Image:
    """Arrange thumbnails on a grid.

    tile: 'CxR' grid shape (default: a near-square fit, like the
    reference).  geometry: each tile's thumbnail geometry 'WxH+bx+by'.
    An image's ``label`` property is drawn under its tile where
    ``label_height`` is set."""
    if not images:
        raise ValueError("montage of zero images")
    g = parse_geometry(geometry)
    tw = int(g.width or 120)
    th = int(g.height or tw)
    bx = abs(g.x) if g.x is not None else 4
    by = abs(g.y) if g.y is not None else 3

    n = len(images)
    if tile:
        tg = parse_geometry(tile)
        cols = int(tg.width or math.ceil(math.sqrt(n)))
        rows = int(tg.height or math.ceil(n / cols))
    else:
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))

    cell_w = tw + 2 * (bx + border_width)
    cell_h = th + 2 * (by + border_width) + label_height
    c = images[0].spec.channels
    dev = images[0].data.device
    fill = list(background)[:c] + [1.0] * max(0, c - len(background))
    canvas = torch.tensor(fill, dtype=torch.float32, device=dev) \
        .expand(rows * cell_h, cols * cell_w, c).clone()

    for idx, img in enumerate(images[: rows * cols]):
        r, col = divmod(idx, cols)
        # aspect-fit thumbnail
        scale = min(tw / img.width, th / img.height, 1.0)
        nw = max(int(img.width * scale), 1)
        nh = max(int(img.height * scale), 1)
        thumb = rz.thumbnail(img.data, nh, nw, has_alpha=img.spec.alpha)
        if thumb.shape[-1] < c:
            head = thumb[..., :1].repeat_interleave(min(3, c), dim=-1) \
                if thumb.shape[-1] == 1 else thumb
            pad = torch.ones(thumb.shape[:-1] + (c - thumb.shape[-1],),
                             dtype=thumb.dtype, device=thumb.device)
            thumb = torch.cat([head, pad], dim=-1)[..., :c]
        elif thumb.shape[-1] > c:
            thumb = thumb[..., :c]
        if border_width:
            thumb = decorate.border(thumb, border_width, border_width)
        # center in the cell
        ox = col * cell_w + (cell_w - thumb.shape[-2]) // 2
        oy = r * cell_h + (cell_h - label_height - thumb.shape[-3]) // 2
        canvas = composite_at(canvas, thumb, "over", ox, oy, "northwest",
                              dst_alpha=c in (2, 4),
                              src_alpha=c in (2, 4))[..., :c]
        label = img.properties.get("label")
        if label and label_height:
            from .draw import annotate

            canvas = annotate(canvas, str(label), x=col * cell_w + 4,
                              y=r * cell_h + cell_h - label_height + 2,
                              color=(0, 0, 0, 1),
                              size=max(label_height - 6, 8))
    return Image(canvas, images[0].spec)
