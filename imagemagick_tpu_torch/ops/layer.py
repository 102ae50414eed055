"""Image-sequence (layers/animation) ops (layer.c).

Port of ``imagemagick_tpu/ops/layer.py``: CoalesceImages, DisposeImages,
OptimizeImageLayers (frame differencing), OptimizeImageTransparency,
RemoveDuplicate/ZeroDelayLayers, CompareImagesLayers, MergeImageLayers
(flatten/mosaic), SmushImages and AppendImages.

They operate on lists of ``Image`` (frame timing and page offsets are
host metadata).  The pixels stay on the images' device: compositing and
differencing are PyTorch ops there, a changed box is cropped after one
read-back of its bounds, and smush and append fill one canvas on the
device with a copy per frame (the JAX functions build theirs in numpy on
the host).  No function changes an ``Image`` it was given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.image import Image
from .composite import composite_at


def _xy(fr: Image) -> Tuple[int, int]:
    return (fr.page[0], fr.page[1]) if fr.page else (0, 0)


def coalesce(frames: List[Image]) -> List[Image]:
    """CoalesceImages: flatten each frame onto the accumulated canvas."""
    if not frames:
        return []
    first = frames[0]
    canvas = first.data
    out = [first]
    for fr in frames[1:]:
        x, y = _xy(fr)
        canvas = composite_at(canvas, fr.data, "over", x, y, "northwest",
                              dst_alpha=first.spec.alpha,
                              src_alpha=fr.spec.alpha)
        if canvas.shape[-1] > first.spec.channels:
            canvas = canvas[..., : first.spec.channels]
        out.append(Image(canvas, first.spec, fr.properties, fr.profiles,
                         None, fr.delay))
    return out


def _changed_box(cur: torch.Tensor, prev: torch.Tensor, fuzz: float):
    """The bounding box (x0, y0, x1, y1) of the pixels of ``cur`` that
    differ from ``prev`` by more than ``fuzz`` in any channel, or None;
    one read-back for the five numbers."""
    diff = ((cur - prev).abs() > fuzz + 1e-6).any(dim=-1)
    rows, cols = diff.any(dim=1), diff.any(dim=0)
    h, w = rows.shape[0], cols.shape[0]
    first_row = torch.argmax(rows.to(torch.uint8))
    last_row = h - 1 - torch.argmax(rows.flip(0).to(torch.uint8))
    first_col = torch.argmax(cols.to(torch.uint8))
    last_col = w - 1 - torch.argmax(cols.flip(0).to(torch.uint8))
    any_, y0, y1, x0, x1 = torch.stack([
        rows.any().to(torch.int64), first_row, last_row, first_col,
        last_col]).tolist()
    return (x0, y0, x1 + 1, y1 + 1) if any_ else None


def deconstruct(frames: List[Image], fuzz: float = 0.0) -> List[Image]:
    """CompareImagesLayers / -deconstruct: keep only changed bounding
    boxes (a 1x1 frame at +0+0 where nothing changed)."""
    if len(frames) < 2:
        return list(frames)
    out = [frames[0]]
    prev = frames[0].data
    for fr in frames[1:]:
        cur = fr.data
        box = _changed_box(cur, prev, fuzz)
        if box is None:
            crop, page = cur[:1, :1], (0, 0, 1, 1)
        else:
            x0, y0, x1, y1 = box
            crop, page = cur[y0:y1, x0:x1], (x0, y0, x1 - x0, y1 - y0)
        out.append(Image(crop, fr.spec, fr.properties, fr.profiles, page,
                         fr.delay))
        prev = cur
    return out


def optimize_layers(frames: List[Image], fuzz: float = 0.0) -> List[Image]:
    """OptimizeImageLayers: coalesce then store only changed regions."""
    return deconstruct(coalesce(frames), fuzz)


def remove_duplicate_layers(frames: List[Image],
                            fuzz: float = 0.0) -> List[Image]:
    """RemoveDuplicateLayers: merge identical consecutive frames, the
    kept frame taking the dropped frames' delays.  The kept frame is a
    new Image: the caller's frames keep their delays (the JAX function
    adds them to the caller's own first frame of each run)."""
    if not frames:
        return []
    out = [frames[0]]
    for fr in frames[1:]:
        prev = out[-1]
        if prev.data.shape == fr.data.shape and bool(
                ((prev.data - fr.data).abs() <= fuzz + 1e-6).all()):
            out[-1] = Image(prev.data, prev.spec, prev.properties,
                            prev.profiles, prev.page, prev.delay + fr.delay)
        else:
            out.append(fr)
    return out


def remove_zero_delay_layers(frames: List[Image]) -> List[Image]:
    """RemoveZeroDelayLayers: drop intermediate zero-delay build frames."""
    kept = [f for f in frames if f.delay != 0]
    return kept or frames[:1]


def _canvas(height: int, width: int, c: int,
            background: Sequence[float], like: torch.Tensor
            ) -> torch.Tensor:
    """A height x width canvas of ``c`` channels in ``background``
    (padded with 1.0, opaque), on ``like``'s device."""
    bg = list(background)[:c]
    while len(bg) < c:
        bg.append(1.0)
    return torch.tensor(bg, dtype=torch.float32, device=like.device) \
        .expand(height, width, c).clone()


def flatten(frames: List[Image],
            background: Optional[Sequence[float]] = None) -> Image:
    """MergeImageLayers FlattenLayer: every frame composited at its page
    offsets onto a background-color canvas of the first frame's size
    (onto the first frame itself when no background is given)."""
    if not frames:
        raise ValueError("no frames")
    base = frames[0]
    c = base.spec.channels
    if background is not None:
        out = _canvas(base.height, base.width, c, background, base.data)
    else:
        out = base.data
        frames = frames[1:]
    for fr in frames:
        x, y = _xy(fr)
        out = composite_at(out, fr.data, "over", x, y, "northwest",
                           dst_alpha=base.spec.alpha,
                           src_alpha=fr.spec.alpha)[..., :c]
    return Image(out, base.spec, base.properties, base.profiles)


def mosaic(frames: List[Image],
           background: Optional[Sequence[float]] = None) -> Image:
    """MergeImageLayers MosaicLayer (layer.c:2020): background-color
    canvas sized to the union of page extents, every frame composited at
    its page offsets."""
    if not frames:
        raise ValueError("no frames")
    max_w = max(_xy(f)[0] + f.width for f in frames)
    max_h = max(_xy(f)[1] + f.height for f in frames)
    first = frames[0].data
    c = frames[0].spec.channels
    canvas = torch.zeros((max_h, max_w, c), dtype=first.dtype,
                         device=first.device) if background is None else \
        _canvas(max_h, max_w, c, background, first)
    for fr in frames:
        x, y = _xy(fr)
        canvas = composite_at(canvas, fr.data, "over", x, y, "northwest",
                              dst_alpha=frames[0].spec.alpha,
                              src_alpha=fr.spec.alpha)[..., :c]
    return Image(canvas, frames[0].spec)


def dispose_images(frames: List[Image]) -> List[Image]:
    """DisposeImages: render the post-disposal canvas of each frame.

    Without per-frame dispose metadata richer than 'none', this equals
    coalesce (the common GIF case)."""
    return coalesce(frames)


def optimize_transparency(frames: List[Image],
                          fuzz: float = 0.0) -> List[Image]:
    """OptimizeImageTransparency (layer.c): zero out the alpha of pixels
    identical to the previous coalesced frame, so that inter-frame
    compression sees constants."""
    if len(frames) < 2:
        return list(frames)
    co = coalesce(frames)
    out = [co[0]]
    for prev, cur in zip(co, co[1:]):
        same = ((cur.data[..., :3] - prev.data[..., :3]).abs()
                <= fuzz + 1e-6).all(dim=-1, keepdim=True)
        a = cur.data[..., 3:4] if cur.spec.alpha else \
            torch.ones_like(cur.data[..., :1])
        data = torch.cat([cur.data[..., :3], torch.where(same, 0.0, a)],
                         dim=-1)
        out.append(Image(data, cur.spec.with_(alpha=True), cur.properties,
                         cur.profiles, cur.page, cur.delay))
    return out


def _gravity_xy(img_w: int, img_h: int, canvas_w: int, canvas_h: int,
                gravity: str) -> Tuple[int, int]:
    """GravityAdjustGeometry (geometry.c:527) applied as SmushImages does:
    region starts as the whole canvas, width/height are the image's.
    Returns the (negated-at-use) region x/y — C double->long truncation."""
    g = (gravity or "northwest").lower().replace("-", "")
    x = 0
    y = 0
    if g in ("northeast", "east", "southeast"):
        x = int(float(img_w) - canvas_w)
    elif g in ("north", "south", "center", "centre"):
        x = int(float(img_w) / 2.0 - canvas_w / 2.0)
    if g in ("southwest", "south", "southeast"):
        y = int(float(img_h) - canvas_h)
    elif g in ("east", "west", "center", "centre"):
        y = int(float(img_h) / 2.0 - canvas_h / 2.0)
    return x, y


def _lead_run(alpha: torch.Tensor) -> torch.Tensor:
    """Per-column count of fully transparent (alpha == 0) leading
    pixels."""
    nz = alpha != 0.0
    first = torch.argmax(nz.to(torch.uint8), dim=0)
    return torch.where(nz.any(dim=0), first,
                       torch.full_like(first, alpha.shape[0]))


def _smush_gap(top: torch.Tensor, bot: torch.Tensor, canvas_extent: int,
               tg: int, bg: int, offset: int) -> int:
    """SmushYGap (image.c:3642) along axis 0 (callers transpose for X):
    the least over canvas columns of (trailing transparent run of the top
    image, capped rows-1) + (leading transparent run of the bottom),
    less the requested offset.  tg/bg are the gravity-adjusted geometry
    offsets that map canvas columns into each image (edge-clamped
    virtual pixels).  One read-back."""
    cols = torch.arange(canvas_extent, device=top.device)

    def col_alpha(img: torch.Tensor, gx: int) -> torch.Tensor:
        a = img[..., -1] if img.shape[-1] in (2, 4) else \
            torch.ones(img.shape[:2], dtype=img.dtype, device=img.device)
        idx = torch.clamp(cols + gx, 0, img.shape[1] - 1)
        return a[:, idx]

    ta = col_alpha(top, tg)
    ba = col_alpha(bot, bg)
    i = torch.clamp(_lead_run(ta.flip(0)), max=top.shape[0] - 1)
    j = _lead_run(ba)
    gap = min(int(bot.shape[0]), int((i + j).min()))
    return gap - offset


def _rgb_alpha(s: torch.Tensor):
    """A source's color as 3 channels and its alpha (None if opaque)."""
    rgb = s[..., :3] if s.shape[-1] >= 3 else \
        s[..., :1].repeat_interleave(3, dim=-1)
    return rgb, (s[..., -1:] if s.shape[-1] in (2, 4) else None)


def smush(frames: List[Image], stack: bool, offset: int,
          background: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
          gravity: str = "northwest") -> Image:
    """SmushImages (image.c:3706-3838).

    Adjacent images overlap by the smallest transparent gap found along
    the seam (SmushX/YGap), less ``offset``; the canvas is background-
    filled and each image is composited Over at its gravity-adjusted
    cross-axis position."""
    if not frames:
        raise ValueError("no frames")
    any_alpha = any(f.spec.alpha for f in frames)
    datas = [f.data.to(torch.float32) for f in frames]
    if stack:
        width = max(d.shape[1] for d in datas)
        height = datas[0].shape[0]
        for d in datas[1:]:
            height = max(height + d.shape[0] + offset, 0)
    else:
        height = max(d.shape[0] for d in datas)
        width = datas[0].shape[1]
        for d in datas[1:]:
            width = max(width + d.shape[1] + offset, 0)
    c = 4 if any_alpha else 3
    canvas = _canvas(height, width, c, background, datas[0])

    def over(src, x0, y0):
        sh, sw = src.shape[:2]
        xs, ys = max(x0, 0), max(y0, 0)
        xe, ye = min(x0 + sw, width), min(y0 + sh, height)
        if xe <= xs or ye <= ys:
            return
        srgb, sa = _rgb_alpha(src[ys - y0:ye - y0, xs - x0:xe - x0])
        d = canvas[ys:ye, xs:xe]
        if sa is None:          # an opaque source covers the canvas
            d[..., :3] = srgb
            if c == 4:
                d[..., 3:] = 1.0
            return
        d[..., :3] = srgb * sa + d[..., :3] * (1.0 - sa)
        if c == 4:
            d[..., 3:] = sa + d[..., 3:] * (1.0 - sa)

    x_off = y_off = 0
    geo = [_gravity_xy(d.shape[1], d.shape[0], width, height, gravity)
           for d in datas]
    for n, d in enumerate(datas):
        gx, gy = geo[n]
        if stack:
            x_off = -gx
            if n > 0:
                y_off -= _smush_gap(datas[n - 1], d, width,
                                    geo[n - 1][0], gx, offset)
        else:
            y_off = -gy
            if n > 0:
                x_off -= _smush_gap(datas[n - 1].transpose(0, 1),
                                    d.transpose(0, 1), height,
                                    geo[n - 1][1], gy, offset)
        over(d, x_off, y_off)
        if stack:
            x_off, y_off = 0, y_off + d.shape[0]
        else:
            x_off, y_off = x_off + d.shape[1], 0
    canvas = canvas[:max(y_off, 0)] if stack else canvas[:, :max(x_off, 0)]
    return Image(canvas, frames[0].spec.with_(alpha=any_alpha))


def append(frames: List[Image], stack: bool,
           background: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
           gravity: str = "northwest") -> Image:
    """AppendImages (image.c:379-560): background-filled canvas, each
    image RAW-COPIED (not composited) at its gravity-adjusted cross-axis
    offset.  stack=True appends top-to-bottom."""
    if not frames:
        raise ValueError("no frames")
    any_alpha = any(f.spec.alpha for f in frames)
    datas = [f.data.to(torch.float32) for f in frames]
    if stack:
        width = max(d.shape[1] for d in datas)
        height = sum(d.shape[0] for d in datas)
    else:
        height = max(d.shape[0] for d in datas)
        width = sum(d.shape[1] for d in datas)
    c = 4 if any_alpha else 3
    canvas = _canvas(height, width, c, background, datas[0])
    x_off = y_off = 0
    for d in datas:
        gx, gy = _gravity_xy(d.shape[1], d.shape[0], width, height, gravity)
        x0, y0 = (-gx, y_off) if stack else (x_off, -gy)
        sh, sw = d.shape[:2]
        xs, ys = max(x0, 0), max(y0, 0)
        xe, ye = min(x0 + sw, width), min(y0 + sh, height)
        if xe > xs and ye > ys:
            rgb, a = _rgb_alpha(d[ys - y0:ye - y0, xs - x0:xe - x0])
            canvas[ys:ye, xs:xe, :3] = rgb
            if c == 4:
                canvas[ys:ye, xs:xe, 3] = 1.0 if a is None else a[..., 0]
        if stack:
            y_off += sh
        else:
            x_off += sw
    all_gray = all(f.spec.colorspace == "gray" for f in frames)
    spec = frames[0].spec.with_(alpha=any_alpha)
    if not all_gray and spec.colorspace == "gray":
        spec = spec.with_(colorspace="srgb")
    if frames[0].spec.colorspace == "gray" and all_gray:
        canvas = canvas[..., :1] if c == 3 else \
            torch.cat([canvas[..., :1], canvas[..., 3:]], -1)
    return Image(canvas, spec)
