"""Glue helpers for the Magick++ compatibility layer (native/magickpp).

Port of ``imagemagick_tpu/wand/cpp_support.py``.  The embedded C++ binding
(``native/magickpp/magickpp.cpp``) keeps its dispatch thin: anything
needing geometry resolution, host staging, or multi-call sequences lands
here instead of being spelled out in C API calls.  Mirrors the roles of
Magick++/lib/Image.cpp's option plumbing around MagickCore calls.

Pixels stay on the wand's device: the bodies that the JAX module writes
in ``jnp`` are torch ops on the image's tensor, and a wand made here (a
sequence read, split or morph) lands on the device of the wand it came
from, or on the ``device`` the caller names (the library's).  What goes
back to C++ as numbers (statistics, moments, the perceptual hash, a
search score) is read back to the host here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import color as core_color
from ..core import geometry as geo
from ..core.image import host_property as _host


def parse_color_rgba(name: str) -> Tuple[float, float, float, float]:
    r, g, b, a = core_color.parse_color(name)
    return float(r), float(g), float(b), float(a)


def resolve_meta_geometry(wand, geometry: str) -> Tuple[int, int, int, int]:
    """ParseMetaGeometry against the wand's current image dims."""
    w, h, x, y = geo.parse_meta_geometry(
        geometry, wand.get_image_width(), wand.get_image_height())
    return int(w), int(h), int(x), int(y)


def parse_geometry_raw(geometry: str) -> Tuple[int, int, int, int]:
    g = geo.parse_geometry(geometry)
    return (int(g.width or 0), int(g.height or 0), int(g.x or 0),
            int(g.y or 0))


def gravity_offset(gravity: str, bg_w: int, bg_h: int, fg_w: int,
                   fg_h: int) -> Tuple[int, int]:
    """Top-left placement offset for a gravity name (GravityAdjustGeometry)."""
    g = (gravity or "undefined").lower()
    if "west" in g:
        x = 0
    elif "east" in g:
        x = bg_w - fg_w
    elif g in ("center", "north", "south"):
        x = (bg_w - fg_w) // 2
    else:
        x = 0
    if "north" in g:
        y = 0
    elif "south" in g:
        y = bg_h - fg_h
    elif g in ("center", "west", "east"):
        y = (bg_h - fg_h) // 2
    else:
        y = 0
    return int(x), int(y)


def composite_gravity(wand, src_wand, operator: str, gravity: str):
    old = wand.gravity
    try:
        wand.gravity = gravity
        wand.composite_image(src_wand, operator, 0, 0)
    finally:
        wand.gravity = old


def extent_gravity(wand, width: int, height: int, gravity: str,
                   background: str = None):
    """MagickExtentImage with gravity-resolved offsets."""
    x, y = gravity_offset(gravity, width, height, wand.get_image_width(),
                          wand.get_image_height())
    if background is not None:
        old = wand.background
        from .api import PixelWand

        wand.background = PixelWand(background)
        try:
            wand.extent_image(width, height, -x, -y)
        finally:
            wand.background = old
    else:
        wand.extent_image(width, height, -x, -y)


def annotate(wand, text: str, geometry: str, gravity: str,
             pointsize: float, font: str):
    """Gravity/offset-aware text annotation (Magick++ Image::annotate)."""
    W, H = wand.get_image_width(), wand.get_image_height()
    x, y = 0, 0
    if geometry:
        g = geo.parse_geometry(geometry)
        x, y = int(g.x or 0), int(g.y or 0)
    m = wand.query_font_metrics(None, text)
    tw = int(m.get("width", pointsize * len(text) * 0.6))
    th = int(m.get("height", pointsize))
    gx, gy = gravity_offset(gravity or "northwest", W, H, tw, th)
    old_ps, old_font = wand.pointsize, wand.font
    try:
        wand.pointsize = pointsize
        if font:
            wand.font = font
        wand.annotate_image(None, gx + x, gy + y + th * 0.8, 0.0, text)
    finally:
        wand.pointsize, wand.font = old_ps, old_font


def bounding_box(wand) -> Tuple[int, int, int, int]:
    from ..ops import attribute as attr

    x0, y0, w, h = attr.bounding_box(wand.current.data, fuzz=wand.fuzz)
    return int(w), int(h), int(x0), int(y0)


def export_rgba_f32(wand, x: int, y: int, width: int, height: int) -> bytes:
    arr = wand.export_image_pixels(x, y, width, height, "RGBA", "float")
    return np.ascontiguousarray(_host(arr), dtype=np.float32).tobytes()


def import_rgba_f32(wand, x: int, y: int, width: int, height: int,
                    buf: bytes):
    arr = np.frombuffer(buf, dtype=np.float32).reshape(height, width, 4)
    wand.import_image_pixels(x, y, width, height, "RGBA", arr)


def export_map(wand, storage: str, channel_map: str) -> bytes:
    arr = wand.export_image_pixels(0, 0, wand.get_image_width(),
                                   wand.get_image_height(), channel_map,
                                   storage)
    return np.ascontiguousarray(_host(arr)).tobytes()


def import_map(wand, storage: str, channel_map: str, buf: bytes):
    dtype = {"char": np.uint8, "uint8": np.uint8, "short": np.uint16,
             "uint16": np.uint16, "float": np.float32,
             "double": np.float64}[storage]
    w, h = wand.get_image_width(), wand.get_image_height()
    arr = np.frombuffer(buf, dtype=dtype).reshape(h, w, len(channel_map))
    wand.import_image_pixels(0, 0, w, h, channel_map, arr)


def compare_stats(wand, ref_wand) -> Tuple[float, float, float]:
    """(meanErrorPerPixel, normalizedMeanError, normalizedMaxError)."""
    mae = wand.get_image_distortion(ref_wand, "mae")
    mse = wand.get_image_distortion(ref_wand, "mse")
    pae = wand.get_image_distortion(ref_wand, "pae")
    return float(mae * 65535.0), float(mse), float(pae)


def convolve(wand, order: int, csv: str):
    vals = [float(v) for v in csv.split(",") if v.strip()]
    kernel = [vals[r * order:(r + 1) * order] for r in range(order)]
    wand.convolve_image(kernel)


def color_matrix(wand, order: int, csv: str):
    vals = [float(v) for v in csv.split(",") if v.strip()]
    matrix = [vals[r * order:(r + 1) * order] for r in range(order)]
    wand.color_matrix_image(matrix)


def distort(wand, method: str, csv: str, bestfit: bool):
    args = [float(v) for v in csv.split(",") if v.strip()]
    wand.distort_image(method, args, bestfit)


def affine_transform(wand, csv: str):
    vals = [float(v) for v in csv.split(",") if v.strip()]
    wand.affine_transform_image(vals)


def gamma_rgb(wand, r: float, g: float, b: float):
    """Per-channel gamma (GammaImage channel form).  The exponents are the
    JAX module's float32 reciprocals; the power is taken in float64 and
    rounded, so the card's float32 ``powf``, an ulp from the CPU's, moves
    no sample."""
    img = wand.current
    data = img.data
    nc = min(3, data.shape[-1])
    inv = 1.0 / np.asarray([r, g, b], np.float32)[:nc]
    safe = torch.clamp(data[..., :nc], min=1e-12).to(torch.float64)
    out = data.clone()
    out[..., :nc] = torch.pow(
        safe, torch.tensor(inv, dtype=torch.float64,
                           device=data.device)).to(data.dtype)
    wand._set_current(img.replace(data=out))


def merge_layers(wand, method: str):
    """In-place flatten/merge (Magick++ has no multi-wand return)."""
    merged = wand.merge_image_layers(method)
    wand.images = merged.images
    wand.iterator = 0


def set_setting(wand, key: str, value: str):
    wand.settings[key] = value


def image_region_colors(wand) -> int:
    return int(wand.get_image_colors())


def stegano(wand, watermark_wand, offset: int = 0):
    out = wand.stegano_image(watermark_wand, offset)
    wand.images = out.images
    wand.iterator = 0


def stereo(wand, right_wand):
    out = wand.stereo_image(right_wand)
    wand.images = out.images
    wand.iterator = 0


def texture(wand, texture_wand):
    out = wand.texture_image(texture_wand)
    wand.images = out.images
    wand.iterator = 0


def connected_components(wand, connectivity: int):
    wand.connected_components_image(connectivity)


def ping(wand, filename: str):
    """Lightweight metadata read (MagickPingImage analog)."""
    wand.ping_image(filename)


# -- multi-image sequence helpers (Magick++ STL.h role) --

def _single(img, device):
    """A wand on ``device`` holding one image."""
    from .api import MagickWand

    w = MagickWand(device)
    w.images = [img]
    w.iterator = 0
    return w


def seq_read(filename: str, device="cuda"):
    """Read a multi-frame file into one single-image wand per frame, each
    on ``device`` (the library's)."""
    from .api import MagickWand

    src = MagickWand(device)
    src.read_image(filename)
    return [_single(img, src.device) for img in src.images]


def _gather(wands, device="cuda"):
    """One wand holding every image of ``wands``, on the first wand's
    device (``device`` for an empty list)."""
    from .api import MagickWand

    merged = MagickWand(wands[0].device if wands else device)
    for w in wands:
        merged.images.extend(w.images)
    merged.iterator = len(merged.images) - 1
    if wands:
        merged.quality = wands[0].quality
    return merged


def seq_write(wands, filename: str, adjoin: bool = True, quality: int = 92):
    merged = _gather(wands)
    merged.quality = quality
    merged.write_images(filename, adjoin=adjoin)


def seq_append(wands, stack: bool):
    return _gather(wands).append_images(top_to_bottom=stack)


def seq_average(wands):
    return _gather(wands).evaluate_images("mean")


def seq_flatten(wands):
    return _gather(wands).merge_image_layers("flatten")


def seq_mosaic(wands):
    return _gather(wands).merge_image_layers("mosaic")


def seq_coalesce(wands):
    merged = _gather(wands).coalesce_images()
    return seq_split(merged)


def seq_deconstruct(wands):
    merged = _gather(wands).deconstruct_images()
    return seq_split(merged)


def seq_split(wand):
    return [_single(img, wand.device) for img in wand.images]


def seq_morph(wands, frames: int):
    """MorphImages: linear interpolation between adjacent frames."""
    from .api import MagickWand

    merged = _gather(wands)
    imgs = merged.images
    out = []
    for a, b in zip(imgs, imgs[1:]):
        out.append(a)
        if a.data.shape != b.data.shape:
            continue
        for i in range(1, frames + 1):
            t = i / (frames + 1)
            out.append(a.replace(
                data=(1 - t) * a.data + t * b.data.to(a.data.device)))
    if imgs:
        out.append(imgs[-1])
    w = MagickWand(merged.device)
    w.images = out
    w.iterator = 0
    return w


def seq_montage(wands, tile: str = "", geometry: str = "120x120+4+3"):
    merged = _gather(wands)
    return merged.montage_image(tile=tile, thumbnail_geometry=geometry)


# -- services exposed to the C++ layer (ResourceLimits / CoderInfo) --

def get_resource_limit(name: str) -> float:
    from ..core.resource import resources

    return float(resources.get_limit(name))


def set_resource_limit(name: str, value: float):
    from ..core.resource import resources

    resources.set_limit(name, value)


def coder_list() -> list:
    """[(format, readable, writable), ...] for CoderInfo queries."""
    from .. import io as iio

    r = set(iio.supported_read_formats())
    w = set(iio.supported_write_formats())
    return [(f, f in r, f in w) for f in sorted(r | w)]


# -- channel-scoped op application (Magick++ *Channel method variants) --

_CHANNEL_IDX = {"red": 0, "cyan": 0, "gray": 0, "green": 1, "magenta": 1,
                "blue": 2, "yellow": 2, "black": 3, "alpha": -1,
                "opacity": -1}


def apply_channel(wand, channel: str, method: str, *args):
    """Run a whole-image wand op, then keep only the named channels'
    results (ChannelType scoping, channel.c semantics for shape-preserving
    ops)."""
    img = wand.current
    before = img.data
    getattr(wand, method)(*args)
    cur = wand.current
    after = cur.data
    if after.shape != before.shape:
        return  # geometry-changing op: scoping is meaningless
    names = channel.lower().replace(",", " ").split()
    nc = before.shape[-1]
    if any(n in ("all", "default", "rgb", "rgba") for n in names):
        return
    keep = sorted({_CHANNEL_IDX[n] % nc for n in names if n in _CHANNEL_IDX})
    data = before.clone()
    for c in keep:
        data[..., c] = after[..., c]
    wand._set_current(cur.replace(data=data))


# -- round-2 widening: attribute/op helpers for the full Image surface --

def erase(wand):
    """SetImage to the background color (Magick++ Image::erase)."""
    img = wand.current
    bgobj = wand.get_image_background_color()
    if bgobj is None:
        bg = (1.0, 1.0, 1.0, 1.0)
    elif hasattr(bgobj, "_rgba"):
        bg = tuple(float(v) for v in bgobj._rgba)
    else:
        bg = parse_color_rgba(str(bgobj))
    nc = img.data.shape[-1]
    vals = (list(bg[:3]) + [bg[3]])[:nc] if nc >= 3 else [bg[0]] * nc
    fill = torch.tensor(np.asarray(vals, np.float32), device=img.data.device)
    wand._set_current(img.replace(
        data=fill.expand(img.data.shape).clone()))


def is_opaque(wand) -> bool:
    img = wand.current
    if not img.spec.alpha:
        return True
    return bool(float(img.data[..., -1].min()) >= 1.0 - 1e-6)


def transparent_chroma(wand, low: str, high: str, alpha: float = 0.0,
                       invert: bool = False):
    """TransparentPaintImageChroma: alpha for pixels inside [low, high]^3."""
    img = wand.current
    dev = img.data.device
    lo = torch.tensor(np.asarray(parse_color_rgba(low)[:3], np.float32),
                      device=dev)
    hi = torch.tensor(np.asarray(parse_color_rgba(high)[:3], np.float32),
                      device=dev)
    rgb = img.data[..., :3]
    inside = ((rgb >= lo) & (rgb <= hi)).all(-1)
    if invert:
        inside = ~inside
    if not img.spec.alpha:
        wand.set_image_alpha_channel("set")
        img = wand.current
    data = img.data.clone()
    data[..., -1] = torch.where(
        inside, torch.tensor(np.float32(alpha), device=dev), data[..., -1])
    wand._set_current(img.replace(data=data))


def copy_pixels(wand, src_wand, geometry: str, ox: int, oy: int):
    """CopyImagePixels: replace the region at (ox,oy) with src's region."""
    w, h, sx, sy = parse_geometry_raw(geometry)
    img = wand.current
    src = src_wand.current
    w = min(w or src.data.shape[-2], img.data.shape[-2] - ox,
            src.data.shape[-2] - sx)
    h = min(h or src.data.shape[-3], img.data.shape[-3] - oy,
            src.data.shape[-3] - sy)
    if w <= 0 or h <= 0:
        return
    patch = src.data[..., sy:sy + h, sx:sx + w, :].to(img.data.device)
    nc = img.data.shape[-1]
    if patch.shape[-1] != nc:
        if patch.shape[-1] == 1:
            patch = patch.expand(patch.shape[:-1] + (nc,))
        else:
            patch = patch[..., :nc]
    data = img.data.clone()
    data[..., oy:oy + h, ox:ox + w, :] = patch
    wand._set_current(img.replace(data=data))


def format_expression(wand, expr: str) -> str:
    from ..core.properties import interpret

    return interpret(expr, wand.current, filename=wand.get_filename() or "")


def statistics(wand):
    """Flat per-channel stats rows: (name, mean, std, min, max, variance,
    skewness, kurtosis, entropy, sum) — composite row last."""
    from ..ops import statistic as stx

    img = wand.current
    st = {k: _host(v) for k, v in stx.get_statistics(img.data).items()}
    names = {1: ["gray"], 2: ["gray", "alpha"],
             3: ["red", "green", "blue"],
             4: (["red", "green", "blue", "alpha"]
                 if img.spec.colorspace != "cmyk" else
                 ["cyan", "magenta", "yellow", "black"]),
             5: ["cyan", "magenta", "yellow", "black", "alpha"]}.get(
                 img.data.shape[-1], ["gray"])
    rows = []
    for i, nm in enumerate(names):
        rows.append((nm, float(st["mean"][i]), float(st["std"][i]),
                     float(st["min"][i]), float(st["max"][i]),
                     float(st["variance"][i]), float(st["skewness"][i]),
                     float(st["kurtosis"][i]), float(st["entropy"][i]),
                     float(st["sum"][i])))
    comp = tuple(float(np.mean([r[j] for r in rows]))
                 for j in range(1, 10))
    rows.append(("composite",) + comp)
    return rows


def moments(wand):
    """Per-channel rows: (name, centroid_x, centroid_y, m00, hu1..hu8)."""
    from ..ops import statistic as stx

    img = wand.current
    mom = stx.get_moments(img.data)
    cx, cy = (_host(v) for v in mom["centroid"])
    inv = _host(mom["invariants"])    # (8, C)
    m00 = _host(mom["m00"])
    nch = img.data.shape[-1]
    names = ["red", "green", "blue", "alpha", "meta"][:nch] \
        if nch > 1 else ["gray"]
    rows = []
    for i, nm in enumerate(names):
        rows.append((nm, float(cx[i]), float(cy[i]), float(m00[i]),
                     *[float(inv[j, i]) for j in range(8)]))
    return rows


def perceptual_hash(wand):
    """42 floats: 2 colorspaces x 8 Hu x up-to-3 channels, flattened."""
    from ..ops import statistic as stx

    ph = _host(stx.perceptual_hash(wand.current.data))
    return [float(v) for v in ph.reshape(-1)]


def type_metrics(wand, text: str, multiline: bool = False):
    """(ascent, descent, text_width, text_height, max_advance) via the
    annotate machinery (Magick++ fontTypeMetrics; annotate.c:680)."""
    from ..ops.draw import get_type_metrics

    size = float(wand.get_pointsize() or 12.0)
    if multiline:
        lines = text.split("\n") or [""]
        ms = [get_type_metrics(ln, size=size) for ln in lines]
        return (ms[0]["ascent"], ms[0]["descent"],
                max(m["width"] for m in ms),
                sum(m["height"] for m in ms), ms[0]["max_advance"])
    m = get_type_metrics(text, size=size)
    return (m["ascent"], m["descent"], m["width"], m["height"],
            m["max_advance"])


def identify_type(wand) -> str:
    from ..ops import attribute as attr

    img = wand.current
    return attr.image_type(img.data, img.spec.alpha)


def channel_count(wand) -> int:
    return int(wand.current.data.shape[-1])


def display(wand):
    """In-terminal sixel preview when attached to a TTY (or with
    ``IMTPU_SIXEL`` set, as for the CLI's ``display``); silent no-op
    otherwise (the reference blocks on an X server here)."""
    import os
    import sys

    if not (sys.stdout.isatty() or os.environ.get("IMTPU_SIXEL")):
        return
    from ..io.extra_coders import encode_sixel

    sys.stdout.buffer.write(encode_sixel(wand.current))
    sys.stdout.buffer.flush()


def sub_image_search(wand, ref_wand):
    """(x, y, ncc_score) of the best template match (SimilarityImage)."""
    from ..ops import compare as cmp_ops

    (y, x), corr = cmp_ops.similarity_image(wand.current.data,
                                            ref_wand.current.data)
    score = float(corr[..., int(y), int(x)])
    return (int(x), int(y), score)


def sparse_color_flat(wand, method: str, args):
    """SparseColor from a flat [x,y,c1..cN,...] argument vector (the
    Magick++ double* calling convention)."""
    img = wand.current
    nch = img.data.shape[-1]
    group = 2 + nch
    pts = []
    vals = list(args)
    for i in range(0, len(vals) - group + 1, group):
        x, y = vals[i], vals[i + 1]
        pts.append((x, y, tuple(vals[i + 2:i + group])))
    from ..ops import distort as dt

    wand._apply(lambda im: dt.sparse_color(im.data, method, pts))
