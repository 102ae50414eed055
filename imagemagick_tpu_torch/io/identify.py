"""Structured identify output (identify.c / coders/json.c).

Port of ``imagemagick_tpu/io/identify.py``: the verbose identify
description (MagickCore/identify.c) and the json: coder (coders/json.c).
The statistics, the color count and the type come from the port's
``ops/statistic.py``, ``ops/histogram.py`` and ``ops/attribute.py`` on
the image's device; the medians, depths and overall statistics from the
pixels on the host, in numpy, as in the JAX module.  Full image state including
per-channel statistics and depths, overall statistics, colors, gamma/
chromaticity, page/compose/dispose/compression attributes, properties,
and the pixel signature, in the reference's -verbose field order.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..core.image import host_property

_Q = 65535.0   # Q16 quantum scale for display (magick-type.h)


def describe(image, filename: str = "", verbose: bool = False) -> str:
    """IdentifyImage one-line / verbose text."""
    w, h = image.width, image.height
    fmt = image.properties.get(
        "format", os.path.splitext(filename)[1].lstrip(".").upper() or "MIFF")
    base = (f"{filename} {fmt} {w}x{h} {w}x{h}+0+0 "
            f"{image.spec.depth}-bit {image.spec.colorspace}")
    if not verbose:
        return base
    info = as_dict(image, filename)
    page = getattr(image, "page", None) or {}
    pw = page.get("width", w) if isinstance(page, dict) else w
    ph = page.get("height", h) if isinstance(page, dict) else h
    px = page.get("x", 0) if isinstance(page, dict) else 0
    py = page.get("y", 0) if isinstance(page, dict) else 0
    props = image.properties

    def q(v):   # "quantum (normalized)" display like identify.c
        return f"{v * _Q:.6g} ({v:.6g})"

    lines = ["Image:", f"  Filename: {filename}", f"  Format: {fmt}",
             "  Class: DirectClass",
             f"  Geometry: {w}x{h}+0+0"]
    if "resolution" in props:
        rx, ry = props["resolution"]
        lines.append(f"  Resolution: {rx:g}x{ry:g}")
    lines += ["  Units: " + props.get("units", "Undefined"),
             f"  Colorspace: {info['colorspace']}",
             f"  Type: {info['type']}",
             "  Endianness: " + props.get("endian", "Undefined"),
             f"  Depth: {image.spec.depth}-bit",
             f"  Channels: {info['channels']}.0"]
    lines.append("  Channel depth:")
    for ch, d in info["channelDepth"].items():
        lines.append(f"    {ch}: {d}-bit")
    lines.append("  Channel statistics:")
    lines.append(f"    Pixels: {w * h}")
    for ch in info["channelStatistics"]:
        s = info["channelStatistics"][ch]
        lines.append(f"    {ch.capitalize()}:")
        lines.append(f"      min: {q(s['min'])}")
        lines.append(f"      max: {q(s['max'])}")
        lines.append(f"      mean: {q(s['mean'])}")
        lines.append(f"      median: {q(s['median'])}")
        lines.append(
            f"      standard deviation: {q(s['standardDeviation'])}")
        lines.append(f"      kurtosis: {s['kurtosis']:.6g}")
        lines.append(f"      skewness: {s['skewness']:.6g}")
        lines.append(f"      entropy: {s['entropy']:.6g}")
    if len(info["channelStatistics"]) > 1:
        o = info["overallStatistics"]
        lines.append("  Image statistics:")
        lines.append("    Overall:")
        lines.append(f"      min: {q(o['min'])}")
        lines.append(f"      max: {q(o['max'])}")
        lines.append(f"      mean: {q(o['mean'])}")
        lines.append(f"      median: {q(o['median'])}")
        lines.append(
            f"      standard deviation: {q(o['standardDeviation'])}")
        lines.append(f"      kurtosis: {o['kurtosis']:.6g}")
        lines.append(f"      skewness: {o['skewness']:.6g}")
        lines.append(f"      entropy: {o['entropy']:.6g}")
    if info["colors"] <= 1024:
        lines.append(f"  Colors: {info['colors']}")
    lines.append("  Rendering intent: "
                 + props.get("rendering-intent", "Perceptual"))
    lines.append(f"  Gamma: {info['gamma']:.6g}")
    lines.append("  Chromaticity:")
    for name, xy in info["chromaticity"].items():
        lines.append(f"    {name}: ({xy[0]:.6g},{xy[1]:.6g})")
    lines.append("  Matte color: " + props.get("matte-color", "grey74"))
    lines.append("  Background color: "
                 + props.get("background-color", "white"))
    lines.append("  Border color: " + props.get("border-color", "srgb(223,223,223)"))
    lines.append("  Transparent color: "
                 + props.get("transparent-color", "none"))
    lines.append("  Interlace: " + props.get("interlace", "None"))
    lines.append("  Intensity: Undefined")
    lines.append("  Compose: " + props.get("compose", "Over"))
    lines.append(f"  Page geometry: {pw}x{ph}{px:+d}{py:+d}")
    lines.append("  Dispose: " + props.get("dispose", "Undefined"))
    lines.append("  Iterations: " + str(props.get("iterations", 0)))
    lines.append("  Compression: " + props.get("compression", "Undefined"))
    lines.append("  Orientation: " + props.get("orientation", "Undefined"))
    shown = {"format", "units", "endian", "rendering-intent", "matte-color",
             "background-color", "border-color", "transparent-color",
             "interlace", "compose", "dispose", "iterations", "compression",
             "orientation"}
    extra = {k: v for k, v in props.items() if k not in shown}
    if extra or True:
        lines.append("  Properties:")
        for k in sorted(extra):
            lines.append(f"    {k}: {host_property(extra[k])}")
        lines.append(f"    signature: {info['signature']}")
    npx = w * h
    lines.append("  Tainted: False")
    lines.append(f"  Number pixels: {npx}")
    lines.append("  Version: imagemagick_tpu_torch (ImageMagick-compatible, "
                 "PyTorch and CUDA)")
    return "\n".join(lines)


def as_dict(image, filename: str = "") -> Dict:
    """json: coder payload (coders/json.c EncodeImageAttributes analog)."""
    from ..ops import attribute as attr
    from ..ops import histogram as hg
    from ..ops import statistic as stx
    from ..utils.signature import signature_image

    stats = {k: v.detach().cpu().numpy()
             for k, v in stx.get_statistics(image.data).items()}
    arr = image.to_numpy()
    if arr.ndim == 4:
        arr = arr[0]
    names = _channel_names(image)
    chstats = {}
    chdepth = {}
    for i, name in enumerate(names):
        ch = arr[..., i]
        med = float(np.median(ch))
        chstats[name] = {
            "min": float(stats["min"][i]),
            "max": float(stats["max"][i]),
            "mean": float(stats["mean"][i]),
            "median": med,
            "standardDeviation": float(stats["std"][i]),
            "skewness": float(stats["skewness"][i]),
            "kurtosis": float(stats["kurtosis"][i]),
            "entropy": float(stats["entropy"][i]),
        }
        chdepth[name] = _channel_depth(ch)
    flat = arr.reshape(-1, arr.shape[-1])
    overall = {
        "min": float(flat.min()),
        "max": float(flat.max()),
        "mean": float(flat.mean()),
        "median": float(np.median(flat)),
        "standardDeviation": float(flat.std()),
        "skewness": float(np.mean([chstats[n]["skewness"] for n in names])),
        "kurtosis": float(np.mean([chstats[n]["kurtosis"] for n in names])),
        "entropy": float(np.mean([chstats[n]["entropy"] for n in names])),
    }
    cs = image.spec.colorspace
    gamma = 1.0 if cs in ("rgb", "xyz", "lab", "linear_gray") else 1 / 2.2
    return {
        "name": filename,
        "format": image.properties.get("format", "MIFF"),
        "geometry": {"width": image.width, "height": image.height,
                     "x": 0, "y": 0},
        "colorspace": cs,
        "type": attr.image_type(image.data, image.spec.alpha),
        "depth": image.spec.depth,
        "channels": len(names),
        "channelDepth": chdepth,
        "alpha": image.spec.alpha,
        "colors": int(hg.number_colors(image.data)),
        "channelStatistics": chstats,
        "overallStatistics": overall,
        "gamma": gamma,
        "chromaticity": {
            "red primary": (0.64, 0.33), "green primary": (0.3, 0.6),
            "blue primary": (0.15, 0.06), "white point": (0.3127, 0.329)},
        "signature": signature_image(image.data),
        "properties": {k: host_property(v)
                       for k, v in image.properties.items()},
    }


def _channel_depth(ch: np.ndarray) -> int:
    """Smallest depth in {1,8,16} that represents the channel exactly
    (GetImageDepth semantics)."""
    q8 = np.round(ch * 255.0) / 255.0
    if np.allclose(ch, np.round(ch)):
        return 1
    if np.allclose(ch, q8, atol=0.5 / 65535.0):
        return 8
    return 16


def to_json(image, filename: str = "") -> str:
    return json.dumps({"image": as_dict(image, filename)}, indent=2)


def _channel_names(image):
    cs = image.spec.colorspace
    if cs in ("gray", "linear_gray"):
        names = ["gray"]
    elif cs == "cmyk":
        names = ["cyan", "magenta", "yellow", "black"]
    else:
        names = ["red", "green", "blue"]
    if image.spec.alpha:
        names.append("alpha")
    return names[: image.channels]
