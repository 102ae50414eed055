"""Property escape interpreter: %[...] and %X format strings (property.c).

Port of ``imagemagick_tpu/core/properties.py``: InterpretImageProperties
(MagickCore/property.c), the format-escape language of -format, -print,
-set, label:, caption: and identify.  The statistics come from the port's
``ops/statistic.py`` and ``ops/histogram.py`` on the image's device; the
text is made on the host.

Supported single-letter escapes (property.c InterpretImageProperties table):
  %w %h width/height        %m magick/format      %f filename
  %b file size              %d directory          %e extension
  %t filename base          %x %y resolution      %z depth
  %k number of colors       %q quantum depth      %# signature
  %n number of images       %p page index         %s scene
  %C compression            %A alpha              %r image class summary
Plus %[property], %[width], %[height], %[mean], %[standard-deviation],
%[min], %[max], %[entropy], %[colorspace], %[channels], %[fx:expr],
%[pixel:p{x,y}], and any stored image property.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .image import host_property


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def interpret(fmt: str, image, filename: str = "", index: int = 0,
              total: int = 1) -> str:
    """InterpretImageProperties analog."""
    from ..ops import statistic as stx

    img = image

    def stats():
        return stx.get_statistics(img.data)

    def esc_letter(ch: str) -> str:
        if ch == "w":
            return str(img.width)
        if ch == "h":
            return str(img.height)
        if ch == "m":
            return img.properties.get("format", "MIFF")
        if ch == "f":
            return os.path.basename(filename)
        if ch == "t":
            return os.path.splitext(os.path.basename(filename))[0]
        if ch == "e":
            return os.path.splitext(filename)[1].lstrip(".")
        if ch == "d":
            return os.path.dirname(filename)
        if ch == "b":
            try:
                return str(os.path.getsize(filename)) + "B"
            except OSError:
                return "0B"
        if ch == "z":
            return str(img.spec.depth)
        if ch == "q":
            return str(img.spec.depth)
        if ch == "k":
            from ..ops import histogram as hg

            return str(int(hg.number_colors(img.data)))
        if ch == "n":
            return str(total)
        if ch in ("p", "s"):
            return str(index)
        if ch == "#":
            from ..utils.signature import signature_image

            return signature_image(img.data)
        if ch == "A":
            return "True" if img.spec.alpha else "False"
        if ch == "C":
            return img.properties.get("compression", "Undefined")
        if ch == "r":
            cls = "DirectClass"
            return f"{cls} {img.spec.colorspace}" + \
                (" Alpha" if img.spec.alpha else "")
        if ch == "x" or ch == "y":
            return img.properties.get("density", "72")
        if ch == "%":
            return "%"
        return "%" + ch

    def esc_bracket(expr: str) -> str:
        e = expr.strip()
        low = e.lower()
        if low in ("width", "w"):
            return str(img.width)
        if low in ("height", "h"):
            return str(img.height)
        if low == "colorspace":
            return img.spec.colorspace
        if low == "channels":
            return f"{img.spec.colorspace.lower()}" + \
                ("a" if img.spec.alpha else "")
        if low == "depth":
            return str(img.spec.depth)
        if low == "colors":
            from ..ops import histogram as hg

            return str(int(hg.number_colors(img.data)))
        if low == "size":
            return f"{img.width}x{img.height}"
        if low in ("mean", "standard-deviation", "standard_deviation", "min",
                   "max", "entropy", "skewness", "kurtosis"):
            key = {"standard-deviation": "std", "standard_deviation": "std"}.get(low, low)
            s = stats()
            v = _host(s[key])
            # %[min]/%[max] are GetImageRange — extrema ACROSS channels
            # (property.c:3190/:3238); the others are the composite
            # (channel-averaged) statistic.
            agg = {"min": v.min, "max": v.max}.get(key, v.mean)
            return f"{float(agg()):.6g}"
        if low.startswith("fx:"):
            from ..ops import fx as fxm

            val = fxm.fx(img.data, e[3:])
            return f"{float(_host(val).reshape(-1)[0]):.6g}"
        if low.startswith("pixel:"):
            m = re.search(r"p?\{?\s*([0-9]+)\s*,\s*([0-9]+)\s*\}?", e)
            if m:
                x, y = int(m.group(1)), int(m.group(2))
                px = _host(img.data[..., y, x, :]).reshape(-1)
                vals = ",".join(f"{v * 255:.0f}" for v in px[:3])
                return f"srgb({vals})"
            return ""
        if low.startswith("hex:"):
            m = re.search(r"([0-9]+)\s*,\s*([0-9]+)", e)
            if m:
                x, y = int(m.group(1)), int(m.group(2))
                px = _host(img.data[..., y, x, :]).reshape(-1)
                return "#" + "".join(f"{int(v * 255 + 0.5):02X}" for v in px[:3])
            return ""
        # EXIF/IPTC/XMP namespaces are case-insensitive in the reference
        # (%[EXIF:DateTime] — property.c GetMagickProperty dispatch)
        for ns in ("exif:", "iptc:", "xmp:"):
            if low.startswith(ns):
                want = low[len(ns):].replace(" ", "").replace("-", "")
                for k, v in img.properties.items():
                    kl = k.lower()
                    if kl.startswith(ns) and \
                            kl[len(ns):].replace(" ", "").replace("-", "") == want:
                        return str(v)
                return ""
        # stored property
        return str(host_property(img.properties.get(e, "")))

    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "\\" and i + 1 < len(fmt):
            nxt = fmt[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r"}.get(nxt, nxt))
            i += 2
            continue
        if ch != "%" or i + 1 >= len(fmt):
            out.append(ch)
            i += 1
            continue
        nxt = fmt[i + 1]
        if nxt == "[":
            end = fmt.index("]", i + 2)
            out.append(esc_bracket(fmt[i + 2:end]))
            i = end + 1
        else:
            out.append(esc_letter(nxt))
            i += 2
    return "".join(out)
