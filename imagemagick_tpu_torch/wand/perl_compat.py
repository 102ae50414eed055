"""PerlMagick method-name dispatch: Image::Magick semantics over MagickWand.

Port of ``imagemagick_tpu/wand/perl_compat.py``.  Maps PerlMagick's
capitalized method names and named parameters (the Magick.xs method
table, the Magick.pm POD) onto the port's ``wand/api.py`` calls.  Used by
``rpc_server.py``, which the pure-Perl
``imagemagick_tpu_torch/bindings/perl/Image/Magick.pm`` drives over a
pipe.  The two bodies that the JAX module writes in ``jnp``
(``SortPixels``, ``Integral``) are torch ops on the image's device.

PerlMagick conventions honored here:
  - ``geometry =>`` strings resolve with ParseMetaGeometry semantics for
    resize-family calls and pass through for crop-family calls;
  - scalar thresholds arrive in Q16 quantum units or as "NN%" strings;
  - methods return undef/"" on success (errors are raised and transported
    as JSON-RPC errors by the server).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import geometry as geo


def _q(v, default=0.0) -> float:
    """Quantum/percent scalar -> [0,1] fraction (PerlMagick threshold args)."""
    if v is None:
        return default
    if isinstance(v, str) and v.endswith("%"):
        return float(v[:-1]) / 100.0
    v = float(v)
    return v / 65535.0 if v > 1.0 else v


def _meta_dims(wand, kwargs) -> Optional[tuple]:
    g = kwargs.get("geometry")
    if g:
        w, h, _, _ = geo.parse_meta_geometry(
            str(g), wand.get_image_width(), wand.get_image_height())
        return int(w), int(h)
    if "width" in kwargs or "height" in kwargs:
        w = int(kwargs.get("width", wand.get_image_width()))
        h = int(kwargs.get("height", wand.get_image_height()))
        return w, h
    return None

def _geom_or_parts(kwargs, defaults=(0, 0, 0, 0)):
    g = kwargs.get("geometry")
    if g:
        p = geo.parse_geometry(str(g))
        return (int(p.width or defaults[0]), int(p.height or defaults[1]),
                int(p.x or defaults[2]), int(p.y or defaults[3]))
    return (int(kwargs.get("width", defaults[0])),
            int(kwargs.get("height", defaults[1])),
            int(kwargs.get("x", defaults[2])),
            int(kwargs.get("y", defaults[3])))


def apply(wand, name, **kw):
    """Dispatch a PerlMagick method call onto the wand."""
    n = name.lower()

    # --- IO ---
    if n == "read":
        wand.read_image(kw.get("filename") or kw.get("file"))
        return None
    if n == "write":
        if "quality" in kw:
            wand.quality = int(kw["quality"])
        wand.write_images(kw.get("filename") or kw.get("file"))
        return None
    if n == "ping":
        wand.ping_image(kw.get("filename") or kw.get("file"))
        return [wand.get_image_width(), wand.get_image_height(),
                wand.get_image_length(), wand.get_image_format()]

    # --- resize family ---
    if n in ("resize", "zoom"):
        w, h = _meta_dims(wand, kw) or (wand.get_image_width(),
                                        wand.get_image_height())
        wand.resize_image(w, h, str(kw.get("filter", "lanczos")).lower())
        return None
    if n in ("scale", "sample", "thumbnail", "adaptiveresize",
             "liquidrescale"):
        w, h = _meta_dims(wand, kw) or (wand.get_image_width(),
                                        wand.get_image_height())
        {"scale": wand.scale_image, "sample": wand.sample_image,
         "thumbnail": wand.thumbnail_image,
         "adaptiveresize": wand.adaptive_resize_image,
         "liquidrescale": wand.liquid_rescale_image}[n](w, h)
        return None
    if n == "magnify":
        wand.magnify_image()
        return None
    if n == "minify":
        wand.minify_image()
        return None

    # --- crop family ---
    if n == "crop":
        if kw.get("gravity"):
            wand.gravity = str(kw["gravity"]).lower()
        if kw.get("geometry"):
            wand.crop_image_geometry(str(kw["geometry"]))
        else:
            w, h, x, y = _geom_or_parts(kw)
            wand.crop_image(w, h, x, y)
        return None
    if n == "chop":
        wand.chop_image(*_geom_or_parts(kw))
        return None
    if n == "extent":
        wand.extent_image(*_geom_or_parts(kw))
        return None
    if n == "splice":
        wand.splice_image(*_geom_or_parts(kw))
        return None
    if n == "shave":
        w, h, _, _ = _geom_or_parts(kw)
        wand.shave_image(w, h)
        return None
    if n == "trim":
        wand.trim_image(_q(kw.get("fuzz"), 0.0))
        return None
    if n == "border":
        if kw.get("bordercolor"):
            color = str(kw["bordercolor"])
        else:
            color = "#dfdfdf"
        w, h, _, _ = _geom_or_parts(kw, (6, 6, 0, 0))
        wand.border_image(color, w, h)
        return None
    if n == "frame":
        color = str(kw.get("fill", kw.get("matte", "#dfdfdf")))
        w, h, _, _ = _geom_or_parts(kw, (25, 25, 0, 0))
        wand.frame_image(color, w, h, int(kw.get("inner", 6)),
                         int(kw.get("outer", 6)))
        return None
    if n == "raise":
        w, h, x, y = _geom_or_parts(kw, (6, 6, 0, 0))
        wand.raise_image(w, h, x, y, bool(kw.get("raise", True)))
        return None

    # --- orientation ---
    if n in ("flip", "flop", "transpose", "transverse"):
        getattr(wand, n + "_image")()
        return None
    if n == "rotate":
        wand.rotate_image(str(kw.get("background", "white")),
                          float(kw.get("degrees", 90.0)))
        return None
    if n == "shear":
        if kw.get("geometry"):
            p = geo.parse_geometry(str(kw["geometry"]))
            x, y = float(p.width or 0), float(p.height or 0)
        else:
            x, y = float(kw.get("x", 0.0)), float(kw.get("y", 0.0))
        wand.shear_image(str(kw.get("background", "white")), x, y)
        return None
    if n == "roll":
        _, _, x, y = _geom_or_parts(kw)
        wand.roll_image(int(kw.get("x", x)), int(kw.get("y", y)))
        return None
    if n == "autoorient":
        wand.auto_orient_image()
        return None
    if n == "deskew":
        wand.deskew_image(_q(kw.get("threshold"), 0.4))
        return None

    # --- blur / effects ---
    if n in ("blur", "gaussianblur", "sharpen", "emboss", "charcoal",
             "sketch", "adaptiveblur", "adaptivesharpen"):
        meth = {"blur": wand.blur_image, "gaussianblur":
                wand.gaussian_blur_image, "sharpen": wand.sharpen_image,
                "emboss": wand.emboss_image, "charcoal": wand.charcoal_image,
                "sketch": wand.sketch_image,
                "adaptiveblur": wand.adaptive_blur_image,
                "adaptivesharpen": wand.adaptive_sharpen_image}[n]
        r, s = float(kw.get("radius", 0.0)), float(kw.get("sigma", 1.0))
        if kw.get("geometry"):
            p = geo.parse_geometry(str(kw["geometry"]))
            r = float(p.width or 0)
            s = float(p.height or 1)
        meth(r, s)
        return None
    if n == "unsharpmask":
        wand.unsharp_mask_image(float(kw.get("radius", 0.0)),
                                float(kw.get("sigma", 1.0)),
                                float(kw.get("gain", kw.get("amount", 1.0))),
                                _q(kw.get("threshold"), 0.05))
        return None
    if n == "motionblur":
        wand.motion_blur_image(float(kw.get("radius", 0.0)),
                               float(kw.get("sigma", 1.0)),
                               float(kw.get("angle", 0.0)))
        return None
    if n == "rotationalblur":
        wand.rotational_blur_image(float(kw.get("angle", 0.0)))
        return None
    if n == "oilpaint":
        wand.oil_paint_image(float(kw.get("radius", 3.0)))
        return None
    if n == "edge":
        wand.edge_image(float(kw.get("radius", 0.0)))
        return None
    if n == "shade":
        wand.shade_image(bool(int(kw.get("gray", 1))),
                         float(kw.get("azimuth", 30.0)),
                         float(kw.get("elevation", 30.0)))
        return None
    if n == "despeckle":
        wand.despeckle_image()
        return None
    if n == "reducenoise":
        o = int(float(kw.get("radius", 0)) * 2 + 1) if kw.get("radius") else 3
        wand.statistic_image("nonpeak", o, o)
        return None
    if n == "medianfilter":
        o = int(float(kw.get("radius", 1)) * 2 + 1)
        wand.statistic_image("median", o, o)
        return None
    if n == "statistic":
        wand.statistic_image(str(kw.get("type", "mean")).lower(),
                             int(kw.get("width", 3)),
                             int(kw.get("height", 3)))
        return None
    if n == "addnoise":
        wand.add_noise_image(str(kw.get("noise", "gaussian")).lower(),
                             float(kw.get("attenuate", 1.0)))
        return None
    if n == "spread":
        wand.spread_image(float(kw.get("radius", kw.get("amount", 3.0))))
        return None
    if n == "swirl":
        wand.swirl_image(float(kw.get("degrees", 50.0)))
        return None
    if n == "implode":
        wand.implode_image(float(kw.get("amount", 0.3)))
        return None
    if n == "wave":
        wand.wave_image(float(kw.get("amplitude", 25.0)),
                        float(kw.get("wavelength", 150.0)))
        return None
    if n == "vignette":
        wand.vignette_image(float(kw.get("radius", 0.0)),
                            float(kw.get("sigma", 10.0)),
                            int(kw.get("x", 0)), int(kw.get("y", 0)))
        return None
    if n == "sepiatone":
        wand.sepia_tone_image(_q(kw.get("threshold"), 0.8))
        return None
    if n == "solarize":
        wand.solarize_image(_q(kw.get("threshold"), 0.5))
        return None
    if n == "blueshift":
        wand.blue_shift_image(float(kw.get("factor", 1.5)))
        return None
    if n == "charcoalimage":
        wand.charcoal_image(float(kw.get("radius", 0)),
                            float(kw.get("sigma", 1)))
        return None
    if n == "colorize":
        wand.colorize_image(str(kw.get("fill", "black")),
                            _q(kw.get("blend", kw.get("opacity")), 1.0))
        return None
    if n == "tint":
        wand.tint_image(str(kw.get("fill", "black")),
                        _q(kw.get("blend", kw.get("opacity")), 0.5))
        return None
    if n == "shadow":
        wand.shadow_image(float(kw.get("alpha", kw.get("opacity", 80.0))),
                          float(kw.get("sigma", 3.0)),
                          int(kw.get("x", 5)), int(kw.get("y", 5)))
        return None
    if n == "polaroid":
        wand.polaroid_image(None, str(kw.get("caption", "")),
                            float(kw.get("angle", 0.0)))
        return None
    if n == "waveletdenoise":
        wand.wavelet_denoise_image(_q(kw.get("threshold"), 0.05),
                                   float(kw.get("softness", 0.0)))
        return None
    if n == "kuwahara":
        wand.kuwahara_image(float(kw.get("radius", 1.0)),
                            float(kw.get("sigma", 0)) or None)
        return None

    # --- enhance ---
    if n == "negate":
        wand.negate_image(bool(int(kw.get("gray", 0))))
        return None
    if n in ("normalize", "equalize", "enhance", "autolevel", "autogamma",
             "whitebalance", "clamp"):
        meth = {"normalize": wand.normalize_image, "equalize":
                wand.equalize_image, "enhance": wand.enhance_image,
                "autolevel": wand.auto_level_image,
                "autogamma": wand.auto_gamma_image,
                "whitebalance": wand.white_balance_image,
                "clamp": wand.clamp_image}[n]
        meth()
        return None
    if n == "gamma":
        wand.gamma_image(float(kw.get("gamma", 1.0)))
        return None
    if n == "level":
        levels = kw.get("levels")
        if levels:
            parts = [p.strip() for p in str(levels).replace(",", " ").split()]
            black = _q(parts[0]) if parts else 0.0
            white = _q(parts[1]) if len(parts) > 1 else 1.0
            gam = float(parts[2]) if len(parts) > 2 else 1.0
        else:
            black = _q(kw.get("black-point", kw.get("black_point")), 0.0)
            white = _q(kw.get("white-point", kw.get("white_point")), 1.0)
            gam = float(kw.get("gamma", 1.0))
        wand.level_image(black, gam, white)
        return None
    if n == "modulate":
        wand.modulate_image(float(kw.get("brightness", 100.0)),
                            float(kw.get("saturation", 100.0)),
                            float(kw.get("hue", 100.0)))
        return None
    if n == "contrast":
        wand.contrast_image(bool(int(kw.get("sharpen", 1))))
        return None
    if n == "sigmoidalcontrast":
        wand.sigmoidal_contrast_image(
            bool(int(kw.get("sharpen", 1))),
            float(kw.get("contrast", 3.0)),
            _q(kw.get("mid-point", kw.get("midpoint")), 0.5))
        return None
    if n == "contraststretch":
        wand.contrast_stretch_image(_q(kw.get("black-point"), 0.0),
                                    _q(kw.get("white-point"), 0.0) or None)
        return None
    if n == "brightnesscontrast":
        wand.brightness_contrast_image(float(kw.get("brightness", 0.0)),
                                       float(kw.get("contrast", 0.0)))
        return None
    if n == "clahe":
        wand.clahe_image(int(kw.get("width", 8)), int(kw.get("height", 8)),
                         int(kw.get("number-bins", kw.get("bins", 128))),
                         float(kw.get("clip-limit", kw.get("clip", 3.0))))
        return None
    if n == "grayscale":
        wand.grayscale_image(str(kw.get("channel",
                                        "rec709luma")).lower())
        return None

    # --- threshold / quantize ---
    if n == "threshold":
        wand.threshold_image(_q(kw.get("threshold"), 0.5))
        return None
    if n == "blackthreshold":
        wand.black_threshold_image(_q(kw.get("threshold"), 0.5))
        return None
    if n == "whitethreshold":
        wand.white_threshold_image(_q(kw.get("threshold"), 0.5))
        return None
    if n == "adaptivethreshold":
        wand.adaptive_threshold_image(int(kw.get("width", 3)),
                                      int(kw.get("height", 3)),
                                      _q(kw.get("bias", kw.get("offset")),
                                         0.0))
        return None
    if n == "autothreshold":
        wand.auto_threshold_image(str(kw.get("method", "otsu")).lower())
        return None
    if n == "randomthreshold":
        wand.random_threshold_image(_q(kw.get("low"), 0.0),
                                    _q(kw.get("high"), 1.0))
        return None
    if n == "ordereddither":
        wand.ordered_dither_image(str(kw.get("map",
                                              kw.get("threshold", "o8x8"))))
        return None
    if n == "posterize":
        wand.posterize_image(int(kw.get("levels", 4)),
                             bool(kw.get("dither", False)))
        return None
    if n == "quantize":
        wand.quantize_image(int(kw.get("colors", 256)),
                            str(kw.get("colorspace", "srgb")).lower())
        return None
    if n == "segment":
        wand.segment_image(str(kw.get("colorspace", "srgb")).lower(),
                           bool(kw.get("verbose", False)))
        return None
    if n == "kmeans":
        wand.kmeans_image(int(kw.get("colors", 8)))
        return None

    # --- color / channels ---
    if n == "colorspace" or n == "transformcolorspace":
        wand.transform_image_colorspace(
            str(kw.get("colorspace", "srgb")).lower())
        return None
    if n == "separate":
        wand.separate_image_channel(str(kw.get("channel", "red")).lower())
        return None
    if n == "opaque":
        wand.opaque_paint_image(str(kw.get("color", "black")),
                                str(kw.get("fill", "white")),
                                _q(kw.get("fuzz"), 0.0),
                                bool(kw.get("invert", False)))
        return None
    if n == "transparent":
        wand.transparent_paint_image(str(kw.get("color", "black")),
                                     _q(kw.get("alpha", kw.get("opacity")),
                                        0.0),
                                     _q(kw.get("fuzz"), 0.0))
        return None
    if n == "floodfill":
        wand.floodfill_paint_image(str(kw.get("fill", "black")),
                                   _q(kw.get("fuzz"), 0.0), None,
                                   int(kw.get("x", 0)), int(kw.get("y", 0)))
        return None
    if n == "cyclecolormap":
        wand.cycle_colormap_image(int(kw.get("amount",
                                              kw.get("displace", 1))))
        return None
    if n == "clut":
        wand.clut_image(kw["image"])
        return None
    if n == "haldclut":
        wand.hald_clut_image(kw["image"])
        return None
    if n == "setalpha" or n == "alpha":
        wand.set_image_alpha_channel(str(kw.get("alpha",
                                                 kw.get("value",
                                                        "on"))).lower())
        return None

    # --- composition / annotation ---
    if n == "composite":
        src = kw["image"]
        if kw.get("gravity"):
            old = wand.gravity
            wand.gravity = str(kw["gravity"]).lower()
            try:
                wand.composite_image(src,
                                     str(kw.get("compose", "over")).lower(),
                                     0, 0)
            finally:
                wand.gravity = old
        else:
            x, y = int(kw.get("x", 0)), int(kw.get("y", 0))
            if kw.get("geometry"):
                p = geo.parse_geometry(str(kw["geometry"]))
                x, y = int(p.x or 0), int(p.y or 0)
            wand.composite_image(src, str(kw.get("compose", "over")).lower(),
                                 x, y)
        return None
    if n == "annotate":
        from . import cpp_support

        cpp_support.annotate(wand, str(kw.get("text", "")),
                             str(kw.get("geometry", "")),
                             str(kw.get("gravity", "northwest")).lower(),
                             float(kw.get("pointsize", 12.0)),
                             kw.get("font"))
        return None
    if n == "draw":
        prim = str(kw.get("primitive", ""))
        mvg = []
        if kw.get("fill"):
            mvg.append(f"fill {kw['fill']}")
        if kw.get("stroke"):
            mvg.append(f"stroke {kw['stroke']}")
        if kw.get("strokewidth"):
            mvg.append(f"stroke-width {kw['strokewidth']}")
        pts = str(kw.get("points", ""))
        mvg.append(f"{prim} {pts}".strip())
        wand.draw_image(" ".join(mvg))
        return None
    if n == "stereo":
        return wand.stereo_image(kw["image"])
    if n == "stegano":
        return wand.stegano_image(kw["image"], int(kw.get("offset", 0)))
    if n == "texture":
        return wand.texture_image(kw["image"])
    if n == "append":
        return wand.append_images(bool(int(kw.get("stack", 0))))
    if n == "coalesce":
        return wand.coalesce_images()
    if n == "deconstruct":
        return wand.deconstruct_images()
    if n == "flatten" or n == "merge" or n == "mosaic":
        return wand.merge_image_layers("flatten" if n == "flatten" else n)
    if n == "montage":
        return wand.montage_image(
            tile=str(kw.get("tile", "")),
            thumbnail_geometry=str(kw.get("geometry", "120x120+4+3")))

    # --- analysis / misc ---
    if n == "compare":
        return wand.get_image_distortion(kw["image"],
                                         str(kw.get("metric",
                                                    "rmse")).lower())
    if n == "signature":
        return wand.get_image_signature()
    if n == "fx":
        return wand.fx_image(str(kw.get("expression", "u")))
    if n == "evaluate":
        wand.evaluate_image(str(kw.get("operator", "set")).lower(),
                            float(kw.get("value", 0.0)))
        return None
    if n == "function":
        args = kw.get("parameters", kw.get("args", []))
        if isinstance(args, str):
            args = [float(v) for v in args.replace(",", " ").split()]
        wand.function_image(str(kw.get("function", "polynomial")).lower(),
                            args)
        return None
    if n == "distort":
        args = kw.get("points", kw.get("args", []))
        if isinstance(args, str):
            args = [float(v) for v in args.replace(",", " ").split()]
        wand.distort_image(str(kw.get("method", "affine")).lower(), args,
                           bool(kw.get("best-fit", kw.get("bestfit",
                                                          False))))
        return None
    if n == "morphology":
        wand.morphology_image(str(kw.get("method", "dilate")).lower(),
                              int(kw.get("iterations", 1)),
                              str(kw.get("kernel", "diamond")))
        return None
    if n == "connectedcomponents":
        wand.connected_components_image(int(kw.get("connectivity", 4)))
        return None
    if n == "cannyedge":
        wand.canny_edge_image(float(kw.get("radius", 0.0)),
                              float(kw.get("sigma", 1.0)),
                              _q(kw.get("lower-percent"), 0.1),
                              _q(kw.get("upper-percent"), 0.3))
        return None
    if n == "houghline":
        wand.hough_line_image(int(kw.get("width", 5)),
                              int(kw.get("height", 5)),
                              int(kw.get("threshold", 40)))
        return None
    if n == "encipher":
        wand.encipher_image(str(kw.get("passphrase", "")))
        return None
    if n == "decipher":
        wand.decipher_image(str(kw.get("passphrase", "")))
        return None
    if n == "strip":
        wand.strip_image()
        return None
    if n == "profile":
        name = kw.get("name", "icc")
        prof = kw.get("profile")
        wand.profile_image(name, prof if prof else None)
        return None
    if n == "comment":
        wand.set_image_property("comment", str(kw.get("comment",
                                                      kw.get("text", ""))))
        return None
    if n == "label":
        wand.set_image_property("label", str(kw.get("label",
                                                    kw.get("text", ""))))
        return None
    if n == "identify":
        from ..io import identify as idf

        return idf.describe(wand.current, "", verbose=True)
    if n == "histogram":
        # the JAX module slices the histogram's dict and raises KeyError
        # on every image; the port returns its 64 most frequent colors
        hist = list(wand.get_image_histogram().items())[:64]
        return [[list(map(float, color)), int(count)]
                for color, count in hist]

    if n == "querycolorhelper":
        from ..core.color import parse_color

        return [float(v) for v in parse_color(str(kw.get("color", "black")))]

    # --- round-2 widening: remaining Magick.xs Mogrify methods ---
    if n in ("colorfloodfill", "floodfillpaint"):
        w_, h_, x, y = _geom_or_parts(kw)
        del w_, h_
        wand.floodfill_paint_image(str(kw.get("fill", "black")),
                                   _q(kw.get("fuzz"), 0.0),
                                   kw.get("bordercolor"), x, y,
                                   bool(kw.get("invert", False)))
        return None
    if n == "mattefloodfill":
        w_, h_, x, y = _geom_or_parts(kw)
        del w_, h_
        alpha = _q(kw.get("opacity"), 0.0)
        r, g, b = [float(v) for v in
                   wand.get_image_pixel_color(x, y)._rgba[:3]]
        fill = "rgba(%d,%d,%d,%g)" % (int(r * 255), int(g * 255),
                                      int(b * 255), 1.0 - alpha)
        wand.floodfill_paint_image(fill, _q(kw.get("fuzz"), 0.0), None,
                                   x, y, bool(kw.get("invert", False)))
        return None
    if n in ("map", "remap"):
        wand.remap_image(kw["image"], bool(kw.get("dither", False)))
        return None
    if n == "numbercolors":
        return int(wand.get_image_colors())
    if n in ("sync", "condense", "sans0", "sans1"):
        return None                      # legacy no-ops (Magick.xs)
    if n == "convolve":
        coeffs = kw.get("coefficients", kw.get("kernel", []))
        if isinstance(coeffs, str):
            coeffs = [float(v) for v in coeffs.replace(",", " ").split()]
        order = int(round(len(coeffs) ** 0.5))
        wand.convolve_image([coeffs[i * order:(i + 1) * order]
                             for i in range(order)])
        return None
    if n == "clip":
        wand.clip_image()
        return None
    if n in ("clipmask", "mask"):
        wand.set_image_mask(kw.get("mask") or kw.get("image"),
                            "read" if n == "clipmask" else "write")
        return None
    if n == "affinetransform":
        mat = kw.get("affine", kw.get("matrix", [1, 0, 0, 1, 0, 0]))
        if isinstance(mat, str):
            mat = [float(v) for v in mat.replace(",", " ").split()]
        wand.affine_transform_image(mat)
        return None
    if n == "difference":
        return wand.get_image_distortion(kw["image"], "mae")
    if n == "resample":
        wand.resample_image(float(kw.get("x", kw.get("density", 72.0))),
                            float(kw.get("y", kw.get("x",
                                                     kw.get("density",
                                                            72.0)))),
                            str(kw.get("filter", "lanczos")).lower())
        return None
    if n == "describe":
        from ..io import identify as idf

        return idf.describe(wand.current, "", verbose=True)
    if n in ("channel", "separate"):
        wand.separate_image_channel(str(kw.get("channel", "gray")).lower())
        return None
    if n == "uniquecolors":
        merged = wand.unique_image_colors()
        wand.images = merged.images
        wand.iterator = 0
        return None
    if n == "linearstretch":
        wand.linear_stretch_image(_q(kw.get("black-point"), 0.0),
                                  _q(kw.get("white-point"), 1.0))
        return None
    if n == "colormatrix":
        mat = kw.get("matrix", [])
        if isinstance(mat, str):
            mat = [float(v) for v in mat.replace(",", " ").split()]
        order = int(round(len(mat) ** 0.5))
        wand.color_matrix_image([mat[i * order:(i + 1) * order]
                                 for i in range(order)])
        return None
    if n == "sparsecolor":
        pts = kw.get("points", [])
        if isinstance(pts, str):
            pts = [float(v) for v in pts.replace(",", " ").split()]
        from .cpp_support import sparse_color_flat

        sparse_color_flat(wand, str(kw.get("method",
                                           "voronoi")).lower(), pts)
        return None
    if n == "selectiveblur":
        wand.selective_blur_image(float(kw.get("radius", 0.0)),
                                  float(kw.get("sigma", 1.0)),
                                  _q(kw.get("threshold"), 0.1))
        return None
    if n == "forwardfouriertransform":
        wand.forward_fourier_transform_image(
            bool(kw.get("magnitude", True)))
        return None
    if n == "inversefouriertransform":
        wand.inverse_fourier_transform_image(
            kw["image"], bool(kw.get("magnitude", True)))
        return None
    if n == "colordecisionlist":
        wand.color_decision_list_image(str(kw.get("filename",
                                                  kw.get("cdl", ""))))
        return None
    if n == "levelcolors":
        wand.level_image_colors(str(kw.get("black-point", "black")),
                                str(kw.get("white-point", "white")),
                                bool(kw.get("invert", True)))
        return None
    if n == "mode":
        w_, h_, _, _ = _geom_or_parts(kw, (3, 3, 0, 0))
        wand.statistic_image("mode", w_, h_ or w_)
        return None
    if n == "perceptible":
        wand.evaluate_image("max", float(kw.get("epsilon", 1e-6)))
        return None
    if n == "poly":
        terms = kw.get("terms", [])
        if isinstance(terms, str):
            terms = [float(v) for v in terms.replace(",", " ").split()]
        wand.polynomial_image(terms)
        return None
    if n == "meanshift":
        w_, h_, _, _ = _geom_or_parts(kw, (3, 3, 0, 0))
        wand.mean_shift_image(w_, h_ or w_,
                              _q(kw.get("distance"), 0.1))
        return None
    if n == "copypixels":
        from .cpp_support import copy_pixels

        g = str(kw.get("geometry", ""))
        copy_pixels(wand, kw["image"], g or "%dx%d+0+0" % (
            kw["image"].get_image_width(),
            kw["image"].get_image_height()),
            int(kw.get("x", kw.get("dx", 0))),
            int(kw.get("y", kw.get("dy", 0))))
        return None
    if n == "color":
        wand.set_image_color(str(kw.get("color", "black")))
        return None
    if n == "rangethreshold":
        g = str(kw.get("geometry", "0x0"))
        vals = [_q(v) for v in g.replace("x", ",").split(",")]
        vals = (vals + [0.0, 0.0, 1.0, 1.0])[:4]
        wand.range_threshold_image(*vals)
        return None
    if n == "colorthreshold":
        wand.color_threshold_image(str(kw.get("start-color", "black")),
                                   str(kw.get("stop-color", "white")))
        return None
    if n == "bilateralblur":
        radius = float(kw.get("radius", 0.0))
        win = max(3, int(2 * radius + 1)) if radius else 5
        wand.bilateral_blur_image(win, win,
                                  float(kw.get("intensity-sigma", 0.75)),
                                  float(kw.get("spatial-sigma", 0.25)))
        return None
    if n == "sortpixels":
        from ..ops.channel import channel_mean

        # the JAX luma (jnp.mean: channels summed in order, times the
        # float32 reciprocal of their count) and its stable argsort, so
        # that ties keep their order as in the JAX module
        img = wand.current
        luma = channel_mean(img.data[..., :3] if img.data.shape[-1] >= 3
                            else img.data)
        order = torch.argsort(luma, dim=-1, stable=True)
        wand._set_current(img.replace(data=torch.take_along_dim(
            img.data, order[..., None], dim=-2)))
        return None
    if n == "integral":
        # summed in float64 and rounded: the card's scan adds in another
        # order than the CPU's, and float64 partial sums of float32
        # samples round to the same float32 on both
        img = wand.current
        total = torch.cumsum(torch.cumsum(img.data.to(torch.float64),
                                          dim=-3), dim=-2)
        wand._set_current(img.replace(data=total.to(img.data.dtype)))
        return None

    raise ValueError(f"PerlMagick method {name!r} is not supported")


# -- Get()/Set() attribute table (Magick.pm POD "Image Attributes") --

def get_attribute(wand, attr):
    a = attr.lower()
    simple = {
        "width": wand.get_image_width, "columns": wand.get_image_width,
        "height": wand.get_image_height, "rows": wand.get_image_height,
        "depth": wand.get_image_depth,
        "magick": wand.get_image_format, "format": wand.get_image_format,
        "colorspace": wand.get_image_colorspace,
        "signature": wand.get_image_signature,
        "colors": wand.get_image_colors,
        "filesize": wand.get_image_length,
        "delay": wand.get_image_delay,
        "scene": wand.get_image_scene,
        "filename": wand.get_image_filename,
        "type": wand.get_image_type,
        "matte": wand.get_image_alpha_channel,
        "alpha": wand.get_image_alpha_channel,
        "gamma": wand.get_image_gamma,
        "orientation": wand.get_image_orientation,
    }
    if a in simple:
        return simple[a]()
    if a in ("label", "comment"):
        return wand.get_image_property(a)
    if a == "fuzz":
        return wand.fuzz
    if a == "pointsize":
        return wand.pointsize
    if a == "font":
        return wand.font
    if a == "quality":
        return wand.quality
    if a == "gravity":
        return wand.gravity
    if a == "density":
        x, y = wand.get_image_resolution()
        return f"{x}x{y}"
    if a == "page":
        w, h, x, y = wand.get_image_page()
        return f"{w}x{h}+{x}+{y}"
    if a in ("images", "n"):
        return len(wand)
    if a.startswith("pixel[") and a.endswith("]"):
        x, y = (int(v) for v in a[6:-1].split(","))
        return list(wand.get_image_pixel_color(x, y).get_color())
    return wand.get_image_property(attr)


def set_attribute(wand, attr, value):
    a = attr.lower()
    if a == "quality":
        wand.quality = int(value)
    elif a == "fuzz":
        wand.fuzz = _q(value, 0.0)
    elif a == "font":
        wand.font = str(value)
    elif a == "pointsize":
        wand.pointsize = float(value)
    elif a == "gravity":
        wand.gravity = str(value).lower()
    elif a in ("magick", "format"):
        wand.set_image_format(str(value))
    elif a == "depth":
        wand.set_image_depth(int(value))
    elif a == "colorspace":
        wand.transform_image_colorspace(str(value).lower())
    elif a == "background":
        wand.set_background_color(str(value))
    elif a == "bordercolor":
        wand.set_image_border_color(str(value))
    elif a == "delay":
        wand.set_image_delay(int(value))
    elif a == "scene":
        wand.set_image_scene(int(value))
    elif a == "filename":
        wand.set_image_filename(str(value))
    elif a in ("label", "comment"):
        wand.set_image_property(a, str(value))
    elif a == "size":
        wand.settings["size"] = str(value)
    elif a == "type":
        wand.set_image_type(str(value).lower())
    elif a == "orientation":
        wand.set_image_orientation(str(value).lower())
    elif a == "alpha" or a == "matte":
        wand.set_image_alpha_channel("on" if value else "off")
    elif a == "page":
        from ..core.geometry import parse_page_geometry

        # the JAX module leaves out the canvas size that
        # parse_page_geometry takes and raises TypeError on every page
        wand.set_image_page(*parse_page_geometry(
            str(value), wand.get_image_width(), wand.get_image_height()))
    else:
        wand.set_image_property(attr, str(value))
