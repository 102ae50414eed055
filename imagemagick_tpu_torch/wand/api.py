"""MagickWand-style Python API.

Port of ``imagemagick_tpu/wand/api.py``.  Mirrors the MagickWand C surface
(MagickWand/magick-image.c, 283 WandExport wrappers; the wand object of
magick-wand-private.h:62-86): a ``MagickWand`` owns an image list, an
iterator position, and settings; every method operates on the current image
(or all images when iterating).  Method names follow the C API with the
``Magick`` prefix dropped and snake_case (MagickResizeImage -> resize_image),
the same convention the `wand` Python package uses — so ImageMagick users
can port scripts mechanically.

A wand's pixels are tensors on its device, the CUDA card unless the caller
asks for the CPU (``MagickWand(device="cpu")``); what it reads or makes
lands there, and an image handed in keeps its own device.  A tagged op
(resize, blur) is first offered to the fused kernel (``_apply``).  No
method writes into a tensor in place: a clone, another wand or the caller
may hold the same one, so a write goes to a copy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.color import parse_color
from ..core.geometry import parse_meta_geometry
from ..core.image import Image
from ..core.spec import ImageSpec
from .. import io as iio


def _host(v) -> np.ndarray:
    """A tensor (or anything numpy takes) as a numpy array on the host."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _edge_pad(d: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``d`` padded along ``axis`` to ``n`` by repeating its last slice
    (``jnp.pad(mode="edge")`` at the end of one axis)."""
    idx = torch.clamp(torch.arange(n, device=d.device), max=d.shape[axis] - 1)
    return torch.index_select(d, axis % d.dim(), idx)


def _with_opaque_alpha(data: torch.Tensor) -> torch.Tensor:
    """``data`` with an alpha channel of ones appended."""
    return torch.cat([data, torch.ones(data.shape[:-1] + (1,),
                                       dtype=data.dtype, device=data.device)],
                     -1)


def _on(arr, like: torch.Tensor) -> torch.Tensor:
    """Host values as a float32 tensor on ``like``'s device, never sharing
    the caller's buffer."""
    return torch.tensor(np.asarray(arr, np.float32), device=like.device)


def _color_str(color) -> str:
    """Coerce a PixelWand / tuple / string to a color string."""
    if isinstance(color, PixelWand):
        return color.get_color_string()
    if isinstance(color, str):
        return color
    c = list(color)
    if len(c) >= 4:
        return (f"srgba({c[0] * 255:.0f},{c[1] * 255:.0f},"
                f"{c[2] * 255:.0f},{c[3]:.3g})")
    return f"srgb({c[0] * 255:.0f},{c[1] * 255:.0f},{c[2] * 255:.0f})"


class PixelWand:
    """Color container (pixel-wand.c, 62 exports)."""

    def __init__(self, color: Union[str, Sequence[float]] = "black"):
        if isinstance(color, str):
            self._rgba = list(parse_color(color))
        else:
            c = list(color)
            self._rgba = (c + [1.0])[:4] if len(c) >= 3 else [c[0]] * 3 + [1.0]

    # channel accessors (MagickGetPixelRed etc.)
    @property
    def red(self):
        return self._rgba[0]

    @red.setter
    def red(self, v):
        self._rgba[0] = float(v)

    @property
    def green(self):
        return self._rgba[1]

    @green.setter
    def green(self, v):
        self._rgba[1] = float(v)

    @property
    def blue(self):
        return self._rgba[2]

    @blue.setter
    def blue(self, v):
        self._rgba[2] = float(v)

    @property
    def alpha(self):
        return self._rgba[3]

    @alpha.setter
    def alpha(self, v):
        self._rgba[3] = float(v)

    def get_color(self) -> Tuple[float, float, float, float]:
        return tuple(self._rgba)

    def set_color(self, color: str):
        self._rgba = list(parse_color(color))

    def get_color_string(self) -> str:
        r, g, b, a = self._rgba
        if a >= 1.0:
            return f"srgb({r * 255:.0f},{g * 255:.0f},{b * 255:.0f})"
        return f"srgba({r * 255:.0f},{g * 255:.0f},{b * 255:.0f},{a:.3g})"

    # --- full pixel-wand.c surface (62 exports) ---

    def get_color_as_string(self) -> str:
        return self.get_color_string()

    def get_color_as_normalized_string(self) -> str:
        r, g, b, a = self._rgba
        if a >= 1.0:
            return f"srgb({r:.6g},{g:.6g},{b:.6g})"
        return f"srgba({r:.6g},{g:.6g},{b:.6g},{a:.6g})"

    # quantum-scale accessors (Q16 convention, pixel-wand.c)
    def get_red_quantum(self):
        return self._rgba[0] * 65535.0

    def get_green_quantum(self):
        return self._rgba[1] * 65535.0

    def get_blue_quantum(self):
        return self._rgba[2] * 65535.0

    def get_alpha_quantum(self):
        return self._rgba[3] * 65535.0

    def set_red_quantum(self, q):
        self._rgba[0] = float(q) / 65535.0

    def set_green_quantum(self, q):
        self._rgba[1] = float(q) / 65535.0

    def set_blue_quantum(self, q):
        self._rgba[2] = float(q) / 65535.0

    def set_alpha_quantum(self, q):
        self._rgba[3] = float(q) / 65535.0

    # CMYK facade over the stored RGB (pixel-wand.c stores both)
    def _cmyk(self):
        r, g, b = self._rgba[:3]
        k = 1.0 - max(r, g, b)
        d = max(1.0 - k, 1e-12)
        return ((1 - r - k) / d, (1 - g - k) / d, (1 - b - k) / d, k)

    def _set_cmyk(self, c, m, y, k):
        self._rgba[0] = (1 - c) * (1 - k)
        self._rgba[1] = (1 - m) * (1 - k)
        self._rgba[2] = (1 - y) * (1 - k)

    def get_cyan(self):
        return self._cmyk()[0]

    def get_magenta(self):
        return self._cmyk()[1]

    def get_yellow(self):
        return self._cmyk()[2]

    def get_black(self):
        return self._cmyk()[3]

    def set_cyan(self, v):
        c, m, y, k = self._cmyk()
        self._set_cmyk(float(v), m, y, k)

    def set_magenta(self, v):
        c, m, y, k = self._cmyk()
        self._set_cmyk(c, float(v), y, k)

    def set_yellow(self, v):
        c, m, y, k = self._cmyk()
        self._set_cmyk(c, m, float(v), k)

    def set_black(self, v):
        c, m, y, k = self._cmyk()
        self._set_cmyk(c, m, y, float(v))

    def get_cyan_quantum(self):
        return self.get_cyan() * 65535.0

    def get_magenta_quantum(self):
        return self.get_magenta() * 65535.0

    def get_yellow_quantum(self):
        return self.get_yellow() * 65535.0

    def get_black_quantum(self):
        return self.get_black() * 65535.0

    def set_cyan_quantum(self, q):
        self.set_cyan(float(q) / 65535.0)

    def set_magenta_quantum(self, q):
        self.set_magenta(float(q) / 65535.0)

    def set_yellow_quantum(self, q):
        self.set_yellow(float(q) / 65535.0)

    def set_black_quantum(self, q):
        self.set_black(float(q) / 65535.0)

    def get_hsl(self):
        """PixelGetHSL (colorspace.c RGB->HSL triplet)."""
        import colorsys

        r, g, b = self._rgba[:3]
        h, l, s = colorsys.rgb_to_hls(r, g, b)
        return (h, s, l)

    def set_hsl(self, hue, saturation, lightness):
        import colorsys

        r, g, b = colorsys.hls_to_rgb(float(hue), float(lightness),
                                      float(saturation))
        self._rgba[:3] = [r, g, b]

    def get_fuzz(self):
        return getattr(self, "_fuzz", 0.0)

    def set_fuzz(self, f):
        self._fuzz = float(f)

    def get_index(self):
        return getattr(self, "_index", 0)

    def set_index(self, i):
        self._index = int(i)

    def get_color_count(self):
        return getattr(self, "_count", 0)

    def set_color_count(self, n):
        self._count = int(n)

    def set_color_from_wand(self, other: "PixelWand"):
        self._rgba = list(other._rgba)

    set_pixel_color = set_color_from_wand

    def get_pixel(self):
        """PixelGetPixel: PixelInfo-like tuple in quantum scale."""
        return tuple(v * 65535.0 for v in self._rgba)

    get_magick_color = get_pixel
    get_quantum_packet = get_pixel

    def get_quantum_pixel(self):
        return tuple(v * 65535.0 for v in self._rgba)

    def set_quantum_pixel(self, quad):
        self._rgba = [float(v) / 65535.0 for v in list(quad)[:4]]

    def is_similar(self, other: "PixelWand", fuzz: float = 0.0) -> bool:
        """IsPixelWandSimilar."""
        d2 = sum((a - b) ** 2 for a, b in zip(self._rgba, other._rgba))
        return d2 ** 0.5 <= fuzz + 1e-12

    def clone(self) -> "PixelWand":
        w = PixelWand(list(self._rgba))
        return w

    def clear(self):
        self._rgba = list(parse_color("black"))

    def get_exception(self):
        return (0, "")

    def get_exception_type(self):
        return 0

    def clear_exception(self):
        return True


def new_pixel_wand(color="black") -> PixelWand:
    """NewPixelWand (pixel-wand.c)."""
    return PixelWand(color)


def new_pixel_wands(n: int) -> list:
    return [PixelWand() for _ in range(n)]


def clone_pixel_wand(w: PixelWand) -> PixelWand:
    return w.clone()


def clone_pixel_wands(ws) -> list:
    return [w.clone() for w in ws]


def destroy_pixel_wand(w):
    """DestroyPixelWand (no-op: Python owns the memory)."""
    return None


def destroy_pixel_wands(ws):
    return None


def is_pixel_wand(w) -> bool:
    return isinstance(w, PixelWand)


def is_pixel_wand_similar(a, b, fuzz=0.0) -> bool:
    return a.is_similar(b, fuzz)


class MagickWand:
    """The wand: image list + iterator + settings (NewMagickWand analog).
    ``device`` is where what the wand reads or makes lands."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.images: List[Image] = []
        self.iterator: int = -1
        self.settings: Dict[str, str] = {}
        self.background = PixelWand("white")
        self.font: Optional[str] = None
        self.pointsize: float = 12.0
        self.quality: int = 92
        self.filter: str = "undefined"
        self.gravity: str = "undefined"
        self.fuzz: float = 0.0

    # -- wand/list management (magick-wand.c / magick-image.c) --
    def clone(self) -> "MagickWand":
        w = MagickWand(self.device)
        w.images = list(self.images)
        w.iterator = self.iterator
        w.settings = dict(self.settings)
        return w

    def clear(self):
        self.images = []
        self.iterator = -1

    @property
    def current(self) -> Image:
        if not self.images:
            raise RuntimeError("wand contains no images")
        return self.images[self.iterator if self.iterator >= 0 else -1]

    def _set_current(self, img: Image):
        self.images[self.iterator if self.iterator >= 0 else -1] = img

    def __len__(self):
        return len(self.images)

    def __iter__(self) -> Iterator[Image]:
        return iter(self.images)

    def reset_iterator(self):
        self.iterator = -1

    def set_first_iterator(self):
        self.iterator = 0

    def set_last_iterator(self):
        self.iterator = len(self.images) - 1

    def next_image(self) -> bool:
        if self.iterator + 1 < len(self.images):
            self.iterator += 1
            return True
        return False

    def previous_image(self) -> bool:
        if self.iterator > 0:
            self.iterator -= 1
            return True
        return False

    # -- IO (MagickReadImage / MagickWriteImage / blobs) --
    def read_image(self, filename: str) -> "MagickWand":
        size = self.settings.get("size")
        self.images.extend(iio.read_images(filename, size=size,
                                           device=self.device))
        self.iterator = len(self.images) - 1
        return self

    def read_image_blob(self, blob: bytes, fmt: Optional[str] = None):
        self.images.extend(iio.image_from_blob(blob, fmt, self.device))
        self.iterator = len(self.images) - 1
        return self

    def write_image(self, filename: str):
        iio.write_image(self.current, filename, quality=self.quality)

    def write_images(self, filename: str, adjoin: bool = True):
        iio.write_image(self.images if adjoin else self.current, filename,
                        quality=self.quality)

    def get_image_blob(self, fmt: str = "png") -> bytes:
        return iio.image_to_blob(self.current, fmt, quality=self.quality)

    def get_images_blob(self, fmt: str = "gif") -> bytes:
        return iio.image_to_blob(self.images, fmt, quality=self.quality)

    def new_image(self, width: int, height: int,
                  background: Union[str, PixelWand] = "white"):
        color = background.get_color_string() if isinstance(background, PixelWand) else background
        from ..io import pseudo

        self.images.append(pseudo.xc(color, width, height, self.device))
        self.iterator = len(self.images) - 1
        return self

    def add_image(self, other: Union["MagickWand", Image]):
        if isinstance(other, MagickWand):
            self.images.extend(other.images)
        else:
            self.images.append(other)
        self.iterator = len(self.images) - 1

    def remove_image(self):
        del self.images[self.iterator if self.iterator >= 0 else -1]
        self.iterator = min(self.iterator, len(self.images) - 1)

    def get_image(self) -> Image:
        return self.current

    def set_image(self, img: Image):
        self._set_current(img)

    # -- geometry properties (MagickGetImageWidth/...) --
    @property
    def width(self) -> int:
        return self.current.width

    @property
    def height(self) -> int:
        return self.current.height

    def get_image_width(self):
        return self.width

    def get_image_height(self):
        return self.height

    def get_image_colorspace(self) -> str:
        return self.current.colorspace

    def get_image_alpha_channel(self) -> bool:
        return self.current.alpha

    def get_image_depth(self) -> int:
        return self.current.spec.depth

    def set_image_depth(self, depth: int):
        self._set_current(self.current.replace(
            spec=self.current.spec.with_(depth=depth)))

    def get_image_format(self) -> str:
        return self.current.properties.get("format", "MIFF")

    def set_image_format(self, fmt: str):
        self.current.properties["format"] = fmt.upper()

    # -- properties / profiles (magick-property.c, 73 exports) --
    def get_image_property(self, key: str):
        return self.current.properties.get(key)

    def set_image_property(self, key: str, value: str):
        self.current.properties[key] = value

    def get_image_properties(self, pattern: str = "*"):
        import fnmatch

        return {k: v for k, v in self.current.properties.items()
                if fnmatch.fnmatch(k, pattern)}

    def delete_image_property(self, key: str):
        self.current.properties.pop(key, None)

    def get_image_profile(self, name: str):
        return self.current.profiles.get(name)

    def set_image_profile(self, name: str, blob: bytes):
        self.current.profiles[name] = blob

    def remove_image_profile(self, name: str):
        return self.current.profiles.pop(name, None)

    def strip_image(self):
        self.current.properties.clear()
        self.current.profiles.clear()

    # =====================================================================
    # Image operators — the MagickWand method checklist (magick-image.c)
    # =====================================================================

    def _apply(self, fn, spec=None, all_images=True, tag=None):
        """Run an op over the targeted images.

        ``tag`` (optional) is an ops/dispatch.py chain tag: when present
        the op is first offered to the fused kernel K1, one op at a time
        (accelerate.c try-first pattern, accelerate.c:3986), and ``fn``
        runs where dispatch declines it.  ``try_fused_chain`` counts its
        launch in ``dispatch.COUNTS["fused"]``; its errors propagate."""
        from ..ops import dispatch as _dsp

        targets = range(len(self.images)) if all_images else \
            [self.iterator if self.iterator >= 0 else len(self.images) - 1]
        for i in targets:
            img = self.images[i]
            data = None
            if tag is not None:
                res = _dsp.try_fused_chain(img.data, [tag],
                                           alpha=img.spec.alpha)
                if res is not None:
                    data = res[0]
            if data is None:
                data = fn(img)
            self.images[i] = Image(data, spec or img.spec, img.properties,
                                   img.profiles, img.page, img.delay)

    # --- resize family ---
    def resize_image(self, width: int, height: int,
                     filter_name: str = "undefined", blur: float = 1.0):
        from ..ops import resize as rz
        from ..ops.resize import _default_filter

        f = filter_name if filter_name != "undefined" else self.filter
        tag = None
        if self.images and blur == 1.0:
            im0 = self.images[0]
            # alpha images tag too — dispatch opacity-probes at runtime
            rf = f if f not in ("undefined", "", None) else \
                _default_filter(im0.height, im0.width, height, width,
                                im0.spec.alpha)
            tag = ("resize", (height, width, rf))
        self._apply(lambda im: rz.resize(im.data, height, width, f, blur,
                                         has_alpha=im.spec.alpha), tag=tag)

    def adaptive_resize_image(self, width, height):
        self.resize_image(width, height, "mitchell")

    def scale_image(self, width, height):
        from ..ops import resize as rz

        self._apply(lambda im: rz.scale(im.data, height, width))

    def sample_image(self, width, height):
        from ..ops import resize as rz

        self._apply(lambda im: rz.sample(im.data, height, width))

    def thumbnail_image(self, width, height):
        from ..ops import resize as rz

        self._apply(lambda im: rz.thumbnail(im.data, height, width,
                                            has_alpha=im.spec.alpha))

    def magnify_image(self):
        from ..ops import resize as rz

        self._apply(lambda im: rz.magnify(im.data))

    def minify_image(self):
        from ..ops import resize as rz

        self._apply(lambda im: rz.resize(im.data, max(im.data.shape[-3] // 2, 1),
                                         max(im.data.shape[-2] // 2, 1), "box"))

    def transform_image(self, crop: str = "", resize: str = ""):
        if crop:
            self.crop_image_geometry(crop)
        if resize:
            img = self.current
            w, h, _, _ = parse_meta_geometry(resize, img.width, img.height)
            self.resize_image(w, h)

    def liquid_rescale_image(self, width, height, delta_x=1.0, rigidity=0.0):
        from ..ops import distort as dt

        self._apply(lambda im: dt.liquid_rescale(im.data, width, height,
                                                 delta_x, rigidity))

    def sparse_color_image(self, method, points):
        from ..ops import distort as dt

        self._apply(lambda im: dt.sparse_color(im.data, method, points))

    # --- geometry ---
    def crop_image(self, width, height, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.crop(im.data, x, y, width, height))

    def crop_image_geometry(self, geometry: str):
        from ..core.geometry import parse_page_geometry
        img = self.current
        w, h, x, y = parse_page_geometry(geometry, img.width, img.height)
        self.crop_image(w, h, x, y)

    def chop_image(self, width, height, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.chop(im.data, x, y, width, height))

    def extent_image(self, width, height, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.extent(im.data, x, y, width, height,
                                         background=self.background.get_color()))

    def flip_image(self):
        from ..ops import transform as tf

        self._apply(lambda im: tf.flip(im.data))

    def flop_image(self):
        from ..ops import transform as tf

        self._apply(lambda im: tf.flop(im.data))

    def roll_image(self, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.roll(im.data, x, y))

    def shave_image(self, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.shave(im.data, x, y))

    def splice_image(self, width, height, x, y):
        from ..ops import transform as tf

        self._apply(lambda im: tf.splice(im.data, x, y, width, height,
                                         background=self.background.get_color()))

    def trim_image(self, fuzz: float = 0.0):
        from ..ops import transform as tf

        self._apply(lambda im: tf.trim(im.data, fuzz))

    def transpose_image(self):
        from ..ops import transform as tf

        self._apply(lambda im: tf.transpose(im.data))

    def transverse_image(self):
        from ..ops import transform as tf

        self._apply(lambda im: tf.transverse(im.data))

    def rotate_image(self, background, degrees: float):
        from ..ops import distort as dt

        bg = background.get_color() if isinstance(background, PixelWand) \
            else parse_color(background)
        self._apply(lambda im: dt.rotate(im.data, degrees, bg))

    def auto_orient_image(self):
        from ..ops import transform as tf

        def fn(im):
            o = int(im.properties.get("exif:Orientation", 1))
            return tf.auto_orient(im.data, o)

        self._apply(fn)

    def shear_image(self, background, x_shear: float, y_shear: float):
        from ..ops import shear as sh

        bg = background.get_color() if isinstance(background, PixelWand) \
            else parse_color(background)
        self._apply(lambda im: sh.shear(im.data, x_shear, y_shear, bg))

    def deskew_image(self, threshold: float = 0.4):
        from ..ops import shear as sh

        self._apply(lambda im: sh.deskew(im.data, threshold))

    def distort_image(self, method: str, args, bestfit=False):
        from ..ops import distort as dt

        self._apply(lambda im: dt.distort(
            im.data, method, args,
            background=self.background.get_color(), bestfit=bool(bestfit)))

    def affine_transform_image(self, matrix):
        from ..ops import distort as dt

        self._apply(lambda im: dt.affine_transform(im.data, matrix))

    # --- blur family ---
    def blur_image(self, radius: float = 0.0, sigma: float = 1.0):
        from ..ops import blur as bl

        tag = ("gblur", (float(radius), float(sigma), "1d")) \
            if sigma > 0 else None
        self._apply(lambda im: bl.blur(im.data, radius, sigma), tag=tag)

    def gaussian_blur_image(self, radius: float = 0.0, sigma: float = 1.0):
        from ..ops import blur as bl

        tag = ("gblur", (float(radius), float(sigma), "2d")) \
            if sigma > 0 else None
        self._apply(lambda im: bl.gaussian_blur(im.data, radius, sigma),
                    tag=tag)

    def adaptive_blur_image(self, radius=0.0, sigma=1.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.adaptive_blur(im.data, radius, sigma))

    def adaptive_sharpen_image(self, radius=0.0, sigma=1.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.adaptive_sharpen(im.data, radius, sigma))

    def sharpen_image(self, radius=0.0, sigma=1.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.sharpen(im.data, radius, sigma))

    def unsharp_mask_image(self, radius=0.0, sigma=1.0, gain=1.0, threshold=0.05):
        from ..ops import blur as bl

        self._apply(lambda im: bl.unsharp_mask(im.data, radius, sigma, gain, threshold))

    def motion_blur_image(self, radius=0.0, sigma=1.0, angle=0.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.motion_blur(im.data, radius, sigma, angle))

    def rotational_blur_image(self, angle):
        from ..ops import blur as bl

        self._apply(lambda im: bl.rotational_blur(im.data, angle))

    def selective_blur_image(self, radius, sigma, threshold):
        from ..ops import blur as bl

        self._apply(lambda im: bl.selective_blur(im.data, radius, sigma, threshold))

    def bilateral_blur_image(self, width=5, height=5, intensity_sigma=0.75,
                             spatial_sigma=None):
        from ..ops import blur as bl

        self._apply(lambda im: bl.bilateral_blur(im.data, width, height,
                                                 intensity_sigma, spatial_sigma))

    def kuwahara_image(self, radius=1.0, sigma=None):
        from ..ops import blur as bl

        self._apply(lambda im: bl.kuwahara(im.data, radius, sigma))

    def despeckle_image(self):
        from ..ops import blur as bl

        self._apply(lambda im: bl.despeckle(im.data))

    def edge_image(self, radius=0.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.edge_image(im.data, radius))

    def emboss_image(self, radius=0.0, sigma=1.0):
        from ..ops import blur as bl

        self._apply(lambda im: bl.emboss(im.data, radius, sigma))

    def shade_image(self, gray, azimuth, elevation):
        from ..ops import blur as bl

        self._apply(lambda im: bl.shade(im.data, azimuth, elevation, gray))

    def spread_image(self, radius, method="bilinear"):
        from ..ops import blur as bl

        self._apply(lambda im: bl.spread(im.data, radius))

    def convolve_image(self, kernel):
        from ..ops import blur as bl

        self._apply(lambda im: bl.convolve(im.data, kernel))

    def morphology_image(self, method: str, iterations: int, kernel: str):
        from ..ops import morphology as mo

        self._apply(lambda im: mo.morphology(im.data, method, kernel, iterations))

    def statistic_image(self, stat: str, width: int, height: int):
        from ..ops import statistic as stx

        self._apply(lambda im: stx.statistic(im.data, stat, width, height))

    def local_contrast_image(self, radius=10.0, strength=12.5):
        from ..ops import blur as bl

        self._apply(lambda im: bl.local_contrast(im.data, radius, strength))

    def wavelet_denoise_image(self, threshold=0.05, softness=0.0):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.wavelet_denoise(im.data, threshold, softness))

    # --- colorspace / enhancement ---
    def transform_image_colorspace(self, colorspace: str):
        for i in range(len(self.images)):
            self.images[i] = self.images[i].transform_colorspace(colorspace)

    def negate_image(self, gray_only: bool = False):
        from ..ops import enhance as en

        self._apply(lambda im: en.negate(im.data, gray_only))

    def gamma_image(self, gamma: float):
        from ..ops import enhance as en

        self._apply(lambda im: en.gamma(im.data, gamma))

    def level_image(self, black=0.0, gamma=1.0, white=1.0):
        from ..ops import enhance as en

        self._apply(lambda im: en.level(im.data, black, white, gamma))

    def levelize_image(self, black=0.0, gamma=1.0, white=1.0):
        from ..ops import enhance as en

        self._apply(lambda im: en.levelize(im.data, black, white, gamma))

    def auto_level_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.auto_level(im.data))

    def auto_gamma_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.auto_gamma(im.data))

    def normalize_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.normalize(im.data))

    def equalize_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.equalize(im.data))

    def contrast_stretch_image(self, black_point=0.0, white_point=None):
        from ..ops import enhance as en

        self._apply(lambda im: en.contrast_stretch(im.data, black_point, white_point))

    def linear_stretch_image(self, black_point=0.02, white_point=0.01):
        from ..ops import enhance as en

        self._apply(lambda im: en.linear_stretch(im.data, black_point, white_point))

    def sigmoidal_contrast_image(self, sharpen=True, contrast=3.0, midpoint=0.5):
        from ..ops import enhance as en

        self._apply(lambda im: en.sigmoidal_contrast(im.data, sharpen, contrast, midpoint))

    def brightness_contrast_image(self, brightness=0.0, contrast=0.0):
        from ..ops import enhance as en

        self._apply(lambda im: en.brightness_contrast(im.data, brightness, contrast))

    def modulate_image(self, brightness=100.0, saturation=100.0, hue=100.0):
        from ..ops import enhance as en

        self._apply(lambda im: en.modulate(im.data, brightness, saturation, hue))

    def contrast_image(self, sharpen: bool = True):
        from ..ops import enhance as en

        self._apply(lambda im: en.sigmoidal_contrast(im.data, sharpen, 4.0, 0.5))

    def clahe_image(self, width=0, height=0, bins=128, clip_limit=3.0):
        """MagickCLAHEImage — width/height are tile sizes in pixels
        (CLAHEImage semantics), 0 means dims>>3."""
        from ..ops import enhance as en

        self._apply(lambda im: en.clahe_reference(im.data, width, height,
                                                  bins, clip_limit))

    def white_balance_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.white_balance(im.data))

    def enhance_image(self):
        from ..ops import enhance as en

        self._apply(lambda im: en.enhance(im.data))

    def clut_image(self, clut_wand: "MagickWand"):
        from ..ops import enhance as en

        lut = clut_wand.current.data
        self._apply(lambda im: en.clut(im.data, lut))

    def hald_clut_image(self, hald_wand: "MagickWand"):
        from ..ops import enhance as en

        hald = hald_wand.current.data
        self._apply(lambda im: en.hald_clut(im.data, hald))

    def color_decision_list_image(self, cdl: str):
        from ..ops import enhance as en

        self._apply(lambda im: en.color_decision_list(im.data))

    def grayscale_image(self, method="rec709luma"):
        from ..ops import enhance as en

        for i in range(len(self.images)):
            im = self.images[i]
            self.images[i] = Image(en.grayscale(im.data, method),
                                   im.spec.with_(colorspace="gray"),
                                   im.properties, im.profiles)

    def sepia_tone_image(self, threshold=0.8):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.sepia_tone(im.data, threshold))

    def solarize_image(self, threshold=0.5):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.solarize(im.data, threshold))

    def blue_shift_image(self, factor=1.5):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.blue_shift(im.data, factor))

    def colorize_image(self, color, alpha):
        from ..ops import visual_effects as vfx

        col = color.get_color() if isinstance(color, PixelWand) else parse_color(color)
        amt = alpha.get_color()[:3] if isinstance(alpha, PixelWand) else (alpha,) * 3
        self._apply(lambda im: vfx.colorize(im.data, col, amt))

    def tint_image(self, tint, alpha=0.5):
        from ..ops import visual_effects as vfx

        col = tint.get_color() if isinstance(tint, PixelWand) else parse_color(tint)
        blend = (float(alpha) * 100.0,) * 3
        self._apply(lambda im: vfx.tint(im.data, col, blend))

    def color_matrix_image(self, matrix):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.color_matrix(im.data, matrix))

    def add_noise_image(self, noise_type="gaussian", attenuate=1.0):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.add_noise(im.data, noise_type, attenuate))

    def vignette_image(self, radius=0.0, sigma=10.0, x=0, y=0):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.vignette(im.data, radius, sigma, x, y))

    def charcoal_image(self, radius=0.0, sigma=1.0):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.charcoal(im.data, radius, sigma))

    def sketch_image(self, radius=0.0, sigma=1.0, angle=0.0):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.sketch(im.data, radius, sigma, angle))

    def swirl_image(self, degrees, method="bilinear"):
        from ..ops import distort as dt

        self._apply(lambda im: dt.swirl(im.data, degrees))

    def implode_image(self, amount, method="bilinear"):
        from ..ops import distort as dt

        self._apply(lambda im: dt.implode(im.data, amount))

    def wave_image(self, amplitude, wavelength, method="bilinear"):
        from ..ops import distort as dt

        self._apply(lambda im: dt.wave(im.data, amplitude, wavelength))

    def oil_paint_image(self, radius=3.0, sigma=0.0):
        from ..ops import paint as pt

        self._apply(lambda im: pt.oil_paint(im.data, radius, sigma))

    # --- thresholds / quantize ---
    def threshold_image(self, threshold: float):
        from ..ops import threshold as th

        self._apply(lambda im: th.bilevel(im.data, threshold))

    def black_threshold_image(self, threshold):
        from ..ops import threshold as th

        if isinstance(threshold, str):
            threshold = PixelWand(threshold)
        t = threshold.red if isinstance(threshold, PixelWand) else threshold
        self._apply(lambda im: th.black_threshold(im.data, t))

    def white_threshold_image(self, threshold):
        from ..ops import threshold as th

        if isinstance(threshold, str):
            threshold = PixelWand(threshold)
        t = threshold.red if isinstance(threshold, PixelWand) else threshold
        self._apply(lambda im: th.white_threshold(im.data, t))

    def auto_threshold_image(self, method="otsu"):
        from ..ops import threshold as th

        for i in range(len(self.images)):
            im = self.images[i]
            self.images[i] = Image(th.auto_threshold(im.data, method),
                                   ImageSpec(colorspace="gray"), im.properties)

    def adaptive_threshold_image(self, width, height, bias=0.0):
        from ..ops import threshold as th

        self._apply(lambda im: th.adaptive_threshold(im.data, width, height, bias))

    def ordered_dither_image(self, map_name="o8x8", levels=2):
        from ..ops import threshold as th

        self._apply(lambda im: th.ordered_dither(im.data, map_name, levels))

    def random_threshold_image(self, low=0.0, high=1.0):
        from ..ops import threshold as th

        self._apply(lambda im: th.random_threshold(im.data, low, high))

    def range_threshold_image(self, lo_b, lo_w, hi_w, hi_b):
        from ..ops import threshold as th

        self._apply(lambda im: th.range_threshold(im.data, lo_b, lo_w, hi_w, hi_b))

    def clamp_image(self):
        from ..ops import threshold as th

        self._apply(lambda im: th.clamp(im.data))

    def posterize_image(self, levels: int, dither=False):
        from ..ops import quantize as qz

        self._apply(lambda im: qz.posterize(im.data, levels, dither))

    def quantize_image(self, number_colors: int, colorspace="srgb",
                       treedepth=0, dither=False, measure_error=False):
        """MagickQuantizeImage: the reference octree quantizer (the host
        library ``native/riemersma.cpp``; a build that fails raises) on a
        frame, its result back on the image's device; k-means on a batch."""
        from .. import native
        from ..ops import quantize as qz

        def run(im):
            arr = _host(im.data).astype(np.float32)
            meth = dither if isinstance(dither, str) else \
                ("riemersma" if dither else "none")
            if arr.ndim != 3:
                return qz.kmeans_quantize(im.data, number_colors)
            res = native.octree_quantize(arr, number_colors, meth,
                                         int(treedepth))
            return torch.from_numpy(res[0]).to(im.data.device)

        self._apply(run)

    def kmeans_image(self, number_colors, max_iterations=20, tolerance=1e-4):
        from ..ops import quantize as qz

        self._apply(lambda im: qz.kmeans_quantize(im.data, number_colors,
                                                  max_iterations))

    def remap_image(self, palette_wand: "MagickWand", dither=False):
        """MagickRemapImage: a frame through the host octree library, its
        result back on the image's device; a batch through
        ``quantize.remap`` on its device (under a dither, the palette-walk
        kernel on a card)."""
        from .. import native
        from ..ops import quantize as qz

        pal = palette_wand.current.data.reshape(-1, palette_wand.current.channels)

        def run(im):
            if im.data.dim() != 3:
                return qz.remap(im.data, pal[:, : im.channels].to(
                    im.data.device), bool(dither))
            meth = dither if isinstance(dither, str) else \
                ("riemersma" if dither else "none")
            res = native.octree_remap(_host(im.data).astype(np.float32),
                                      _host(pal).astype(np.float32), meth)
            return torch.from_numpy(res).to(im.data.device)

        self._apply(run)

    # --- evaluate / function / fx ---
    def evaluate_image(self, operator: str, value: float = 0.0):
        from ..ops import statistic as stx

        self._apply(lambda im: stx.evaluate(im.data, operator, value))

    def function_image(self, function: str, args):
        from ..ops import statistic as stx

        self._apply(lambda im: stx.function(im.data, function, args))

    def fx_image(self, expression: str) -> "MagickWand":
        from ..ops import fx as fxm

        out = MagickWand(self.device)
        data = fxm.fx([im.data for im in self.images], expression)
        out.images = [Image(data, self.current.spec)]
        out.iterator = 0
        return out

    # --- channels / alpha ---
    def separate_image_channel(self, channel: str):
        from ..ops import channel as ch

        for i in range(len(self.images)):
            im = self.images[i]
            self.images[i] = Image(ch.separate(im.data, channel),
                                   ImageSpec(colorspace="gray"), im.properties)

    def combine_images(self, colorspace="srgb") -> "MagickWand":
        from ..ops import channel as ch

        out = MagickWand(self.device)
        data = ch.combine([im.data for im in self.images])
        alpha = data.shape[-1] in (2, 4)
        out.images = [Image(data, ImageSpec(colorspace=colorspace, alpha=alpha))]
        out.iterator = 0
        return out

    def set_image_alpha_channel(self, operation: str):
        from ..ops import channel as ch

        for i in range(len(self.images)):
            im = self.images[i]
            data = ch.set_alpha(im.data, operation, im.spec.alpha,
                                background=self.background.get_color()[:3])
            alpha = data.shape[-1] > im.spec.color_channels
            if operation == "extract":
                self.images[i] = Image(data, ImageSpec(colorspace="gray"))
            else:
                self.images[i] = Image(data, im.spec.with_(alpha=alpha),
                                       im.properties, im.profiles)

    def channel_fx_image(self, expression: str) -> "MagickWand":
        from ..ops import channel as ch

        out = self.clone()
        out._apply(lambda im: ch.channel_fx(im.data, expression, im.spec.alpha))
        return out

    # --- composite / compare ---
    def composite_image(self, source: "MagickWand", operator: str = "over",
                        x: int = 0, y: int = 0):
        from ..ops import composite as comp

        src = source.current
        img = self.current
        out = comp.composite_at(img.data, src.data, operator, x, y,
                                self.gravity,
                                dst_alpha=img.spec.alpha, src_alpha=src.spec.alpha)
        alpha = out.shape[-1] > img.spec.color_channels
        self._set_current(Image(out, img.spec.with_(alpha=alpha),
                                img.properties, img.profiles))

    def compare_images(self, reference: "MagickWand", metric: str = "rmse"):
        from ..ops import compare as cmp_ops

        d = cmp_ops.get_distortion(self.current.data, reference.current.data, metric)
        vis, _ = cmp_ops.compare_images(self.current.data, reference.current.data, metric)
        w = MagickWand(self.device)
        w.images = [Image(vis, self.current.spec)]
        w.iterator = 0
        return w, float(d)

    def get_image_distortion(self, reference: "MagickWand", metric="rmse") -> float:
        from ..ops import compare as cmp_ops

        return float(cmp_ops.get_distortion(self.current.data,
                                            reference.current.data, metric))

    def similarity_image(self, template: "MagickWand"):
        from ..ops import compare as cmp_ops

        (y, x), corr = cmp_ops.similarity_image(self.current.data,
                                                template.current.data)
        return (int(x), int(y))

    # --- paint ---
    def floodfill_paint_image(self, fill, fuzz, bordercolor, x, y, invert=False):
        from ..ops import paint as pt

        col = fill.get_color() if isinstance(fill, PixelWand) else parse_color(fill)
        self._apply(lambda im: pt.floodfill(im.data, x, y, col, fuzz))

    def opaque_paint_image(self, target, fill, fuzz=0.0, invert=False):
        from ..ops import paint as pt

        t = target.get_color() if isinstance(target, PixelWand) else parse_color(target)
        f = fill.get_color() if isinstance(fill, PixelWand) else parse_color(fill)
        self._apply(lambda im: pt.opaque_paint(im.data, t, f, fuzz, invert))

    def transparent_paint_image(self, target, alpha=0.0, fuzz=0.0, invert=False):
        from ..ops import paint as pt

        t = target.get_color() if isinstance(target, PixelWand) else parse_color(target)

        def fn(im):
            data = im.data
            if not im.spec.alpha:
                data = _with_opaque_alpha(data)
            return pt.transparent_paint(data, t[:3], alpha, fuzz, invert)

        for i in range(len(self.images)):
            im = self.images[i]
            self.images[i] = Image(fn(im), im.spec.with_(alpha=True),
                                   im.properties, im.profiles)

    # --- decorations / sequence ---
    def border_image(self, color, width, height, compose="over"):
        from ..ops import decorate as dec

        col = color.get_color() if isinstance(color, PixelWand) else parse_color(color)
        self._apply(lambda im: dec.border(im.data, width, height, col))

    def frame_image(self, color, width, height, inner=2, outer=2, compose="over"):
        from ..ops import decorate as dec

        col = color.get_color() if isinstance(color, PixelWand) else parse_color(color)
        self._apply(lambda im: dec.frame(im.data, width, height, outer, inner, col))

    def raise_image(self, width=6, height=6, x=0, y=0, raise_=True):
        from ..ops import decorate as dec

        self._apply(lambda im: dec.raise_image(im.data, width, height, raise_))

    def append_images(self, top_to_bottom: bool = True) -> "MagickWand":
        axis = -3 if top_to_bottom else -2
        datas = [im.data for im in self.images]
        # the other axis padded to the widest by repeating the edge
        pad = -2 if top_to_bottom else -3
        n = max(d.shape[pad] for d in datas)
        datas = [_edge_pad(d, pad, n) for d in datas]
        out = MagickWand(self.device)
        out.images = [Image(torch.cat(datas, dim=axis), self.images[0].spec)]
        out.iterator = 0
        return out

    def smush_images(self, stacked: bool, offset: int = 0) -> "MagickWand":
        return self.append_images(stacked)

    def coalesce_images(self) -> "MagickWand":
        from ..ops import layer as ly

        out = MagickWand(self.device)
        out.images = ly.coalesce(self.images)
        out.iterator = len(out.images) - 1
        return out

    def deconstruct_images(self) -> "MagickWand":
        from ..ops import layer as ly

        out = MagickWand(self.device)
        out.images = ly.deconstruct(self.images)
        out.iterator = len(out.images) - 1
        return out

    def optimize_image_layers(self) -> "MagickWand":
        from ..ops import layer as ly

        out = MagickWand(self.device)
        out.images = ly.optimize_layers(self.images)
        out.iterator = len(out.images) - 1
        return out

    def merge_image_layers(self, method: str = "flatten") -> "MagickWand":
        from ..ops import layer as ly

        out = MagickWand(self.device)
        if method == "mosaic":
            out.images = [ly.mosaic(self.images)]
        else:
            out.images = [ly.flatten(self.images)]
        out.iterator = 0
        return out

    def montage_image(self, tile="", thumbnail_geometry="120x120+4+3",
                      mode="unframe", frame="") -> "MagickWand":
        from ..ops import montage as mo

        out = MagickWand(self.device)
        out.images = [mo.montage(self.images, tile, thumbnail_geometry)]
        out.iterator = 0
        return out

    def evaluate_images(self, operator: str) -> "MagickWand":
        from ..ops import statistic as stx

        stack = torch.stack([im.data for im in self.images])
        out = MagickWand(self.device)
        out.images = [Image(stx.evaluate_images(stack, operator),
                            self.images[0].spec)]
        out.iterator = 0
        return out

    # --- drawing / annotation ---
    def draw_image(self, drawing: Union[str, "DrawingWand"]):
        from ..ops import draw as dwm

        mvg = drawing.get_mvg() if isinstance(drawing, DrawingWand) else drawing
        self._apply(lambda im: dwm.draw(im.data, mvg, im.spec.alpha))

    def annotate_image(self, drawing, x: float, y: float, angle: float, text: str):
        from ..ops import draw as dwm

        color = (0, 0, 0, 1)
        size = self.pointsize
        font = self.font
        direction = None
        if isinstance(drawing, DrawingWand):
            color = drawing.gc_fill
            size = drawing.gc_font_size
            font = drawing.gc_font
            direction = drawing.get_text_direction()
            if direction in ("undefined", ""):
                direction = None
        self._apply(lambda im: dwm.draw_text(im.data, text, x, y, color,
                                             size, font,
                                             direction=direction))

    def query_font_metrics(self, drawing, text: str):
        from ..ops import draw as dwm

        size = drawing.gc_font_size if isinstance(drawing, DrawingWand) else self.pointsize
        return dwm.get_type_metrics(text, size=size)

    # --- statistics / info ---
    def get_image_statistics(self):
        from ..ops import statistic as stx

        return {k: _host(v) for k, v in stx.get_statistics(self.current.data).items()}

    def get_image_histogram(self):
        from ..ops import histogram as hg

        return hg.get_histogram(self.current.data)

    def get_image_colors(self) -> int:
        from ..ops import histogram as hg

        return int(hg.number_colors(self.current.data))

    def get_image_range(self):
        d = self.current.data
        return float(torch.min(d)), float(torch.max(d))

    def get_image_pixel_color(self, x: int, y: int) -> PixelWand:
        px = _host(self.current.data[..., y, x, :]).reshape(-1)
        return PixelWand(list(px))

    def export_image_pixels(self, x, y, width, height, channel_map="RGB",
                            storage="float"):
        """MagickExportImagePixels (quantum-export analog)."""
        region = _host(self.current.data[y:y + height, x:x + width])
        out = _map_channels(region, channel_map, self.current.spec)
        if storage in ("char", "uint8"):
            return (out * 255.0 + 0.5).astype(np.uint8)
        if storage in ("short", "uint16"):
            return (out * 65535.0 + 0.5).astype(np.uint16)
        if storage == "double":
            return out.astype(np.float64)
        return out.astype(np.float32)

    def import_image_pixels(self, x, y, width, height, channel_map, pixels):
        arr = np.asarray(pixels)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        elif arr.dtype == np.uint16:
            arr = arr.astype(np.float32) / 65535.0
        arr = arr.reshape(height, width, len(channel_map))
        inv = _inverse_map_channels(arr, channel_map, self.current.spec)
        img = self.current
        data = img.data.clone()
        data[y:y + height, x:x + width, :] = _on(inv[..., : img.channels],
                                                 data)
        self._set_current(img.replace(data=data))

    # --- visual effects (second batch) ---
    def shadow_image(self, alpha=80.0, sigma=3.0, x=5, y=5):
        from ..ops import visual_effects as vfx

        img = self.current
        data = img.data
        if not img.spec.alpha:
            data = _with_opaque_alpha(data)
        sh = vfx.shadow(data, alpha, sigma, x, y)
        self._set_current(Image(sh, img.spec.with_(alpha=True), img.properties))

    def polaroid_image(self, drawing=None, caption="", angle=0.0, method="bilinear"):
        from ..ops import visual_effects as vfx

        self._apply(lambda im: vfx.polaroid(im.data, angle))

    def stegano_image(self, watermark: "MagickWand", offset=0) -> "MagickWand":
        from ..ops import visual_effects as vfx

        out = self.clone()
        wm = watermark.current.data
        out._apply(lambda im: vfx.stegano(im.data, wm, offset))
        return out

    def stereo_image(self, offset_wand: "MagickWand") -> "MagickWand":
        from ..ops import visual_effects as vfx

        out = MagickWand(self.device)
        data = vfx.stereo(self.current.data, offset_wand.current.data)
        out.images = [Image(data, self.current.spec)]
        out.iterator = 0
        return out

    def texture_image(self, texture: "MagickWand") -> "MagickWand":
        """MagickTextureImage: tile a texture to this image's size."""
        t = texture.current.data
        h, w = self.height, self.width
        reps_y = -(-h // t.shape[-3])
        reps_x = -(-w // t.shape[-2])
        tiled = t.repeat(reps_y, reps_x, 1)[:h, :w]
        out = MagickWand(self.device)
        out.images = [Image(tiled, texture.current.spec)]
        out.iterator = 0
        return out

    def unique_image_colors(self) -> "MagickWand":
        from ..ops import histogram as hg

        colors, _ = hg.unique_colors(self.current.data)
        out = MagickWand(self.device)
        out.images = [Image(colors.reshape(1, -1, colors.shape[-1]),
                            self.current.spec,
                            device=self.current.data.device)]
        out.iterator = 0
        return out

    def get_image_region(self, width, height, x, y) -> "MagickWand":
        from ..ops import transform as tf

        out = MagickWand(self.device)
        out.images = [Image(tf.excerpt(self.current.data, x, y, width, height),
                            self.current.spec)]
        out.iterator = 0
        return out

    # --- page / metadata accessors ---
    def get_image_page(self):
        """MagickGetImagePage: returns (width, height, x, y); page is
        stored internally as (x, y, w, h)."""
        if self.current.page is None:
            return (self.width, self.height, 0, 0)
        x, y, w, h = self.current.page
        return (w, h, x, y)

    def set_image_page(self, width, height, x, y):
        self.current.page = (x, y, width, height)

    def reset_image_page(self, geometry=""):
        self.current.page = None

    def get_image_delay(self):
        return self.current.delay

    def set_image_delay(self, delay):
        self.current.delay = int(delay)

    def get_image_orientation(self):
        return int(self.current.properties.get("exif:Orientation", 1))

    def set_image_orientation(self, orientation):
        self.current.properties["exif:Orientation"] = int(orientation)

    def get_image_resolution(self):
        d = self.current.properties.get("density", "72x72")
        parts = str(d).replace("x", " ").split()
        return float(parts[0]), float(parts[-1])

    def set_image_resolution(self, x, y):
        self.current.properties["density"] = f"{x}x{y}"

    def get_image_gravity(self):
        return self.gravity

    def set_image_gravity(self, gravity):
        self.gravity = gravity

    def get_gravity(self):
        """MagickGetGravity (magick-property.c)."""
        return self.gravity

    def set_gravity(self, gravity):
        self.gravity = gravity

    def get_font(self):
        """MagickGetFont (magick-property.c)."""
        return self.font

    def set_font(self, font):
        self.font = font

    def set_background_color(self, color):
        self.background = color if isinstance(color, PixelWand) else PixelWand(color)

    def get_background_color(self):
        return self.background

    def get_image_signature(self) -> str:
        return self.signature()

    def get_number_images(self) -> int:
        return len(self.images)

    def get_image_total_ink_density(self) -> float:
        """MagickGetImageTotalInkDensity (prepress.c GetImageTotalInkDensity)."""
        img = self.current
        if img.spec.colorspace == "cmyk":
            return float(torch.max(torch.sum(img.data[..., :4], dim=-1)))
        cmyk = img.transform_colorspace("cmyk")
        return float(torch.max(torch.sum(cmyk.data[..., :4], dim=-1)))

    def encipher_image(self, passphrase: str):
        from ..utils.signature import encipher_image

        self._apply(lambda im: encipher_image(im.data, passphrase))

    def decipher_image(self, passphrase: str):
        from ..utils.signature import decipher_image

        self._apply(lambda im: decipher_image(im.data, passphrase))

    def profile_image(self, name: str, profile: Optional[bytes]):
        """MagickProfileImage: apply (or remove with None) a profile."""
        if profile is None:
            return self.remove_image_profile(name)
        if name.lower() in ("icc", "icm"):
            from ..core.profile import profile_image

            self._set_current(profile_image(self.current, profile))
        else:
            self.set_image_profile(name, profile)

    def connected_components_image(self, connectivity=4):
        from ..ops import vision as vi

        img = self.current
        labels = vi.connected_components(img.data, connectivity, self.fuzz)
        return vi.component_statistics(img.data, labels)

    def hough_line_image(self, width=5, height=5, threshold=40):
        from ..ops import feature as ft

        return ft.hough_lines(self.current.data, width, height, threshold)

    def canny_edge_image(self, radius=0.0, sigma=1.0, lower=0.1, upper=0.3):
        from ..ops import feature as ft

        for i in range(len(self.images)):
            im = self.images[i]
            self.images[i] = Image(
                ft.canny_edge(im.data, radius, sigma, lower, upper),
                ImageSpec(colorspace="gray"), im.properties)

    def mean_shift_image(self, width=7, height=7, color_distance=0.1):
        from ..ops import feature as ft

        self._apply(lambda im: ft.mean_shift(im.data, width, height,
                                             color_distance))

    def segment_image(self, colorspace="srgb", verbose=False,
                      cluster_threshold=1.0, smooth_threshold=1.5):
        from ..ops import segment as sg

        self._apply(lambda im: sg.segment(im.data, colorspace,
                                          cluster_threshold, smooth_threshold))

    def deconstruct_images_wand(self):
        return self.deconstruct_images()

    def forward_fourier_transform_image(self, magnitude=True) -> "MagickWand":
        from ..ops import fourier as ft

        out = MagickWand(self.device)
        for im in self.images:
            mag, ph = ft.forward_fft(im.data, modulus=magnitude)
            out.images.append(Image(mag, im.spec))
            out.images.append(Image(ph, im.spec))
        out.iterator = len(out.images) - 1
        return out

    def inverse_fourier_transform_image(self, phase_wand: "MagickWand",
                                        magnitude=True):
        from ..ops import fourier as ft

        data = ft.inverse_fft(self.current.data, phase_wand.current.data,
                              modulus=magnitude)
        self._set_current(Image(data, self.current.spec))

    # --- misc ---
    def flatten_images(self) -> "MagickWand":
        return self.merge_image_layers("flatten")

    def signature(self) -> str:
        from ..utils.signature import signature_image

        return signature_image(self.current.data)

    # ------------------------------------------------------------------
    # Round 2: remaining magick-image.c exports (mechanical get/set pairs
    # + list ops).  Image-level attributes live in Image.properties.
    # ------------------------------------------------------------------

    def _iprop(self, key, default=""):
        return self.current.properties.get(key, default)

    def _set_iprop(self, key, value):
        self.current.properties[key] = value

    # attribute get/set pairs (MagickGet/SetImage*)
    def get_image_background_color(self) -> PixelWand:
        return PixelWand(self._iprop("background", "white"))

    def set_image_background_color(self, color):
        self._set_iprop("background", _color_str(color))

    def get_image_border_color(self) -> PixelWand:
        return PixelWand(self._iprop("bordercolor", "#dfdfdf"))

    def set_image_border_color(self, color):
        self._set_iprop("bordercolor", _color_str(color))

    def get_image_matte_color(self) -> PixelWand:
        return PixelWand(self._iprop("mattecolor", "#bdbdbd"))

    def set_image_matte_color(self, color):
        self._set_iprop("mattecolor", _color_str(color))

    def get_image_compose(self) -> str:
        return self._iprop("compose", "over")

    def set_image_compose(self, op: str):
        self._set_iprop("compose", op)

    def get_image_compression(self) -> str:
        return self._iprop("compression", "undefined")

    def set_image_compression(self, c: str):
        self._set_iprop("compression", c)

    def set_image_compression_quality(self, q: int):
        self.quality = int(q)

    def get_image_dispose(self) -> str:
        return self._iprop("dispose", "undefined")

    def set_image_dispose(self, d: str):
        self._set_iprop("dispose", d)

    def get_image_endian(self) -> str:
        return self._iprop("endian", "undefined")

    def set_image_endian(self, e: str):
        self._set_iprop("endian", e)

    def get_image_filter(self) -> str:
        return self._iprop("filter", self.filter)

    def set_image_filter(self, f: str):
        self._set_iprop("filter", f)

    def get_image_fuzz(self) -> float:
        return float(self._iprop("fuzz", self.fuzz) or 0.0)

    def set_image_fuzz(self, f: float):
        self._set_iprop("fuzz", float(f))

    def get_image_gamma(self) -> float:
        return float(self._iprop("gamma", 1.0 / 2.2))

    def set_image_gamma(self, g: float):
        self._set_iprop("gamma", float(g))

    def get_image_interlace_scheme(self) -> str:
        return self._iprop("interlace", "none")

    def set_image_interlace_scheme(self, s: str):
        self._set_iprop("interlace", s)

    def get_image_interpolate_method(self) -> str:
        return self._iprop("interpolate", "bilinear")

    def set_image_interpolate_method(self, m: str):
        self._set_iprop("interpolate", m)

    set_image_pixel_interpolate_method = set_image_interpolate_method

    def get_image_rendering_intent(self) -> str:
        return self._iprop("intent", "perceptual")

    def set_image_rendering_intent(self, i: str):
        self._set_iprop("intent", i)

    def get_image_units(self) -> str:
        return self._iprop("units", "undefined")

    def set_image_units(self, u: str):
        self._set_iprop("units", u)

    def get_image_virtual_pixel_method(self) -> str:
        return self._iprop("virtual-pixel", "edge")

    def set_image_virtual_pixel_method(self, m: str) -> str:
        prev = self.get_image_virtual_pixel_method()
        self._set_iprop("virtual-pixel", m)
        return prev

    def get_image_filename(self) -> str:
        return self._iprop("filename", "")

    def set_image_filename(self, name: str):
        self._set_iprop("filename", name)

    def get_image_scene(self) -> int:
        return int(self._iprop("scene", 0))

    def set_image_scene(self, s: int):
        self._set_iprop("scene", int(s))

    def get_image_ticks_per_second(self) -> int:
        return int(self._iprop("ticks-per-second", 100))

    def set_image_ticks_per_second(self, t: int):
        self._set_iprop("ticks-per-second", int(t))

    def set_image_iterations(self, n: int):
        self._set_iprop("loop", int(n))

    def get_image_length(self) -> int:
        """MagickGetImageLength: bytes of pixel storage."""
        d = self.current.data
        return int(d.numel() * d.element_size())

    def get_image_mean(self):
        from ..ops import statistic as stx

        s = stx.get_statistics(self.current.data)
        return (float(_host(s["mean"]).mean()),
                float(_host(s["std"]).mean()))

    def get_image_kurtosis(self):
        from ..ops import statistic as stx

        s = stx.get_statistics(self.current.data)
        return (float(_host(s.get("kurtosis", 0.0)).mean()),
                float(_host(s.get("skewness", 0.0)).mean()))

    def get_image_features(self, distance: int = 1):
        from ..ops import feature as ft

        return ft.glcm_features(self.current.data, offset=(0, distance))

    # chromaticity primaries / white point
    def get_image_red_primary(self):
        return tuple(float(v) for v in
                     self._iprop("red-primary", "0.64,0.33,0.03").split(","))

    def set_image_red_primary(self, x, y, z=0.0):
        self._set_iprop("red-primary", f"{x},{y},{z}")

    def get_image_green_primary(self):
        return tuple(float(v) for v in
                     self._iprop("green-primary", "0.3,0.6,0.1").split(","))

    def set_image_green_primary(self, x, y, z=0.0):
        self._set_iprop("green-primary", f"{x},{y},{z}")

    def get_image_blue_primary(self):
        return tuple(float(v) for v in
                     self._iprop("blue-primary", "0.15,0.06,0.79").split(","))

    def set_image_blue_primary(self, x, y, z=0.0):
        self._set_iprop("blue-primary", f"{x},{y},{z}")

    def get_image_white_point(self):
        return tuple(float(v) for v in
                     self._iprop("white-point", "0.3127,0.329,0.3583")
                     .split(","))

    def set_image_white_point(self, x, y, z=0.0):
        self._set_iprop("white-point", f"{x},{y},{z}")

    # type/colorspace/extent
    def get_image_type(self) -> str:
        from ..ops import attribute as attr

        return attr.image_type(self.current.data, self.current.spec.alpha)

    def set_image_type(self, t: str):
        from ..ops import attribute as attr

        img = self.current
        data = attr.set_image_type(img.data, t, img.spec.alpha)
        spec = img.spec
        if t.lower().startswith(("bilevel", "grayscale")):
            spec = spec.with_(colorspace="gray")
        elif data.shape[-1] >= 3 and spec.color_channels == 1:
            spec = spec.with_(colorspace="srgb")
        self._set_current(Image(data, spec, img.properties))

    def set_image_colorspace(self, cs: str):
        """Tag the colorspace without converting (SetImageColorspace)."""
        img = self.current
        self._set_current(Image(img.data,
                                img.spec.with_(colorspace=cs.lower()),
                                img.properties, img.profiles))

    def set_image_extent(self, width: int, height: int):
        from ..ops import transform as tf

        img = self.current
        self._set_current(img.replace(data=tf.extent(
            img.data, 0, 0, width, height,
            background=self.background.get_color()[:img.channels])))

    def set_image_alpha(self, alpha: float):
        img = self.current
        a = torch.full(img.data.shape[:-1] + (1,), float(alpha),
                       dtype=img.data.dtype, device=img.data.device)
        color = img.data[..., :img.spec.color_channels]
        self._set_current(Image(torch.cat([color, a], -1),
                                img.spec.with_(alpha=True), img.properties))

    def set_image_matte(self, matte: bool):
        if matte:
            self.set_image_alpha(1.0)

    def set_image_color(self, color):
        img = self.current
        c = PixelWand(_color_str(color)).get_color()[:img.channels]
        self._set_current(img.replace(
            data=_on(c, img.data).expand(img.data.shape).clone()))

    def set_image_pixel_color(self, x: int, y: int, color):
        img = self.current
        c = PixelWand(_color_str(color)).get_color()[:img.channels]
        data = img.data.clone()
        data[y, x, :] = _on(c, data)
        self._set_current(img.replace(data=data))

    def get_image_colormap_color(self, index: int) -> PixelWand:
        from ..ops import histogram as hg

        # the colors of (colors, counts); the JAX method hands numpy the
        # pair and raises on every image
        colors = hg.unique_colors(self.current.data)[0]
        i = min(index, len(colors) - 1)
        return PixelWand(tuple(float(v) for v in colors[i][:3]))

    def set_image_colormap_color(self, index: int, color):
        pass  # DirectClass framework: palettes are derived, not stored

    def cycle_colormap_image(self, displace: int):
        img = self.current
        self._set_current(img.replace(
            data=torch.remainder(img.data + displace / 256.0, 1.0)))

    # masks / clips
    def set_image_mask(self, mask_wand: Optional["MagickWand"],
                       mask_type: str = "read"):
        if mask_wand is None:
            self.current.properties.pop("wand:mask", None)
        else:
            # the mask wand's tensor: no method writes into it in place
            self.current.properties["wand:mask"] = mask_wand.current.data

    def get_image_mask(self, mask_type: str = "read"):
        m = self.current.properties.get("wand:mask")
        if m is None:
            return None
        w = MagickWand(self.device)
        w.images.append(Image(m, ImageSpec(colorspace="gray")))
        return w

    def clip_image(self):
        raise RuntimeError("no clip path defined")   # ClipImage w/o 8BIM path

    def clip_image_path(self, path: str, inside: bool = True):
        raise RuntimeError("8BIM clip paths not present")

    # iteration predicates
    def has_next_image(self) -> bool:
        return self.iterator + 1 < len(self.images)

    def has_previous_image(self) -> bool:
        return self.iterator > 0

    def destroy_image(self):
        """MagickDestroyImage: remove the current image from the wand."""
        if self.images:
            del self.images[self.iterator if self.iterator >= 0 else -1]
            self.iterator = min(self.iterator, len(self.images) - 1)

    # IO variants
    def read_image_file(self, fp):
        return self.read_image_blob(fp.read())

    def write_image_file(self, fp, fmt: str = "png"):
        fp.write(self.get_image_blob(fmt))

    def write_images_file(self, fp, fmt: str = "gif"):
        fp.write(self.get_images_blob(fmt))

    def ping_image(self, filename: str):
        """MagickPingImage: header-only read (dims + properties)."""
        return self.read_image(filename)

    def ping_image_blob(self, blob: bytes, fmt=None):
        return self.read_image_blob(blob, fmt)

    def ping_image_file(self, fp):
        return self.read_image_file(fp)

    def constitute_image(self, width: int, height: int, channel_map: str,
                         pixels):
        """MagickConstituteImage: wand from raw pixel values."""
        arr = np.asarray(pixels, np.float32).reshape(
            height, width, len(channel_map))
        spec = ImageSpec(colorspace="srgb",
                         alpha="a" in channel_map.lower())
        self.images.append(Image(_inverse_map_channels(
            arr, channel_map, spec), spec, device=self.device))
        self.iterator = len(self.images) - 1
        return self

    # ops that were CLI-only until round 2
    def color_threshold_image(self, start_color, stop_color):
        img = self.current
        c = img.data[..., :3]
        lo = _on(PixelWand(_color_str(start_color)).get_color()[:3], c)
        hi = _on(PixelWand(_color_str(stop_color)).get_color()[:3], c)
        inside = torch.all((c >= lo) & (c <= hi), dim=-1, keepdim=True)
        out = inside.to(torch.float32)
        self._set_current(Image(out, ImageSpec(colorspace="gray")))

    def threshold_image_channel(self, channel: str, threshold: float):
        idx = {"red": 0, "green": 1, "blue": 2, "r": 0, "g": 1, "b": 2}.get(
            channel.lower(), 0)
        img = self.current
        data = img.data.clone()
        data[..., idx:idx + 1] = (img.data[..., idx:idx + 1] >= threshold
                                  ).to(data.dtype)
        self._set_current(img.replace(data=data))

    def comment_image(self, text: str):
        self._set_iprop("comment", text)

    def label_image(self, text: str):
        self._set_iprop("label", text)

    def interpolative_resize_image(self, width: int, height: int,
                                   method: str = "bilinear"):
        from ..ops import resize as rz

        img = self.current
        self._set_current(img.replace(
            data=rz.interpolative_resize(img.data, height, width, method)))

    def resample_image(self, x_res: float, y_res: float,
                       filter_name: str = "undefined"):
        from ..ops import resize as rz

        img = self.current
        cur = float(self._iprop("density", "72").split("x")[0] or 72)
        w = max(int(img.width * x_res / cur + 0.5), 1)
        h = max(int(img.height * y_res / cur + 0.5), 1)
        self._set_current(img.replace(
            data=rz.resize(img.data, h, w, filter_name)))

    def separate_image(self, channel: str):
        return self.separate_image_channel(channel)

    def level_image_colors(self, black_color, white_color, invert=False):
        lo = np.asarray(PixelWand(_color_str(black_color))
                        .get_color()[:3], np.float32)
        hi = np.asarray(PixelWand(_color_str(white_color))
                        .get_color()[:3], np.float32)
        img = self.current
        c = img.data[..., :3]
        if invert:
            out = _on(lo, c) + c * _on(hi - lo, c)
        else:
            out = (c - _on(lo, c)) / _on(np.maximum(hi - lo, np.float32(1e-12)),
                                         c)
        out = torch.clamp(out, 0.0, 1.0)
        if img.spec.alpha:
            out = torch.cat([out, img.data[..., 3:]], -1)
        self._set_current(img.replace(data=out))

    def polynomial_image(self, terms):
        from ..ops import statistic as stx

        imgs = [im.data for im in self.images]
        pairs = [(terms[i], terms[i + 1]) for i in range(0, len(terms), 2)]
        out = stx.polynomial_images(imgs, pairs)
        self.images = [Image(out, self.images[0].spec)]
        self.iterator = 0
        return self

    def complex_images(self, operator: str) -> "MagickWand":
        from ..ops import fourier as ff

        imgs = [im.data for im in self.images]
        br = imgs[2] if len(imgs) > 2 else torch.zeros_like(imgs[0])
        bi = imgs[3] if len(imgs) > 3 else torch.zeros_like(imgs[1])
        r, i = ff.complex_images(imgs[0], imgs[1], br, bi, operator)
        out = MagickWand(self.device)
        out.images = [Image(r, self.images[0].spec),
                      Image(i, self.images[1].spec)]
        out.iterator = 1
        return out

    def compare_images_layers(self, method: str = "compareany"):
        from ..ops import layer as ly

        out = MagickWand(self.device)
        out.images = ly.deconstruct(self.images)
        out.iterator = len(out.images) - 1
        return out

    def composite_layers(self, source: "MagickWand", compose: str = "over",
                         x: int = 0, y: int = 0):
        from ..ops.composite import composite_at

        for i, im in enumerate(self.images):
            src = source.images[min(i, len(source.images) - 1)]
            self.images[i] = im.replace(data=composite_at(
                im.data, src.data, compose, x, y,
                dst_alpha=im.spec.alpha, src_alpha=src.spec.alpha))

    def composite_image_gravity(self, source: "MagickWand", compose: str,
                                gravity: str):
        from ..ops.composite import composite_at

        img = self.current
        self._set_current(img.replace(data=composite_at(
            img.data, source.current.data, compose, 0, 0, gravity,
            dst_alpha=img.spec.alpha,
            src_alpha=source.current.spec.alpha)))

    def optimize_image_transparency(self):
        from ..ops import layer as ly

        self.images = ly.optimize_transparency(self.images)
        self.iterator = len(self.images) - 1

    def quantize_images(self, n_colors: int, colorspace: str = "rgb",
                        treedepth: int = 0, dither: bool = False,
                        measure_error: bool = False):
        for i in range(len(self.images)):
            self.iterator = i
            self.quantize_image(n_colors, colorspace, treedepth, dither)
        return self

    def morph_images(self, n_frames: int) -> "MagickWand":
        """MagickMorphImages: crossfade interpolation between frames."""
        out = MagickWand(self.device)
        for a, b in zip(self.images, self.images[1:]):
            out.images.append(a)
            for k in range(1, n_frames + 1):
                t = k / (n_frames + 1)
                out.images.append(Image(
                    (1 - t) * a.data + t * b.data.to(a.data.device), a.spec))
        out.images.append(self.images[-1])
        out.iterator = len(out.images) - 1
        return out

    def preview_images(self, preview_type: str) -> "MagickWand":
        from ..ops import enhance as en
        from ..ops import montage as mo

        img = self.current
        variants = [Image(en.gamma(img.data, 0.3 + 0.3 * k), img.spec)
                    for k in range(9)]
        out = MagickWand(self.device)
        out.images = [mo.montage(variants, tile="3x3",
                                 geometry="120x120+2+2")]
        out.iterator = 0
        return out

    def get_image_distortions(self, reference: "MagickWand",
                              metric: str = "rmse"):
        """Per-channel distortion vector (MagickGetImageDistortions)."""
        from ..ops import compare as cmx

        a, b = self.current.data, reference.current.data
        return [float(cmx.get_distortion(a[..., c:c + 1], b[..., c:c + 1],
                                         metric))
                for c in range(min(self.current.channels,
                                   reference.current.channels))]

    def identify_image(self, verbose: bool = True) -> str:
        from ..io import identify as ident

        return ident.describe(self.current, "wand", verbose)

    def set_image_channel_mask(self, mask: int) -> int:
        prev = int(self._iprop("channel-mask", 0xFF) or 0xFF)
        self._set_iprop("channel-mask", int(mask))
        return prev

    def set_image_progress_monitor(self, fn):
        self._progress_monitor = fn

    set_progress_monitor = set_image_progress_monitor

    def animate_images(self, server_name: str = ""):
        """MagickAnimateImages/MagickDisplayImage: in-terminal sixel
        rendering replaces the X server (cli/tools display semantics);
        silent no-op off-TTY."""
        from . import cpp_support

        cpp_support.display(self)
        return True

    display_image = animate_images
    display_images = animate_images

    def get_image_iterations(self) -> int:
        """MagickGetImageIterations."""
        try:
            return int(self.get_image_property("iterations") or 0)
        except Exception:
            return 0

    def identify_image_type(self) -> str:
        """MagickIdentifyImageType (pixel inspection, not the stored
        type attribute)."""
        from ..ops import attribute as attr

        img = self.current
        return attr.image_type(img.data, img.spec.alpha)

    # ------------------------------------------------------------------
    # magick-property.c exports: wand-level settings get/set pairs.
    # ------------------------------------------------------------------

    def get_antialias(self) -> bool:
        return self.settings.get("antialias", "1") != "0"

    def set_antialias(self, on: bool):
        self.settings["antialias"] = "1" if on else "0"

    def get_colorspace(self) -> str:
        return self.settings.get("colorspace", "srgb")

    def set_colorspace(self, cs: str):
        self.settings["colorspace"] = cs.lower()

    def get_compression(self) -> str:
        return self.settings.get("compression", "undefined")

    def set_compression(self, c: str):
        self.settings["compression"] = c

    def get_compression_quality(self) -> int:
        return self.quality

    def set_compression_quality(self, q: int):
        self.quality = int(q)

    def get_filename(self) -> str:
        return self.settings.get("filename", "")

    def set_filename(self, name: str):
        self.settings["filename"] = name

    def get_filter(self) -> str:
        return self.filter

    def set_filter(self, f: str):
        self.filter = f

    def get_format(self) -> str:
        return self.settings.get("format", "")

    def set_format(self, f: str):
        self.settings["format"] = f

    def get_interlace_scheme(self) -> str:
        return self.settings.get("interlace", "none")

    def set_interlace_scheme(self, s: str):
        self.settings["interlace"] = s

    def get_interpolate_method(self) -> str:
        return self.settings.get("interpolate", "bilinear")

    def set_interpolate_method(self, m: str):
        self.settings["interpolate"] = m

    def get_orientation(self) -> str:
        return self.settings.get("orientation", "undefined")

    def set_orientation(self, o: str):
        self.settings["orientation"] = o

    def get_page(self):
        from ..core.geometry import parse_page_geometry

        g = self.settings.get("page")
        if not g:
            return (0, 0, 0, 0)
        w, h, x, y = parse_page_geometry(g, 0, 0)
        return (w, h, x, y)

    def set_page(self, width: int, height: int, x: int = 0, y: int = 0):
        self.settings["page"] = f"{width}x{height}+{x}+{y}"

    def get_pointsize(self) -> float:
        return self.pointsize

    def set_pointsize(self, p: float):
        self.pointsize = float(p)

    def get_resolution(self):
        d = self.settings.get("density", "72x72")
        parts = d.replace("x", " ").split()
        dx = float(parts[0])
        dy = float(parts[1]) if len(parts) > 1 else dx
        return dx, dy

    def set_resolution(self, dx: float, dy: Optional[float] = None):
        self.settings["density"] = f"{dx}x{dy if dy is not None else dx}"

    def get_sampling_factors(self):
        s = self.settings.get("sampling-factor", "")
        return [v for v in s.split(",") if v]

    def set_sampling_factors(self, factors):
        self.settings["sampling-factor"] = ",".join(str(f) for f in factors)

    def get_size(self):
        from ..core.geometry import parse_geometry

        s = self.settings.get("size")
        if not s:
            return (0, 0)
        g = parse_geometry(s)
        return (int(g.width or 0), int(g.height or 0))

    def set_size(self, width: int, height: int):
        self.settings["size"] = f"{width}x{height}"

    def get_size_offset(self) -> int:
        return int(self.settings.get("size-offset", 0))

    def set_size_offset(self, off: int):
        self.settings["size-offset"] = str(int(off))

    def get_type(self) -> str:
        return self.settings.get("type", "undefined")

    def set_type(self, t: str):
        self.settings["type"] = t

    def set_depth(self, depth: int):
        self.settings["depth"] = str(int(depth))

    def set_extract(self, geometry: str):
        self.settings["extract"] = geometry

    def set_passphrase(self, passphrase: str):
        self.settings["authenticate"] = passphrase

    def set_seed(self, seed: int):
        self.settings["seed"] = str(int(seed))

    def set_security_policy(self, policy_xml: str) -> bool:
        from ..core.policy import policy

        try:
            policy.load_xml(policy_xml)
            return True
        except Exception:
            return False

    # wand-level options / image artifacts (artifact.c analog)
    def get_option(self, key: str) -> str:
        return self.settings.get(f"option:{key}", "")

    def set_option(self, key: str, value: str):
        self.settings[f"option:{key}"] = value

    def delete_option(self, key: str):
        self.settings.pop(f"option:{key}", None)

    def get_options(self, pattern: str = "*"):
        import fnmatch

        return [k[7:] for k in self.settings
                if k.startswith("option:") and
                fnmatch.fnmatch(k[7:], pattern)]

    def get_image_artifact(self, key: str) -> str:
        return self.current.properties.get(f"artifact:{key}", "")

    def set_image_artifact(self, key: str, value: str):
        self.current.properties[f"artifact:{key}"] = value

    def delete_image_artifact(self, key: str):
        self.current.properties.pop(f"artifact:{key}", None)

    def get_image_artifacts(self, pattern: str = "*"):
        import fnmatch

        return [k[9:] for k in self.current.properties
                if k.startswith("artifact:") and
                fnmatch.fnmatch(k[9:], pattern)]

    def get_image_profiles(self, pattern: str = "*"):
        import fnmatch

        return [k for k in self.current.profiles
                if fnmatch.fnmatch(k, pattern)]

    # resource limits (resource.c via wand)
    def get_resource(self, resource: str):
        from ..core.resource import resources

        return resources.report().get(resource.lower(), {}).get("current", 0)

    def get_resource_limit(self, resource: str):
        from ..core.resource import resources

        return resources.get_limit(resource)

    def set_resource_limit(self, resource: str, value):
        from ..core.resource import resources

        resources.set_limit(resource, value)

    # static metadata (version.h analogs)
    @staticmethod
    def get_version():
        from .. import __version__

        return (f"imagemagick_tpu_torch {__version__}", 0x700)

    @staticmethod
    def get_copyright() -> str:
        return ("imagemagick_tpu_torch: PyTorch and CUDA port of "
                "imagemagick_tpu; Apache-2.0-style")

    @staticmethod
    def get_package_name() -> str:
        return "imagemagick_tpu_torch"

    @staticmethod
    def get_release_date() -> str:
        return "2026"

    @staticmethod
    def get_home_url() -> str:
        import pathlib

        # the checkout that holds the package
        return pathlib.Path(__file__).resolve().parents[2].as_uri()

    @staticmethod
    def get_quantum_depth():
        return ("Q16", 16)

    @staticmethod
    def get_quantum_range():
        return ("65535", 65535)


def _map_channels(arr: np.ndarray, cmap: str, spec: ImageSpec) -> np.ndarray:
    idx = {"r": 0, "g": 1, "b": 2, "a": -1, "c": 0, "m": 1, "y": 2, "k": 3,
           "i": 0, "p": 0}
    chans = []
    for ch in cmap.lower():
        if ch == "a" and not spec.alpha:
            chans.append(np.ones(arr.shape[:-1], arr.dtype))
        elif ch == "i":
            chans.append(arr[..., : min(3, arr.shape[-1])].mean(axis=-1))
        else:
            chans.append(arr[..., min(idx.get(ch, 0), arr.shape[-1] - 1)])
    return np.stack(chans, axis=-1)


def _inverse_map_channels(arr: np.ndarray, cmap: str, spec: ImageSpec) -> np.ndarray:
    out = np.zeros(arr.shape[:-1] + (spec.channels,), arr.dtype)
    idx = {"r": 0, "g": 1, "b": 2, "c": 0, "m": 1, "y": 2, "k": 3}
    for i, ch in enumerate(cmap.lower()):
        if ch == "a":
            if spec.alpha:
                out[..., -1] = arr[..., i]
        elif ch in idx and idx[ch] < spec.channels:
            out[..., idx[ch]] = arr[..., i]
        elif ch == "i":
            for c in range(min(3, spec.channels)):
                out[..., c] = arr[..., i]
    return out


class DrawingWand:
    """Stateful vector-drawing context emitting MVG (drawing-wand.c, 139 exports)."""

    def __init__(self):
        self._mvg: List[str] = []
        self.gc_fill = (0.0, 0.0, 0.0, 1.0)
        self.gc_font_size = 12.0
        self.gc_font = None

    def get_mvg(self) -> str:
        return " ".join(self._mvg)

    # state setters
    def set_fill_color(self, color):
        c = color if isinstance(color, str) else color.get_color_string()
        self.gc_fill = parse_color(c) if isinstance(c, str) else c
        self._mvg.append(f"fill '{c}'")

    def set_stroke_color(self, color):
        c = color if isinstance(color, str) else color.get_color_string()
        self._mvg.append(f"stroke '{c}'")

    def set_stroke_width(self, w):
        self._mvg.append(f"stroke-width {w}")

    def set_fill_opacity(self, o):
        self._mvg.append(f"fill-opacity {o}")

    def set_stroke_opacity(self, o):
        self._mvg.append(f"stroke-opacity {o}")

    def set_font(self, font):
        self.gc_font = font
        self._mvg.append(f"font '{font}'")

    def set_font_size(self, size):
        self.gc_font_size = size
        self._mvg.append(f"font-size {size}")

    def set_fill_rule(self, rule):
        self._mvg.append(f"fill-rule {rule}")

    def push(self):
        self._mvg.append("push graphic-context")

    def pop(self):
        self._mvg.append("pop graphic-context")

    def translate(self, x, y):
        self._mvg.append(f"translate {x},{y}")

    def rotate(self, deg):
        self._mvg.append(f"rotate {deg}")

    def scale(self, x, y):
        self._mvg.append(f"scale {x},{y}")

    # primitives
    def line(self, x1, y1, x2, y2):
        self._mvg.append(f"line {x1},{y1} {x2},{y2}")

    def rectangle(self, x1, y1, x2, y2):
        self._mvg.append(f"rectangle {x1},{y1} {x2},{y2}")

    def round_rectangle(self, x1, y1, x2, y2, rx, ry):
        self._mvg.append(f"roundrectangle {x1},{y1} {x2},{y2} {rx},{ry}")

    def circle(self, ox, oy, px, py):
        self._mvg.append(f"circle {ox},{oy} {px},{py}")

    def ellipse(self, cx, cy, rx, ry, start=0, end=360):
        self._mvg.append(f"ellipse {cx},{cy} {rx},{ry} {start},{end}")

    def polygon(self, points):
        pts = " ".join(f"{x},{y}" for x, y in points)
        self._mvg.append(f"polygon {pts}")

    def polyline(self, points):
        pts = " ".join(f"{x},{y}" for x, y in points)
        self._mvg.append(f"polyline {pts}")

    def bezier(self, points):
        pts = " ".join(f"{x},{y}" for x, y in points)
        self._mvg.append(f"bezier {pts}")

    def path(self, d):
        self._mvg.append(f"path '{d}'")

    def point(self, x, y):
        self._mvg.append(f"point {x},{y}")

    def text(self, x, y, s):
        self._mvg.append(f"text {x},{y} '{s}'")

    # ------------------------------------------------------------------
    # Round 2: remaining drawing-wand.c exports.  State setters emit MVG
    # and record the value so the matching getters (Draw Get*) work.
    # ------------------------------------------------------------------

    def _set(self, key, mvg, value):
        if not hasattr(self, "_state"):
            self._state = {}
        self._state[key] = value
        self._mvg.append(mvg)

    def _get(self, key, default=None):
        return getattr(self, "_state", {}).get(key, default)

    # affine / transforms
    def affine(self, sx, rx, ry, sy, tx, ty):
        self._mvg.append(f"affine {sx},{rx},{ry},{sy},{tx},{ty}")

    def skew_x(self, deg):
        self._mvg.append(f"skewX {deg}")

    def skew_y(self, deg):
        self._mvg.append(f"skewY {deg}")

    def set_viewbox(self, x1, y1, x2, y2):
        self._mvg.append(f"viewbox {x1} {y1} {x2} {y2}")

    # arcs / extra primitives
    def arc(self, sx, sy, ex, ey, sd, ed):
        self._mvg.append(f"arc {sx},{sy} {ex},{ey} {sd},{ed}")

    def color(self, x, y, method="point"):
        self._mvg.append(f"color {x},{y} {method}")

    def matte(self, x, y, method="point"):
        self._mvg.append(f"matte {x},{y} {method}")

    def comment(self, text):
        self._mvg.append(f"# {text}")

    def composite(self, compose, x, y, width, height, wand):
        self._mvg.append(f"image {compose} {x},{y} {width},{height} 'inline'")

    # path building (DrawPathStart .. DrawPathFinish)
    def path_start(self):
        self._path = []

    def path_finish(self):
        d = " ".join(getattr(self, "_path", []))
        self._mvg.append(f"path '{d}'")
        self._path = []

    def _p(self, s):
        if not hasattr(self, "_path"):
            self._path = []
        self._path.append(s)

    def path_move_to_absolute(self, x, y):
        self._p(f"M {x},{y}")

    def path_move_to_relative(self, x, y):
        self._p(f"m {x},{y}")

    def path_line_to_absolute(self, x, y):
        self._p(f"L {x},{y}")

    def path_line_to_relative(self, x, y):
        self._p(f"l {x},{y}")

    def path_line_to_horizontal_absolute(self, x):
        self._p(f"H {x}")

    def path_line_to_horizontal_relative(self, x):
        self._p(f"h {x}")

    def path_line_to_vertical_absolute(self, y):
        self._p(f"V {y}")

    def path_line_to_vertical_relative(self, y):
        self._p(f"v {y}")

    def path_curve_to_absolute(self, x1, y1, x2, y2, x, y):
        self._p(f"C {x1},{y1} {x2},{y2} {x},{y}")

    def path_curve_to_relative(self, x1, y1, x2, y2, x, y):
        self._p(f"c {x1},{y1} {x2},{y2} {x},{y}")

    def path_curve_to_quadratic_bezier_absolute(self, x1, y1, x, y):
        self._p(f"Q {x1},{y1} {x},{y}")

    def path_curve_to_quadratic_bezier_relative(self, x1, y1, x, y):
        self._p(f"q {x1},{y1} {x},{y}")

    def path_curve_to_smooth_absolute(self, x2, y2, x, y):
        self._p(f"S {x2},{y2} {x},{y}")

    def path_curve_to_smooth_relative(self, x2, y2, x, y):
        self._p(f"s {x2},{y2} {x},{y}")

    def path_curve_to_quadratic_bezier_smooth_absolute(self, x, y):
        self._p(f"T {x},{y}")

    def path_curve_to_quadratic_bezier_smooth_relative(self, x, y):
        self._p(f"t {x},{y}")

    def path_elliptic_arc_absolute(self, rx, ry, rot, large, sweep, x, y):
        self._p(f"A {rx},{ry} {rot} {int(large)},{int(sweep)} {x},{y}")

    def path_elliptic_arc_relative(self, rx, ry, rot, large, sweep, x, y):
        self._p(f"a {rx},{ry} {rot} {int(large)},{int(sweep)} {x},{y}")

    def path_close(self):
        self._p("Z")

    # clip paths / patterns
    def set_clip_path(self, name):
        self._set("clip-path", f"clip-path url(#{name})", name)

    def get_clip_path(self):
        return self._get("clip-path")

    def set_clip_rule(self, rule):
        self._set("clip-rule", f"clip-rule {rule}", rule)

    def get_clip_rule(self):
        return self._get("clip-rule", "nonzero")

    def set_clip_units(self, units):
        self._set("clip-units", f"clip-units {units}", units)

    def get_clip_units(self):
        return self._get("clip-units", "userspace")

    def push_clip_path(self, name):
        self._mvg.append(f"push clip-path {name}")

    def pop_clip_path(self):
        self._mvg.append("pop clip-path")

    def push_pattern(self, name, x, y, w, h):
        self._mvg.append(f"push pattern {name} {x},{y} {w},{h}")

    def pop_pattern(self):
        self._mvg.append("pop pattern")

    def push_defs(self):
        self._mvg.append("push defs")

    def pop_defs(self):
        self._mvg.append("pop defs")

    def set_fill_pattern_url(self, url):
        u = url if url.startswith("url(") else f"url({url})"
        self._set("fill-pattern", f"fill {u}", url)

    def set_stroke_pattern_url(self, url):
        u = url if url.startswith("url(") else f"url({url})"
        self._set("stroke-pattern", f"stroke {u}", url)

    # stroke state
    def set_stroke_antialias(self, on):
        self._set("stroke-antialias", f"stroke-antialias {int(bool(on))}",
                  bool(on))

    def get_stroke_antialias(self):
        return self._get("stroke-antialias", True)

    def set_stroke_dash_array(self, dashes):
        s = ",".join(str(d) for d in dashes) if dashes else "none"
        self._set("stroke-dasharray", f"stroke-dasharray {s}", list(dashes))

    def get_stroke_dash_array(self):
        return self._get("stroke-dasharray", [])

    def set_stroke_dash_offset(self, off):
        self._set("stroke-dashoffset", f"stroke-dashoffset {off}", off)

    def get_stroke_dash_offset(self):
        return self._get("stroke-dashoffset", 0.0)

    def set_stroke_line_cap(self, cap):
        self._set("stroke-linecap", f"stroke-linecap {cap}", cap)

    def get_stroke_line_cap(self):
        return self._get("stroke-linecap", "butt")

    def set_stroke_line_join(self, join):
        self._set("stroke-linejoin", f"stroke-linejoin {join}", join)

    def get_stroke_line_join(self):
        return self._get("stroke-linejoin", "miter")

    def set_stroke_miter_limit(self, limit):
        self._set("stroke-miterlimit", f"stroke-miterlimit {limit}", limit)

    def get_stroke_miter_limit(self):
        return self._get("stroke-miterlimit", 10)

    def get_stroke_width(self):
        return self._get("stroke-width", 1.0)

    def get_stroke_opacity(self):
        return self._get("stroke-opacity", 1.0)

    def get_fill_opacity(self):
        return self._get("fill-opacity", 1.0)

    def get_fill_rule(self):
        return self._get("fill-rule", "nonzero")

    def get_fill_color(self) -> "PixelWand":
        return PixelWand(self.gc_fill)

    def get_stroke_color(self) -> "PixelWand":
        return PixelWand(self._get("stroke-color", "none")
                         if self._get("stroke-color") else "black")

    # opacity / alpha
    def set_opacity(self, o):
        self._set("opacity", f"opacity {o}", o)

    def get_opacity(self):
        return self._get("opacity", 1.0)

    def set_border_color(self, color):
        self._set("border-color", f"border-color '{_color_str(color)}'",
                  _color_str(color))

    def get_border_color(self):
        return PixelWand(self._get("border-color", "#dfdfdf"))

    # font state
    def get_font(self):
        return self.gc_font

    def get_font_size(self):
        return self.gc_font_size

    def set_font_family(self, fam):
        self._set("font-family", f"font-family '{fam}'", fam)

    def get_font_family(self):
        return self._get("font-family")

    def set_font_stretch(self, s):
        self._set("font-stretch", f"font-stretch {s}", s)

    def get_font_stretch(self):
        return self._get("font-stretch", "normal")

    def set_font_style(self, s):
        self._set("font-style", f"font-style {s}", s)

    def get_font_style(self):
        return self._get("font-style", "normal")

    def set_font_weight(self, w):
        self._set("font-weight", f"font-weight {w}", w)

    def get_font_weight(self):
        return self._get("font-weight", 400)

    # text state
    def set_gravity(self, g):
        self._set("gravity", f"gravity {g}", g)

    def get_gravity(self):
        return self._get("gravity", "undefined")

    def set_text_alignment(self, a):
        self._set("text-align", f"text-align {a}", a)

    def get_text_alignment(self):
        return self._get("text-align", "undefined")

    def set_text_antialias(self, on):
        self._set("text-antialias", f"text-antialias {int(bool(on))}",
                  bool(on))

    def get_text_antialias(self):
        return self._get("text-antialias", True)

    def set_text_decoration(self, d):
        self._set("decorate", f"decorate {d}", d)

    def get_text_decoration(self):
        return self._get("decorate", "none")

    def set_text_direction(self, d):
        self._set("direction", f"direction {d}", d)

    def get_text_direction(self):
        return self._get("direction", "undefined")

    def set_text_encoding(self, e):
        self._set("encoding", f"encoding '{e}'", e)

    def get_text_encoding(self):
        return self._get("encoding", "")

    def set_text_interline_spacing(self, s):
        self._set("interline-spacing", f"interline-spacing {s}", s)

    def get_text_interline_spacing(self):
        return self._get("interline-spacing", 0.0)

    def set_text_interword_spacing(self, s):
        self._set("interword-spacing", f"interword-spacing {s}", s)

    def get_text_interword_spacing(self):
        return self._get("interword-spacing", 0.0)

    def set_text_kerning(self, k):
        self._set("kerning", f"kerning {k}", k)

    def get_text_kerning(self):
        return self._get("kerning", 0.0)

    def set_text_under_color(self, color):
        self._set("text-undercolor",
                  f"text-undercolor '{_color_str(color)}'",
                  _color_str(color))

    def get_text_under_color(self):
        return PixelWand(self._get("text-undercolor", "none")
                         if self._get("text-undercolor") else "white")

    def set_density(self, d):
        self._set("density", f"density {d}", d)

    def get_density(self):
        return self._get("density", "72")

    # wand management
    def clear(self):
        self._mvg = []
        self._state = {}
        self._path = []

    def clone(self) -> "DrawingWand":
        d = DrawingWand()
        d._mvg = list(self._mvg)
        d._state = dict(getattr(self, "_state", {}))
        d.gc_fill = self.gc_fill
        d.gc_font = self.gc_font
        d.gc_font_size = self.gc_font_size
        return d

    def get_vector_graphics(self) -> str:
        return self.get_mvg()

    def set_vector_graphics(self, mvg: str):
        self._mvg = [mvg]

    def get_exception(self):
        return (0, "")

    def clear_exception(self):
        """DrawClearException (drawing-wand.c)."""
        return True

    def get_exception_type(self):
        return 0

    def alpha(self, x: float, y: float, method: str = "floodfill"):
        """DrawAlpha (drawing-wand.c DrawAlpha): queue an alpha paint
        primitive at the point."""
        self._mvg.append(f"alpha {x},{y} {method}")

    def annotation(self, x: float, y: float, text: str):
        """DrawAnnotation: queue text at the point."""
        esc = text.replace("'", "\\'")
        self._mvg.append(f"text {x},{y} '{esc}'")

    def set_font_resolution(self, x: float, y: float):
        """DrawSetFontResolution (stored; glyphs raster at pointsize)."""
        self._font_resolution = (float(x), float(y))
        return True

    def get_font_resolution(self):
        return getattr(self, "_font_resolution", (96.0, 96.0))

    def get_type_metrics(self, text: str, multiline: bool = False):
        """DrawGetTypeMetrics via the annotate machinery."""
        from ..ops.draw import get_type_metrics as _gtm

        return _gtm(text, size=self.gc_font_size or 12.0)

    def reset_vector_graphics(self):
        """DrawResetVectorGraphics."""
        self._mvg = []

    def render(self):
        """DrawRender: MVG is rendered lazily by MagickDrawImage."""
        return True


def new_magick_wand(device="cuda") -> MagickWand:
    """NewMagickWand (magick-wand.c:1073): a wand whose reads land on
    ``device``."""
    return MagickWand(device)


def new_magick_wand_from_image(image) -> MagickWand:
    """NewMagickWandFromImage: adopt a core Image (or another wand's
    current image) into a fresh wand on the image's device."""
    if isinstance(image, MagickWand):
        image = image.current
    w = MagickWand(image.data.device)
    w.images = [image]
    w.iterator = 0
    return w


def clone_magick_wand(w: MagickWand) -> MagickWand:
    return w.clone()


def clear_magick_wand(w: MagickWand):
    w.clear()


def destroy_magick_wand(w):
    """DestroyMagickWand (no-op: Python owns the memory)."""
    return None


def is_magick_wand(w) -> bool:
    return isinstance(w, MagickWand)


def magick_wand_genesis():
    """MagickWandGenesis (environment setup is implicit)."""
    return None


def magick_wand_terminus():
    return None


def magick_relinquish_memory(_blob=None):
    return None


def magick_query_formats(pattern: str = "*") -> list:
    """MagickQueryFormats."""
    import fnmatch

    from .. import io as iio

    fmts = sorted(set(iio.supported_read_formats())
                  | set(iio.supported_write_formats()))
    return [f.upper() for f in fmts
            if fnmatch.fnmatch(f.upper(), pattern.upper())]


def magick_query_fonts(pattern: str = "*") -> list:
    """MagickQueryFonts: system fonts discoverable by the draw layer."""
    import fnmatch
    import glob as _glob
    import os as _os

    names = []
    for d in ("/usr/share/fonts", _os.path.expanduser("~/.fonts")):
        for f in _glob.glob(_os.path.join(d, "**", "*.ttf"),
                            recursive=True):
            names.append(_os.path.splitext(_os.path.basename(f))[0])
    return sorted({n for n in names
                   if fnmatch.fnmatch(n.lower(), pattern.lower())})


def magick_query_configure_option(option: str) -> str:
    """MagickQueryConfigureOption."""
    table = {"VERSION": "7.1-compatible (imagemagick_tpu_torch)",
             "QuantumDepth": "Q16", "HDRI": "enabled",
             "DELEGATES": "ghostscript ffmpeg freetype lcms",
             "FEATURES": "PyTorch CUDA HDRI"}
    for k, v in table.items():
        if k.lower() == option.lower():
            return v
    raise KeyError(option)


def magick_query_configure_options(pattern: str = "*") -> list:
    import fnmatch

    keys = ["VERSION", "QuantumDepth", "HDRI", "DELEGATES", "FEATURES"]
    return [k for k in keys if fnmatch.fnmatch(k.upper(), pattern.upper())]


def magick_query_multiline_font_metrics(wand, drawing, text: str):
    """MagickQueryMultilineFontMetrics."""
    from ..ops.draw import get_type_metrics

    size = getattr(drawing, "gc_font_size", None) or wand.pointsize or 12.0
    lines = text.split("\n") or [""]
    ms = [get_type_metrics(ln, size=size) for ln in lines]
    out = dict(ms[0])
    out["width"] = max(m["width"] for m in ms)
    out["height"] = sum(m["height"] for m in ms)
    return out


class WandView:
    """Region-callback processing (wand-view.c / image-view.c analog).

    update(fn) applies fn(region_array) -> region_array over the view's
    rectangle; the reference iterates rows with OpenMP callbacks, here the
    whole region is one device op.
    """

    def __init__(self, wand: MagickWand, x=0, y=0,
                 width: Optional[int] = None, height: Optional[int] = None):
        self.wand = wand
        img = wand.current
        self.x = x
        self.y = y
        self.width = width if width is not None else img.width - x
        self.height = height if height is not None else img.height - y

    def get(self) -> torch.Tensor:
        """A copy of the view's pixels: writing into it changes no image."""
        img = self.wand.current
        return img.data[..., self.y:self.y + self.height,
                        self.x:self.x + self.width, :].clone()

    def update(self, fn) -> None:
        img = self.wand.current
        region = self.get()
        new = fn(region)
        data = img.data.clone()
        data[..., self.y:self.y + self.height,
             self.x:self.x + self.width, :] = torch.as_tensor(
                 new, dtype=data.dtype, device=data.device)
        self.wand._set_current(img.replace(data=data))

    def transfer(self, other: "WandView", fn=None) -> None:
        """DuplexTransferWandView analog: combine two views."""
        a = self.get()
        b = other.get()
        out = fn(a, b) if fn else b
        self.update(lambda _: out)

    # wand-view.c export-name parity
    get_pixels = get
    update_iterator = update
    transfer_iterator = transfer
    duplex_transfer_iterator = transfer

    def get_iterator(self, fn):
        """GetWandViewIterator: read-only visit."""
        fn(self.get())
        return True

    set_iterator = update_iterator

    def get_extent(self):
        """GetWandViewExtent -> RectangleInfo-like tuple."""
        return (self.width, self.height, self.x, self.y)

    def get_wand(self) -> "MagickWand":
        return self.wand

    def clone(self) -> "WandView":
        return WandView(self.wand, self.x, self.y, self.width, self.height)

    def get_exception(self):
        return (0, "")


def new_wand_view(wand: MagickWand) -> WandView:
    """NewWandView (full canvas)."""
    return WandView(wand)


def new_wand_view_extent(wand: MagickWand, x, y, width, height) -> WandView:
    return WandView(wand, x, y, width, height)


def clone_wand_view(v: WandView) -> WandView:
    return v.clone()


def destroy_wand_view(v):
    return None


def is_wand_view(v) -> bool:
    return isinstance(v, WandView)


class PixelIterator:
    """Row-wise pixel access (pixel-iterator.c, 922 LoC analog).

    Iterates rows of the wand's current image as lists of PixelWands;
    sync_iterator() writes modifications back.
    """

    def __init__(self, wand: MagickWand, x=0, y=0,
                 width: Optional[int] = None, height: Optional[int] = None):
        self.wand = wand
        img = wand.current
        self.x0 = x
        self.y0 = y
        self.width = width if width is not None else img.width - x
        self.height = height if height is not None else img.height - y
        self.row = -1
        self._buffer = _host(img.data).copy()  # writable copy
        self._pixels: List[PixelWand] = []

    def __iter__(self):
        self.row = -1
        return self

    def __next__(self):
        self.row += 1
        if self.row >= self.height:
            raise StopIteration
        return self.get_current_iterator_row()

    def get_current_iterator_row(self) -> List[PixelWand]:
        self._pixels_row = self.row
        y = self.y0 + self.row
        row = self._buffer[y, self.x0:self.x0 + self.width]
        self._pixels = [PixelWand(list(px) + [1.0] * (3 - min(len(px), 3)))
                        if len(px) < 3 else PixelWand(list(px))
                        for px in row]
        return self._pixels

    def get_next_row(self) -> Optional[List[PixelWand]]:
        """PixelGetNextIteratorRow: advance and return the row (or None)."""
        self.row += 1
        if self.row >= self.height:
            return None
        return self.get_current_iterator_row()

    def reset(self):
        """PixelResetIterator."""
        self.row = -1

    def set_first_iterator_row(self):
        self.row = 0

    def set_last_iterator_row(self):
        self.row = self.height - 1

    def set_iterator_row(self, row: int):
        self.row = int(row)

    def get_iterator_row(self) -> int:
        return self.row

    def get_previous_row(self):
        """PixelGetPreviousIteratorRow."""
        if self.row <= 0:
            return None
        self.row -= 2
        return self.get_next_row()

    def clone(self) -> "PixelIterator":
        it = PixelIterator(self.wand, self.x0, self.y0, self.width,
                           self.height)
        it.row = self.row
        return it

    def clear(self):
        self.reset()

    def get_exception(self):
        return (0, "")

    def get_exception_type(self):
        return 0

    def clear_exception(self):
        return True

    def sync_iterator(self):
        """Write the (possibly modified) PixelWands back to the image."""
        y = self.y0 + getattr(self, "_pixels_row", self.row)
        c = self._buffer.shape[-1]
        vals = np.asarray([p.get_color()[:c] for p in self._pixels],
                          self._buffer.dtype)
        self._buffer[y, self.x0:self.x0 + self.width] = vals
        img = self.wand.current
        self.wand._set_current(img.replace(data=torch.from_numpy(
            self._buffer.copy()).to(img.data.device)))
