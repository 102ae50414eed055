"""Image: the user-facing container — a tensor plus its static spec.

Port of ``imagemagick_tpu/core/image.py`` (the reference's Image struct and
pixel cache, MagickCore/image.h:131-350, cache.c): pixels are a dense
(H, W, C) — or batched (N, H, W, C) — float32 tensor in [0,1] (Q16-HDRI
semantics); static semantics live in ImageSpec, and host-only metadata
(properties, profiles, page geometry, animation delay) in plain values
that ops carry along.  A tensor keeps the device
it lies on; pixels given as a numpy array or a list go to ``device``, the
CUDA card unless the caller asks for the CPU.  Op methods are thin
wrappers over the functions in ``imagemagick_tpu_torch.ops`` and return
new Images.  The class has 31 of the JAX class's 33 members: its two
pytree hooks have no use here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .spec import ImageSpec, normalize_colorspace


class Image:
    __slots__ = ("data", "spec", "properties", "profiles", "page", "delay")

    def __init__(self, data, spec: Optional[ImageSpec] = None,
                 properties: Optional[Dict[str, Any]] = None,
                 profiles: Optional[Dict[str, bytes]] = None,
                 page: Optional[Tuple[int, int, int, int]] = None,
                 delay: int = 0, device="cuda"):
        self.data = data if isinstance(data, torch.Tensor) else \
            _to_device(np.asarray(data, np.float32), device)
        self.spec = spec or ImageSpec()
        self.properties = dict(properties or {})
        self.profiles = dict(profiles or {})
        self.page = page
        self.delay = delay

    # -- basic accessors ----------------------------------------------------
    @property
    def height(self) -> int:
        return self.data.shape[-3]

    @property
    def width(self) -> int:
        return self.data.shape[-2]

    @property
    def channels(self) -> int:
        return self.data.shape[-1]

    @property
    def colorspace(self) -> str:
        return self.spec.colorspace

    @property
    def alpha(self) -> bool:
        return self.spec.alpha

    @property
    def batched(self) -> bool:
        return self.data.dim() == 4

    def replace(self, data=None, spec=None) -> "Image":
        return Image(self.data if data is None else data,
                     self.spec if spec is None else spec,
                     self.properties, self.profiles, self.page, self.delay)

    def __repr__(self):
        shp = "x".join(str(s) for s in self.data.shape)
        return (f"<Image {shp} {self.spec.colorspace}"
                f"{'+alpha' if self.spec.alpha else ''} {self.data.device}>")

    def _with(self, data, spec: ImageSpec) -> "Image":
        return Image(data, spec, self.properties, self.profiles, self.page,
                     self.delay)

    # layout: [color..., alpha?, meta...] (the meta tail of pixel.h:27's
    # 64-channel map; per-pixel ops ignore it, geometry ops carry it)
    def color_data(self) -> torch.Tensor:
        return self.data[..., : self.spec.color_channels]

    def alpha_data(self) -> Optional[torch.Tensor]:
        if self.spec.alpha:
            cc = self.spec.color_channels
            return self.data[..., cc:cc + 1]
        return None

    def meta_data(self) -> Optional[torch.Tensor]:
        """The meta-channel tail (None when absent)."""
        if self.spec.meta_channels:
            return self.data[..., -self.spec.meta_channels:]
        return None

    def with_meta(self, meta: Optional[torch.Tensor]) -> "Image":
        """Attach/replace/drop meta channels (SetPixelMetaChannels analog)."""
        base = self.data[..., : self.spec.channels - self.spec.meta_channels]
        if meta is None:
            return self._with(base, self.spec.with_(meta_channels=0))
        return self._with(torch.cat([base, meta], dim=-1),
                          self.spec.with_(meta_channels=meta.shape[-1]))

    def with_color(self, color: torch.Tensor) -> "Image":
        rest = self.data[..., self.spec.color_channels:]
        data = torch.cat([color, rest], dim=-1) if rest.shape[-1] else color
        return self.replace(data=data)

    def set_alpha(self, enable: bool, value: float = 1.0) -> "Image":
        """SetImageAlphaChannel analog (channel.c)."""
        if enable and not self.spec.alpha:
            a = torch.full(self.data.shape[:-1] + (1,), value,
                           dtype=self.data.dtype, device=self.data.device)
            return self._with(torch.cat([self.data, a], dim=-1),
                              self.spec.with_(alpha=True))
        if not enable and self.spec.alpha:
            return self._with(self.data[..., :-1],
                              self.spec.with_(alpha=False))
        return self

    # -- op wrappers (thin; real math in ops/) -------------------------------
    def transform_colorspace(self, target: str) -> "Image":
        from ..ops import colorspace as cs

        tgt = normalize_colorspace(target)
        src = self.spec.colorspace
        if tgt == src:
            return self
        color = cs.convert(self.color_data(), src, tgt)
        rest = self.data[..., self.spec.color_channels:]
        data = torch.cat([color, rest], dim=-1) if rest.shape[-1] else color
        return self._with(data, self.spec.with_(colorspace=tgt))

    def resize(self, width: int, height: int, filter_name: str = "undefined",
               blur: float = 1.0) -> "Image":
        from ..ops import resize as rz

        data = rz.resize(self.data, height, width, filter_name, blur,
                         has_alpha=self.spec.alpha)
        return self.replace(data=data)

    def resize_geometry(self, geometry: str,
                        filter_name: str = "undefined") -> "Image":
        from .geometry import parse_meta_geometry

        w, h, _, _ = parse_meta_geometry(geometry, self.width, self.height)
        if (w, h) == (self.width, self.height):
            return self
        return self.resize(w, h, filter_name)

    def blur(self, radius: float = 0.0, sigma: float = 1.0) -> "Image":
        from ..ops import blur as bl

        return self.replace(data=bl.blur(self.data, radius, sigma))

    def gaussian_blur(self, radius: float = 0.0, sigma: float = 1.0) -> "Image":
        from ..ops import blur as bl

        return self.replace(data=bl.gaussian_blur(self.data, radius, sigma))

    def sharpen(self, radius: float = 0.0, sigma: float = 1.0) -> "Image":
        from ..ops import blur as bl

        return self.replace(data=bl.sharpen(self.data, radius, sigma))

    def unsharp_mask(self, radius: float = 0.0, sigma: float = 1.0,
                     gain: float = 1.0, threshold: float = 0.05) -> "Image":
        from ..ops import blur as bl

        return self.replace(data=bl.unsharp_mask(self.data, radius, sigma,
                                                 gain, threshold))

    def crop(self, geometry: str) -> "Image":
        from .geometry import parse_page_geometry
        from ..ops import transform as tf

        w, h, x, y = parse_page_geometry(geometry, self.width, self.height)
        return self.replace(data=tf.crop(self.data, x, y, w, h))

    def flip(self) -> "Image":
        from ..ops import transform as tf

        return self.replace(data=tf.flip(self.data))

    def flop(self) -> "Image":
        from ..ops import transform as tf

        return self.replace(data=tf.flop(self.data))

    def rotate(self, degrees: float, background=None) -> "Image":
        from ..ops import distort as dt

        return self.replace(data=dt.rotate(self.data, degrees, background))

    # -- host conversion ------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def _quantized(self, top: float) -> np.ndarray:
        arr = torch.clamp(self.data, 0.0, 1.0).detach().cpu().numpy()
        return arr * np.float32(top) + np.float32(0.5)

    def to_uint8(self) -> np.ndarray:
        return self._quantized(255.0).astype(np.uint8)

    def to_uint16(self) -> np.ndarray:
        return self._quantized(65535.0).astype(np.uint16)

    @classmethod
    def _from_int(cls, arr: np.ndarray, top: float,
                  spec: Optional[ImageSpec], device) -> "Image":
        if arr.ndim == 2:
            arr = arr[..., None]
        data = _to_device(np.asarray(arr, np.float32) / np.float32(top),
                          device)
        if spec is None:
            spec = _infer_spec(arr.shape[-1])
        return cls(data, spec)

    @classmethod
    def from_uint8(cls, arr: np.ndarray, spec: Optional[ImageSpec] = None,
                   device="cuda") -> "Image":
        """An Image of 8-bit pixels scaled to [0, 1], on ``device``."""
        return cls._from_int(arr, 255.0, spec, device)

    @classmethod
    def from_uint16(cls, arr: np.ndarray, spec: Optional[ImageSpec] = None,
                    device="cuda") -> "Image":
        """An Image of 16-bit pixels scaled to [0, 1], on ``device``."""
        return cls._from_int(arr, 65535.0, spec, device)


def checked_device(device, what: str = "Image") -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    rather than leaving the work on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA card for device 'cuda'; pass device='cpu' to "
            "keep the pixels on the CPU")
    return device


def host_property(value):
    """A property as the host sees it: a tensor (-region's write mask,
    kept on the image's device for the ops) as a numpy array, the form in
    which text, headers and coders render it; anything else as it is."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else value


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host pixels as a float32 tensor on ``device``; a CUDA device
    without a card raises rather than leaving the pixels on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        checked_device(device))


def _infer_spec(channels: int) -> ImageSpec:
    if channels == 1:
        return ImageSpec(colorspace="gray", alpha=False)
    if channels == 2:
        return ImageSpec(colorspace="gray", alpha=True)
    if channels == 3:
        return ImageSpec(colorspace="srgb", alpha=False)
    if channels == 4:
        return ImageSpec(colorspace="srgb", alpha=True)
    if channels == 5:
        return ImageSpec(colorspace="cmyk", alpha=True)
    raise ValueError(f"cannot infer spec for {channels} channels")


def stack(images: Sequence[Image]) -> Image:
    """Batch same-shape images along a leading axis."""
    if not images:
        raise ValueError("no images to stack")
    spec = images[0].spec
    for im in images[1:]:
        if im.spec != spec:
            raise ValueError("all images in a batch must share a spec")
    return Image(torch.stack([im.data for im in images], dim=0), spec)
