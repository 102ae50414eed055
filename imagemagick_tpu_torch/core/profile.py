"""ICC color management (profile.c).

Port of ``imagemagick_tpu/core/profile.py``: ProfileImage
(MagickCore/profile.c:923) through LittleCMS, the library ImageMagick
links, by way of PIL's ``ImageCms``, with rendering intents and
black-point compensation.  The transform runs on the host over 8-bit
planes, as in the JAX package; the result comes back on the image's
device.
"""

from __future__ import annotations

import io as _io

import numpy as np

try:
    from PIL import Image as PILImage
    from PIL import ImageCms

    HAVE_LCMS = True
except Exception:  # pragma: no cover
    HAVE_LCMS = False

INTENTS = {
    "perceptual": 0,
    "relative": 1,
    "saturation": 2,
    "absolute": 3,
}


def srgb_profile_bytes() -> bytes:
    prof = ImageCms.createProfile("sRGB")
    return ImageCms.ImageCmsProfile(prof).tobytes()


def profile_image(image, icc_profile: bytes,
                  intent: str = "perceptual",
                  black_point_compensation: bool = False):
    """Apply an ICC transform from the image's current profile (or sRGB)
    to the target profile; returns a new Image, on the image's device,
    with the profile attached."""
    if not HAVE_LCMS:
        raise RuntimeError("LittleCMS (PIL.ImageCms) unavailable")
    from .image import Image

    src_icc = image.profiles.get("icc")
    src = ImageCms.ImageCmsProfile(_io.BytesIO(src_icc)) if src_icc \
        else ImageCms.createProfile("sRGB")
    dst = ImageCms.ImageCmsProfile(_io.BytesIO(icc_profile))

    arr = image.to_uint8()
    mode = {1: "L", 3: "RGB", 4: "RGBA"}.get(arr.shape[-1])
    if mode is None:
        arr = arr[..., :3]
        mode = "RGB"
    pim = PILImage.fromarray(arr.squeeze() if mode == "L" else arr, mode)
    out_mode = "CMYK" if _profile_space(dst) == "CMYK" else "RGB"
    flags = ImageCms.Flags.BLACKPOINTCOMPENSATION if black_point_compensation else 0
    xform = ImageCms.buildTransform(src, dst,
                                    "RGB" if mode != "L" else "L",
                                    out_mode,
                                    renderingIntent=INTENTS.get(intent.lower(), 0),
                                    flags=flags)
    if mode == "RGBA":
        rgb = pim.convert("RGB")
        res = ImageCms.applyTransform(rgb, xform)
    elif mode == "L":
        res = ImageCms.applyTransform(pim.convert("RGB") if out_mode != "L" else pim, xform)
    else:
        res = ImageCms.applyTransform(pim, xform)
    out_arr = np.asarray(res).astype(np.float32) / 255.0
    if out_arr.ndim == 2:
        out_arr = out_arr[..., None]
    spec = image.spec
    if out_mode == "CMYK":
        spec = spec.with_(colorspace="cmyk", alpha=False)
    if mode == "RGBA" and out_mode == "RGB":
        out_arr = np.concatenate([out_arr, image.to_numpy()[..., 3:4]], -1)
    out = Image(out_arr, spec, dict(image.properties), dict(image.profiles),
                image.page, image.delay, device=image.data.device)
    out.profiles["icc"] = icc_profile
    return out


def _profile_space(prof) -> str:
    try:
        return ImageCms.getProfileInfo(prof) and prof.profile.xcolor_space.strip()
    except Exception:
        try:
            return prof.profile.color_space.strip()
        except Exception:
            return "RGB"


def transform_to_srgb(image):
    """Normalize any embedded profile to sRGB (the thumbnailer ICC step)."""
    if "icc" not in image.profiles:
        return image
    return profile_image(image, srgb_profile_bytes(), "perceptual")
